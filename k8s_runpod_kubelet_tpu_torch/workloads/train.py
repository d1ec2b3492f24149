"""Training on one card: loss, optimizer, train step, data, checkpoints.

Port of the JAX package's ``workloads/train.py`` for the Llama decoder,
dense, MLA or sparse MoE (Mixtral, DeepSeek-MoE), Gemma 2 and 3 among the
dense ones (the local/global window interleave with a RoPE table each,
both soft caps, the sandwich norms and q/k norm, a tied table scaled by
√E): f32 master parameters, bf16 compute through ``LlamaModel.forward``
(flash attention kernels, RMSNorm kernel, remat per layer, "full" or
"dots"; under an in-process mesh with seq > 1, ring attention over the
sequence shards), the loss of ``_ce_and_zloss`` or, with
``fused_ce_chunks``, ``ops.fused_ce.fused_cross_entropy`` over the final
hidden states (no (B, S, V) logits), and the optimizer written out with
optax's exact semantics (``clip_by_global_norm`` then ``adamw`` on a
``warmup_cosine_decay_schedule``; with a trainable mask, optax's
``multi_transform`` with ``set_to_zero`` on the frozen leaves). An MoE
model routes at its ``capacity_factor`` (assignments past it drop) and its
objective adds the router's load-balance and z losses, as the JAX step's
does; the step reports them as ``aux_loss`` beside the NLL.

``Trainer(lora=)`` wraps the target projections with adapters
(``models.lora.apply_lora``) and trains A and B alone: the frozen leaves
carry no ``requires_grad``, so autograd builds no gradient for them, and
the optimizer holds Adam moments for the trainable leaves only. A frozen
leaf is held in the compute dtype (norms, the router and adapter scales
stay f32): every use casts it there anyway, so the numbers are the JAX
trainer's, in half the memory and checkpoint bytes of an f32 copy; a
random init draws the frozen leaves straight into it, so the f32 tree is
never whole on the card.

``Trainer(telemetry=)`` syncs every step and feeds a
``workloads.telemetry.TrainingTelemetry`` (the goodput ledger, step and
MFU stats, the protocol lines). Checkpoints are ``torch.save`` files of
the trainable parameters and the optimizer state (a LoRA run's hold the
adapters and a fingerprint of the frozen base, which the resume rebuilds
from the same seed or weights: megabytes, not the 16 GB of an 8B base),
written under a temporary name and renamed, the newest three kept; the
loop's periodic saves stage params and optimizer state into host memory
and write in a background thread, and ``run()`` waits for the write at
its end (a direct ``save()`` blocks). They log the markers the
kubelet parses: ``checkpoint saved at step N`` and ``resumed from
checkpoint step N``.

Not ported yet: elastic ``resize`` (ROADMAP Queue 1 #7.5) and training
over a process group (each rank its token shard, the gradients
all-reduced over the group; #7.8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from ..device import resolve_device
from ..models.llama import (LlamaConfig, LlamaModel, Params, init_params,
                            keeps_f32)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` this port uses, with its
    defaults."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # MaxText-style z-loss coefficient (0 = off): coef * mean(lse^2)
    z_loss_coef: float = 0.0
    batch_size: int = 8          # global batch per optimizer step
    seq_len: int = 512
    steps: int = 100
    # >1: split the batch into this many strided microbatches, average
    # their gradients, apply one optimizer update
    grad_accum_steps: int = 1
    # >0: the LM-head loss through ops.fused_ce, streaming the vocab in
    # this many chunks: the (B, S, V) logits never exist, at one more head
    # product in backward
    fused_ce_chunks: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 1000


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL. logits (B, S, V), targets (B, S) int."""
    ce, _ = _ce_and_zloss(logits, targets, 0.0)
    return ce


def _ce_and_zloss(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss_coef: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean NLL, z-loss term) sharing one logsumexp, in f32: the CE is
    lse - picked logit, the z-loss coef * mean(lse^2)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    ce = (lse - picked).mean()
    z = (z_loss_coef * lse.square().mean() if z_loss_coef
         else torch.zeros((), device=logits.device))
    return ce, z


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from init to peak
    over ``warmup_steps``, then cosine to ``end_value`` over the remaining
    ``decay_steps - warmup_steps``, flat after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine part needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t
                                     / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _leaves(tree: Params) -> list[torch.Tensor]:
    """The tensors of a parameter-shaped tree, in a fixed order."""
    out = []
    for name in sorted(tree):
        leaf = tree[name]
        out.extend(_leaves(leaf) if isinstance(leaf, dict) else [leaf])
    return out


def _map(fn, tree: Params) -> Params:
    return {name: (_map(fn, leaf) if isinstance(leaf, dict) else fn(leaf))
            for name, leaf in tree.items()}


def trainable(tree: Params, mask: Optional[Params]) -> Params:
    """``tree`` pruned to the leaves ``mask`` (a boolean tree of the same
    structure, ``models.lora.lora_mask``) marks trainable, nested as
    before; the whole tree without a mask."""
    if mask is None:
        return tree
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            sub = trainable(leaf, mask[name])
            if sub:
                out[name] = sub
        elif mask[name]:
            out[name] = leaf
    return out


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, in
    f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


# adamw's moments and epsilon, as the JAX trainer sets them
B1, B2, EPS = 0.9, 0.95, 1e-8


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1=B1, b2=B2, eps=EPS, weight_decay=weight_decay))`` with optax's
    semantics, where three differ from PyTorch's defaults:

    - the schedule is read at the update count *before* the update, so with
      a warmup from 0 the first update moves nothing;
    - weight decay is decoupled, scaled by the scheduled learning rate, and
      applies to every trained leaf (norm weights too);
    - the clip scales by ``grad_clip / norm`` only when ``norm >=
      grad_clip`` (optax's ``select(norm < max, g, g / norm * max)``; the
      two agree at equality), with no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``.

    With ``trainable_mask`` it is the JAX trainer's ``multi_transform``
    of that chain over the trainable leaves and ``set_to_zero`` over the
    rest: moments exist for the trainable leaves only, the clip's norm
    covers them alone, and a frozen leaf is never touched (no update, no
    decay). State is ``{"count": int, "mu": tree, "nu": tree}`` over the
    trainable leaves; ``update`` changes the parameters in place."""

    def __init__(self, schedule: Callable[[int], float], grad_clip: float,
                 weight_decay: float, trainable_mask: Optional[Params] = None):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.trainable_mask = trainable_mask

    def init(self, params: Params) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
        tree = trainable(params, self.trainable_mask)
        return {"count": 0, "mu": _map(zeros, tree), "nu": _map(zeros, tree)}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: dict,
               params: Params) -> torch.Tensor:
        """Apply one update for ``grads`` (in the order of the trainable
        leaves, ``_leaves(trainable(params, mask))``); returns their global
        norm before the clip."""
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(
                _leaves(trainable(params, self.trainable_mask)), grads,
                _leaves(state["mu"]), _leaves(state["nu"])):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            mu_hat = mu / (1 - B1 ** count)
            nu_hat = nu / (1 - B2 ** count)
            step = mu_hat / (nu_hat.sqrt() + EPS) + self.weight_decay * p
            p.add_(step, alpha=-lr)
        state["count"] = count
        return norm


def make_optimizer(tc: TrainConfig,
                   trainable_mask: Optional[Params] = None) -> Optimizer:
    schedule = warmup_cosine_decay(
        0.0, tc.learning_rate, tc.warmup_steps,
        max(tc.steps, tc.warmup_steps + 1))
    return Optimizer(schedule, tc.grad_clip, tc.weight_decay,
                     trainable_mask)


def _loss(model: LlamaModel, params: Params, inputs: torch.Tensor,
          targets: torch.Tensor, z_loss_coef: float,
          fused_ce_chunks: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean NLL, z-loss term, router aux) of one batch: through the fused
    chunked loss over the final hidden states when ``fused_ce_chunks`` is
    set and the head is a plain tensor, through the logits otherwise (a
    LoRA or quantized head leaf, as the JAX step decides). The aux is an
    MoE model's scaled router losses summed over its layers
    (``forward(with_aux=True)``), 0 for a dense one."""
    cfg = model.cfg
    moe = bool(cfg.n_experts)
    head = params.get("tok_embed") if cfg.tie_embeddings \
        else params.get("lm_head")
    fused = fused_ce_chunks and not isinstance(head, dict)
    out = model.forward(params, inputs, return_hidden=bool(fused),
                        with_aux=moe)
    out, aux = out if moe else (out, torch.zeros((), device=inputs.device))
    if fused:
        from ..ops.fused_ce import fused_cross_entropy
        ce, z = fused_cross_entropy(out, head, targets,
                                    tied=cfg.tie_embeddings,
                                    z_loss_coef=z_loss_coef,
                                    logit_softcap=cfg.logit_softcap,
                                    n_chunks=fused_ce_chunks)
    else:
        ce, z = _ce_and_zloss(out, targets, z_loss_coef)
    return ce, z, aux


def loss_aux_and_grads(model: LlamaModel, params: Params,
                       batch: torch.Tensor, z_loss_coef: float = 0.0,
                       trainable_mask: Optional[Params] = None,
                       fused_ce_chunks: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor,
                                  tuple[torch.Tensor, ...]]:
    """(mean NLL, router aux, gradients of the trainable leaves in
    ``_leaves(trainable(params, trainable_mask))`` order) of one batch of
    tokens (B, S + 1): inputs [:, :-1], targets [:, 1:]; the gradients are
    of the NLL plus the router aux plus the z-loss term (the JAX step's
    objective). A leaf the objective does not reach (DeepSeek-V3's
    ``router_bias``, which only selects experts) gets a zero gradient, as
    ``jax.grad`` gives it, so the optimizer still decays it and the global
    norm counts it."""
    leaves = _leaves(trainable(params, trainable_mask))
    ce, z, aux = _loss(model, params, batch[:, :-1], batch[:, 1:],
                       z_loss_coef, fused_ce_chunks)
    grads = torch.autograd.grad(ce + aux + z, leaves, allow_unused=True)
    grads = tuple(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
    return ce.detach(), aux.detach(), grads


def loss_and_grads(model: LlamaModel, params: Params, batch: torch.Tensor,
                   z_loss_coef: float = 0.0,
                   trainable_mask: Optional[Params] = None,
                   fused_ce_chunks: int = 0
                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """``loss_aux_and_grads`` without the aux: (mean NLL, gradients)."""
    ce, _, grads = loss_aux_and_grads(model, params, batch, z_loss_coef,
                                      trainable_mask, fused_ce_chunks)
    return ce, grads


def make_train_step(model: LlamaModel, optimizer: Optimizer,
                    grad_accum_steps: int = 1, z_loss_coef: float = 0.0,
                    trainable_mask: Optional[Params] = None,
                    fused_ce_chunks: int = 0):
    """(params, opt_state, batch, before_update=None) -> metrics,
    updating params and state in place. batch: tokens (B, S + 1); inputs
    are [:, :-1], targets [:, 1:]. ``grad_accum_steps`` > 1 runs that many
    microbatches, rows m::accum (strided, as the JAX step splits them),
    and averages their gradients before the one update; the accumulators
    exist for the trainable leaves alone. ``before_update`` runs just
    before the parameters are written (the trainer waits there for a
    checkpoint's staging copy). ``loss`` is the NLL, ``aux_loss`` the
    router aux (both averaged over the microbatches) and ``grad_norm``
    the global norm before the clip."""

    def grads_of(params, batch):
        return loss_aux_and_grads(model, params, batch, z_loss_coef,
                                  trainable_mask, fused_ce_chunks)

    def step(params: Params, opt_state: dict, batch: torch.Tensor,
             before_update: Optional[Callable[[], None]] = None) -> dict:
        if grad_accum_steps > 1:
            b = batch.shape[0]
            if b % grad_accum_steps:
                raise ValueError(f"batch {b} not divisible by "
                                 f"grad_accum_steps {grad_accum_steps}")
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in
                     _leaves(trainable(params, trainable_mask))]
            ce = aux = torch.zeros((), device=batch.device)
            for m in range(grad_accum_steps):
                ce_m, aux_m, g_m = grads_of(params,
                                            batch[m::grad_accum_steps])
                for acc, g in zip(grads, g_m):
                    acc.add_(g)
                ce, aux = ce + ce_m, aux + aux_m
                del g_m
            scale = 1.0 / grad_accum_steps
            for g in grads:
                g.mul_(scale)
            ce, aux = ce * scale, aux * scale
        else:
            ce, aux, grads = grads_of(params, batch)
        if before_update is not None:
            before_update()
        gnorm = optimizer.update(grads, opt_state, params)
        return {"loss": ce, "aux_loss": aux, "grad_norm": gnorm}

    return step


def synthetic_batches(cfg: LlamaConfig, tc: TrainConfig, seed: int = 0,
                      device=None) -> Iterator[torch.Tensor]:
    """Deterministic synthetic token stream (B, S + 1), drawn from a
    ``torch.Generator`` seeded with ``seed`` (it cannot reproduce the JAX
    package's ``jax.random`` stream; the parity tests feed numpy batches to
    both)."""
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    while True:
        batch = torch.randint(0, cfg.vocab_size,
                              (tc.batch_size, tc.seq_len + 1),
                              generator=gen, dtype=torch.int32)
        yield batch.to(dev)


# the profiler range around each optimizer step of ``Trainer.run``
STEP_RANGE = "train_step"
_CKPT = re.compile(r"^step_(\d+)\.pt$")
_KEEP_CHECKPOINTS = 3   # as the JAX trainer's orbax manager keeps
# pinned staging buffers kept for the next save, at most this many bytes:
# pinning is slow and pinned pages stay out of the host's reach, so leaves
# past the cap stage through pageable memory (the copy then holds the host
# until it is done), allocated for one save and freed once its write lands
_PINNED_STAGING_BYTES = 4 << 30


class CheckpointWriter:
    """The checkpoints of one directory, written one at a time in a
    background thread. ``stage`` copies a step's params and optimizer
    state into host memory (on the card from a side stream into pinned
    buffers, kept for the next save up to ``_PINNED_STAGING_BYTES``, the
    rest into pageable memory; ``event`` marks the copy's end), then
    the thread writes the file under a temporary name, renames it into
    place, prunes to the newest three and logs ``checkpoint saved at step
    N``. ``wait`` joins the write and raises its error, if it had one: a
    write that failed renames nothing, so the newest durable checkpoint
    stays the previous one."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.event: Optional[torch.cuda.Event] = None
        self.step: Optional[int] = None          # the write in flight
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = None
        self._host: dict[str, torch.Tensor] = {}    # pinned, reused
        self._pinned_bytes = 0
        # called in the writer thread with the temporary file once it is
        # written, before the rename: a raise there is a write interrupted
        # before it became durable (tests)
        self.before_rename: Optional[Callable[[Path], None]] = None

    def checkpoints(self) -> list[tuple[int, Path]]:
        """(step, path) of every durable checkpoint, oldest first."""
        if not self.root.is_dir():
            return []
        found = [(int(m.group(1)), self.root / m.group(0))
                 for m in map(_CKPT.match, os.listdir(self.root)) if m]
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        """The newest step saved or in flight (None: none)."""
        steps = [s for s, _ in self.checkpoints()]
        if self.step is not None:
            steps.append(self.step)
        return max(steps, default=None)

    def _to_host(self, key: str, x):
        if isinstance(x, dict):
            return {k: self._to_host(f"{key}/{k}", v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x.clone()
        host = self._host.get(key)
        if host is None or host.shape != x.shape or host.dtype != x.dtype:
            if host is not None:
                del self._host[key]
                self._pinned_bytes -= host.nbytes
            nbytes = x.numel() * x.element_size()
            pin = self._pinned_bytes + nbytes <= _PINNED_STAGING_BYTES
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            if pin:
                self._host[key] = host
                self._pinned_bytes += nbytes
        # into pageable memory the copy returns only once it is done
        host.copy_(x, non_blocking=True)
        return host

    def stage(self, step: int, state: dict) -> None:
        """Snapshot ``state`` (a tree of tensors and plain values) as step
        ``step`` into host memory and start its write, after any write in
        flight has finished (one at a time, as orbax's manager)."""
        self.wait()
        state = {"step": step, **state}
        cuda = [t for t in _leaves(state) if isinstance(t, torch.Tensor)
                and t.is_cuda]
        self.event = None
        if cuda:
            device = cuda[0].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                snap = self._to_host("", state)
            self.event = torch.cuda.Event()
            self.event.record(self._stream)
        else:
            snap = self._to_host("", state)
        self.root.mkdir(parents=True, exist_ok=True)
        self.step = step
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, self.event),
            name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _write(self, step: int, snap: dict, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            path = self.root / f"step_{step:08d}.pt"
            tmp = path.with_name(f".{os.getpid()}.{path.name}")
            try:
                torch.save(snap, tmp)
                if self.before_rename is not None:
                    self.before_rename(tmp)
                os.replace(tmp, path)
            finally:
                tmp.unlink(missing_ok=True)
            for _, old in self.checkpoints()[:-_KEEP_CHECKPOINTS]:
                old.unlink(missing_ok=True)
            log.info("checkpoint saved at step %d", step)
        except Exception as e:  # noqa: BLE001 — raised again by wait()
            log.exception("checkpoint write at step %d failed", step)
            self._error = e

    def wait(self) -> None:
        """Block until the write in flight is durable; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.step = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("checkpoint write failed; the newest durable "
                               "checkpoint is the previous one") from err


def _copy_into(dst, src, where: str = "") -> None:
    """Copy a loaded tree into the trainer's own, leaf by leaf, in place;
    raises when the two trees differ in structure."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint{where or ' root'} holds {sorted(src)}, "
                         f"this trainer {sorted(dst)}")
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_into(d, src[k], f"{where}/{k}")
        else:
            d.copy_(src[k])


class Trainer:
    """Training on one card: init (or given params), LoRA adapters, the
    step loop with telemetry, evaluation and checkpoints (async in the
    loop). ``device`` defaults to ``cuda`` and raises without a card.
    ``mesh``, an in-process ``parallel.Mesh``, goes to the model, as the
    JAX trainer passes its mesh (with seq > 1 attention runs as ring
    attention over the sequence shards). ``lora`` (a
    ``models.lora.LoraConfig``) wraps the target projections with fresh
    adapters drawn from ``seed + 1`` and freezes the rest; ``telemetry``
    (a ``workloads.telemetry.TrainingTelemetry``) is fed every step."""

    def __init__(self, cfg: LlamaConfig, tc: TrainConfig, seed: int = 0,
                 initial_params: Optional[Params] = None, device=None,
                 mesh=None, lora: Optional[Any] = None,
                 telemetry: Optional[Any] = None):
        if mesh is not None and not mesh.in_process:
            raise ValueError(
                "training over a process group is not ported (ROADMAP "
                "Queue 1 #7.8: each rank its token shard and the gradients "
                "all-reduced over the group); pass an in-process mesh")
        if mesh is not None and mesh.tensor > 1:
            raise ValueError(
                f"tensor = {mesh.tensor}: tensor-parallel training is not "
                "ported (ROADMAP Queue 1 #7.8, FSDP/TP over NCCL); the "
                "port's tensor meshes serve")
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.telemetry = telemetry
        # True once any step has run: the first step of a fresh process is
        # charged to the ledger's compile bucket, as in the JAX trainer
        self._compiled = False
        self.device = resolve_device(device)
        self.model = LlamaModel(cfg, self.device, mesh)
        if initial_params is not None:
            params = _map(lambda p: p.detach().to(self.device,
                                                  cfg.param_dtype).clone(),
                          initial_params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            # under LoRA every drawn leaf is frozen: drawn straight into
            # the dtype _hold_frozen_in would give it (the same values, as
            # the f32 draw rounded), never a whole f32 tree (63 GB at
            # DeepSeek-V2-Lite's 15.7 B)
            params = init_params(cfg, gen, self.device,
                                 master=lora is None)
        self.trainable_mask = None
        if lora is not None:
            from ..models.lora import apply_lora, lora_mask
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            params = apply_lora(cfg, params, lora, gen, self.device,
                                dtype=cfg.param_dtype)
            self.trainable_mask = lora_mask(params)
            _hold_frozen_in(params, self.trainable_mask, cfg.dtype)
        self.params = params
        for p in _leaves(trainable(params, self.trainable_mask)):
            p.requires_grad_()
        self.optimizer = make_optimizer(tc, self.trainable_mask)
        self.opt_state = self.optimizer.init(self.params)
        step = make_train_step(self.model, self.optimizer,
                               grad_accum_steps=tc.grad_accum_steps,
                               z_loss_coef=tc.z_loss_coef,
                               trainable_mask=self.trainable_mask,
                               fused_ce_chunks=tc.fused_ce_chunks)
        self.step_fn = lambda params, opt_state, batch: step(
            params, opt_state, batch, before_update=self._await_staging)
        self.step = 0
        self.checkpoints = (CheckpointWriter(tc.checkpoint_dir)
                            if tc.checkpoint_dir else None)
        self._staged: Optional[torch.cuda.Event] = None
        self._fingerprint: Optional[list[int]] = None

    # -- checkpoint / resume ---------------------------------------------------

    def _await_staging(self) -> None:
        """Before an update writes params and moments in place: the
        device's stream waits for a checkpoint's staging copy of them."""
        if self._staged is not None:
            torch.cuda.current_stream(self.device).wait_event(self._staged)
            self._staged = None

    def save(self, block: bool = True) -> None:
        """Checkpoint params, optimizer state and step. A direct call
        blocks until the file is durable; the loop's saves pass
        ``block=False``: the state is staged into host memory and written
        in the background, and the telemetry's exposure marker moves only
        when ``wait_pending`` has seen the write land. A step already
        saved or in flight is not written again (orbax's manager skips
        it)."""
        ck = self.checkpoints
        if ck is None:
            return
        span = (self.telemetry.checkpoint("save", step=self.step,
                                          durable=block)
                if self.telemetry is not None else contextlib.nullcontext())
        latest = ck.latest_step()
        fresh = latest is None or latest < self.step
        with span:
            if fresh:
                ck.stage(self.step, self._checkpoint_state())
                self._staged = ck.event
            if block:
                ck.wait()
        if not block:
            log.info("checkpoint staged at step %d (write in background)",
                     self.step)
        elif not fresh and latest != self.step:
            # the step's own write logged the marker when it landed
            log.info("checkpoint saved at step %d", self.step)

    def wait_pending(self) -> None:
        """Block until any in-flight checkpoint write is durable."""
        if self.checkpoints is not None:
            self.checkpoints.wait()
            if self.telemetry is not None:
                # the staged save is durable: the exposure baseline moves
                # to its staging point
                self.telemetry.checkpoint_durable()

    def restore(self) -> bool:
        """Load the newest checkpoint into the trainer's own tensors, if
        there is one (an in-flight write lands first); False when there is
        none."""
        self.wait_pending()
        found = self.checkpoints.checkpoints() if self.checkpoints else []
        if not found:
            return False
        step, path = found[-1]
        if self.telemetry is not None:
            with self.telemetry.checkpoint("restore", step=step):
                self._restore_from(path)
        else:
            self._restore_from(path)
        return True

    def _checkpoint_state(self) -> dict:
        """What a checkpoint holds: the trainable parameters (all of them
        without a mask) and the optimizer state; for a LoRA run, in place
        of the frozen leaves, their fingerprint (``frozen_fingerprint``)."""
        state = {"params": trainable(self.params, self.trainable_mask),
                 "opt_state": self.opt_state}
        if self.trainable_mask is not None:
            state["frozen"] = self.frozen_fingerprint()
        return state

    def frozen_fingerprint(self) -> list[int]:
        """``bits_sum`` of each frozen leaf, in ``_leaves`` order: a LoRA
        checkpoint names the base it was trained over with it (the base
        is rebuilt from the same seed or weights on resume, and never
        changes), so a resume over another base is refused."""
        if self._fingerprint is None:
            self._fingerprint = [bits_sum(p) for p in _leaves(self.params)
                                 if not p.requires_grad]
        return self._fingerprint

    @torch.no_grad()
    def _restore_from(self, path: Path) -> None:
        state = torch.load(path, map_location="cpu", weights_only=True,
                           mmap=True)
        if state.get("frozen") != (self.frozen_fingerprint()
                                   if self.trainable_mask is not None
                                   else None):
            raise ValueError(f"{path} was written over other frozen weights "
                             "(or another LoRA setting) than this trainer's")
        _copy_into(trainable(self.params, self.trainable_mask),
                   state["params"])
        _copy_into({"mu": self.opt_state["mu"], "nu": self.opt_state["nu"]},
                   {"mu": state["opt_state"]["mu"],
                    "nu": state["opt_state"]["nu"]})
        self.opt_state["count"] = state["opt_state"]["count"]
        self.step = state["step"]
        log.info("resumed from checkpoint step %d", self.step)

    # -- eval ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, batches: Optional[Iterator] = None,
                 steps: int = 10) -> dict:
        """Mean next-token NLL and perplexity over ``steps`` held-out
        batches of the microbatch size (through the fused loss when the
        training loss is fused, so the eval never builds the logits
        either; an MoE model routed at its training capacity, as the JAX
        eval's forward routes)."""
        if batches is None:
            etc = dataclasses.replace(
                self.tc, batch_size=max(1, self.tc.batch_size
                                        // max(1, self.tc.grad_accum_steps)))
            batches = synthetic_batches(self.cfg, etc, seed=10_000_019,
                                        device=self.device)
        total = 0.0
        for _ in range(steps):
            batch = next(batches)
            ce, _, _ = _loss(self.model, self.params, batch[:, :-1],
                             batch[:, 1:], 0.0, self.tc.fused_ce_chunks)
            total += float(ce)
        nll = total / max(steps, 1)
        return {"eval_loss": nll, "eval_ppl": math.exp(nll),
                "eval_steps": steps}

    # -- loop ------------------------------------------------------------------

    def run(self, steps: Optional[int] = None,
            batches: Optional[Iterator] = None) -> dict:
        """Run ``steps`` optimizer steps (default ``tc.steps``); returns
        steps, final_loss, grad_norm, wall_s, first_step_s and tokens_per_s
        (over the whole run, first step included), and with telemetry its
        goodput, mfu and lost_s. The loop's checkpoints are durable when it
        returns (the wait is outside ``wall_s``)."""
        steps = steps or self.tc.steps
        batches = batches or synthetic_batches(self.cfg, self.tc,
                                               device=self.device)
        metrics: dict[str, Any] = {}
        tel = self.telemetry
        if tel is not None:
            tel.run_started(self.step, compiled=self._compiled)
        t0 = time.perf_counter()
        first_step_s = None
        t_step = t0
        for _ in range(steps):
            # one profiler range a step (free without a profiler): a
            # train_main --profile-dir trace counts its steps by it
            with torch.profiler.record_function(STEP_RANGE):
                metrics = self.step_fn(self.params, self.opt_state,
                                       next(batches))
            if first_step_s is None:
                float(metrics["loss"])      # waits for the device
                first_step_s = time.perf_counter() - t0
            self.step += 1
            if tel is not None:
                # sync every step: the recorded step time is device time,
                # not dispatch time (the telemetry contract)
                loss = float(metrics["loss"])
                now = time.perf_counter()
                tel.record_step(self.step, now - t_step, loss=loss)
                t_step = now
            if (self.tc.checkpoint_dir
                    and self.step % self.tc.checkpoint_every == 0):
                self.save(block=False)
                t_step = time.perf_counter()  # save time is not step time
        final_loss = float(metrics["loss"])
        self._compiled = True
        wall = time.perf_counter() - t0
        # the loop's staged writes are durable before the run reports done
        self.wait_pending()
        out = {"steps": steps, "final_loss": final_loss,
               "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
               "first_step_s": first_step_s,
               "tokens_per_s": (self.tc.batch_size * self.tc.seq_len
                                * steps / wall)}
        if tel is not None:
            out.update(tel.run_finished({"steps": steps}))
        return out


def bits_sum(t: torch.Tensor) -> int:
    """A position-weighted int64 sum of a tensor's raw bits, on its device a
    chunk at a time: bit-identical tensors give equal sums, a changed
    element a different one (short of a collision)."""
    flat = t.detach().reshape(-1)
    flat = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    chunk = 1 << 26
    for i in range(0, flat.numel(), chunk):
        part = flat[i:i + chunk].to(torch.int64)
        total += (part * (torch.arange(i, i + part.numel(),
                                       device=flat.device) % 65521 + 1)).sum()
    return int(total)


def _hold_frozen_in(tree: Params, mask: Params, dtype: torch.dtype) -> None:
    """Replace each frozen floating leaf by its ``dtype`` copy, in place:
    every use casts it to the compute dtype anyway (``llama._mm``, the
    embedding gather, the fused loss's head chunks), so the numbers do not
    change. Norms stay f32 (RMSNorm applies them in f32), as do the
    adapters' scales."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _hold_frozen_in(leaf, mask[name], dtype)
        elif (not mask[name] and leaf.is_floating_point()
              and not keeps_f32(name) and name != "scale"):
            tree[name] = leaf.to(dtype)
