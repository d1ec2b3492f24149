"""Training on one card: loss, optimizer, train step, data, checkpoints.

Port of the JAX package's ``workloads/train.py`` for the dense Llama
decoder: f32 master parameters, bf16 compute through ``LlamaModel.forward``
(flash attention kernels, RMSNorm kernel, remat per layer; under an
in-process mesh with seq > 1, ring attention over the sequence shards),
the loss of ``_ce_and_zloss``, and the optimizer written out with
optax's exact semantics (``clip_by_global_norm`` then ``adamw`` on a
``warmup_cosine_decay_schedule``). Checkpoints are ``torch.save`` files and
log the two markers the kubelet parses: ``checkpoint saved at step N`` and
``resumed from checkpoint step N``.

Not ported yet: the fused chunked cross-entropy, LoRA, telemetry, async
checkpoints, elastic ``resize``, and training over a process group (each
rank its token shard, the gradients all-reduced over the group).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from ..device import resolve_device
from ..models.llama import LlamaConfig, LlamaModel, Params, init_params

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
      applies to every leaf (norm weights too);
    - the clip scales by ``grad_clip / norm`` only when ``norm >=
      grad_clip`` (optax's ``select(norm < max, g, g / norm * max)``; the
      two agree at equality), with no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``.

    State is ``{"count": int, "mu": tree, "nu": tree}``; ``update`` changes
    the parameters in place."""

    def __init__(self, schedule: Callable[[int], float], grad_clip: float,
                 weight_decay: float):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay

    def init(self, params: Params) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
        return {"count": 0, "mu": _map(zeros, params),
                "nu": _map(zeros, params)}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: dict,
               params: Params) -> torch.Tensor:
        """Apply one update for ``grads`` (in ``_leaves(params)`` order);
        returns their global norm before the clip."""
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(_leaves(params), grads, _leaves(state["mu"]),
                                _leaves(state["nu"])):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            mu_hat = mu / (1 - B1 ** count)
            nu_hat = nu / (1 - B2 ** count)
            step = mu_hat / (nu_hat.sqrt() + EPS) + self.weight_decay * p
            p.add_(step, alpha=-lr)
        state["count"] = count
        return norm


def make_optimizer(tc: TrainConfig) -> Optimizer:
    schedule = warmup_cosine_decay(
        0.0, tc.learning_rate, tc.warmup_steps,
        max(tc.steps, tc.warmup_steps + 1))
    return Optimizer(schedule, tc.grad_clip, tc.weight_decay)


def loss_and_grads(model: LlamaModel, params: Params, batch: torch.Tensor,
                   z_loss_coef: float = 0.0
                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """(mean NLL, gradients in ``_leaves(params)`` order) of one batch of
    tokens (B, S + 1): inputs [:, :-1], targets [:, 1:]; the gradients are
    of the NLL plus the z-loss term."""
    leaves = _leaves(params)
    logits = model.forward(params, batch[:, :-1])
    ce, z = _ce_and_zloss(logits, batch[:, 1:], z_loss_coef)
    del logits
    grads = torch.autograd.grad(ce + z, leaves)
    return ce.detach(), grads


def make_train_step(model: LlamaModel, optimizer: Optimizer,
                    grad_accum_steps: int = 1, z_loss_coef: float = 0.0):
    """(params, opt_state, batch) -> metrics, updating params and state in
    place. batch: tokens (B, S + 1); inputs are [:, :-1], targets [:, 1:].
    ``grad_accum_steps`` > 1 runs that many microbatches, rows m::accum
    (strided, as the JAX step splits them), and averages their gradients
    before the one update. ``grad_norm`` is the global norm before the
    clip."""

    def step(params: Params, opt_state: dict, batch: torch.Tensor) -> dict:
        if grad_accum_steps > 1:
            b = batch.shape[0]
            if b % grad_accum_steps:
                raise ValueError(f"batch {b} not divisible by "
                                 f"grad_accum_steps {grad_accum_steps}")
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in _leaves(params)]
            ce = torch.zeros((), device=batch.device)
            for m in range(grad_accum_steps):
                ce_m, g_m = loss_and_grads(model, params,
                                           batch[m::grad_accum_steps],
                                           z_loss_coef)
                for acc, g in zip(grads, g_m):
                    acc.add_(g)
                ce = ce + ce_m
                del g_m
            scale = 1.0 / grad_accum_steps
            for g in grads:
                g.mul_(scale)
            ce = ce * scale
        else:
            ce, grads = loss_and_grads(model, params, batch, z_loss_coef)
        gnorm = optimizer.update(grads, opt_state, params)
        return {"loss": ce, "aux_loss": torch.zeros_like(ce),
                "grad_norm": gnorm}

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


_CKPT = re.compile(r"^step_(\d+)\.pt$")
_KEEP_CHECKPOINTS = 3   # as the JAX trainer's orbax manager keeps


class Trainer:
    """Training on one card: init (or given params), the step loop,
    evaluation and blocking ``torch.save`` checkpoints. ``device``
    defaults to ``cuda`` and raises without a card. ``mesh``, an
    in-process ``parallel.Mesh``, goes to the model, as the JAX trainer
    passes its mesh (with seq > 1 attention runs as ring attention over
    the sequence shards)."""

    def __init__(self, cfg: LlamaConfig, tc: TrainConfig, seed: int = 0,
                 initial_params: Optional[Params] = None, device=None,
                 mesh=None):
        if cfg.n_experts:
            raise ValueError(
                f"{cfg.name}: training a sparse-MoE model is not ported (the "
                "MoE training slice: the router's load-balance and z losses "
                "in the objective, capacity drops, and the expert "
                "gradients); MoE configs serve only")
        interleave = [f for f, on in (
            ("sliding_window_pattern", cfg.sliding_window_pattern != 1),
            ("attn_logit_softcap", cfg.attn_logit_softcap is not None),
            ("logit_softcap", cfg.logit_softcap is not None),
            ("query_pre_attn_scalar", cfg.query_pre_attn_scalar is not None),
            ("post_norms", cfg.post_norms),
            ("rope_local_theta", cfg.rope_local_theta is not None)) if on]
        if interleave:
            raise ValueError(
                f"{cfg.name}: training Gemma 2 and 3 ({interleave}) is not "
                "ported (ROADMAP Queue 1 #3.4: their flash backward at D "
                "256 meets dK/dV's spill); these configs serve only")
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
        self.device = resolve_device(device)
        self.model = LlamaModel(cfg, self.device, mesh)
        if initial_params is not None:
            params = _map(lambda p: p.detach().to(self.device,
                                                  cfg.param_dtype).clone(),
                          initial_params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device, master=True)
        self.params = _map(lambda p: p.requires_grad_(), params)
        self.optimizer = make_optimizer(tc)
        self.opt_state = self.optimizer.init(self.params)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       grad_accum_steps=tc.grad_accum_steps,
                                       z_loss_coef=tc.z_loss_coef)
        self.step = 0

    # -- checkpoint / resume ---------------------------------------------------

    def _checkpoints(self) -> list[tuple[int, Path]]:
        root = Path(self.tc.checkpoint_dir)
        if not root.is_dir():
            return []
        found = [(int(m.group(1)), root / m.group(0))
                 for m in map(_CKPT.match, os.listdir(root)) if m]
        return sorted(found)

    def save(self) -> None:
        """Checkpoint params, optimizer state and step; durable when it
        returns (written to a temporary name, then renamed). Keeps the
        newest three."""
        if not self.tc.checkpoint_dir:
            return
        root = Path(self.tc.checkpoint_dir)
        root.mkdir(parents=True, exist_ok=True)
        path = root / f"step_{self.step:08d}.pt"
        tmp = path.with_name(f".{os.getpid()}.{path.name}")
        torch.save({"step": self.step,
                    "params": _map(torch.Tensor.detach, self.params),
                    "opt_state": self.opt_state}, tmp)
        os.replace(tmp, path)
        for _, old in self._checkpoints()[:-_KEEP_CHECKPOINTS]:
            old.unlink()
        log.info("checkpoint saved at step %d", self.step)

    def restore(self) -> bool:
        """Load the newest checkpoint, if any; False when there is none."""
        found = self._checkpoints() if self.tc.checkpoint_dir else []
        if not found:
            return False
        state = torch.load(found[-1][1], map_location=self.device,
                           weights_only=True)
        self.params = _map(lambda p: p.requires_grad_(), state["params"])
        self.opt_state = state["opt_state"]
        self.step = state["step"]
        log.info("resumed from checkpoint step %d", self.step)
        return True

    # -- eval ------------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, batches: Optional[Iterator] = None,
                 steps: int = 10) -> dict:
        """Mean next-token NLL and perplexity over ``steps`` held-out
        batches of the microbatch size."""
        if batches is None:
            etc = dataclasses.replace(
                self.tc, batch_size=max(1, self.tc.batch_size
                                        // max(1, self.tc.grad_accum_steps)))
            batches = synthetic_batches(self.cfg, etc, seed=10_000_019,
                                        device=self.device)
        total = 0.0
        for _ in range(steps):
            batch = next(batches)
            logits = self.model.forward(self.params, batch[:, :-1])
            total += float(cross_entropy_loss(logits, batch[:, 1:]))
        nll = total / max(steps, 1)
        return {"eval_loss": nll, "eval_ppl": math.exp(nll),
                "eval_steps": steps}

    # -- loop ------------------------------------------------------------------

    def run(self, steps: Optional[int] = None,
            batches: Optional[Iterator] = None) -> dict:
        """Run ``steps`` optimizer steps (default ``tc.steps``); returns
        steps, final_loss, grad_norm, wall_s, first_step_s and tokens_per_s
        (over the whole run, first step included)."""
        steps = steps or self.tc.steps
        batches = batches or synthetic_batches(self.cfg, self.tc,
                                               device=self.device)
        metrics: dict[str, Any] = {}
        t0 = time.perf_counter()
        first_step_s = None
        for _ in range(steps):
            metrics = self.step_fn(self.params, self.opt_state,
                                   next(batches))
            if first_step_s is None:
                float(metrics["loss"])      # waits for the device
                first_step_s = time.perf_counter() - t0
            self.step += 1
            if (self.tc.checkpoint_dir
                    and self.step % self.tc.checkpoint_every == 0):
                self.save()
        final_loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        return {"steps": steps, "final_loss": final_loss,
                "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
                "first_step_s": first_step_s,
                "tokens_per_s": (self.tc.batch_size * self.tc.seq_len
                                 * steps / wall)}
