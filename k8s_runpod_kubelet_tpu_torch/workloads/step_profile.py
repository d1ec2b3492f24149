"""Where a step's time goes on the card: one paged decode step (8 slots),
one 1024-token prefill chunk, and one training step of the model's widths
at 4 layers (batch 8 x seq 2048, remat "full", f32 master weights),
profiled with ``torch.profiler``, device time summed by kernel family.

Run on a machine with one NVIDIA card:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b [--int4] [--kv-int8]
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model mla-8b [--kv-int8]
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model mixtral-8x7b --int4
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model deepseek-v2-lite [--int4] [--kv-int8]
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model gemma-7b | mistral-7b | qwen2-7b | qwen3-8b [--int4] [--kv-int8]

A windowed interleave (``--model gemma2-9b`` or ``gemma3-12b``), and any
model with ``--prefix-cache off``, serves from the contiguous loop: its
decode step is profiled instead, eagerly and as a ``DecodeGraph`` replay
in turns, over the batch cache a ``--cache-len 8192`` engine of 8 slots
with 1024-token chunks builds (linear, ring or mixed, random values, the
slots at the same contexts), with a 1024-token chunk through
``prefill_chunk_step`` on a single cache of the same layout:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model gemma2-9b | gemma3-12b [--int4] [--kv-int8]
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b --prefix-cache off

With ``--seq N`` only training is profiled, at the same 16,384 tokens a
step in rows of N x 2048 positions (``--seq 4``: batch 2 x 8192): the
step on an in-process mesh of N sequence shards with ``ring_flash`` (ring
attention, the flash kernels at each ring offset; ``train_ring``) beside
the unsharded flash step at the same batch (``train``):

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b --seq 4

With ``--speculate K`` a speculative verify step is profiled too: one
``paged_verify_step`` at K + 1 tokens over the same 8 slots and contexts,
every row written (``n_tokens`` = K + 1), the step a ``--speculate K``
engine runs when its slots are greedy.

Each of those steps is also profiled as the serving engine runs it on a
card, a replay of its ``StepGraph`` (one CUDA graph, fed by one
host-to-card copy of the slots' values), beside the eager step in turns:
eager, graph, graph, eager (``decode_graph`` and ``verify_graph``). One
more replay is traced alone: the kernels the profiler counts by name must
equal the launches the capture recorded for each kernel wrapper.

With ``--lora-rank R`` (and ``--lora-targets``, default wq,wv) the
serving steps are profiled once more beside the same steps without
adapters (``lora``): the decode step as a graph replay over the 8 slots
with a mixed batch of adapter ids (the base and LORA_ADAPTERS adapters of
rank R, random stacks allocated as a multi-LoRA engine allocates them),
the base replay and the adapter replay in turns (base, lora, lora, base),
and a 1024-token chunk under adapter 1 beside the same chunk without
adapters; the stacks' bytes and the kernels counted in one replay of each
(the deltas are plain PyTorch products, no counted kernel):

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b --lora-rank 16 \
        [--lora-targets wq,wk,wv,wo,w_gate,w_up,w_down]

With ``--tensor-parallel N`` the serving steps are profiled twice on the
one card: on one device (``tp1``) and then on an in-process tensor mesh of
N shards (``tp``: the weights laid out by ``parallel.shard_params``, the
arena's kv heads sharded, every int4 product one ``int4_matmul_sharded``
launch and the paged kernel once a shard), the same weights and inputs
over an arena drawn from the same seed, so the decode replay's and the
chunk's device time by family compare within one call:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b --int4 --kv-int8 --tensor-parallel 2

With ``--int4`` and ``--kv-int8`` the serving steps run the memory-lean
deployment (the weights quantized on the card as ``ServingEngine`` does,
the arena int8 with its scale sections) and the training step, which
never sees quantized weights, is left out; ``--int4`` weights are drawn
and quantized a layer at a time (``init_quantized_params``, the serve
CLI's way), so a model whose bf16 tree does not fit the card
(mixtral-8x7b, 93 GB) profiles too. Such a model (``SERVE_INT4_ONLY``)
profiles its training step alone without ``--int4``:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model mixtral-8x7b

``--model mla-8b`` profiles the serving steps over the latent arena (int8
latents with ``--kv-int8``) and, without ``--kv-int8``, the training step
in MLA's direct form (the flash kernels at head_dim + rope_dim = 192;
``--seq N`` its ring too). Only the models in ``TRAINED`` profile a
training step: llama3-8b, llama31-8b and mla-8b at 4 layers, the MoE
models mixtral-8x7b at 2 and deepseek-v2-lite at 4 (its dense prefix layer
and 3 routed ones, the flash kernels at D = 192); the other dense families
(gemma-7b, mistral-7b, qwen2-7b, qwen3-8b, llama3-70b) profile their
serving steps only (gemma-7b's 256000-entry vocabulary alone makes the
train batch's f32 logits 16.8 GB). An MoE model's expert products are
their own family, ``int4 experts`` (the ``int4_expert_matmul`` kernel);
in bf16 they are ``torch.bmm`` GEMMs, named as any other, so the eager
steps run each expert product inside a profiler range and its kernels'
device time moves from ``gemm`` to ``experts``, and in a training step
so do the kernels of each ``bmm``'s backward (the autograd node
``BmmBackward0``; the remat recompute runs inside the range again). A
graph replay has no ranges: its ``gemm`` keeps them.

Prints one JSON object (also written to ``--out`` if given): per phase
the wall time of a step (host clock around work that ends in a
synchronize), the device time by family (the attention kernels, the
RMSNorm kernel, GEMMs, the arena scatter, the running sums, everything
else), the device's
busy share of the wall time, ``rms_norm`` alone at the chunk's shape
(mean device time beside its byte bound), and the card's name and power
limit.
Weights are random from a fixed seed; the arena holds random K/V; the
training step sees one seeded batch. Device times the profiler cannot see
read "not measured".
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import time

import torch

from ..device import resolve_device
from ..models import MODEL_CONFIGS, LlamaModel, init_params
from ..models.quant import init_quantized_params
from ..parallel import MeshConfig, make_mesh, shard_params
from .serving.engine import ServingEngine
from .serving.scheduler import ServingConfig
from .serving.step_graph import KERNEL_NAMES, DecodeGraph, StepGraph

SEED = 0
CHUNK = 1024                              # the engine's max_prefill_len
# the contiguous loop's profiled engine: gemma2-9b's 4096 window rings
# (5120 slots) only past 5120 positions
CONTIG_CACHE_LEN = 8192
STEPS = 10                                # profiled decode steps
# one decode context length per slot (serve_main's default 8 slots): those
# of the 200-900-token prompts the chip smoke serves
DECODE_LENGTHS = (402, 475, 468, 252, 411, 789, 881, 571)

# --lora-rank: adapters registered beside the base, and the slots' ids
LORA_ADAPTERS = 4
LORA_IDS = (0, 1, 2, 3, 4, 1, 2, 3)

TRAIN_LAYERS = 4                          # the widths at the depth one card holds
# ... except where the widths hold less: Mixtral-8x7B's 1.41 B expert
# parameters a layer (f32 master weights, gradients and Adam moments, 16
# bytes each) fit 2 layers
TRAIN_DEPTH = {"mixtral-8x7b": 2}
TRAIN_BATCH, TRAIN_SEQ = 8, 2048          # train_main's defaults
# the models whose training the port runs (chip_smoke phases 9, 9m and
# 9e); the others profile their serving steps only
TRAINED = ("llama3-8b", "llama31-8b", "mla-8b", "mixtral-8x7b",
           "deepseek-v2-lite")
# the models whose bf16 tree does not fit the card: their serving steps
# profile with --int4 only, and without it their training step alone
SERVE_INT4_ONLY = ("mixtral-8x7b",)

FAMILIES = (
    ("MLA quant attention", ("paged_attention_multi_mla_quant_kernel",)),
    ("MLA attention", ("paged_attention_multi_mla_kernel",)),
    ("MLA split merge", ("mla_merge_kernel",)),
    ("quant attention", ("paged_attention_multi_quant_kernel",)),
    ("paged split merge", ("paged_attention_merge_kernel",)),
    ("int4 experts", ("int4_expert_matmul",)),
    ("int4 GEMM", ("int4_matmul",)),
    ("paged_attention_multi", ("paged_attention_multi_kernel",)),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_dq", ("flash_dq_kernel",)),
    ("flash_dkv", ("flash_dkv_kernel",)),
    ("rms_norm", ("_rms_kernel",)),
    ("gemm", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("arena_scatter", ("index_put", "indexing_backward", "scatter")),
    # running sums (torch.cumsum): the MoE routing's positions, the
    # sampler's top-p
    ("scan", ("scan",)),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def trace_kernel_events(path: str) -> dict:
    """The kernel events of a Chrome trace ``torch.profiler`` wrote (a
    ``GET /debug/profile`` capture, whose CUPTI activity names each kernel
    a graph replay launches), by family (FAMILIES, else "other"): the
    events' count and their device time in ms."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out: dict[str, dict] = {}
    for ev in events:
        if str(ev.get("cat", "")).lower() != "kernel":
            continue
        fam = out.setdefault(_family(str(ev.get("name", ""))),
                             {"count": 0, "ms": 0.0})
        fam["count"] += 1
        fam["ms"] += float(ev.get("dur", 0.0)) / 1e3
    return out


# the profiler range each MoE expert product runs in while profiled
EXPERTS_RANGE = "moe_expert_matmul"
# the autograd node of an expert product's backward (in a training step
# the only ``bmm``); the profiler records it under either name
EXPERTS_BACKWARD = ("BmmBackward0",
                    "autograd::engine::evaluate_function: BmmBackward0")


def train_layers(name: str) -> int:
    """The depth a training step of model ``name`` is profiled at."""
    return TRAIN_DEPTH.get(name, TRAIN_LAYERS)


@contextlib.contextmanager
def _experts_marked():
    """``models.moe``'s expert products each inside the profiler range
    ``EXPERTS_RANGE`` while the block runs (this tool's own wrapper; the
    serving path itself carries no range)."""
    from ..models import moe

    inner = moe._expert_matmul

    def marked(*args, **kwargs):
        with torch.profiler.record_function(EXPERTS_RANGE):
            return inner(*args, **kwargs)

    moe._expert_matmul = marked
    try:
        yield
    finally:
        moe._expert_matmul = inner


def _profile(fn, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    with _experts_marked(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    by_family: dict[str, float] = {}
    kernels: dict[str, float] = {}
    experts_us = 0.0
    backward_us = dict.fromkeys(EXPERTS_BACKWARD, 0.0)
    device_us: dict[str, float] = {}
    # the events themselves, summed by name as key_averages would, without
    # its totals over every host event (most of a long trace's seconds)
    for ev in prof.events():
        if ev.key == EXPERTS_RANGE:
            # the range's host event sums the device time of the kernels
            # launched inside it; its device-side annotation is no kernel
            if ev.device_type == torch.autograd.DeviceType.CPU:
                experts_us += ev.device_time_total
            continue
        if ev.key in backward_us:
            # the same kernels under both names: the larger sum counts
            if ev.device_type == torch.autograd.DeviceType.CPU:
                backward_us[ev.key] += ev.device_time_total
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us[ev.key] = (device_us.get(ev.key, 0.0)
                                 + ev.self_device_time_total)
    for key, us in device_us.items():
        if us <= 0:
            continue
        fam = _family(key)
        by_family[fam] = by_family.get(fam, 0.0) + us / 1e3 / steps
        kernels[key] = kernels.get(key, 0.0) + us / 1e3 / steps
    experts_us += max(backward_us.values())
    if experts_us and "int4 experts" not in by_family \
            and "gemm" in by_family:
        # the bf16 expert products' GEMMs: their own family
        ms = min(experts_us / 1e3 / steps, by_family["gemm"])
        by_family["gemm"] -= ms
        by_family["experts"] = ms
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    device_ms = sum(by_family.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if device_ms else "not measured",
            "device_busy_share": (device_ms / wall_ms if device_ms
                                  else "not measured"),
            "device_ms_by_family": by_family or "not measured",
            "top_kernels_ms": dict(top)}


def kernel_counts(fn) -> dict:
    """Kernels of one call of ``fn``, counted by name (KERNEL_NAMES) in a
    torch.profiler trace, or "not measured" if it shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    seen = False
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        seen = True
        for wrapper, kernel in KERNEL_NAMES.items():
            if kernel in ev.key:
                counts[wrapper] += ev.count
    return counts if seen else "not measured"


def _graph_turns(eager, graph: StepGraph, params, arena, host) -> dict:
    """The eager step and its graph's replay in turns (eager, graph,
    graph, eager), then one replay's kernels by name against the
    launches the capture recorded."""
    def replay():
        graph.run(params, arena, *host)

    out = {label: _profile(fn, STEPS) for label, fn in
           (("eager", eager), ("graph", replay), ("graph_2", replay),
            ("eager_2", eager))}
    want = {w: graph.launches_per_replay[w] for w in KERNEL_NAMES}
    counts = graph.kernels_in_graph()
    if counts != want:
        raise RuntimeError(f"one replay launched {counts}, the capture "
                           f"recorded {want}")
    return dict(out, kernels_in_one_replay=counts,
                launches_per_replay=want,
                capture_memory=graph.capture_memory)


def _norm_profile(cfg, dev, gen) -> dict:
    """``rms_norm`` alone at a chunk's shape (CHUNK x E bf16, an f32
    weight): the kernel's mean device time over 20 launches, the L2
    flushed before each, beside its byte bound (x read and y written once,
    the weight once, at the H100's 3.35 TB/s)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import rms_norm

    x = torch.randn((CHUNK, cfg.embed_dim), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    w = torch.ones(cfg.embed_dim, device=dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        rms_norm(x, w, cfg.norm_eps)
    torch.cuda.synchronize()
    launches = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            flush.zero_()
            rms_norm(x, w, cfg.norm_eps)
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and _family(ev.key) == "rms_norm")
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    return {"rows": CHUNK, "width": cfg.embed_dim,
            "device_ms": us / 1e3 / launches if us else "not measured",
            "bound_ms": nbytes / 3.35e12 * 1e3, "launches": launches}


def _train_profile(cfg, dev, seq: int = 1, ring: bool = False) -> dict:
    """One training step at ``train_layers`` over TRAIN_BATCH x TRAIN_SEQ
    tokens, in rows of ``seq`` x TRAIN_SEQ positions; with ``ring`` on an
    in-process mesh of ``seq`` sequence shards with ``ring_flash``."""
    from ..parallel import MeshConfig, make_mesh
    from .train import TrainConfig, Trainer, synthetic_batches

    layers = train_layers(cfg.name)
    cfg = dataclasses.replace(cfg, n_layers=layers, ring_flash=ring)
    batch, seq_len = TRAIN_BATCH // seq, TRAIN_SEQ * seq
    mesh = make_mesh(MeshConfig(seq=seq)) if ring else None
    tc = TrainConfig(batch_size=batch, seq_len=seq_len, warmup_steps=1)
    trainer = Trainer(cfg, tc, seed=SEED, device=dev, mesh=mesh)
    batches = itertools.repeat(next(synthetic_batches(cfg, tc, seed=SEED,
                                                      device=dev)))
    torch.cuda.reset_peak_memory_stats()
    prof = _profile(lambda: trainer.run(steps=1, batches=batches), 3)
    return dict(prof, layers=layers, batch=batch, seq_len=seq_len,
                seq_shards=seq if ring else 1,
                tokens_per_s=batch * seq_len / prof["wall_ms"] * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="llama3-8b",
                   choices=[n for n in MODEL_CONFIGS if n != "deepseek-v3"])
    p.add_argument("--out", default="",
                   help="also write the JSON object to this file")
    p.add_argument("--int4", action="store_true",
                   help="int4 weights (serving steps only)")
    p.add_argument("--kv-int8", action="store_true",
                   help="an int8 arena (serving steps only)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="also profile a verify step of K drafts (K + 1 "
                        "rows a slot)")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="N",
                   help="profile the serving steps on one device and on an "
                        "in-process tensor mesh of N shards")
    p.add_argument("--lora-rank", type=int, default=0, metavar="R",
                   help="also profile the decode replay and the chunk with "
                        "multi-LoRA adapters of rank R (mixed ids) beside "
                        "the same steps without")
    p.add_argument("--lora-targets", default="wq,wv",
                   help="the adapters' projections (with --lora-rank)")
    p.add_argument("--prefix-cache", default="on", choices=["on", "off"],
                   help="off: profile the contiguous loop's decode step "
                        "(as does a windowed interleave either way)")
    p.add_argument("--seq", type=int, default=0, metavar="N",
                   help="profile only training: a ring step over N "
                        "sequence shards beside the unsharded step, rows "
                        "of N x 2048 positions")
    args = p.parse_args(argv)
    if args.seq and (args.seq < 2 or TRAIN_BATCH % args.seq):
        p.error(f"--seq must be at least 2 and divide {TRAIN_BATCH}")
    if args.tensor_parallel < 1 or (args.tensor_parallel > 1 and args.seq):
        p.error("--tensor-parallel must be at least 1, and profiles the "
                "serving steps, not --seq's training")
    if args.lora_rank < 0 or (args.lora_rank and args.seq):
        p.error("--lora-rank must be at least 0, and profiles the serving "
                "steps, not --seq's training")
    dev = resolve_device("cuda")   # raises without a card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = MODEL_CONFIGS[args.model]()
    if args.seq:
        if args.int4 or args.kv_int8 or cfg.name not in TRAINED:
            p.error("--seq profiles the training step, which this model "
                    "or these flags do not have")
        out = {"card": card, "model": cfg.name, "torch": torch.__version__,
               "train": _train_profile(cfg, dev, args.seq),
               "train_ring": _train_profile(cfg, dev, args.seq, ring=True)}
        return _emit(out, args.out)
    if cfg.name in SERVE_INT4_ONLY and not args.int4:
        if (args.kv_int8 or args.speculate or args.tensor_parallel > 1
                or args.lora_rank or args.prefix_cache == "off"):
            p.error(f"{cfg.name}'s serving steps need --int4 (its bf16 "
                    "tree does not fit the card); without it only its "
                    "training step is profiled")
        out = {"card": card, "model": cfg.name, "torch": torch.__version__,
               "train": _train_profile(cfg, dev)}
        return _emit(out, args.out)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the same draws either way: init_quantized_params gives
    # quantize_params(init_params(...)) without the bf16 tree
    params = (init_quantized_params(cfg, gen, 4, dev) if args.int4
              else init_params(cfg, gen, dev))
    out = {"card": card, "model": cfg.name, "torch": torch.__version__,
           "weights": "int4" if args.int4 else "bf16",
           "kv": "int8" if args.kv_int8 else "bf16"}
    contiguous = (args.prefix_cache == "off"
                  or (cfg.sliding_window is not None
                      and cfg.sliding_window_pattern > 1))
    if contiguous:
        if args.tensor_parallel > 1 or args.lora_rank or args.speculate:
            p.error("the contiguous loop's profile takes no "
                    "--tensor-parallel, --lora-rank or --speculate "
                    "(chip_smoke.py phase 7g (e) and (f) time its verify "
                    "and tensor-parallel replays)")
        out.update(_contiguous(cfg, dev, params, args))
        return _emit(out, args.out)
    if args.tensor_parallel > 1:
        out["tp1"] = _serving(cfg, dev, params, args, None)
        mesh = make_mesh(MeshConfig(tensor=args.tensor_parallel))
        # in place: the one-device tree becomes the shards' leaf by leaf
        out["tp"] = dict(_serving(cfg, dev, shard_params(cfg, params, mesh),
                                  args, mesh),
                         tensor=args.tensor_parallel)
        return _emit(out, args.out)
    out.update(_serving(cfg, dev, params, args, None))
    if args.lora_rank:
        out["lora"] = lora_profile(
            cfg, dev, params, args.lora_rank,
            tuple(t for t in args.lora_targets.split(",") if t),
            kv_int8=args.kv_int8)
    del params
    torch.cuda.empty_cache()
    if not (args.int4 or args.kv_int8) and cfg.name in TRAINED:
        out["train"] = _train_profile(cfg, dev)
    return _emit(out, args.out)


def _serving_inputs(model, dev, kv_int8: bool, gen) -> dict:
    """The serving steps' inputs: an arena of random values (8 slots'
    tables of 128 16-token pages and one more table for the chunk), the
    slots' contexts and tokens, a 1024-token chunk."""
    cfg = model.cfg
    t, cols = 16, 128                     # 16-token pages, cache_len 2048
    b = len(DECODE_LENGTHS)
    arena = model.init_paged_arena(b * cols + cols, t, quantize=kv_int8)
    for name, a in arena.items():
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        elif name.endswith("scale"):
            a.uniform_(0.005, 0.02, generator=gen)
        else:
            a.normal_(generator=gen)
    tables = torch.arange(b * cols, dtype=torch.int32,
                          device=dev).reshape(b, cols)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                           device=dev, dtype=torch.int32)
    return {"arena": arena, "tables": tables, "lengths": lengths,
            "tokens": tokens, "cols": cols,
            "chunk_tokens": torch.randint(0, cfg.vocab_size, (1, CHUNK),
                                          generator=gen, device=dev,
                                          dtype=torch.int32),
            "chunk_table": torch.arange(b * cols, b * cols + cols,
                                        dtype=torch.int32, device=dev)[None],
            "zero": torch.zeros(1, dtype=torch.int32, device=dev),
            "true_len": torch.tensor([CHUNK], dtype=torch.int32, device=dev)}


def _serving(cfg, dev, params, args, mesh) -> dict:
    """The serving steps of ``params`` (a tree laid out for ``mesh``, None
    on one device): decode eagerly and as a graph replay in turns, a
    prefill chunk, ``rms_norm`` alone, and with ``--speculate`` the verify
    step, over an arena of random values from the seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    model = LlamaModel(cfg, dev, mesh)
    inp = _serving_inputs(model, dev, args.kv_int8, gen)
    arena, tables, lengths, tokens, cols = (
        inp[k] for k in ("arena", "tables", "lengths", "tokens", "cols"))
    b = len(DECODE_LENGTHS)

    def decode():
        model.paged_decode_step(params, tokens, arena, tables, lengths)

    def prefill():
        model.paged_prefill_chunk_step(params, inp["chunk_tokens"], arena,
                                       inp["chunk_table"], inp["zero"],
                                       inp["true_len"])

    # the engine's graphs over the same slots: one pool, captured before
    # any profiled step, as an engine captures at start()
    pool = torch.cuda.graph_pool_handle()
    host = [x.cpu().numpy() for x in (tokens, lengths, tables)]
    active = [True] * b
    graphs = {1: StepGraph(model, 1, b, cols)}
    if args.speculate > 0:
        kk = args.speculate + 1
        graphs[kk] = StepGraph(model, kk, b, cols)
    for g in graphs.values():
        g.capture(params, arena, pool)
    out = {"decode": dict(_profile(decode, STEPS), slots=b,
                          lengths=lengths.tolist()),
           "decode_graph": _graph_turns(decode, graphs[1], params, arena,
                                        (*host, active)),
           "prefill": dict(_profile(prefill, STEPS // 3),
                           chunk=CHUNK),
           "rms_norm": _norm_profile(cfg, dev, gen)}
    if args.speculate > 0:
        drafts = torch.randint(0, cfg.vocab_size, (b, kk), generator=gen,
                               device=dev, dtype=torch.int32)
        n_tokens = torch.full((b,), kk, dtype=torch.int32, device=dev)

        def verify():
            model.paged_verify_step(params, drafts, arena, tables, lengths,
                                    n_tokens=n_tokens)

        out["verify"] = dict(_profile(verify, STEPS), slots=b, k=kk,
                             lengths=lengths.tolist())
        out["verify_graph"] = _graph_turns(
            verify, graphs[kk], params, arena,
            (drafts.cpu().numpy(), *host[1:], active,
             n_tokens.cpu().numpy()))
    del arena, graphs, g, inp
    torch.cuda.empty_cache()
    return out


def fill_contiguous_cache(cache: dict, gen, lengths) -> None:
    """Fill a contiguous cache's sections with random values, each row's
    index at ``lengths`` and a ring's ``abs_pos`` at the last position
    below it that each slot holds."""
    for name, a in cache.items():
        if name in ("index", "abs_pos"):
            continue
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=a.device, dtype=torch.int8))
        elif name.endswith("scale"):
            a.uniform_(0.005, 0.02, generator=gen)
        else:
            a.normal_(generator=gen)
    idx = cache["index"]
    idx.copy_(lengths)
    if "abs_pos" in cache:
        r = cache["abs_pos"].shape[1]
        slot = torch.arange(r, device=idx.device)[None, :]
        last = idx.long()[:, None] - 1
        held = last - (last - slot) % r
        cache["abs_pos"].copy_(torch.where(held >= 0, held, -1))


def _contiguous(cfg, dev, params, args) -> dict:
    """The contiguous loop's steps: the batch cache of an engine with 8
    slots, ``CONTIG_CACHE_LEN`` positions and ``CHUNK``-token chunks (its
    ``_pick_ring_len``), random values, the slots at ``DECODE_LENGTHS``;
    the decode step eagerly and as a ``DecodeGraph`` replay in turns, and
    one ``CHUNK``-token ``prefill_chunk_step`` on a single cache of the
    same layout. Each decode call advances the slots' indices by one."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b = len(DECODE_LENGTHS)
    sc = ServingConfig(slots=b, cache_len=CONTIG_CACHE_LEN,
                       max_prefill_len=CONTIG_CACHE_LEN // 2,
                       serving_chunk_tokens=CHUNK, prefix_cache_enabled=False,
                       quantize_kv_int8=args.kv_int8)
    ring = ServingEngine._pick_ring_len(cfg, sc)
    model = LlamaModel(cfg, dev)

    def fresh(batch):
        return ServingEngine.contiguous_cache(model, sc, ring, batch)

    cache = fresh(b)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    fill_contiguous_cache(cache, gen, lengths)
    tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                           device=dev, dtype=torch.int32)
    single = fresh(1)
    fill_contiguous_cache(single, gen,
                          torch.zeros(1, dtype=torch.int32, device=dev))
    chunk = torch.randint(0, cfg.vocab_size, (1, CHUNK), generator=gen,
                          device=dev, dtype=torch.int32)
    true_len = torch.tensor([CHUNK], dtype=torch.int32, device=dev)

    def decode():
        model.decode_step(params, tokens, cache, check=False)

    def prefill():
        single["index"].zero_()
        model.prefill_chunk_step(params, chunk, single, true_len)

    graph = DecodeGraph(model, b)
    graph.capture(params, cache, torch.cuda.graph_pool_handle())
    host = (tokens.cpu().numpy(), [True] * b)
    out = {"cache_layout": ServingEngine.contiguous_layout(cfg, ring),
           "ring_len": ring, "cache_len": sc.cache_len,
           "cache_bytes": sum(a.numel() * a.element_size()
                              for a in cache.values()),
           "decode": dict(_profile(decode, STEPS), slots=b,
                          lengths=list(DECODE_LENGTHS)),
           "decode_graph": _graph_turns(decode, graph, params, cache, host),
           "prefill": dict(_profile(prefill, STEPS // 3), chunk=CHUNK),
           "rms_norm": _norm_profile(cfg, dev, gen)}
    del cache, single, graph
    torch.cuda.empty_cache()
    return out


def lora_stacks(cfg, rank: int, targets, gen, dev,
                n: int = LORA_ADAPTERS) -> dict:
    """Multi-LoRA stacks as ``ServingEngine`` allocates them for ``n``
    adapters (slot 0 zero, the base), slots 1..n random: A ~ N(0, 1/in),
    B ~ N(0, 0.02^2), scale 1."""
    from .serving import ServingConfig, ServingEngine

    dims = ServingEngine.lora_dims(cfg, ServingConfig(
        lora_rank=rank, lora_targets=tuple(targets), max_adapters=n))
    out = {}
    for t in targets:
        din, dout = dims[t]
        a = torch.randn((cfg.n_layers, n + 1, din, rank), generator=gen,
                        device=dev) / din ** 0.5
        b = torch.randn((cfg.n_layers, n + 1, rank, dout), generator=gen,
                        device=dev) * 0.02
        scale = torch.ones((cfg.n_layers, n + 1), device=dev)
        for x in (a, b, scale):
            x[:, 0] = 0
        out[t] = {"a": a.to(cfg.dtype), "b": b.to(cfg.dtype),
                  "scale": scale}
    return out


def lora_profile(cfg, dev, params, rank: int, targets, kv_int8=False,
                 mesh=None) -> dict:
    """The decode step as a graph replay and a 1024-token chunk, with
    multi-LoRA adapters of ``rank`` over ``targets`` (the 8 slots' ids
    LORA_IDS, the chunk under adapter 1) beside the same steps without
    adapters, in turns (base, lora, lora, base); the stacks' bytes and the
    kernels counted by name in one replay of each graph (equal: the deltas
    launch no counted kernel)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    model = LlamaModel(cfg, dev, mesh)
    inp = _serving_inputs(model, dev, kv_int8, gen)
    arena = inp["arena"]
    stacks = lora_stacks(cfg, rank, targets, gen, dev)
    b = len(DECODE_LENGTHS)
    ids = torch.tensor(LORA_IDS[:b], dtype=torch.int32, device=dev)
    pool = torch.cuda.graph_pool_handle()
    graphs = {"base": StepGraph(model, 1, b, inp["cols"]),
              "lora": StepGraph(model, 1, b, inp["cols"])}
    graphs["base"].capture(params, arena, pool)
    graphs["lora"].capture(params, arena, pool, stacks)
    host = [x.cpu().numpy() for x in (inp["tokens"], inp["lengths"],
                                      inp["tables"])]
    kw = {"base": {}, "lora": {"adapters": stacks,
                               "adapter_ids": ids.cpu().numpy()}}

    def replay(which):
        return lambda: graphs[which].run(params, arena, *host, [True] * b,
                                         **kw[which])

    def chunk(which):
        ad = ({} if which == "base" else
              {"adapters": stacks, "adapter_ids": ids[1:2]})
        return lambda: model.paged_prefill_chunk_step(
            params, inp["chunk_tokens"], arena, inp["chunk_table"],
            inp["zero"], inp["true_len"], **ad)

    decode = {label: _profile(replay(which), STEPS) for label, which in
              (("base", "base"), ("lora", "lora"), ("lora_2", "lora"),
               ("base_2", "base"))}
    counts = {}
    for w, g in graphs.items():
        want = {k: g.launches_per_replay[k] for k in KERNEL_NAMES}
        counts[w] = g.kernels_in_graph()
        if counts[w] != want:
            raise RuntimeError(f"one {w} replay launched {counts[w]}, the "
                               f"capture recorded {want}")
    if graphs["base"].launches_per_replay \
            != graphs["lora"].launches_per_replay:
        raise RuntimeError("the adapters changed the counted launches: "
                           f"{graphs['lora'].launches_per_replay}")
    prefill = {label: _profile(chunk(which), STEPS // 3) for label, which in
               (("base", "base"), ("lora", "lora"), ("lora_2", "lora"),
                ("base_2", "base"))}
    out = {"rank": rank, "targets": list(targets),
           "adapters": LORA_ADAPTERS, "ids": list(LORA_IDS[:b]),
           "stack_bytes": sum(x.numel() * x.element_size()
                              for ad in stacks.values()
                              for x in ad.values()),
           "decode_graph": decode, "prefill": dict(prefill, chunk=CHUNK),
           "kernels_in_one_replay": counts,
           "launches_per_replay": graphs["lora"].launches_per_replay}
    del arena, graphs, inp, stacks
    torch.cuda.empty_cache()
    return out


def _emit(out: dict, path: str) -> int:
    text = json.dumps(out)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
