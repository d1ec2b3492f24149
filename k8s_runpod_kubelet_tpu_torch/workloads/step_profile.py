"""Where a step's time goes on the card: one paged decode step (8 slots),
one 1024-token prefill chunk, and one training step of the model's widths
at 4 layers (batch 8 x seq 2048, remat "full", f32 master weights),
profiled with ``torch.profiler``, device time summed by kernel family.

Run on a machine with one NVIDIA card:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b [--int4] [--kv-int8]
    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model mla-8b [--kv-int8]

With ``--int4`` and ``--kv-int8`` the serving steps run the memory-lean
deployment (the weights quantized on the card as ``ServingEngine`` does,
the arena int8 with its scale sections) and the training step, which
never sees quantized weights, is left out. ``--model mla-8b`` profiles
the serving steps over the latent arena (int8 latents with
``--kv-int8``); an MLA model has no training step in this port.

Prints one JSON object (also written to ``--out`` if given): per phase
the wall time of a step (host clock around work that ends in a
synchronize), the device time by family (the attention kernels, the
RMSNorm kernel, GEMMs, the arena scatter, everything else), the device's
busy share of the wall time, ``rms_norm`` alone at the chunk's shape
(mean device time beside its byte bound), and the card's name and power
limit.
Weights are random from a fixed seed; the arena holds random K/V; the
training step sees one seeded batch. Device times the profiler cannot see
read "not measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import time

import torch

from ..device import resolve_device
from ..models import MODEL_CONFIGS, LlamaModel, init_params
from ..models.quant import quantize_params

SEED = 0
CHUNK = 1024                              # the engine's max_prefill_len
STEPS = 10                                # profiled decode steps
# one decode context length per slot (serve_main's default 8 slots): those
# of the 200-900-token prompts the chip smoke serves
DECODE_LENGTHS = (402, 475, 468, 252, 411, 789, 881, 571)

TRAIN_LAYERS = 4                          # the widths at the depth one card holds
TRAIN_BATCH, TRAIN_SEQ = 8, 2048          # train_main's defaults

FAMILIES = (
    ("MLA quant attention", ("paged_attention_multi_mla_quant_kernel",)),
    ("MLA attention", ("paged_attention_multi_mla_kernel",)),
    ("MLA split merge", ("mla_merge_kernel",)),
    ("quant attention", ("paged_attention_multi_quant_kernel",)),
    ("paged split merge", ("paged_attention_merge_kernel",)),
    ("int4 GEMM", ("int4_matmul",)),
    ("paged_attention_multi", ("paged_attention_multi_kernel",)),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_dq", ("flash_dq_kernel",)),
    ("flash_dkv", ("flash_dkv_kernel",)),
    ("rms_norm", ("_rms_kernel",)),
    ("gemm", ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("arena_scatter", ("index_put", "indexing_backward", "scatter")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def _profile(fn, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    by_family: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if us <= 0:
            continue
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us / 1e3 / steps
        kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3 / steps
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    device_ms = sum(by_family.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if device_ms else "not measured",
            "device_busy_share": (device_ms / wall_ms if device_ms
                                  else "not measured"),
            "device_ms_by_family": by_family or "not measured",
            "top_kernels_ms": dict(top)}


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


def _train_profile(cfg, dev) -> dict:
    from .train import TrainConfig, Trainer, synthetic_batches

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    tc = TrainConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     warmup_steps=1)
    trainer = Trainer(cfg, tc, seed=SEED, device=dev)
    batches = itertools.repeat(next(synthetic_batches(cfg, tc, seed=SEED,
                                                      device=dev)))
    torch.cuda.reset_peak_memory_stats()
    prof = _profile(lambda: trainer.run(steps=1, batches=batches), 3)
    return dict(prof, layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / prof["wall_ms"] * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="llama3-8b",
                   choices=list(MODEL_CONFIGS))
    p.add_argument("--out", default="",
                   help="also write the JSON object to this file")
    p.add_argument("--int4", action="store_true",
                   help="int4 weights (serving steps only)")
    p.add_argument("--kv-int8", action="store_true",
                   help="an int8 arena (serving steps only)")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")   # raises without a card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = MODEL_CONFIGS[args.model]()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    if args.int4:
        params = quantize_params(cfg, params, bits=4)
    model = LlamaModel(cfg, dev)
    t, cols = 16, 128                     # 16-token pages, cache_len 2048
    b = len(DECODE_LENGTHS)
    arena = model.init_paged_arena(b * cols + cols, t,
                                   quantize=args.kv_int8)
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

    def decode():
        model.paged_decode_step(params, tokens, arena, tables, lengths)

    chunk_tokens = torch.randint(0, cfg.vocab_size, (1, CHUNK),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
    chunk_table = torch.arange(b * cols, b * cols + cols, dtype=torch.int32,
                               device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    true_len = torch.tensor([CHUNK], dtype=torch.int32, device=dev)

    def prefill():
        model.paged_prefill_chunk_step(params, chunk_tokens, arena,
                                       chunk_table, zero, true_len)

    out = {"card": card, "model": cfg.name, "torch": torch.__version__,
           "weights": "int4" if args.int4 else "bf16",
           "kv": "int8" if args.kv_int8 else "bf16",
           "decode": dict(_profile(decode, STEPS), slots=b,
                          lengths=lengths.tolist()),
           "prefill": dict(_profile(prefill, STEPS // 3),
                           chunk=CHUNK),
           "rms_norm": _norm_profile(cfg, dev, gen)}
    del params, arena
    torch.cuda.empty_cache()
    if not (args.int4 or args.kv_int8 or cfg.is_mla):
        out["train"] = _train_profile(cfg, dev)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
