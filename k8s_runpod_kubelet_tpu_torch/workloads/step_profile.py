"""Where a paged step's time goes on the card: one decode step (8 slots)
and one 1024-token prefill chunk of a model, profiled with
``torch.profiler``, device time summed by kernel family.

Run on a machine with one NVIDIA card:

    python -m k8s_runpod_kubelet_tpu_torch.workloads.step_profile \
        --model llama3-8b

Prints one JSON object (also written to ``--out`` if given): per phase
the wall time of a step (host clock around work that ends in a
synchronize), the device time by family (the paged attention kernel, the
RMSNorm kernel, GEMMs, the arena scatter, everything else), the device's
busy share of the wall time, and the card's name and power limit.
Weights are random from a fixed seed; the arena holds random K/V. Device
times the profiler cannot see read "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..device import resolve_device
from ..models import MODEL_CONFIGS, LlamaModel, init_params

SEED = 0
CHUNK = 1024                              # the engine's max_prefill_len
STEPS = 10                                # profiled decode steps
# one decode context length per slot (serve_main's default 8 slots): those
# of the 200-900-token prompts the chip smoke serves
DECODE_LENGTHS = (402, 475, 468, 252, 411, 789, 881, 571)

FAMILIES = (
    ("paged_attention_multi", ("paged_attention_multi_kernel",)),
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="llama3-8b",
                   choices=list(MODEL_CONFIGS))
    p.add_argument("--out", default="",
                   help="also write the JSON object to this file")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")   # raises without a card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = MODEL_CONFIGS[args.model]()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    model = LlamaModel(cfg, dev)
    t, cols = 16, 128                     # 16-token pages, cache_len 2048
    b = len(DECODE_LENGTHS)
    arena = model.init_paged_arena(b * cols + cols, t)
    for a in arena.values():
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
           "decode": dict(_profile(decode, STEPS), slots=b,
                          lengths=lengths.tolist()),
           "prefill": dict(_profile(prefill, STEPS // 3),
                           chunk=CHUNK)}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
