#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version on the card, serves llama3-8b (full
width and depth, random bf16 weights from a seed) through the paged
engine and its HTTP front, in bf16 and then with int4 weights and an int8
KV arena, serves mla-8b (the same, with Multi-head Latent Attention) over
a bf16 and then an int8 latent arena, then trains Llama-3-8B widths at 4
layers.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failed check raises: the script exits nonzero and does not
print the final ``ok`` line):

1. card: name and power limit (nvidia-smi), printed before any number;
2. build: ``csrc/paged_attention_multi.cu``,
   ``csrc/paged_attention_multi_quant.cu``,
   ``csrc/paged_attention_multi_mla.cu``,
   ``csrc/paged_attention_multi_mla_quant.cu``, ``csrc/int4_matmul.cu`` and
   ``csrc/flash_attention.cu`` with nvcc for sm_90a (one nvcc each, started
   together), and the Triton RMSNorm kernel, with their seconds and ptxas
   register/spill lines; where the toolkit has ``cuobjdump``, the HGMMA
   (wgmma) and HMMA counts of every kernel of the six tensor-core sources
   (an instantiation of either paged kernel, ``paged_attention_multi`` or
   the int8-page ``paged_attention_multi_quant``, ``flash_fwd``,
   ``flash_dq``, ``flash_dkv``, either MLA latent kernel or a prefill-regime
   ``int4_matmul`` without HGMMA, or a decode-regime ``int4_matmul`` with
   neither HGMMA nor HMMA, fails the phase, as does a kernel missing from
   its library);
3. kernels vs plain on the card, at the shapes the 8B main path gives
   them: ``paged_attention_multi`` (decode K=1 B=8 with ragged lengths up
   to 2048, K=4 B=8, a 1024-token prefill chunk behind a 100-token
   prefix; tables carry stale ids of garbage pages past ceil(len/T)),
   ``paged_attention_multi_quant`` (the same three cases, over int8 pages
   the model's ``_kv_quant`` made from the same K/V), the
   single-token forms ``paged_attention`` and ``paged_attention_quant`` at
   the decode shape, ``int4_matmul`` at each distinct projection shape of
   the 8B model at 8 and 1024 rows, and
   ``rms_norm`` (8 and 1024 rows of 4096 for serving; x (8, 2048, 4096)
   needing gradients with an f32 weight for training, where y, dx and dw
   are each held against autograd of the plain version). Each case prints
   the max abs
   error and its share of the tolerance (each element within 1e-4 +
   1e-2 |plain|, 1.3 bf16 ulps; broken variants are scored against it
   and must read above 1x: for attention p.v accumulated in bf16, P
   rounded to bf16 before P.V and a page lost from the long contexts,
   for int8 pages also the scales
   ignored and each key's scales taken from the neighbouring kv head, for
   int4 the two nibbles of each byte swapped, each group
   given its neighbour's scale and each weight multiplied by its scale in
   bf16 before the product), the kernel's median time (CUDA events,
   L2 flushed before every launch), its bound (bytes over 3.35 TB/s or
   operations over the peak for their type, whichever is larger), the
   plain version's time, and one PyTorch library call's time for the
   same function (SDPA over the gathered K/V with the same mask,
   ``F.rms_norm``, ``torch.ops.aten._weight_int4pack_mm`` on the same
   nibbles and bf16 group scales, held to the plain version by relative
   L2, beside ``torch.matmul`` by the dequantized bf16 weight as a
   yardstick) or, where no single call takes the kernel's inputs (int8
   pages), a labelled yardstick (SDPA over the dequantized K/V), which the
   port itself never calls;
3b. MLA kernels vs plain at mla-8b's shapes (32 heads, latent 512, rope
   64, 16-token pages, f32 absorbed queries): ``paged_attention_multi_mla``
   and ``paged_attention_multi_mla_quant`` (int8 latents that the model's
   ``_kv_quant`` made) at decode K=1 B=8 over the burst's contexts
   (252-881) and at a 1024-token prefill chunk behind a 100-token prefix,
   and the single-token ``paged_attention_mla`` and
   ``paged_attention_mla_quant`` at the decode shape; the tolerance of
   phase 3, controls (the rope term dropped, a page lost, the causal floor
   off at K > 1, q in bf16 alone, the scales ignored for int8) that must
   read above 1x, the
   kernel's, the plain version's and a labelled SDPA yardstick's times
   (q = [q_lat, q_rope], k = [c, kr], v = c, one kv head), and the bound;
4. engine: ``ServingEngine`` for llama3-8b, 8 slots, cache_len 2048,
   16-token pages; 8 greedy requests of 200-900 prompt tokens (two share
   a 96-token prefix), 32 new tokens each. The launch counters are set to
   0 just before and read just after; all 8 must finish, the prefix hit
   must register, both kernels' counters must have risen. Launches are
   also read per path, each against the engine's own step counters: the
   decode-only stretch after the burst's last prefill, and a prefill-only
   stretch (a 1500-token prompt, two chunks, one new token); every step
   or chunk must launch the attention kernel once per layer and the norm
   kernel twice per layer plus once. The single-token forms, on no model
   path, are counted in the same way and must stay at 0, here and in 7b;
5. repeat: one prompt served twice more gives the same tokens both times;
6. HTTP: the front on a free port answers one POST /generate with 200;
7. drain: the engine drains and the pool holds zero leaked pages;
   before it, the independent check: the engine path's last-token logits
   for one measured prompt against a plain f32 forward of the same bf16
   weights (no paging, no kernels: ``_attention_plain`` and
   ``_rms_norm_plain``, one layer upcast at a time), within a relative L2
   limit that the same forward with one layer skipped must exceed;
7b. quantized engine: the bf16 engine freed, the engine the serve CLI
   builds from ``--int4 --kv-int8`` (8 slots, cache_len 2048) over the same
   seeded bf16 params, which it quantizes on the card; the same burst,
   stretches and repeat, each step or chunk launching exactly 32
   ``paged_attention_multi_quant``, 225 ``int4_matmul`` (7 a layer and the
   head), 65 ``rms_norm`` and no ``paged_attention_multi``,
   ``paged_attention`` or ``paged_attention_quant``; the weight and
   arena bytes and peak memory; the independent check against a plain
   f32 forward of the dequantized weights over unquantized K/V (its own
   limit, the same skipped-layer control), the gap to the bf16 engine's
   logits (information only), HTTP, drain with zero leaked pages;
7c. MLA engine: the engine the serve CLI builds from ``--model mla-8b``
   (8 slots, cache_len 2048, 16-token pages) over random bf16 weights from
   the same seed; its arena must be 2048 + 1 latent pages of 589,824 B;
   the same burst, stretches and repeat, each step or chunk launching
   exactly 32 ``paged_attention_multi_mla`` and 97 ``rms_norm`` (attn,
   c and mlp norms a layer and the final one) and no other attention
   kernel (the dense paged kernels, the int8 latent kernel and the
   single-token forms, all read from the counters); the independent check
   against a plain f32 forward in MLA's direct form (per-head K = [c w_uk,
   kr], V = c w_uv, ``_attention_plain`` at head_dim + rope_dim, no
   paging, no absorption, no kernels), limit 0.1, with the skipped-layer
   control; HTTP, drain with zero leaked pages;
7d. the same from ``--model mla-8b --kv-int8`` (int8 latents, pages of
   299,008 B), through ``paged_attention_multi_mla_quant``, the
   independent check at limit 0.15, and the gap to 7c's logits
   (information only); then the MLA weights are freed before training;
8. flash kernels vs plain on the card: ``flash_fwd``, ``flash_dq`` and
   ``flash_dkv`` at the training shape (B 8, Hq 32, Hkv 8, S 2048, D 128,
   causal), a ragged S=1000, D=64, D=256, GQA group 1, a window, a soft
   cap and non-causal. Each kernel is held per element against its plain
   version on the same inputs (the backward kernels take the forward
   kernel's lse and delta), with the tolerance of phase 3 (lse: 1e-4 +
   1e-5 |plain|, f32); the whole autograd path against autograd through
   ``_attention_plain`` in f32 (gradients within 1% of each tensor's
   largest magnitude: delta comes from the bf16 o, as in the JAX
   package); four broken controls scored with the same check (p.v
   accumulated in bf16 over 64-key tiles; P rounded to bf16 before P.V;
   dK/dV with one q head of each group dropped; dS and P rounded to bf16
   before the products that accumulate dq, dk and dv, each of the three
   scored and the least share kept; each must read above 1x); times of
   each kernel, its
   plain version and SDPA forward / autograd backward (no SDPA for a soft
   cap; the backward computes dq, dk and dv together, so it is the library
   time of both backward kernels), and its bound (operations over the
   bf16 tensor peak, or bytes);
9. train: ``Trainer`` on llama3-8b widths at 4 layers (f32 master
   params, bf16 compute, remat "full"), batch 8 x seq 2048, 6 steps with
   warmup_steps=1 on one seeded synthetic batch repeated (fresh random
   batches can teach the model nothing past the uniform unigram, so their
   loss need not fall in 6 steps; one batch repeated must, though the
   embedding and head alone could memorise it, so a falling loss does not
   show the gradients right): every loss finite and the last below the
   first. Before the run, the gradients of step 1 (same params, same
   batch) through ``loss_and_grads`` against autograd of the plain f32
   forward (``_attention_plain``, ``_rms_norm_plain``, one row at a time):
   each leaf's relative L2 error and the global norm's relative error
   within their limits, step 1's reported grad_norm too, and a control
   with the dK/dV kernel's output zeroed that must exceed the leaf limit;
   per
   step the launches are checked exactly (flash_fwd 2L, flash_dq L,
   flash_dkv L, rms_norm 4L+1: each layer's forward and its recompute);
   step wall, tokens/s and peak memory;
10. train_main: the CLI on ``--model tiny`` with a checkpoint directory,
   twice; the second life must log ``resumed from checkpoint step 2``.

The next-to-last line is the kernels JSON record (each kernel's
``launches`` counted on its own main path: the bf16 engine's burst for
``paged_attention_multi`` and ``rms_norm``, the quantized engine's burst
for ``paged_attention_multi_quant`` and ``int4_matmul``, the MLA engines'
bursts for ``paged_attention_multi_mla`` and
``paged_attention_multi_mla_quant``, the training run for the flash
kernels; the single-token forms lie on no model path, in this port as in
the JAX package, and count 0), the last line
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every
number (engine and training phases included) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
SEED = 20261016
# the kernels on the tensor cores, by source: every instantiation named so
# must hold wgmma instructions (HGMMA), except int4_matmul's decode regime
# (a tile of at most INT4_DECODE_ROWS rows), which may hold mma.sync (HMMA)
# instead; each name must be found in its library
TENSOR_CORE_KERNELS = {
    "paged_attention_multi": ("paged_attention_multi_kernel",),
    "paged_attention_multi_quant": ("paged_attention_multi_quant_kernel",),
    "flash_attention": ("flash_fwd_kernel", "flash_dq_kernel",
                        "flash_dkv_kernel"),
    "paged_attention_multi_mla": ("paged_attention_multi_mla_kernel",),
    "paged_attention_multi_mla_quant": (
        "paged_attention_multi_mla_quant_kernel",),
    "int4_matmul": ("int4_matmul_kernel",)}
INT4_DECODE_ROWS = 16
# Kernel and plain version both compute in f32 and round once to bf16, so
# they differ by at most one bf16 ulp of the output, which is <= 2^-7 |y|;
# RTOL is 1.3 ulps, ATOL covers f32 sum-order noise near zero. Both apply
# to each element against the plain version's |y|.
BF16_ATOL, BF16_RTOL = 1e-4, 1e-2
TOLERANCE = f"atol {BF16_ATOL} + rtol {BF16_RTOL}"
# the f32 lse of the flash forward: f32 sums in another order
F32_ATOL, F32_RTOL = 1e-4, 1e-5
# the flash gradients through autograd against autograd through the plain
# attention in f32: delta = rowsum(dO o) comes from the bf16 o in both the
# port and the JAX package, which moves dS by ~2^-8 |o| |dO| sqrt(D) per
# row; the gradients then sit within 1% of each tensor's largest magnitude
E2E_SCALE_RTOL = 1e-2
# the engine's last-token logits against the plain f32 forward of the same
# weights: relative L2 norm of the difference (the bf16 engine rounds at
# every layer of 32; see PERF.md for the readings this limit was set from)
ENGINE_REL_L2_LIMIT = 0.1
# the --int4 --kv-int8 engine's last-token logits against the plain f32
# forward of the same dequantized weights over unquantized K/V: the bf16
# activations of the bf16 engine (0.0588 there) plus the int8 rounding of
# every K/V row (half a step of amax/127, ~0.7% of a row's RMS). Set before
# the first run at 0.15: the skipped-layer control read 0.34 on bf16 weights
QUANT_ENGINE_REL_L2_LIMIT = 0.15
# the mla-8b engine's last-token logits against a plain f32 forward of the
# same weights in MLA's direct form (K and V materialised per head, no
# paging, no absorption): bf16 latents are held to the bf16 engine's limit;
# int8 latents add the int8 rounding of every c and kr row (half a step of
# amax/127), as the int8 arena did, and get the int8 arena's limit. Both set
# before the first run.
MLA_ENGINE_REL_L2_LIMIT = 0.1
MLA_INT8_ENGINE_REL_L2_LIMIT = 0.15
# the training gradients (bf16 compute through the kernels) against autograd
# of the plain f32 forward of the same f32 master params: relative L2 error
# of each leaf, and relative error of the global norm (see PERF.md for the
# readings these limits were set from: every leaf 0.025-0.034, the norm
# 2.6e-5; with dK/dV zeroed, wk and wv read 1.0 and the norm 0.27)
TRAIN_GRAD_REL_L2_LIMIT = 0.1
TRAIN_NORM_REL_LIMIT = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out.splitlines()[0]


def kernel_name(line: str):
    """The kernel named in a ptxas line by its mangled name (a length
    prefix, the identifier, then ``I...E`` integer or bool template
    arguments), as ``name<args>``; None if no ``*_kernel`` is named."""
    for i, ch in enumerate(line):
        if not ch.isdigit():
            continue
        for j in range(i + 1, min(i + 4, len(line)) + 1):
            if not line[i:j].isdigit():
                break
            n = int(line[i:j])
            ident = line[j:j + n]
            if len(ident) == n and ident.endswith("_kernel") \
                    and (ident[0].isalpha() or ident[0] == "_"):
                targs = re.match(r"I((?:L[ib]\d+E)+)", line[j + n:])
                if targs:
                    ident += "<" + ",".join(re.findall(
                        r"L[ib](\d+)E", targs.group(1))) + ">"
                return ident
    return None


def ptxas_summary(text: str) -> list[str]:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    name with template arguments, registers and spill bytes."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        if "entry function" in line or "Function properties" in line:
            name = kernel_name(line) or name
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
    return out


def sass_counts(lib_path: str) -> dict:
    """Tensor-core instructions of each kernel in a built library, from
    ``cuobjdump -sass``: {kernel name: {"HGMMA": n, "HMMA": n}} (wgmma
    lowers to HGMMA, mma.sync to HMMA); {} where the toolkit that holds
    nvcc has no cuobjdump."""
    from k8s_runpod_kubelet_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :", 1)[1].strip())
            if name is not None:
                out.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    out[name][op] += 1
    return out


def tensor_core_ok(kernel: str, counts: dict) -> bool:
    """Whether a tensor-core kernel's SASS holds what its regime needs:
    HGMMA, or for an ``int4_matmul_kernel<NR, ...>`` with NR <=
    INT4_DECODE_ROWS, HGMMA or HMMA."""
    m = re.match(r"int4_matmul_kernel<(\d+),", kernel)
    if m and int(m.group(1)) <= INT4_DECODE_ROWS:
        return counts["HGMMA"] + counts["HMMA"] > 0
    return counts["HGMMA"] > 0


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median of per-launch CUDA-event times, the L2 cache flushed before
    each launch (the main path finds these inputs cold)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------------

def tolerance_check(out, ref, atol=BF16_ATOL,
                    rtol=BF16_RTOL) -> tuple[float, float]:
    """(max abs error, largest share of the tolerance) of out against ref;
    a share above 1 fails the check."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    share = (diff / (atol + rtol * ref.abs())).max().item()
    err = diff.max().item()
    return err, (share if math.isfinite(err) else math.inf)


def attention_inputs(torch, dev, b, kq, lengths, t=16, cols=128):
    """llama3-8b shapes (32 q heads, 8 kv heads, D=128) at cache_len 2048:
    pages in random order, and table entries past ceil(len/T) naming
    pages of large finite garbage."""
    hq, hkv, d = 32, 8, 128
    gen = torch.Generator().manual_seed(SEED + kq)
    live = [-(-n // t) for n in lengths]
    n_garbage = 64
    n_pages = sum(live) + n_garbage
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        stale = torch.arange(cols - live[i]) % n_garbage
        table[i, live[i]:] = garbage[stale]
    k = torch.randn((n_pages, t, hkv, d), generator=gen)
    v = torch.randn((n_pages, t, hkv, d), generator=gen)
    k[garbage] = 3e4
    v[garbage] = -3e4
    q = torch.randn((b, kq, hq, d), generator=gen)
    q, k, v = (x.to(dev, torch.bfloat16) for x in (q, k, v))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, table.to(dev), lens, live


def gathered(torch, q, k, v, table, lens):
    """q as (B, Hq, K, D), K/V gathered into contiguous (B, Hq, S, D) with
    the GQA heads repeated, and the causal mask (B, 1, K, S)."""
    b, kq, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    s_len = table.shape[1] * t
    idx = table.long()
    kc = k[idx].reshape(b, s_len, hkv, d).transpose(1, 2) \
        .repeat_interleave(hq // hkv, dim=1).contiguous()
    vc = v[idx].reshape(b, s_len, hkv, d).transpose(1, 2) \
        .repeat_interleave(hq // hkv, dim=1).contiguous()
    qs = q.transpose(1, 2).contiguous()
    qpos = (lens.long()[:, None] - kq
            + torch.arange(kq, device=q.device)[None, :])[:, None, :, None]
    mask = torch.arange(s_len, device=q.device)[None, None, None, :] <= qpos
    return qs, kc, vc, mask


def bf16_p_output(torch, s, v):
    """The textbook tensor-core kernel's P.V: unnormalised probabilities
    exp(s - rowmax) of masked scores s (-inf where masked) rounded to bf16
    before the product with v, the row sum kept in f32."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return (e.bfloat16().float() @ v.float()) / e.sum(-1, keepdim=True)


def attention_controls(torch, qs, kc, vc, mask, scale, t, ref) -> dict:
    """The tolerance check applied to three broken variants of the same
    attention: p.v accumulated page by page in bf16, P rounded to bf16
    before P.V (the rounding the kernels' split of P into bf16 hi and lo
    halves avoids), and the second page lost from every context of 1024
    positions or more (rows with shorter contexts are left right, so the
    long rows alone are scored). A share of the tolerance above 1 means
    the check catches the fault."""
    b, h, kq, s_len = mask.shape[0], qs.shape[1], qs.shape[2], kc.shape[2]
    cols, d = s_len // t, qs.shape[3]
    s = (qs.float() @ kc.float().transpose(-1, -2)) * scale
    o_bf16_p = bf16_p_output(torch, s.masked_fill(~mask, -math.inf), vc) \
        .bfloat16().transpose(1, 2)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    part = torch.einsum("bhkct,bhctd->bhkcd", p.view(b, h, kq, cols, t),
                        vc.float().view(b, h, cols, t, d))
    acc = torch.zeros_like(part[:, :, :, 0]).bfloat16()
    for c in range(cols):
        acc = (acc.float() + part[:, :, :, c]).bfloat16()
    del part
    lost = mask.clone()
    lost[..., t:2 * t] = False
    p_lost = torch.softmax(s.masked_fill(~lost, -math.inf), dim=-1)
    o_lost = (p_lost @ vc.float()).bfloat16().transpose(1, 2)
    long_rows = (mask.sum(-1) >= 1024).transpose(1, 2)[..., None]
    o_lost = torch.where(long_rows, o_lost, ref)
    out = {}
    for name, o in (("bf16_accumulation", acc.transpose(1, 2)),
                    ("bf16_p", o_bf16_p), ("lost_page", o_lost)):
        err, share = tolerance_check(o, ref)
        out[name] = {"max_abs_err": err, "tolerance_share": share}
    return out


# the four paged entry points: (wrapper name, plain name, single-token
# (q (B, Hq, D)), int8 pages)
PAGED_KINDS = {
    "paged_attention_multi": ("_paged_attention_multi_plain", False, False),
    "paged_attention_multi_quant": ("_paged_attention_multi_quant_plain",
                                    False, True),
    "paged_attention": ("_paged_attention_plain", True, False),
    "paged_attention_quant": ("_paged_attention_quant_plain", True, True),
}


def attention_case(torch, F, dev, flush, kind, name, b, kq, lengths):
    """One paged entry point against its plain version at llama3-8b's
    shapes. The int8 kinds take pages that the model's own ``_kv_quant``
    made from the bf16 ones (the garbage pages stay large). Controls: p.v
    accumulated in bf16, P rounded to bf16 and a page lost (both kinds),
    the scales ignored and the neighbouring kv head's scales (int8 pages);
    each must read above 1x the tolerance."""
    from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
    from k8s_runpod_kubelet_tpu_torch.ops import attention

    wrapper = getattr(attention, kind)
    plain_name, single, quant = PAGED_KINDS[kind]
    plain_fn = getattr(attention, plain_name)
    q, k, v, table, lens, live = attention_inputs(torch, dev, b, kq, lengths)
    hq, d = q.shape[2], q.shape[3]
    t, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    if quant:
        (kp, ks), (vp, vs) = _kv_quant(k), _kv_quant(v)
        pages = (kp, vp, ks, vs)
        k = kp.float() * ks[..., None]   # what the pages stand for
        v = vp.float() * vs[..., None]
    else:
        pages = (k, v)
    qa = q[:, 0].contiguous() if single else q

    def kernel():
        return wrapper(qa, *pages, table, lens, sm_scale=scale)

    def plain(*pg):
        return plain_fn(qa, *(pg or pages), table, lens, sm_scale=scale)

    before = wrapper.launches
    out = kernel()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{kind} did not launch its kernel")
    ref = plain()
    err, share = tolerance_check(out, ref)
    if share > 1:
        raise RuntimeError(f"{kind} {name}: max abs err {err}, {share:.2f}x "
                           f"the tolerance {TOLERANCE}")
    ref4 = ref[:, None] if single else ref
    # the library yardstick: SDPA over contiguous K/V gathered once
    qs, kc, vc, mask = gathered(torch, q, k, v, table, lens)
    controls = attention_controls(torch, qs, kc, vc, mask, scale, t, ref4)
    if quant:
        ones = torch.ones_like(ks)
        err_s, share_s = tolerance_check(plain(kp, vp, ones, ones), ref)
        controls["scales_ignored"] = {"max_abs_err": err_s,
                                      "tolerance_share": share_s}
        # each key's scales from the neighbouring kv head: the stride-Hkv
        # indexing of the kernel's scale staging, one head off
        err_h, share_h = tolerance_check(
            plain(kp, vp, ks.roll(1, dims=2).contiguous(),
                  vs.roll(1, dims=2).contiguous()), ref)
        controls["wrong_head_scales"] = {"max_abs_err": err_h,
                                         "tolerance_share": share_h}
    for control, c in controls.items():
        if not c["tolerance_share"] > 1:
            raise RuntimeError(f"{kind} {name}: the {control} control "
                               "passed the check")
    kc, vc = kc.to(q.dtype), vc.to(q.dtype)

    def library():
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                              scale=scale)

    ms = time_ms(torch, kernel, 50, flush)
    plain_ms = time_ms(torch, plain, 10, flush)
    library_ms = time_ms(torch, library, 20, flush)
    page_bytes = t * hkv * d * pages[0].element_size() \
        + (t * hkv * 4 if quant else 0)
    nbytes = (2 * sum(live) * page_bytes + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    visible = sum(n - kq + j + 1 for n in lengths for j in range(kq))
    ops = visible * hq * 4 * d          # q.k and p.v, 2 flops a product
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "B": b, "K": kq, "lengths": lengths,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    ctl = ", ".join(f"{c} {v['max_abs_err']:.3e} ({v['tolerance_share']:.2f})"
                    for c, v in controls.items())
    log(f"  {kind} {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: {ctl}) kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, library "
        f"(SDPA) {library_ms:.4f} ms")
    return rec


# -- phase 3b: the MLA latent kernels ---------------------------------------------

# the four MLA entry points: (wrapper name, plain name, single-token
# (q (B, Hq, .)), int8 latents)
MLA_KINDS = {
    "paged_attention_multi_mla": ("_paged_attention_multi_mla_plain", False,
                                  False),
    "paged_attention_multi_mla_quant": (
        "_paged_attention_multi_mla_quant_plain", False, True),
    "paged_attention_mla": ("_paged_attention_mla_plain", True, False),
    "paged_attention_mla_quant": ("_paged_attention_mla_quant_plain", True,
                                  True),
}
# one decode context per slot: those of the burst's 200-900-token prompts,
# as step_profile's decode step holds them
MLA_DECODE_LENGTHS = [402, 475, 468, 252, 411, 789, 881, 571]


def mla_inputs(torch, dev, b, kq, lengths, t=16, cols=128):
    """mla-8b shapes (32 heads, latent 512, rope 64) at cache_len 2048: f32
    absorbed queries, bf16 latent pages in random order, and table entries
    past ceil(len/T) naming pages of large finite garbage."""
    hq, r, dr = 32, 512, 64
    gen = torch.Generator().manual_seed(SEED + 7 * kq)
    live = [-(-n // t) for n in lengths]
    n_garbage = 64
    n_pages = sum(live) + n_garbage
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[torch.arange(cols - live[i]) % n_garbage]
    c = torch.randn((n_pages, t, r), generator=gen)
    kr = torch.randn((n_pages, t, dr), generator=gen)
    c[garbage] = 3e4
    kr[garbage] = -3e4
    q_lat = torch.randn((b, kq, hq, r), generator=gen)
    q_rope = torch.randn((b, kq, hq, dr), generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q_lat.to(dev), q_rope.to(dev), c.to(dev, torch.bfloat16),
            kr.to(dev, torch.bfloat16), table.to(dev), lens, live)


def mla_variant(torch, q_lat, q_rope, c, kr, lens, scale, drop_rope=False,
                lost_page=False, causal=True, q_bf16=False):
    """The absorbed attention written out over gathered f32 latents c
    (B, S, R) and kr (B, S, Dr), with one fault switched on for a control:
    the rope term dropped, the second page (positions 16-31) lost, the
    causal floor off (every query sees the whole context), or the scaled
    queries rounded to bf16 alone (a tensor-core product without the lo
    term of the kernels' hi + lo split)."""
    kq, s_len = q_lat.shape[1], c.shape[1]
    ql, qr = q_lat * scale, q_rope * scale
    if q_bf16:
        ql, qr = ql.bfloat16().float(), qr.bfloat16().float()
    s = torch.einsum("bkhr,bLr->bkhL", ql, c)
    if not drop_rope:
        s = s + torch.einsum("bkhd,bLd->bkhL", qr, kr)
    pos = torch.arange(s_len, device=c.device)
    if causal:
        qpos = (lens.long()[:, None] - kq
                + torch.arange(kq, device=c.device)[None, :])
        valid = pos[None, None, :] <= qpos[:, :, None]          # (B, K, S)
    else:
        valid = (pos[None, :] < lens.long()[:, None])[:, None, :] \
            .expand(-1, kq, -1)
    if lost_page:
        valid = valid & ((pos < 16) | (pos >= 32))
    p = torch.softmax(s.masked_fill(~valid[:, :, None], -math.inf), dim=-1)
    return torch.einsum("bkhL,bLr->bkhr", p, c)


def mla_case(torch, F, dev, flush, kind, name, b, kq, lengths):
    """One MLA entry point against its plain version at mla-8b's shapes. The
    int8 kinds take latents that the model's own ``_kv_quant`` made from the
    bf16 ones (the garbage pages stay large). Controls, each scored by the
    same check and each required above 1x: the rope term dropped, a page
    lost, the causal floor off (K > 1), q in bf16 alone (no lo term), the
    scales ignored (int8)."""
    from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
    from k8s_runpod_kubelet_tpu_torch.ops import attention

    wrapper = getattr(attention, kind)
    plain_name, single, quant = MLA_KINDS[kind]
    plain_fn = getattr(attention, plain_name)
    q_lat, q_rope, c, kr, table, lens, live = mla_inputs(torch, dev, b, kq,
                                                         lengths)
    hq, r = q_lat.shape[2], q_lat.shape[3]
    t, dr = kr.shape[1], kr.shape[2]
    scale = (128 + dr) ** -0.5           # mla-8b: (head_dim + rope)^-0.5
    if quant:
        (cp, cs), (krp, krs) = _kv_quant(c), _kv_quant(kr)
        pages = (cp, krp, cs, krs)
        c = cp.float() * cs[..., None]   # what the pages stand for
        kr = krp.float() * krs[..., None]
    else:
        pages = (c, kr)
    qa = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous()) if single \
        else (q_lat, q_rope)

    def kernel():
        return wrapper(*qa, *pages, table, lens, sm_scale=scale)

    def plain(*pg):
        return plain_fn(*qa, *(pg or pages), table, lens, sm_scale=scale)

    before = wrapper.launches
    out = kernel()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{kind} did not launch its kernel")
    ref = plain()
    err, share = tolerance_check(out, ref)
    if share > 1:
        raise RuntimeError(f"{kind} {name}: max abs err {err}, {share:.2f}x "
                           f"the tolerance {TOLERANCE}")
    ref4 = ref[:, None] if single else ref
    idx = table.long()
    cg = c[idx].float().reshape(b, -1, r)
    krg = kr[idx].float().reshape(b, -1, dr)
    variants = {"rope_dropped": dict(drop_rope=True),
                "lost_page": dict(lost_page=True),
                "q_bf16": dict(q_bf16=True)}
    if kq > 1:
        variants["causal_floor_off"] = dict(causal=False)
    controls = {}
    for control, kw in variants.items():
        o = mla_variant(torch, q_lat, q_rope, cg, krg, lens, scale, **kw)
        e, sh = tolerance_check(o, ref4)
        controls[control] = {"max_abs_err": e, "tolerance_share": sh}
        del o
    if quant:
        ones = torch.ones_like(pages[2])
        e, sh = tolerance_check(plain(pages[0], pages[1], ones, ones), ref)
        controls["scales_ignored"] = {"max_abs_err": e, "tolerance_share": sh}
    for control, ctl in controls.items():
        if not ctl["tolerance_share"] > 1:
            raise RuntimeError(f"{kind} {name}: the {control} control "
                               "passed the check")
    # the library yardstick: SDPA over the gathered (dequantized) latents in
    # bf16, q = [q_lat, q_rope], k = [c, kr] and v = c as one kv head
    s_len = cg.shape[1]
    qs = torch.cat([q_lat, q_rope], -1).transpose(1, 2).bfloat16()
    ks = torch.cat([cg, krg], -1)[:, None].bfloat16()
    vs = cg[:, None].bfloat16()
    qpos = (lens.long()[:, None] - kq
            + torch.arange(kq, device=dev)[None, :])[:, None, :, None]
    mask = torch.arange(s_len, device=dev)[None, None, None, :] <= qpos
    del cg, krg

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    ms = time_ms(torch, kernel, 50, flush)
    plain_ms = time_ms(torch, plain, 10, flush)
    library_ms = time_ms(torch, library, 20, flush)
    page_bytes = t * (r + dr) * pages[0].element_size() \
        + (2 * t * 4 if quant else 0)
    nbytes = (sum(live) * page_bytes + q_lat.numel() * 4
              + q_rope.numel() * 4 + q_lat.numel() * 4 + table.numel() * 4
              + lens.numel() * 4)
    visible = sum(n - kq + j + 1 for n in lengths for j in range(kq))
    ops = visible * hq * (2 * (r + dr) + 2 * r)   # scores and p.c
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "B": b, "K": kq, "lengths": lengths,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    ctl = ", ".join(f"{c_} {v['tolerance_share']:.1f}"
                    for c_, v in controls.items())
    log(f"  {kind} {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: {ctl}) kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, library "
        f"(SDPA yardstick) {library_ms:.4f} ms")
    return rec


# the distinct projection shapes of llama3-8b: (in, out, leaves)
INT4_SHAPES = [(4096, 4096, "wq, wo"), (4096, 1024, "wk, wv"),
               (4096, 14336, "w_gate, w_up"), (14336, 4096, "w_down"),
               (4096, 128256, "lm_head")]


def int4_plain_rows(torch, h, q4, scale):
    """``_int4_matmul_plain`` applied to row blocks whose (rows, groups,
    out) f32 partials stay under 1 GiB (rows are independent; the plain
    version materializes that tensor: 16 GiB at 1024 rows of the head)."""
    from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import \
        _int4_matmul_plain

    per_row = scale.shape[0] * q4.shape[1] * 4
    step = max(1, 2**30 // per_row)
    return torch.cat([_int4_matmul_plain(h[r:r + step], q4, scale)
                      for r in range(0, h.shape[0], step)])


# the library's int4 GEMM against the plain version: it takes the scales in
# bf16 (2^-9 relative) and dequantizes each weight to bf16 before its f32
# sums, so it is held by the relative L2 norm of its difference, not per
# element
INT4PACK_REL_L2_LIMIT = 1e-2


def int4pack_call(torch, h, q4, scale):
    """``torch.ops.aten._weight_int4pack_mm`` set up for the port's packed
    weight: the same nibbles (q - 8 with q stored + 8), repacked to the
    library's (out, in/2) bytes with the even in-element in the high nibble
    and tiled by ``_convert_weight_to_int4pack``, the group scales in bf16
    beside zero points of 0. Returns the call."""
    kin2, out = q4.shape
    group = 2 * kin2 // scale.shape[0]
    nib = ((q4 & 0xF) << 4) | (q4 >> 4)
    packed = torch.ops.aten._convert_weight_to_int4pack(
        nib.t().contiguous(), 8)
    sz = torch.stack([scale[:, 0, :], torch.zeros_like(scale[:, 0, :])],
                     dim=-1).bfloat16().contiguous()
    return lambda: torch.ops.aten._weight_int4pack_mm(h, packed, group, sz)


def int4_case(torch, dev, flush, rows, kin, out, leaves):
    """``int4_matmul`` at one projection shape against its plain version:
    random weights (normal * 0.02) quantized by the port's quantizer on the
    card, bf16 activations. Controls, scored by the same check: the two
    nibbles of every byte swapped, each group given its neighbour's scale,
    and the scale folded into bf16 weights before the product (the
    dequantized bf16 weight in an f32 product). Times: the kernel, the
    plain version (row blocks, see ``int4_plain_rows``), the library's int4
    GEMM
    ``_weight_int4pack_mm`` on the same nibbles and group scales (the same
    function up to the scales' bf16 rounding; its output is held against
    the plain version by relative L2, ``INT4PACK_REL_L2_LIMIT``) and, as a
    yardstick the port never calls, ``torch.matmul`` of h by the
    dequantized bf16 weight (cuBLAS, 4x the weight bytes)."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import (
        _quantize_leaf_int4, dequantize)
    from k8s_runpod_kubelet_tpu_torch.ops import int4_matmul

    gen = torch.Generator(device=dev).manual_seed(SEED + kin + out)
    w = torch.randn((kin, out), generator=gen, device=dev) * 0.02
    leaf = _quantize_leaf_int4(w)
    del w
    q4, scale = leaf["q4"], leaf["scale"]
    h = torch.randn((rows, kin), generator=gen, device=dev).bfloat16()
    name = f"{rows} x ({kin} -> {out}) [{leaves}]"
    before = int4_matmul.launches
    y = int4_matmul(h, q4, scale)
    torch.cuda.synchronize()
    if int4_matmul.launches != before + 1:
        raise RuntimeError("int4_matmul did not launch its kernel")
    hf = h.float()
    ref = int4_plain_rows(torch, hf, q4, scale)   # f32, before its cast
    err, share = tolerance_check(y, ref)
    if share > 1:
        raise RuntimeError(f"int4_matmul {name}: max abs err {err}, "
                           f"{share:.2f}x the tolerance {TOLERANCE}")
    swapped = (q4 >> 4) | (q4 << 4)
    w_bf16 = dequantize(leaf).bfloat16()
    controls = {}
    for control, fn in (
            ("nibbles_swapped",
             lambda: int4_plain_rows(torch, hf, swapped, scale)),
            ("neighbour_group_scale",
             lambda: int4_plain_rows(torch, hf, q4,
                                     torch.roll(scale, 1, dims=0))),
            # the scale folded into bf16 weights before an f32 product
            ("scale_folded_bf16", lambda: hf @ w_bf16.float())):
        e, sh = tolerance_check(fn(), ref)
        controls[control] = {"max_abs_err": e, "tolerance_share": sh}
        if not sh > 1:
            raise RuntimeError(f"int4_matmul {name}: the {control} control "
                               "passed the check")
    int4pack = int4pack_call(torch, h, q4, scale)
    lib_y = int4pack()
    lib_err, lib_share = tolerance_check(lib_y, ref)
    rel = ((lib_y.float() - ref).norm() / ref.norm()).item()
    int4pack_check = {"max_abs_err": lib_err, "tolerance_share": lib_share,
                      "rel_l2": rel, "limit": INT4PACK_REL_L2_LIMIT}
    if not rel <= INT4PACK_REL_L2_LIMIT:
        raise RuntimeError(f"_weight_int4pack_mm {name}: relative L2 {rel} "
                           "from the plain version")
    del ref, swapped, hf, lib_y
    big = rows * kin * out > 2**34
    ms = time_ms(torch, lambda: int4_matmul(h, q4, scale), 5 if big else 30,
                 flush)
    plain_ms = time_ms(torch, lambda: int4_plain_rows(torch, h, q4, scale),
                       2 if big else 5, flush)
    library_ms = time_ms(torch, int4pack, 20, flush)
    yardstick_ms = time_ms(torch, lambda: torch.matmul(h, w_bf16), 20, flush)
    nbytes = q4.numel() + scale.numel() * 4 + h.numel() * 2 + rows * out * 2
    ops = 2 * rows * kin * out
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "rows": rows, "in": kin, "out": out,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "int4pack_check": int4pack_check, "yardstick_ms": yardstick_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "tflops": ops / ms / 1e9,
           "gb_per_s": nbytes / ms / 1e6}
    log(f"  int4_matmul {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: nibbles swapped "
        f"{controls['nibbles_swapped']['tolerance_share']:.0f}, neighbour "
        f"group's scale "
        f"{controls['neighbour_group_scale']['tolerance_share']:.0f}, scale "
        f"folded into bf16 weights "
        f"{controls['scale_folded_bf16']['tolerance_share']:.1f}) kernel "
        f"{ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s, {rec['gb_per_s']:.0f} "
        f"GB/s), bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} "
        f"ms, library (_weight_int4pack_mm) {library_ms:.4f} ms (relative L2 "
        f"{rel:.2e}, per element {lib_share:.2f} of the tolerance), "
        f"yardstick (matmul by the dequantized bf16 weight) "
        f"{yardstick_ms:.4f} ms")
    return rec


def rms_case(torch, F, dev, flush, shape, grad=False):
    """``rms_norm`` on x of ``shape`` (last axis 4096) against its plain
    version. With ``grad`` x and the f32 weight need gradients, as on the
    training path: the call goes through the autograd Function, and y, dx
    and dw are each held against autograd of the plain version."""
    from k8s_runpod_kubelet_tpu_torch.ops import rms_norm
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

    e, eps = shape[-1], 1e-5
    rows = math.prod(shape[:-1])
    gen = torch.Generator().manual_seed(SEED + rows)
    x = torch.randn(shape, generator=gen).mul_(3).to(dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn((e,), generator=gen)).to(dev)
    w_bf16 = w.to(torch.bfloat16)   # the library call takes one dtype
    name = f"rows={rows}" + (" (train, with gradients)" if grad else "")
    x.requires_grad_(grad)
    w.requires_grad_(grad)

    before = rms_norm.launches
    out = rms_norm(x, w, eps)
    torch.cuda.synchronize()
    if rms_norm.launches != before + 1:
        raise RuntimeError("rms_norm did not launch its kernel")
    px, pw = (t.detach().clone().requires_grad_(grad) for t in (x, w))
    ref = _rms_norm_plain(px, pw, eps)
    checks = {"y": tolerance_check(out, ref)}
    if grad:
        g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        dx, dw = torch.autograd.grad(out, (x, w), g)
        pdx, pdw = torch.autograd.grad(ref, (px, pw), g)
        if dx.dtype != x.dtype or dw.dtype != torch.float32:
            raise RuntimeError(f"rms_norm gradients came as {dx.dtype}, "
                               f"{dw.dtype}")
        checks.update(dx=tolerance_check(dx, pdx), dw=tolerance_check(dw, pdw))
        del g, dx, dw, pdx, pdw
    del px, pw, ref
    for what, (err, share) in checks.items():
        if share > 1:
            raise RuntimeError(f"rms_norm {name} {what}: max abs err {err}, "
                               f"{share:.2f}x the tolerance {TOLERANCE}")
    err = max(e_ for e_, _ in checks.values())
    share = max(s_ for _, s_ in checks.values())
    ms = time_ms(torch, lambda: rms_norm(x, w, eps), 100, flush)
    with torch.no_grad():
        plain_ms = time_ms(torch, lambda: _rms_norm_plain(x, w, eps), 50,
                           flush)
        library_ms = time_ms(torch, lambda: F.rms_norm(x, (e,), w_bf16,
                                                       eps), 100, flush)
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    ops = 4 * x.numel()   # square, sum, scale, weight: f32 elementwise
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    rec = {"case": name, "rows": rows, "E": e, "grad": grad,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share,
           "checks": {k: {"max_abs_err": v[0], "tolerance_share": v[1]}
                      for k, v in checks.items()},
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    shares = ", ".join(f"{k} {v[1]:.2f}" for k, v in checks.items())
    log(f"  rms_norm {name}: max_abs_err {err:.3e} (of {TOLERANCE}: "
        f"{shares}) kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms, library (F.rms_norm) "
        f"{library_ms:.4f} ms")
    return rec


# -- phase 8: the flash attention kernels -------------------------------------------

FLASH_CASES = [
    # name, B, Hq, Hkv, S, D, causal, window, soft cap
    ("train B=8 S=2048 D=128", 8, 32, 8, 2048, 128, True, None, None),
    ("ragged S=1000", 2, 32, 8, 1000, 128, True, None, None),
    ("D=64", 4, 16, 4, 1024, 64, True, None, None),
    ("D=256", 2, 8, 4, 1024, 256, True, None, None),
    ("GQA group 1", 2, 16, 16, 1024, 128, True, None, None),
    ("window 512", 2, 32, 8, 2048, 128, True, 512, None),
    ("soft cap 5", 2, 32, 8, 1024, 128, True, None, 5.0),
    ("non-causal", 2, 32, 8, 1024, 128, False, None, None),
]


def visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps for one head."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def flash_controls(torch, q, k, v, do, args, o_ref, dk_ref, dv_ref,
                   lse, delta) -> dict:
    """Three broken variants scored by the same check: p.v accumulated in
    bf16 over 64-key tiles and P rounded to bf16 before P.V (against o),
    and dK/dV with the last q head of each GQA group dropped (against dk,
    dv)."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (
        _flash_dkv_plain, _flash_mask, _grouped)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = _grouped(q.float(), hkv) * args["sm_scale"]
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if args["logit_soft_cap"] is not None:
        cap = args["logit_soft_cap"]
        sc = torch.tanh(sc / cap) * cap
    mask = _flash_mask(s, s, args["causal"], args["sliding_window"],
                       q.device)
    if mask is not None:
        sc.masked_fill_(~mask, -math.inf)
    o_bf16_p = bf16_p_output(torch, sc, v[:, :, None]).reshape(b, hq, s, d)
    err, share = tolerance_check(o_bf16_p.bfloat16(), o_ref)
    del o_bf16_p
    p = torch.softmax(sc, dim=-1)
    del sc
    acc = torch.zeros((b, hkv, hq // hkv, s, d), dtype=torch.bfloat16,
                      device=q.device)
    vf = v.float()[:, :, None]
    for t0 in range(0, s, 64):
        acc = (acc.float() + p[..., t0:t0 + 64] @ vf[..., t0:t0 + 64, :]
               ).bfloat16()
    del p
    out = {"bf16_p": {"max_abs_err": err, "tolerance_share": share}}
    err, share = tolerance_check(acc.reshape(b, hq, s, d), o_ref)
    out["bf16_accumulation"] = {"max_abs_err": err, "tolerance_share": share}
    dropped = _grouped(do.float(), hkv).clone()
    dropped[:, :, -1] = 0
    dk_c, dv_c = _flash_dkv_plain(q.float(), k.float(), v.float(),
                                  dropped.reshape(b, hq, s, d), lse, delta,
                                  **args)
    checks = [tolerance_check(dk_c.bfloat16(), dk_ref),
              tolerance_check(dv_c.bfloat16(), dv_ref)]
    out["dropped_q_head"] = {"max_abs_err": max(e for e, _ in checks),
                             "tolerance_share": max(s for _, s in checks)}
    del dk_c, dv_c, dropped
    return out


def bf16_ds_control(torch, q, k, v, do, args, lse, delta, refs) -> dict:
    """The backward kernels' control: dS (and P) rounded to bf16 alone
    before the products that accumulate dq = scale dS k, dk = scale dS^T q
    and dv = P^T dO, scored against the plain versions' (dq, dk, dv) by the
    same check; the least of the three shares is the control's (every one
    must miss the check)."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import _flash_ds
    b, hq, s, d = q.shape
    scale = args["sm_scale"]
    p, ds, qg, dog = _flash_ds(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, args["causal"], scale,
                               args["sliding_window"],
                               args["logit_soft_cap"])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    kf = k.float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(b, hq, s, d)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg.float()) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog.float())
    del p, ds
    shares = {}
    for name, got, ref in (("dq", dq * scale, refs[0]), ("dk", dk, refs[1]),
                           ("dv", dv, refs[2])):
        err, share = tolerance_check(got.bfloat16(), ref)
        shares[name] = {"max_abs_err": err, "tolerance_share": share}
    return {"max_abs_err": max(c["max_abs_err"] for c in shares.values()),
            "tolerance_share": min(c["tolerance_share"]
                                   for c in shares.values()),
            "by_gradient": shares}


def flash_case(torch, F, dev, flush, name, b, hq, hkv, s, d, causal, window,
               cap) -> dict:
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_attention, flash_dkv,
                                                  flash_dq, flash_fwd)
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (
        _attention_plain, _flash_dkv_plain, _flash_dq_plain,
        _flash_fwd_plain)

    gen = torch.Generator().manual_seed(SEED + s + d + hkv)
    q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
    q, k, v, do = (t.to(dev, torch.bfloat16) for t in (q, k, v, do))
    args = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap)
    kernels = (flash_fwd, flash_dq, flash_dkv)
    before = [f.launches for f in kernels]
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    if [f.launches for f in kernels] != [n + 1 for n in before]:
        raise RuntimeError(f"flash {name}: a kernel did not launch")

    # each kernel against its plain version on the same inputs, in f32
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd_plain(qf, kf, vf, **args)
    dq_ref = _flash_dq_plain(qf, kf, vf, dof, lse, delta, **args)
    dk_ref, dv_ref = _flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args)
    checks = {"flash_fwd": [tolerance_check(o, o_ref),
                            tolerance_check(lse, lse_ref, F32_ATOL,
                                            F32_RTOL)],
              "flash_dq": [tolerance_check(dq, dq_ref)],
              "flash_dkv": [tolerance_check(dk, dk_ref),
                            tolerance_check(dv, dv_ref)]}
    controls = flash_controls(torch, q, k, v, do, args, o_ref, dk_ref,
                              dv_ref, lse, delta)
    controls["bf16_ds"] = bf16_ds_control(torch, q, k, v, do, args, lse,
                                          delta, (dq_ref, dk_ref, dv_ref))
    del qf, kf, vf, dof, dq_ref, dk_ref, dv_ref
    for kname, results in checks.items():
        for err, share in results:
            if share > 1:
                raise RuntimeError(f"{kname} {name}: max abs err {err}, "
                                   f"{share:.2f}x the tolerance")
    for control, c in controls.items():
        if not c["tolerance_share"] > 1:
            raise RuntimeError(f"flash {name}: the {control} control passed "
                               "the check")

    # the whole autograd path against autograd through the plain attention
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(tq, tk, tv, **args).backward(do)
    pq, pk, pv = (t.float().requires_grad_() for t in (q, k, v))
    _attention_plain(pq, pk, pv, **args).backward(do.float())
    e2e = {}
    for gname, got, want in (("dq", tq.grad, pq.grad), ("dk", tk.grad,
                                                         pk.grad),
                             ("dv", tv.grad, pv.grad)):
        err = (got.float() - want).abs().max().item()
        e2e[gname] = err / (E2E_SCALE_RTOL * want.abs().max().item())
        if not e2e[gname] <= 1:
            raise RuntimeError(f"flash {name}: autograd d{gname} differs "
                               f"from the plain attention's by {err}")
    del tq, tk, tv, pq, pk, pv

    # times: kernels, plain versions, SDPA (forward and autograd backward)
    reps = 5 if b * hq * s * s > 2 ** 31 else 10
    fwd_ms = time_ms(torch, lambda: flash_fwd(q, k, v, **args), reps, flush)
    dq_ms = time_ms(torch, lambda: flash_dq(q, k, v, do, lse, delta, **args),
                    reps, flush)
    dkv_ms = time_ms(torch, lambda: flash_dkv(q, k, v, do, lse, delta,
                                              **args), reps, flush)
    plain = {"flash_fwd": time_ms(torch, lambda: _flash_fwd_plain(
                 q, k, v, **args), 3, flush),
             "flash_dq": time_ms(torch, lambda: _flash_dq_plain(
                 q, k, v, do, lse, delta, **args), 3, flush),
             "flash_dkv": time_ms(torch, lambda: _flash_dkv_plain(
                 q, k, v, do, lse, delta, **args), 3, flush)}
    lib_fwd = lib_bwd = None
    if cap is None:
        ks, vs = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        mask = None
        if window is not None:
            from k8s_runpod_kubelet_tpu_torch.ops.attention import \
                _flash_mask
            mask = _flash_mask(s, s, True, window, dev)
        sdpa = dict(attn_mask=mask, is_causal=causal and mask is None,
                    scale=args["sm_scale"])
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ks, vs, **sdpa), reps, flush)
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, ks, vs))
        lo = F.scaled_dot_product_attention(lq, lk, lv, **sdpa)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), reps, flush)
        del ks, vs, lq, lk, lv, lo

    pairs = b * hq * visible_pairs(s, causal, window)
    qb, kb = q.numel() * 2, k.numel() * 2
    rows = b * hq * s * 4                      # one f32 per row (lse, delta)
    work = {"flash_fwd": (4 * pairs * d, 2 * qb + 2 * kb + rows, fwd_ms,
                          lib_fwd),
            "flash_dq": (6 * pairs * d, 3 * qb + 2 * kb + 2 * rows, dq_ms,
                         lib_bwd),
            "flash_dkv": (8 * pairs * d, 2 * qb + 4 * kb + 2 * rows, dkv_ms,
                          lib_bwd)}
    rec = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
           "causal": causal, "window": window, "soft_cap": cap,
           "controls": controls, "autograd_vs_plain_share": e2e,
           "tolerance": TOLERANCE, "kernels": {}}
    for kname, (ops, nbytes, ms, lib) in work.items():
        bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
        rec["kernels"][kname] = {
            "max_abs_err": max(e for e, _ in checks[kname]),
            "tolerance_share": max(sh for _, sh in checks[kname]),
            "ms": ms, "plain_ms": plain[kname], "library_ms": lib,
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes, "tflops": ops / ms / 1e9}
    lib_txt = ("none (soft cap)" if lib_fwd is None else
               f"fwd {lib_fwd:.3f} ms, autograd bwd {lib_bwd:.3f} ms")
    log(f"  flash {name}: SDPA {lib_txt}; controls: bf16 accumulation "
        f"{controls['bf16_accumulation']['tolerance_share']:.2f}, bf16 P "
        f"{controls['bf16_p']['tolerance_share']:.2f}, dropped q "
        f"head {controls['dropped_q_head']['tolerance_share']:.0f}, bf16 dS "
        + "/".join(f"{c['tolerance_share']:.2f}" for c in
                   controls["bf16_ds"]["by_gradient"].values())
        + " (dq/dk/dv); "
        f"autograd vs plain (share of 1% of scale) dq {e2e['dq']:.2f} dk "
        f"{e2e['dk']:.2f} dv {e2e['dv']:.2f}")
    for kname, r in rec["kernels"].items():
        log(f"    {kname}: max_abs_err {r['max_abs_err']:.3e} "
            f"({r['tolerance_share']:.2f} of {TOLERANCE}) kernel "
            f"{r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s), bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms")
    return rec


# -- phases 9-10: training ----------------------------------------------------------

def leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Names of a parameter tree's leaves in ``_leaves`` order."""
    out = []
    for name in sorted(tree):
        leaf = tree[name]
        out.extend(leaf_names(leaf, f"{prefix}{name}/")
                   if isinstance(leaf, dict) else [prefix + name])
    return out


def train_grad_check(torch, dev, cfg, batch) -> dict:
    """Step 1's gradients as the training path computes them
    (``loss_and_grads``: bf16 compute through the kernels, remat) against
    autograd of ``plain_logits`` in f32 on the same f32 master params and
    the same batch, one row at a time. Each leaf's relative L2 error and
    the global norm's relative error must stay within their limits; the
    same path with the dK/dV kernel's output zeroed (the control) must
    exceed the leaf limit."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, init_params
    from k8s_runpod_kubelet_tpu_torch.ops import attention
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        _ce_and_zloss, _leaves, global_norm, loss_and_grads)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    rows = batch.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = [torch.zeros_like(p) for p in leaves]
    ref_loss = 0.0
    for r in range(rows):
        mb = batch[r:r + 1]
        logits = plain_logits(torch, cfg, params, mb[:, :-1])
        ce, _ = _ce_and_zloss(logits, mb[:, 1:], 0.0)
        del logits
        for acc, g in zip(ref, torch.autograd.grad(ce / rows, leaves)):
            acc.add_(g)
        ref_loss += ce.item() / rows
        del ce
    ref_norm = global_norm(ref).item()
    ref_s = time.perf_counter() - t0
    model = LlamaModel(cfg, dev)

    def against_ref() -> dict:
        loss, grads = loss_and_grads(model, params, batch)
        errs = {n: ((g.float() - r).norm() / r.norm()).item()
                for n, g, r in zip(names, grads, ref)}
        norm = global_norm(grads).item()
        del grads
        worst = max(errs, key=errs.get)
        return {"loss": loss.item(), "grad_norm": norm,
                "norm_rel_err": abs(norm - ref_norm) / ref_norm,
                "leaf_rel_l2": errs, "worst_leaf": worst,
                "worst_leaf_rel_l2": errs[worst]}

    port = against_ref()
    real_dkv = attention.flash_dkv
    attention.flash_dkv = lambda q, k, v, *a, **kw: (torch.zeros_like(k),
                                                     torch.zeros_like(v))
    try:
        control = against_ref()
    finally:
        attention.flash_dkv = real_dkv
    peak = torch.cuda.max_memory_allocated()
    del params, leaves, ref, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rows": rows, "ref_loss": ref_loss, "ref_grad_norm": ref_norm,
           "ref_s": ref_s, "peak_bytes": peak, "port": port,
           "control_zero_dkv": control,
           "limit_leaf_rel_l2": TRAIN_GRAD_REL_L2_LIMIT,
           "limit_norm_rel": TRAIN_NORM_REL_LIMIT}
    log(f"  gradients vs autograd of the plain f32 forward (batch "
        f"{rows} x {batch.shape[1] - 1}, {ref_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB): loss "
        f"{port['loss']:.5f} vs {ref_loss:.5f}; grad_norm "
        f"{port['grad_norm']:.5f} vs {ref_norm:.5f} (rel "
        f"{port['norm_rel_err']:.2e}, limit {TRAIN_NORM_REL_LIMIT}); worst "
        f"leaf {port['worst_leaf']} rel L2 {port['worst_leaf_rel_l2']:.2e} "
        f"(limit {TRAIN_GRAD_REL_L2_LIMIT})")
    log("    leaf rel L2: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (dK/dV zeroed): worst leaf {control['worst_leaf']} rel "
        f"L2 {control['worst_leaf_rel_l2']:.3f}, grad_norm rel "
        f"{control['norm_rel_err']:.2e}")
    if not (port["worst_leaf_rel_l2"] <= TRAIN_GRAD_REL_L2_LIMIT
            and port["norm_rel_err"] <= TRAIN_NORM_REL_LIMIT):
        raise RuntimeError(f"training gradients off the plain forward's: "
                           f"{port}")
    if not control["worst_leaf_rel_l2"] > TRAIN_GRAD_REL_L2_LIMIT:
        raise RuntimeError(f"the zeroed-dK/dV control passed: {control}")
    return out


def train_phase(torch, dev, card: str) -> dict:
    from k8s_runpod_kubelet_tpu_torch.models import llama3_8b
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, synthetic_batches)

    cfg = dataclasses.replace(llama3_8b(), n_layers=4)
    n_layers = cfg.n_layers
    tc = TrainConfig(batch_size=8, seq_len=2048, steps=6, warmup_steps=1)
    batch = next(synthetic_batches(cfg, tc, seed=SEED, device=dev))
    grad_check = train_grad_check(torch, dev, cfg, batch)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tc, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(trainer.params))
    log(f"  llama3-8b widths, {n_layers} layers: {n_params / 1e9:.3f} B "
        f"params (f32 master), init {init_s:.1f} s; batch {tc.batch_size} x "
        f"seq {tc.seq_len}, remat {cfg.remat_policy}, lr {tc.learning_rate}")
    batches = itertools.repeat(batch)
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": 2 * n_layers, "flash_dq": n_layers,
                "flash_dkv": n_layers, "rms_norm": 2 * (2 * n_layers) + 1}
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before the run, read just after
    for k in kernels:
        k.launches = 0
    losses, norms, walls = [], [], []
    for step in range(tc.steps):
        before = {k.__name__: k.launches for k in kernels}
        out = trainer.run(steps=1, batches=batches)
        got = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        if got != per_step:
            raise RuntimeError(f"train step {step + 1} launched {got}, not "
                               f"{per_step}")
        losses.append(out["final_loss"])
        norms.append(out["grad_norm"])
        walls.append(out["wall_s"])
        log(f"  step {trainer.step}: loss {out['final_loss']:.4f}, "
            f"grad_norm {out['grad_norm']:.4f}, wall {out['wall_s']:.3f} s")
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    # step 1 ran on the params and batch of the gradient check
    step1_rel = (abs(norms[0] - grad_check["ref_grad_norm"])
                 / grad_check["ref_grad_norm"])
    log(f"  step 1 grad_norm {norms[0]:.5f} vs the plain f32 forward's "
        f"{grad_check['ref_grad_norm']:.5f}: rel {step1_rel:.2e} (limit "
        f"{TRAIN_NORM_REL_LIMIT})")
    if not step1_rel <= TRAIN_NORM_REL_LIMIT:
        raise RuntimeError(f"step 1's grad_norm {norms[0]} is off the plain "
                           f"forward's {grad_check['ref_grad_norm']}")
    step_s = statistics.median(walls[1:])
    tok_s = tc.batch_size * tc.seq_len / step_s
    log(f"  [{card}] step wall {step_s:.3f} s (median of steps 2-"
        f"{tc.steps}; first {walls[0]:.3f} s), {tok_s:.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB allocated")
    log(f"  launches over {tc.steps} steps: {launches} ({per_step} per step)")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": n_layers, "params": n_params, "batch": tc.batch_size,
            "seq_len": tc.seq_len, "steps": tc.steps, "losses": losses,
            "grad_norms": norms, "step_walls_s": walls,
            "step_s_median": step_s, "tokens_per_s": tok_s,
            "peak_bytes": peak, "launches": launches,
            "launches_per_step": per_step, "init_s": init_s,
            "grad_check": grad_check, "step1_norm_rel_err": step1_rel}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def train_main_phase(torch) -> dict:
    import contextlib
    import io

    from k8s_runpod_kubelet_tpu_torch.workloads import train_main

    cap = _Capture()
    train_log = logging.getLogger("k8s_runpod_kubelet_tpu_torch.workloads")
    train_log.addHandler(cap)
    train_log.setLevel(logging.INFO)
    outs = []
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            for _ in range(2):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = train_main.main(["--model", "tiny", "--steps", "2",
                                          "--checkpoint-dir", ckpt])
                if rc != 0:
                    raise RuntimeError(f"train_main exited {rc}")
                outs.append(json.loads(buf.getvalue().strip()
                                       .splitlines()[-1]))
    finally:
        train_log.removeHandler(cap)
    if "resumed from checkpoint step 2" not in cap.lines:
        raise RuntimeError(f"the second life did not resume: {cap.lines}")
    for out in outs:
        if not (out["workload"] == "pretrain" and out["steps"] == 2
                and math.isfinite(out["final_loss"])):
            raise RuntimeError(f"train_main printed {out}")
    log(f"  train_main --model tiny --steps 2, twice: losses "
        f"{outs[0]['final_loss']:.4f} then {outs[1]['final_loss']:.4f}; "
        f"logged {[x for x in cap.lines if 'checkpoint' in x]}")
    return {"summaries": outs, "log": cap.lines}


# -- phases 4-7: the engine ------------------------------------------------------------

def http_generate(port: int, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def prefix_path_check(torch, model, params, prompt: list[int]) -> dict:
    """Last-token logits of one prompt prefilled in one chunk (A), through
    a cached prefix of its full pages plus the tail chunk (B), as a prefix
    hit computes them, and in two uncached chunks split where B's cache
    ends (C). B and C run the same tail chunk over the same prefix K/V;
    they differ only in whether the prefix pages were written by A's
    one-chunk prefill or by C's first chunk. So |B - C| is what the cache
    adds, and |A - C| what the tail chunk's GEMM shapes alone change.
    Reported against the logits' spread and A's top-1 margin."""
    dev, t, n = model.device, 16, len(prompt)
    n_pages = -(-n // t)
    cached = (n - 1) // t                     # the trie's match cap
    arena = model.init_paged_arena(3 * n_pages, t)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    table_a = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    table_a[0, :n_pages] = torch.arange(n_pages, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    la, _, _ = model.paged_prefill_chunk_step(
        params, toks, arena, table_a, zero,
        torch.tensor([n], dtype=torch.int32, device=dev))
    table_b = table_a.clone()
    table_b[0, cached:n_pages] = torch.arange(
        n_pages, 2 * n_pages - cached, device=dev)
    lb, _, _ = model.paged_prefill_chunk_step(
        params, toks[:, cached * t:], arena, table_b,
        zero + cached * t,
        torch.tensor([n - cached * t], dtype=torch.int32, device=dev))
    half = cached * t
    table_c = table_a.clone()
    table_c[0, :n_pages] = torch.arange(n_pages, 2 * n_pages, device=dev)
    _, _, done = model.paged_prefill_chunk_step(
        params, toks[:, :half], arena, table_c, zero,
        torch.tensor([half], dtype=torch.int32, device=dev))
    lc, _, _ = model.paged_prefill_chunk_step(
        params, toks[:, half:], arena, table_c, done,
        torch.tensor([n - half], dtype=torch.int32, device=dev))
    a, b, c = la[0], lb[0], lc[0]
    top2 = a.topk(2).values
    return a, {"prompt_tokens": n, "cached_tokens": cached * t,
            "max_abs_diff": (a - b).abs().max().item(),
            "cache_vs_uncached_max_abs_diff": (b - c).abs().max().item(),
            "two_chunk_max_abs_diff": (a - c).abs().max().item(),
            "logit_std": a.std().item(),
            "top1_margin": (top2[0] - top2[1]).item(),
            "argmax_agree": bool(a.argmax() == b.argmax())}


def layer_f32(w, layer=None):
    """A weight leaf (of one layer) in f32: a raw weight upcast, a
    quantized leaf dequantized."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import dequantize

    if isinstance(w, dict):
        return dequantize({k: (v if layer is None else v[layer])
                           for k, v in w.items()})
    return (w if layer is None else w[layer]).float()


def plain_logits(torch, cfg, params, tokens, skip_layer=None,
                 last_only=False):
    """Logits (B, S, V) of tokens (B, S), or with ``last_only`` the last
    position's (B, V), from a plain f32 forward of the same weights: no
    paging, no KV quantization and no kernels (``_attention_plain``,
    ``_rms_norm_plain``), each layer's weights upcast (or dequantized) only
    while it runs (an upcast is a no-op on f32 master weights, through
    which autograd then reaches the parameters); an MLA model's attention in
    the direct form (``mla_direct_qkv``). ``skip_layer`` leaves one layer
    out (a control)."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops.attention import _attention_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import (apply_rope,
                                                       rope_frequencies)

    dev = params["tok_embed"].device
    (b, n), hd = tokens.shape, cfg.head_dim_
    cos, sin = rope_frequencies(cfg.mla_rope_dim if cfg.is_mla else hd,
                                cfg.max_seq_len, cfg.rope_theta,
                                cfg.rope_scaling, device=dev)
    x = params["tok_embed"][tokens.long()].float()
    for layer in range(cfg.n_layers):
        if layer == skip_layer:
            continue
        lp = {k: layer_f32(w, layer) for k, w in params["layers"].items()}
        h = _rms_norm_plain(x, lp["attn_norm"], cfg.norm_eps)
        if cfg.is_mla:
            q, k, v = mla_direct_qkv(torch, cfg, lp, h, cos, sin)
        else:
            q = apply_rope((h @ lp["wq"]).view(b, n, cfg.n_heads, hd), cos,
                           sin)
            k = apply_rope((h @ lp["wk"]).view(b, n, cfg.n_kv_heads, hd),
                           cos, sin)
            v = (h @ lp["wv"]).view(b, n, cfg.n_kv_heads, hd)
        o = _attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             sm_scale=cfg.sm_scale)[..., :hd]
        x = x + o.transpose(1, 2).reshape(b, n, -1) @ lp["wo"]
        h = _rms_norm_plain(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
        del lp
    if last_only:
        x = x[:, -1]
    x = _rms_norm_plain(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["tok_embed"].t().float()
    return x @ layer_f32(params["lm_head"])


def mla_direct_qkv(torch, cfg, lp, h, cos, sin):
    """The direct (non-absorbed) form of MLA attention, as the JAX
    package's ``_mla_attention_block`` computes it, in f32 from one layer's
    f32 weights: per-head K = [c w_uk, kr] and V = c w_uv zero-padded to
    head_dim + rope_dim, so one plain attention at that width computes
    q_nope . k_nope + q_rope . kr and the weighted V (its padded tail is
    sliced off after). No paging, no absorption, no kernels."""
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import apply_rope

    b, n, _ = h.shape
    hn, hd, dr, r = (cfg.n_heads, cfg.head_dim_, cfg.mla_rope_dim,
                     cfg.mla_latent_dim)
    if cfg.mla_q_lora_rank is not None:
        q = _rms_norm_plain(h @ lp["w_qa"], lp["q_a_norm"], cfg.norm_eps) \
            @ lp["w_qb"]
    else:
        q = h @ lp["wq"]
    q = q.view(b, n, hn, hd + dr)
    ckr = h @ lp["w_dkv"]
    c = _rms_norm_plain(ckr[..., :r], lp["c_norm"], cfg.norm_eps)
    kr = apply_rope(ckr[..., None, r:], cos, sin)              # (B,S,1,dr)
    q = torch.cat([q[..., :hd], apply_rope(q[..., hd:], cos, sin)], -1)
    k = torch.cat([(c @ lp["w_uk"]).view(b, n, hn, hd),
                   kr.expand(b, n, hn, dr)], -1)
    v = torch.cat([(c @ lp["w_uv"]).view(b, n, hn, hd),
                   torch.zeros((b, n, hn, dr), device=h.device)], -1)
    return q, k, v


def reference_logits(torch, cfg, params, prompt: list[int],
                     skip_layer=None):
    """Last-token logits (V,) of ``prompt`` from ``plain_logits``."""
    toks = torch.tensor(prompt, device=params["tok_embed"].device)[None]
    return plain_logits(torch, cfg, params, toks, skip_layer,
                        last_only=True)[0]


def engine_reference_check(torch, cfg, params, prompt, engine_logits,
                           limit=ENGINE_REL_L2_LIMIT, what="engine"):
    """The engine path's logits against the plain f32 forward of the same
    (dequantized) weights, within ``limit``; the forward with its middle
    layer skipped must land outside it."""
    ref = reference_logits(torch, cfg, params, prompt)
    ctrl = reference_logits(torch, cfg, params, prompt,
                            skip_layer=cfg.n_layers // 2)

    def rel_l2(a):
        return ((a - ref).norm() / ref.norm()).item()

    out = {"prompt_tokens": len(prompt), "rel_l2": rel_l2(engine_logits),
           "max_abs_diff": (engine_logits - ref).abs().max().item(),
           "ref_logit_std": ref.std().item(),
           "argmax_agree": bool(engine_logits.argmax() == ref.argmax()),
           "control_skip_layer_rel_l2": rel_l2(ctrl),
           "limit_rel_l2": limit}
    log(f"  independent check: {what} vs plain f32 forward, last-token "
        f"logits of a {len(prompt)}-token prompt: relative L2 "
        f"{out['rel_l2']:.4f} (limit {limit}), max abs "
        f"{out['max_abs_diff']:.4f} (logit std {out['ref_logit_std']:.4f}), "
        f"argmax agree {out['argmax_agree']}; control (layer "
        f"{cfg.n_layers // 2} skipped) {out['control_skip_layer_rel_l2']:.4f}")
    if not out["rel_l2"] <= limit:
        raise RuntimeError(f"{what} logits off the plain forward: {out}")
    if not out["control_skip_layer_rel_l2"] > limit:
        raise RuntimeError(f"the skipped-layer control passed: {out}")
    return out


def burst_prompts(cfg) -> tuple[list, list, "np.random.Generator"]:
    """The seeded traffic both engines serve: a warm-up prompt no measured
    request shares, 8 prompts of 200-900 tokens (two sharing a 96-token
    prefix), and the generator for the later prompts."""
    import numpy as np

    rng = np.random.default_rng(SEED)

    def prompt(n: int) -> list[int]:
        return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

    warm = prompt(64)
    prompts = [prompt(int(n)) for n in rng.integers(200, 901, 8)]
    prompts[1] = prompts[0][:96] + prompts[1][96:]
    return warm, prompts, prompt


def serve_burst(torch, engine, cfg, card: str, kernels, per_step) -> dict:
    """The engine's main path, read per path: the 8-request burst (counts
    set to 0 just before it, read just after), its decode-only stretch
    after the last prefill, a prefill-only stretch (a 1500-token prompt in
    two chunks, one new token), and a repeat. ``per_step`` maps each
    kernel to its launches per decode step or prefill chunk (0: must not
    launch)."""
    warm, prompts, prompt = burst_prompts(cfg)
    # warm-up: cuBLAS handles and first-call allocations stay out of the
    # measured phase
    engine.submit(warm, max_new_tokens=4).result(timeout=900)
    hits0 = engine.counters["prefix_cache_hits"]

    def snap() -> dict:
        # steps and chunks count under the arena lock with their launches,
        # so a snapshot taken holding it is consistent
        with engine._prefix_lock:
            return {"prefill_chunks": engine.counters["prefill_chunks"],
                    "decode_steps": engine.counters["decode_steps"],
                    **{k.__name__: k.launches for k in kernels}}

    def stretch(a: dict, b: dict, path: str) -> dict:
        d = {k: b[k] - a[k] for k in a}
        steps = d["prefill_chunks"] + d["decode_steps"]
        for name, n in per_step.items():
            if d[name] != n * steps or (n and d[name] < 1):
                raise RuntimeError(
                    f"{path}: {name} launched {d[name]} times in "
                    f"{d['prefill_chunks']} prefill chunks and "
                    f"{d['decode_steps']} decode steps, not {n} per step")
        return d

    with engine._prefix_lock:
        for k in kernels:
            k.launches = 0
    s0 = snap()
    t_start = time.perf_counter()
    futs = [engine.submit(p) for p in prompts]
    deadline = time.monotonic() + 900
    while engine.counters["prefill_chunks"] - s0["prefill_chunks"] < 8:
        if time.monotonic() > deadline:
            raise RuntimeError("the burst's 8 prefills did not finish")
        time.sleep(0.001)
    s1 = snap()
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t_start
    s2 = snap()
    launches = {k.__name__: k.launches for k in kernels}

    if len(results) != 8 or any(len(r["tokens"]) != 32 for r in results):
        raise RuntimeError("not all 8 requests finished with 32 tokens")
    hits = engine.counters["prefix_cache_hits"] - hits0
    if hits < 1:
        raise RuntimeError("the shared 96-token prefix did not hit")
    burst = stretch(s0, s2, "burst")
    decode = stretch(s1, s2, "decode-only stretch")
    if decode["prefill_chunks"] or burst["prefill_chunks"] != 8:
        raise RuntimeError(f"burst counted {burst['prefill_chunks']} "
                           f"prefill chunks, {decode['prefill_chunks']} "
                           f"of them after the eighth")
    ttft = [r["ttft_s"] for r in results]
    per_stream = [(len(r["tokens"]) - 1) / (r["latency_s"] - r["ttft_s"])
                  for r in results]
    out_tok_s = sum(len(r["tokens"]) for r in results) / wall
    log(f"  8/8 requests ({sum(len(p) for p in prompts)} prompt tokens, "
        f"lengths {[len(p) for p in prompts]}) in {wall:.2f} s; prefix "
        f"hits {hits}")
    log(f"  [{card}] TTFT median {statistics.median(ttft) * 1e3:.1f} ms, "
        f"max {max(ttft) * 1e3:.1f} ms")
    log(f"  [{card}] decode {statistics.median(per_stream):.1f} tokens/s "
        f"per stream (median), {out_tok_s:.1f} output tokens/s over the "
        f"phase")
    # prefill only: a 1500-token prompt (two chunks) asking for one token
    # completes at admission, with no decode step
    s3 = snap()
    engine.submit(prompt(1500), max_new_tokens=1).result(timeout=900)
    prefill = stretch(s3, snap(), "prefill-only stretch")
    if prefill["decode_steps"] or prefill["prefill_chunks"] != 2:
        raise RuntimeError(f"prefill-only stretch counted {prefill}")
    by_path = {"burst": burst, "decode_only": decode,
               "prefill_only": prefill}
    for path, d in by_path.items():
        counts = ", ".join(f"{k.__name__} {d[k.__name__]}" for k in kernels)
        log(f"  launches, {path}: {d['prefill_chunks']} prefill chunks, "
            f"{d['decode_steps']} decode steps; {counts}")

    # repeat: the same prompt twice more, both through the prefix-hit path,
    # must give the same tokens
    rep = [engine.submit(prompts[2]).result(timeout=900)["tokens"]
           for _ in range(2)]
    if rep[0] != rep[1]:
        raise RuntimeError(f"repeat differs: {rep[0]} vs {rep[1]}")
    same_as_first = sum(a == b for a, b in zip(rep[0], results[2]["tokens"]))
    log(f"  repeat: identical twice; {same_as_first}/32 tokens equal to the "
        f"first run (which prefilled without a prefix hit)")
    return {"launches": launches, "launches_by_path": by_path,
            "launches_per_step": per_step,
            "ttft_ms": [x * 1e3 for x in ttft],
            "decode_tok_s_per_stream": per_stream,
            "output_tok_s": out_tok_s, "wall_s": wall,
            "prompt_lengths": [len(p) for p in prompts],
            "prefix_hits": hits, "repeat_same_as_first": same_as_first,
            "tokens": [r["tokens"] for r in results],
            "prompts": prompts, "prompt": prompt}


def http_and_drain(engine, prompt) -> dict:
    """One request through the HTTP front, then drain: the pool must hold
    zero leaked pages."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve

    httpd = serve(engine, port=0, host="127.0.0.1")
    try:
        status, body = http_generate(httpd.server_address[1],
                                     {"tokens": prompt(100),
                                      "max_new_tokens": 8})
    finally:
        httpd.shutdown()
        httpd.server_close()
    if status != 200 or len(body.get("tokens", [])) != 8:
        raise RuntimeError(f"/generate answered {status}: {body}")
    log(f"  HTTP: POST /generate -> {status}, {len(body['tokens'])} tokens")
    engine.drain()
    deadline = time.monotonic() + 120
    while not engine.drained:
        if time.monotonic() > deadline:
            raise RuntimeError("engine did not drain")
        time.sleep(0.05)
    stats = engine.prefix_cache_stats()
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    leaked = (store.pool.n_pages - store.pool.free_count - len(nodes)
              + sum(store.pool.refcount(n.page) - 1 for n in nodes))
    if leaked:
        raise RuntimeError(f"{leaked} pages leaked after drain: {stats}")
    log(f"  drained: {stats['pages_free']} free + {stats['nodes']} cached = "
        f"{stats['pages_total']} pages, 0 leaked")
    return {"http_status": status, "pool": stats, "leaked_pages": 0}


def engine_phase(torch, dev, card: str, cfg, params) -> dict:
    """The bf16 engine: burst, prefix path, independent check, HTTP,
    drain. Returns its record and the one-chunk last-token logits of the
    checked prompt (on the host) for the quantized engine to compare."""
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, max_new_tokens=32)
    engine = ServingEngine(cfg, params, sc, device=dev).start()
    try:
        log(f"  {cfg.name}: {cfg.n_layers} layers, E={cfg.embed_dim}, bf16; "
            f"arena {engine._kv_store.pool.n_pages} pages of 16 tokens, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        # the single-token forms lie on no model path: held at 0
        per_step = {"paged_attention_multi": cfg.n_layers,
                    "rms_norm": 2 * cfg.n_layers + 1,
                    "paged_attention": 0, "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (paged_attention_multi, rms_norm, paged_attention,
                           paged_attention_quant), per_step)
        prompts = rec.pop("prompts")
        with engine._prefix_lock:   # the engine is idle; keep it so
            one_chunk, prefix = prefix_path_check(torch, engine.model,
                                                  engine.params, prompts[2])
            reference = engine_reference_check(torch, cfg, engine.params,
                                               prompts[2], one_chunk)
        log(f"  prefix path (last-token logits, max abs diff): one chunk vs "
            f"cached prefix + tail {prefix['max_abs_diff']:.4f}; cached vs "
            f"uncached prefix, same tail chunk "
            f"{prefix['cache_vs_uncached_max_abs_diff']:.4f}; one chunk vs "
            f"two uncached chunks {prefix['two_chunk_max_abs_diff']:.4f} "
            f"(logit std {prefix['logit_std']:.4f}, top-1 margin "
            f"{prefix['top1_margin']:.4f}, argmax agree "
            f"{prefix['argmax_agree']})")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   prefix_path=prefix, reference=reference)
        return rec, one_chunk.cpu()
    finally:
        engine.stop()


def quant_logits(torch, model, params, prompt) -> "torch.Tensor":
    """Last-token logits of ``prompt`` prefilled in one chunk through the
    quantized engine's model and params, over a fresh int8 arena."""
    dev, t, n = model.device, 16, len(prompt)
    n_pages = -(-n // t)
    arena = model.init_paged_arena(n_pages, t, quantize=True)
    table = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    table[0, :n_pages] = torch.arange(n_pages, device=dev)
    logits, _, _ = model.paged_prefill_chunk_step(
        params, torch.tensor([prompt], dtype=torch.int32, device=dev), arena,
        table, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([n], dtype=torch.int32, device=dev))
    return logits[0]


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quant_engine_phase(torch, dev, card: str, cfg, params: list,
                       bf16: dict, bf16_logits) -> dict:
    """The memory-lean deployment: the engine built through the serve
    CLI's own arguments (``--int4 --kv-int8``, 8 slots, cache_len 2048)
    from the bf16 phase's seeded params, which it quantizes on the card;
    the caller's bf16 params are then dropped. The burst with exact
    launches per step (no bf16 paged kernel), memory, the independent check
    against a plain f32 forward of the dequantized weights over
    unquantized K/V, the gap to the bf16 engine's logits (information
    only), HTTP, drain. ``params`` is a one-element list holding the bf16
    tree, emptied once the engine holds its quantized copy."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
         "--kv-int8"])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(args, params[0])
    params.clear()   # the caller's bf16 tree goes; the engine holds int4
    gc.collect()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    try:
        sc = engine.sc
        if not (sc.quantize_int4 and sc.quantize_kv_int8 and sc.slots == 8
                and sc.cache_len == 2048 and sc.max_prefill_len == 1024):
            raise RuntimeError(f"--int4 --kv-int8 built {sc}")
        p = engine.params
        weights = {
            "q4": sum(w["q4"].numel() for w in p["layers"].values()
                      if isinstance(w, dict)),
            "scales": sum(w["scale"].numel() * 4 for w in p["layers"].values()
                          if isinstance(w, dict)),
            "lm_head": tensor_bytes(p["lm_head"]),
            "tok_embed": tensor_bytes(p["tok_embed"]),
            "norms": tensor_bytes(p["final_norm"]) + sum(
                tensor_bytes(w) for n, w in p["layers"].items()
                if n.endswith("norm"))}
        arena = tensor_bytes(engine._kv_store.arena)
        snap = engine.debug_snapshot()
        log(f"  --int4 --kv-int8: weights {snap['weights']}, kv {snap['kv']}, "
            f"quantized on the card in {quant_s:.1f} s; weight bytes "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in weights.items())
            + f" ({sum(weights.values()) / 1e9:.3f} GB); arena "
            f"{engine._kv_store.pool.n_pages} pages of "
            f"{snap['prefix_cache']['page_bytes']} bytes, {arena / 1e9:.3f} "
            f"GB; [{card}] allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB (bf16 params freed), peak while quantizing "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (from "
            f"{before / 2**30:.2f} GiB)")
        torch.cuda.reset_peak_memory_stats()
        per_step = {"paged_attention_multi_quant": cfg.n_layers,
                    "int4_matmul": 7 * cfg.n_layers + 1,
                    "rms_norm": 2 * cfg.n_layers + 1,
                    "paged_attention_multi": 0, "paged_attention": 0,
                    "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (paged_attention_multi_quant, int4_matmul,
                           rms_norm, paged_attention_multi, paged_attention,
                           paged_attention_quant), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        prompts = rec.pop("prompts")
        with engine._prefix_lock:   # the engine is idle; keep it so
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2])
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=QUANT_ENGINE_REL_L2_LIMIT, what="int4/int8 engine")
        ref_bf16 = bf16_logits.to(logits.device)
        gap = {"rel_l2": ((logits - ref_bf16).norm()
                          / ref_bf16.norm()).item(),
               "argmax_agree": bool(logits.argmax() == ref_bf16.argmax()),
               "same_tokens": sum(a == b for x, y in zip(rec["tokens"],
                                                         bf16["tokens"])
                                  for a, b in zip(x, y))}
        log(f"  gap to the bf16 engine (information only): last-token "
            f"logits relative L2 {gap['rel_l2']:.4f}, argmax agree "
            f"{gap['argmax_agree']}; {gap['same_tokens']}/256 burst tokens "
            f"equal")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, gap_to_bf16=gap,
                   weight_bytes=weights, arena_bytes=arena,
                   page_bytes=snap["prefix_cache"]["page_bytes"],
                   quantize_s=quant_s, serve_peak_bytes=serve_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        return rec
    finally:
        engine.stop()


def mla_engine_phase(torch, dev, card: str, cfg, params: list,
                     kv_int8: bool, bf16_logits=None):
    """mla-8b served through the latent arena: the engine the serve CLI
    builds from ``--model mla-8b`` (``--kv-int8``: int8 latents), 8 slots,
    cache_len 2048, 16-token pages, over the seeded bf16 params in
    ``params`` (a one-element list, emptied by the int8 phase, the last one
    to use them). The arena's shape, the burst with exact launches per step
    (32 latent-kernel launches and 3 norms a layer plus one; no dense paged
    or single-token launch), the independent check against a plain f32
    direct-form forward, HTTP, drain. Returns its record and the one-chunk
    last-token logits of the checked prompt (on the host)."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        paged_attention, paged_attention_mla, paged_attention_mla_quant,
        paged_attention_multi, paged_attention_multi_mla,
        paged_attention_multi_mla_quant, paged_attention_multi_quant,
        paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32"]
        + (["--kv-int8"] if kv_int8 else []))
    engine, _ = serve_main.build_engine(args, params[0])
    if kv_int8:
        params.clear()   # the engine holds the last reference
    what = f"{cfg.name}{' --kv-int8' if kv_int8 else ''} engine"
    try:
        sc, store = engine.sc, engine._kv_store
        if not (sc.slots == 8 and sc.cache_len == 2048
                and sc.max_prefill_len == 1024 and sc.kv_page_tokens == 16
                and sc.quantize_kv_int8 == kv_int8):
            raise RuntimeError(f"{what}: the CLI built {sc}")
        r, dr, t = cfg.mla_latent_dim, cfg.mla_rope_dim, 16
        width = torch.empty(0, dtype=cfg.dtype).element_size()
        per_position = r + dr + 8 if kv_int8 else width * (r + dr)
        want = cfg.n_layers * t * per_position
        c = store.arena["c"]
        snap = engine.debug_snapshot()
        if store.pool.n_pages != 2048 or c.shape[1] != 2049 \
                or store.page_bytes != want or snap["kv_layout"] != "latent":
            raise RuntimeError(f"{what}: arena {store.pool.n_pages} + 1 "
                               f"pages of {store.page_bytes} B "
                               f"({snap['kv_layout']}), not 2048 + 1 of "
                               f"{want} (latent)")
        arena_bytes = tensor_bytes(store.arena)
        log(f"  {what}: {cfg.n_layers} layers, E={cfg.embed_dim}, latent "
            f"{r} + rope {dr}, kv {snap['kv']} ({snap['kv_layout']}); arena "
            f"2048 + 1 pages of {store.page_bytes} B, "
            f"{arena_bytes / 1e9:.3f} GB; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        main = paged_attention_multi_mla_quant if kv_int8 \
            else paged_attention_multi_mla
        held = [k for k in (paged_attention_multi_mla,
                            paged_attention_multi_mla_quant,
                            paged_attention_mla, paged_attention_mla_quant,
                            paged_attention_multi,
                            paged_attention_multi_quant, paged_attention,
                            paged_attention_quant) if k is not main]
        per_step = {main.__name__: cfg.n_layers,
                    "rms_norm": 3 * cfg.n_layers + 1,
                    **{k.__name__: 0 for k in held}}
        torch.cuda.reset_peak_memory_stats()
        rec = serve_burst(torch, engine, cfg, card, (main, rms_norm, *held),
                          per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        prompts = rec.pop("prompts")
        prefix = None
        with engine._prefix_lock:   # the engine is idle; keep it so
            if kv_int8:
                logits = quant_logits(torch, engine.model, engine.params,
                                      prompts[2])
            else:
                logits, prefix = prefix_path_check(
                    torch, engine.model, engine.params, prompts[2])
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=(MLA_INT8_ENGINE_REL_L2_LIMIT if kv_int8
                       else MLA_ENGINE_REL_L2_LIMIT), what=what)
        if prefix is not None:
            log(f"  prefix path (last-token logits, max abs diff): one chunk "
                f"vs cached prefix + tail {prefix['max_abs_diff']:.4f}; "
                f"cached vs uncached prefix, same tail chunk "
                f"{prefix['cache_vs_uncached_max_abs_diff']:.4f} (logit std "
                f"{prefix['logit_std']:.4f})")
        gap = None
        if bf16_logits is not None:
            ref = bf16_logits.to(logits.device)
            gap = {"rel_l2": ((logits - ref).norm() / ref.norm()).item(),
                   "argmax_agree": bool(logits.argmax() == ref.argmax())}
            log(f"  gap to the bf16-latent engine (information only): "
                f"last-token logits relative L2 {gap['rel_l2']:.4f}, argmax "
                f"agree {gap['argmax_agree']}")
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, prefix_path=prefix, gap_to_bf16=gap,
                   page_bytes=store.page_bytes, arena_bytes=arena_bytes,
                   serve_peak_bytes=serve_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        return rec, logits.cpu()
    finally:
        engine.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chip smoke of the PyTorch "
                                "port (see the module docstring)")
    p.add_argument("--out", default="",
                   help="also write every number to this JSON file")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops import _cuda, rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("phase build")
    sources = ("paged_attention_multi", "paged_attention_multi_quant",
               "paged_attention_multi_mla", "paged_attention_multi_mla_quant",
               "int4_matmul", "flash_attention")
    nvcc_s, errors = {}, []

    def build(name):
        t = time.perf_counter()
        try:
            _cuda.load(name)
        except Exception as e:   # re-raised below, after the join
            errors.append(e)
        nvcc_s[name] = time.perf_counter() - t

    threads = [threading.Thread(target=build, args=(n,)) for n in sources]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    rms_norm(torch.ones((1, 64), dtype=torch.bfloat16, device=dev),
             torch.ones(64, device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, text in sorted(_cuda.build_logs.items()):
        for line in ptxas_summary(text):
            log(f"  ptxas {name}: {line}")
    # the tensor-core kernels: each must hold wgmma (HGMMA in the SASS)
    sass = {name: sass_counts(_cuda.load(name)._name)
            for name in TENSOR_CORE_KERNELS}
    for name, counts in sass.items():
        if not counts:
            log(f"  sass {name}: no cuobjdump in the toolkit, not counted")
            continue
        for kernel, c in sorted(counts.items()):
            log(f"  sass {name}: {kernel}: {c['HGMMA']} HGMMA, "
                f"{c['HMMA']} HMMA")
            if kernel.startswith(TENSOR_CORE_KERNELS[name]) \
                    and not tensor_core_ok(kernel, c):
                raise RuntimeError(f"{kernel} holds no tensor-core "
                                   "instruction its regime needs")
        for prefix in TENSOR_CORE_KERNELS[name]:
            if not any(k.startswith(prefix) for k in counts):
                raise RuntimeError(f"no {prefix} in the SASS of {name}")
    log("  nvcc (sm_90a, in parallel) " + ", ".join(
        f"csrc/{n}.cu {nvcc_s[n]:.1f} s" for n in sources)
        + f"; Triton rms_norm {triton_s:.1f} s")

    log("phase kernels (bf16 on the card, compared in f32)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    decode_lengths = [1, 17, 300, 511, 1024, 1500, 1999, 2048]
    attn = {kind: [] for kind in PAGED_KINDS}
    for kind, single, _ in ((k, v[1], v[2]) for k, v in PAGED_KINDS.items()):
        attn[kind].append(attention_case(torch, F, dev, flush, kind,
                                         "decode K=1 B=8", 8, 1,
                                         decode_lengths))
        if single:
            continue
        attn[kind].append(attention_case(
            torch, F, dev, flush, kind, "K=4 B=8", 8, 4,
            [4, 40, 333, 700, 1029, 1600, 1999, 2048]))
        attn[kind].append(attention_case(torch, F, dev, flush, kind,
                                         "prefill K=1024 B=1", 1, 1024,
                                         [100 + 1024]))
    mla = {kind: [] for kind in MLA_KINDS}
    for kind, (_, single, _) in MLA_KINDS.items():
        mla[kind].append(mla_case(torch, F, dev, flush, kind,
                                  "decode K=1 B=8", 8, 1, MLA_DECODE_LENGTHS))
        if not single:
            mla[kind].append(mla_case(torch, F, dev, flush, kind,
                                      "prefill K=1024 B=1", 1, 1024,
                                      [100 + 1024]))
    gc.collect()
    torch.cuda.empty_cache()
    int4 = [int4_case(torch, dev, flush, rows, kin, out, leaves)
            for rows in (8, 1024) for kin, out, leaves in INT4_SHAPES]
    gc.collect()
    torch.cuda.empty_cache()
    rms = [rms_case(torch, F, dev, flush, (rows, 4096)) for rows in (8, 1024)]
    # the training path's shape: x (8, 2048, 4096) needing gradients
    rms.append(rms_case(torch, F, dev, flush, (8, 2048, 4096), grad=True))

    log("phase flash kernels (bf16 on the card, compared in f32)")
    flash = [flash_case(torch, F, dev, flush, *case) for case in FLASH_CASES]
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    log("phase engine (llama3-8b, 8 slots, cache_len 2048)")
    from k8s_runpod_kubelet_tpu_torch.models import init_params, llama3_8b

    cfg = llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  random bf16 init in {init_s:.1f} s")
    eng, bf16_logits = engine_phase(torch, dev, card, cfg, params)
    eng["init_s"] = init_s
    gc.collect()
    torch.cuda.empty_cache()

    log("phase quantized engine (llama3-8b --int4 --kv-int8, 8 slots, "
        "cache_len 2048)")
    box = [params]
    del params
    qeng = quant_engine_phase(torch, dev, card, cfg, box, eng, bf16_logits)
    del box, bf16_logits
    gc.collect()
    torch.cuda.empty_cache()

    log("phase MLA engine (mla-8b, bf16 latents, 8 slots, cache_len 2048)")
    from k8s_runpod_kubelet_tpu_torch.models import mla_8b

    mcfg = mla_8b()
    t0 = time.perf_counter()
    box = [init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)]
    torch.cuda.synchronize()
    mla_init_s = time.perf_counter() - t0
    log(f"  random bf16 init in {mla_init_s:.1f} s")
    mla_eng, mla_logits = mla_engine_phase(torch, dev, card, mcfg, box,
                                           kv_int8=False)
    mla_eng["init_s"] = mla_init_s
    gc.collect()
    torch.cuda.empty_cache()
    log("phase MLA engine (mla-8b --kv-int8: int8 latents, 8 slots, "
        "cache_len 2048)")
    mla_q, _ = mla_engine_phase(torch, dev, card, mcfg, box, kv_int8=True,
                                bf16_logits=mla_logits)
    del box, mla_logits
    gc.collect()
    torch.cuda.empty_cache()

    log("phase train (llama3-8b widths, 4 layers, batch 8 x seq 2048)")
    train = train_phase(torch, dev, card)

    log("phase train_main (--model tiny, checkpoint and resume)")
    train_cli = train_main_phase(torch)

    def record(name, route, source, replaces, cases, launches, by_path,
               library_call):
        head = cases[0]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "library_call": library_call, "case": head["case"],
                "cases": cases}

    def flash_cases(kname):
        return [{"case": c["case"], **c["kernels"][kname]} for c in flash]

    serve_launches, quant_launches = eng["launches"], qeng["launches"]
    mla_launches, mla_q_launches = mla_eng["launches"], mla_q["launches"]
    csrc = "k8s_runpod_kubelet_tpu_torch/csrc/"
    jax_attn = "k8s_runpod_kubelet_tpu/ops/attention.py:"
    sdpa = "SDPA over the gathered (dequantized) K/V, same mask"
    kernels = [
        record("paged_attention_multi", "cuda",
               csrc + "paged_attention_multi.cu", jax_attn + "1524",
               attn["paged_attention_multi"],
               serve_launches["paged_attention_multi"],
               {"serve": serve_launches["paged_attention_multi"],
                "serve_int4_kv_int8":
                    quant_launches["paged_attention_multi"]}, sdpa),
        record("rms_norm", "triton",
               "k8s_runpod_kubelet_tpu_torch/ops/rmsnorm.py",
               "k8s_runpod_kubelet_tpu/ops/rmsnorm.py:80", rms,
               serve_launches["rms_norm"],
               {"serve": serve_launches["rms_norm"],
                "serve_int4_kv_int8": quant_launches["rms_norm"],
                "serve_mla": mla_launches["rms_norm"],
                "serve_mla_kv_int8": mla_q_launches["rms_norm"],
                "train": train["launches"]["rms_norm"]},
               "F.rms_norm, bf16 weight"),
    ] + [
        record(kname, "cuda", csrc + "flash_attention.cu",
               replaces, flash_cases(kname), train["launches"][kname],
               {"train": train["launches"][kname]}, library_call)
        for kname, replaces, library_call in (
            ("flash_fwd", jax_attn + "199", "SDPA forward"),
            ("flash_dq", jax_attn + "360",
             "SDPA autograd backward: dq, dk and dv together"),
            ("flash_dkv", jax_attn + "397",
             "SDPA autograd backward: dq, dk and dv together"))
    ] + [
        record("paged_attention_multi_quant", "cuda",
               csrc + "paged_attention_multi_quant.cu", jax_attn + "1741",
               attn["paged_attention_multi_quant"],
               quant_launches["paged_attention_multi_quant"],
               {"serve_int4_kv_int8":
                    quant_launches["paged_attention_multi_quant"]},
               sdpa + " (a yardstick: no single PyTorch call reads int8 "
               "pages)"),
        record("int4_matmul", "cuda", csrc + "int4_matmul.cu",
               "k8s_runpod_kubelet_tpu/ops/int4_matmul.py:64", int4,
               quant_launches["int4_matmul"],
               {"serve_int4_kv_int8": quant_launches["int4_matmul"]},
               "torch.ops.aten._weight_int4pack_mm on the same nibbles and "
               "bf16 group scales (yardstick_ms: torch.matmul by the "
               "dequantized bf16 weight)"),
    ] + [
        # the single-token forms: no model path calls them in either
        # package (decode runs the multi-token kernels at K = 1); their
        # counts are read from both bursts, which hold them at 0
        record(kname, "cuda", csrc + source, jax_attn + line, attn[kname],
               serve_launches[kname] + quant_launches[kname],
               {"serve": serve_launches[kname],
                "serve_int4_kv_int8": quant_launches[kname]}, library_call)
        for kname, source, line, library_call in (
            ("paged_attention", "paged_attention_multi.cu", "608", sdpa),
            ("paged_attention_quant", "paged_attention_multi_quant.cu",
             "884", sdpa + " (a yardstick: no single PyTorch call reads "
             "int8 pages)"))
    ]
    mla_sdpa = ("SDPA over the gathered latents in bf16, q = [q_lat, "
                "q_rope], k = [c, kr], v = c, one kv head (enable_gqa), "
                "same mask")
    kernels += [
        record("paged_attention_multi_mla", "cuda",
               csrc + "paged_attention_multi_mla.cu", jax_attn + "1932",
               mla["paged_attention_multi_mla"],
               mla_launches["paged_attention_multi_mla"],
               {"serve_mla": mla_launches["paged_attention_multi_mla"],
                "serve_mla_kv_int8":
                    mla_q_launches["paged_attention_multi_mla"]}, mla_sdpa),
        record("paged_attention_multi_mla_quant", "cuda",
               csrc + "paged_attention_multi_mla_quant.cu", jax_attn + "2105",
               mla["paged_attention_multi_mla_quant"],
               mla_q_launches["paged_attention_multi_mla_quant"],
               {"serve_mla": mla_launches["paged_attention_multi_mla_quant"],
                "serve_mla_kv_int8":
                    mla_q_launches["paged_attention_multi_mla_quant"]},
               mla_sdpa + " over the dequantized latents (a yardstick: no "
               "single PyTorch call reads int8 latents)"),
    ] + [
        # the single-token MLA forms: no model path calls them (decode runs
        # the multi-token kernels at K = 1); counted in both MLA bursts,
        # which hold them at 0
        record(kname, "cuda", csrc + source, jax_attn + line, mla[kname],
               mla_launches[kname] + mla_q_launches[kname],
               {"serve_mla": mla_launches[kname],
                "serve_mla_kv_int8": mla_q_launches[kname]}, library_call)
        for kname, source, line, library_call in (
            ("paged_attention_mla", "paged_attention_multi_mla.cu", "1078",
             mla_sdpa),
            ("paged_attention_mla_quant", "paged_attention_multi_mla_quant.cu",
             "1269", mla_sdpa + " over the dequantized latents (a "
             "yardstick: no single PyTorch call reads int8 latents)"))
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": device, "kernels": kernels,
                       "flash": flash, "engine": eng,
                       "quant_engine": qeng, "mla_engine": mla_eng,
                       "mla_kv_int8_engine": mla_q, "train": train,
                       "train_main": train_cli,
                       "build_s": {**nvcc_s, "triton": triton_s},
                       "sass": sass},
                      f, indent=1)
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
