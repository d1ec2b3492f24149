#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version on the card, then serves llama3-8b
(full width and depth, random bf16 weights from a seed) through the
paged engine and its HTTP front.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failed check raises: the script exits nonzero and does not
print the final ``ok`` line):

1. card: name and power limit (nvidia-smi), printed before any number;
2. build: ``csrc/paged_attention_multi.cu`` with nvcc for sm_90a, and
   the Triton RMSNorm kernel, with their seconds;
3. kernels vs plain on the card, at the shapes the 8B main path gives
   them: ``paged_attention_multi`` (decode K=1 B=8 with ragged lengths up
   to 2048, K=4 B=8, a 1024-token prefill chunk behind a 100-token
   prefix; tables carry stale ids of garbage pages past ceil(len/T)) and
   ``rms_norm`` (8 and 1024 rows of 4096). Each case prints the max abs
   error and its share of the tolerance (each element within 1e-4 +
   1e-2 |plain|, 1.3 bf16 ulps; attention cases also score two broken
   variants against it: p.v accumulated in bf16, and a page lost from
   the long contexts), the kernel's median time (CUDA events,
   L2 flushed before every launch), its bound (bytes over 3.35 TB/s or
   operations over the peak for their type, whichever is larger), the
   plain version's time, and one PyTorch library call's time for the
   same function (SDPA over the gathered K/V with the same mask,
   ``F.rms_norm``), which the port itself never calls;
4. engine: ``ServingEngine`` for llama3-8b, 8 slots, cache_len 2048,
   16-token pages; 8 greedy requests of 200-900 prompt tokens (two share
   a 96-token prefix), 32 new tokens each. Both kernels' launch counters
   are set to 0 just before and read just after; all 8 must finish, the
   prefix hit must register, both counters must have risen. Launches are
   also read per path, each against the engine's own step counters: the
   decode-only stretch after the burst's last prefill, and a prefill-only
   stretch (a 1500-token prompt, two chunks, one new token); every step
   or chunk must launch the attention kernel once per layer and the norm
   kernel twice per layer plus once;
5. repeat: one prompt served twice more gives the same tokens both times;
6. HTTP: the front on a free port answers one POST /generate with 200;
7. drain: the engine drains and the pool holds zero leaked pages.

The next-to-last line is the kernels JSON record, the last line
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every
number (engine phase included) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
SEED = 20261016
# Kernel and plain version both compute in f32 and round once to bf16, so
# they differ by at most one bf16 ulp of the output, which is <= 2^-7 |y|;
# RTOL is 1.3 ulps, ATOL covers f32 sum-order noise near zero. Both apply
# to each element against the plain version's |y|.
BF16_ATOL, BF16_RTOL = 1e-4, 1e-2
TOLERANCE = f"atol {BF16_ATOL} + rtol {BF16_RTOL}"


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

def tolerance_check(out, ref) -> tuple[float, float]:
    """(max abs error, largest share of the tolerance) of out against ref;
    a share above 1 fails the check."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    share = (diff / (BF16_ATOL + BF16_RTOL * ref.abs())).max().item()
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


def attention_controls(torch, qs, kc, vc, mask, scale, t, ref) -> dict:
    """The tolerance check applied to two broken variants of the same
    attention: p.v accumulated page by page in bf16, and the second page
    lost from every context of 1024 positions or more (rows with shorter
    contexts are left right, so the long rows alone are scored). A share
    of the tolerance above 1 means the check catches the fault."""
    b, h, kq, s_len = mask.shape[0], qs.shape[1], qs.shape[2], kc.shape[2]
    cols, d = s_len // t, qs.shape[3]
    s = (qs.float() @ kc.float().transpose(-1, -2)) * scale
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
                    ("lost_page", o_lost)):
        err, share = tolerance_check(o, ref)
        out[name] = {"max_abs_err": err, "tolerance_share": share}
    return out


def attention_case(torch, F, dev, flush, name, b, kq, lengths):
    from k8s_runpod_kubelet_tpu_torch.ops import paged_attention_multi
    from k8s_runpod_kubelet_tpu_torch.ops.attention import \
        _paged_attention_multi_plain

    q, k, v, table, lens, live = attention_inputs(torch, dev, b, kq, lengths)
    hq, d = q.shape[2], q.shape[3]
    t, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5

    def kernel():
        return paged_attention_multi(q, k, v, table, lens, sm_scale=scale)

    def plain():
        return _paged_attention_multi_plain(q, k, v, table, lens,
                                            sm_scale=scale)

    before = paged_attention_multi.launches
    out = kernel()
    torch.cuda.synchronize()
    if paged_attention_multi.launches != before + 1:
        raise RuntimeError("paged_attention_multi did not launch its kernel")
    ref = plain()
    err, share = tolerance_check(out, ref)
    if share > 1:
        raise RuntimeError(f"paged_attention_multi {name}: max abs err "
                           f"{err}, {share:.2f}x the tolerance {TOLERANCE}")
    # the library yardstick: SDPA over contiguous K/V gathered once
    qs, kc, vc, mask = gathered(torch, q, k, v, table, lens)
    controls = attention_controls(torch, qs, kc, vc, mask, scale, t, ref)

    def library():
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                              scale=scale)

    ms = time_ms(torch, kernel, 50, flush)
    plain_ms = time_ms(torch, plain, 10, flush)
    library_ms = time_ms(torch, library, 20, flush)
    page_bytes = t * hkv * d * 2
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
    log(f"  paged_attention_multi {name}: max_abs_err {err:.3e} "
        f"({share:.2f} of {TOLERANCE}; controls: bf16 accumulation "
        f"{controls['bf16_accumulation']['max_abs_err']:.3e} "
        f"({controls['bf16_accumulation']['tolerance_share']:.2f}), lost "
        f"page {controls['lost_page']['max_abs_err']:.3e} "
        f"({controls['lost_page']['tolerance_share']:.2f})) kernel "
        f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain "
        f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms")
    return rec


def rms_case(torch, F, dev, flush, rows):
    from k8s_runpod_kubelet_tpu_torch.ops import rms_norm
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

    e, eps = 4096, 1e-5
    gen = torch.Generator().manual_seed(SEED + rows)
    x = torch.randn((rows, e), generator=gen).mul_(3).to(dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn((e,), generator=gen)).to(dev)
    w_bf16 = w.to(torch.bfloat16)   # the library call takes one dtype

    before = rms_norm.launches
    out = rms_norm(x, w, eps)
    torch.cuda.synchronize()
    if rms_norm.launches != before + 1:
        raise RuntimeError("rms_norm did not launch its kernel")
    err, share = tolerance_check(out, _rms_norm_plain(x, w, eps))
    if share > 1:
        raise RuntimeError(f"rms_norm rows={rows}: max abs err {err}, "
                           f"{share:.2f}x the tolerance {TOLERANCE}")
    ms = time_ms(torch, lambda: rms_norm(x, w, eps), 100, flush)
    plain_ms = time_ms(torch, lambda: _rms_norm_plain(x, w, eps), 50, flush)
    library_ms = time_ms(torch, lambda: F.rms_norm(x, (e,), w_bf16, eps),
                         100, flush)
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    ops = 4 * x.numel()   # square, sum, scale, weight: f32 elementwise
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    rec = {"case": f"rows={rows}", "rows": rows, "E": e,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    log(f"  rms_norm rows={rows}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}) kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms, library (F.rms_norm) "
        f"{library_ms:.4f} ms")
    return rec


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
    return {"prompt_tokens": n, "cached_tokens": cached * t,
            "max_abs_diff": (a - b).abs().max().item(),
            "cache_vs_uncached_max_abs_diff": (b - c).abs().max().item(),
            "two_chunk_max_abs_diff": (a - c).abs().max().item(),
            "logit_std": a.std().item(),
            "top1_margin": (top2[0] - top2[1]).item(),
            "argmax_agree": bool(a.argmax() == b.argmax())}


def engine_phase(torch, dev, card: str) -> dict:
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models import init_params, llama3_8b
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention_multi,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg = llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, max_new_tokens=32)
    engine = ServingEngine(cfg, params, sc, device=dev).start()
    httpd = None
    try:
        log(f"  llama3-8b: {cfg.n_layers} layers, E={cfg.embed_dim}, "
            f"random bf16 init in {init_s:.1f} s; arena "
            f"{engine._kv_store.pool.n_pages} pages of 16 tokens, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        rng = np.random.default_rng(SEED)

        def prompt(n: int) -> list[int]:
            return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

        # warm-up: cuBLAS handles and first-call allocations stay out of
        # the measured phase (a prompt no measured request shares)
        engine.submit(prompt(64), max_new_tokens=4).result(timeout=600)
        prompts = [prompt(int(n)) for n in rng.integers(200, 901, 8)]
        prompts[1] = prompts[0][:96] + prompts[1][96:]
        hits0 = engine.counters["prefix_cache_hits"]

        kernels = (paged_attention_multi, rms_norm)
        per_step = {"paged_attention_multi": cfg.n_layers,
                    "rms_norm": 2 * cfg.n_layers + 1}

        def snap() -> dict:
            # steps and chunks count under the arena lock with their
            # launches, so a snapshot taken holding it is consistent
            with engine._prefix_lock:
                return {"prefill_chunks": engine.counters["prefill_chunks"],
                        "decode_steps": engine.counters["decode_steps"],
                        **{k.__name__: k.launches for k in kernels}}

        def stretch(a: dict, b: dict, path: str) -> dict:
            d = {k: b[k] - a[k] for k in a}
            steps = d["prefill_chunks"] + d["decode_steps"]
            for name, n in per_step.items():
                if d[name] < 1 or d[name] != n * steps:
                    raise RuntimeError(
                        f"{path}: {name} launched {d[name]} times in "
                        f"{d['prefill_chunks']} prefill chunks and "
                        f"{d['decode_steps']} decode steps, not {n} per "
                        f"step")
            return d

        # the main path: counts set to 0 just before the burst, read just
        # after; within it, the stretch after the last prefill is decode
        # only
        with engine._prefix_lock:
            for k in kernels:
                k.launches = 0
        s0 = snap()
        t_start = time.perf_counter()
        futs = [engine.submit(p) for p in prompts]
        deadline = time.monotonic() + 600
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
        # prefill only: a 1500-token prompt (two chunks) asking for one
        # token completes at admission, with no decode step
        s3 = snap()
        engine.submit(prompt(1500), max_new_tokens=1).result(timeout=600)
        prefill = stretch(s3, snap(), "prefill-only stretch")
        if prefill["decode_steps"] or prefill["prefill_chunks"] != 2:
            raise RuntimeError(f"prefill-only stretch counted {prefill}")
        by_path = {"burst": burst, "decode_only": decode,
                   "prefill_only": prefill}
        for path, d in by_path.items():
            log(f"  launches, {path}: {d['prefill_chunks']} prefill chunks, "
                f"{d['decode_steps']} decode steps; paged_attention_multi "
                f"{d['paged_attention_multi']}, rms_norm {d['rms_norm']}")

        # repeat: the same prompt twice more, both through the prefix-hit
        # path, must give the same tokens
        rep = [engine.submit(prompts[2]).result(timeout=600)["tokens"]
               for _ in range(2)]
        if rep[0] != rep[1]:
            raise RuntimeError(f"repeat differs: {rep[0]} vs {rep[1]}")
        same_as_first = sum(a == b for a, b in zip(rep[0],
                                                   results[2]["tokens"]))
        log(f"  repeat: identical twice; {same_as_first}/32 tokens equal "
            f"to the first run (which prefilled without a prefix hit)")
        with engine._prefix_lock:   # the engine is idle; keep it so
            prefix = prefix_path_check(torch, engine.model, engine.params,
                                       prompts[2])
        log(f"  prefix path (last-token logits, max abs diff): one chunk vs "
            f"cached prefix + tail {prefix['max_abs_diff']:.4f}; cached vs "
            f"uncached prefix, same tail chunk "
            f"{prefix['cache_vs_uncached_max_abs_diff']:.4f}; one chunk vs "
            f"two uncached chunks {prefix['two_chunk_max_abs_diff']:.4f} "
            f"(logit std "
            f"{prefix['logit_std']:.4f}, top-1 margin "
            f"{prefix['top1_margin']:.4f}, argmax agree "
            f"{prefix['argmax_agree']})")

        httpd = serve(engine, port=0, host="127.0.0.1")
        status, body = http_generate(httpd.server_address[1],
                                     {"tokens": prompt(100),
                                      "max_new_tokens": 8})
        if status != 200 or len(body.get("tokens", [])) != 8:
            raise RuntimeError(f"/generate answered {status}: {body}")
        log(f"  HTTP: POST /generate -> {status}, {len(body['tokens'])} "
            "tokens")

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
        log(f"  drained: {stats['pages_free']} free + {stats['nodes']} "
            f"cached = {stats['pages_total']} pages, 0 leaked")
        return {"launches": launches, "launches_by_path": by_path,
                "ttft_ms": [x * 1e3 for x in ttft],
                "decode_tok_s_per_stream": per_stream,
                "output_tok_s": out_tok_s, "wall_s": wall,
                "prompt_lengths": [len(p) for p in prompts],
                "prefix_hits": hits, "repeat_same_as_first": same_as_first,
                "prefix_path": prefix, "init_s": init_s}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
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
    t0 = time.perf_counter()
    _cuda.load("paged_attention_multi")
    nvcc_s = time.perf_counter() - t0
    for name, text in sorted(_cuda.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    rms_norm(torch.ones((1, 64), dtype=torch.bfloat16, device=dev),
             torch.ones(64, device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    log(f"  nvcc (csrc/paged_attention_multi.cu, sm_90a) {nvcc_s:.1f} s; "
        f"Triton rms_norm {triton_s:.1f} s")

    log("phase kernels (bf16 on the card, compared in f32)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    attn = [
        attention_case(torch, F, dev, flush, "decode K=1 B=8", 8, 1,
                       [1, 17, 300, 511, 1024, 1500, 1999, 2048]),
        attention_case(torch, F, dev, flush, "K=4 B=8", 8, 4,
                       [4, 40, 333, 700, 1029, 1600, 1999, 2048]),
        attention_case(torch, F, dev, flush, "prefill K=1024 B=1", 1, 1024,
                       [100 + 1024]),
    ]
    rms = [rms_case(torch, F, dev, flush, rows) for rows in (8, 1024)]
    del flush

    log("phase engine (llama3-8b, 8 slots, cache_len 2048)")
    eng = engine_phase(torch, dev, card)

    def record(name, route, source, replaces, cases):
        head = cases[0]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": eng["launches"][name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "case": head["case"],
                "cases": cases}

    kernels = [
        record("paged_attention_multi", "cuda",
               "k8s_runpod_kubelet_tpu_torch/csrc/paged_attention_multi.cu",
               "k8s_runpod_kubelet_tpu/ops/attention.py:1524", attn),
        record("rms_norm", "triton",
               "k8s_runpod_kubelet_tpu_torch/ops/rmsnorm.py",
               "k8s_runpod_kubelet_tpu/ops/rmsnorm.py:80", rms),
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": device, "kernels": kernels,
                       "engine": eng, "build_s": {"nvcc": nvcc_s,
                                                  "triton": triton_s}},
                      f, indent=1)
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
