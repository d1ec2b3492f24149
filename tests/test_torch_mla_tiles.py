"""The tensor-core MLA latent-attention recipe, emulated in plain PyTorch on
the CPU, against the port's plain versions and the JAX package's kernels.

``csrc/paged_attention_mla.cuh`` is the body of both paged MLA kernels on
the card. A CUDA kernel cannot run here, so this file runs its arithmetic
step by step:

- blocks of 64 query rows (query-major, row = j * Hq + h) over tiles of 32
  keys [c | kr], gathered page by page, zeros past the split's end;
- q = q_lat * scale and q_rope * scale as bf16 hi + lo; the two warpgroups'
  halves of S (each its half of the latent columns and half of the rope
  columns, int8 tiles scaled per key after the products: S_c * c_scale +
  S_r * kr_scale), summed;
- the online softmax in log2 units with the causal floor per row, P (times
  c_scale for int8 latents) as bf16 hi + lo against the tile's latents
  (int8 values, exact as bf16);
- split-KV ranges from the wrapper's own ``_mla_split_plan`` and
  ``_split_ranges``, merged by their maxima, a split that saw no key of a
  row left out.

Each result is held per element to ``chip_smoke.py``'s tolerance, 1e-4 +
1e-2 |plain| (the f32 output of two f32 computations of the same function
from the same inputs: every product exact or carried to ~2^-17 by the hi +
lo split, the sums in another order), against
``_paged_attention_multi_mla{,_quant}_plain`` on the same inputs, and
against the JAX kernels in interpret mode on the same numpy inputs. The
control runs the same recipe with q in bf16 alone (no lo term) and must
fall outside the tolerance, at mla-8b's decode shape.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops import attention as jattn
from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _mla_split_plan, _paged_attention_multi_mla_plain,
    _paged_attention_multi_mla_quant_plain, _split_ranges)

ATOL, RTOL = 1e-4, 1e-2            # chip_smoke.py: output vs f32 plain
LOG2E = 1.4426950408889634
NEG_INF = -1e30
H100_SMS = 132
ROWS, BN = 64, 32                  # rows a block, keys a tile


def _share(out, ref) -> float:
    """Largest share of the per-element tolerance (above 1 fails)."""
    return float(((out - ref).abs() / (ATOL + RTOL * ref.abs())).max())


def _hi_lo(x, split=True):
    """An f32 operand as the kernel feeds it to a bf16 product: hi + lo
    (two products, each exact in f32), or bf16 alone (the control)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _walk(qs, qrs, c, kr, cs, krs, pos, hi):
    """One block's walk over one split's keys (a multiple of 32, zeros past
    its end): qs and qrs the hi (+ lo) terms of q_lat and q_rope (rows, .),
    c (n, R) and kr (n, Dr) the staged latents (int8 integers for int8
    pages, with per-key scales cs, krs; None for bf16), pos the keys'
    positions, hi each row's last visible position. Returns the
    unnormalised f32 accumulator, the running max (log2 units) and sum."""
    n_rows, r = qs[0].shape
    dr = qrs[0].shape[1]
    o = torch.zeros((n_rows, r))
    m = torch.full((n_rows,), NEG_INF)
    l = torch.zeros(n_rows)
    for t0 in range(0, c.shape[0], BN):
        ct, krt, pt = c[t0:t0 + BN], kr[t0:t0 + BN], pos[t0:t0 + BN]
        halves = []
        for w in (0, 1):      # the two warpgroups: their latent, rope halves
            rc = slice(w * r // 2, (w + 1) * r // 2)
            rd = slice(w * dr // 2, (w + 1) * dr // 2)
            s_c = sum(q[:, rc] @ ct[:, rc].T for q in qs)
            s_r = sum(q[:, rd] @ krt[:, rd].T for q in qrs)
            if cs is None:
                halves.append(s_c + s_r)
            else:
                halves.append(s_c * cs[t0:t0 + BN] + s_r * krs[t0:t0 + BN])
        s = halves[0] + halves[1]
        keep = pt[None] <= hi[:, None]
        x = torch.where(keep, s * LOG2E, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[:, None])          # exactly 0 where masked
        l = l * corr + p.sum(-1)
        if cs is not None:
            p = p * cs[t0:t0 + BN]
        ph, pl = _hi_lo(p)
        o = o * corr[:, None] + ph @ ct + pl @ ct
        m = m_new
    return o, m, l


def _mla_recipe(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
                page_table, lengths, *, sm_scale, split_q=True,
                sms=H100_SMS):
    """The kernel's recipe over every (sequence, 64-row tile, split); the
    splits merged as mla_merge_kernel does. f32 output (B, K, Hq, R)."""
    b, kq, hq, r = q_lat.shape
    _, t, dr = kr_pages.shape
    cols = page_table.shape[1]
    n_rows = kq * hq
    _, per = _mla_split_plan(b, kq, hq, cols, sms)
    out = torch.zeros((b, n_rows, r))
    for bi in range(b):
        length = int(lengths[bi])
        ql = q_lat[bi].reshape(n_rows, r).float() * sm_scale
        qr = q_rope[bi].reshape(n_rows, dr).float() * sm_scale
        for row0 in range(0, n_rows, ROWS):
            rows = torch.arange(row0, min(row0 + ROWS, n_rows))
            qpos = length - kq + rows // hq
            newest = int(qpos[-1])
            qs = _hi_lo(ql[rows], split_q)
            qrs = _hi_lo(qr[rows], split_q)
            parts = []
            for p0, p1 in _split_ranges(length, row0, int(rows[-1]), kq, hq,
                                        t, None, per, cols):
                end = min(p1 * t, newest + 1)
                n = -(-(end - p0 * t) // BN) * BN
                pos = torch.arange(p0 * t, p0 * t + n)
                live = pos < end
                page = page_table[bi, pos[live] // t].long()
                c = torch.zeros((n, r))
                kr = torch.zeros((n, dr))
                c[live] = c_pages[page, pos[live] % t].float()
                kr[live] = kr_pages[page, pos[live] % t].float()
                cs = krs = None
                if c_scale is not None:
                    cs, krs = torch.zeros(n), torch.zeros(n)
                    cs[live] = c_scale[page, pos[live] % t]
                    krs[live] = kr_scale[page, pos[live] % t]
                parts.append(_walk(qs, qrs, c, kr, cs, krs, pos,
                                   qpos.clamp(max=end - 1)))
            seen = torch.stack([l_s > 0 for _, _, l_s in parts])
            big = torch.where(seen, torch.stack([m for _, m, _ in parts]),
                              torch.full_like(seen, NEG_INF, dtype=torch.float
                                              )).amax(0)
            acc = torch.zeros((len(rows), r))
            l = torch.zeros(len(rows))
            for (o_s, m_s, l_s), seen_s in zip(parts, seen):
                w = torch.where(seen_s, torch.exp2(m_s - big),
                                torch.zeros_like(m_s))
                acc += w[:, None] * o_s
                l += w * l_s
            out[bi, rows] = acc / l.clamp_min(1e-30)[:, None]
    return out.reshape(b, kq, hq, r)


def _case(b, kq, hq, r, dr, t, cols, lengths, seed=0):
    """Latent pages in random order; table entries past ceil(len/T) name
    pages of large finite garbage (never read); a length past the table's
    cols x T positions fills every column."""
    rng = np.random.default_rng(seed)
    live = [min(-(-n // t), cols) for n in lengths]
    n_garbage = 4
    n_pages = sum(live) + n_garbage
    perm = rng.permutation(n_pages)
    table = np.zeros((b, cols), np.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[np.arange(cols - live[i]) % n_garbage]
    c = rng.normal(size=(n_pages, t, r)).astype(np.float32)
    kr = rng.normal(size=(n_pages, t, dr)).astype(np.float32)
    c[garbage], kr[garbage] = 3e4, -3e4
    q_lat = rng.normal(size=(b, kq, hq, r)).astype(np.float32)
    q_rope = rng.normal(size=(b, kq, hq, dr)).astype(np.float32)
    return (q_lat, q_rope, c, kr, table, np.asarray(lengths, np.int32))


def _torch_args(q_lat, q_rope, c, kr, table, lens, quant):
    """Torch tensors as the kernels take them: bf16 latent pages, or int8
    pages and scales from the model's own ``_kv_quant``."""
    tq, tr = torch.from_numpy(q_lat), torch.from_numpy(q_rope)
    cb = torch.from_numpy(c).bfloat16()
    krb = torch.from_numpy(kr).bfloat16()
    if quant:
        (cq, cs), (krq, krs) = _kv_quant(cb), _kv_quant(krb)
        pages = (cq, krq, cs, krs)
    else:
        pages = (cb, krb, None, None)
    return tq, tr, pages, torch.from_numpy(table), torch.from_numpy(lens)


def _plain(tq, tr, pages, table, lens, scale):
    if pages[2] is None:
        return _paged_attention_multi_mla_plain(tq, tr, *pages[:2], table,
                                                lens, sm_scale=scale)
    return _paged_attention_multi_mla_quant_plain(tq, tr, *pages, table,
                                                  lens, sm_scale=scale)


# mla-8b: 32 heads, latent 512, rope 64, 16-token pages, (head_dim +
# rope)^-0.5; decode at the burst's contexts, short chunks, ragged rows
MLA8B = (32, 512, 64, 16)
CASES = {
    # name: (B, K, lengths, table cols)
    "decode_8b": (8, 1, [402, 475, 468, 252, 411, 789, 881, 571], 128),
    "k4_8b": (2, 4, [4, 333], 64),
    "chunk_8b": (1, 40, [40 + 37], 16),
    "past_the_table": (2, 3, [4 * 16 + 5, 3 * 4 * 16], 4),
}
SCALE = (128 + 64) ** -0.5


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mla_recipe_matches_plain_within_chip_tolerance(name, quant):
    b, kq, lengths, cols = CASES[name]
    hq, r, dr, t = MLA8B
    tq, tr, pages, table, lens = _torch_args(
        *_case(b, kq, hq, r, dr, t, cols, lengths), quant)
    out = _mla_recipe(tq, tr, *pages, table, lens, sm_scale=SCALE)
    ref = _plain(tq, tr, pages, table, lens, SCALE)
    assert torch.isfinite(out).all()
    assert _share(out, ref) <= 1


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_mla_recipe_with_q_in_bf16_alone_falls_outside_the_tolerance(quant):
    """The control at mla-8b's decode shape: q_lat and q_rope rounded to
    bf16 (no lo term) move each score by ~2^-9 relative and miss the check
    the split recipe passes on the same inputs."""
    b, kq, lengths, cols = CASES["decode_8b"]
    hq, r, dr, t = MLA8B
    tq, tr, pages, table, lens = _torch_args(
        *_case(b, kq, hq, r, dr, t, cols, lengths, seed=5), quant)
    ref = _plain(tq, tr, pages, table, lens, SCALE)
    split = _mla_recipe(tq, tr, *pages, table, lens, sm_scale=SCALE)
    rounded = _mla_recipe(tq, tr, *pages, table, lens, sm_scale=SCALE,
                          split_q=False)
    assert _share(split, ref) <= 1
    assert _share(rounded, ref) > 1


def test_mla_decode_recipe_splits_and_matches_the_one_pass_walk():
    """Decode splits the pages (8 one-tile sequences on 132 SMs); the merged
    splits agree with the walk of one split per block."""
    b, kq, lengths, cols = CASES["decode_8b"]
    hq, r, dr, t = MLA8B
    assert _mla_split_plan(b, kq, hq, cols, H100_SMS)[0] > 1
    tq, tr, pages, table, lens = _torch_args(
        *_case(b, kq, hq, r, dr, t, cols, lengths, seed=2), False)
    split = _mla_recipe(tq, tr, *pages, table, lens, sm_scale=SCALE)
    whole = _mla_recipe(tq, tr, *pages, table, lens, sm_scale=SCALE, sms=1)
    assert _share(split, whole) <= 1


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_mla_recipe_matches_the_jax_kernels_in_interpret_mode(quant):
    """At a narrow latent (R 64, Dr 16, T 8) the recipe against the JAX
    Pallas kernel on the same numpy inputs (f32 latents for the bf16 kind
    are rounded to bf16 first, the int8 kind takes the same int8 pages)."""
    b, kq, hq, r, dr, t, cols = 2, 3, 4, 64, 16, 8, 6
    q_lat, q_rope, c, kr, table, lens = _case(b, kq, hq, r, dr, t, cols,
                                              [3, 29], seed=4)
    tq, tr, pages, ttable, tlens = _torch_args(q_lat, q_rope, c, kr, table,
                                               lens, quant)
    out = _mla_recipe(tq, tr, *pages, ttable, tlens, sm_scale=0.17)
    jpages = [jnp.asarray(p.float().numpy() if p.dtype == torch.bfloat16
                          else p.numpy()) for p in pages if p is not None]
    jfn = (jattn.paged_attention_multi_mla_quant if quant
           else jattn.paged_attention_multi_mla)
    ref = np.array(jfn(jnp.asarray(q_lat), jnp.asarray(q_rope), *jpages,
                       jnp.asarray(table), jnp.asarray(lens),
                       sm_scale=0.17, interpret=True))
    assert _share(out, torch.from_numpy(ref)) <= 1


def test_mla_split_plan_splits_small_grids_only():
    for b, kq, hq, cols in ((8, 1, 32, 128), (1, 1, 32, 128), (8, 4, 32, 64),
                            (1, 1024, 32, 128), (3, 5, 6, 12), (2, 1, 4, 1)):
        splits, per = _mla_split_plan(b, kq, hq, cols, H100_SMS)
        blocks = b * -(-kq * hq // ROWS)
        assert per >= 1 and (splits - 1) * per < cols <= splits * per
        assert (splits == 1) == (blocks >= H100_SMS or cols <= 1)
        if splits > 1:      # about one block an SM, not many more
            assert blocks * splits < 2 * H100_SMS + blocks
