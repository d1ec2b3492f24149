"""The tensor-core attention tile recipe, emulated in plain PyTorch on the
CPU, against the port's plain versions and the JAX package's reference.

``csrc/attention_tile_sm90.cuh`` is the body of the bf16 flash forward and
of paged multi-token attention on the card. A CUDA kernel cannot run here,
so this file runs its arithmetic step by step in PyTorch:

- bf16 operands, scores as f32 sums of exact products, the softmax scale
  applied to the f32 scores, then the soft cap, then the mask;
- 64-key tiles (32 at D = 256) walked with an online softmax in log2 units
  over row tiles of 64 or 128 rows, the flash band and the paged page
  ranges as the kernels compute them;
- P split into bf16 hi = bf16(P) and lo = bf16(P - hi), O += hi V + lo V in
  f32;
- for paged attention, split-KV ranges from the wrapper's own
  ``_split_plan`` and ``_split_ranges``, merged by their maxima;
- for the flash backward (the dQ and dK/dV kernels of
  ``csrc/flash_attention.cu``): S and dP as f32 sums of exact bf16
  products, P = exp2(S scale log2 e - lse log2 e) with masked entries 0,
  dS = P (dP - delta), 64-row blocks (128 for dQ) over 64-row tiles (32
  at D = 192 and 256) of the band, and every product with an f32 operand
  (P, dS) as bf16 hi + lo: dQ += dS K, dV += P^T dO, dK += dS^T Q. At
  D = 192 (MLA's direct form) each product whose N is the head dimension
  is one m64n192k16 wgmma, whose f32 sums over k16 slices the recipe
  takes whole; the forward keeps 64-key tiles there.

Each result is held per element to ``chip_smoke.py``'s tolerance, 1e-4 +
1e-2 |plain| on the bf16 output (lse: 1e-4 + 1e-5 |plain|, f32), against
``_flash_fwd_plain`` / ``_paged_attention_multi_plain`` in f32 on the same
bf16 inputs, and once against the JAX ``paged_attention_multi`` on the same
numpy inputs. A control runs the same recipe with P rounded to bf16 alone
and must fall outside the tolerance. The backward recipe is held in the
same way against ``_flash_dq_plain``/``_flash_dkv_plain`` (the same lse
and delta) and once against the JAX ``_flash_bwd_pallas`` in interpret
mode; its control rounds dS (and P) to bf16 alone. The split-plan tests
hold the ranges to the kernel's contracts: every split non-empty, the
splits covering exactly the pages the rows see, none behind the window's
first page, nothing read at or past ceil(len / T) or the table's width.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.attention import (
    _flash_bwd_pallas, _flash_fwd_pallas)
from k8s_runpod_kubelet_tpu.ops.attention import \
    paged_attention_multi as jax_paged_attention_multi
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _flash_dkv_plain, _flash_dq_plain, _flash_fwd_plain,
    _paged_attention_multi_plain, _split_plan, _split_ranges, _warpgroups)

ATOL, RTOL = 1e-4, 1e-2            # chip_smoke.py: bf16 output vs f32 plain
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5    # chip_smoke.py: the f32 lse
LOG2E = 1.4426950408889634
NEG_INF = -1e30
H100_SMS = 132


def _share(out, ref, atol=ATOL, rtol=RTOL) -> float:
    """Largest share of the per-element tolerance (above 1 fails)."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs()))
                 .max())


def _bf16(*arrays):
    """Seeded numpy f32 arrays as bf16-valued torch tensors."""
    return [torch.from_numpy(a).bfloat16() for a in arrays]


# -- the recipe -----------------------------------------------------------------

def _tiles(q_rows, keys, vals, key_pos, lo, hi, scale, cap, tile,
           split_p=True):
    """One warpgroup's walk: rows q_rows (R, D) against keys/vals (n, D) at
    positions key_pos (n,), tile by tile; row r sees lo[r] <= pos <= hi[r].
    Returns the unnormalised f32 accumulator (R, D), the running max (R,)
    in log2 units and the running sum (R,)."""
    r, d = q_rows.shape
    o = torch.zeros((r, d))
    m = torch.full((r,), NEG_INF)
    l = torch.zeros((r,))
    qf = q_rows.float()
    for t0 in range(0, keys.shape[0], tile):
        kt, vt = keys[t0:t0 + tile].float(), vals[t0:t0 + tile].float()
        pos = key_pos[t0:t0 + tile]
        s = qf @ kt.T
        # in log2 units, the kernel's products: s (scale log2 e), or
        # (cap log2 e) tanh(s (scale / cap))
        if cap is None:
            s = s * (scale * LOG2E)
        else:
            s = (cap * LOG2E) * torch.tanh(s * (scale / cap))
        keep = (pos[None] >= lo[:, None]) & (pos[None] <= hi[:, None])
        s = torch.where(keep, s, torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])          # exactly 0 where masked
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if split_p:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        o = o * corr[:, None] + pv
        m = m_new
    return o, m, l


def _flash_recipe(q, k, v, *, causal, sm_scale, sliding_window=None,
                  logit_soft_cap=None, split_p=True):
    """The flash forward kernel's recipe: (o bf16, lse f32). Blocks of 128
    query rows (two warpgroups) walk the 64-key tiles (32 at D = 256) of
    their band, as ``k_range`` in ``csrc/flash_attention.cu`` gives it."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bn, bm = (32 if d == 256 else 64), 128
    o = torch.zeros((b, hq, sq, d), dtype=torch.bfloat16)
    lse = torch.zeros((b, hq, sq))
    n_k = -(-sk // bn)
    for q0 in range(0, sq, bm):
        rows = torch.arange(q0, min(q0 + bm, sq))
        kt0, kt1 = 0, n_k
        if causal:
            kt1 = min(n_k, (int(rows[-1]) // bn) + 1)
            if sliding_window is not None and q0 - sliding_window + 1 > 0:
                kt0 = (q0 - sliding_window + 1) // bn
        if causal:
            hi = torch.clamp(rows, max=sk - 1)
            lo = (rows - sliding_window + 1 if sliding_window is not None
                  else torch.zeros_like(rows))
        else:
            hi, lo = torch.full_like(rows, sk - 1), torch.zeros_like(rows)
        keys = torch.arange(kt0 * bn, min(kt1 * bn, sk))
        for bi in range(b):
            for h in range(hq):
                hk = h // (hq // hkv)
                acc, m, l = _tiles(q[bi, h, rows], k[bi, hk, keys],
                                   v[bi, hk, keys], keys, lo, hi, sm_scale,
                                   logit_soft_cap, bn, split_p)
                o[bi, h, rows] = (acc / l.clamp_min(1e-30)[:, None]
                                  ).bfloat16()
                lse[bi, h, rows] = torch.where(
                    l > 0, m / LOG2E + torch.log(l),
                    torch.full_like(l, NEG_INF))
    return o, lse


def _paged_recipe(q, k_pages, v_pages, page_table, lengths, *, sm_scale,
                  logit_soft_cap=None, sliding_window=None, split_p=True,
                  sms=H100_SMS):
    """The paged kernel's recipe: blocks of (sequence, kv head, 64 WG rows)
    over the pages ``_split_ranges`` gives each split of the wrapper's
    ``_split_plan``, 64-key tiles from each split's first page, the splits
    merged by their maxima; bf16 output."""
    b, kq, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    group = hq // hkv
    n_rows = kq * group
    bm = 64 * _warpgroups(n_rows)
    bn = 32 if d == 256 else 64
    _, per = _split_plan(b, kq, group, hkv, page_table.shape[1], sms)
    out = torch.zeros((b, kq, hq, d), dtype=torch.bfloat16)
    for bi in range(b):
        length = int(lengths[bi])
        for row0 in range(0, n_rows, bm):
            rows = torch.arange(row0, min(row0 + bm, n_rows))
            j, g = rows // group, rows % group
            qpos = length - kq + j
            lo = (qpos - sliding_window + 1 if sliding_window is not None
                  else torch.zeros_like(qpos))
            newest = int(qpos[-1])
            ranges = _split_ranges(length, row0, int(rows[-1]), kq, group, t,
                                   sliding_window, per, page_table.shape[1])
            for h in range(hkv):
                parts = []
                for p0, p1 in ranges:
                    # the split's keys, then zero rows up to a whole tile,
                    # as the kernel's cp.async zero-fill leaves them; each
                    # row's last key is clamped to the split's end
                    end = min(p1 * t, newest + 1)
                    n = -(-(end - p0 * t) // bn) * bn
                    pos = torch.arange(p0 * t, p0 * t + n)
                    live = pos < end
                    page = page_table[bi, pos[live] // t].long()
                    keys = torch.zeros((n, d), dtype=k_pages.dtype)
                    vals = torch.zeros((n, d), dtype=v_pages.dtype)
                    keys[live] = k_pages[page, pos[live] % t, h]
                    vals[live] = v_pages[page, pos[live] % t, h]
                    parts.append(_tiles(q[bi, j, h * group + g], keys, vals,
                                        pos, lo, qpos.clamp(max=end - 1),
                                        sm_scale, logit_soft_cap, bn,
                                        split_p))
                big = torch.stack([m for _, m, _ in parts]).amax(0)
                acc = torch.zeros((len(rows), d))
                l = torch.zeros(len(rows))
                for o_s, m_s, l_s in parts:
                    w = torch.exp2(m_s - big)
                    acc += w[:, None] * o_s
                    l += w * l_s
                out[bi, j, h * group + g] = (
                    acc / l.clamp_min(1e-30)[:, None]).bfloat16()
    return out


# -- flash forward --------------------------------------------------------------

FLASH = {
    # name: (B, Hq, Hkv, Sq, Sk, D, causal, window, soft cap)
    "gqa4_ragged": (1, 8, 2, 300, 300, 64, True, None, None),
    "group1": (1, 4, 4, 192, 192, 128, True, None, None),
    "window": (1, 4, 2, 260, 260, 64, True, 70, None),
    "soft_cap": (1, 4, 2, 200, 200, 64, True, None, 5.0),
    "non_causal": (1, 4, 2, 130, 130, 64, False, None, None),
    "d256": (1, 2, 1, 100, 100, 256, True, None, None),
    "sq_gt_sk_window": (1, 2, 1, 90, 40, 64, True, 8, None),
    # MLA's direct form: head_dim 128 + rope 64, one kv head a q head
    "d192": (1, 2, 2, 150, 150, 192, True, None, None),
}


def _flash_inputs(name, seed=0):
    b, hq, hkv, sq, sk, d = FLASH[name][:6]
    rng = np.random.default_rng(seed + sorted(FLASH).index(name))
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    return _bf16(q, k, v)


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_recipe_matches_plain_within_chip_tolerance(name):
    causal, window, cap = FLASH[name][6:]
    q, k, v = _flash_inputs(name)
    args = dict(causal=causal, sm_scale=q.shape[3] ** -0.5,
                sliding_window=window, logit_soft_cap=cap)
    o, lse = _flash_recipe(q, k, v, **args)
    o_ref, lse_ref = _flash_fwd_plain(q.float(), k.float(), v.float(),
                                      **args)
    assert _share(o, o_ref) <= 1
    assert _share(lse, lse_ref, LSE_ATOL, LSE_RTOL) <= 1
    assert torch.isfinite(o.float()).all()


def test_flash_recipe_rows_that_see_no_key_give_zero_and_neg_inf_lse():
    q, k, v = _flash_inputs("sq_gt_sk_window")
    o, lse = _flash_recipe(q, k, v, causal=True, sm_scale=0.125,
                           sliding_window=8)
    # rows 47.. see keys >= row - 7 >= 40 = Sk: none
    assert torch.all(o[:, :, 47:].float() == 0)
    assert torch.all(lse[:, :, 47:] == NEG_INF)
    assert torch.all(lse[:, :, :47] > -100)


def test_flash_recipe_with_bf16_p_falls_outside_the_tolerance():
    """The control: P rounded to bf16 before P V (the textbook tensor-core
    kernel) misses the check the split recipe passes on the same inputs."""
    rng = np.random.default_rng(3)
    q, k, v = _bf16(*(rng.normal(size=(1, 4, 512, 64)).astype(np.float32)
                      for _ in range(3)))
    args = dict(causal=True, sm_scale=0.125)
    o_ref, _ = _flash_fwd_plain(q.float(), k.float(), v.float(), **args)
    split, _ = _flash_recipe(q, k, v, **args)
    rounded, _ = _flash_recipe(q, k, v, split_p=False, **args)
    assert _share(split, o_ref) <= 1
    assert _share(rounded, o_ref) > 1


# -- flash backward -------------------------------------------------------------

def _split(x, split=True):
    """An f32 operand as the kernels feed it to a bf16 product: hi + lo,
    or bf16 alone (the control)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _grad_scores(s, dp, l2, dl, keep, sm_scale, cap):
    """P (exactly 0 where masked) and dS = P (dP - delta) [* (1 - tanh^2)]
    from the f32 scores s and dP, in log2 units as the kernels compute
    them; l2 is lse in log2 units."""
    th = None
    if cap is None:
        x = s * (sm_scale * LOG2E)
    else:
        th = torch.tanh(s * (sm_scale / cap))
        x = (cap * LOG2E) * th
    p = torch.where(keep, torch.exp2(x - l2), torch.zeros_like(x))
    ds = p * (dp - dl)
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, ds


def _bwd_tiles(d):
    """(rows a block owns in dQ, in dK/dV; rows of a streamed tile)."""
    return 128, 64, (32 if d >= 192 else 64)


def _dq_recipe(q, k, v, do, lse, delta, *, causal, sm_scale,
               sliding_window=None, logit_soft_cap=None, split=True):
    """The dQ kernel's recipe: blocks of 128 query rows walk the key tiles
    of their band (``k_range``); dQ += dS K with dS split; bf16 out."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bm, _, bn = _bwd_tiles(d)
    kx, vx = (t.repeat_interleave(hq // hkv, 1).float() for t in (k, v))
    qf, dof = q.float(), do.float()
    dq = torch.zeros(q.shape, dtype=torch.bfloat16)
    n_k = -(-sk // bn)
    for q0 in range(0, sq, bm):
        rows = torch.arange(q0, min(q0 + bm, sq))
        kt0, kt1 = 0, n_k
        lo, hi = torch.zeros_like(rows), torch.full_like(rows, sk - 1)
        if causal:
            kt1 = min(n_k, int(rows[-1]) // bn + 1)
            hi = torch.clamp(rows, max=sk - 1)
            if sliding_window is not None:
                lo = rows - sliding_window + 1
                if q0 - sliding_window + 1 > 0:
                    kt0 = (q0 - sliding_window + 1) // bn
        l2 = (lse[:, :, rows] * LOG2E)[..., None]
        dl = delta[:, :, rows][..., None]
        acc = torch.zeros((b, hq, len(rows), d))
        for kt in range(kt0, kt1):
            keys = torch.arange(kt * bn, min(kt * bn + bn, sk))
            keep = (keys[None] >= lo[:, None]) & (keys[None] <= hi[:, None])
            kt_, vt = kx[:, :, keys], vx[:, :, keys]
            s = qf[:, :, rows] @ kt_.transpose(-1, -2)
            dp = dof[:, :, rows] @ vt.transpose(-1, -2)
            _, ds = _grad_scores(s, dp, l2, dl, keep, sm_scale,
                                 logit_soft_cap)
            acc += _split(ds, split) @ kt_
        dq[:, :, rows] = (acc * sm_scale).bfloat16()
    return dq


def _dkv_recipe(q, k, v, do, lse, delta, *, causal, sm_scale,
                sliding_window=None, logit_soft_cap=None, split=True):
    """The dK/dV kernel's recipe: blocks of 64 key rows walk the group's q
    heads x the q tiles that see them (``q_range``) in the transposed
    forms; dV += P^T dO and dK += dS^T Q with P and dS split; bf16 out."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    _, bmk, bn = _bwd_tiles(d)
    kf, vf, qf, dof = (t.float() for t in (k, v, q, do))
    dk = torch.zeros(k.shape, dtype=torch.bfloat16)
    dv = torch.zeros(v.shape, dtype=torch.bfloat16)
    n_q = -(-sq // bn)
    for k0 in range(0, sk, bmk):
        keys = torch.arange(k0, min(k0 + bmk, sk))
        qt0, qt1 = 0, n_q
        if causal:
            qt0 = min(n_q, k0 // bn)
            if sliding_window is not None:
                qt1 = min(n_q, (int(keys[-1]) + sliding_window - 1) // bn + 1)
        dk_acc = torch.zeros((b, hkv, len(keys), d))
        dv_acc = torch.zeros((b, hkv, len(keys), d))
        kt_, vt = kf[:, :, keys], vf[:, :, keys]
        for g in range(group):
            heads = torch.arange(hkv) * group + g
            for qt in range(qt0, qt1):
                qrows = torch.arange(qt * bn, min(qt * bn + bn, sq))
                keep = torch.ones((len(keys), len(qrows)), dtype=torch.bool)
                if causal:
                    gap = qrows[None] - keys[:, None]
                    keep = gap >= 0
                    if sliding_window is not None:
                        keep &= gap < sliding_window
                qg = qf[:, heads][:, :, qrows]
                dog = dof[:, heads][:, :, qrows]
                s_t = kt_ @ qg.transpose(-1, -2)
                dp_t = vt @ dog.transpose(-1, -2)
                l2 = (lse[:, heads][:, :, qrows] * LOG2E)[:, :, None]
                dl = delta[:, heads][:, :, qrows][:, :, None]
                p_t, ds_t = _grad_scores(s_t, dp_t, l2, dl, keep, sm_scale,
                                         logit_soft_cap)
                dv_acc += _split(p_t, split) @ dog
                dk_acc += _split(ds_t, split) @ qg
        dk[:, :, keys] = (dk_acc * sm_scale).bfloat16()
        dv[:, :, keys] = dv_acc.bfloat16()
    return dk, dv


def _bwd_case(name, seed=0):
    """bf16 q, k, v, dO and the f32 lse and delta the kernels take: lse
    from the plain forward, delta = rowsum(dO o) of its bf16 o."""
    q, k, v = _flash_inputs(name, seed)
    causal, window, cap = FLASH[name][6:]
    args = dict(causal=causal, sm_scale=q.shape[3] ** -0.5,
                sliding_window=window, logit_soft_cap=cap)
    rng = np.random.default_rng(100 + seed + sorted(FLASH).index(name))
    do, = _bf16(rng.normal(size=tuple(q.shape)).astype(np.float32))
    o, lse = _flash_fwd_plain(q.float(), k.float(), v.float(), **args)
    delta = (do.float() * o.bfloat16().float()).sum(-1)
    return q, k, v, do, lse, delta, args


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_backward_recipe_matches_plain_within_chip_tolerance(name):
    q, k, v, do, lse, delta, args = _bwd_case(name)
    f32 = [t.float() for t in (q, k, v, do)]
    dq = _dq_recipe(q, k, v, do, lse, delta, **args)
    dk, dv = _dkv_recipe(q, k, v, do, lse, delta, **args)
    dk_ref, dv_ref = _flash_dkv_plain(*f32, lse, delta, **args)
    assert _share(dq, _flash_dq_plain(*f32, lse, delta, **args)) <= 1
    assert _share(dk, dk_ref) <= 1
    assert _share(dv, dv_ref) <= 1
    for t in (dq, dk, dv):
        assert torch.isfinite(t.float()).all()


def test_flash_backward_recipe_rows_that_see_no_key_give_no_gradient():
    q, k, v, do, lse, delta, args = _bwd_case("sq_gt_sk_window")
    dq = _dq_recipe(q, k, v, do, lse, delta, **args)
    # rows 47.. see keys >= row - 7 >= 40 = Sk: none
    assert torch.all(lse[:, :, 47:] == NEG_INF)
    assert torch.all(dq[:, :, 47:].float() == 0)
    assert torch.any(dq[:, :, :47].float() != 0)


def test_flash_backward_recipe_with_bf16_ds_falls_outside_the_tolerance():
    """The control: dS (and P) rounded to bf16 alone before the products
    that accumulate dQ, dK and dV miss the check the split recipe passes
    on the same inputs."""
    rng = np.random.default_rng(4)
    q, k, v, do = _bf16(*(rng.normal(size=(1, 4, 512, 64)).astype(np.float32)
                          for _ in range(4)))
    args = dict(causal=True, sm_scale=0.125)
    f32 = [t.float() for t in (q, k, v, do)]
    o, lse = _flash_fwd_plain(*f32[:3], **args)
    delta = (do.float() * o.bfloat16().float()).sum(-1)
    dq_ref = _flash_dq_plain(*f32, lse, delta, **args)
    dk_ref, dv_ref = _flash_dkv_plain(*f32, lse, delta, **args)
    shares = {}
    for split in (True, False):
        dq = _dq_recipe(q, k, v, do, lse, delta, split=split, **args)
        dk, dv = _dkv_recipe(q, k, v, do, lse, delta, split=split, **args)
        shares[split] = (_share(dq, dq_ref), _share(dk, dk_ref),
                         _share(dv, dv_ref))
    assert max(shares[True]) <= 1
    assert min(shares[False]) > 1, shares


def test_flash_backward_recipe_matches_the_jax_pallas_kernels():
    """The recipe on bf16-valued numpy inputs against the JAX package's
    ``_flash_bwd_pallas`` in interpret mode on the same values, fed the
    Pallas forward's own o and lse."""
    rng = np.random.default_rng(11)
    b, hq, hkv, s, d = 1, 4, 2, 256, 64
    q, do = (rng.normal(size=(b, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    q, k, v, do = (np.asarray(x.float()) for x in _bf16(q, k, v, do))
    scale = d ** -0.5
    jo, jlse = _flash_fwd_pallas(q, k, v, True, scale, 128, 128,
                                 interpret=True, window=100, soft_cap=20.0)
    jdq, jdk, jdv = _flash_bwd_pallas(q, k, v, jo, jlse, do, True, scale,
                                      128, 128, interpret=True, window=100,
                                      soft_cap=20.0)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.from_numpy(np.array(jlse)[..., 0])
    delta = (tdo * torch.from_numpy(np.array(jo))).sum(-1)
    args = dict(causal=True, sm_scale=scale, sliding_window=100,
                logit_soft_cap=20.0)
    dq = _dq_recipe(tq, tk, tv, tdo, lse, delta, **args)
    dk, dv = _dkv_recipe(tq, tk, tv, tdo, lse, delta, **args)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert _share(got, torch.from_numpy(np.array(want))) <= 1


# -- paged multi-token attention ------------------------------------------------

def _paged_inputs(seed, b, kq, hq, hkv, d, t, cols, lengths):
    """Pages in random order; table entries past ceil(len/T) name garbage
    pages of +-3e4 that the recipe, like the kernel, never reads."""
    rng = np.random.default_rng(seed)
    live = [-(-n // t) for n in lengths]
    n_pages = sum(live) + 4
    perm = rng.permutation(n_pages)
    table = np.zeros((b, cols), np.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[np.arange(cols - live[i]) % 4]
    k = rng.normal(size=(n_pages, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, t, hkv, d)).astype(np.float32)
    k[garbage], v[garbage] = 3e4, -3e4
    q = rng.normal(size=(b, kq, hq, d)).astype(np.float32)
    return (q, k, v, table, np.asarray(lengths, np.int32))


PAGED = {
    # name: (B, K, Hq, Hkv, D, T, cols, lengths, soft cap, window)
    "decode_k1": (8, 1, 8, 2, 64, 16, 40, [1, 17, 70, 129, 300, 450, 511,
                                           640], None, None),
    "speculative_k4": (4, 4, 8, 2, 128, 16, 24, [4, 40, 200, 384], None,
                       None),
    "chunk_k100": (1, 100, 8, 2, 64, 16, 16, [100 + 37], None, None),
    "ragged_chunk_k20": (3, 20, 8, 2, 64, 8, 24, [20, 77, 190], None, None),
    "window": (3, 5, 8, 2, 64, 16, 32, [5, 300, 500], None, 70),
    "soft_cap": (3, 5, 8, 2, 64, 16, 16, [9, 120, 250], 5.0, None),
    "group1": (2, 3, 4, 4, 128, 16, 16, [3, 200], None, None),
    "d256": (2, 2, 4, 2, 256, 8, 16, [2, 100], None, None),
}


@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_recipe_matches_plain_within_chip_tolerance(name):
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = PAGED[name]
    q, k, v, table, lens = _paged_inputs(sorted(PAGED).index(name), b, kq,
                                         hq, hkv, d, t, cols, lengths)
    q, k, v = _bf16(q, k, v)
    table, lens = torch.from_numpy(table), torch.from_numpy(lens)
    args = dict(sm_scale=d ** -0.5, logit_soft_cap=cap,
                sliding_window=window)
    out = _paged_recipe(q, k, v, table, lens, **args)
    ref = _paged_attention_multi_plain(q.float(), k.float(), v.float(),
                                       table, lens, **args)
    assert _share(out, ref) <= 1
    assert torch.isfinite(out.float()).all()


def test_paged_decode_recipe_splits_and_matches_the_one_pass_walk():
    """Decode's small grid takes split-KV; the merged splits agree with the
    same recipe in one pass (a grid as full as the card)."""
    b, kq, hq, hkv, d, t, cols, lengths, _, _ = PAGED["decode_k1"]
    assert _split_plan(b, kq, hq // hkv, hkv, cols, H100_SMS)[0] > 1
    q, k, v, table, lens = _paged_inputs(1, b, kq, hq, hkv, d, t, cols,
                                         lengths)
    q, k, v = _bf16(q, k, v)
    table, lens = torch.from_numpy(table), torch.from_numpy(lens)
    split = _paged_recipe(q, k, v, table, lens, sm_scale=0.125)
    whole = _paged_recipe(q, k, v, table, lens, sm_scale=0.125, sms=1)
    torch.testing.assert_close(split.float(), whole.float(), atol=ATOL,
                               rtol=RTOL)


def test_paged_recipe_matches_the_jax_reference_on_the_same_inputs():
    """The recipe on bf16-valued numpy inputs against the JAX package's
    own ``paged_attention_multi`` (its XLA reference) on the same values."""
    b, kq, hq, hkv, d, t, cols = 3, 6, 8, 2, 128, 8, 12
    q, k, v, table, lens = _paged_inputs(5, b, kq, hq, hkv, d, t, cols,
                                         [6, 40, 90])
    q, k, v = (np.asarray(x.float()) for x in _bf16(q, k, v))
    ref = jax_paged_attention_multi(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), use_pallas=False, logit_soft_cap=30.0,
        sliding_window=50)
    out = _paged_recipe(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(table),
                        torch.from_numpy(lens), sm_scale=d ** -0.5,
                        logit_soft_cap=30.0, sliding_window=50)
    assert _share(out, torch.from_numpy(np.array(ref))) <= 1


def test_paged_recipe_with_bf16_p_falls_outside_the_tolerance():
    b, kq, hq, hkv, d, t, cols = 1, 256, 8, 2, 64, 16, 24
    q, k, v, table, lens = _paged_inputs(9, b, kq, hq, hkv, d, t, cols,
                                         [256 + 100])
    q, k, v = _bf16(q, k, v)
    table, lens = torch.from_numpy(table), torch.from_numpy(lens)
    ref = _paged_attention_multi_plain(q.float(), k.float(), v.float(),
                                       table, lens, sm_scale=0.125)
    split = _paged_recipe(q, k, v, table, lens, sm_scale=0.125)
    rounded = _paged_recipe(q, k, v, table, lens, sm_scale=0.125,
                            split_p=False)
    assert _share(split, ref) <= 1
    assert _share(rounded, ref) > 1


# -- the split plan -------------------------------------------------------------

def test_split_plan_splits_small_grids_only():
    # decode at 8B shapes: 8 sequences x 8 kv heads x 1 row tile
    splits, per = _split_plan(8, 1, 4, 8, 128, H100_SMS)
    assert splits > 1 and 8 * 8 * splits >= 2 * H100_SMS
    assert splits * per >= 128 > (splits - 1) * per
    # a 1024-token chunk: 32 two-warpgroup row tiles x 8 kv heads
    assert _split_plan(1, 1024, 4, 8, 64, H100_SMS) == (1, 64)
    # a batch that fills the card takes one pass
    assert _split_plan(64, 1, 4, 8, 128, H100_SMS)[0] == 1


@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 1, 40, 333])
@pytest.mark.parametrize("kq,group", [(1, 4), (4, 4), (37, 2)])
def test_split_ranges_cover_exactly_the_pages_the_rows_see(t, window, kq,
                                                          group):
    n_rows = kq * group
    bm = 64 * _warpgroups(n_rows)
    for length in (kq, kq + 1, kq + 63, 517, 2048):
        live = -(-length // t)
        for per in (1, 3, 26):
            for row0 in range(0, n_rows, bm):
                last = min(row0 + bm, n_rows) - 1
                ranges = _split_ranges(length, row0, last, kq, group, t,
                                       window, per, live)
                oldest = length - kq + row0 // group
                newest = length - kq + last // group
                first_page = 0
                if window is not None:
                    first_page = max(0, oldest - window + 1) // t
                want = set(range(first_page, newest // t + 1))
                got = [p for p0, p1 in ranges for p in range(p0, p1)]
                assert all(p1 > p0 and p1 - p0 <= per for p0, p1 in ranges)
                assert got == sorted(want)               # exactly, once each
                assert all(p < live for p in got)        # never past ceil(len/T)
                assert all(p >= first_page for p in got)  # none behind the window
                # every page the rows see is one of them
                seen = {pos // t for r in range(row0, last + 1)
                        for pos in range(length - kq + r // group + 1)
                        if window is None
                        or pos > length - kq + r // group - window}
                assert seen <= want


@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("kq,group", [(1, 4), (37, 2)])
def test_split_ranges_stay_inside_the_table(t, kq, group):
    """Lengths past the table's ``cols * T`` positions: no split reads a
    column at or past the table's width, and the splits still cover
    exactly the table's pages that the rows see (those past it are
    absent, as in the reference)."""
    n_rows = kq * group
    bm = 64 * _warpgroups(n_rows)
    for cols in (1, 5, 24):
        for length in (cols * t + 1, cols * t + kq + 9, 3 * cols * t):
            for window in (None, 40):
                for per in (1, 4, 26):
                    for row0 in range(0, n_rows, bm):
                        last = min(row0 + bm, n_rows) - 1
                        ranges = _split_ranges(length, row0, last, kq, group,
                                               t, window, per, cols)
                        got = [p for p0, p1 in ranges
                               for p in range(p0, p1)]
                        assert all(p1 > p0 for p0, p1 in ranges)
                        assert all(p1 <= cols for _, p1 in ranges)
                        oldest = length - kq + row0 // group
                        newest = length - kq + last // group
                        first = 0 if window is None else \
                            max(0, oldest - window + 1) // t
                        assert got == list(range(first,
                                                 min(newest // t + 1, cols)))


def test_paged_recipe_past_the_table_matches_plain():
    """Lengths beyond the table (``cols * T`` < length): the recipe reads
    the table's pages and no further, and agrees with the plain version,
    whose gathered view holds only those positions."""
    b, kq, hq, hkv, d, t, cols = 2, 3, 8, 2, 64, 16, 4
    q, k, v, table, lens = _paged_inputs(13, b, kq, hq, hkv, d, t, cols,
                                         [cols * t, cols * t])
    lens = np.asarray([cols * t + 5, 3 * cols * t], np.int32)
    q, k, v = _bf16(q, k, v)
    table, lens = torch.from_numpy(table), torch.from_numpy(lens)
    ref = _paged_attention_multi_plain(q.float(), k.float(), v.float(),
                                       table, lens, sm_scale=0.125)
    out = _paged_recipe(q, k, v, table, lens, sm_scale=0.125)
    assert _share(out, ref) <= 1
