"""The tensor-core recipe of the int8-page paged attention kernel, emulated
in plain PyTorch on the CPU, against the port's plain version and the JAX
package's kernel.

``csrc/paged_attention_multi_quant.cu`` runs the bf16 paged kernel's tiles
over int8 pages with per-(position, kv head) f32 scales, keeping the int8
bytes and the arithmetic exact. A CUDA kernel cannot run here, so this
file runs its arithmetic step by step:

- blocks of (sequence, kv head, 64 or 128 query rows), the pages of each
  split of the wrapper's own ``_split_plan`` and ``_split_ranges``, 64-key
  tiles (32 at D = 256) from each split's first page, keys (and their
  scales) zero past the split's end;
- the integer keys and values as bf16 (exact): S = q k_int^T as f32 sums of
  exact products, each key's column times its k-scale in f32, then the
  softmax scale, the soft cap and the mask, online softmax in log2 units;
- P (its row sums unscaled) times each key's v-scale, split into bf16
  hi + lo, O += hi v_int + lo v_int in f32; the splits merged by their
  maxima.

Each result is held per element to ``chip_smoke.py``'s tolerance, 1e-4 +
1e-2 |plain| on the bf16 output, against ``_paged_attention_multi_quant_plain``
on pages the port's ``_kv_quant`` made, and against the JAX
``paged_attention_multi_quant`` (its XLA reference and its Pallas kernel in
interpret mode) on the same numpy inputs. Broken variants must fall
outside it; at the 256-token chunk of the variant tests below, where the
recipe reads 0.38 of the tolerance, P * v_scale rounded to bf16 alone
reads 8.7x and each key's scales taken from the neighbouring kv head (the
stride-Hkv indexing the kernel's scale staging introduces) 6,108x. A
third variant, K and V dequantized into bf16 before the products (int8 *
scale rounded to bf16: the tempting design, the bf16 tile body as it is
with no scale passes), reads 11.9x there: each key and value element
then carries a bf16 rounding of up to 2^-9 that the reference's f32
dequantization does not, so the kernel, not the quantizer, would set the
int8 arena's error. The integer widen itself
(two int8 bytes to a bf16 pair by integer ops and one bf16x2 subtract) is
checked bit for bit over every byte, and its shared-memory stores for bank
conflicts.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.attention import \
    paged_attention_multi_quant as jax_paged_attention_multi_quant
from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _paged_attention_multi_quant_plain, _split_plan, _split_ranges,
    _warpgroups)

ATOL, RTOL = 1e-4, 1e-2            # chip_smoke.py: bf16 output vs f32 plain
LOG2E = 1.4426950408889634
NEG_INF = -1e30
H100_SMS = 132


def _share(out, ref) -> float:
    """Largest share of the per-element tolerance (above 1 fails)."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (ATOL + RTOL * ref.abs()))
                 .max())


# -- the recipe -----------------------------------------------------------------

def _tiles(q_rows, keys, vals, k_s, v_s, key_pos, lo, hi, scale, cap, tile,
           variant):
    """One warpgroup's walk: bf16 rows q_rows (R, D) against integer keys
    and values (n, D) with their scales (n,) at positions key_pos (n,);
    row r sees lo[r] <= pos <= hi[r]. Returns the unnormalised f32
    accumulator (R, D), the running max (R,) in log2 units and the running
    sum (R,)."""
    r, d = q_rows.shape
    o = torch.zeros((r, d))
    m = torch.full((r,), NEG_INF)
    l = torch.zeros((r,))
    qf = q_rows.float()
    for t0 in range(0, keys.shape[0], tile):
        kt, vt = keys[t0:t0 + tile], vals[t0:t0 + tile]
        ks, vs = k_s[t0:t0 + tile], v_s[t0:t0 + tile]
        pos = key_pos[t0:t0 + tile]
        if variant == "dequant_bf16":
            # int8 * scale rounded to bf16 before the products
            s = qf @ (kt * ks[:, None]).bfloat16().float().T
            vt = (vt * vs[:, None]).bfloat16().float()
        else:
            s = (qf @ kt.T) * ks[None]         # exact products, then scales
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
        if variant != "dequant_bf16":
            p = p * vs[None]                       # P meets the integer V
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if variant != "bf16_p":
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        o = o * corr[:, None] + pv
        m = m_new
    return o, m, l


def _int8_paged_recipe(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       lengths, *, sm_scale, logit_soft_cap=None,
                       sliding_window=None, variant=None, sms=H100_SMS):
    """The kernel's recipe over every (sequence, row tile, kv head, split)
    of the wrapper's split plan, the splits merged by their maxima; bf16
    output. ``variant``: None (the kernel), "bf16_p" (P * v_scale in bf16
    alone), "wrong_head" (each key's scales from kv head h + 1), or
    "dequant_bf16" (K and V dequantized into bf16 before the products)."""
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
                hs = (h + 1) % hkv if variant == "wrong_head" else h
                parts = []
                for p0, p1 in ranges:
                    # the split's keys, then zero rows and scales up to a
                    # whole tile, as the kernel's cp.async zero-fill leaves
                    # them; each row's last key is clamped to the split's end
                    end = min(p1 * t, newest + 1)
                    n = -(-(end - p0 * t) // bn) * bn
                    pos = torch.arange(p0 * t, p0 * t + n)
                    live = pos < end
                    page = page_table[bi, pos[live] // t].long()
                    slot = pos[live] % t
                    keys, vals = torch.zeros((n, d)), torch.zeros((n, d))
                    k_s, v_s = torch.zeros(n), torch.zeros(n)
                    keys[live] = k_pages[page, slot, h].float()
                    vals[live] = v_pages[page, slot, h].float()
                    k_s[live] = k_scale[page, slot, hs]
                    v_s[live] = v_scale[page, slot, hs]
                    parts.append(_tiles(q[bi, j, h * group + g], keys, vals,
                                        k_s, v_s, pos, lo,
                                        qpos.clamp(max=end - 1), sm_scale,
                                        logit_soft_cap, bn, variant))
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


# -- inputs ---------------------------------------------------------------------

def _paged_inputs(seed, b, kq, hq, hkv, d, t, cols, lengths):
    """bf16-valued q and int8 pages (with their scales) that the port's
    ``_kv_quant`` made from normal K/V, pages in random order; table
    entries past ceil(len/T) name garbage pages of +-3e4 that the recipe,
    like the kernel, never reads. Returns torch tensors."""
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
    (kp, ks), (vp, vs) = (_kv_quant(torch.from_numpy(x).bfloat16())
                          for x in (k, v))
    return (torch.from_numpy(q).bfloat16(), kp, vp, ks, vs,
            torch.from_numpy(table), torch.from_numpy(
                np.asarray(lengths, np.int32)))


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


def _case(name, seed=None):
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = PAGED[name]
    inputs = _paged_inputs(sorted(PAGED).index(name) if seed is None
                           else seed, b, kq, hq, hkv, d, t, cols, lengths)
    args = dict(sm_scale=d ** -0.5, logit_soft_cap=cap,
                sliding_window=window)
    return inputs, args


# -- the recipe against the plain version and the JAX package -------------------

@pytest.mark.parametrize("name", sorted(PAGED))
def test_int8_recipe_matches_plain_within_chip_tolerance(name):
    inputs, args = _case(name)
    out = _int8_paged_recipe(*inputs, **args)
    ref = _paged_attention_multi_quant_plain(inputs[0].float(), *inputs[1:],
                                             **args)
    assert torch.isfinite(out.float()).all()
    assert _share(out, ref) <= 1


def test_int8_decode_recipe_splits_and_matches_the_one_pass_walk():
    """Decode's small grid takes split-KV; the merged splits agree with the
    same recipe in one pass (a grid as full as the card)."""
    b, kq, hq, hkv, _, _, cols, _, _, _ = PAGED["decode_k1"]
    assert _split_plan(b, kq, hq // hkv, hkv, cols, H100_SMS)[0] > 1
    inputs, args = _case("decode_k1", seed=1)
    split = _int8_paged_recipe(*inputs, **args)
    whole = _int8_paged_recipe(*inputs, **args, sms=1)
    torch.testing.assert_close(split.float(), whole.float(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas"])
def test_int8_recipe_matches_the_jax_package_on_the_same_inputs(interpret):
    """The recipe on bf16-valued q and the same int8 pages and scales
    against the JAX ``paged_attention_multi_quant``: its XLA reference, and
    its Pallas kernel in interpret mode (D = 128 and T a multiple of 8, the
    shapes it takes), as the JAX package's own tests run them."""
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        5, 2, 3, 8, 2, 128, 8, 6, [3, 41])
    args = dict(logit_soft_cap=30.0, sliding_window=20)
    ref = jax_paged_attention_multi_quant(
        jnp.asarray(q.float().numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vs.numpy()), jnp.asarray(table.numpy()),
        jnp.asarray(lens.numpy()), use_pallas=None if interpret else False,
        interpret=interpret, **args)
    out = _int8_paged_recipe(q, kp, vp, ks, vs, table, lens,
                             sm_scale=128 ** -0.5, **args)
    assert _share(out, torch.from_numpy(np.array(ref))) <= 1


# -- broken variants ------------------------------------------------------------

@pytest.mark.parametrize("variant", ["bf16_p", "wrong_head"])
def test_int8_recipe_broken_variants_fall_outside_the_tolerance(variant):
    """At a 256-token chunk behind 100 positions: the recipe passes, P *
    v_scale in bf16 alone and each key's scales from the neighbouring kv
    head do not."""
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        9, 1, 256, 8, 2, 64, 16, 24, [256 + 100])
    args = dict(sm_scale=0.125)
    ref = _paged_attention_multi_quant_plain(q.float(), kp, vp, ks, vs,
                                             table, lens, **args)
    good = _int8_paged_recipe(q, kp, vp, ks, vs, table, lens, **args)
    bad = _int8_paged_recipe(q, kp, vp, ks, vs, table, lens, **args,
                             variant=variant)
    assert _share(good, ref) <= 1
    assert _share(bad, ref) > 1


def test_int8_dequantized_into_bf16_misses_the_tolerance():
    """The design not taken: K and V dequantized into bf16 before the
    products (the module docstring records its share)."""
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        9, 1, 256, 8, 2, 64, 16, 24, [256 + 100])
    ref = _paged_attention_multi_quant_plain(q.float(), kp, vp, ks, vs,
                                             table, lens, sm_scale=0.125)
    bad = _int8_paged_recipe(q, kp, vp, ks, vs, table, lens, sm_scale=0.125,
                             variant="dequant_bf16")
    assert _share(bad, ref) > 1


# -- the integer widen ----------------------------------------------------------

def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _i8_bf16(w: int, half: int) -> tuple[float, float]:
    """i8_bf16: bytes 2 half and 2 half + 1 of w into bits 0-7 and 16-23
    (__byte_perm with 0x4140 or 0x4342), then (a & 0x7F | 0x4300) less
    (a & 0x80 | 0x4300), each half read as bf16; the f32 difference of
    two bf16 values, rounded to bf16 as the bf16x2 subtract does."""
    sel = 0x4342 if half else 0x4140
    src = [(w >> (8 * i)) & 0xFF for i in range(4)] + [0] * 4
    a = sum(src[(sel >> (4 * i)) & 0xF] << (8 * i) for i in range(4))
    y = (a & 0x007F007F) | 0x43004300
    z = (a & 0x00800080) | 0x43004300
    halves = np.array([[y & 0xFFFF, y >> 16], [z & 0xFFFF, z >> 16]])
    diff = _bf16_value(halves[0]) - _bf16_value(halves[1])
    rounded = torch.from_numpy(diff).bfloat16().float().numpy()
    assert np.array_equal(rounded, diff)       # the subtract is exact
    return float(diff[0]), float(diff[1])


def test_widen_gives_every_int8_pair_exactly_in_order():
    """Every byte value, in both positions of both halves of a word: the
    bf16 pair is the two int8 values, exact, lower address first."""
    vals = np.arange(-128, 128)
    for b0 in vals:
        for pos in range(4):
            other = int(vals[(b0 * 7 + pos) % 256])
            bytes_ = [other] * 4
            bytes_[pos] = int(b0)
            w = sum((x & 0xFF) << (8 * i) for i, x in enumerate(bytes_))
            assert _i8_bf16(w, pos // 2)[pos % 2] == b0
            assert _i8_bf16(w, pos // 2)[1 - pos % 2] == other


def _swz(rows: int, r: int, chunk: int) -> int:
    """tile90::swz: byte offset of 16-byte chunk `chunk` of row r."""
    return (chunk >> 3) * rows * 128 + r * 128 + (((chunk & 7) ^ (r & 7))
                                                  << 4)


@pytest.mark.parametrize("d,bn,threads", [(64, 64, 128), (128, 64, 128),
                                          (128, 64, 256), (256, 32, 256)])
def test_widen_stores_cover_the_tile_once_without_bank_conflicts(d, bn,
                                                                 threads):
    """The widen's two 16-byte stores of raw chunk c of row r (bf16 chunks
    2c and 2c + 1, the second first where c & 4): every chunk of the
    swizzled tile written exactly once, and each store instruction's
    quarter warp (8 threads) on 8 distinct 16-byte bank groups."""
    ch = d // 16
    written = []
    for i in range(bn * ch // threads):
        for first_store in (True, False):
            slots = []
            for tid in range(threads):
                idx = tid + i * threads
                r, c = idx // ch, idx % ch
                swap = bool(c & 4)
                chunk = 2 * c + (swap if first_store else not swap)
                off = _swz(bn, r, chunk)
                written.append(off)
                slots.append((off % 128) // 16)
            for q0 in range(0, threads, 8):
                assert len(set(slots[q0:q0 + 8])) == 8
    assert sorted(written) == list(range(0, bn * d * 2, 16))
