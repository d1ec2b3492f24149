"""The Hopper ``int4_expert_matmul`` design, emulated in plain PyTorch on
the CPU, against the port's plain version and the JAX package.

``csrc/int4_expert_matmul.cu`` runs every expert's y^T = W^T h^T as wgmma
m64nNRk16 products on a persistent grid: each block walks the live units
(expert, column tile, row tile) that the device counts leave, in steps
staged by TMA (h zero past a group's end), the step's products summed in
f32 per group and scaled into a running f32 sum at the group's end. The
short tile (16 rows, buffers up to 64 rows) splits a unit's groups in two
halves, one consumer warpgroup each, in steps of 128 in-elements, and adds
the second half's sums to the first's at the unit's end; the tall tile (64
rows) walks every group in steps of 64. The sum is cast to bf16 once; the
producer warpgroup's spare warps write the zeros of every row past a
count. A CUDA kernel cannot run here, so this
file runs that walk and that arithmetic step by step, and the kernel's
integer tricks bit by bit: the byte -> bf16x2 unpack of a 32-bit word, the
fragment -> output column map, the swizzled reads' banks.

Results are held per element to ``chip_smoke.py``'s tolerance, 1e-4 +
1e-2 |plain| on the bf16 output, against ``_int4_expert_matmul_plain`` in
f32, and to one bf16 ulp against the JAX ``int4_expert_matmul``'s Pallas
kernel in interpret mode, run per expert (both round an f32 sum once, in
another order). The routing's positions and counts must equal the JAX
``moe_mlp``'s integers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.ops import int4_matmul as jint4
from k8s_runpod_kubelet_tpu_torch.models.moe import (dispatch_positions,
                                                     moe_capacity)
from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import \
    _int4_expert_matmul_plain

ATOL, RTOL = 1e-4, 1e-2            # chip_smoke.py: bf16 output vs f32 plain
K16 = 16                           # the wgmma's reduced depth
WN = 128                           # columns a consumer warpgroup owns
SMALL_ROWS = 64                    # buffers up to this take 16-row tiles


def _tile(rows):
    """(tile rows NR, consumer warpgroups on the columns CW, group halves
    KSPLIT, in-elements a step KS) for C rows an expert."""
    return (16, 1, 2, 128) if rows <= SMALL_ROWS else (64, 2, 1, 64)


def _share(out, ref) -> float:
    ref = ref.float()
    return float(((out.float() - ref).abs() / (ATOL + RTOL * ref.abs()))
                 .max())


# -- the unpack: one 32-bit word to four A fragment registers -----------------

def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (s >> 4n) & 7 of y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _bf16_bits(v: float) -> int:
    return int(torch.tensor([v]).bfloat16().view(torch.int16)[0]) & 0xFFFF


def _bf16_value(bits: int) -> float:
    return float(torch.tensor([bits << 16], dtype=torch.int32)
                 .view(torch.float32)[0])


def _unpack4(w: int) -> list[int]:
    """unpack4 of the kernel: a shift and three masks, one prmt a register,
    then each bf16 half less 136 (exact, so the bf16x2 subtract's rounding
    never acts): the four registers' bits."""
    hi = (w >> 4) & 0x0F0F0F0F
    a = (w & 0x00000F0F) | 0x43430000
    b = (w & 0x0F0F0000) | 0x00004343
    regs = [_byte_perm(a, hi, 0x3430), _byte_perm(a, hi, 0x3531),
            _byte_perm(b, hi, 0x0602), _byte_perm(b, hi, 0x0703)]
    out = []
    for r in regs:
        lo_v = _bf16_value(r & 0xFFFF) - 136.0
        hi_v = _bf16_value(r >> 16) - 136.0
        out.append(_bf16_bits(lo_v) | (_bf16_bits(hi_v) << 16))
    return out


@pytest.mark.parametrize("j", range(4))
def test_unpack_gives_every_byte_value_its_nibbles_less_8_bit_for_bit(j):
    """Every byte value at every position of the word: register j's bits
    are the bf16 pair (low nibble - 8, high nibble - 8), the (2i, 2i + 1)
    fragment pair of its M row; the other three bytes do not leak in."""
    rng = np.random.default_rng(j)
    for byte in range(256):
        others = rng.integers(0, 256, size=4)
        w = sum(int(others[n]) << (8 * n) for n in range(4) if n != j) \
            | (byte << (8 * j))
        regs = _unpack4(w)
        for n in range(4):
            bn = (w >> (8 * n)) & 0xFF
            want = _bf16_bits((bn & 0xF) - 8.0) \
                | (_bf16_bits((bn >> 4) - 8.0) << 16)
            assert regs[n] == want, (j, byte, n)


# -- the fragment -> output column map and the swizzled reads --------------

def _columns(w: int, g8: int) -> int:
    """The first of a thread's four columns within its warpgroup's 128."""
    chunk = 4 * (g8 >> 2) + w
    return 4 * (4 * chunk + (g8 & 3))


def test_fragment_rows_cover_each_column_of_a_tile_once():
    """Thread (warp w, lane g8, t4) holds M rows g8 and g8 + 8 of warp w in
    both m64 tiles; tile T's row i is column cb + 2T + i. Over a
    warpgroup every one of the 128 columns is one (tile, M row), held by
    the four threads of a quad (which hold different rows of h)."""
    owner = {}
    for w in range(4):
        for g8 in range(8):
            cb = _columns(w, g8)
            for t in range(2):
                for i in range(2):
                    m = 16 * w + g8 + 8 * i
                    col = cb + 2 * t + i
                    assert col not in owner, col
                    owner[col] = (t, m)
    assert sorted(owner) == list(range(WN))
    assert sorted(owner.values()) == [(t, m) for t in range(2)
                                      for m in range(64)]


def _swizzled_word(row: int, word: int) -> int:
    """Word index in shared memory of (row, word) of a 128-byte-row tile
    under TMA's 128-byte swizzle (16-byte chunk c of row r at c ^ r % 8)."""
    return row * 32 + (((word // 4) ^ (row % 8)) * 4) + word % 4


@pytest.mark.parametrize("mapped", [True, False])
def test_a_warps_32_bit_reads_hit_32_banks(mapped):
    """Each k16 half-slice: a warp reads four packed rows (t4) of its eight
    column words (g8). With the kernel's map they lie in 32 banks; words
    taken in order (word 8w + g8) collide under the swizzle."""
    for w in range(4):
        for kk in range(128 // 16):
            for half in range(2):
                banks = set()
                for lane in range(32):
                    g8, t4 = lane // 4, lane % 4
                    word = (_columns(w, g8) // 4 if mapped else 8 * w + g8)
                    row = 8 * kk + 4 * half + t4
                    banks.add(_swizzled_word(row, word) % 32)
                assert (len(banks) == 32) == mapped


# -- the persistent walk ----------------------------------------------------

def _live(counts, rows):
    return [min(max(int(c), 0), rows) for c in counts]


def _walk(counts, rows, out, blocks):
    """The kernel's walk: for each block the units it runs, in order, as
    (expert, row tile, column tile, live rows); and the rows the producer
    warpgroup's spare warps zero, as (expert, row)."""
    nr, cw = _tile(rows)[:2]
    col_tiles = -(-out // (cw * WN))
    live = _live(counts, rows)
    units = [(x, r, c, lv) for x, lv in enumerate(live)
             for c in range(col_tiles) for r in range(-(-lv // nr))]
    mine = [units[b::blocks] for b in range(blocks)]
    dead = [(x, row) for x, lv in enumerate(live) for row in range(lv, rows)]
    zeros = [dead[b::blocks] for b in range(blocks)]
    return mine, zeros


def _edge_counts(rows):
    nr = _tile(rows)[0]
    return [0, 1, nr - 1, nr, nr + 1, rows]


@pytest.mark.parametrize("rows", [8, 40, 300])
def test_walk_lists_every_live_unit_once_and_zeroes_the_rest(rows):
    """Counts of 0, 1, NR - 1, NR, NR + 1 and C (clipped to C): every row
    tile holding a filled row runs once, on one block, with every column
    tile; no unit starts past its count; the zeroed rows are exactly those
    past each count; row tiles of one column tile are adjacent units."""
    counts = [min(c, rows) for c in _edge_counts(rows)]
    nr = _tile(rows)[0]
    out = 400
    col_tiles = -(-out // (_tile(rows)[1] * WN))
    for blocks in (1, 3, 264):
        mine, zeros = _walk(counts, rows, out, blocks)
        seen = [u[:3] for b in mine for u in b]
        assert len(seen) == len(set(seen))
        want = {(x, r, c) for x, n in enumerate(counts)
                for r in range(-(-n // nr)) for c in range(col_tiles)}
        assert set(seen) == want
        assert all(r * nr < counts[x] for x, r, _ in seen)
        covered = {(x, r * nr + i) for x, r, _ in seen for i in range(nr)
                   if r * nr + i < counts[x]}
        assert covered == {(x, i) for x, n in enumerate(counts)
                           for i in range(n)}
        zeroed = [z for b in zeros for z in b]
        assert sorted(zeroed) == [(x, i) for x, n in enumerate(counts)
                                  for i in range(n, rows)]
    units = _walk(counts, rows, out, 1)[0][0]
    for a, b in zip(units, units[1:]):
        if a[0] == b[0] and a[2] == b[2]:
            assert b[1] == a[1] + 1


def test_walk_at_full_capacity_has_no_zero_rows_and_ragged_tiles_stay():
    """Without counts every row is live (the kernel's live rows are C);
    the last tile of C = 40 at NR = 16 holds 8 rows (the kernel stores
    rows below C only)."""
    mine, zeros = _walk([40, 40], 40, 128, 5)
    assert not [z for b in zeros for z in b]
    assert sorted(u[1] for b in mine for u in b if u[0] == 0) == [0, 1, 2]


# -- the recipe -------------------------------------------------------------

def _weights(q4):
    w = torch.empty((2 * q4.shape[0], q4.shape[1]))
    w[0::2] = ((q4 & 0xF).to(torch.int16) - 8).float()
    w[1::2] = ((q4 >> 4).to(torch.int16) - 8).float()
    return w


def _recipe(h, q4, scale, counts=None, fold_halves=False):
    """The kernel's arithmetic over its walk: every live unit sums each
    half of its groups in order (one half in the tall tile), each group's
    steps of KS in-elements (h zero past the group's end) as f32 sums of
    exact products over k16 slices, scaled into the half's running f32 sum
    at the group's end; the halves' sums are added first + second and the
    unit's filled rows cast to bf16 once; every other row is zero. The
    control ``fold_halves`` rounds each half's sum to bf16 before the add
    (the second half handed over in bf16)."""
    xn, rows, kin = h.shape
    out = q4.shape[2]
    g = scale.shape[1]
    gs = kin // g
    nr, cw, ksplit, ks = _tile(rows)
    steps = -(-gs // ks)
    gh = -(-g // ksplit)
    y = torch.full((xn, rows, out), float("nan"))
    mine, zeros = _walk(counts if counts is not None else [rows] * xn,
                        rows, out, 7)
    for units in mine:
        for x, r, c, lv in units:
            w = _weights(q4[x])
            cols = slice(c * cw * WN, min((c + 1) * cw * WN, out))
            hr = torch.zeros((nr, kin))
            take = h[x, r * nr:(r + 1) * nr].float()
            hr[:take.shape[0]] = take
            halves = []
            for half in range(ksplit):
                acc = torch.zeros((nr, w[:, cols].shape[1]))
                for gi in range(half * gh, min(g, (half + 1) * gh)):
                    part = torch.zeros_like(acc)
                    for s in range(steps):
                        k0 = gi * gs + s * ks
                        k1 = min(k0 + ks, (gi + 1) * gs)
                        for kk in range(k0, k1, K16):
                            part = part + hr[:, kk:kk + K16] \
                                @ w[kk:kk + K16, cols]
                    acc = acc + part * scale[x, gi, 0, cols]
                halves.append(acc.bfloat16().float() if fold_halves
                              else acc)
            acc = halves[0]
            for other in halves[1:]:
                acc = acc + other
            n = min(nr, lv - r * nr)
            y[x, r * nr:r * nr + n, cols] = acc[:n].bfloat16().float()
    for b in zeros:
        for x, row in b:
            y[x, row] = 0.0
    assert not torch.isnan(y).any()
    return y.bfloat16()


def _inputs(xn, rows, kin, out, seed):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.normal(size=(xn, kin, out))).astype(np.float32)
    leaves = [_quantize_leaf_int4(torch.from_numpy(w[x])) for x in range(xn)]
    h = torch.from_numpy(rng.normal(size=(xn, rows, kin))
                         .astype(np.float32)).bfloat16()
    return (h, torch.stack([lf["q4"] for lf in leaves]),
            torch.stack([lf["scale"] for lf in leaves]))


RECIPE_CASES = {
    # name: (experts, rows an expert, in, out, counts)
    "decode": (4, 8, 256, 128, [8, 0, 3, 5]),
    "verify_edges": (6, 40, 256, 256, [0, 1, 15, 16, 17, 40]),
    "prefill_edges": (6, 130, 384, 400, [0, 1, 63, 64, 65, 130]),
    "one_group_of_688": (2, 70, 688, 128, [70, 13]),
}


@pytest.mark.parametrize("name", sorted(RECIPE_CASES))
def test_recipe_matches_plain_within_chip_tolerance(name):
    xn, rows, kin, out, counts = RECIPE_CASES[name]
    h, q4, scale = _inputs(xn, rows, kin, out, seed=len(name))
    cnt = torch.tensor(counts, dtype=torch.int32)
    y = _recipe(h, q4, scale, cnt)
    ref = _int4_expert_matmul_plain(h.float(), q4, scale, cnt)
    assert _share(y, ref) <= 1
    past = torch.arange(rows)[None] >= cnt[:, None]
    assert not y[past].float().any()
    # the filled rows are the same bytes at full capacity
    full = _recipe(h, q4, scale)
    assert torch.equal(y[~past], full[~past])


def test_recipe_handing_the_second_half_over_in_bf16_misses():
    """The control: the short tile's second half handed to the first in
    bf16 rather than f32 rounds each half's sum (2^-9 of its magnitude),
    which the halves' cancellation lifts past the check the recipe passes
    on the same decode-shaped inputs."""
    h, q4, scale = _inputs(2, 8, 4096, 1024, seed=5)
    ref = _int4_expert_matmul_plain(h.float(), q4, scale)
    assert _share(_recipe(h, q4, scale), ref) <= 1
    assert _share(_recipe(h, q4, scale, fold_halves=True), ref) > 1


@pytest.mark.parametrize("rows,counts", [(8, [8, 2, 0]), (70, [70, 64, 1])])
def test_recipe_matches_the_jax_kernel_per_expert_in_interpret_mode(rows,
                                                                    counts):
    """Per expert, the JAX ``int4_expert_matmul``'s kernel (``_matmul_2d``
    in interpret mode, what its ``lax.map`` runs) on the buffer with the
    rows past the count zero, as the JAX dispatch leaves it: within one
    bf16 ulp on every row."""
    kin, out = 256, 256
    rng = np.random.default_rng(rows)
    w = (0.1 * rng.normal(size=(len(counts), kin, out))).astype(np.float32)
    leaf = jquant._quantize_leaf_int4(w)
    q4, scale = np.asarray(leaf["q4"]), np.asarray(leaf["scale"])
    h = rng.normal(size=(len(counts), rows, kin)).astype(np.float32)
    past = np.arange(rows)[None, :] >= np.asarray(counts)[:, None]
    h = np.where(past[..., None], 0.0, h).astype(np.float32)
    got = _recipe(torch.from_numpy(h).bfloat16(), torch.from_numpy(q4),
                  torch.from_numpy(scale),
                  torch.tensor(counts, dtype=torch.int32)).float().numpy()
    for x in range(len(counts)):
        ref = np.asarray(jint4.int4_matmul(
            jnp.asarray(h[x], jnp.bfloat16), jnp.asarray(q4[x]),
            jnp.asarray(scale[x]), interpret=True), np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30)))
                      - 7)
        assert (np.abs(got[x] - ref) <= ulp).all(), x
    np.testing.assert_array_equal(got[past], 0.0)


# -- the routing ------------------------------------------------------------

def _jax_positions(top_idx: np.ndarray, x_experts: int, cap: int):
    """The JAX ``moe_mlp``'s dispatch integers (``models/moe.py:262-269``
    of the JAX package): each assignment's position in its expert's buffer
    and each expert's filled rows."""
    g, k = top_idx.shape
    onehot = jax.nn.one_hot(jnp.asarray(top_idx), x_experts,
                            dtype=jnp.int32)
    flat = onehot.reshape(g * k, x_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    counts = jnp.minimum(flat.sum(axis=0), cap)
    return np.asarray(pos), np.asarray(counts)


@pytest.mark.parametrize("g,x,k,factor", [(8, 8, 2, 1.0), (40, 8, 2, 1.25),
                                          (1024, 8, 2, 8.0 / 2),
                                          (300, 16, 4, 0.5), (5, 4, 1, 1.0)])
def test_dispatch_positions_equal_the_jax_moe_mlps(g, x, k, factor):
    """Seeded routings (top-k of seeded logits, ties impossible), at the
    serving capacity and with drops: the same positions and counts."""
    rng = np.random.default_rng(g + x + k)
    logits = rng.normal(size=(g, x)).astype(np.float32)
    top_idx = np.argsort(-logits, axis=-1)[:, :k]
    cap = moe_capacity(g, x, k, factor)
    pos, counts = dispatch_positions(torch.from_numpy(top_idx), x, cap)
    want_pos, want_counts = _jax_positions(top_idx, x, cap)
    assert pos.dtype == counts.dtype == torch.int32
    assert counts.is_contiguous()
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
