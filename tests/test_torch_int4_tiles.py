"""The tensor-core int4 matmul recipe, emulated in plain PyTorch on the
CPU, against the port's plain version and the JAX package's kernel.

``csrc/int4_matmul.cu`` runs y^T = W^T h^T as wgmma m64nNk16 products: the
int4 weights, unpacked from the quantizer's bytes as they are, are the A
operand (nibble - 8, an integer in [-8, 7] and exact in bf16), h is the B
operand in bf16, each group's partial sum is formed in f32 over its k16
steps (eight to a 128-element step) and then multiplied by the group's
scale into the running f32 sum, which is cast to bf16 once. A CUDA kernel
cannot run here, so this file runs that arithmetic step by step, and the
integer tricks of the kernel (the nibble-to-bf16 bit pattern, the output
column of each fragment row, the padded rows of the staged bytes) bit by
bit.

Each result is held per element to ``chip_smoke.py``'s tolerance, 1e-4 +
1e-2 |plain| on the bf16 output (the kernel and the plain version both sum
exact products in f32 and round once to bf16: at most one bf16 ulp, 2^-8
relative, apart), against ``_int4_matmul_plain`` in f32 on the same inputs,
and against the JAX ``int4_matmul`` in interpret mode on the same numpy
inputs (one bf16 ulp: both round an f32 sum once, in another order). The
control multiplies each weight by its scale in bf16 before the product
(what ``_weight_int4pack_mm`` does with its bf16 scales); it must fall
outside the tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.ops import int4_matmul as jint4
from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import _int4_matmul_plain

ATOL, RTOL = 1e-4, 1e-2            # chip_smoke.py: bf16 output vs f32 plain
K16 = 16                           # the wgmma's reduced depth


def _share(out, ref) -> float:
    """Largest share of the per-element tolerance (above 1 fails)."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (ATOL + RTOL * ref.abs()))
                 .max())


def _weights(q4: torch.Tensor) -> torch.Tensor:
    """The unpacked weights (in, out) as the kernel's A operand holds
    them: in-element 2i from the low nibble, 2i + 1 from the high, less 8."""
    w = torch.empty((2 * q4.shape[0], q4.shape[1]))
    w[0::2] = ((q4 & 0xF).to(torch.int16) - 8).float()
    w[1::2] = ((q4 >> 4).to(torch.int16) - 8).float()
    return w


def _recipe(h, q4, scale, fold_scale=False):
    """The kernel's arithmetic: per group, the f32 sum of exact bf16
    products over its k16 steps, then scaled into the running f32 sum; the
    control instead rounds weight * scale to bf16 and sums those."""
    rows, kin = h.shape
    g = scale.shape[0]
    gs = kin // g
    w = _weights(q4)
    assert torch.equal(w.bfloat16().float(), w)    # exact in bf16
    hf = h.float()
    if fold_scale:
        wf = (w * scale[:, 0, :].repeat_interleave(gs, 0)).bfloat16().float()
        return (hf @ wf).bfloat16()
    acc = torch.zeros((rows, q4.shape[1]))
    for gi in range(g):
        part = torch.zeros_like(acc)
        for k0 in range(gi * gs, (gi + 1) * gs, K16):
            part = part + hf[:, k0:k0 + K16] @ w[k0:k0 + K16]
        acc = acc + part * scale[gi, 0]
    return acc.bfloat16()


def _inputs(rows, kin, out, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.normal(size=(kin, out))).astype(np.float32)
    h = rng.normal(size=(rows, kin)).astype(np.float32)
    leaf = _quantize_leaf_int4(torch.from_numpy(w))
    return torch.from_numpy(h).bfloat16(), leaf["q4"], leaf["scale"]


CASES = {
    # name: (rows, in, out); groups of 128 unless 128 does not divide in
    "decode": (8, 512, 256),
    "decode_one_row": (1, 256, 128),
    "regime_edge": (17, 384, 384),
    "prefill": (130, 1024, 256),
    "one_group_of_688": (13, 688, 128),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_int4_recipe_matches_plain_within_chip_tolerance(name):
    h, q4, scale = _inputs(*CASES[name])
    y = _recipe(h, q4, scale)
    ref = _int4_matmul_plain(h.float(), q4, scale)   # f32, before a cast
    assert y.shape == ref.shape and torch.isfinite(y.float()).all()
    assert _share(y, ref) <= 1


@pytest.mark.parametrize("rows,kin,out", [(8, 256, 384), (16, 512, 128),
                                          (3, 64, 128)])
def test_int4_recipe_matches_the_jax_kernel_in_interpret_mode(rows, kin,
                                                              out):
    w = np.random.RandomState(0).randn(kin, out).astype(np.float32) * 0.1
    leaf = jquant._quantize_leaf_int4(w)
    h = np.random.RandomState(1).randn(rows, kin).astype(np.float32)
    ref = np.asarray(jint4.int4_matmul(jnp.asarray(h, jnp.bfloat16),
                                       jnp.asarray(leaf["q4"]),
                                       jnp.asarray(leaf["scale"]),
                                       interpret=True), np.float32)
    got = _recipe(torch.from_numpy(h).bfloat16(),
                  torch.from_numpy(leaf["q4"]),
                  torch.from_numpy(leaf["scale"])).float().numpy()
    # one bf16 ulp: 2^-7 of the magnitude's power of two
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()


def test_int4_recipe_with_the_scale_folded_into_bf16_weights_misses():
    """The control: each weight times its scale rounded to bf16 before the
    product moves an element by up to ~2^-9 of the weight's magnitude;
    over the decode shape's 16384 outputs that misses the check the recipe
    passes on the same inputs."""
    h, q4, scale = _inputs(8, 4096, 2048, seed=3)
    ref = _int4_matmul_plain(h.float(), q4, scale)
    assert _share(_recipe(h, q4, scale), ref) <= 1
    assert _share(_recipe(h, q4, scale, fold_scale=True), ref) > 1


# -- the kernel's integer tricks, bit by bit ----------------------------------

def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (s >> 4n) & 7 of y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _bf16_value(bits: int) -> float:
    return float(torch.tensor([bits << 16], dtype=torch.int32)
                 .view(torch.float32)[0])


def _nibbles_bf16(w: int) -> tuple[float, float]:
    """nibbles_bf16: w | 0x43004300 read as two bf16 values, less 136."""
    v = w | 0x43004300
    return (_bf16_value(v & 0xFFFF) - 136.0, _bf16_value(v >> 16) - 136.0)


def test_unpack_gives_each_bytes_two_nibbles_less_8_as_the_fragment_pair():
    """Every pair of adjacent bytes (columns cw, cw + 1 of a packed row)
    gives the A fragment registers of both columns: (low nibble - 8, high
    nibble - 8), the (k = 2i, 2i + 1) pair, exact."""
    for b0 in range(256):
        for b1 in (0, 0x80, 0x7F, 0xFF, b0 ^ 0x5A):
            x = b0 | (b1 << 8)
            lo, hi = x & 0x0F0F, (x >> 4) & 0x0F0F
            for b, sel in ((b0, 0x7470), (b1, 0x7571)):
                pair = _nibbles_bf16(_byte_perm(lo, hi, sel))
                assert pair == ((b & 0xF) - 8.0, (b >> 4) - 8.0), (b0, b1)


def test_fragment_rows_map_to_adjacent_output_columns_once_each():
    """A thread's two accumulator rows (g and g + 8 of its warp) are output
    columns cw and cw + 1; over the block's 256 threads the 128 columns are
    each owned by the 4 threads of a quad (which hold different rows of h)."""
    owners = {}
    for tid in range(256):
        lane = tid % 32
        cw = (tid // 32) * 16 + 2 * (lane // 4)
        for c in (cw, cw + 1):
            owners.setdefault(c, set()).add(lane % 4)
    assert sorted(owners) == list(range(128))
    assert all(v == {0, 1, 2, 3} for v in owners.values())


def test_staged_rows_of_144_bytes_keep_the_fragment_reads_conflict_free():
    """A warp's 16-bit reads of one k16 half-slice (4 packed rows t4 x its
    16 columns) touch 16 distinct 4-byte words, which must lie in 16
    distinct banks; rows of 128 bytes would put all four rows in the same
    banks."""
    for row_bytes, free in ((144, True), (128, False)):
        for warp in range(8):
            for kk in range(8):
                for half in range(2):
                    words = {((8 * kk + 4 * half + lane % 4) * row_bytes
                              + warp * 16 + 2 * (lane // 4)) // 4
                             for lane in range(32)}
                    banks = {w % 32 for w in words}
                    assert (len(banks) == len(words)) == free
