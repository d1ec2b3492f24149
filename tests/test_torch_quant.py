"""The port's quantization ops against the JAX package's, on the same numpy
inputs.

- ``quantize_params`` (bits 8 and 4) bit-identical to the JAX quantizer on
  ``tiny_llama``, whose ``w_down`` (contraction 688, not a multiple of 128)
  takes the one-group branch; ``dequantize`` inverts the packing;
- ``_kv_quant`` bit-identical to the JAX model's;
- ``_int4_matmul_plain`` against the JAX int4 kernel in interpret mode and
  its ``_fallback_2d``: f32 within 1e-5, bf16 within one bf16 ulp (both
  sides sum in f32 and round once);
- ``_paged_attention_multi_quant_plain`` and the single-token plains
  (``_paged_attention_plain``, ``_paged_attention_quant_plain``) against
  the JAX Pallas kernels in interpret mode and their ``_xla`` versions
  (D=128, T=8, f32, atol 1e-5), plain, with a soft cap and with a window;
  stale table entries name pages of large values, which neither side may
  let through;
- the wrappers' dispatch: a CPU tensor takes the plain version and counts
  no launch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.ops import attention as jattn
from k8s_runpod_kubelet_tpu.ops import int4_matmul as jint4
from k8s_runpod_kubelet_tpu_torch.models import llama as tllama
from k8s_runpod_kubelet_tpu_torch.models.from_jax import config_from_jax
from k8s_runpod_kubelet_tpu_torch.models.quant import (dequantize,
                                                       is_quantized,
                                                       quantize_params)
from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul, paged_attention,
                                              paged_attention_multi_quant,
                                              paged_attention_quant)
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _paged_attention_multi_quant_plain, _paged_attention_plain,
    _paged_attention_quant_plain)
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import _int4_matmul_plain

GARBAGE = 3e4


# -- quantize_params ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_tree():
    jcfg = jllama.tiny_llama()           # E=256, mlp 688, vocab 32000
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.normal(size=s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    return jcfg, tree


def _leaves(tree, prefix=""):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{name}/")
        else:
            yield prefix + name, leaf


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bit_identical_to_jax(tiny_tree, bits):
    jcfg, tree = tiny_tree
    ref = jquant.quantize_params(jcfg, tree, bits=bits)
    cfg = config_from_jax(jcfg, torch.bfloat16)
    got = quantize_params(cfg, jax.tree_util.tree_map(torch.from_numpy, tree),
                          bits=bits)
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    got_leaves = dict(_leaves(got))
    assert set(got_leaves) == set(ref_leaves)
    kind = "q4" if bits == 4 else "q8"
    assert is_quantized(got["layers"]["w_down"])
    assert f"layers/w_down/{kind}" in got_leaves
    if bits == 4:   # kin 688: one group; kin 256: two groups of 128
        assert got["layers"]["w_down"]["scale"].shape == (2, 1, 1, 256)
        assert got["layers"]["wq"]["scale"].shape == (2, 2, 1, 256)
    for name, r in ref_leaves.items():
        g = got_leaves[name]
        if g.dtype == torch.bfloat16:
            assert r.dtype == jnp.bfloat16, name
            g, r = g.float().numpy(), r.astype(np.float32)
        else:
            g = g.numpy()
            assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    # the packing inverts: dequantize reads back the JAX dequantization
    w = got["layers"]["w_gate"]
    back = dequantize(w).numpy()
    q = w[kind].numpy()
    if bits == 4:
        lo = (q & 0xF).astype(np.int8) - 8
        hi = (q >> 4).astype(np.int8) - 8
        ints = np.stack((lo, hi), axis=-2).reshape(2, 256, 688)
        want = (ints.reshape(2, 2, 128, 688) * w["scale"].numpy()).reshape(
            2, 256, 688)
    else:
        want = q.astype(np.float32) * w["scale"].numpy()
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_kv_quant_bit_identical_to_jax(dtype):
    x = (np.random.default_rng(4).normal(size=(3, 5, 2, 64)) * 2.0)
    x[0, 0, 0] = 0.0                      # an all-zero row: the 1e-8 floor
    x = x.astype(dtype)
    jq, js = jllama._kv_quant(jnp.asarray(x))
    tq, ts = tllama._kv_quant(torch.from_numpy(np.asarray(x, np.float32))
                              .to(torch.bfloat16 if dtype != np.float32
                                  else torch.float32))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tllama._kv_dequant(tq, ts).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jllama._kv_dequant(jq, js)))


# -- int4_matmul ------------------------------------------------------------------

INT4_CASES = [
    # b, kin, out: the JAX package's kernel test shapes, then 1 and 13 rows
    (16, 256, 384),
    (3, 64, 128),
    (8, 512, 512),
    (1, 256, 128),
    (13, 384, 256),
]


@pytest.mark.parametrize("b,kin,out", INT4_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int4_matmul_plain_matches_jax_kernel(b, kin, out, dtype):
    w = np.random.RandomState(0).randn(kin, out).astype(np.float32) * 0.1
    leaf = jquant._quantize_leaf_int4(w)
    h = np.random.RandomState(1).randn(b, kin).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jh = jnp.asarray(h, jdt)
    q4, scale = jnp.asarray(leaf["q4"]), jnp.asarray(leaf["scale"])
    kernel = np.asarray(jint4.int4_matmul(jh, q4, scale, interpret=True),
                        np.float32)
    fallback = np.asarray(jint4._fallback_2d(jh, q4, scale), np.float32)
    th = torch.from_numpy(h).to(tdt)
    tq, ts = torch.from_numpy(leaf["q4"]), torch.from_numpy(leaf["scale"])
    got = _int4_matmul_plain(th, tq, ts)
    before = int4_matmul.launches
    via = int4_matmul(th[None], tq, ts)             # batch dims flatten
    assert int4_matmul.launches == before           # CPU: no launch
    assert got.dtype == tdt and via.shape == (1, b, out)
    torch.testing.assert_close(via[0], got, rtol=0, atol=0)
    got = got.float().numpy()
    for ref in (kernel, fallback):
        if dtype == "f32":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        else:   # one bf16 ulp: 2^-7 of the magnitude's power of two
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref),
                                                      1e-30))) - 7)
            assert (np.abs(got - ref) <= ulp).all()


# -- paged attention over int8 pages, and the single-token forms -----------------

def _quant_case(seed, b, kq, hq, hkv, d, t, n_pages, cols, lengths):
    """int8 pages with positive f32 scales, a bf16-free f32 q, and a table
    whose entries past ceil(len/T) name garbage pages (int8 127 at a large
    scale)."""
    rng = np.random.default_rng(seed)
    kp = rng.integers(-127, 128, size=(n_pages, t, hkv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(n_pages, t, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, size=(n_pages, t, hkv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, size=(n_pages, t, hkv)).astype(np.float32)
    perm = rng.permutation(n_pages)
    live = [-(-int(n) // t) for n in lengths]
    table = np.zeros((b, cols), np.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[np.arange(cols - live[i]) % len(garbage)]
    kp[garbage], vp[garbage] = 127, -127
    ks[garbage] = vs[garbage] = GARBAGE / 127
    q = rng.normal(size=(b, kq, hq, d)).astype(np.float32)
    return q, kp, vp, ks, vs, table, np.asarray(lengths, np.int32)


QUANT_CASES = {
    # name: (K, soft_cap, window, lengths)
    "k4": (4, None, None, [4, 20, 40]),
    "k4_softcap": (4, 5.0, None, [5, 31, 44]),
    "k4_window": (4, None, 10, [9, 27, 45]),
    "k1": (1, None, None, [1, 9, 37]),
    "k1_softcap": (1, 5.0, None, [3, 17, 48]),
    "k1_window": (1, None, 10, [7, 26, 48]),
}
B, HQ, HKV, D, T, COLS, N_PAGES = 3, 8, 2, 128, 8, 6, 24


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_multi_quant_plain_matches_jax_kernel_and_xla(case):
    kq, cap, window, lengths = QUANT_CASES[case]
    arrays = _quant_case(11, B, kq, HQ, HKV, D, T, N_PAGES, COLS, lengths)
    kw = dict(logit_soft_cap=cap, sliding_window=window)
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = jattn.paged_attention_multi_quant(*jargs, interpret=True, **kw)
    xla = jattn._paged_attention_multi_quant_xla(*jargs, sm_scale=D ** -0.5,
                                                 **kw)
    before = paged_attention_multi_quant.launches
    out = paged_attention_multi_quant(*_torch(*arrays), **kw)
    assert paged_attention_multi_quant.launches == before
    plain = _paged_attention_multi_quant_plain(*_torch(*arrays),
                                               sm_scale=D ** -0.5, **kw)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert out.shape == (B, kq, HQ, D) and out.dtype == torch.float32
    for ref in (kernel, xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("case", ["k1", "k1_softcap", "k1_window"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_form", "int8"])
def test_single_token_plains_match_jax_kernels_and_xla(case, quant):
    """The single-token forms: q (B, Hq, D), lengths counting the query's
    own token."""
    _, cap, window, lengths = QUANT_CASES[case]
    q, kp, vp, ks, vs, table, lens = _quant_case(
        13, B, 1, HQ, HKV, D, T, N_PAGES, COLS, lengths)
    q = q[:, 0]
    kw = dict(logit_soft_cap=cap, sliding_window=window)
    if quant:
        arrays = (q, kp, vp, ks, vs, table, lens)
        jfn, jxla = jattn.paged_attention_quant, \
            jattn._paged_attention_quant_xla
        fn, plain = paged_attention_quant, _paged_attention_quant_plain
    else:   # f32 pages: the dequantized values
        arrays = (q, kp.astype(np.float32) * ks[..., None],
                  vp.astype(np.float32) * vs[..., None], table, lens)
        jfn, jxla = jattn.paged_attention, jattn._paged_attention_xla
        fn, plain = paged_attention, _paged_attention_plain
    jargs = [jnp.asarray(a) for a in arrays]
    kernel = jfn(*jargs, interpret=True, **kw)
    xla = jxla(*jargs, sm_scale=D ** -0.5, **kw)
    before = fn.launches
    out = fn(*_torch(*arrays), **kw)
    assert fn.launches == before and out.shape == (B, HQ, D)
    torch.testing.assert_close(
        out, plain(*_torch(*arrays), sm_scale=D ** -0.5, **kw), rtol=0,
        atol=0)
    for ref in (kernel, xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_wrappers_refuse_other_devices_and_bad_shapes():
    q, kp, vp, ks, vs, table, lens = _torch(*_quant_case(
        1, 1, 1, 4, 2, 64, 8, 4, 2, [5]))
    with pytest.raises(ValueError, match="scale shapes"):
        paged_attention_multi_quant(q, kp, vp, ks[:, :4], vs, table, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_quant(q[:, 0].to("meta"), kp, vp, ks, vs, table,
                              lens)
    w = torch.zeros((32, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="packs"):
        int4_matmul(torch.zeros((2, 32)), w, torch.ones((1, 1, 8)))
    with pytest.raises(ValueError, match="does not group"):
        int4_matmul(torch.zeros((2, 64)), w, torch.ones((3, 1, 8)))
