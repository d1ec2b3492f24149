"""The port's ops against the JAX package's, on the same numpy inputs.

- ``rms_norm``: the port's plain version against the JAX XLA path, in f32
  (atol 1e-6: the same f32 statistics, summed in another order).
- ``paged_attention_multi``: the port's plain version against the JAX
  Pallas kernel run in interpret mode, in f32, over K in {1, 4, 16}, with
  a soft cap and with a sliding window (atol 1e-5: f32 softmax and
  products, accumulated page by page in the kernel and all at once in the
  plain version). Tables carry stale ids past ceil(len/T) that point at
  pages of large finite garbage, which neither side may let through.
- ``rope_frequencies`` / ``apply_rope``, unscaled and with the Llama-3.1
  scaling (atol 1e-6).
- The wrappers' dispatch: a CPU tensor takes the plain version and counts
  no launch; any other non-CUDA device raises. The kernels themselves run
  only on the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.attention import \
    paged_attention_multi as jax_paged_attention_multi
from k8s_runpod_kubelet_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from k8s_runpod_kubelet_tpu.ops.rope import apply_rope as jax_apply_rope
from k8s_runpod_kubelet_tpu.ops.rope import \
    rope_frequencies as jax_rope_frequencies
from k8s_runpod_kubelet_tpu_torch.ops import (apply_rope,
                                              paged_attention_multi,
                                              rms_norm, rope_frequencies)
from k8s_runpod_kubelet_tpu_torch.ops.attention import \
    _paged_attention_multi_plain
from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

GARBAGE = 3e4  # stale pages hold large finite values


# -- rms_norm -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 64), (8, 4096), (1, 1, 96)])
def test_rms_norm_plain_matches_jax_f32(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, use_pallas=False)
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_rms_norm_bf16_keeps_dtype_and_f32_weight():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    out = rms_norm(x.bfloat16(), w, 1e-5)
    assert out.dtype == torch.bfloat16
    ref = _rms_norm_plain(x.bfloat16().float(), w, 1e-5)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=1e-2)


# -- paged_attention_multi ------------------------------------------------------

def _attention_case(seed, b, kq, hq, hkv, d, t, n_pages, cols, lengths):
    """Pages, a table whose entries past ceil(len/T) are stale ids of
    garbage pages, and q."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_pages, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, t, hkv, d)).astype(np.float32)
    perm = rng.permutation(n_pages)
    live = [-(-int(n) // t) for n in lengths]
    table = np.zeros((b, cols), np.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    assert len(garbage) > 0
    for i in range(b):
        table[i, live[i]:] = garbage[np.arange(cols - live[i]) % len(garbage)]
    k[garbage] = GARBAGE
    v[garbage] = -GARBAGE
    q = rng.normal(size=(b, kq, hq, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


ATTN_CASES = {
    # name: (K, soft_cap, window, lengths)
    "k1": (1, None, None, [1, 9, 37]),
    "k4": (4, None, None, [4, 20, 40]),
    "k16": (16, None, None, [16, 23, 48]),
    "k1_softcap": (1, 5.0, None, [3, 17, 48]),
    "k4_softcap": (4, 5.0, None, [5, 31, 44]),
    "k16_softcap": (16, 5.0, None, [19, 33, 47]),
    "k1_window": (1, None, 10, [7, 26, 48]),
    "k4_window": (4, None, 10, [9, 27, 45]),
    "k16_window": (16, None, 11, [16, 30, 48]),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_paged_attention_multi_plain_matches_jax_kernel(case):
    kq, cap, window, lengths = ATTN_CASES[case]
    # D=128 and T=8: the shapes the JAX kernel's interpret mode takes
    b, hq, hkv, d, t, cols = 3, 8, 2, 128, 8, 6
    q, k, v, table, lens = _attention_case(
        7, b, kq, hq, hkv, d, t, 24, cols, lengths)
    ref = jax_paged_attention_multi(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), interpret=True, logit_soft_cap=cap,
        sliding_window=window)
    out = paged_attention_multi(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lens),
        logit_soft_cap=cap, sliding_window=window)
    assert out.shape == (b, kq, hq, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_paged_attention_multi_gqa_group_and_head_dim_64():
    """Group 4 at D=64 against the JAX XLA reference (the interpret-mode
    kernel takes D=128 only)."""
    b, kq, hq, hkv, d, t, cols = 2, 3, 8, 2, 64, 16, 4
    q, k, v, table, lens = _attention_case(
        11, b, kq, hq, hkv, d, t, 12, cols, [5, 50])
    ref = jax_paged_attention_multi(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), use_pallas=False)
    out = paged_attention_multi(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_paged_attention_multi_rejects_bad_arguments():
    q = torch.zeros(1, 1, 6, 64)
    pages = torch.zeros(4, 8, 4, 64)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        paged_attention_multi(q, pages, pages, table, lens)
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="soft_cap"):
        paged_attention_multi(q, pages, pages, table, lens,
                              logit_soft_cap=0.0)
    with pytest.raises(ValueError, match="sliding_window"):
        paged_attention_multi(q, pages, pages, table, lens,
                              sliding_window=0)


# -- rope -------------------------------------------------------------------------

ROPE_SCALINGS = {
    "none": None,
    "llama3": {"factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position": 64},
    "linear": {"rope_type": "linear", "factor": 4.0},
}


@pytest.mark.parametrize("scaling", sorted(ROPE_SCALINGS))
def test_rope_matches_jax(scaling):
    sc = ROPE_SCALINGS[scaling]
    cos_j, sin_j = jax_rope_frequencies(64, 256, 500_000.0, sc)
    cos_t, sin_t = rope_frequencies(64, 256, 500_000.0, sc)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    ref = jax_apply_rope(jnp.asarray(x), cos_j, sin_j, jnp.asarray(pos))
    out = apply_rope(torch.from_numpy(x), cos_t, sin_t,
                     torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    ref0 = jax_apply_rope(jnp.asarray(x), cos_j, sin_j)
    out0 = apply_rope(torch.from_numpy(x), cos_t, sin_t)
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), atol=1e-6)


def test_rope_refuses_yarn():
    """YaRN is ported now (held against JAX in tests/test_torch_mla.py): a
    yarn dict builds its tables, and what stays refused is a type neither
    package has, whose error names yarn among the supported types."""
    cos, _ = rope_frequencies(64, 16, 10_000.0, {"rope_type": "yarn",
                                                 "factor": 4.0})
    assert cos.shape == (16, 32)
    with pytest.raises(ValueError, match="yarn"):
        rope_frequencies(64, 16, 10_000.0, {"rope_type": "dynamic",
                                            "factor": 4.0})


# -- dispatch ---------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (rms_norm.launches, paged_attention_multi.launches)
    x, w = torch.randn(2, 64), torch.ones(64)
    torch.testing.assert_close(rms_norm(x, w, 1e-5),
                               _rms_norm_plain(x, w, 1e-5), rtol=0, atol=0)
    q, k, v, table, lens = (torch.from_numpy(a) for a in _attention_case(
        5, 2, 2, 4, 2, 64, 8, 8, 3, [3, 17]))
    torch.testing.assert_close(
        paged_attention_multi(q, k, v, table, lens),
        _paged_attention_multi_plain(q, k, v, table, lens,
                                     sm_scale=64 ** -0.5), rtol=0, atol=0)
    assert (rms_norm.launches, paged_attention_multi.launches) == before


def test_other_devices_raise_instead_of_falling_back():
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm(torch.zeros(2, 8, device="meta"),
                 torch.ones(8, device="meta"))
    q = torch.zeros(1, 1, 2, 64, device="meta")
    pages = torch.zeros(2, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_multi(q, pages, pages,
                              torch.zeros(1, 1, dtype=torch.int32,
                                          device="meta"),
                              torch.ones(1, dtype=torch.int32,
                                         device="meta"))
