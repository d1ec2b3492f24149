"""The port's kernels against their plain versions on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the CPU has no mode for a CUDA or Triton kernel. This file imports no
jax, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Inputs are bf16 on the card; outputs are compared in f32 against the
plain version run on the same inputs on the card (tolerances: bf16 output
rounding, 1 ulp = 2^-8 relative, plus f32 sums taken in another order).
"""

import dataclasses
import time

import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4
from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
from k8s_runpod_kubelet_tpu_torch.ops import (
    flash_attention, flash_dkv, flash_dq, flash_fwd, int4_expert_matmul,
    int4_matmul, int4_matmul_sharded,
    paged_attention, paged_attention_mla, paged_attention_mla_quant,
    paged_attention_multi, paged_attention_multi_mla,
    paged_attention_multi_mla_quant, paged_attention_multi_quant,
    paged_attention_quant, rms_norm)
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _attention_plain, _flash_dkv_plain, _flash_dq_plain, _flash_fwd_plain,
    _paged_attention_mla_plain, _paged_attention_mla_quant_plain,
    _paged_attention_multi_mla_plain, _paged_attention_multi_mla_quant_plain,
    _paged_attention_multi_plain, _paged_attention_multi_quant_plain,
    _paged_attention_plain, _paged_attention_quant_plain)
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import (
    _expert_launchers, _int4_expert_matmul_plain, _int4_matmul_plain,
    _sharded_launchers)
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import \
    _launchers as int4_matmul_launchers
from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# Gemma-7B's 3072 and Qwen2-7B's 3584 are not powers of two (the masked
# block); 256 rows of 128 are Qwen3-8B's q/k norm over 8 slots x 32 heads
@pytest.mark.parametrize("rows,width", [(8, 4096), (1024, 4096), (3, 100),
                                        (1024, 3072), (1024, 3584),
                                        (256, 128)])
def test_rms_norm_kernel_matches_plain(cuda, rows, width):
    gen = torch.Generator().manual_seed(rows)
    x = (3 * torch.randn((rows, width), generator=gen)).to(cuda,
                                                           torch.bfloat16)
    w = (1 + 0.1 * torch.randn((width,), generator=gen)).to(cuda)
    before = rms_norm.launches
    out = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), _rms_norm_plain(x, w, 1e-5)
                               .float(), atol=1e-2, rtol=1e-2)


def test_rms_norm_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.ones((2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        rms_norm(x.float(), torch.ones(64, device=cuda))
    with pytest.raises(TypeError):
        rms_norm(x, torch.ones(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm(torch.ones((64, 2), dtype=torch.bfloat16, device=cuda).t(),
                 torch.ones(64, device=cuda))


def _case(dev, b, kq, hq, hkv, d, t, cols, lengths, seed=0):
    gen = torch.Generator().manual_seed(seed)
    live = [-(-n // t) for n in lengths]
    n_pages = sum(live) + 8
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[torch.arange(cols - live[i]) % 8]
    k = torch.randn((n_pages, t, hkv, d), generator=gen)
    v = torch.randn((n_pages, t, hkv, d), generator=gen)
    k[garbage], v[garbage] = 3e4, -3e4
    q = torch.randn((b, kq, hq, d), generator=gen)
    return (q.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16),
            v.to(dev, torch.bfloat16), table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


CASES = {
    # name: (B, K, Hq, Hkv, D, T, table cols, lengths, soft cap, window)
    "8b_decode": (8, 1, 32, 8, 128, 16, 128,
                  [1, 17, 300, 511, 1024, 1500, 1999, 2048], None, None),
    "8b_k4": (8, 4, 32, 8, 128, 16, 128,
              [4, 40, 333, 700, 1029, 1600, 1999, 2048], None, None),
    "8b_chunk": (1, 300, 32, 8, 128, 16, 64, [300 + 37], None, None),
    # the verify width of --speculate 4 over the engine's 8 slots
    "8b_verify_k5": (8, 5, 32, 8, 128, 16, 128,
                     [5, 41, 334, 705, 1029, 1605, 1999, 2048], None, None),
    "d64_softcap": (3, 5, 8, 2, 64, 16, 8, [5, 60, 128], 20.0, None),
    "d256_window": (2, 7, 8, 4, 256, 8, 8, [9, 64], None, 13),
    "group1_window_softcap": (2, 16, 4, 4, 128, 16, 6, [16, 90], 8.0, 20),
    # the other dense families: Gemma-7B (16 heads of 256 over 16, group 1),
    # Qwen2-7B (28 over 4, group 7), Mistral-7B's 4096-token window over
    # contexts past it
    "gemma_decode": (8, 1, 16, 16, 256, 16, 128,
                     [1, 17, 300, 511, 1024, 1500, 1999, 2048], None, None),
    "gemma_verify_k5": (8, 5, 16, 16, 256, 16, 128,
                        [5, 41, 334, 705, 1029, 1605, 1999, 2048], None,
                        None),
    "qwen2_group7_decode": (8, 1, 28, 4, 128, 16, 128,
                            [1, 17, 300, 511, 1024, 1500, 1999, 2048], None,
                            None),
    "mistral_window_decode": (8, 1, 32, 8, 128, 16, 320,
                              [4200, 4311, 4452, 4580, 4699, 4777, 4901,
                               5000], None, 4096),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_multi_kernel_matches_plain(cuda, name):
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = CASES[name]
    q, k, v, table, lens = _case(cuda, b, kq, hq, hkv, d, t, cols, lengths)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, k, v, table, lens, logit_soft_cap=cap,
                                sliding_window=window)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    ref = _paged_attention_multi_plain(q, k, v, table, lens,
                                       sm_scale=d ** -0.5,
                                       logit_soft_cap=cap,
                                       sliding_window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_kernels_skip_pages_behind_the_window(cuda, quant):
    """Mistral's window at decode and at K = 5 over contexts past 4096:
    rewriting every page wholly behind the oldest query's window to 3e4
    (as a recycled table entry would hold another position's rows) leaves
    the output bit for bit as it was; rewriting a page inside it does
    not."""
    t, window = 16, 4096
    for kq, lengths in ((1, [4200, 4577, 5000]), (5, [4105, 4400, 4999])):
        q, k, v, table, lens = _case(cuda, 3, kq, 32, 8, 128, t, 320,
                                     lengths, seed=kq)
        pages = [k, v]
        if quant:
            kp, ks, vp, vs = _int8_pages(k, v)
            pages = [kp, vp, ks, vs]
        fn = paged_attention_multi_quant if quant else paged_attention_multi

        def run(pg):
            return fn(q, *pg, table, lens, sliding_window=window)

        ref = run(pages)
        behind = torch.cat([table[i, :(n - kq - window + 1) // t]
                            for i, n in enumerate(lengths)])
        inside = table[:, (min(lengths) - kq) // t - 1]
        for rows, same in ((behind, True), (inside, False)):
            bad = [p.clone() for p in pages]
            for p in bad[:2]:
                p[rows.long()] = 3e4 if p.dtype == torch.bfloat16 else 127
            out = run(bad)
            assert torch.equal(out, ref) == same, (kq, same)


def test_paged_attention_multi_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, table, lens = _case(cuda, 1, 1, 4, 2, 96, 16, 2, [5])
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_multi(q, k, v, table, lens)
    q, k, v, table, lens = _case(cuda, 1, 1, 4, 2, 128, 16, 2, [5])
    with pytest.raises(TypeError):
        paged_attention_multi(q.float(), k, v, table, lens)
    with pytest.raises(TypeError):
        paged_attention_multi(q, k, v, table.long(), lens)
    q2, k, v, table, lens = _case(cuda, 1, 2, 4, 2, 128, 16, 2, [5])
    strided = q2.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_multi(strided, k, v, table, lens)


def test_rms_norm_gradients_on_the_card_match_plain(cuda):
    gen = torch.Generator().manual_seed(5)
    x = (3 * torch.randn((6, 256), generator=gen)).to(cuda, torch.bfloat16)
    w = (1 + 0.1 * torch.randn((256,), generator=gen)).to(cuda)
    g = torch.randn((6, 256), generator=gen).to(cuda, torch.bfloat16)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = rms_norm.launches
    (rms_norm(xk, wk, 1e-5).float() * g.float()).sum().backward()
    assert rms_norm.launches == before + 1
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    (_rms_norm_plain(xp, wp, 1e-5).float() * g.float()).sum().backward()
    assert xk.grad.dtype == torch.bfloat16 and wk.grad.dtype == torch.float32
    torch.testing.assert_close(xk.grad, xp.grad, atol=0, rtol=0)
    torch.testing.assert_close(wk.grad, wp.grad, atol=1e-5, rtol=1e-5)


FLASH_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, causal, window, soft cap)
    "s1": (1, 2, 2, 1, 1, 128, True, None, None),
    "ragged_gqa": (2, 8, 2, 133, 133, 128, True, None, None),
    "d64_softcap": (2, 4, 4, 77, 77, 64, True, None, 8.0),
    "d256_window": (1, 4, 1, 130, 130, 256, True, 40, None),
    "noncausal": (2, 8, 2, 65, 65, 128, False, None, None),
    "sq_gt_sk_window": (1, 2, 1, 50, 20, 64, True, 8, None),
    "sk_gt_sq": (1, 4, 2, 20, 70, 128, False, None, None),
    # the serving shape: a dense-route prefill head or an embed at 8B
    # widths, one sequence of a ragged length
    "serving_b1_s1000": (1, 32, 8, 1000, 1000, 128, True, None, None),
    # MLA's direct form: D = 128 + 64, one kv head a q head
    "d192_mla": (2, 4, 4, 133, 133, 192, True, None, None),
    "d192_noncausal": (1, 2, 2, 70, 70, 192, False, None, None),
    # Gemma-7B's dense-route prefill head: 16 heads of 256, group 1
    "gemma_serving_d256_group1": (1, 16, 16, 1024, 1024, 256, True, None,
                                  None),
}


def _flash_case(dev, name, seed=0):
    b, hq, hkv, sq, sk, d = FLASH_CASES[name][:6]
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, hq, sq, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=gen) for _ in range(2))
    return tuple(t.to(dev, torch.bfloat16) for t in (q, k, v, do))


def _close_bf16(out, ref):
    """Per element within 1e-4 + 1e-2 |ref|: the kernel rounds its f32
    result once to bf16 (half an ulp, <= 2^-8 |ref|)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    assert torch.all(err <= 1e-4 + 1e-2 * ref.abs()), float(err.max())


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    causal, window, cap = FLASH_CASES[name][6:]
    q, k, v, do = _flash_case(cuda, name)
    d = q.shape[3]
    args = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap)
    counts = [f.launches for f in (flash_fwd, flash_dq, flash_dkv)]
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_fwd, flash_dq, flash_dkv)] == \
        [n + 1 for n in counts]
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd_plain(qf, kf, vf, **args)
    _close_bf16(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    _close_bf16(dq, _flash_dq_plain(qf, kf, vf, dof, lse, delta, **args))
    dk_ref, dv_ref = _flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args)
    _close_bf16(dk, dk_ref)
    _close_bf16(dv, dv_ref)
    for t in (o, dq, dk, dv):
        assert torch.isfinite(t).all()


def test_flash_attention_autograd_on_the_card(cuda):
    q, k, v, do = _flash_case(cuda, "ragged_gqa", seed=1)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=True)
    o.backward(do)
    pq, pk, pv = (t.float().requires_grad_() for t in (q, k, v))
    ref = _attention_plain(pq, pk, pv, causal=True,
                           sm_scale=q.shape[3] ** -0.5)
    ref.backward(do.float())
    _close_bf16(o, ref)
    # delta comes from the bf16 o (as the JAX package computes it), so the
    # gradients sit within 1% of each tensor's scale, not per element
    for got, want in ((tq.grad, pq.grad), (tk.grad, pk.grad),
                      (tv.grad, pv.grad)):
        err = (got.float() - want).abs()
        assert float(err.max()) <= 1e-2 * float(want.abs().max())


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _flash_case(cuda, "noncausal")
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3),
                        v.transpose(2, 3))
    q96 = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q96, q96, q96)
    o, lse = flash_fwd(q, k, v, causal=False, sm_scale=0.1)
    with pytest.raises(TypeError):
        flash_dq(q, k, v, do, lse.bfloat16(), lse, causal=False,
                 sm_scale=0.1)
    with pytest.raises(ValueError, match="is on"):
        flash_dkv(q, k, v, do, lse.cpu(), lse, causal=False, sm_scale=0.1)


# -- the tensor-core tile's edges (csrc/attention_tile_sm90.cuh) ---------------------

TILE_FLASH_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, causal, window, soft cap)
    "s129_d64": (1, 4, 2, 129, 129, 64, True, None, None),
    "s191_d256_window": (1, 2, 1, 191, 191, 256, True, 50, None),
    "s200_sk70_window_blind_rows": (1, 4, 2, 200, 70, 128, True, 16, None),
    "s65_sk300_noncausal_cap": (2, 4, 4, 65, 300, 128, False, None, 10.0),
    "s191_d192_window": (1, 2, 2, 191, 191, 192, True, 50, None),
}


@pytest.mark.parametrize("name", sorted(TILE_FLASH_CASES))
def test_flash_fwd_tile_edges_match_plain(cuda, name):
    """S off the 64-row and 64-key tiles, D = 64, 192 and 256, and rows
    that see no key (o = 0, lse = -1e30), per element at the chip check's
    tolerance."""
    b, hq, hkv, sq, sk, d, causal, window, cap = TILE_FLASH_CASES[name]
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((b, hq, sq, d), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((b, hkv, sk, d), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    args = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap)
    o, lse = flash_fwd(q, k, v, **args)
    o_ref, lse_ref = _flash_fwd_plain(q.float(), k.float(), v.float(),
                                      **args)
    _close_bf16(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if sq > sk and window is not None:
        blind = torch.arange(sq, device=cuda) - window + 1 >= sk
        assert bool(blind.any())
        assert torch.all(o[:, :, blind] == 0)
        assert torch.all(lse[:, :, blind] == -1e30)


TILE_BWD_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, causal, window, soft cap)
    "s37_d64_below_one_tile": (1, 4, 2, 37, 37, 64, True, None, None),
    "s129_ragged_gqa4": (2, 8, 2, 129, 129, 128, True, None, None),
    "s191_d256_window": (1, 4, 2, 191, 191, 256, True, 50, None),
    "s200_sk70_window_blind_rows": (1, 4, 2, 200, 70, 128, True, 16, None),
    "s65_sk300_noncausal_cap": (2, 4, 4, 65, 300, 128, False, None, 10.0),
    "s100_d256_noncausal_cap": (1, 2, 1, 100, 100, 256, False, None, 5.0),
    "s300_d64_window_cap": (1, 8, 2, 300, 300, 64, True, 70, 8.0),
    "s37_d192_below_one_tile": (1, 2, 2, 37, 37, 192, True, None, None),
    "s161_d192_cap": (1, 4, 4, 161, 161, 192, True, None, 5.0),
}


@pytest.mark.parametrize("name", sorted(TILE_BWD_CASES))
def test_flash_backward_tile_edges_match_plain(cuda, name):
    """flash_dq and flash_dkv at S off the 64-row tiles and below one, D =
    64, 192 and 256 (dK/dV in two passes), a window, a soft cap, non-causal,
    Sq != Sk and rows that see no key (no gradient), per element at the
    chip check's tolerance against the plain versions fed the kernel's lse
    and delta."""
    b, hq, hkv, sq, sk, d, causal, window, cap = TILE_BWD_CASES[name]
    gen = torch.Generator().manual_seed(11)
    q, do = (torch.randn((b, hq, sq, d), generator=gen)
             .to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    args = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap)
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    counts = [f.launches for f in (flash_dq, flash_dkv)]
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_dq, flash_dkv)] == \
        [n + 1 for n in counts]
    f32 = [t.float() for t in (q, k, v, do)]
    _close_bf16(dq, _flash_dq_plain(*f32, lse, delta, **args))
    dk_ref, dv_ref = _flash_dkv_plain(*f32, lse, delta, **args)
    _close_bf16(dk, dk_ref)
    _close_bf16(dv, dv_ref)
    if sq > sk and window is not None:
        blind = torch.arange(sq, device=cuda) - window + 1 >= sk
        assert bool(blind.any())
        assert torch.all(dq[:, :, blind] == 0)


# ring attention's chunk steps: q_offset = the chunk's distance behind
OFFSET_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, window, soft cap, q_offset)
    "ragged_all_visible": (2, 8, 2, 133, 133, 128, None, None, 133),
    "d64_cap_3s": (1, 4, 4, 77, 77, 64, None, 8.0, 231),
    "window_band": (1, 8, 2, 200, 200, 128, 70, None, 200),
    "d256_window": (1, 4, 1, 130, 130, 256, 40, None, 130),
    "window_blind": (1, 4, 2, 100, 100, 128, 16, None, 300),
    "sq1_window_cap": (1, 2, 1, 1, 64, 128, 30, 5.0, 40),
    "d192_all_visible": (1, 4, 4, 130, 130, 192, None, None, 130),
}


def _within_bf16(out, ref) -> bool:
    ref = ref.float()
    return bool(torch.all((out.float() - ref).abs()
                          <= 1e-4 + 1e-2 * ref.abs()))


@pytest.mark.parametrize("name", sorted(OFFSET_CASES))
def test_flash_kernels_at_an_offset_match_plain(cuda, name):
    """The three kernels at q_offset > 0 against their plain versions at
    the same offset (the backward fed the kernel's lse and delta), per
    element at the chip check's tolerance; the control, the same kernels
    at offset 0 on the same inputs, must miss it."""
    b, hq, hkv, sq, sk, d, window, cap, offset = OFFSET_CASES[name]
    gen = torch.Generator().manual_seed(13)
    q, do = (torch.randn((b, hq, sq, d), generator=gen)
             .to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, hkv, sk, d), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    args = dict(causal=True, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap, q_offset=offset)
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = _flash_fwd_plain(*f32[:3], **args)
    dq_ref = _flash_dq_plain(*f32, lse, delta, **args)
    dk_ref, dv_ref = _flash_dkv_plain(*f32, lse, delta, **args)
    _close_bf16(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close_bf16(got, ref)
    zero = dict(args, q_offset=0)
    o0, lse0 = flash_fwd(q, k, v, **zero)
    assert not _within_bf16(o0, o_ref)
    assert not _within_bf16(flash_dq(q, k, v, do, lse, delta, **zero),
                            dq_ref)
    dk0, dv0 = flash_dkv(q, k, v, do, lse, delta, **zero)
    assert not (_within_bf16(dk0, dk_ref) and _within_bf16(dv0, dv_ref))
    if name == "window_blind":     # no query sees a key of this chunk
        assert not o.any() and not dq.any() and not dk.any()
        assert torch.all(lse <= -1e29)


@pytest.mark.parametrize("window", [None, 100])
def test_ring_flash_on_the_card_matches_the_plain_ring(cuda, window):
    """The in-process ring through the kernels (bf16) against the plain
    online-softmax ring in f32 on the same inputs: the output and the
    gradients within 1% of each tensor's largest magnitude (each chunk's
    o is rounded to bf16 before the f32 merge, and a chunk's o may exceed
    the merged one where chunks cancel; delta comes from the bf16 o); one
    launch of each kernel a ring step."""
    from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import (
        _ring_steps, ring_attention)
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
    n, s = 4, 512
    mesh = make_mesh(MeshConfig(seq=n))
    gen = torch.Generator().manual_seed(17)
    q, do = (torch.randn((2, 8, s, 128), generator=gen)
             .to(cuda, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 2, s, 128), generator=gen)
            .to(cuda, torch.bfloat16) for _ in range(2))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    steps = _ring_steps(n, s // n, window)
    before = [f.launches for f in (flash_fwd, flash_dq, flash_dkv)]
    o = ring_attention(tq, tk, tv, mesh, sliding_window=window,
                       use_flash=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip((flash_fwd, flash_dq, flash_dkv),
                                           before)] == [steps] * 3
    pq, pk, pv = (t.float().requires_grad_() for t in (q, k, v))
    ref = ring_attention(pq, pk, pv, mesh, sliding_window=window)
    ref.backward(do.float())
    for got, want in ((o.detach(), ref.detach()), (tq.grad, pq.grad),
                      (tk.grad, pk.grad), (tv.grad, pv.grad)):
        assert float((got.float() - want).abs().max()) <= \
            1e-2 * float(want.abs().max())


TILE_PAGED_CASES = {
    # name: (B, K, Hq, Hkv, D, T, cols, lengths, soft cap, window)
    # decode splits of 15 pages (240 positions): boundaries mid-tile and
    # mid-sequence, and sequences shorter than one split
    "decode_split_edges": (8, 1, 32, 8, 128, 16, 128,
                           [239, 240, 241, 481, 1023, 1024, 1025, 2047],
                           None, None),
    "k4_split_d64_window": (8, 4, 16, 4, 64, 16, 64,
                            [4, 63, 64, 65, 500, 700, 900, 1024], None, 100),
    "decode_split_d256_softcap": (4, 1, 8, 4, 256, 8, 64, [1, 100, 257, 512],
                                  5.0, None),
    "rows_65_two_warpgroups": (2, 13, 10, 2, 128, 16, 32, [13, 300], None,
                               None),
    "rows_129_two_blocks_window": (1, 43, 6, 2, 128, 16, 16, [43 + 150],
                                   None, 60),
    # 40 sequences fill the card: one pass, one warpgroup a block
    "decode_b40_one_pass": (40, 1, 32, 8, 128, 16, 32,
                            [1 + 13 * i for i in range(40)], None, None),
}


@pytest.mark.parametrize("name", sorted(TILE_PAGED_CASES))
def test_paged_attention_multi_tile_edges_match_plain(cuda, name):
    """Split-KV boundaries inside a sequence and inside a 64-key tile, D =
    64 and 256, row tiles of 65 and 129 rows, a window and a soft cap, per
    element at the chip check's tolerance against the f32 plain."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import _split_plan
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = TILE_PAGED_CASES[name]
    q, k, v, table, lens = _case(cuda, b, kq, hq, hkv, d, t, cols, lengths)
    splits = _split_plan(b, kq, hq // hkv, hkv, cols,
                         torch.cuda.get_device_properties(cuda)
                         .multi_processor_count)[0]
    if name.startswith(("decode_split", "k4_split")):
        assert splits > 1
    if name.endswith("one_pass"):
        assert splits == 1
    args = dict(logit_soft_cap=cap, sliding_window=window)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, k, v, table, lens, **args)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    ref = _paged_attention_multi_plain(q.float(), k, v, table, lens,
                                       sm_scale=d ** -0.5, **args)
    _close_bf16(out, ref)


# -- int8 pages, the single-token forms, int4 -----------------------------------------

def _int8_pages(k, v):
    """int8 pages and per-(position, kv head) scales standing for k, v."""
    out = []
    for x in (k, v):
        s = x.float().abs().amax(-1).clamp_min(1e-8) / 127
        out += [torch.round(x.float() / s[..., None]).clamp(-127, 127)
                .to(torch.int8), s.contiguous()]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_multi_quant_kernel_matches_plain(cuda, name):
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = CASES[name]
    q, k, v, table, lens = _case(cuda, b, kq, hq, hkv, d, t, cols, lengths)
    kp, ks, vp, vs = _int8_pages(k, v)
    args = dict(logit_soft_cap=cap, sliding_window=window)
    before = paged_attention_multi_quant.launches
    out = paged_attention_multi_quant(q, kp, vp, ks, vs, table, lens, **args)
    torch.cuda.synchronize()
    assert paged_attention_multi_quant.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close_bf16(out, _paged_attention_multi_quant_plain(
        q, kp, vp, ks, vs, table, lens, sm_scale=d ** -0.5, **args))


@pytest.mark.parametrize("name", sorted(TILE_PAGED_CASES))
def test_paged_attention_multi_quant_tile_edges_match_plain(cuda, name):
    """The int8-page kernel over the bf16 kernel's tile edges: split-KV
    boundaries inside a sequence and a 64-key tile, D = 64 and 256, row
    tiles of 65 and 129 rows, a window, a soft cap, the one-pass grid."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import _split_plan
    b, kq, hq, hkv, d, t, cols, lengths, cap, window = TILE_PAGED_CASES[name]
    q, k, v, table, lens = _case(cuda, b, kq, hq, hkv, d, t, cols, lengths)
    kp, ks, vp, vs = _int8_pages(k, v)
    splits = _split_plan(b, kq, hq // hkv, hkv, cols,
                         torch.cuda.get_device_properties(cuda)
                         .multi_processor_count)[0]
    if name.startswith(("decode_split", "k4_split")):
        assert splits > 1
    if name.endswith("one_pass"):
        assert splits == 1
    args = dict(logit_soft_cap=cap, sliding_window=window)
    before = paged_attention_multi_quant.launches
    out = paged_attention_multi_quant(q, kp, vp, ks, vs, table, lens, **args)
    torch.cuda.synchronize()
    assert paged_attention_multi_quant.launches == before + 1
    _close_bf16(out, _paged_attention_multi_quant_plain(
        q, kp, vp, ks, vs, table, lens, sm_scale=d ** -0.5, **args))


def test_paged_attention_multi_quant_wrong_head_scales_miss(cuda):
    """At the 8B decode shape (split-KV): the kernel matches the plain
    version, and the plain version with each key's scales taken from the
    neighbouring kv head (the stride-Hkv indexing of the kernel's scale
    staging, one head off) does not."""
    b, kq, hq, hkv, d, t, cols, lengths, _, _ = CASES["8b_decode"]
    q, k, v, table, lens = _case(cuda, b, kq, hq, hkv, d, t, cols, lengths)
    kp, ks, vp, vs = _int8_pages(k, v)
    out = paged_attention_multi_quant(q, kp, vp, ks, vs, table, lens)
    ref = _paged_attention_multi_quant_plain(q, kp, vp, ks, vs, table, lens,
                                             sm_scale=d ** -0.5)
    _close_bf16(out, ref)
    wrong = _paged_attention_multi_quant_plain(
        q, kp, vp, ks.roll(1, dims=2).contiguous(),
        vs.roll(1, dims=2).contiguous(), table, lens, sm_scale=d ** -0.5)
    share = ((wrong.float() - ref.float()).abs()
             / (1e-4 + 1e-2 * ref.float().abs())).max().item()
    assert share > 1, share


@pytest.mark.parametrize("quant", [False, True])
def test_single_token_forms_launch_at_k1_and_match_plain(cuda, quant):
    b, _, hq, hkv, d, t, cols, lengths, _, _ = CASES["8b_decode"]
    q, k, v, table, lens = _case(cuda, b, 1, hq, hkv, d, t, cols, lengths)
    q = q[:, 0].contiguous()
    if quant:
        kp, ks, vp, vs = _int8_pages(k, v)
        pages, fn, plain = (kp, vp, ks, vs), paged_attention_quant, \
            _paged_attention_quant_plain
    else:
        pages, fn, plain = (k, v), paged_attention, _paged_attention_plain
    counts = [f.launches for f in (fn, paged_attention_multi,
                                   paged_attention_multi_quant)]
    out = fn(q, *pages, table, lens)
    torch.cuda.synchronize()
    after = [f.launches for f in (fn, paged_attention_multi,
                                  paged_attention_multi_quant)]
    assert after == [counts[0] + 1] + counts[1:]   # its own count only
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _close_bf16(out, plain(q, *pages, table, lens, sm_scale=d ** -0.5))


INT4_CASES = [(1, 256, 128), (8, 4096, 1024), (13, 688, 256),
              (16, 4096, 4096), (17, 512, 384), (300, 1024, 512)]


@pytest.mark.parametrize("rows,kin,out", INT4_CASES)
def test_int4_matmul_kernel_matches_plain(cuda, rows, kin, out):
    gen = torch.Generator().manual_seed(rows + kin)
    leaf = _quantize_leaf_int4(0.02 * torch.randn((kin, out), generator=gen))
    q4, scale = leaf["q4"].to(cuda), leaf["scale"].to(cuda)
    h = torch.randn((rows, kin), generator=gen).to(cuda, torch.bfloat16)
    before = int4_matmul.launches
    y = int4_matmul(h, q4, scale)
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (rows, out)
    # against the plain version's f32 result before its cast: the kernel
    # rounds its own f32 sum once
    _close_bf16(y, _int4_matmul_plain(h.float(), q4, scale))


def test_int4_matmul_splits_leave_no_slice_empty(cuda):
    """The C entry's split choice, which the wrapper sizes its scratch by:
    between 1 and the group count and at most 8, every slice of groups
    non-empty (the reduce adds every slice's partials), split only when
    blocks are few."""
    splits_of = int4_matmul_launchers()[1]
    for rows in (1, 8, 13, 16, 17, 300, 1024):
        for out in (128, 1024, 4096, 14336, 128256):
            for g in (1, 2, 5, 32, 112):
                s = splits_of(rows, out, g)
                per = -(-g // s)               # the kernel's groups a slice
                assert 1 <= s <= min(g, 8) and (s - 1) * per < g, \
                    (rows, out, g, s)
    assert splits_of(8, 1024, 32) > 1 and splits_of(1024, 14336, 32) == 1


def test_int4_matmul_rejects_what_it_does_not_take(cuda):
    leaf = _quantize_leaf_int4(torch.randn((256, 128)))
    q4, scale = leaf["q4"].to(cuda), leaf["scale"].to(cuda)
    h = torch.zeros((2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        int4_matmul(h.float(), q4, scale)
    with pytest.raises(ValueError, match="is on"):
        int4_matmul(h, q4.cpu(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(torch.zeros((256, 2), dtype=torch.bfloat16,
                                device=cuda).t(), q4, scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        int4_matmul(h, q4[:, :126].contiguous(), scale[..., :126]
                    .contiguous())
    leaf = _quantize_leaf_int4(torch.randn((40, 128)))   # one group of 40
    with pytest.raises(ValueError, match="multiple of 16"):
        int4_matmul(torch.zeros((2, 40), dtype=torch.bfloat16, device=cuda),
                    leaf["q4"].to(cuda), leaf["scale"].to(cuda))
    shifted = torch.zeros(2 * 256 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(2, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int4_matmul(shifted, q4, scale)


# the tile edges of both regimes: rows around the decode limit (16) and the
# 64-row warpgroup and 128-row block; out widths of the 8B model and one
# (400) that is not a multiple of the block's 128 columns; one group (in
# 128) and 112 groups (in 14336, the w_down contraction)
INT4_EDGE_ROWS = [1, 8, 16, 17, 63, 64, 65, 300, 1024]
INT4_EDGE_OUTS = [128, 400, 1024, 4096, 14336]


def _int4_plain_rows(h, q4, scale):
    """The plain version in row blocks whose (rows, groups, out) f32
    partials stay under 1 GiB."""
    step = max(1, 2**30 // (scale.shape[0] * q4.shape[1] * 4))
    return torch.cat([_int4_matmul_plain(h[r:r + step], q4, scale)
                      for r in range(0, h.shape[0], step)])


@pytest.mark.parametrize("kin", [128, 14336], ids=["groups1", "groups112"])
@pytest.mark.parametrize("out", INT4_EDGE_OUTS)
@pytest.mark.parametrize("rows", INT4_EDGE_ROWS)
def test_int4_matmul_tile_edges_match_plain(cuda, rows, out, kin):
    gen = torch.Generator(device=cuda).manual_seed(rows + out + kin)
    leaf = _quantize_leaf_int4(
        0.02 * torch.randn((kin, out), generator=gen, device=cuda))
    q4, scale = leaf["q4"], leaf["scale"]
    assert scale.shape[0] == kin // 128
    h = torch.randn((rows, kin), generator=gen, device=cuda).bfloat16()
    before = int4_matmul.launches
    y = int4_matmul(h, q4, scale)
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (rows, out)
    _close_bf16(y, _int4_plain_rows(h.float(), q4, scale))


# (experts, rows an expert, in, out, counts): both regimes (16-row tiles up
# to 64 rows an expert, 64-row tiles above), fewer live units than the
# persistent grid has blocks and more, tile edges, an expert with no row,
# one full, one past a row tile, one group of 688 in-elements
INT4_EXPERT_CASES = [
    (4, 8, 256, 128, [8, 0, 3, 5]),
    (8, 8, 4096, 1024, [2, 3, 0, 8, 1, 0, 2, 0]),
    (3, 17, 512, 400, [17, 16, 1]),
    (2, 40, 1024, 256, [40, 0]),
    (4, 300, 688, 256, [130, 0, 300, 64]),
    (8, 256, 1024, 1024, [64, 65, 128, 129, 0, 256, 255, 1]),
]


@pytest.mark.parametrize("experts,rows,kin,out,counts", INT4_EXPERT_CASES)
def test_int4_expert_matmul_kernel_matches_plain(cuda, experts, rows, kin,
                                                 out, counts):
    """One launch for every expert against the plain version on every row
    (the buffer past a count is zero, as the MoE dispatch leaves it, but
    the kernel must write zeros there however h reads), with the counts
    and at full capacity."""
    gen = torch.Generator(device=cuda).manual_seed(experts + rows + kin)
    leaves = [_quantize_leaf_int4(0.02 * torch.randn(
        (kin, out), generator=gen, device=cuda)) for _ in range(experts)]
    q4 = torch.stack([lf["q4"] for lf in leaves])
    scale = torch.stack([lf["scale"] for lf in leaves])
    h = torch.randn((experts, rows, kin), generator=gen,
                    device=cuda).bfloat16()
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    before = int4_expert_matmul.launches
    y = int4_expert_matmul(h, q4, scale, cnt)
    y_full = int4_expert_matmul(h, q4, scale)
    torch.cuda.synchronize()
    assert int4_expert_matmul.launches == before + 2
    assert y.dtype == torch.bfloat16 and y.shape == (experts, rows, out)
    _close_bf16(y, _int4_expert_matmul_plain(h.float(), q4, scale, cnt))
    _close_bf16(y_full, _int4_expert_matmul_plain(h.float(), q4, scale))
    past = torch.arange(rows, device=cuda)[None] >= cnt[:, None]
    assert torch.equal(y[past], torch.zeros_like(y[past]))
    assert torch.equal(y[~past], y_full[~past])


def test_int4_expert_matmul_is_one_launch_of_its_own(cuda):
    """The expert entry counts on its own wrapper only, and it is one
    launch with no split partials: its tile height comes from the buffer's
    rows alone, 16 up to 64 rows an expert (decode C = 8, a K = 5 verify
    C = 40) and 64 above (a prefill chunk)."""
    leaf = _quantize_leaf_int4(torch.randn((256, 128), device=cuda))
    q4 = torch.stack([leaf["q4"]] * 3)
    scale = torch.stack([leaf["scale"]] * 3)
    h = torch.zeros((3, 4, 256), dtype=torch.bfloat16, device=cuda)
    before = (int4_matmul.launches, int4_expert_matmul.launches)
    int4_expert_matmul(h, q4, scale)
    assert (int4_matmul.launches, int4_expert_matmul.launches) == \
        (before[0], before[1] + 1)
    tile_rows = _expert_launchers()[1]
    assert [tile_rows(c) for c in (1, 8, 40, 64, 65, 1024)] == \
        [16, 16, 16, 16, 64, 64]
    with pytest.raises(TypeError):
        int4_expert_matmul(h, q4, scale, torch.zeros(3, dtype=torch.int64,
                                                      device=cuda))
    with pytest.raises(ValueError, match="counts"):
        int4_expert_matmul(h, q4, scale, torch.zeros(3, dtype=torch.int32))


# the new tile's edges in both regimes, at narrow widths: (rows an expert,
# in, out, counts); each list has an expert with no row and one at C, and
# counts around the tile height (16 up to 64 rows, else 64)
INT4_EXPERT_EDGE_CASES = [
    (8, 256, 128, [0, 1, 7, 8]),
    (40, 512, 256, [0, 1, 15, 16, 17, 31, 33, 40]),
    (64, 256, 400, [64, 0, 16, 48]),
    (65, 256, 256, [0, 65, 64, 1]),
    (300, 384, 272, [0, 1, 63, 64, 65, 127, 129, 300]),
]


@pytest.mark.parametrize("rows,kin,out,counts", INT4_EXPERT_EDGE_CASES)
def test_int4_expert_matmul_tile_edges_match_plain(cuda, rows, kin, out,
                                                   counts):
    """Counts at the edges of the tile that the buffer's rows choose: every
    filled row against the plain version, the rest exactly zero, and the
    filled rows the same bytes as the launch at full capacity."""
    experts = len(counts)
    gen = torch.Generator(device=cuda).manual_seed(rows + kin + out)
    leaves = [_quantize_leaf_int4(0.02 * torch.randn(
        (kin, out), generator=gen, device=cuda)) for _ in range(experts)]
    q4 = torch.stack([lf["q4"] for lf in leaves])
    scale = torch.stack([lf["scale"] for lf in leaves])
    h = torch.randn((experts, rows, kin), generator=gen,
                    device=cuda).bfloat16()
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    y = int4_expert_matmul(h, q4, scale, cnt)
    y_full = int4_expert_matmul(h, q4, scale)
    torch.cuda.synchronize()
    _close_bf16(y, _int4_expert_matmul_plain(h.float(), q4, scale, cnt))
    _close_bf16(y_full, _int4_expert_matmul_plain(h.float(), q4, scale))
    past = torch.arange(rows, device=cuda)[None] >= cnt[:, None]
    assert torch.equal(y[past], torch.zeros_like(y[past]))
    assert torch.equal(y[~past], y_full[~past])


@pytest.mark.parametrize("rows", [8, 300])
def test_int4_expert_matmul_graph_replays_rewritten_counts(cuda, rows):
    """One launch captured in a CUDA graph reads the counts on the card at
    every replay: rewritten in place between replays, each replay equals an
    eager launch with the new counts (no host read at capture)."""
    experts, kin, out = 4, 256, 256
    gen = torch.Generator(device=cuda).manual_seed(rows)
    leaves = [_quantize_leaf_int4(0.02 * torch.randn(
        (kin, out), generator=gen, device=cuda)) for _ in range(experts)]
    q4 = torch.stack([lf["q4"] for lf in leaves])
    scale = torch.stack([lf["scale"] for lf in leaves])
    h = torch.randn((experts, rows, kin), generator=gen,
                    device=cuda).bfloat16()
    cnt = torch.tensor([rows, 0, 1, rows // 2], dtype=torch.int32,
                       device=cuda)
    int4_expert_matmul(h, q4, scale, cnt)          # built before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = int4_expert_matmul.launches
    with torch.cuda.graph(graph):
        y = int4_expert_matmul(h, q4, scale, cnt)
    assert int4_expert_matmul.launches == before + 1
    for counts in ([0, rows, rows // 2, 1], [3, 5, 0, rows]):
        cnt.copy_(torch.tensor(counts, dtype=torch.int32))
        graph.replay()
        ref = int4_expert_matmul(h, q4, scale, cnt)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), counts
        _close_bf16(y, _int4_expert_matmul_plain(h.float(), q4, scale, cnt))


# (shards, rows, in, out a shard): both regimes, split and unsplit launches,
# a shard's out not a multiple of the block's 128 columns (400, 1008), and
# llama3-8b's per-shard widths at tensor 2 and 4
INT4_SHARDED_CASES = [
    (2, 1, 256, 128), (4, 8, 4096, 256), (2, 8, 4096, 2048),
    (2, 13, 688, 400), (4, 17, 512, 1008), (4, 300, 1024, 512),
    (2, 1024, 4096, 7168), (4, 1024, 14336, 1024),
]


def _sharded_leaves(dev, shards, kin, out, seed):
    """The N shards' (in/2, out) slices of one quantized (in, N * out)
    weight, stacked: (N, in/2, out) and (N, g, 1, out); and the gathered
    weight's own q4 and scale."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaf = _quantize_leaf_int4(0.02 * torch.randn(
        (kin, shards * out), generator=gen, device=dev))
    q4 = leaf["q4"].unflatten(1, (shards, out)).movedim(1, 0).contiguous()
    scale = leaf["scale"].unflatten(2, (shards, out)).movedim(2, 0) \
        .contiguous()
    return q4, scale, leaf["q4"], leaf["scale"]


@pytest.mark.parametrize("shards,rows,kin,out", INT4_SHARDED_CASES)
def test_int4_matmul_sharded_kernel_matches_plain(cuda, shards, rows, kin,
                                                  out):
    """One launch for every shard against the plain version, and against
    row 13 on the gathered weight: the same f32 sums wherever the two
    launches split the groups alike, so the same bytes."""
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(tensor=shards))
    q4, scale, q4_all, scale_all = _sharded_leaves(cuda, shards, kin, out,
                                                   shards + rows + kin)
    h = torch.randn((rows, kin), generator=torch.Generator(
        device=cuda).manual_seed(rows), device=cuda).bfloat16()
    before = (int4_matmul.launches, int4_matmul_sharded.launches)
    y = int4_matmul_sharded(h, q4, scale, mesh)
    torch.cuda.synchronize()
    assert (int4_matmul.launches, int4_matmul_sharded.launches) == \
        (before[0], before[1] + 1)
    assert y.dtype == torch.bfloat16 and y.shape == (rows, shards * out)
    _close_bf16(y, torch.cat([_int4_plain_rows(h.float(), q4[s], scale[s])
                              for s in range(shards)], dim=1))
    g = scale.shape[1]
    same_splits = _sharded_launchers()[1](shards, rows, out, g) == \
        int4_matmul_launchers()[1](rows, shards * out, g)
    if same_splits:
        assert torch.equal(y, int4_matmul(h, q4_all, scale_all))


def test_int4_matmul_sharded_takes_a_stacked_layout_only(cuda):
    """The in-process entry wants (N, in/2, out/N) and (N, g, 1, out/N)
    stacks of the mesh's N shards; its split choice is the dense entry's
    over the gathered columns (every shard's tiles)."""
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    q4, scale, q4_all, scale_all = _sharded_leaves(cuda, 2, 256, 128, 0)
    h = torch.zeros((2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="stack"):
        int4_matmul_sharded(h, q4, scale, make_mesh(MeshConfig(tensor=4)))
    with pytest.raises(ValueError, match="stack"):
        int4_matmul_sharded(h, q4_all, scale_all,
                            make_mesh(MeshConfig(tensor=2)))
    with pytest.raises(TypeError):
        int4_matmul_sharded(h.float(), q4, scale,
                            make_mesh(MeshConfig(tensor=2)))
    splits, dense = _sharded_launchers()[1], int4_matmul_launchers()[1]
    for n, rows, out, g in ((2, 8, 2048, 32), (4, 8, 256, 32),
                            (4, 1024, 1024, 112)):
        assert splits(n, rows, out, g) == dense(rows, n * out, g)


def test_tp2_engine_matches_tp1_on_the_card(cuda):
    """tiny_llama in bf16 on the card, --int4 --kv-int8 and bf16 weights:
    the engine on an in-process tensor mesh of 2 against the one-device
    engine on the same weights. Tokens must be equal up to any first
    divergence, and there the plain f32 forward's top-2 margin must be
    under 5% of the logits' RMS (the row-parallel partial sums add in
    another order, and int4 launches split their groups by other shapes,
    so a logit moves by well under 1% of that RMS); each step launches
    int4_matmul_sharded once per projection, an n = 2 group serves
    through the dense-scratch route, and no page leaks."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    from k8s_runpod_kubelet_tpu_torch.models.quant import (dequantize,
                                                           quantize_params)

    cfg, params = _tiny_bf16(cuda)
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [3, 1, 4, 1, 5, 9, 2, 6],
               list(range(1, 40))]
    ref_model = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32),
                           "cpu")

    def f32(w):
        w = dequantize(w) if isinstance(w, dict) else w
        return w.float().cpu()

    for quant in (True, False):
        # the plain f32 forward of the weights the engines serve
        served = quantize_params(cfg, params, 4) if quant else params
        ref_params = {k: ({n: f32(x) for n, x in v.items()}
                          if k == "layers" else f32(v))
                      for k, v in served.items()}
        outs = []
        for tp in (1, 2):
            tree = {k: (v.clone() if not isinstance(v, dict) else
                        {n: x.clone() for n, x in v.items()})
                    for k, v in params.items()}
            sc = ServingConfig(slots=4, max_prefill_len=64, cache_len=256,
                               max_new_tokens=24, kv_page_tokens=16,
                               quantize_int4=quant, quantize_kv_int8=quant)
            eng = ServingEngine(cfg, tree, sc, device=cuda,
                                mesh=make_mesh(MeshConfig(tensor=tp))
                                if tp > 1 else None).start()
            try:
                before = int4_matmul_sharded.launches
                steps = eng.counters["decode_steps"] \
                    + eng.counters["paged_prefill_chunks"]
                outs.append([eng.submit(p).result(timeout=300)["tokens"]
                             for p in prompts])
                launched = int4_matmul_sharded.launches - before
                steps = eng.counters["decode_steps"] \
                    + eng.counters["paged_prefill_chunks"] - steps
                assert launched == (7 * cfg.n_layers + 1) * steps \
                    if quant and tp > 1 else launched == 0
                assert eng.debug_snapshot()["paged_tp_shards"] == tp
                # an n = 2 group: the dense-scratch route, its pages copied
                # into the (sharded) arena, both greedy members alike
                group = [f.result(timeout=300)["tokens"]
                         for f in eng.submit_group(prompts[2], 2)]
                assert group[0] == group[1] and len(group[0]) == 24
                eng.drain()
                while not eng.drained:
                    time.sleep(0.01)
                stats = eng.prefix_cache_stats()
                assert stats["pages_free"] + stats["nodes"] \
                    == stats["pages_total"]
            finally:
                eng.stop()
        for prompt, one, two in zip(prompts, *outs):
            n = next((i for i, (a, b) in enumerate(zip(one, two)) if a != b),
                     None)
            if n is None:
                assert one == two
                continue
            ctx = torch.tensor([prompt + one[:n]])
            logits = ref_model.forward(ref_params, ctx)[0, -1]
            top2 = logits.topk(2).values
            rms = logits.pow(2).mean().sqrt()
            assert top2[0] - top2[1] < 0.05 * rms, (quant, prompt, n)


# -- MLA latent attention ------------------------------------------------------------

MLA_CASES = {
    # name: (B, K, Hq, R, Dr, T, table cols, lengths)
    "mla8b_decode": (8, 1, 32, 512, 64, 16, 128,
                     [252, 402, 475, 468, 411, 789, 881, 571]),
    "mla8b_k4": (4, 4, 32, 512, 64, 16, 64, [4, 17, 333, 1000]),
    "mla8b_chunk": (1, 300, 32, 512, 64, 16, 64, [300 + 37]),
    "t8_ragged_rows": (3, 5, 6, 512, 64, 8, 12, [5, 41, 96]),
    "t32_large_tile": (2, 3, 16, 512, 64, 32, 8, [3, 200]),
}


def _mla_case(dev, b, kq, hq, r, dr, t, cols, lengths, seed=0):
    """f32 queries, bf16 latent pages in random order; entries past
    ceil(len/T) name pages of large finite garbage."""
    gen = torch.Generator().manual_seed(seed)
    live = [-(-n // t) for n in lengths]
    n_pages = sum(live) + 8
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[torch.arange(cols - live[i]) % 8]
    c = torch.randn((n_pages, t, r), generator=gen)
    kr = torch.randn((n_pages, t, dr), generator=gen)
    c[garbage], kr[garbage] = 3e4, -3e4
    q_lat = torch.randn((b, kq, hq, r), generator=gen)
    q_rope = torch.randn((b, kq, hq, dr), generator=gen)
    return (q_lat.to(dev), q_rope.to(dev), c.to(dev, torch.bfloat16),
            kr.to(dev, torch.bfloat16), table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _close_f32(out, ref):
    """The kernel and the plain version both compute in f32 from the same
    inputs; they differ by sum order only."""
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(MLA_CASES))
def test_paged_attention_multi_mla_kernels_match_plain(cuda, name, quant):
    b, kq, hq, r, dr, t, cols, lengths = MLA_CASES[name]
    q_lat, q_rope, c, kr, table, lens = _mla_case(cuda, b, kq, hq, r, dr, t,
                                                  cols, lengths)
    if quant:
        (c, cs), (kr, ks) = _kv_quant(c), _kv_quant(kr)
        pages, fn, plain = (c, kr, cs, ks), paged_attention_multi_mla_quant, \
            _paged_attention_multi_mla_quant_plain
    else:
        pages, fn, plain = (c, kr), paged_attention_multi_mla, \
            _paged_attention_multi_mla_plain
    scale = (128 + dr) ** -0.5
    before = fn.launches
    out = fn(q_lat, q_rope, *pages, table, lens, sm_scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q_lat.shape
    _close_f32(out, plain(q_lat, q_rope, *pages, table, lens,
                          sm_scale=scale))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_single_token_mla_forms_launch_at_k1_and_match_plain(cuda, quant):
    b, _, hq, r, dr, t, cols, lengths = MLA_CASES["mla8b_decode"]
    q_lat, q_rope, c, kr, table, lens = _mla_case(cuda, b, 1, hq, r, dr, t,
                                                  cols, lengths, seed=1)
    q_lat, q_rope = q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous()
    if quant:
        (c, cs), (kr, ks) = _kv_quant(c), _kv_quant(kr)
        pages, fn, plain = (c, kr, cs, ks), paged_attention_mla_quant, \
            _paged_attention_mla_quant_plain
    else:
        pages, fn, plain = (c, kr), paged_attention_mla, \
            _paged_attention_mla_plain
    others = (paged_attention_multi_mla, paged_attention_multi_mla_quant)
    counts = [f.launches for f in (fn, *others)]
    out = fn(q_lat, q_rope, *pages, table, lens)
    torch.cuda.synchronize()
    after = [f.launches for f in (fn, *others)]
    assert after == [counts[0] + 1] + counts[1:]   # its own count only
    assert out.shape == q_lat.shape and out.dtype == torch.float32
    _close_f32(out, plain(q_lat, q_rope, *pages, table, lens,
                          sm_scale=(r + dr) ** -0.5))


def test_mla_kernels_reject_what_they_do_not_take(cuda):
    q_lat, q_rope, c, kr, table, lens = _mla_case(cuda, 1, 1, 4, 384, 64, 16,
                                                  2, [5])
    with pytest.raises(ValueError, match="latent"):
        paged_attention_multi_mla(q_lat, q_rope, c, kr, table, lens)
    q_lat, q_rope, c, kr, table, lens = _mla_case(cuda, 1, 2, 4, 512, 64, 16,
                                                  2, [5])
    with pytest.raises(TypeError):
        paged_attention_multi_mla(q_lat.bfloat16(), q_rope, c, kr, table,
                                  lens)
    with pytest.raises(TypeError):
        paged_attention_multi_mla(q_lat, q_rope, c.float(), kr, table, lens)
    with pytest.raises(TypeError):
        paged_attention_multi_mla(q_lat, q_rope, c, kr, table.long(), lens)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_multi_mla(q_lat, q_rope, c[:, :12].contiguous(),
                                  kr[:, :12].contiguous(), table, lens)


# the MLA tile edges: K = 1 decode over ragged lengths with split-KV (8 and 5
# one-tile sequences), and row counts (K x Hq) that are not a multiple of the
# 64-row tile
MLA_EDGES = {
    # name: (B, K, Hq, T, table cols, lengths)
    "decode_split_hq32": (8, 1, 32, 16, 128,
                          [1, 16, 17, 252, 881, 1000, 2047, 2048]),
    "decode_split_hq16": (5, 1, 16, 16, 64, [3, 100, 511, 512, 1024]),
    "rows96": (2, 3, 32, 16, 16, [3, 200]),
    "rows30_t8": (1, 5, 6, 8, 24, [100]),
    "rows70_t32": (3, 7, 10, 32, 20, [7, 50, 320]),
    "rows64": (4, 2, 32, 16, 64, [2, 33, 600, 1024]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(MLA_EDGES))
def test_mla_kernel_tile_edges_match_plain(cuda, name, quant):
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (_mla_split_plan,
                                                            _sm_count)

    b, kq, hq, t, cols, lengths = MLA_EDGES[name]
    q_lat, q_rope, c, kr, table, lens = _mla_case(cuda, b, kq, hq, 512, 64,
                                                  t, cols, lengths, seed=3)
    if name.startswith("decode_split"):
        assert _mla_split_plan(b, kq, hq, cols, _sm_count(0))[0] > 1
    if quant:
        (c, cs), (kr, ks) = _kv_quant(c), _kv_quant(kr)
        pages, fn, plain = (c, kr, cs, ks), paged_attention_multi_mla_quant, \
            _paged_attention_multi_mla_quant_plain
    else:
        pages, fn, plain = (c, kr), paged_attention_multi_mla, \
            _paged_attention_multi_mla_plain
    scale = (128 + 64) ** -0.5
    before = fn.launches
    out = fn(q_lat, q_rope, *pages, table, lens, sm_scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(out).all()
    _close_f32(out, plain(q_lat, q_rope, *pages, table, lens,
                          sm_scale=scale))


# -- the page walk stays inside the table --------------------------------------------

def test_paged_kernels_never_read_past_the_table(cuda):
    """Every paged wrapper (bf16 and int8 pages, bf16 and int8 latents,
    multi-token and single-token forms) with lengths past the table's cols
    x T positions: the kernels must read the table's columns and no
    further. The table is a view of the first B rows of a (B + 1, cols)
    tensor whose extra row names a page of NaN (NaN scales for int8), so a
    read past a sequence's row lands on the next sequence's first page or,
    for the last sequence, on the NaN page; each result is held against the
    plain version, whose gathered view holds only the table's positions."""
    b, t, cols = 3, 16, 4
    lengths = [cols * t + 5, cols * t + 40, 3 * cols * t]
    gen = torch.Generator().manual_seed(21)
    n_pages = b * cols + 1
    nan_page = n_pages - 1
    full = torch.empty((b + 1, cols), dtype=torch.int32)
    full[:b] = torch.randperm(b * cols, generator=gen).reshape(b, cols)
    full[b] = nan_page
    table = full.to(cuda)[:b]
    assert table.is_contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)

    hq, hkv, d, kq = 8, 2, 128, 4
    k, v = (torch.randn((n_pages, t, hkv, d), generator=gen)
            for _ in range(2))
    k[nan_page], v[nan_page] = float("nan"), float("nan")
    k, v = (x.to(cuda, torch.bfloat16) for x in (k, v))
    kp, ks, vp, vs = _int8_pages(k, v)
    ks[nan_page], vs[nan_page] = float("nan"), float("nan")
    q = torch.randn((b, kq, hq, d), generator=gen).to(cuda, torch.bfloat16)
    dense = [
        (paged_attention_multi, _paged_attention_multi_plain, q, (k, v)),
        (paged_attention_multi_quant, _paged_attention_multi_quant_plain, q,
         (kp, vp, ks, vs)),
        (paged_attention, _paged_attention_plain, q[:, 0].contiguous(),
         (k, v)),
        (paged_attention_quant, _paged_attention_quant_plain,
         q[:, 0].contiguous(), (kp, vp, ks, vs))]
    for fn, plain, qx, pages in dense:
        before = fn.launches
        out = fn(qx, *pages, table, lens)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.isfinite(out.float()).all(), fn.__name__
        _close_bf16(out, plain(qx, *pages, table, lens, sm_scale=d ** -0.5))

    hq, r, dr = 4, 512, 64
    c = torch.randn((n_pages, t, r), generator=gen)
    kr = torch.randn((n_pages, t, dr), generator=gen)
    c[nan_page], kr[nan_page] = float("nan"), float("nan")
    c, kr = c.to(cuda, torch.bfloat16), kr.to(cuda, torch.bfloat16)
    (cq, cs), (krq, krs) = _kv_quant(c), _kv_quant(kr)
    cs[nan_page], krs[nan_page] = float("nan"), float("nan")
    q_lat = torch.randn((b, kq, hq, r), generator=gen).to(cuda)
    q_rope = torch.randn((b, kq, hq, dr), generator=gen).to(cuda)
    single = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous())
    latent = [
        (paged_attention_multi_mla, _paged_attention_multi_mla_plain,
         (q_lat, q_rope), (c, kr)),
        (paged_attention_multi_mla_quant,
         _paged_attention_multi_mla_quant_plain, (q_lat, q_rope),
         (cq, krq, cs, krs)),
        (paged_attention_mla, _paged_attention_mla_plain, single, (c, kr)),
        (paged_attention_mla_quant, _paged_attention_mla_quant_plain, single,
         (cq, krq, cs, krs))]
    scale = (r + dr) ** -0.5
    for fn, plain, qs, pages in latent:
        before = fn.launches
        out = fn(*qs, *pages, table, lens, sm_scale=scale)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.isfinite(out).all(), fn.__name__
        _close_f32(out, plain(*qs, *pages, table, lens, sm_scale=scale))


# -- speculative verification on the card ----------------------------------------

def _tiny_bf16(dev, vocab=128):
    from k8s_runpod_kubelet_tpu_torch.models import init_params, tiny_llama

    cfg = tiny_llama(vocab_size=vocab, embed_dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=256, max_seq_len=512)
    return cfg, init_params(cfg, torch.Generator(dev).manual_seed(0), dev)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_verify_step_n_tokens_mix_matches_the_cpu(cuda, quant):
    """paged_verify_step at K = 5, B = 8 with a mix of n_tokens (5 for a
    greedy slot, 1 for a sampled one, 0 inactive): the rows each slot
    commits match the same step's plain path on the CPU, one kernel launch
    a layer, and rows past n_tokens leave their table's pages unwritten."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel

    cfg, params = _tiny_bf16(cuda)
    kernel = paged_attention_multi_quant if quant else paged_attention_multi
    b, kk, t, cols = 8, 5, 16, 8
    gen = torch.Generator().manual_seed(3)
    lengths = torch.tensor([0, 3, 16, 17, 40, 60, 77, 100], dtype=torch.int32)
    n_tokens = torch.tensor([5, 1, 5, 0, 3, 5, 1, 5], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b, kk), generator=gen,
                           dtype=torch.int32)
    table = torch.randperm(b * cols, generator=gen).to(torch.int32) \
        .reshape(b, cols)
    outs = []
    for dev in ("cpu", cuda):
        model = LlamaModel(cfg, dev)
        arena = model.init_paged_arena(b * cols, t, quantize=quant)
        for i, (name, a) in enumerate(sorted(arena.items())):
            g = torch.Generator().manual_seed(i)   # the same on both
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-127, 128, a.shape, generator=g,
                                      dtype=torch.int8))
            elif name.endswith("scale"):
                a.copy_(torch.rand(a.shape, generator=g) * 0.02 + 0.005)
            else:
                a.copy_(torch.randn(a.shape, generator=g))
        p = {k: (v.to(dev) if not isinstance(v, dict) else
                 {n: x.to(dev) for n, x in v.items()})
             for k, v in params.items()}
        before = kernel.launches
        logits, arena = model.paged_verify_step(
            p, tokens.to(dev), arena, table.to(dev), lengths.to(dev),
            n_tokens=n_tokens.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert kernel.launches == before + cfg.n_layers
        outs.append((logits.float().cpu(),
                     {k: v.cpu() for k, v in arena.items()}))
    (cpu_logits, cpu_arena), (gpu_logits, gpu_arena) = outs
    for i in range(b):
        n = int(n_tokens[i])
        if n:
            ref = cpu_logits[i, :n]
            rel = (gpu_logits[i, :n] - ref).norm() / ref.norm()
            assert rel < 3e-2, (i, float(rel))
    k_cpu, k_gpu = cpu_arena["k"].float(), gpu_arena["k"].float()
    for i in range(b):
        for j in range(int(n_tokens[i]), kk):
            pos = int(lengths[i]) + j
            page = int(table[i, pos // t])
            # a dropped row leaves its page's slot as the seed wrote it
            assert torch.equal(k_gpu[:, page, pos % t],
                               k_cpu[:, page, pos % t])


def test_speculative_engine_matches_plain_on_the_card(cuda):
    """tiny_llama in bf16 on the card: the speculate_k=3 engine against the
    plain one on repetitive, hostile and sampled prompts. Tokens must be
    equal up to any first divergence, and there the plain f32 forward's
    top-2 margin must be under 5% of the logits' RMS: the K-wide and
    1-wide steps round differently in bf16 (GEMM shapes, split-KV plans),
    which moves a logit by well under 1% of that RMS on this model, so
    only a near-tie may flip."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg, params = _tiny_bf16(cuda)
    sc = dict(slots=4, max_prefill_len=64, cache_len=256, max_new_tokens=32,
              kv_page_tokens=16)
    rep = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
    hostile = [3, 1, 4, 1, 5, 9, 2, 6, 8, 10]
    sampled = dict(temperature=0.8, seed=7)
    reqs = [(rep, {}), (hostile, {}), ([11, 12, 13] * 3, sampled)]
    outs, counters = [], None
    for k in (3, 0):
        eng = ServingEngine(cfg, params, ServingConfig(**sc, speculate_k=k),
                            device=cuda).start()
        try:
            outs.append([eng.submit(p, **kw).result(timeout=300)["tokens"]
                         for p, kw in reqs])
            if k:
                counters = dict(eng.counters)
            eng.drain()
            while not eng.drained:
                time.sleep(0.01)
            stats = eng.prefix_cache_stats()
            assert stats["pages_free"] + stats["nodes"] \
                == stats["pages_total"]
        finally:
            eng.stop()
    assert counters["paged_speculative_steps"] > 0
    assert counters["spec_accepted"] > 0
    ref_model = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32),
                           "cpu")
    ref_params = {k: (v.float().cpu() if not isinstance(v, dict) else
                      {n: x.float().cpu() for n, x in v.items()})
                  for k, v in params.items()}
    for (prompt, kw), spec, plain in zip(reqs, *outs):
        if kw:
            continue   # sampled: reported by the chip smoke, not gated
        n = next((i for i, (a, b) in enumerate(zip(spec, plain)) if a != b),
                 None)
        if n is None:
            assert spec == plain
            continue
        ctx = torch.tensor([prompt + plain[:n]])
        logits = ref_model.forward(ref_params, ctx)[0, -1]
        top2 = logits.topk(2).values
        rms = logits.pow(2).mean().sqrt()
        assert top2[0] - top2[1] < 0.05 * rms, (prompt, n)


# -- the engine's step graphs on the card ------------------------------------------

def _graph_model(dev, kind):
    """A tiny model of each arena and weight type the engines serve, bf16
    on the card at widths the kernels take: (model, params, arena)."""
    from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, init_params,
                                                     tiny_mla, tiny_moe)
    from k8s_runpod_kubelet_tpu_torch.models.quant import (
        init_quantized_params, quantize_params)

    if kind == "moe_int4":   # int4 experts over a bf16 arena, as Mixtral's
        cfg = tiny_moe(vocab_size=128, embed_dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=256, max_seq_len=512)
        params = init_quantized_params(
            cfg, torch.Generator(dev).manual_seed(0), 4, dev)
    elif kind.startswith("mla"):
        cfg = tiny_mla(vocab_size=128, embed_dim=256, n_layers=2, n_heads=4,
                       head_dim=64, mla_latent_dim=512, mla_rope_dim=64,
                       mlp_dim=256, max_seq_len=512)
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    else:
        cfg, params = _tiny_bf16(dev)
    if kind == "int4":
        params = quantize_params(cfg, params, bits=4)
    model = LlamaModel(cfg, dev)
    arena = model.init_paged_arena(GRAPH_SLOTS * GRAPH_COLS + 4, 16,
                                   quantize=kind in ("int8", "int4",
                                                     "mla_int8"))
    gen = torch.Generator().manual_seed(1)
    for name, a in sorted(arena.items()):
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  dtype=torch.int8))
        elif name.endswith("scale"):
            a.copy_(torch.rand(a.shape, generator=gen) * 0.02 + 0.005)
        else:
            a.copy_(torch.randn(a.shape, generator=gen))
    return model, params, arena


GRAPH_SLOTS, GRAPH_COLS = 4, 8
GRAPH_KINDS = ["bf16", "int8", "int4", "mla", "mla_int8", "moe_int4"]


def _graph_steps(width, vocab, seed=0):
    """Two steps' host values (numpy): slot 1 crosses into a page only the
    second step's table names, slot 2 is inactive."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 16
    lengths = np.array([3, 2 * t - width, 40, 70], np.int32)
    active = np.array([True, True, False, True])
    n_tokens = np.array([width, width, 0, 1], np.int32)
    perm = rng.permutation(GRAPH_SLOTS * GRAPH_COLS).astype(np.int32) \
        .reshape(GRAPH_SLOTS, GRAPH_COLS)
    out = []
    for _ in range(2):
        live = -(-(lengths + n_tokens) // t)
        tables = np.where(np.arange(GRAPH_COLS)[None] < live[:, None], perm,
                          0).astype(np.int32)
        out.append((rng.integers(0, vocab, (GRAPH_SLOTS, width))
                    .astype(np.int32), lengths.copy(), tables, active,
                    n_tokens))
        lengths = lengths + n_tokens
    return out


def _eager_verify(model, params, arena, step):
    dev = model.device
    tokens, lengths, tables, active, n_tokens = (
        torch.from_numpy(x).to(dev) for x in step)
    logits, _ = model.paged_verify_step(params, tokens, arena, tables,
                                        lengths, active, n_tokens)
    return logits


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_step_graph_replay_matches_eager(cuda, kind):
    """The width-1 and width-4 graphs (one pool) against the eager
    paged_verify_step on an arena copy, over two steps whose tokens,
    lengths and one table page change: logits and every arena page but
    the sink bit-identical (the same kernels on the same inputs), and
    each replay counts the capture's launches."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        StepGraph

    model, params, arena = _graph_model(cuda, kind)
    ref_arena = {k: v.clone() for k, v in arena.items()}
    pool = torch.cuda.graph_pool_handle()
    graphs = {w: StepGraph(model, w, GRAPH_SLOTS, GRAPH_COLS)
              for w in (1, 4)}
    for g in graphs.values():
        g.capture(params, arena, pool)
    for w, g in graphs.items():
        for step in _graph_steps(w, model.cfg.vocab_size, seed=w):
            before = rms_norm.launches
            got = g.run(params, arena, *step).clone()
            assert rms_norm.launches - before \
                == g.launches_per_replay["rms_norm"] > 0
            ref = _eager_verify(model, params, ref_arena, step)
            torch.cuda.synchronize()
            assert torch.equal(got, ref[:, 0] if w == 1 else ref), (kind, w)
            # every page but the sink: the capture's warm-up wrote only
            # there, and dropped rows of several slots land on one sink
            # row in no set order
            for name in arena:
                assert torch.equal(arena[name][:, :-1],
                                   ref_arena[name][:, :-1]), name
        assert g.captures == 1 and g.replays == 2
    per = graphs[1].launches_per_replay
    n_layers = model.cfg.n_layers
    main = {"bf16": "paged_attention_multi", "int8":
            "paged_attention_multi_quant", "int4":
            "paged_attention_multi_quant", "mla": "paged_attention_multi_mla",
            "mla_int8": "paged_attention_multi_mla_quant",
            "moe_int4": "paged_attention_multi"}[kind]
    assert per[main] == n_layers
    assert per["int4_matmul"] == {"int4": 7 * n_layers + 1,
                                  "moe_int4": 4 * n_layers + 1}.get(kind, 0)
    assert per["int4_expert_matmul"] == \
        (3 * n_layers if kind == "moe_int4" else 0)
    assert per["rms_norm"] == (3 if kind.startswith("mla") else 2) \
        * n_layers + 1
    assert sum(per.values()) == per[main] + per["int4_matmul"] \
        + per["int4_expert_matmul"] + per["rms_norm"]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_step_graph_counts_match_the_profiler(cuda, kind):
    """One replay traced by torch.profiler: the kernels counted by name
    equal the launches the capture recorded for each wrapper."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import (
        KERNEL_NAMES, StepGraph)
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        kernel_counts

    model, params, arena = _graph_model(cuda, kind)
    g = StepGraph(model, 4, GRAPH_SLOTS, GRAPH_COLS)
    g.capture(params, arena)
    step = _graph_steps(4, model.cfg.vocab_size)[0]
    g.run(params, arena, *step)
    seen = kernel_counts(lambda: g.run(params, arena, *step))
    want = {w: g.launches_per_replay[w] for w in KERNEL_NAMES}
    assert seen == want, (seen, want)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_step_graph_kernel_nodes_match_the_capture(cuda, kind):
    """The captured graph's kernel nodes counted by name
    (``kernels_in_graph``, from the graph's own description) equal the
    launches the capture recorded for each wrapper, and what a profiler
    trace of one replay counts in a fresh process."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import (
        KERNEL_NAMES, StepGraph)
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        kernel_counts

    model, params, arena = _graph_model(cuda, kind)
    g = StepGraph(model, 4, GRAPH_SLOTS, GRAPH_COLS)
    g.capture(params, arena)
    want = {w: g.launches_per_replay[w] for w in KERNEL_NAMES}
    assert sum(want.values()) > 0
    assert g.kernels_in_graph() == want
    step = _graph_steps(4, model.cfg.vocab_size)[0]
    g.run(params, arena, *step)
    assert g.kernels_in_graph() == want        # a replay changes no node
    assert kernel_counts(lambda: g.run(params, arena, *step)) == want


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_step_graph_with_adapters_matches_eager(cuda, kind):
    """Multi-LoRA stacks (all seven targets, 4 adapters, rank 8) with a
    mixed batch of ids (0 included): the width-1 and width-4 replays
    against the eager paged_verify_step with the same stacks and ids,
    logits bit-identical, and the same counted launches as the graph
    without adapters; the adapters move the logits, the base slot's stay
    the base step's."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        StepGraph
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        lora_stacks

    model, params, arena = _graph_model(cuda, kind)
    ref_arena = {k: v.clone() for k, v in arena.items()}
    stacks = lora_stacks(model.cfg, 8, ("wq", "wk", "wv", "wo", "w_gate",
                                        "w_up", "w_down"),
                         torch.Generator(cuda).manual_seed(2), cuda)
    ids = np.array([1, 0, 3, 4], np.int32)
    ids_dev = torch.from_numpy(ids).to(cuda)
    pool = torch.cuda.graph_pool_handle()
    for w in (1, 4):
        plain = StepGraph(model, w, GRAPH_SLOTS, GRAPH_COLS)
        plain.capture(params, {k: v.clone() for k, v in arena.items()},
                      pool)
        g = StepGraph(model, w, GRAPH_SLOTS, GRAPH_COLS)
        g.capture(params, arena, pool, stacks)
        assert g.launches_per_replay == plain.launches_per_replay
        for step in _graph_steps(w, model.cfg.vocab_size, seed=w):
            got = g.run(params, arena, *step, adapters=stacks,
                        adapter_ids=ids).clone()
            tokens, lengths, tables, active, n_tokens = (
                torch.from_numpy(np.asarray(x)).to(cuda) for x in step)
            before = {k: v.clone() for k, v in ref_arena.items()}
            ref, _ = model.paged_verify_step(
                params, tokens, ref_arena, tables, lengths, active,
                n_tokens, adapters=stacks, adapter_ids=ids_dev)
            base, _ = model.paged_verify_step(params, tokens, before,
                                              tables, lengths, active,
                                              n_tokens)
            torch.cuda.synchronize()
            assert torch.equal(got, ref[:, 0] if w == 1 else ref), (kind, w)
            assert (ref[0] - base[0]).abs().max() > 1e-3
            assert torch.equal(ref[1], base[1])      # slot 1 is the base
        assert g.captures == 1 and g.replays == 2


def test_adapter_registration_never_recaptures(cuda):
    """tiny_llama bf16 engine with --lora-rank 8 over all seven targets on
    the card: adapters registered after the captures (a new one, then a
    rewrite) serve at once, no graph is captured twice, the rewrite's
    tokens equal a fresh engine's with that adapter, and an adapter's
    tokens differ from the base's."""
    from k8s_runpod_kubelet_tpu_torch.models import LoraConfig, apply_lora
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg, params = _tiny_bf16(cuda)
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def adapter(seed):
        tree = apply_lora(cfg, params, LoraConfig(rank=8, targets=targets),
                          torch.Generator(cuda).manual_seed(seed), cuda)
        for t in targets:
            b = tree["layers"][t]["lora_b"]
            b.copy_(torch.randn(b.shape, generator=torch.Generator(cuda)
                                .manual_seed(seed + 50), device=cuda) * 0.2)
        return tree

    def engine(**ads):
        eng = ServingEngine(cfg, params, ServingConfig(
            slots=4, max_prefill_len=64, cache_len=256, max_new_tokens=12,
            kv_page_tokens=16, speculate_k=3, lora_rank=8,
            lora_targets=targets, max_adapters=3), device=cuda)
        for name, ad in ads.items():
            eng.register_adapter(name, ad)
        return eng.start()

    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7], [3, 1, 4, 1, 5, 9, 2, 6]]
    eng = engine(a1=adapter(1))
    fresh = engine(a1=adapter(3))
    try:
        def serve(e, name):
            # greedy requests take the verify graph, a sampled one alone
            # the decode graph
            return [e.submit(p, adapter=name, **kw).result(timeout=300)[
                "tokens"] for p in prompts
                for kw in ({}, {"temperature": 0.8, "seed": 1})]

        base, first = serve(eng, ""), serve(eng, "a1")
        assert eng.register_adapter("a2", adapter(2)) == 2
        assert eng.register_adapter("a1", adapter(3)) == 1
        rewritten, second = serve(eng, "a1"), serve(eng, "a2")
        want = serve(fresh, "a1")
        graphs = eng.debug_snapshot()["graphs"]
    finally:
        eng.stop()
        fresh.stop()
    assert first != base and second != base
    assert rewritten == want != first
    for name in ("paged_step", "paged_verify"):
        assert graphs[name]["compiles"] == 1, graphs
        assert graphs[name]["recompiles"] == 0 and graphs[name]["replays"]


def test_engine_recovers_without_recapture(cuda):
    """tiny_llama bf16 on the card: a step that fails fails its request,
    the arena stays in place (zeroed), the engine serves the same greedy
    tokens again, and neither graph was captured twice."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg, params = _tiny_bf16(cuda)
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=4, max_prefill_len=64, cache_len=256, max_new_tokens=16,
        kv_page_tokens=16, speculate_k=3), device=cuda).start()
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6, 7], [3, 1, 4, 1, 5, 9, 2, 6]]
    try:
        ref = [eng.submit(p).result(timeout=300)["tokens"] for p in prompts]
        old = eng._kv_store
        ptrs = {k: v.data_ptr() for k, v in old.arena.items()}
        commit = eng._commit_decode

        def boom(logits):
            eng._commit_decode = commit
            raise RuntimeError("injected step failure")

        eng._commit_decode = boom
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit([9, 9, 9], temperature=0.8, seed=1).result(timeout=300)
        deadline = time.monotonic() + 60
        while eng._kv_store is old and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng._kv_store is not old
        assert {k: v.data_ptr() for k, v in eng._kv_store.arena.items()} \
            == ptrs
        again = [eng.submit(p).result(timeout=300)["tokens"]
                 for p in prompts]
        graphs = eng.debug_snapshot()["graphs"]
    finally:
        eng.stop()
    assert again == ref
    assert eng.counters["engine_errors"] == 1
    for name in ("paged_step", "paged_verify"):
        assert graphs[name]["compiles"] == 1, graphs
        assert graphs[name]["recompiles"] == 0 and graphs[name]["replays"]


# -- the dense-scratch route and embeddings on the card ------------------------------

def test_dense_route_first_logits_match_eager_paged_prefill(cuda):
    """tiny_llama bf16 on the card: the dense route's prefill (the flash
    kernel, one launch a layer) gives the last-token logits of an eager
    ``paged_prefill_chunk_step`` over the same prompt within 2% relative
    L2 (the two bf16 paths round at other places), the same layer-0 K/V
    rows bit for bit (both quantize nothing and compute them with the same
    GEMMs), and an n = 2 greedy group from it decodes through the step
    graph with no recapture; ``embed`` launches the flash kernel once a
    layer and lands within 2% of a plain f32 forward's pooled state."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg, params = _tiny_bf16(cuda)
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=2, max_prefill_len=128, cache_len=256, max_new_tokens=8,
        kv_page_tokens=16), device=cuda).start()
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 128, (100,), generator=gen).tolist()
    try:
        f0, r0 = flash_fwd.launches, rms_norm.launches
        logits, single, matched = eng._prefill_tokens(prompt,
                                                      single_only=True)
        torch.cuda.synchronize()
        assert matched == 0 and isinstance(single, dict)
        assert flash_fwd.launches - f0 == cfg.n_layers
        assert rms_norm.launches - r0 == 2 * cfg.n_layers + 1
        model = eng.model
        arena = model.init_paged_arena(8, 16)
        table = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
        table[0, :7] = torch.arange(7)
        want, _, _ = model.paged_prefill_chunk_step(
            params, torch.tensor([prompt], device=cuda), arena, table,
            torch.zeros(1, dtype=torch.int32, device=cuda),
            torch.tensor([100], dtype=torch.int32, device=cuda))
        rel = ((logits - want).norm() / want.norm()).item()
        assert rel <= 2e-2, rel
        paged_k = arena["k"][0, :7].reshape(112, *arena["k"].shape[3:])
        assert torch.equal(single["k"][0, 0, :100], paged_k[:100])
        outs = [f.result(timeout=300)["tokens"]
                for f in eng.submit_group(prompt, 2)]
        assert outs[0] == outs[1] and len(outs[0]) == 8
        f0 = flash_fwd.launches
        vec = torch.tensor(eng.embed(prompt[:64]))
        assert flash_fwd.launches - f0 == cfg.n_layers
        # the plain f32 forward runs on the CPU (the kernels take bf16)
        ref_model = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32),
                               "cpu")
        ref = ref_model.forward(
            {k: v.float().cpu() if not isinstance(v, dict) else
             {n: x.float().cpu() for n, x in v.items()}
             for k, v in params.items()},
            torch.tensor([prompt[:64]]), return_hidden=True)[0].mean(dim=0)
        assert torch.isfinite(vec).all()
        assert ((vec - ref).norm() / ref.norm()).item() <= 2e-2
        graphs = eng.graphs_snapshot()
    finally:
        eng.stop()
    assert graphs["paged_step"]["compiles"] == 1
    assert graphs["paged_step"]["recompiles"] == 0


# -- the other dense families on the card ---------------------------------------------

FAMILY_CFGS = {
    "gemma": dict(n_heads=2, n_kv_heads=2, head_dim=256, tie_embeddings=True,
                  mlp_activation="gelu_tanh", embed_scale=True,
                  norm_zero_centered=True),
    "window": dict(n_heads=4, n_kv_heads=2, head_dim=64, sliding_window=40),
    "qkv_bias": dict(n_heads=7, n_kv_heads=1, head_dim=64, qkv_bias=True),
    "qk_norm": dict(n_heads=4, n_kv_heads=2, head_dim=128, qk_norm=True),
}


@pytest.mark.parametrize("name", sorted(FAMILY_CFGS))
def test_family_steps_on_the_card_match_the_cpu(cuda, name):
    """A tiny config of each family in bf16, its biases, q/k norms and
    zero-centered norms drawn away from identity: a 100-token chunk and
    three decode steps on the card (the paged kernel once a layer, the
    norm kernel 2L + 1 times a step, 4L + 1 with the q/k norm) against the
    same steps on the CPU, logits within 3e-2 relative L2; then the
    decode step as a step graph replayed equals the eager step."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.models.llama import tiny_llama
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        StepGraph

    cfg = tiny_llama(vocab_size=512, embed_dim=256, n_layers=2,
                     mlp_dim=512, max_seq_len=512, **FAMILY_CFGS[name])
    gen = torch.Generator().manual_seed(1)
    params = init_params_cpu(cfg, gen)
    b, t, cols = 2, 16, 16
    table = torch.arange(b * cols, dtype=torch.int32).reshape(b, cols)
    chunk = torch.randint(0, cfg.vocab_size, (b, 100), generator=gen,
                          dtype=torch.int32)
    norms = (4 if cfg.qk_norm else 2) * cfg.n_layers + 1

    def run(dev, tokens=None):
        """The chunk, then three decode steps fed ``tokens`` (default: the
        greedy tokens of this run); returns (logits of each step, tokens
        fed, model, params on dev, arena, lengths)."""
        model = LlamaModel(cfg, dev)
        p = {k: (v.to(dev) if not isinstance(v, dict) else
                 {n: x.to(dev) for n, x in v.items()})
             for k, v in params.items()}
        arena = model.init_paged_arena(b * cols, t)
        lengths = torch.zeros(b, dtype=torch.int32, device=dev)
        logits, arena, lengths = model.paged_prefill_chunk_step(
            p, chunk.to(dev), arena, table.to(dev), lengths,
            torch.full((b,), 100, dtype=torch.int32, device=dev))
        steps, fed = [logits.float().cpu()], []
        for i in range(3):
            tok = (steps[-1].argmax(-1).to(torch.int32) if tokens is None
                   else tokens[i])
            fed.append(tok)
            logits, arena, lengths = model.paged_decode_step(
                p, tok.to(dev), arena, table.to(dev), lengths)
            steps.append(logits.float().cpu())
        return steps, fed, model, p, arena, lengths

    cpu_steps, fed, _, _, _, _ = run("cpu")
    n0, r0 = paged_attention_multi.launches, rms_norm.launches
    steps, _, model, p, arena, lengths = run(cuda, fed)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches - n0 == 4 * cfg.n_layers
    assert rms_norm.launches - r0 == 4 * norms
    for ref, got in zip(cpu_steps, steps):
        assert float((got - ref).norm() / ref.norm()) < 3e-2
    graph = StepGraph(model, 1, b, cols)
    graph.capture(p, arena)
    assert graph.launches_per_replay["rms_norm"] == norms
    host = (steps[-1].argmax(-1).to(torch.int32).numpy(),
            lengths.cpu().numpy(), table.numpy(), [True] * b)
    copy = {k: v.clone() for k, v in arena.items()}
    got = graph.run(p, arena, *host).clone()
    want, _, _ = model.paged_decode_step(
        p, torch.from_numpy(host[0]).to(cuda), copy, table.to(cuda), lengths)
    assert torch.equal(got, want)


def init_params_cpu(cfg, gen):
    """bf16 params of ``cfg`` on the CPU with their branch leaves drawn
    away from identity: biases N(0, 0.5^2), q/k norms U(0.5, 1.5),
    zero-centered norms N(0, 0.3^2)."""
    from k8s_runpod_kubelet_tpu_torch.models import init_params

    params = init_params(cfg, gen, "cpu")
    lp = params["layers"]
    for name in ("wq_b", "wk_b", "wv_b"):
        if name in lp:
            lp[name].copy_(0.5 * torch.randn(lp[name].shape, generator=gen))
    for name in ("q_norm", "k_norm"):
        if name in lp:
            lp[name].uniform_(0.5, 1.5, generator=gen)
    if cfg.norm_zero_centered:
        for v in (params["final_norm"], lp["attn_norm"], lp["mlp_norm"]):
            v.copy_(0.3 * torch.randn(v.shape, generator=gen))
    return params


@pytest.mark.parametrize("layout", ["mixed", "mixed_int8", "linear"])
def test_decode_graph_replay_matches_eager(cuda, layout):
    """The contiguous loop's decode graph (a tiny Gemma-2-shaped config on
    a mixed cache, int8 too, or a tiny Llama on a linear one) against the
    eager ``decode_step`` on a copy of the cache, over 20 steps that wrap
    the 16-slot ring, one row inactive: logits and every section
    bit-identical, the norm kernel counted at each replay, one capture."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models.llama import (LlamaModel,
                                                           tiny_llama)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        DecodeGraph

    g2 = dict(sliding_window=8, sliding_window_pattern=2,
              attn_logit_softcap=50.0, query_pre_attn_scalar=64.0,
              post_norms=True, logit_softcap=30.0)
    # head_dim 64: the prefill's flash kernel takes 64, 128, 192 or 256
    cfg = tiny_llama(vocab_size=128, embed_dim=128, n_layers=4, n_heads=4,
                     n_kv_heads=2, head_dim=64, mlp_dim=128, max_seq_len=256,
                     **({} if layout == "linear" else g2))
    model = LlamaModel(cfg, cuda)
    params = init_params_cpu(cfg, torch.Generator().manual_seed(7))
    params = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                  {n: w.to(cuda) for n, w in v.items()})
              for k, v in params.items()}
    quant = layout == "mixed_int8"
    cache = (model.init_cache(4, 64, quant) if layout == "linear"
             else model.init_mixed_cache(4, 64, 16, quant))
    prompt = torch.randint(0, 128, (4, 6), device=cuda)
    model.prefill(params, prompt, cache)
    ref = {k: v.clone() for k, v in cache.items()}
    graph = DecodeGraph(model, 4)
    graph.capture(params, cache, torch.cuda.graph_pool_handle())
    for name in cache:
        assert torch.equal(cache[name], ref[name]), name   # warm-up: no write
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(3)
    norms = (4 if cfg.post_norms else 2) * cfg.n_layers + 1
    assert graph.launches_per_replay["rms_norm"] == norms
    for _ in range(20):
        toks = rng.integers(0, 128, 4).astype(np.int32)
        before = rms_norm.launches
        got = graph.run(params, cache, toks, active).clone()
        assert rms_norm.launches - before == norms
        want, _ = model.decode_step(params, torch.from_numpy(toks).to(cuda),
                                    ref, torch.from_numpy(active).to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for name in cache:
            assert torch.equal(cache[name], ref[name]), name
    assert graph.captures == 1 and graph.replays == 20
    counts = graph.kernels_in_graph()
    assert counts["rms_norm"] == norms and sum(counts.values()) == norms


def _contiguous_setup(cuda, layout, mesh=None):
    """A tiny Gemma-2-shaped config (mixed cache) or a tiny Llama (linear
    cache, or with a uniform window of 8 a 16-slot ring), its bf16 params
    on the card (laid out over ``mesh``'s shards when given) and a 4-row
    cache prefilled with 6 tokens a row."""
    import copy

    from k8s_runpod_kubelet_tpu_torch.models.llama import (LlamaModel,
                                                           tiny_llama)
    from k8s_runpod_kubelet_tpu_torch.parallel.sharding import shard_params

    g2 = dict(sliding_window=8, sliding_window_pattern=2,
              attn_logit_softcap=50.0, query_pre_attn_scalar=64.0,
              post_norms=True, logit_softcap=30.0)
    extra = {"mixed": g2, "linear": {}, "ring": dict(sliding_window=8)}
    # head_dim 64: the prefill's flash kernel takes 64, 128, 192 or 256
    cfg = tiny_llama(vocab_size=128, embed_dim=128, n_layers=4, n_heads=4,
                     n_kv_heads=2, head_dim=64, mlp_dim=128, max_seq_len=256,
                     **extra[layout])
    model = LlamaModel(cfg, cuda, mesh)
    params = init_params_cpu(cfg, torch.Generator().manual_seed(7))
    if mesh is not None:
        params = shard_params(cfg, copy.deepcopy(params), mesh)
    params = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                  {n: w.to(cuda) for n, w in v.items()})
              for k, v in params.items()}
    cache = {"linear": lambda: model.init_cache(4, 64),
             "mixed": lambda: model.init_mixed_cache(4, 64, 16),
             "ring": lambda: model.init_ring_cache(4, 16)}[layout]()
    prompt = torch.randint(0, 128, (4, 6), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(5))
    model.prefill(params, prompt, cache)
    return cfg, model, params, cache


@pytest.mark.parametrize("layout", ["mixed", "ring", "linear"])
def test_verify_graph_replay_matches_eager(cuda, layout):
    """The contiguous loop's K + 1 = 4-wide verify graph (the speculative
    step) against the eager ``verify_step`` on a copy of the cache, over
    12 steps whose index moves by 1 to 4 (what a row commits), wrapping the
    16-slot ring and writing past the 64-position linear section: logits
    and every section bit-identical, one capture, the norm kernel counted
    at each replay and no other counted kernel."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        DecodeGraph

    cfg, model, params, cache = _contiguous_setup(cuda, layout)
    # rows near the end of the 64 positions: their writes run past it
    cache["index"] += torch.tensor([30, 45, 0, 52], dtype=torch.int32,
                                   device=cuda)
    ref = {k: v.clone() for k, v in cache.items()}
    graph = DecodeGraph(model, 4, width=4)
    graph.capture(params, cache, torch.cuda.graph_pool_handle())
    for name in cache:
        assert torch.equal(cache[name], ref[name]), name   # warm-up: no write
    norms = (4 if cfg.post_norms else 2) * cfg.n_layers + 1
    assert graph.launches_per_replay["rms_norm"] == norms
    assert sum(graph.launches_per_replay.values()) == norms
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(4)
    for _ in range(12):
        toks = rng.integers(0, 128, (4, 4)).astype(np.int32)
        before = rms_norm.launches
        got = graph.run(params, cache, toks, active).clone()
        assert rms_norm.launches - before == norms
        want, _ = model.verify_step(params, torch.from_numpy(toks).to(cuda),
                                    ref, torch.from_numpy(active).to(cuda),
                                    check=False)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for name in cache:
            assert torch.equal(cache[name], ref[name]), name
        commit = torch.from_numpy(
            rng.integers(1, 5, 4) * active).to(cuda, torch.int32)
        cache["index"] += commit
        ref["index"] += commit
    assert graph.captures == 1 and graph.replays == 12
    assert graph.kernels_in_graph()["rms_norm"] == norms


@pytest.mark.parametrize("layout", ["mixed", "linear"])
def test_tp2_contiguous_decode_step_matches_tp1(cuda, layout):
    """A decode step over a head-sharded contiguous cache (an in-process
    tensor mesh of 2) against the one-device step on the same bf16
    weights: logits within the bf16 tolerance (relative L2 3e-2), every
    shard's cache heads equal to the one-device cache's heads s·h ..
    (s+1)·h within one bf16 rounding of the written rows; ``flash_fwd``
    twice a layer in the prefill (once a shard)."""
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(tensor=2))
    _, one, p1, whole = _contiguous_setup(cuda, layout)
    before = flash_fwd.launches
    cfg, two, p2, sharded = _contiguous_setup(cuda, layout, mesh)
    assert flash_fwd.launches - before == 2 * cfg.n_layers
    assert two.cache_shards(sharded) == 2
    tok = torch.tensor([3, 9, 27, 81], dtype=torch.int32, device=cuda)
    for _ in range(3):
        la, whole = one.decode_step(p1, tok, whole)
        lb, sharded = two.decode_step(p2, tok, sharded)
        torch.cuda.synchronize()
        assert float((lb - la).norm() / la.norm()) < 3e-2
        tok = la.argmax(-1).to(torch.int32)
    for name in ("k", "v", "k_l", "v_l", "k_g", "v_g"):
        if name not in whole:
            continue
        h = whole[name].shape[3] // 2
        shards = sharded[name].view(2, -1, *sharded[name].shape[1:])
        for s in range(2):
            a, b = shards[s].float(), whole[name][..., s * h:(s + 1) * h, :]
            assert float((a - b.float()).norm() / b.float().norm()) < 3e-2


# -- the replica's profile route on the card -------------------------------------------

def test_debug_profile_names_the_paged_kernel_and_the_norm(cuda):
    """tiny_llama bf16 behind ``serve_main.serve`` with profile capture on:
    ``GET /debug/profile?seconds=1`` while requests keep 4 slots decoding
    writes a Chrome trace whose kernel events hold ``paged_attention_multi``
    (row 8) and ``rms_norm`` (row 12) at L : 2L + 1 a step or chunk,
    within one step at each edge of the window; no graph was captured
    again."""
    import json
    import os
    import shutil
    import threading
    import urllib.request

    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        trace_kernel_events

    cfg, params = _tiny_bf16(cuda)
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=4, max_prefill_len=64, cache_len=512, max_new_tokens=64,
        kv_page_tokens=16), device=cuda).start()
    httpd = serve(eng, 0, host="127.0.0.1", profile_capture=True)
    port = httpd.server_address[1]
    stop = threading.Event()

    def traffic():
        i = 0
        while not stop.is_set():
            futs = [eng.submit(list(range(5 + i + j, 40 + i + j)))
                    for j in range(4)]
            for f in futs:
                f.result(timeout=300)
            i += 1

    runner = threading.Thread(target=traffic)
    try:
        eng.submit([1, 2, 3], max_new_tokens=2).result(timeout=300)
        runner.start()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/profile"
                                    "?seconds=1", timeout=120) as r:
            prof = json.loads(r.read())
        fams = trace_kernel_events(os.path.join(prof["profile_dir"],
                                                "trace.json"))
        shutil.rmtree(prof["profile_dir"], ignore_errors=True)
        graphs = eng.debug_snapshot()["graphs"]
    finally:
        stop.set()
        if runner.is_alive():
            runner.join(timeout=300)
        httpd.shutdown()
        httpd.server_close()
        eng.stop()
    assert prof["seconds"] == 1.0
    attn = fams["paged_attention_multi"]["count"]
    norm = fams["rms_norm"]["count"]
    assert attn >= cfg.n_layers and norm >= 2 * cfg.n_layers + 1, fams
    assert abs(attn / cfg.n_layers - norm / (2 * cfg.n_layers + 1)) <= 2
    assert fams["paged_attention_multi"]["ms"] > 0
    assert graphs["paged_step"]["compiles"] == 1


# -- the trainer on the card: the fused loss and the async checkpoint --------


@pytest.mark.parametrize("tied", [False, True])
def test_fused_loss_at_an_8b_head_matches_the_plain_loss(cuda, tied):
    """``ops/fused_ce.py`` at llama3-8b's head (E 4096, V 128256) over
    2048 bf16 rows of an f32 head, 8 chunks, z-loss on: against the naive
    loss on the same bf16-rounded operands in f32 (loss and z within 1e-5
    relative: the same f32 products summed in another order; gradients
    within 1e-2 relative L2: the fused backward rounds each chunk's
    d_logits to bf16 before its two products)."""
    from k8s_runpod_kubelet_tpu_torch.ops.fused_ce import fused_cross_entropy
    from k8s_runpod_kubelet_tpu_torch.workloads.train import _ce_and_zloss

    gen = torch.Generator(device=cuda).manual_seed(21)
    n, e, v = 2048, 4096, 128256
    h = torch.randn((n, e), generator=gen, device=cuda).to(torch.bfloat16)
    w = 0.02 * torch.randn((v, e) if tied else (e, v), generator=gen,
                           device=cuda)
    t = torch.randint(0, v, (n,), generator=gen, device=cuda)
    h.requires_grad_()
    w.requires_grad_()
    ce, z = fused_cross_entropy(h, w, t, tied=tied, z_loss_coef=1e-4,
                                n_chunks=8)
    dh, dw = torch.autograd.grad(ce + z, (h, w))
    hf = h.detach().float().requires_grad_()
    wf = w.detach().to(torch.bfloat16).float().requires_grad_()
    logits = hf @ (wf.t() if tied else wf)
    ce0, z0 = _ce_and_zloss(logits, t, 1e-4)
    dh0, dw0 = torch.autograd.grad(ce0 + z0, (hf, wf))
    torch.testing.assert_close(ce, ce0, rtol=1e-5, atol=0)
    torch.testing.assert_close(z, z0, rtol=1e-5, atol=0)
    for got, want in ((dh.float(), dh0), (dw, dw0)):
        assert ((got - want).norm() / want.norm()).item() < 1e-2


def _staged_save_round_trip(cuda, tmp_path):
    """A staged save followed at once by a step that updates every
    parameter and moment in place: the checkpoint holds the state at the
    save, bit for bit, and the step after restoring it reproduces the
    live run's loss. Returns the trainer that saved."""
    from k8s_runpod_kubelet_tpu_torch.models import tiny_llama
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, synthetic_batches)

    cfg = tiny_llama(embed_dim=1024, n_layers=4, n_heads=8, n_kv_heads=4,
                     mlp_dim=2816, max_seq_len=512)
    tc = TrainConfig(batch_size=2, seq_len=256, steps=4, warmup_steps=1,
                     checkpoint_dir=str(tmp_path / "ck"))
    a = Trainer(cfg, tc, seed=3, device=cuda)
    batches = synthetic_batches(cfg, tc, seed=4, device=cuda)
    a.run(steps=2, batches=batches)
    want = [t.detach().clone() for t in _leaves(a.params)
            + _leaves(a.opt_state["mu"]) + _leaves(a.opt_state["nu"])]
    a.save(block=False)
    batch = next(batches)
    live = a.step_fn(a.params, a.opt_state, batch)   # in place, at once
    a.wait_pending()
    b = Trainer(cfg, tc, seed=5, device=cuda)
    assert b.restore() and b.step == 2
    got = (_leaves(b.params) + _leaves(b.opt_state["mu"])
           + _leaves(b.opt_state["nu"]))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    moved = [t for t, w in zip(_leaves(a.params), want) if not
             torch.equal(t, w)]
    assert moved    # the live step did update in place
    again = b.step_fn(b.params, b.opt_state, batch)
    assert float(again["loss"]) == float(live["loss"])
    return a


def test_async_save_under_a_running_step(cuda, tmp_path):
    """The staged save round trip with every leaf in pinned buffers (the
    update waits for the staging copy)."""
    a = _staged_save_round_trip(cuda, tmp_path)
    assert all(h.is_pinned() for h in a.checkpoints._host.values())


def test_async_save_past_the_pinned_cap(cuda, tmp_path, monkeypatch):
    """Under a 1 MiB cap on the kept pinned buffers the round trip is
    the same bit for bit: the leaves past the cap stage through pageable
    memory, and only the pinned ones are kept for the next save."""
    from k8s_runpod_kubelet_tpu_torch.workloads import train

    cap = 1 << 20
    monkeypatch.setattr(train, "_PINNED_STAGING_BYTES", cap)
    a = _staged_save_round_trip(cuda, tmp_path)
    kept = a.checkpoints._host.values()
    assert 0 < a.checkpoints._pinned_bytes <= cap
    assert a.checkpoints._pinned_bytes == sum(h.nbytes for h in kept)
    assert all(h.is_pinned() for h in kept)


# -- DeepSeek-V2-Lite's shapes -------------------------------------------------------

def _not_close(out, ref) -> bool:
    return not torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("section", ["prefix", "main"])
@pytest.mark.parametrize("b,kq,lengths", [
    (8, 1, [252, 402, 475, 468, 411, 789, 881, 571]),
    (1, 300, [300 + 37])], ids=["decode", "chunk"])
def test_mla_kernels_at_deepseek_heads_on_each_section(cuda, quant, section,
                                                       b, kq, lengths):
    """Row 10 (and 11 with int8 latents) at DeepSeek-V2-Lite's 16 heads on
    a layer of its arena's two section stacks, ``c_pre``/``kr_pre`` (the
    dense prefix, 1 layer) and ``c``/``kr`` (26 layers): each layer is a
    view at its own base pointer into a stack of 16-token pages. Held
    against the plain version; the control, the plain version over the
    other stack's layer, must fail."""
    t, cols, hq, r, dr = 16, 64, 16, 512, 64
    q_lat, q_rope, c0, kr0, table, lens = _mla_case(cuda, b, kq, hq, r, dr,
                                                    t, cols, lengths)
    gen = torch.Generator(device=cuda).manual_seed(22)
    stacks = {name: (torch.randn((n,) + c0.shape, generator=gen,
                                 device=cuda).bfloat16(),
                     torch.randn((n,) + kr0.shape, generator=gen,
                                 device=cuda).bfloat16())
              for name, n in (("prefix", 1), ("main", 26))}
    layer = {"prefix": 0, "main": 25}
    other = "main" if section == "prefix" else "prefix"

    def pages(name):
        c, kr = (s[layer[name]] for s in stacks[name])
        return (_kv_quant(c) + _kv_quant(kr)) if quant else (c, kr)

    def order(p):   # (c, c_scale, kr, kr_scale) -> the kernel's order
        return (p[0], p[2], p[1], p[3]) if quant else p

    fn, plain = ((paged_attention_multi_mla_quant,
                  _paged_attention_multi_mla_quant_plain) if quant else
                 (paged_attention_multi_mla, _paged_attention_multi_mla_plain))
    scale = (128 + dr) ** -0.5
    got = order(pages(section))
    assert got[0].data_ptr() != order(pages(other))[0].data_ptr()
    before = fn.launches
    out = fn(q_lat, q_rope, *got, table, lens, sm_scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _close_f32(out, plain(q_lat, q_rope, *got, table, lens, sm_scale=scale))
    assert _not_close(out, plain(q_lat, q_rope, *order(pages(other)), table,
                                 lens, sm_scale=scale))


def _topk_counts(dev, tokens: int, experts: int, k: int, seed: int):
    """Each expert's rows when ``tokens`` tokens each pick ``k`` distinct
    experts at random (int32 (experts,))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    picks = torch.rand((tokens, experts), generator=gen,
                       device=dev).topk(k, dim=-1).indices
    return torch.bincount(picks.reshape(-1), minlength=experts).int()


@pytest.mark.parametrize("kin,out", [(2048, 1408), (1408, 2048)],
                         ids=["gate_up", "down"])
@pytest.mark.parametrize("tokens", [8, 128])
def test_int4_expert_matmul_at_deepseek_widths(cuda, kin, out, tokens):
    """Row 14 at DeepSeek-V2-Lite's 64 experts of width 1408 (out 1408 is
    11 column tiles of 128, in 1408 is 11 groups of 128), the buffer at
    the serving capacity (one row a token) and counts from top-6 picks:
    at 8 tokens most experts hold no row or one. Filled rows against the
    plain version, the rest exactly zero; the control, each expert given
    its neighbour's weights, must fail."""
    experts = 64
    gen = torch.Generator(device=cuda).manual_seed(kin + tokens)
    leaves = [_quantize_leaf_int4(0.02 * torch.randn(
        (kin, out), generator=gen, device=cuda)) for _ in range(experts)]
    q4 = torch.stack([lf["q4"] for lf in leaves])
    scale = torch.stack([lf["scale"] for lf in leaves])
    assert scale.shape[1] == kin // 128
    cnt = _topk_counts(cuda, tokens, experts, 6, tokens)
    if tokens == 8:
        assert int((cnt == 0).sum()) > 0 and int((cnt == 1).sum()) > 0
    rows = torch.arange(tokens, device=cuda)[None] < cnt[:, None]
    h = (torch.randn((experts, tokens, kin), generator=gen, device=cuda)
         * rows[..., None]).bfloat16()
    before = int4_expert_matmul.launches
    y = int4_expert_matmul(h, q4, scale, cnt)
    torch.cuda.synchronize()
    assert int4_expert_matmul.launches == before + 1
    ref = _int4_expert_matmul_plain(h.float(), q4, scale, cnt)
    _close_bf16(y, ref)
    assert torch.equal(y[~rows], torch.zeros_like(y[~rows]))
    rolled = _int4_expert_matmul_plain(h.float(), torch.roll(q4, 1, 0),
                                       torch.roll(scale, 1, 0), cnt)
    assert _not_close(y[rows], rolled[rows])


# -- MoE training on the card --------------------------------------------------------

def _moe_train_cfg(shape: str):
    """A tiny MoE config the kernels take (attention at D = 64): Mixtral's
    softmax top-2 over 4 experts, or DeepSeek-V3's sigmoid routing over 8
    experts in 4 groups with MLA (48 + 16), the low-rank q, a shared
    expert and a dense prefix layer. bf16 compute, f32 master weights."""
    from k8s_runpod_kubelet_tpu_torch.models import tiny_mla, tiny_moe

    if shape == "moe":
        return tiny_moe(vocab_size=256, embed_dim=256, n_layers=2, n_heads=4,
                        n_kv_heads=2, mlp_dim=256, max_seq_len=256)
    return tiny_mla(vocab_size=256, embed_dim=256, n_layers=3, n_heads=4,
                    head_dim=48, mla_latent_dim=64, mla_rope_dim=16,
                    mla_q_lora_rank=64, mlp_dim=128, max_seq_len=256,
                    n_dense_prefix=1, dense_prefix_mlp_dim=256, n_experts=8,
                    n_experts_per_tok=2, n_shared_experts=1,
                    router_norm_topk=True, router_sigmoid_bias=True,
                    router_n_group=4, router_topk_group=2,
                    routed_scaling_factor=2.5)


def _forced_routes(moe, picks: list):
    """Context: ``moe.route_top_k`` and ``route_top_k_v3`` record the
    experts they choose into ``picks`` (empty) or, given them, take the
    recorded ones call by call (a step's calls come in the same order every
    time: each routed layer's forward, then its remat recompute), weighted
    as the routing weights them (softmax probabilities, or V3's raw
    sigmoid scores, renormalized as configured, times the scaling)."""
    import contextlib

    real = (moe.route_top_k, moe.route_top_k_v3)
    replay = iter(list(picks))
    record = not picks

    def forced(logits, k, norm_topk=True, *, sigmoid=False,
               routed_scaling=1.0):
        idx = next(replay)
        scores = (torch.sigmoid(logits) if sigmoid
                  else torch.softmax(logits, dim=-1))
        w = torch.gather(scores, 1, idx)
        if norm_topk:
            w = w / (w.sum(dim=-1, keepdim=True) + (1e-20 if sigmoid else 0))
        return w * routed_scaling, idx, scores

    def top_k(logits, k, norm_topk=True):
        if record:
            out = real[0](logits, k, norm_topk)
            picks.append(out[1])
            return out
        return forced(logits, k, norm_topk)

    def top_k_v3(logits, k, **kw):
        if record:
            out = real[1](logits, k, **kw)
            picks.append(out[1])
            return out
        return forced(logits, k, kw["norm_topk"], sigmoid=True,
                      routed_scaling=kw["routed_scaling"])

    @contextlib.contextmanager
    def ctx():
        moe.route_top_k, moe.route_top_k_v3 = top_k, top_k_v3
        try:
            yield
        finally:
            moe.route_top_k, moe.route_top_k_v3 = real
    return ctx()


@pytest.mark.parametrize("shape", ["moe", "v3"])
def test_moe_train_step_on_the_card_matches_its_plain_path(cuda, shape,
                                                          monkeypatch):
    """One train step's gradients in bf16 through the flash and rms_norm
    kernels against the same step with both swapped for their plain
    versions (``_attention_plain``, ``_rms_norm_plain``, autograd), on the
    same f32 master params and batch: loss and aux within 1% relative, each
    leaf's gradient within 0.1 relative L2 (chip_smoke's
    TRAIN_GRAD_REL_L2_LIMIT, set for bf16 against f32; here both sides
    are bf16 and differ only in where attention and the norms round). The
    plain step takes the kernel step's expert choices (``_forced_routes``):
    rounded elsewhere, the two would part at near ties, and a changed
    choice moves a whole expert's share of the gradients. Routers are
    drawn at normal * 0.25 (logits of std ~4 at E = 256: sigmoid scores
    far from saturation, whose derivative would be rounding noise). V3's
    ``router_bias`` reaches the loss only through the expert choice: its
    gradient is exactly zero on the card too. Then the trainer's own step
    runs the kernels and reports a finite loss and aux (nonzero under
    softmax routing, zero under V3's)."""
    from k8s_runpod_kubelet_tpu_torch.models import llama, moe
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, loss_aux_and_grads)

    cfg = _moe_train_cfg(shape)
    tc = TrainConfig(batch_size=2, seq_len=128, warmup_steps=1)
    tr = Trainer(cfg, tc, seed=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for name, scale in (("router", 0.25), ("router_bias", 0.3)):
            leaf = tr.params["layers"].get(name)
            if leaf is not None:
                leaf.copy_(scale * torch.randn(leaf.shape, generator=gen,
                                               device=cuda))
    batch = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen,
                          device=cuda)
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    before = [k.launches for k in kernels]
    picks: list = []
    with _forced_routes(moe, picks):
        ce, aux, grads = loss_aux_and_grads(tr.model, tr.params, batch)
    assert all(k.launches > n for k, n in zip(kernels, before))
    assert len(picks) == 2 * (cfg.n_layers - cfg.n_dense_prefix)
    with monkeypatch.context() as mp, _forced_routes(moe, picks):
        mp.setattr(llama, "rms_norm", _rms_norm_plain)
        mp.setattr(llama, "flash_attention",
                   lambda q, k, v, *, causal, sm_scale, sliding_window,
                   logit_soft_cap: _attention_plain(
                       q, k, v, causal=causal, sm_scale=sm_scale,
                       sliding_window=sliding_window,
                       logit_soft_cap=logit_soft_cap))
        mid = [k.launches for k in kernels]
        ce_p, aux_p, grads_p = loss_aux_and_grads(tr.model, tr.params,
                                                  batch)
        assert [k.launches for k in kernels] == mid
    assert abs(float(ce) - float(ce_p)) <= 1e-2 * abs(float(ce_p))
    assert abs(float(aux) - float(aux_p)) <= 1e-2 * abs(float(aux_p)) + 1e-6
    names = []

    def walk(tree, prefix=""):
        for n in sorted(tree):
            if isinstance(tree[n], dict):
                walk(tree[n], f"{prefix}{n}/")
            else:
                names.append(prefix + n)

    walk(tr.params)
    for name, g, gp in zip(names, grads, grads_p):
        if name.endswith("router_bias"):
            assert not g.any() and not gp.any(), name
            continue
        rel = float((g.float() - gp.float()).norm() / gp.float().norm())
        assert rel <= 0.1, (name, rel)
    m = tr.step_fn(tr.params, tr.opt_state, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert (float(m["aux_loss"]) > 0) == (shape == "moe")
    assert len(names) == len(_leaves(tr.params))


@pytest.mark.parametrize("rung", ["device", "device_streamed", "wire"])
def test_kv_handoff_between_engines_on_the_card(cuda, rung):
    """Two tiny bf16 engines on the card (graph replays on): a prompt's
    run moves from one to the other over the device rung (monolithic or
    streamed, the adopter waiting on the exporter's event) or the wire
    codec (bf16 as its raw words); the adopted pages equal the exporter's
    bit for bit, and the decode engine's greedy tokens equal the
    exporter's own from its cached pages (the same path)."""
    from k8s_runpod_kubelet_tpu_torch.fleet.device_transfer import (
        DeviceTransferBus, device_push)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    cfg, params = _tiny_bf16(cuda)
    chunk = 16 if rung == "device_streamed" else 0

    def engine(chunk_tokens):
        sc = ServingConfig(slots=2, max_prefill_len=64, cache_len=256,
                           max_new_tokens=12, kv_page_tokens=16,
                           serving_chunk_tokens=chunk_tokens)
        return ServingEngine(cfg, params, sc, device=cuda).start()

    src, dst = engine(chunk), engine(0)
    try:
        prompt = [(i * 37) % 120 + 1 for i in range(75)]
        if rung == "wire":
            dst.adopt_handoff(src.export_handoff(prompt)["blob"])
        else:
            bus = DeviceTransferBus()
            bus.register("http://dst", dst, "card")
            out = device_push(src, "http://dst", prompt, domain="card",
                              bus=bus)
            assert out["streamed"] == bool(chunk)
        runs = []
        for eng in (src, dst):
            store = eng._kv_store
            with eng._prefix_lock:
                m = store.match_full(0, prompt)
                runs.append(store.export_pages(m.pages))
                store.release(m.pages)
        for name in runs[0]:
            assert runs[0][name].dtype == torch.bfloat16
            assert runs[0][name].shape[1] == len(prompt) // 16
            assert torch.equal(runs[0][name], runs[1][name]), name
        want = src.submit(prompt).result(timeout=300)["tokens"]
        assert dst.submit(prompt).result(timeout=300)["tokens"] == want
    finally:
        src.stop()
        dst.stop()


# -- Gemma 2 and 3 training shapes: rows 1-3, 16 and 12 ---------------------------

GEMMA_TRAIN_CASES = {
    # name: (Hq, Hkv, S, window, soft cap, q_offset); B 1, D 256
    "g2_local_cap_window": (16, 8, 2048, 1024, 50.0, 0),
    "g2_global_cap": (16, 8, 2048, None, 50.0, 0),
    "g3_local_window": (16, 8, 2048, 512, None, 0),
    # row 16: one shard of a seq = 2 ring, a local layer's band behind it
    "g2_ring_offset_cap_window": (16, 8, 1024, 1024, 50.0, 1024),
}


@pytest.mark.parametrize("name", sorted(GEMMA_TRAIN_CASES))
def test_flash_kernels_at_gemma_train_shapes_and_their_controls(cuda, name):
    """Gemma's train-step heads (16 over 8 of 256) under its cap of 50 and
    a window that bites, at q_offset 0 and a ring shard's: the three
    kernels against their plain versions per element (q drawn 8x, so the
    scores reach the cap); the controls must miss: dQ and dK/dV launched
    without the cap on the same lse and delta (each of dq, dk, dv), and
    the three kernels at the window one short (some output)."""
    hq, hkv, s, window, cap, offset = GEMMA_TRAIN_CASES[name]
    d = 256
    gen = torch.Generator().manual_seed(25)
    q, do = (torch.randn((1, hq, s, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((1, hkv, s, d), generator=gen) for _ in range(2))
    if cap is not None:
        q *= 8
    q, k, v, do = (t.to(cuda, torch.bfloat16) for t in (q, k, v, do))
    args = dict(causal=True, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap, q_offset=offset)
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = _flash_fwd_plain(*f32[:3], **args)
    refs = (o_ref, _flash_dq_plain(*f32, lse, delta, **args),
            *_flash_dkv_plain(*f32, lse, delta, **args))
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    for got, ref in zip((o, dq, dk, dv), refs):
        _close_bf16(got, ref)
    if cap is not None:
        nocap = dict(args, logit_soft_cap=None)
        broken = (flash_dq(q, k, v, do, lse, delta, **nocap),
                  *flash_dkv(q, k, v, do, lse, delta, **nocap))
        for got, ref in zip(broken, refs[1:]):
            assert not _within_bf16(got, ref)
    if window is not None:
        short = dict(args, sliding_window=window - 1)
        o_c, lse_c = flash_fwd(q, k, v, **short)
        delta_c = (do.float() * o_c.float()).sum(-1)
        broken = (o_c, flash_dq(q, k, v, do, lse_c, delta_c, **short),
                  *flash_dkv(q, k, v, do, lse_c, delta_c, **short))
        assert not all(_within_bf16(g, r) for g, r in zip(broken, refs))


def test_flash_dkv_misses_toward_the_cap_stay_few_queue3(cuda):
    """ROADMAP Queue 3's closed fault, "dK/dV per element with scores
    toward a soft cap": Gemma 2's global train head (B 1, 16 q heads over
    8 of 256, S 8192, causal, cap 50) on ``chip_smoke.py``'s draw for that
    case with q 8x, so the scores reach toward the cap. Every output
    within 4e-3 relative L2 and within the per-element check, no element
    over; dK of kv head 0 within the check of float64, as the plain f32
    version's is. The control is the kernel before the repair
    (``FLASH_DKV_STRAIGHT=1``: each q tile's product summed straight in
    the wgmma accumulator, dS in two bf16 terms), whose dK must miss the
    per-element check."""
    from k8s_runpod_kubelet_tpu_torch.workloads.flash_large_logits import (
        VARIANTS, backward_calls, dk_float64)

    b, hq, hkv, s, d = 1, 16, 8, 8192, 256
    gen = torch.Generator().manual_seed(20261016 + s + d + hkv)
    q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
    q, k, v, do = (t.to(cuda, torch.bfloat16) for t in (q, k, v, do))
    q = (q.float() * 8).bfloat16()
    args = dict(causal=True, sm_scale=d ** -0.5, sliding_window=None,
                logit_soft_cap=50.0, q_offset=0)
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    f32 = [t.float() for t in (q, k, v, do)]
    refs = (_flash_fwd_plain(*f32[:3], **args)[0],
            _flash_dq_plain(*f32, lse, delta, **args),
            *_flash_dkv_plain(*f32, lse, delta, **args))
    for got, ref in zip((o, dq, dk, dv), refs):
        assert ((got.float() - ref).norm() / ref.norm()).item() <= 4e-3
        _close_bf16(got, ref)
    exact = dk_float64(q, k, v, do, lse, delta, args)
    for t in (dk, refs[2]):
        t = t[:, :1].double()
        assert torch.all((t - exact).abs() <= 1e-4 + 1e-2 * exact.abs())
    (_, dk_c, _), _, run_dkv = backward_calls(VARIANTS["straight"], q, k, v,
                                              do, lse, delta, args)
    run_dkv()
    assert not _within_bf16(dk_c, refs[2])


@pytest.mark.parametrize("rows,width", [(2048, 3584), (2048, 3840),
                                        (2048 * 16, 256)],
                         ids=["gemma2_3584", "gemma3_3840", "gemma3_qk_256"])
def test_rms_norm_backward_at_gemma_widths_and_its_control(cuda, rows,
                                                           width):
    """Row 12 with gradients at Gemma 2's and 3's widths and Gemma 3's q/k
    norm rows of 256: y, dx and dw against autograd of the plain version;
    the control, dx without the term through the mean square, must
    miss."""
    gen = torch.Generator().manual_seed(width)
    x = (3 * torch.randn((rows, width), generator=gen)).to(cuda,
                                                           torch.bfloat16)
    w = (1 + 0.1 * torch.randn((width,), generator=gen)).to(cuda)
    g = torch.randn((rows, width), generator=gen).to(cuda, torch.bfloat16)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = rms_norm.launches
    y = rms_norm(xk, wk, 1e-6)
    dx, dw = torch.autograd.grad(y, (xk, wk), g)
    assert rms_norm.launches == before + 1
    xp, wp = x.float().requires_grad_(), w.clone().requires_grad_()
    yp = _rms_norm_plain(xp, wp, 1e-6)
    pdx, pdw = torch.autograd.grad(yp, (xp, wp), g.float())
    _close_bf16(y, yp)
    _close_bf16(dx, pdx)
    torch.testing.assert_close(dw, pdw, atol=1e-3, rtol=1e-3)
    rstd = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6)
    assert not _within_bf16(g.float() * w * rstd, pdx)


def test_decode_graph_with_adapters_matches_eager_and_never_recaptures(cuda):
    """The contiguous loop's decode graph over a tiny Gemma-2-shaped mixed
    cache with multi-LoRA stacks (all seven targets, 3 adapters, rank 8):
    replays with mixed ids (0 among them) bit-identical to the eager
    ``decode_step`` with the same stacks and ids; an adapter rewritten in
    the stacks in place and a new id serve at the next replay with no
    capture; the adapters move the logits, the base row's stay the base
    step's."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models.llama import (LlamaModel,
                                                           tiny_llama)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        DecodeGraph
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        lora_stacks

    cfg = tiny_llama(vocab_size=128, embed_dim=128, n_layers=4, n_heads=4,
                     n_kv_heads=2, head_dim=64, mlp_dim=128, max_seq_len=256,
                     sliding_window=8, sliding_window_pattern=2,
                     attn_logit_softcap=50.0, query_pre_attn_scalar=64.0,
                     post_norms=True, logit_softcap=30.0)
    model = LlamaModel(cfg, cuda)
    params = init_params_cpu(cfg, torch.Generator().manual_seed(7))
    params = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                  {n: w.to(cuda) for n, w in v.items()})
              for k, v in params.items()}
    stacks = lora_stacks(cfg, 8, ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                  "w_down"),
                         torch.Generator(cuda).manual_seed(2), cuda)
    cache = model.init_mixed_cache(4, 64, 16)
    model.prefill(params, torch.randint(0, 128, (4, 6), device=cuda), cache)
    ref = {k: v.clone() for k, v in cache.items()}
    graph = DecodeGraph(model, 4)
    graph.capture(params, cache, torch.cuda.graph_pool_handle(), stacks)
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(3)
    for step in range(6):
        ids = np.array([1, 0, 2, 3] if step < 3 else [3, 0, 0, 1], np.int32)
        if step == 3:   # a rewrite in place, as register_adapter writes
            for st in stacks.values():
                st["b"][:, 3].mul_(-1.5)
        toks = rng.integers(0, 128, 4).astype(np.int32)
        got = graph.run(params, cache, toks, active, adapters=stacks,
                        adapter_ids=ids).clone()
        tok_t = torch.from_numpy(toks).to(cuda)
        act_t = torch.from_numpy(active).to(cuda)
        base_cache = {k: v.clone() for k, v in ref.items()}
        want, _ = model.decode_step(params, tok_t, ref, act_t,
                                    adapters=stacks,
                                    adapter_ids=torch.from_numpy(ids).to(
                                        cuda))
        base, _ = model.decode_step(params, tok_t, base_cache, act_t)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step
        for name in cache:
            assert torch.equal(cache[name], ref[name]), (step, name)
        assert (want[0] - base[0]).abs().max() > 1e-3
        assert torch.equal(want[1], base[1])        # row 1 is the base
    assert graph.captures == 1 and graph.replays == 6
