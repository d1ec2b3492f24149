"""The port's kernels against their plain versions on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the CPU has no mode for a CUDA or Triton kernel. This file imports no
jax, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Inputs are bf16 on the card; outputs are compared in f32 against the
plain version run on the same inputs on the card (tolerances: bf16 output
rounding, 1 ulp = 2^-8 relative, plus f32 sums taken in another order).
"""

import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4
from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
from k8s_runpod_kubelet_tpu_torch.ops import (
    flash_attention, flash_dkv, flash_dq, flash_fwd, int4_matmul,
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
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import _int4_matmul_plain
from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import \
    _launchers as int4_matmul_launchers
from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,width", [(8, 4096), (1024, 4096), (3, 100)])
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
    "d64_softcap": (3, 5, 8, 2, 64, 16, 8, [5, 60, 128], 20.0, None),
    "d256_window": (2, 7, 8, 4, 256, 8, 8, [9, 64], None, 13),
    "group1_window_softcap": (2, 16, 4, 4, 128, 16, 6, [16, 90], 8.0, 20),
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
}


@pytest.mark.parametrize("name", sorted(TILE_FLASH_CASES))
def test_flash_fwd_tile_edges_match_plain(cuda, name):
    """S off the 64-row and 64-key tiles, D = 64 and 256, and rows that see
    no key (o = 0, lse = -1e30), per element at the chip check's
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
}


@pytest.mark.parametrize("name", sorted(TILE_BWD_CASES))
def test_flash_backward_tile_edges_match_plain(cuda, name):
    """flash_dq and flash_dkv at S off the 64-row tiles and below one, D =
    64 and 256 (dK/dV in two passes), a window, a soft cap, non-causal,
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
