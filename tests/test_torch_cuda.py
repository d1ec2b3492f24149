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

from k8s_runpod_kubelet_tpu_torch.ops import paged_attention_multi, rms_norm
from k8s_runpod_kubelet_tpu_torch.ops.attention import \
    _paged_attention_multi_plain
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
