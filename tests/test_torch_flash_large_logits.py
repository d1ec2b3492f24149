"""``workloads/flash_large_logits.py``'s float64 dK, the yardstick its
card readings hold the flash dK/dV kernel and the plain f32 version to,
against the plain version itself on the CPU: both compute dK of kv head 0
from the same bf16 inputs, lse and delta, so at scores well inside the
cap they agree to f32 rounding; under the cap, a window and a ring offset
too."""

import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.ops.attention import (_flash_dkv_plain,
                                                        _flash_fwd_plain)
from k8s_runpod_kubelet_tpu_torch.workloads.flash_large_logits import \
    dk_float64


@pytest.mark.parametrize("window,cap,q_offset", [
    (None, None, 0), (None, 50.0, 0), (16, 50.0, 0), (24, 5.0, 32)],
    ids=["causal", "cap", "window_cap", "offset_window_cap"])
def test_dk_float64_matches_the_plain_f32_dk(window, cap, q_offset):
    rng = np.random.default_rng(25)
    b, hq, hkv, s, d = 1, 4, 2, 48, 32
    q, do = (torch.from_numpy(rng.normal(size=(b, hq, s, d))).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, d))).bfloat16()
            for _ in range(2))
    args = dict(causal=True, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap, q_offset=q_offset)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o, lse = _flash_fwd_plain(qf, kf, vf, **args)
    delta = (dof * o).sum(-1)
    dk, _ = _flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args)
    exact = dk_float64(q, k, v, do, lse, delta, args)
    assert exact.shape == (b, 1, s, d) and exact.dtype == torch.float64
    torch.testing.assert_close(dk[:, :1].double(), exact, atol=1e-5,
                               rtol=1e-4)
    # the yardstick sees the cap: without it, another dK
    if cap is not None:
        nocap = dict(args, logit_soft_cap=None)
        other = dk_float64(q, k, v, do, lse, delta, nocap)
        assert (other - exact).abs().max() > 1e-3
