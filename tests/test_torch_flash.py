"""The port's flash attention and RMSNorm gradients against the JAX
package's, on the same seeded numpy inputs, in f32 on the CPU.

- ``flash_attention`` forward and its gradients (dq, dk, dv through
  the port's autograd Function, whose forward and backward call the
  three kernels' wrappers, which take their plain versions on the CPU)
  against the JAX
  ``flash_attention(..., interpret=True, block_q=128, block_k=128)`` and
  ``jax.grad`` through it: the Pallas forward and backward kernels run by
  the interpreter, as ``tests/test_ops.py`` runs them. S=256, D=32,
  (Hq, Hkv) in {(4, 4), (8, 2)}, causal and not, plus a sliding window and
  a soft cap.
- The three kernels' plain versions (``flash_fwd``, ``flash_dq``,
  ``flash_dkv`` on CPU tensors, the math the CUDA kernels run: o and the
  row lse, then dq and the group-summed dk/dv from lse and delta) against
  the Pallas kernels' own outputs (``_flash_fwd_pallas`` and
  ``_flash_bwd_pallas`` in interpret mode) on the same inputs.
- ``rms_norm``'s gradients against ``jax.grad`` of the JAX ``rms_norm``.
- The CPU gradients go through the same Functions as the card's: a dK/dV
  wrapper that returns zeros zeroes dk and dv, and ``rms_norm``'s
  backward is ``_RmsNorm.backward``.

Tolerance: atol 2e-5 + rtol 1e-5 for attention (f32 on both sides; the
sums run in other orders, blockwise in the kernels and all at once in the
plain versions: the readings stay below 4e-6), 1e-5 for RMSNorm. The JAX
test holds the same kernels to 2e-3 against its own XLA reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.attention import (_flash_bwd_pallas,
                                                  _flash_fwd_pallas)
from k8s_runpod_kubelet_tpu.ops.attention import \
    flash_attention as jax_flash_attention
from k8s_runpod_kubelet_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from k8s_runpod_kubelet_tpu_torch.ops import (flash_attention, flash_dkv,
                                              flash_dq, flash_fwd, rms_norm)

B, S, D = 2, 256, 32
ATOL, RTOL = 2e-5, 1e-5

# name: (Hq, Hkv, causal, sliding_window, logit_soft_cap)
CASES = {
    "mha_causal": (4, 4, True, None, None),
    "gqa_causal": (8, 2, True, None, None),
    "mha_full": (4, 4, False, None, None),
    "gqa_full": (8, 2, False, None, None),
    "gqa_window": (8, 2, True, 100, None),
    "gqa_softcap": (8, 2, True, None, 5.0),
}


def _inputs(name):
    hq, hkv = CASES[name][:2]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(B, hq, S, D)).astype(np.float32)
    k = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, hkv, S, D)).astype(np.float32)
    g = rng.normal(size=(B, hq, S, D)).astype(np.float32)
    return q, k, v, g


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_and_grads_match_pallas_interpret(name):
    _, _, causal, window, cap = CASES[name]
    q, k, v, g = _inputs(name)

    def jax_loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                block_q=128, block_k=128,
                                sliding_window=window, logit_soft_cap=cap)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = flash_attention(tq, tk, tv, causal=causal, sliding_window=window,
                         logit_soft_cap=cap)
    (to * torch.from_numpy(g)).sum().backward()
    _close(to.detach(), jo, "o")
    for what, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, f"d{what}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_plain_versions_match_pallas_kernels(name):
    _, _, causal, window, cap = CASES[name]
    q, k, v, g = _inputs(name)
    scale = D ** -0.5
    jo, jlse = _flash_fwd_pallas(q, k, v, causal, scale, 128, 128,
                                 interpret=True, window=window, soft_cap=cap)
    jdq, jdk, jdv = _flash_bwd_pallas(q, k, v, jo, jlse, g, causal, scale,
                                      128, 128, interpret=True,
                                      window=window, soft_cap=cap)
    args = dict(causal=causal, sm_scale=scale, sliding_window=window,
                logit_soft_cap=cap)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    to, tlse = flash_fwd(tq, tk, tv, **args)
    _close(to, jo, "o")
    _close(tlse, np.asarray(jlse)[..., 0], "lse")
    # the backward from the Pallas forward's own o and lse, as the JAX
    # package feeds its backward kernels
    o_ref = torch.from_numpy(np.array(jo))
    lse_ref = torch.from_numpy(np.array(jlse)[..., 0])
    delta = (tg * o_ref).sum(-1)
    tdq = flash_dq(tq, tk, tv, tg, lse_ref, delta, **args)
    tdk, tdv = flash_dkv(tq, tk, tv, tg, lse_ref, delta, **args)
    _close(tdq, jdq, "dq")
    _close(tdk, jdk, "dk")
    _close(tdv, jdv, "dv")
    for fn in (flash_fwd, flash_dq, flash_dkv):
        assert fn.launches == 0   # the CPU path launches nothing


def test_rows_that_see_no_key_give_zero_and_no_gradient():
    # Sq > Sk under a window: rows 6.. see no key at all
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    q.requires_grad_()
    o = flash_attention(q, k, v, causal=True, sliding_window=3)
    o.sum().backward()
    assert torch.all(o[:, :, 6:] == 0) and torch.all(q.grad[:, :, 6:] == 0)
    assert torch.isfinite(o).all() and torch.isfinite(q.grad).all()
    args = dict(causal=True, sm_scale=0.25, sliding_window=3)
    o2, lse = flash_fwd(q.detach(), k, v, **args)
    torch.testing.assert_close(o2, o.detach(), atol=1e-6, rtol=0)
    assert torch.all(lse[:, :, 6:] <= -1e29)


def test_flash_attention_checks_its_arguments():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 3, 8, 16)),
                        torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, k, causal=False, sliding_window=4)
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q, k, k, sliding_window=0)
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q, k, k, logit_soft_cap=-1.0)
    with pytest.raises(ValueError):
        flash_attention(q, k, torch.zeros((1, 2, 9, 16)))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 96)])
def test_rms_norm_grads_match_jax(shape):
    rng = np.random.default_rng(11)
    x = (3 * rng.normal(size=shape)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    def jax_loss(x_, w_):
        return jnp.sum(jax_rms_norm(x_, w_, 1e-5, use_pallas=False) * g)

    jdx, jdw = jax.grad(jax_loss, argnums=(0, 1))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (rms_norm(tx, tw, 1e-5) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)


def test_cpu_gradients_go_through_the_kernel_wrappers(monkeypatch):
    from k8s_runpod_kubelet_tpu_torch.ops import attention
    q, k, v, g = (torch.from_numpy(x) for x in _inputs("gqa_causal"))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(tq, tk, tv).backward(g)
    assert tk.grad.abs().max() > 0 and tv.grad.abs().max() > 0
    monkeypatch.setattr(attention, "flash_dkv",
                        lambda q_, k_, v_, *a, **kw: (torch.zeros_like(k_),
                                                      torch.zeros_like(v_)))
    zq, zk, zv = (t.clone().requires_grad_() for t in (q, k, v))
    flash_attention(zq, zk, zv).backward(g)
    assert torch.equal(zq.grad, tq.grad)   # dq comes from flash_dq alone
    assert not zk.grad.any() and not zv.grad.any()


def test_rms_norm_cpu_backward_is_the_functions(monkeypatch):
    from k8s_runpod_kubelet_tpu_torch.ops import rmsnorm
    calls = []
    backward = rmsnorm._RmsNorm.backward

    def counted(ctx, grad):
        calls.append(grad.shape)
        return backward(ctx, grad)

    monkeypatch.setattr(rmsnorm._RmsNorm, "backward", staticmethod(counted))
    x = torch.randn((3, 16), requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    rms_norm(x, w, 1e-5).sum().backward()
    assert calls == [(3, 16)] and x.grad is not None and w.grad is not None
