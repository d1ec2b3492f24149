"""The port's ring flash attention (``ring_attention(..., use_flash=True)``
in one process, its kernels' plain versions on the CPU) against the JAX
``ring_attention(..., use_flash=True)`` whose Pallas chunk kernels run in
interpret mode, on the 8-device CPU mesh, in f32; the cases of
``tests/test_ops.py:262-330``:

- ``MeshConfig(data=2, seq=4)``, S 128 (32-position shards, blocks of 16):
  forward and dq/dk/dv by ``jax.grad``, without a window or cap, with
  each and with both (window 48 truncates the ring at 3 of 4 steps);
- ``MeshConfig(data=1, seq=8)``, S 256: window 24 (the ring stops after 2
  steps), forward; and 24-position shards, which the JAX wrapper cannot
  block, so it runs its XLA ring there, while the port runs its kernels
  (the answer is the same).

Tolerances: outputs atol = rtol = 2e-5, gradients 2e-4 (the JAX tests:
2e-4 and 2e-3). One jit a mesh holds all of its cases: the interpreter's
chunk kernels dominate the file's time.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.ring_attention import \
    ring_attention as jax_ring_attention
from k8s_runpod_kubelet_tpu.parallel.mesh import MeshConfig as JMeshConfig
from k8s_runpod_kubelet_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import (_ring_steps,
                                                             ring_attention)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

OUT_TOL, GRAD_TOL = 2e-5, 2e-4
GRAD_CASES = {"plain": (None, None), "window48": (48, None),
              "softcap30": (None, 30.0), "window48_softcap30": (48, 30.0)}


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def seq4_grads():
    rng = np.random.default_rng(12)
    q, g = _normal(rng, 1, 4, 128, 16), _normal(rng, 1, 4, 128, 16)
    k, v = _normal(rng, 1, 2, 128, 16), _normal(rng, 1, 2, 128, 16)
    mesh = jmake_mesh(JMeshConfig(data=2, seq=4))

    def run(q, k, v):
        outs = {}
        for name, (window, cap) in GRAD_CASES.items():
            def loss(q, k, v, window=window, cap=cap):
                o = jax_ring_attention(q, k, v, mesh, causal=True,
                                       sliding_window=window,
                                       logit_soft_cap=cap, use_flash=True,
                                       interpret=True, block_q=16,
                                       block_k=16)
                return jnp.sum(o * g), o
            (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True)(q, k, v)
            outs[name] = (o, *grads)
        return outs

    out = jax.jit(run)(q, k, v)
    return (q, k, v, g), {n: [np.asarray(x) for x in o]
                          for n, o in out.items()}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_ring_and_grads_match_jax_flash_ring(seq4_grads, name):
    (q, k, v, g), ref = seq4_grads
    window, cap = GRAD_CASES[name]
    if window is not None:
        assert _ring_steps(4, 32, window) == 3     # a truncated ring
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ring_attention(tq, tk, tv, make_mesh(MeshConfig(seq=4)),
                       sliding_window=window, logit_soft_cap=cap,
                       use_flash=True)
    (o * torch.from_numpy(g)).sum().backward()
    for what, got, want, tol in zip(("o", "dq", "dk", "dv"),
                                    (o, tq.grad, tk.grad, tv.grad), ref[name],
                                    (OUT_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=f"{name} {what}")


@pytest.fixture(scope="module")
def seq8_forward():
    rng = np.random.default_rng(13)
    q = _normal(rng, 1, 2, 256, 16)
    k, v = _normal(rng, 1, 2, 256, 16), _normal(rng, 1, 2, 256, 16)
    q24 = _normal(rng, 1, 2, 8 * 24, 16)
    k24, v24 = _normal(rng, 1, 2, 8 * 24, 16), _normal(rng, 1, 2, 8 * 24, 16)
    mesh = jmake_mesh(JMeshConfig(data=1, seq=8))

    def run(q, k, v, q24, k24, v24):
        return {"window24": jax_ring_attention(
                    q, k, v, mesh, causal=True, sliding_window=24,
                    use_flash=True, interpret=True, block_q=16, block_k=16),
                # 24-position shards: the JAX wrapper takes its XLA ring
                "s_local24": jax_ring_attention(q24, k24, v24, mesh,
                                                causal=True, use_flash=True,
                                                interpret=True)}

    out = jax.jit(run)(q, k, v, q24, k24, v24)
    return {"window24": ((q, k, v), np.asarray(out["window24"]), 24),
            "s_local24": ((q24, k24, v24), np.asarray(out["s_local24"]),
                          None)}


@pytest.mark.parametrize("name", ["window24", "s_local24"])
def test_flash_ring_forward_matches_jax(seq8_forward, name):
    inputs, ref, window = seq8_forward[name]
    if window is not None:
        assert _ring_steps(8, 32, window) == 2
    got = ring_attention(*(torch.from_numpy(x) for x in inputs),
                         make_mesh(MeshConfig(seq=8)), sliding_window=window,
                         use_flash=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=OUT_TOL, rtol=OUT_TOL)
