"""Ring attention in the port (``ops/ring_attention.py``) and the flash
kernels' ``q_offset``, against the JAX package on the CPU, in f32.

- The flash kernels' plain versions at ``q_offset`` in {S, 3S} (``flash_fwd``
  o and lse, ``flash_dq``, ``flash_dkv``) against ``_flash_fwd_pallas`` /
  ``_flash_bwd_pallas`` in interpret mode at the same offset, causal, with
  a window, a soft cap and both (atol 2e-5 + rtol 1e-5, the pattern of
  ``tests/test_torch_flash.py``). A windowed row that sees no key of the
  chunk gives o = 0 and lse = -1e30 in the port; the Pallas kernel leaves
  the mean of v there under an lse of -1e30 (a weight of 0 in the ring's
  merge), so o is compared on the rows that see a key. The backward gets a
  finite lse (the chunk's own is -1e30 on such rows; the ring feeds the
  global one). Offset 0 is bit-identical to a call without it.
- The port's ``ring_attention`` in one process against the JAX
  ``ring_attention`` on the 8-device CPU mesh (``MeshConfig(data=1,
  seq=8)`` and ``(data=2, seq=4)``), ``use_flash=False`` (the XLA ring)
  with a window, a soft cap and both, forward and dq/dk/dv by
  ``jax.grad``; the windows of ``tests/test_ops.py`` and the non-causal
  ring, forward; one shard falls through to ``flash_attention``; the
  ``_ring_steps`` table. The Pallas-interpret ring (``use_flash=True``) is
  in ``tests/test_torch_ring_flash.py``.
- The process-group form is in ``tests/test_torch_ring_gloo.py``.
- The argument checks: a negative offset, a non-causal flash ring, a
  sequence the shards do not divide, a mesh axis other than ``seq``.

Tolerances: the ring against the JAX ring, outputs atol = rtol = 2e-5 and
gradients 2e-4, tighter than the JAX tests' own (2e-4 and 2e-3,
``tests/test_ops.py:262-330``; f32 sums in other orders, the readings stay
near 2e-6).
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.ops.ring_attention import \
    _ring_steps as jax_ring_steps
from k8s_runpod_kubelet_tpu.ops.ring_attention import \
    ring_attention as jax_ring_attention
from k8s_runpod_kubelet_tpu.ops.attention import (_flash_bwd_pallas,
                                                  _flash_fwd_pallas)
from k8s_runpod_kubelet_tpu.parallel.mesh import MeshConfig as JMeshConfig
from k8s_runpod_kubelet_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_runpod_kubelet_tpu_torch.ops import flash_dkv, flash_dq, flash_fwd
from k8s_runpod_kubelet_tpu_torch.ops.attention import (_check_flash_shapes,
                                                        _flash_mask)
from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import (_ring_steps,
                                                             ring_attention)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

ATOL, RTOL = 2e-5, 1e-5          # the offset kernels, as test_torch_flash
OUT_TOL, GRAD_TOL = 2e-5, 2e-4   # the ring against the JAX ring


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -- the offset kernels ---------------------------------------------------------

S, D = 64, 16
# name: (window, soft cap). A window of 48 cuts the band at offset S and
# leaves no key in sight at 3S (a chunk the ring truncates); one of 150
# sees all of the chunk at S and a band at 3S.
OFFSET_CASES = {
    "causal": (None, None),
    "window48": (48, None),
    "window150": (150, None),
    "softcap": (None, 5.0),
    "window48_softcap": (48, 5.0),
    "window150_softcap": (150, 5.0),
}


@pytest.mark.parametrize("offset", [S, 3 * S])
@pytest.mark.parametrize("name", sorted(OFFSET_CASES))
def test_offset_plain_versions_match_pallas_interpret(name, offset):
    window, cap = OFFSET_CASES[name]
    rng = np.random.default_rng(sorted(OFFSET_CASES).index(name) + offset)
    q, do = (_normal(rng, 1, 4, S, D) for _ in range(2))
    k, v = (_normal(rng, 1, 2, S, D) for _ in range(2))
    scale = D ** -0.5
    jo, jlse = _flash_fwd_pallas(q, k, v, True, scale, 32, 32,
                                 interpret=True, window=window, soft_cap=cap,
                                 q_offset=offset)
    seen = _flash_mask(S, S, True, window, "cpu", offset).any(-1).numpy()
    # the backward from the forward's own o and lse, finite (0) on the rows
    # that see no key, as the ring's global lse is
    o_in = np.asarray(jo)
    lse_in = np.where(seen[:, None], np.asarray(jlse), 0.0).astype(np.float32)
    jdq, jdk, jdv = _flash_bwd_pallas(q, k, v, o_in, lse_in, do, True, scale,
                                      32, 32, interpret=True, window=window,
                                      soft_cap=cap, q_offset=offset)
    args = dict(causal=True, sm_scale=scale, sliding_window=window,
                logit_soft_cap=cap, q_offset=offset)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = flash_fwd(tq, tk, tv, **args)
    np.testing.assert_allclose(to.numpy()[:, :, seen], np.asarray(jo)[:, :,
                                                                   seen],
                               atol=ATOL, rtol=RTOL, err_msg="o")
    assert not to[:, :, ~seen].any()
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=ATOL, rtol=RTOL, err_msg="lse")
    lse_t = torch.from_numpy(lse_in[..., 0].copy())
    delta = (tdo * torch.from_numpy(o_in.copy())).sum(-1)
    tdq = flash_dq(tq, tk, tv, tdo, lse_t, delta, **args)
    tdk, tdv = flash_dkv(tq, tk, tv, tdo, lse_t, delta, **args)
    for what, got, want in (("dq", tdq, jdq), ("dk", tdk, jdk),
                            ("dv", tdv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=what)
    # the offset moves the band: at offset 0 the same inputs differ
    assert not torch.allclose(flash_fwd(tq, tk, tv, **dict(args,
                                                           q_offset=0))[0],
                              to, atol=1e-3)


@pytest.mark.parametrize("window,cap", [(None, None), (40, 5.0)])
def test_offset_zero_is_the_call_without_it(window, cap):
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(_normal(rng, 2, 4, 48, D)) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, 2, 2, 48, D)) for _ in range(2))
    args = dict(causal=True, sm_scale=0.25, sliding_window=window,
                logit_soft_cap=cap)
    o, lse = flash_fwd(q, k, v, **args)
    o0, lse0 = flash_fwd(q, k, v, q_offset=0, **args)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    delta = (do * o).sum(-1)
    assert torch.equal(flash_dq(q, k, v, do, lse, delta, **args),
                       flash_dq(q, k, v, do, lse, delta, q_offset=0, **args))
    for a, b in zip(flash_dkv(q, k, v, do, lse, delta, **args),
                    flash_dkv(q, k, v, do, lse, delta, q_offset=0, **args)):
        assert torch.equal(a, b)
    assert torch.equal(_flash_mask(48, 48, True, window, "cpu"),
                       _flash_mask(48, 48, True, window, "cpu", 0))


def test_negative_offset_is_refused():
    x = torch.zeros((1, 2, 8, 16))
    lse = torch.zeros((1, 2, 8))
    args = dict(causal=True, sm_scale=0.25, q_offset=-1)
    for call in (lambda: flash_fwd(x, x, x, **args),
                 lambda: flash_dq(x, x, x, x, lse, lse, **args),
                 lambda: flash_dkv(x, x, x, x, lse, lse, **args),
                 lambda: _check_flash_shapes(x, x, x, True, None, None, -1)):
        with pytest.raises(ValueError, match="q_offset"):
            call()


# -- the ring against the JAX ring -----------------------------------------------

RING_CASES = {            # name: (window, soft cap)
    "plain": (None, None),
    "window": (48, None),
    "softcap": (None, 30.0),
    "window_softcap": (48, 30.0),
}
RING_MESHES = {"seq8": (1, 8), "data2_seq4": (2, 4)}


def _ring_inputs(seed, s=128, d=16, hq=4, hkv=2):
    rng = np.random.default_rng(seed)
    return (_normal(rng, 1, hq, s, d), _normal(rng, 1, hkv, s, d),
            _normal(rng, 1, hkv, s, d), _normal(rng, 1, hq, s, d))


def _jax_ring_grads(mesh_cfg, cases, inputs, **common):
    """(o, dq, dk, dv) of the JAX ``ring_attention`` for each case, all in
    one jit."""
    q, k, v, g = inputs
    mesh = jmake_mesh(mesh_cfg)

    def run(q, k, v):
        outs = {}
        for name, kw in cases.items():
            def loss(q, k, v, kw=kw):
                o = jax_ring_attention(q, k, v, mesh, **common, **kw)
                return jnp.sum(o * g), o
            (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True)(q, k, v)
            outs[name] = (o, *grads)
        return outs

    return {name: [np.asarray(x) for x in got]
            for name, got in jax.jit(run)(q, k, v).items()}


def _port_ring_grads(n, inputs, **kw):
    q, k, v, g = inputs
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ring_attention(tq, tk, tv, make_mesh(MeshConfig(seq=n)), **kw)
    (o * torch.from_numpy(g)).sum().backward()
    return [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]


def _close_all(got, want, what):
    for name, a, b, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (OUT_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def jax_xla_ring():
    inputs = _ring_inputs(12)
    cases = {name: dict(sliding_window=w, logit_soft_cap=c)
             for name, (w, c) in RING_CASES.items()}
    return inputs, {mesh: _jax_ring_grads(JMeshConfig(data=data, seq=seq),
                                          cases, inputs, causal=True)
                    for mesh, (data, seq) in RING_MESHES.items()}


@pytest.mark.parametrize("mesh", sorted(RING_MESHES))
@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_plain_ring_and_grads_match_jax_ring(jax_xla_ring, mesh, name):
    inputs, ref = jax_xla_ring
    window, cap = RING_CASES[name]
    got = _port_ring_grads(RING_MESHES[mesh][1], inputs, causal=True,
                           sliding_window=window, logit_soft_cap=cap)
    _close_all(got, ref[mesh][name], f"{mesh} {name}")


FWD_CASES = {   # name: (seq axis, kwargs): the test_ops.py forward cases
    "window32": (8, dict(sliding_window=32)),
    "window100": (8, dict(sliding_window=100)),
    "window256": (8, dict(sliding_window=256)),
    "window64_softcap50": (8, dict(sliding_window=64, logit_soft_cap=50.0)),
    "non_causal": (4, dict(causal=False)),
}


@pytest.fixture(scope="module")
def jax_forward_cases():
    rng = np.random.default_rng(9)
    q = _normal(rng, 1, 4, 256, 32)
    k, v = _normal(rng, 1, 2, 256, 32), _normal(rng, 1, 2, 256, 32)
    meshes = {n: jmake_mesh(JMeshConfig(data=8 // n, seq=n)) for n in (4, 8)}

    def run(q, k, v):
        return {name: jax_ring_attention(
                    q, k, v, meshes[n], **{"causal": True, **kw})
                for name, (n, kw) in FWD_CASES.items()}

    out = jax.jit(run)(q, k, v)
    return (q, k, v), {name: np.asarray(o) for name, o in out.items()}


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_ring_forward_cases_match_jax(jax_forward_cases, name):
    (q, k, v), ref = jax_forward_cases
    n, kw = FWD_CASES[name]
    kw = {"causal": True, **kw}
    mesh = make_mesh(MeshConfig(seq=n))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ring_attention(tq, tk, tv, mesh, **kw)
    np.testing.assert_allclose(got.numpy(), ref[name], atol=OUT_TOL,
                               rtol=OUT_TOL)
    if kw["causal"]:   # the flash schedule computes the same attention
        got = ring_attention(tq, tk, tv, mesh, use_flash=True, **kw)
        np.testing.assert_allclose(got.numpy(), ref[name], atol=OUT_TOL,
                                   rtol=OUT_TOL)


def test_one_shard_is_flash_attention():
    from k8s_runpod_kubelet_tpu_torch.ops import flash_attention
    q, k, v, _ = (torch.from_numpy(x) for x in _ring_inputs(3, s=64))
    mesh = make_mesh(MeshConfig(seq=1))
    for use_flash in (False, True):
        got = ring_attention(q, k, v, mesh, sliding_window=20,
                             use_flash=use_flash)
        assert torch.equal(got, flash_attention(q, k, v, sliding_window=20))


def test_ring_steps_match_the_jax_table():
    assert _ring_steps(8, 32, 1) == 1
    assert _ring_steps(8, 32, 16) == 2
    assert _ring_steps(8, 32, 33) == 2
    assert _ring_steps(8, 32, 65) == 3
    assert _ring_steps(8, 32, None) == 8
    for n in (2, 4, 8):
        for s in (16, 24, 32, 2048):
            for w in (None, 1, 2, 15, 16, 17, 31, 32, 33, 100, 4096, 10 ** 6):
                assert _ring_steps(n, s, w) == jax_ring_steps(n, s, w)


def test_ring_checks_its_arguments():
    q, k, v, _ = (torch.from_numpy(x) for x in _ring_inputs(4, s=64))
    mesh = make_mesh(MeshConfig(seq=4))
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, k, v, mesh, causal=False, use_flash=True)
    with pytest.raises(ValueError, match="causal"):
        ring_attention(q, k, v, mesh, causal=False, sliding_window=8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, k, v, make_mesh(MeshConfig(seq=3)))
    with pytest.raises(ValueError, match="positions"):
        ring_attention(q, k[:, :, :32], v[:, :, :32], mesh)


@pytest.mark.parametrize("axis,item", [("tensor", "#6"), ("fsdp", "#7.8"),
                                       ("data", "#7.8"), ("expert", "#8"),
                                       ("stage", "#8")])
def test_mesh_refuses_other_axes_by_name(axis, item):
    with pytest.raises(ValueError, match=f"'{axis}'.*Queue 1 {item}"):
        make_mesh(MeshConfig(seq=2, **{axis: 2}))
    mesh = make_mesh(MeshConfig(seq=2))
    assert mesh.in_process and mesh.seq == 2 and mesh.rank == 0
