"""Expert parallelism in the port (ROADMAP Queue 1 #8's EP bullet, with
#6's MoE under a tensor mesh), on the CPU.

- ``moe_mlp`` under an in-process ``expert`` 2 x ``tensor`` 2 mesh (raw
  f32, int8 and int4 expert leaves, laid out by ``shard_params``) against
  JAX ``moe_mlp`` under ``make_mesh(expert=2, tensor=2)`` on 4 of the 8
  virtual CPU devices (its ``_expert_ffn_sharded`` under ``shard_map``):
  within 1e-5 (f32 sums in other orders: the tensor shards' partials);
- the process-group form (4 gloo ranks, rank r at expert r // 2 and
  tensor r % 2, each holding its expert shard's experts and its mlp
  slice) against the in-process form, within 1e-5;
- f32 ``tiny-moe`` engines at EP 2 and at EP 2 x TP 2 (int4 experts
  too, replicated over tensor), and a DeepSeek engine with V3's routing
  fields (latent attention, a dense first layer, a shared expert,
  sigmoid group routing) at EP 2: greedy tokens identical to the
  unsharded port engine's, with speculation on once, and no page leaked;
- the placement: in one process an expert leaf keeps its expert axis
  whole (the shard is its outer part), raw and int8 experts stack their
  tensor shards, int4 experts stay as they are; the router stays whole;
- ``serve_main --expert-parallel`` builds ``tiny-moe --int4
  --tensor-parallel 2 --expert-parallel 2`` and reports both degrees.
"""

import copy
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import moe as jmoe
from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.parallel import MeshConfig as JMeshConfig
from k8s_runpod_kubelet_tpu.parallel import make_mesh as jmake_mesh
from k8s_runpod_kubelet_tpu_torch.models import init_params
from k8s_runpod_kubelet_tpu_torch.models import llama as tllama
from k8s_runpod_kubelet_tpu_torch.models import moe as tmoe
from k8s_runpod_kubelet_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                   shard_params)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
X, K, E, M = 4, 2, 128, 256
NAMES = ("we_gate", "we_up", "we_down")


def _leaves(kind: str, seed: int = 11):
    """h (2, 12, E), the router (E, X) and the expert leaves, raw f32 or
    the JAX quantizer's int8 / int4, as numpy."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 12, E)).astype(np.float32)
    router = (0.3 * rng.normal(size=(E, X))).astype(np.float32)
    raw = {n: (0.05 * rng.normal(size=s)).astype(np.float32)
           for n, s in (("we_gate", (X, E, M)), ("we_up", (X, E, M)),
                        ("we_down", (X, M, E)))}
    if kind == "raw":
        return h, router, raw
    quant = (jquant._quantize_leaf if kind == "int8"
             else jquant._quantize_leaf_int4)
    return h, router, {n: {k: np.asarray(v) for k, v in quant(w).items()}
                       for n, w in raw.items()}


def _torch_leaves(leaves: dict) -> dict:
    return {n: ({k: torch.from_numpy(np.array(v)) for k, v in w.items()}
                if isinstance(w, dict) else torch.from_numpy(np.array(w)))
            for n, w in leaves.items()}


def _laid_out(leaves: dict, mesh) -> dict:
    """The expert leaves as ``shard_params`` lays them out over ``mesh``
    (stacked as one layer, then that layer's slices)."""
    cfg = tllama.tiny_moe(embed_dim=E, mlp_dim=M, n_experts=X,
                          n_experts_per_tok=K, dtype=torch.float32)
    tree = {"layers": {n: ({k: v[None] for k, v in w.items()}
                           if isinstance(w, dict) else w[None])
                       for n, w in _torch_leaves(leaves).items()}}
    shard_params(cfg, tree, mesh)
    return {n: tllama._at(w, 0) for n, w in tree["layers"].items()}


def _port_moe(h, router, leaves, mesh):
    y, _, _ = tmoe.moe_mlp(torch.from_numpy(h), torch.from_numpy(router),
                           *(leaves[n] for n in NAMES), n_experts_per_tok=K,
                           capacity_factor=X / K, dtype=torch.float32,
                           with_losses=False, mesh=mesh)
    return y.numpy()


@pytest.mark.parametrize("kind", ["raw", "int8", "int4"])
def test_moe_mlp_under_expert_x_tensor_matches_jax(kind):
    h, router, leaves = _leaves(kind)
    jmesh = jmake_mesh(JMeshConfig(data=1, expert=2, tensor=2),
                       jax.devices()[:4])
    jl = {n: jax.tree_util.tree_map(jnp.asarray, leaves[n]) for n in NAMES}
    want = np.asarray(jax.jit(lambda hh: jmoe.moe_mlp(
        hh, jnp.asarray(router), *(jl[n] for n in NAMES),
        n_experts_per_tok=K, capacity_factor=X / K, activation=jax.nn.silu,
        dtype=jnp.float32, mesh=jmesh)[0])(jnp.asarray(h)))
    mesh = make_mesh(MeshConfig(expert=2, tensor=2))
    laid = _laid_out(leaves, mesh)
    got = _port_moe(h, router, laid, mesh)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the unsharded port, and the expert shard alone, compute the same
    plain = _port_moe(h, router, _torch_leaves(leaves), None)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    ep_only = make_mesh(MeshConfig(expert=2))
    np.testing.assert_array_equal(
        _port_moe(h, router, _laid_out(leaves, ep_only), ep_only), plain)


def test_the_in_process_placement():
    _, _, raw = _leaves("raw")
    mesh = make_mesh(MeshConfig(expert=2, tensor=2))
    laid = _laid_out(raw, mesh)
    # raw experts: the tensor shards stacked ahead of the whole expert axis
    assert tuple(laid["we_gate"].shape) == (2, X, E, M // 2)
    assert tuple(laid["we_down"].shape) == (2, X, M // 2, E)
    np.testing.assert_array_equal(laid["we_gate"][1].numpy(),
                                  raw["we_gate"][..., M // 2:])
    _, _, q4 = _leaves("int4")
    laid = _laid_out(q4, mesh)
    for n in NAMES:      # int4 experts: replicated over tensor, unmoved
        for k in ("q4", "scale"):
            np.testing.assert_array_equal(laid[n][k].numpy(), q4[n][k])
    cfg = tllama.tiny_moe(embed_dim=E, mlp_dim=M, n_experts=X,
                          dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    router = params["layers"]["router"].clone()
    shard_params(cfg, params, mesh)
    assert torch.equal(params["layers"]["router"], router)
    with pytest.raises(ValueError, match="expert mesh axis 3"):
        shard_params(cfg, params, make_mesh(MeshConfig(expert=3)))
    with pytest.raises(ValueError, match="expert mesh axis 2"):
        tllama.LlamaModel(tllama.tiny_llama(), "cpu",
                          make_mesh(MeshConfig(expert=2)))


# -- the process-group form ---------------------------------------------------------

_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, n, base = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{base}.store",
                            world_size=n, rank=rank)
    sys.path.insert(0, sys.argv[4])
    import test_torch_expert_parallel as t
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(expert=2, tensor=2), group=dist.group.WORLD)
    assert (mesh.expert_rank, mesh.rank) == divmod(rank, 2)
    res = {}
    for kind in ("raw", "int8", "int4"):
        h, router, leaves = t._leaves(kind)
        res[kind] = t._port_moe(h, router, t._laid_out(leaves, mesh), mesh)
    np.savez(f"{base}{rank}.npz", **res)
    dist.destroy_process_group()
''')


def test_process_group_form_equals_the_in_process_form(tmp_path):
    base, n = str(tmp_path / "ep"), 4
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n), base,
         os.path.dirname(os.path.abspath(__file__))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for r, p in enumerate(procs):
            text = p.communicate(timeout=TIMEOUT)[0].decode()
            assert p.returncode == 0, f"rank {r}:\n{text[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mesh = make_mesh(MeshConfig(expert=2, tensor=2))
    for kind in ("raw", "int8", "int4"):
        h, router, leaves = _leaves(kind)
        want = _port_moe(h, router, _laid_out(leaves, mesh), mesh)
        for r in range(n):
            np.testing.assert_allclose(np.load(f"{base}{r}.npz")[kind], want,
                                       rtol=1e-5, atol=1e-5)


# -- engines ------------------------------------------------------------------------

MOE = tllama.tiny_moe(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                      dtype=torch.float32)
V3 = tllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=3, n_heads=4,
                     n_kv_heads=4, head_dim=16, mla_latent_dim=32,
                     mla_rope_dim=8, mlp_dim=48, max_seq_len=256,
                     n_experts=4, n_experts_per_tok=2, n_shared_experts=1,
                     router_sigmoid_bias=True, router_n_group=2,
                     router_topk_group=1, routed_scaling_factor=2.5,
                     n_dense_prefix=1, dense_prefix_mlp_dim=96,
                     dtype=torch.float32)
SC = dict(slots=4, max_prefill_len=32, cache_len=128, max_new_tokens=8,
          kv_page_tokens=8)
SHARED = [((i * 37) % 120) + 1 for i in range(24)]


def _params(cfg, seed: int):
    """Seeded weights: norms near 1, the router at 1.0, V3's correction
    bias at 0.05, every other leaf at 0.08."""
    rng = np.random.default_rng(seed)
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def fill(name, t):
        scale = (1.0 if name == "router" else 0.05 if name == "router_bias"
                 else 0.08)
        x = rng.normal(size=tuple(t.shape))
        x = 1.0 + 0.1 * x if name.endswith("norm") else scale * x
        return torch.from_numpy(x.astype(np.float32)).to(t.dtype)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v)
                for k, v in d.items()}

    return walk(tree)


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)],
           SHARED + [int(t) for t in rng.integers(1, 128, 9)]]
    out += [[int(t) for t in rng.integers(1, 128, n)] for n in (3, 17, 40)]
    return out


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _tokens(cfg, params, mesh, **kw):
    engine = ServingEngine(cfg, copy.deepcopy(params), ServingConfig(
        **SC, **kw), device="cpu", mesh=mesh).start()
    try:
        out = [engine.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in _prompts()]
        engine.drain()
        deadline = time.monotonic() + TIMEOUT
        while not engine.drained:
            assert time.monotonic() < deadline, "engine did not drain"
            time.sleep(0.02)
        assert _leak_free(engine)
        return out, engine.debug_snapshot()
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def moe_params():
    return _params(MOE, 20261019)


@pytest.mark.parametrize("ep,tp,kw", [
    (2, 1, {}),
    (2, 2, {}),
    (2, 2, {"speculate_k": 2}),
    (2, 2, {"quantize_int4": True}),
], ids=["ep2", "ep2_tp2", "ep2_tp2_speculate", "ep2_tp2_int4"])
def test_moe_engine_tokens_equal_the_unsharded_engine(moe_params, ep, tp,
                                                      kw):
    want, _ = _tokens(MOE, moe_params, None, **kw)
    got, snap = _tokens(MOE, moe_params, make_mesh(MeshConfig(
        expert=ep, tensor=tp)), **kw)
    assert got == want
    assert (snap["expert_parallel"], snap["tensor_parallel"]) == (ep, tp)


def test_deepseek_v3_fields_engine_at_ep2_equals_the_unsharded_engine():
    params = _params(V3, 20261020)
    want, _ = _tokens(V3, params, None)
    got, snap = _tokens(V3, params, make_mesh(MeshConfig(expert=2)))
    assert got == want and snap["expert_parallel"] == 2
    with pytest.raises(ValueError, match="Queue 1 #9"):
        ServingEngine(V3, copy.deepcopy(params), ServingConfig(**SC),
                      device="cpu",
                      mesh=make_mesh(MeshConfig(expert=2, tensor=2)))


def test_serve_main_builds_an_int4_ep_x_tp_engine():
    args = serve_main.parse_args([
        "--model", "tiny-moe", "--device", "cpu", "--int4",
        "--tensor-parallel", "2", "--expert-parallel", "2", "--slots", "2",
        "--cache-len", "64", "--max-new-tokens", "3"])
    engine, _ = serve_main.build_engine(args)
    try:
        snap = engine.debug_snapshot()
        assert (snap["tensor_parallel"], snap["expert_parallel"]) == (2, 2)
        out = engine.submit([5, 9, 2]).result(timeout=TIMEOUT)
        assert len(out["tokens"]) == 3
    finally:
        engine.stop()
