"""The port's tensor-parallel serving against the JAX package's, on the CPU.

The JAX side runs on a ``tensor`` mesh of the 8 virtual CPU devices that
``tests/conftest.py`` sets up; the port's side on an in-process mesh
(``parallel.Mesh`` with ``group`` None: every shard in one process).

- ``int4_matmul_sharded``: the port's plain version (per shard, then
  gathered) against the JAX ``int4_matmul_sharded`` on a 2- and a 4-device
  mesh (its ``shard_map`` over ``_dispatch_2d``, the XLA fallback on the
  CPU), f32 activations, within 1e-6;
- the rules tables: the port's ``param_logical_axes`` and
  ``quantized_logical_axes`` equal the JAX ones leaf by leaf, for dense,
  tied, MLA and MoE configs at both widths;
- ``paged_verify_step`` of an f32 ``tiny_llama`` at tensor 2 and 4 against
  the JAX ``paged_verify_step`` under a mesh of as many devices, on the
  same ``params_from_jax`` weights (f32, int8 and int4), over an f32 and
  an int8 arena, and over a replicated arena (a kv-head count the mesh does
  not divide): logits within 1e-5 on two steps (a chunk, then a verify
  over it), and the arena the port holds per shard, put back together,
  equal to the JAX arena (f32 within 1e-5, int8 within one step). Where an
  int8 page element differs by a step (an f32 difference of one ulp at a
  rounding tie, which cascades through the later layers' K/V rows), the
  logits are held to 5e-3 and, in every case, within 1e-5 of the port's
  own one-device step on the same weights;
- the port's TP engine gives the JAX engine's greedy tokens on the f32
  tiny model: plain with a shared prefix and an n = 2 group (the
  dense-scratch route, its cached prefix gathered from the sharded arena
  and its pages copied back), speculative, int4 weights over an int8 arena, and a
  replicated arena, with zero leaked pages after drain;
- ``serve_main`` refuses a tensor degree below 1, one that does not divide
  the head counts, and MLA models under it, and an expert degree below 1,
  without an MoE model or not dividing its expert count, before any
  weight is drawn; ``Mesh`` refuses ``tensor`` beside ``seq``.

Tolerances: f32 sums in other orders over two layers (1e-5 on logits of
magnitude ~1; the per-shard products and the psum reorder the sums).
"""

import dataclasses
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import \
    param_logical_axes as jax_param_logical_axes
from k8s_runpod_kubelet_tpu.models.quant import \
    quantize_params as jax_quantize_params
from k8s_runpod_kubelet_tpu.models.quant import \
    quantized_logical_axes as jax_quantized_logical_axes
from k8s_runpod_kubelet_tpu.ops.int4_matmul import \
    int4_matmul_sharded as jax_int4_matmul_sharded
from k8s_runpod_kubelet_tpu.parallel import MeshConfig as JMeshConfig
from k8s_runpod_kubelet_tpu.parallel import make_mesh as jmake_mesh
from k8s_runpod_kubelet_tpu.parallel import param_shardings
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.quant import (
    _quantize_leaf_int4, quantized_logical_axes)
from k8s_runpod_kubelet_tpu_torch.ops import int4_matmul_sharded
from k8s_runpod_kubelet_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                   param_logical_axes,
                                                   shard_params)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
# 8 q heads and 4 kv heads: tensor 2 and 4 both shard the arena
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=256, n_layers=2,
                         n_heads=8, n_kv_heads=4, mlp_dim=256,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
# 2 kv heads: tensor 4 does not divide them, and the arena replicates
JCFG_REP = dataclasses.replace(JCFG, n_kv_heads=2)
T, N_PAGES, COLS = 8, 24, 8


def _tree(jcfg, seed=20261016):
    """Seeded numpy parameters in the JAX layout (norms near 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _jmesh(n):
    return jmake_mesh(JMeshConfig(data=1, tensor=n), jax.devices()[:n])


# -- int4_matmul_sharded ------------------------------------------------------------

@pytest.mark.parametrize("n,rows", [(2, 1), (2, 13), (4, 8)])
def test_int4_matmul_sharded_plain_matches_jax(n, rows):
    rng = np.random.default_rng(n * 100 + rows)
    kin, out = 512, 96 * n
    leaf = _quantize_leaf_int4(torch.from_numpy(
        (0.05 * rng.normal(size=(kin, out))).astype(np.float32)))
    q4, scale = leaf["q4"].numpy(), leaf["scale"].numpy()
    h = rng.normal(size=(rows, kin)).astype(np.float32)
    want = np.asarray(jax_int4_matmul_sharded(
        jnp.asarray(h), jnp.asarray(q4), jnp.asarray(scale), _jmesh(n)))
    mesh = make_mesh(MeshConfig(tensor=n))
    q4s = torch.from_numpy(q4).unflatten(1, (n, -1)).movedim(1, 0)
    scales = torch.from_numpy(scale).unflatten(2, (n, -1)).movedim(2, 0)
    got = int4_matmul_sharded(torch.from_numpy(h), q4s.contiguous(),
                              scales.contiguous(), mesh)
    assert got.shape == (rows, out) and int4_matmul_sharded.launches == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- the rules tables ---------------------------------------------------------------

def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("name", ["dense", "tied", "mla", "mla_lora", "moe"])
def test_rules_tables_match_jax(name, bits):
    jcfg = {"dense": JCFG,
            "tied": dataclasses.replace(JCFG, tie_embeddings=True),
            "mla": jllama.tiny_llama(n_heads=4, n_kv_heads=4, head_dim=32,
                                     mla_latent_dim=64, mla_rope_dim=16),
            "mla_lora": jllama.tiny_llama(n_heads=4, n_kv_heads=4,
                                          head_dim=32, mla_latent_dim=64,
                                          mla_rope_dim=16,
                                          mla_q_lora_rank=48),
            "moe": jllama.tiny_moe()}[name]
    cfg = config_from_jax(jcfg, torch.float32)
    if bits is None:
        want, got = jax_param_logical_axes(jcfg), param_logical_axes(cfg)
    else:
        want = jax_quantized_logical_axes(jcfg, bits=bits)
        got = quantized_logical_axes(cfg, bits=bits)
    assert _as_tuples(got) == _as_tuples(want)


# -- paged_verify_step --------------------------------------------------------------

def _jax_side(jcfg, tree, bits, n):
    """The JAX model under a tensor mesh of n devices and its params placed
    by the JAX rules."""
    mesh = _jmesh(n)
    if bits is None:
        params, axes = tree, jax_param_logical_axes(jcfg)
    else:
        params = jax_quantize_params(jcfg, tree, bits=bits, commit=False)
        axes = jax_quantized_logical_axes(jcfg, bits=bits)
    params = jax.device_put(params, param_shardings(mesh, axes))
    return jllama.LlamaModel(jcfg, mesh), params


def _port_side(jcfg, tree, bits, n):
    host = tree if bits is None else jax.tree_util.tree_map(
        np.asarray, jax_quantize_params(jcfg, tree, bits=bits, commit=False))
    cfg = config_from_jax(jcfg, torch.float32)
    mesh = make_mesh(MeshConfig(tensor=n))
    params = shard_params(cfg, params_from_jax(host, cfg, device="cpu"),
                          mesh)
    return LlamaModel(cfg, "cpu", mesh), params


def _whole(section, shards, layers):
    """A port arena section as one (L, P + 1, T, Hkv, ...) tensor: the
    shards' heads side by side."""
    if shards == 1:
        return section
    x = section.unflatten(0, (shards, layers)).movedim(0, 3)
    return x.flatten(3, 4)


# (config, weight bits, int8 arena, tensor, arena shards)
PAGED_CASES = {
    "f32_tp2": (JCFG, None, False, 2, 2),
    "f32_int8_arena_tp4": (JCFG, None, True, 4, 4),
    "int8_tp4": (JCFG, 8, False, 4, 4),
    "int8_int8_arena_tp2": (JCFG, 8, True, 2, 2),
    "int4_int8_arena_tp2": (JCFG, 4, True, 2, 2),
    "int4_tp4": (JCFG, 4, False, 4, 4),
    "replicated_arena_tp4": (JCFG_REP, None, False, 4, 1),
    "replicated_int8_arena_tp4": (JCFG_REP, 4, True, 4, 1),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_verify_step_matches_jax_under_tp(case):
    jcfg, bits, kv_int8, n, shards = PAGED_CASES[case]
    tree = _tree(jcfg)
    jmodel, jparams = _jax_side(jcfg, tree, bits, n)
    model, params = _port_side(jcfg, tree, bits, n)
    one, one_params = _port_side(jcfg, tree, bits, 1)
    jstep = jax.jit(jmodel.paged_verify_step)
    jarena = jmodel.init_paged_arena(N_PAGES, T, quantize=kv_int8)
    arena = model.init_paged_arena(N_PAGES, T, quantize=kv_int8)
    arena_1 = one.init_paged_arena(N_PAGES, T, quantize=kv_int8)
    assert arena["k"].shape == (jcfg.n_layers * shards, N_PAGES + 1, T,
                                jcfg.n_kv_heads // shards, jcfg.head_dim_)
    table = np.random.default_rng(5).permutation(N_PAGES)[:2 * COLS] \
        .reshape(2, COLS).astype(np.int32)
    rng = np.random.default_rng(8)
    lengths = np.zeros((2,), np.int32)
    steps = []
    for width, n_tok in ((24, np.array([21, 17], np.int32)),
                         (3, np.array([3, 2], np.int32))):
        toks = rng.integers(1, 128, (2, width)).astype(np.int32)
        args = [torch.from_numpy(x) for x in (toks, table, lengths, n_tok)]
        lj, jarena = jstep(jparams, jnp.asarray(toks), jarena,
                           jnp.asarray(table), jnp.asarray(lengths),
                           n_tokens=jnp.asarray(n_tok))
        lt, arena = model.paged_verify_step(
            params, args[0], arena, args[1], args[2], n_tokens=args[3])
        l1, arena_1 = one.paged_verify_step(
            one_params, args[0], arena_1, args[1], args[2],
            n_tokens=args[3])
        steps.append((n_tok, np.asarray(lj), lt.numpy(), l1.numpy()))
        lengths = lengths + n_tok
    # the arena the port holds per shard, put back together (the JAX arena
    # has no sink page)
    steps_off = 0
    for name, a in arena.items():
        got = _whole(a, shards, jcfg.n_layers).numpy()[:, :N_PAGES]
        want = np.asarray(jarena[name])
        if a.dtype == torch.int8:
            off = np.abs(got.astype(np.int32) - want)
            assert off.max() <= 1, name
            steps_off += int((off > 0).sum())
        elif not name.endswith("scale"):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=f"{case} {name}")
    # logits within 1e-5 of the JAX step where the int8 pages agree; where
    # an f32 difference of one ulp moved an int8 rounding by one step, the
    # step moves that layer's attention, and the later layers' K/V rows
    # round differently in turn (~1e-3 in the logits): held to 5e-3 then
    atol = 1e-5 if not steps_off else 5e-3
    for n_tok, lj, lt, l1 in steps:
        for b, k in enumerate(n_tok):
            np.testing.assert_allclose(lt[b, :k], lj[b, :k], atol=atol,
                                       rtol=0, err_msg=case)
            # against the port's own one-device step: the tensor layout
            # reorders f32 sums only
            np.testing.assert_allclose(lt[b, :k], l1[b, :k], atol=1e-5,
                                       rtol=0, err_msg=case)


# -- the engine ---------------------------------------------------------------------

SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)],
           SHARED + [int(t) for t in rng.integers(1, 128, 9)]]
    for n in (3, 17, 40):
        out.append([int(t) for t in rng.integers(1, 128, n)])
    out.append([5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6])    # drafts to accept
    return out


def _drained_leak_free(engine) -> bool:
    engine.drain()
    wait = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            break
        wait.wait(0.05)
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (engine.drained
            and store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


# (config, tensor, ServingConfig fields)
ENGINE_CASES = {
    "plain_tp2": (JCFG, 2, {}),
    "speculative_tp4": (JCFG, 4, {"speculate_k": 3}),
    "int4_kv_int8_tp2": (JCFG, 2, {"quantize_int4": True,
                                   "quantize_kv_int8": True}),
    "replicated_arena_tp2": (JCFG, 2, {"kv_arena_sharding": "replicate"}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_tp_engine_greedy_tokens_match_the_jax_engine(case):
    jcfg, n, extra = ENGINE_CASES[case]
    sc = dict(slots=4, max_prefill_len=32, cache_len=128,
              max_new_tokens=12, kv_page_tokens=8, **extra)
    tree = _tree(jcfg, seed=3)
    prompts = _prompts()
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**sc)).start()
    try:
        # one at a time: the shared-prefix pair then hits the trie
        want = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
                for p in prompts]
    finally:
        jeng.stop()
    cfg = config_from_jax(jcfg, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**sc), device="cpu",
                        mesh=make_mesh(MeshConfig(tensor=n))).start()
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
        # an n = 2 group prefills once through the dense-scratch route,
        # its cached prefix pages gathered from the arena
        hits = eng.counters["prefix_cache_hits"]
        group = [f.result(timeout=TIMEOUT)["tokens"]
                 for f in eng.submit_group(prompts[1], 2)]
        assert eng.counters["prefix_cache_hits"] == hits + 1
        snap = eng.debug_snapshot()
        assert snap["paged_tp_shards"] == n
        assert snap["kv_arena_shards"] == (
            1 if extra.get("kv_arena_sharding") == "replicate" else n)
        assert snap["counters"]["prefix_cache_hits"] >= 1
        assert snap["counters"]["dense_prefills"] == 1
        if extra.get("speculate_k"):
            assert snap["counters"]["spec_accepted"] > 0
        assert _drained_leak_free(eng)
    finally:
        eng.stop()
    assert got == want
    assert group == [want[1], want[1]]


# -- refusals -----------------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["--tensor-parallel", "0"], ">= 1"),
    (["--tensor-parallel", "3"], "divide the model's head counts"),
    (["--model", "tiny-mla", "--tensor-parallel", "2"], "Queue 1 #9"),
    # MoE serves under a tensor mesh (tests/test_torch_expert_parallel.py);
    # the expert degree is checked as the JAX CLI checks it
    (["--model", "tiny-moe", "--expert-parallel", "0"], ">= 1"),
    (["--expert-parallel", "2"], "needs an MoE model"),
    (["--model", "tiny-moe", "--expert-parallel", "3"],
     "n_experts it divides"),
])
def test_serve_main_refuses_before_any_weight(argv, match, monkeypatch):
    import k8s_runpod_kubelet_tpu_torch.models as models
    import k8s_runpod_kubelet_tpu_torch.models.quant as quant

    def drawn(*a, **k):
        raise AssertionError("weights drawn before the refusal")

    monkeypatch.setattr(models, "init_params", drawn)
    monkeypatch.setattr(quant, "init_quantized_params", drawn)
    args = serve_main.parse_args(["--model", "tiny", "--device", "cpu"]
                                 + argv)
    with pytest.raises(ValueError, match=match):
        serve_main.build_engine(args)
    assert serve_main.main(["--model", "tiny", "--device", "cpu"]
                           + argv) == 1


def test_tp_serve_main_serves_on_the_cpu():
    args = serve_main.parse_args(["--model", "tiny", "--device", "cpu",
                                  "--tensor-parallel", "2", "--int4",
                                  "--kv-int8", "--slots", "2",
                                  "--cache-len", "128",
                                  "--max-new-tokens", "4"])
    engine, _ = serve_main.build_engine(args)
    try:
        out = engine.submit([1, 2, 3]).result(timeout=TIMEOUT)
        snap = engine.debug_snapshot()
    finally:
        engine.stop()
    assert len(out["tokens"]) == 4
    assert snap["paged_tp_shards"] == 2 and snap["kv_arena_shards"] == 2
    assert engine.params["layers"]["wq"]["q4"].shape[1] == 2


def test_meshes_shard_one_axis():
    with pytest.raises(ValueError, match="tensor.*seq"):
        make_mesh(MeshConfig(seq=2, tensor=2))
    mesh = make_mesh(MeshConfig(tensor=4))
    assert mesh.tensor == 4 and mesh.seq == 1 and mesh.shards == 4
    cfg = config_from_jax(JCFG, torch.float32)
    with pytest.raises(ValueError, match="tensor-parallel training"):
        from k8s_runpod_kubelet_tpu_torch.workloads.train import (
            TrainConfig, Trainer)
        Trainer(cfg, TrainConfig(), device="cpu", mesh=mesh)
