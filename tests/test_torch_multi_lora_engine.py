"""The port's multi-LoRA engine on the CPU (f32 tiny models, seeded numpy
weights, adapters with non-zero B):

- greedy output over a mixed batch (base and three adapters, one of them
  from an ``.npz`` the JAX ``save_adapter`` wrote) token-identical to the
  JAX ``ServingEngine`` on the same weights and adapters, with all seven
  targets; an adapter request's tokens differ from the base's;
- the same with int4 and int8 base weights over an int8 arena;
- speculative verify with adapters == the plain loop, drafts accepted;
- the dense-scratch route (a spied full pool) and an n = 2 group with an
  adapter == the native route;
- per-adapter trie roots (no page shared between two adapters' runs of
  one prompt), ``drop_adapter`` on re-registration, no leak, and an
  adapter's own copy of a registered prefix filled once;
- registry full, unknown adapter, shapes and targets refused, MLA refused,
  MoE: MLP targets refused and attention targets served token-identical
  to the JAX MoE engine;
- an in-process tensor mesh of 2 == TP 1 with adapters;
- a re-registration landing mid-prefill waits for that prefill: the
  request's first token is the old adapter's, the trie keeps nothing of
  it, and later requests read the new adapter.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import lora as jlora
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import init_params, load_adapter
from k8s_runpod_kubelet_tpu_torch.models import tiny_mla
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
JCFG = jllama.tiny_llama(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32)
JMOE = jllama.tiny_moe(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32)
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages
NAMES = ("a1", "a2", "a3")


def _tree(jcfg, seed: int):
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = 0.3 if name == "router" else 0.05
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def adapter(jcfg, seed: int, targets=TARGETS, rank=4) -> dict:
    """One adapter {t: {"a": (L, in, r), "b": (L, r, out), "scale": (L,)}}
    as numpy, B non-zero (the ``_trained_lora`` idiom)."""
    rng = np.random.default_rng(seed)
    e, hd, m = jcfg.embed_dim, jcfg.head_dim_, jcfg.mlp_dim
    dims = {"wq": (e, jcfg.n_heads * hd), "wk": (e, jcfg.n_kv_heads * hd),
            "wv": (e, jcfg.n_kv_heads * hd), "wo": (jcfg.n_heads * hd, e),
            "w_gate": (e, m), "w_up": (e, m), "w_down": (m, e)}
    L = jcfg.n_layers
    return {t: {"a": (rng.normal(size=(L, dims[t][0], rank))
                      / np.sqrt(dims[t][0])).astype(np.float32),
                "b": (0.3 * rng.normal(size=(L, rank, dims[t][1])))
                .astype(np.float32),
                "scale": np.full((L,), 2.0, np.float32)}
            for t in targets}


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)],
           SHARED + [int(t) for t in rng.integers(1, 128, 9)]]
    for n in (3, 17, 40, 8):
        out.append([int(t) for t in rng.integers(1, 128, n)])
    return out


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=12, kv_page_tokens=8, lora_rank=4,
                lora_targets=TARGETS, max_adapters=3)
    base.update(kw)
    return base


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _drain(engine):
    engine.drain()
    deadline = time.monotonic() + TIMEOUT
    while not engine.drained:
        assert time.monotonic() < deadline, "engine did not drain"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def tree():
    return _tree(JCFG, 20261017)


@pytest.fixture(scope="module")
def adapters():
    return {name: adapter(JCFG, seed) for name, seed in zip(NAMES, (1, 2, 3))}


def _engine(tree, adapters, jcfg=JCFG, mesh=None, **kw):
    cfg = config_from_jax(jcfg, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**_config(**kw)), device="cpu",
                        mesh=mesh)
    for name, ad in adapters.items():
        eng.register_adapter(name, ad)
    return eng.start()


def _traffic():
    """(prompt, adapter) pairs cycling base, a1, a2, a3."""
    cycle = ("",) + NAMES
    return [(p, cycle[i % 4]) for i, p in enumerate(_prompts())]


def _serve(engine, traffic, **kw):
    futs = [engine.submit(p, adapter=a, **kw) for p, a in traffic]
    return [f.result(timeout=TIMEOUT)["tokens"] for f in futs]


def test_mixed_batch_matches_the_jax_engine(tree, adapters, tmp_path):
    traffic = _traffic()
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config())).start()
    try:
        for name, ad in adapters.items():
            jeng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                               ad))
        # all at once: every decode batch mixes the four
        want = _serve(jeng, traffic)
    finally:
        jeng.stop()
    # a1 reaches the port as the JAX package's own file
    path = jlora.save_adapter(str(tmp_path / "a1"), adapters["a1"])
    eng = _engine(tree, {"a1": load_adapter(path), "a2": adapters["a2"],
                         "a3": adapters["a3"]})
    try:
        got = _serve(eng, traffic)
        base = eng.submit(traffic[1][0]).result(timeout=TIMEOUT)["tokens"]
        _drain(eng)
        assert _leak_free(eng)
        snap = eng.debug_snapshot()
        assert snap["multi_lora"] and snap["adapters"] == list(NAMES)
        assert snap["counters"]["adapters_registered"] == 3
        steps = [r for r in eng.recorder.records()
                 if r.get("batch", {}).get("mode") == "decode"]
        assert max(r["batch"]["adapters"] for r in steps) >= 2
    finally:
        eng.stop()
    assert got == want
    # non-vacuous: the adapter changes the tokens of the same prompt
    assert traffic[1][1] == "a1" and got[1] != base


@pytest.mark.parametrize("weights", ["int4", "int8"])
def test_quantized_weights_with_adapters_match_the_jax_engine(
        tree, adapters, weights):
    """int4 or int8 base weights over an int8 arena: the deltas stay in the
    compute dtype beside the quantized products, in both packages."""
    flags = dict(quantize_int4=weights == "int4",
                 quantize_int8=weights == "int8", quantize_kv_int8=True)
    traffic = _traffic()
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config(**flags))).start()
    try:
        for name, ad in adapters.items():
            jeng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                               ad))
        want = _serve(jeng, traffic)
    finally:
        jeng.stop()
    eng = _engine(tree, adapters, **flags)
    try:
        got = _serve(eng, traffic)
        assert eng.debug_snapshot()["weights"] == weights
    finally:
        eng.stop()
    assert got == want


def test_speculative_verify_with_adapters(tree, adapters):
    rep = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
    traffic = [(rep, "a1"), (rep, ""), ([3, 1, 4, 1, 5, 9, 2, 6], "a2"),
               (rep + [9, 9, 9], "a3")]
    plain = _engine(tree, adapters)
    spec = _engine(tree, adapters, speculate_k=3)
    try:
        want = _serve(plain, traffic, max_new_tokens=24)
        got = _serve(spec, traffic, max_new_tokens=24)
        assert spec.counters["paged_speculative_steps"] > 0
        assert spec.counters["spec_accepted"] > 0
        _drain(spec)
        assert _leak_free(spec)
    finally:
        plain.stop()
        spec.stop()
    assert got == want


def test_dense_route_and_groups_with_an_adapter(tree, adapters):
    traffic = _traffic()
    native = _engine(tree, adapters)
    dense = _engine(tree, adapters)
    # a pool that never holds a run up front: every prompt dense-routes
    dense._prefill_paged_native = lambda tokens, adapter_id=0: None
    try:
        want = [native.submit(p, adapter=a).result(timeout=TIMEOUT)[
            "tokens"] for p, a in traffic]
        got = [dense.submit(p, adapter=a).result(timeout=TIMEOUT)["tokens"]
               for p, a in traffic]
        assert dense.counters["dense_prefills"] == len(traffic)
        # an n = 2 group prefills once through the dense route
        heads = native.counters["dense_prefills"]
        group = [f.result(timeout=TIMEOUT)["tokens"] for f in
                 native.submit_group(traffic[2][0], 2, adapter="a2")]
        assert native.counters["dense_prefills"] == heads + 1
        _drain(dense)
        _drain(native)
        assert _leak_free(dense) and _leak_free(native)
    finally:
        native.stop()
        dense.stop()
    assert got == want
    assert group == [want[2], want[2]]


def _root_pages(engine, adapter_id) -> set:
    trie = engine._kv_store.trie
    stack, pages = list(trie._roots.get(adapter_id, {}).values()), set()
    while stack:
        node = stack.pop()
        pages.add(node.page)
        stack.extend(node.children.values())
    return pages


def test_trie_roots_per_adapter_and_drop_on_reregistration(tree, adapters):
    prompt = _prompts()[1]
    eng = _engine(tree, adapters)
    fresh = _engine(tree, {"a1": adapter(JCFG, 9)})
    try:
        for a in ("", "a1", "a1"):
            eng.submit(prompt, adapter=a).result(timeout=TIMEOUT)
        assert eng.prefix_cache_stats()["adapters"] == [0, 1]
        assert eng.counters["prefix_cache_hits"] == 1   # a1 on a1 only
        base_pages, a1_pages = _root_pages(eng, 0), _root_pages(eng, 1)
        assert base_pages and a1_pages and not base_pages & a1_pages
        old = eng.submit(prompt, adapter="a1").result(timeout=TIMEOUT)
        assert eng.register_adapter("a1", adapter(JCFG, 9)) == 1
        assert eng.prefix_cache_stats()["adapters"] == [0]
        assert _root_pages(eng, 0) == base_pages
        new = eng.submit(prompt, adapter="a1").result(timeout=TIMEOUT)
        want = fresh.submit(prompt, adapter="a1").result(timeout=TIMEOUT)
        # a registered prefix is the base's; an adapter's first prompt over
        # it fills the adapter's own pages, its second hits them
        eng.register_prefix(SHARED)
        for tail in ([1, 2], [3, 4]):
            eng.submit(SHARED + tail, adapter="a2").result(timeout=TIMEOUT)
        assert eng.counters["prefix_adapter_fills"] == 1
        assert eng.counters["prefix_hits"] == 1
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
        fresh.stop()
    assert new["tokens"] == want["tokens"] != old["tokens"]


def test_registry_and_refusals(tree, adapters):
    cfg = config_from_jax(JCFG, torch.float32)
    eng = _engine(tree, {}, max_adapters=2, lora_targets=("wq", "wv"))
    small = {t: adapters["a1"][t] for t in ("wq", "wv")}
    try:
        assert eng.register_adapter("x", small) == 1
        assert eng.register_adapter("y", small) == 2
        with pytest.raises(ValueError, match=r"adapter registry full \(2\)"):
            eng.register_adapter("z", small)
        assert eng.register_adapter("x", small) == 1    # a rewrite fits
        with pytest.raises(ValueError, match="not in lora_targets"):
            eng.register_adapter("x", adapters["a1"])
        bad = {"wq": dict(small["wq"], a=small["wq"]["a"][:, :, :2])}
        with pytest.raises(ValueError, match="don't match rank-4"):
            eng.register_adapter("x", bad)
        with pytest.raises(ValueError, match="name required"):
            eng.register_adapter("", small)
        fut = eng.submit([1, 2, 3], adapter="nope")
        with pytest.raises(ValueError, match="unknown adapter 'nope'"):
            fut.result(timeout=TIMEOUT)
        assert eng.adapter_names == ("x", "y")
    finally:
        eng.stop()
    params = params_from_jax(tree, cfg, device="cpu")
    off = ServingEngine(cfg, params, ServingConfig(**_config(lora_rank=0)),
                        device="cpu")
    assert not off.multi_lora_enabled
    with pytest.raises(ValueError, match="without lora_rank"):
        off.register_adapter("x", small)
    with pytest.raises(ValueError, match="unknown lora_targets"):
        ServingEngine(cfg, params, ServingConfig(**_config(
            lora_targets=("wq", "w_dkv"))), device="cpu")
    mcfg = tiny_mla(vocab_size=64, embed_dim=64, n_layers=1,
                    dtype=torch.float32)
    with pytest.raises(ValueError, match="does not support MLA"):
        ServingEngine(mcfg, init_params(mcfg, torch.Generator(), "cpu"),
                      ServingConfig(**_config()), device="cpu")


def test_moe_serves_attention_targets_and_refuses_mlp_ones():
    tree = _tree(JMOE, 5)
    ads = {n: adapter(JMOE, s, targets=("wq", "wv", "wo"))
           for n, s in zip(NAMES, (1, 2, 3))}
    kw = dict(lora_targets=("wq", "wv", "wo"))
    traffic = _traffic()
    jeng = JaxServingEngine(JMOE, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config(**kw))).start()
    try:
        for name, ad in ads.items():
            jeng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                               ad))
        want = _serve(jeng, traffic)
    finally:
        jeng.stop()
    eng = _engine(tree, ads, jcfg=JMOE, **kw)
    try:
        got = _serve(eng, traffic)
    finally:
        eng.stop()
    assert got == want
    cfg = config_from_jax(JMOE, torch.float32)
    with pytest.raises(ValueError, match="no dense mlp weights"):
        ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                      ServingConfig(**_config()), device="cpu")


def test_tensor_mesh_of_two_equals_one_device(tree, adapters):
    traffic = _traffic()
    one = _engine(tree, adapters)
    two = _engine(tree, adapters, mesh=make_mesh(MeshConfig(tensor=2)))
    try:
        want = _serve(one, traffic)
        got = _serve(two, traffic)
        group = [f.result(timeout=TIMEOUT)["tokens"] for f in
                 two.submit_group(traffic[3][0], 2, adapter="a3")]
        assert two.debug_snapshot()["paged_tp_shards"] == 2
    finally:
        one.stop()
        two.stop()
    assert got == want
    assert group == [want[3], want[3]]


def test_reregistration_mid_prefill_waits_for_that_prefill(tree, adapters):
    """A 40-token prompt under a1 in 8-token chunks, held after its first
    chunk: a re-registration of a1 blocks until the prefill is done, the
    request's first token is the old adapter's, the trie keeps none of
    its pages, and the next a1 request reads the new adapter."""
    prompt = _prompts()[4]
    new_a1 = adapter(JCFG, 9)
    old_ref = _engine(tree, {"a1": adapters["a1"]})
    new_ref = _engine(tree, {"a1": new_a1})
    eng = _engine(tree, adapters, serving_chunk_tokens=8)
    held, go = threading.Event(), threading.Event()
    yield_once = eng._yield_between_chunks

    def hold():
        if not held.is_set():
            held.set()
            assert go.wait(TIMEOUT)
        yield_once()

    eng._yield_between_chunks = hold
    try:
        want_old = old_ref.submit(prompt, adapter="a1", max_new_tokens=1) \
            .result(timeout=TIMEOUT)["tokens"]
        want_new = new_ref.submit(prompt, adapter="a1", max_new_tokens=1) \
            .result(timeout=TIMEOUT)["tokens"]
        assert want_old != want_new
        fut = eng.submit(prompt, adapter="a1", max_new_tokens=1)
        assert held.wait(TIMEOUT)
        reg = threading.Thread(target=eng.register_adapter,
                               args=("a1", new_a1))
        reg.start()
        reg.join(0.5)
        assert reg.is_alive(), "re-registration did not wait"
        go.set()
        reg.join(TIMEOUT)
        assert not reg.is_alive()
        assert fut.result(timeout=TIMEOUT)["tokens"] == want_old
        assert 1 not in eng.prefix_cache_stats()["adapters"]
        again = eng.submit(prompt, adapter="a1", max_new_tokens=1) \
            .result(timeout=TIMEOUT)["tokens"]
        _drain(eng)
        assert _leak_free(eng)
    finally:
        go.set()
        for e in (eng, old_ref, new_ref):
            e.stop()
    assert again == want_new
