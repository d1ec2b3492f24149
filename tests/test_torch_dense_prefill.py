"""The dense-scratch prefill route of the port against the JAX package.

- ``prefill``, ``prefill_chunk_step`` and ``verify_step`` over a
  contiguous cache (``init_cache``, f32 and int8) against the
  JAX model's: logits and cache sections within 1e-5 (int8 values within
  one rounding step where the f32 rows sit on a rounding edge);
- pages filled from a dense int8 cache (``fill_pages``) are bit-equal to
  the pages ``paged_prefill_chunk_step`` writes where both quantize the
  same rows (layer 0), and ``gather`` reads back what ``insert`` wrote;
- an engine whose pool is too small for an up-front run: the JAX engine
  takes its fallback (``_prefill_paged_native`` returns None, the dense
  route runs); the port, driven by the same traffic with the same
  ``kv_pool_pages``, gives the same greedy tokens, counts the dense route
  and leaks no page; ``register_prefix`` on that full pool registers the
  prefix, as the reference does, pinning what it can cache;
- MLA (``tiny_mla``, f32 latents): ``init_cache``'s latent sections equal
  the JAX model's in names, shapes and dtypes, and the MLA engine on the
  same full pool gives the JAX MLA engine's greedy tokens for that
  traffic and for an n = 2 group after it (the int8-latent engine and the
  model-level parity are ``tests/test_torch_mla_dense.py``).
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
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import \
    PagedKVStore

TIMEOUT = 120
DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
JCFG = jllama.tiny_llama(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32)
T = 8


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX tree layout (norms near 1)."""
    rng = np.random.default_rng(20261017)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(JCFG, jax.random.PRNGKey(0)))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(scope="module")
def pair(tree):
    jmodel = jllama.LlamaModel(JCFG)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = config_from_jax(JCFG, torch.float32)
    return (jmodel, jparams, LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_sections(cache, jcache, names):
    for name in names:
        a, b = _np(cache[name]), _np(jcache[name])
        assert a.shape == b.shape, name
        if a.dtype == np.int8:
            # a row's f32 values agree to ~1e-7: a value on a rounding
            # edge may round either way, one step
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_prefill_and_chunk_step_match_jax(pair, quantize):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(1, 128, 40)]
    head, rest = prompt[:24], prompt[24:]
    jcache = jmodel.init_cache(1, 64, quantize=quantize)
    cache = model.init_cache(1, 64, quantize=quantize)
    assert set(cache) == set(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype), name
    jl, jcache = jmodel.prefill(jparams, jnp.asarray([head], jnp.int32),
                                jcache)
    tl, cache = model.prefill(params, torch.tensor([head]), cache)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
    names = [n for n in cache if n != "index"]
    _close_sections(cache, jcache, names)
    assert _np(cache["index"]).tolist() == [24]
    jl, jcache = jmodel.prefill_chunk_step(
        jparams, jnp.asarray([rest], jnp.int32), jcache,
        jnp.asarray([len(rest)], jnp.int32))
    tl, cache = model.prefill_chunk_step(params, torch.tensor([rest]), cache,
                                         torch.tensor([len(rest)]))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
    _close_sections(cache, jcache, names)
    assert _np(cache["index"]).tolist() == _np(jcache["index"]).tolist() \
        == [40]


def test_verify_step_writes_active_rows_only(pair):
    """Two rows prefilled to different lengths (the second padded past its
    true length), then a K = 3 verify with the second row inactive."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 128, (2, 20)).astype(np.int32)
    true_len = np.array([20, 13], np.int32)
    jcache = jmodel.init_cache(2, 48)
    cache = model.init_cache(2, 48)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jcache,
                                jnp.asarray(true_len))
    tl, cache = model.prefill(params, torch.from_numpy(toks), cache,
                              torch.from_numpy(true_len))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
    draft = rng.integers(1, 128, (2, 3)).astype(np.int32)
    active = np.array([True, False])
    jl, jcache = jmodel.verify_step(jparams, jnp.asarray(draft), jcache,
                                    jnp.asarray(active))
    before = cache["k"].clone()
    tl, cache = model.verify_step(params, torch.from_numpy(draft), cache,
                                  torch.from_numpy(active))
    np.testing.assert_allclose(_np(tl)[0], _np(jl)[0], atol=1e-5, rtol=1e-5)
    _close_sections(cache, jcache, ["k", "v"])
    assert torch.equal(cache["k"][:, 1], before[:, 1])   # inactive row
    assert not torch.equal(cache["k"][:, 0], before[:, 0])


MLA_DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
                max_seq_len=256)
MLA_JCFG = jllama.tiny_mla(**MLA_DIMS, dtype=jnp.float32,
                           param_dtype=jnp.float32)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_mla_contiguous_cache_matches_jax(quantize):
    """The contiguous cache of an MLA model (refused before its direct
    form was ported) is the JAX model's latent layout."""
    model = LlamaModel(config_from_jax(MLA_JCFG, torch.float32),
                       device="cpu")
    cache = model.init_cache(2, 32, quantize=quantize)
    jcache = jllama.LlamaModel(MLA_JCFG).init_cache(2, 32,
                                                    quantize=quantize)
    assert set(cache) == set(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype), name
        assert not cache[name].any(), name


def test_filled_int8_pages_equal_the_paged_chunk_steps(pair):
    _, _, model, params = pair
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(1, 128, 37)]   # 4 pages + 5
    n_pages = -(-len(prompt) // T)
    cache = model.init_cache(1, 64, quantize=True)
    model.prefill(params, torch.tensor([prompt]), cache)
    dense = PagedKVStore(2 * n_pages, T, model.init_paged_arena(
        2 * n_pages, T, quantize=True))
    dense.fill_pages(cache, list(range(n_pages)), 0)
    paged = model.init_paged_arena(2 * n_pages, T, quantize=True)
    table = torch.zeros((1, 8), dtype=torch.int32)
    table[0, :n_pages] = torch.arange(n_pages)
    model.paged_prefill_chunk_step(
        params, torch.tensor([prompt]), paged, table,
        torch.zeros(1, dtype=torch.int32),
        torch.tensor([len(prompt)], dtype=torch.int32))
    for name, a in dense.arena.items():
        got, want = a[0, :n_pages], paged[name][0, :n_pages]
        # the last page past the prompt: zeros from the padded fill, and
        # nothing from the chunk step (never attended either way)
        last = len(prompt) - (n_pages - 1) * T
        assert torch.equal(got[:-1], want[:-1]), name
        assert torch.equal(got[-1, :last], want[-1, :last]), name
        assert not got[-1, last:].any(), name
    # layer 1 rows come from the flash and the paged attention, whose f32
    # sums differ in order: within one int8 step
    diff = (dense.arena["k"][1, :n_pages].int()
            - paged["k"][1, :n_pages].int()).abs()
    assert diff.max() <= 1
    # gather reads back the rows the trie's insert copied in
    store = PagedKVStore(2 * n_pages, T, model.init_paged_arena(
        2 * n_pages, T, quantize=True))
    added, evicted = store.insert(0, prompt, cache)
    assert (added, evicted) == (len(prompt) // T, 0)
    m = store.match_full(0, prompt)
    back = store.gather(m.pages, model.init_cache(1, 64, quantize=True))
    full = len(m.pages) * T
    assert back["index"].tolist() == [full]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(back[name][:, :, :full], cache[name][:, :, :full])
    store.release(m.pages)


# -- the engine on a pool too small for an up-front run ---------------------------

PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(1, 128, n)]
           for s, n in ((11, 58), (12, 58), (13, 40))]
PREFIX = [int(t) for t in np.random.default_rng(14).integers(1, 128, 20)]


def _sc(cls):
    # 2 slots of 8 pages; the pool's minimum, 16 pages
    return cls(slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=6,
               kv_page_tokens=T, kv_pool_pages=16)


def _wait(cond, what: str):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _full_pool_traffic(engine) -> dict:
    """Two 58-token prompts whose runs take the whole pool; the engine
    thread held at the first request's first token (its on_token blocks),
    so the second stays prefilled and unbound; then a 40-token prompt,
    which no up-front run can hold, and a prefix registration on the full
    pool; then the engine runs on."""
    entered, gate = threading.Event(), threading.Event()

    def hold(_tok):
        if not entered.is_set():
            entered.set()
            gate.wait(TIMEOUT)

    f1 = engine.submit(PROMPTS[0], on_token=hold)
    _wait(entered.is_set, "the first request was never admitted")
    f2 = engine.submit(PROMPTS[1])
    _wait(lambda: engine._ready.qsize() == 1, "the second never prefilled")
    f3 = engine.submit(PROMPTS[2])
    _wait(lambda: engine._ready.qsize() == 2, "the third never prefilled")
    try:
        engine.register_prefix(PREFIX)
        registered = engine.prefix_cache_stats()
    finally:
        gate.set()
    toks = [f.result(timeout=TIMEOUT)["tokens"] for f in (f1, f2, f3)]
    return {"tokens": toks, "registered": registered["registered"],
            "pinned": registered["pinned"]}


@pytest.fixture(scope="module")
def jax_outcome(tree):
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jeng = JaxServingEngine(JCFG, jparams, _sc(JaxServingConfig))
    native = jeng._prefill_paged_native
    raw = jeng._prefill_raw
    seen = {"native_none": 0, "raw": 0}

    def spy_native(*a, **k):
        out = native(*a, **k)
        seen["native_none"] += out is None
        return out

    def spy_raw(*a, **k):
        seen["raw"] += 1
        return raw(*a, **k)

    jeng._prefill_paged_native = spy_native
    jeng._prefill_raw = spy_raw
    jeng.start()
    try:
        out = _full_pool_traffic(jeng)
    finally:
        jeng.stop()
    return out, seen


def test_jax_engine_takes_its_fallback(jax_outcome):
    """The reference's own route on this traffic: the native prefill of
    the third prompt and of the prefix finds no up-front run and the
    dense route prefills both (``_prefill_paged`` past its native
    return)."""
    _, seen = jax_outcome
    assert seen == {"native_none": 2, "raw": 2}


def test_port_serves_the_full_pool_as_the_reference(pair, jax_outcome):
    _, _, model, params = pair
    want, _ = jax_outcome
    eng = ServingEngine(model.cfg, params, _sc(ServingConfig),
                        device="cpu").start()
    try:
        got = _full_pool_traffic(eng)
        assert eng.counters["dense_prefills"] == 2
        assert eng.counters["dense_prefill_heads"] == 2
        assert eng.counters["admission_rejected"] == 0
        eng.drain()
        _wait(lambda: eng.drained, "the engine did not drain")
        store = eng._kv_store
        nodes = list(store.trie._nodes.values())
        assert store.pool.free_count + len(nodes) == store.pool.n_pages
        assert all(store.pool.refcount(n.page) == 1 for n in nodes)
    finally:
        eng.stop()
    assert got == want
    assert got["registered"] == 1


def test_pool_below_the_slots_residency_is_refused(pair):
    _, _, model, params = pair
    sc = ServingConfig(slots=2, cache_len=64, kv_page_tokens=T,
                       kv_pool_pages=15, max_prefill_len=32)
    with pytest.raises(ValueError, match="kv_pool_pages"):
        ServingEngine(model.cfg, params, sc, device="cpu")


def _mla_traffic(engine) -> dict:
    """The traffic an MLA engine refused before its dense route: the
    full-pool traffic above, then an n = 2 greedy group."""
    out = _full_pool_traffic(engine)
    out["group"] = [f.result(timeout=TIMEOUT)["tokens"]
                    for f in engine.submit_group(PROMPTS[2][:30], 2)]
    return out


@pytest.fixture(scope="module")
def mla_tree():
    rng = np.random.default_rng(20261019)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(MLA_JCFG, jax.random.PRNGKey(0)))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def test_mla_engine_takes_the_dense_route(mla_tree):
    """An MLA engine on a pool too small for an up-front run (which
    answered EngineOverloaded, and ValueError for an n > 1 group, before
    the route existed) serves the prompt, the prefix and the group through
    the dense-scratch route with the JAX MLA engine's greedy tokens, and
    leaks no page."""
    jeng = JaxServingEngine(
        MLA_JCFG, jax.tree_util.tree_map(jnp.asarray, mla_tree),
        _sc(JaxServingConfig)).start()
    try:
        want = _mla_traffic(jeng)
    finally:
        jeng.stop()
    cfg = config_from_jax(MLA_JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(mla_tree, cfg, device="cpu"),
                        _sc(ServingConfig), device="cpu").start()
    try:
        got = _mla_traffic(eng)
        assert eng.counters["dense_prefills"] == 3
        assert eng.counters["dense_prefill_heads"] >= 2
        assert eng.counters["admission_rejected"] == 0
        eng.drain()
        _wait(lambda: eng.drained, "the engine did not drain")
        store = eng._kv_store
        assert sorted(store.arena) == ["c", "kr"]
        nodes = list(store.trie._nodes.values())
        assert store.pool.free_count + len(nodes) == store.pool.n_pages
        assert all(store.pool.refcount(n.page) == 1 for n in nodes)
    finally:
        eng.stop()
    assert got == want
    assert got["registered"] == 1
    assert got["group"][0] == got["group"][1]
