"""The port's contiguous decode loop against the JAX package's engine, on
the same f32 weights:

- greedy tokens identical, prompt by prompt, in every layout the loop
  serves: Gemma 2's mixed cache (rings past their wraparound), a tiny
  Llama with the prefix cache off (linear), a uniform window with
  ``paged_decode`` off (a ring), tiny-mla and tiny-moe with the prefix
  cache off, a linear cache over the paged prefix pool (``paged_decode``
  off), and the paged loop with ``paged_prefill`` off (the dense-scratch
  route);
- a registered prefix hits (``prefix_hits``) in both engines, and its
  stored cache is never written by the requests that copy it; every slot
  ends free;
- ``_pick_ring_len`` equals the JAX engine's over a grid of
  ``ServingConfig``s, ``ServingEngine.contiguous_cache`` builds the
  engine's batch cache, and ``DensePrefixStore`` behaves as the JAX one;
- the loop selection and the refusals (``paged_decode=True`` on an
  interleave, ``paged_prefill=True`` without the paged loop,
  ``ring_cache=True`` without a window), and speculative decoding,
  multi-LoRA and a tensor mesh, which the loop serves: the engine builds
  there, the flags parse and serve;
- ``serve_main``'s ``--prefix-cache``, ``--paged-decode``,
  ``--paged-prefill``, ``--kv-page-tokens`` and ``--ring-cache`` (None
  unless given, as the JAX flags, then resolved), checked before any
  weight.
"""

import itertools

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
from k8s_runpod_kubelet_tpu.workloads.serving.kv_manager import \
    DensePrefixStore as JaxDensePrefixStore
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import \
    DensePrefixStore

TIMEOUT = 300
SMALL = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
             n_kv_heads=2, mlp_dim=128, max_seq_len=256,
             dtype=jnp.float32, param_dtype=jnp.float32)
G2 = jllama.tiny_llama(**dict(SMALL, n_layers=4), name="tiny-g2",
                       head_dim=32, sliding_window=8,
                       sliding_window_pattern=2, attn_logit_softcap=50.0,
                       query_pre_attn_scalar=64.0, post_norms=True,
                       logit_softcap=30.0)
# cache_len 256 over 16-token chunks: a window of 8 rings at 128 slots
SC = dict(slots=3, max_prefill_len=16, cache_len=256, max_new_tokens=24,
          kv_page_tokens=8)
# name -> (JAX config, ServingConfig fields, layout, prefix store)
CASES = {
    "gemma2_mixed": (G2, {}, "mixed", "dense"),
    "llama_prefix_off": (jllama.tiny_llama(**SMALL),
                         dict(prefix_cache_enabled=False), "linear", "dense"),
    "window_ring": (jllama.tiny_llama(**SMALL, sliding_window=8),
                    dict(paged_decode=False), "ring", "dense"),
    "mla_prefix_off": (jllama.tiny_mla(**SMALL),
                       dict(prefix_cache_enabled=False), "linear", "dense"),
    "moe_prefix_off": (jllama.tiny_moe(**SMALL),
                       dict(prefix_cache_enabled=False), "linear", "dense"),
    "linear_paged_pool": (jllama.tiny_llama(**SMALL),
                          dict(paged_decode=False), "linear", "paged"),
    "paged_prefill_off": (jllama.tiny_llama(**SMALL),
                          dict(paged_prefill=False), "paged", "paged"),
}
PREFIX = [int(t) for t in np.random.default_rng(30).integers(1, 128, 20)]


def _prompts():
    rng = np.random.default_rng(31)
    tails = [[int(t) for t in rng.integers(1, 128, n)] for n in (9, 110, 4)]
    return ([PREFIX + tails[0], [int(t) for t in rng.integers(1, 128, 7)],
             PREFIX + tails[1], PREFIX[:12], tails[2]])


def _port(jcfg, jparams):
    cfg = config_from_jax(jcfg, torch.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, params_from_jax(tree, cfg, device="cpu")


def _serve(engine, prompts):
    engine.register_prefix(PREFIX)
    return [engine.submit(p).result(timeout=TIMEOUT)["tokens"]
            for p in prompts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_match_the_jax_engine(case):
    jcfg, extra, layout, store = CASES[case]
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    prompts = _prompts()
    jeng = JaxServingEngine(jcfg, jparams,
                            JaxServingConfig(**SC, **extra)).start()
    try:
        want = _serve(jeng, prompts)
        jax_hits = jeng.metrics.get_counter("tpu_serving_prefix_hits")
    finally:
        jeng.stop()
    cfg, params = _port(jcfg, jparams)
    eng = ServingEngine(cfg, params, ServingConfig(**SC, **extra),
                        device="cpu").start()
    try:
        snap = eng.debug_snapshot()
        assert snap["cache_layout"] == layout
        assert snap["paged_decode"] == (layout == "paged")
        assert snap["paged_prefill"] is False
        eng.register_prefix(PREFIX)
        stored = None
        if store == "dense":
            assert eng.prefix_cache_stats()["dense_entries"] == 1
            (_, cache), = (e.variants[0] for e in eng._dense_prefixes._entries)
            stored = {k: v.clone() for k, v in cache.items()}
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
        assert eng.counters["prefix_hits"] == jax_hits == 2
        if stored is not None:
            for k, v in stored.items():
                torch.testing.assert_close(cache[k], v, rtol=0, atol=0)
        else:
            assert eng.counters["dense_prefills"] == len(prompts) + 1
        assert eng.active_slots == 0 and eng.counters["engine_errors"] == 0
        graphs = eng.graphs_snapshot()
        assert set(graphs) == ({"paged_step"} if layout == "paged"
                               else {"decode"})
    finally:
        eng.stop()
    assert got == want


def test_mixed_engine_caches_equal_the_jax_engines():
    """The batch cache of the port's Gemma 2 engine has the JAX engine's
    sections and shapes, ring included, for the same ServingConfig."""
    jparams = jax_init_params(G2, jax.random.PRNGKey(3))
    jeng = JaxServingEngine(G2, jparams, JaxServingConfig(**SC))
    cfg, params = _port(G2, jparams)
    eng = ServingEngine(cfg, params, ServingConfig(**SC), device="cpu")
    assert {k: tuple(v.shape) for k, v in eng._cache.items()} == {
        k: tuple(v.shape) for k, v in jeng._cache.items()}
    assert eng._ring_len == jeng._ring_len == 128


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", ["gemma2_mixed", "llama_prefix_off",
                                  "window_ring"])
def test_contiguous_cache_is_the_engines(case, quant):
    """``ServingEngine.contiguous_cache`` (what ``step_profile`` profiles)
    builds the engine's batch cache, section for section, and
    ``contiguous_layout`` names it as ``debug_snapshot`` does."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel

    jcfg, extra, layout, _ = CASES[case]
    cfg, params = _port(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    sc = ServingConfig(**SC, **extra, quantize_kv_int8=quant)
    eng = ServingEngine(cfg, params, sc, device="cpu")
    ring = ServingEngine._pick_ring_len(cfg, sc)
    cache = ServingEngine.contiguous_cache(LlamaModel(cfg, device="cpu"), sc,
                                           ring, sc.slots)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in eng._cache.items()}
    assert ServingEngine.contiguous_layout(cfg, ring) == layout == \
        eng.debug_snapshot()["cache_layout"]


# -- ring length and the dense store ------------------------------------------------

_GRID = dict(window=(None, 8, 1024, 4096), pattern=(1, 2),
             ring_cache=(None, True, False),
             serving_chunk_tokens=(0, 100, 1024, 5000),
             max_prefill_len=(16, 512, 4096), speculate_k=(0, 4),
             cache_len=(64, 2048, 8192))


def test_pick_ring_len_equals_the_jax_engines():
    n = 0
    for vals in itertools.product(*_GRID.values()):
        kw = dict(zip(_GRID, vals))
        if kw["pattern"] > 1 and kw["window"] is None:
            continue
        jcfg = jllama.tiny_llama(**SMALL, sliding_window=kw["window"],
                                 sliding_window_pattern=kw["pattern"])
        fields = {k: kw[k] for k in ("ring_cache", "serving_chunk_tokens",
                                     "max_prefill_len", "speculate_k",
                                     "cache_len")}
        try:
            want = JaxServingEngine._pick_ring_len(
                jcfg, JaxServingConfig(**fields))
        except ValueError as e:
            want = type(e)
        cfg = config_from_jax(jcfg, torch.float32)
        try:
            got = ServingEngine._pick_ring_len(cfg, ServingConfig(**fields))
        except ValueError as e:
            got = type(e)
        assert got == want, kw
        n += 1
    assert n > 1000


def test_dense_prefix_store_behaves_as_the_jax_one():
    ours, theirs = DensePrefixStore(2), JaxDensePrefixStore(2)
    ops = [("add", [1, 2, 3], "a"), ("add", [1, 2], "b"),
           ("add", [7, 8, 9, 10], "c")]
    for store in (ours, theirs):
        for _, toks, var in ops:
            store.add(toks, var)
    for toks in ([1, 2, 3, 4], [1, 2, 5], [7, 8], [7, 8, 9, 10, 11], [9]):
        a, b = ours.lookup(toks), theirs.lookup(toks)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tokens == b.tokens and a.variants == b.variants
    assert ours.has([1, 2]) and not ours.has([1])
    for store in (ours, theirs):
        for i, toks in enumerate(([1, 2, 3], [1, 2], [7, 8, 9, 10],
                                  [1, 2, 3])):
            entry = store.lookup(toks)
            store.put_variant(entry, i % 3 + 1, f"v{i}")
        assert not store.put_variant(store.lookup([1, 2, 3]), 1, "again")
        store.drop_adapter(2)
    assert ours.snapshot() == theirs.snapshot()
    assert len(ours) == len(theirs) == 3
    assert [e.variants for e in ours._entries] == [
        e.variants for e in theirs._entries]


# -- loop selection and refusals -------------------------------------------------

@pytest.fixture(scope="module")
def g2_port():
    return _port(G2, jax_init_params(G2, jax.random.PRNGKey(3)))


@pytest.mark.parametrize("extra,match", [
    (dict(speculate_k=2), None),
    (dict(lora_rank=4), None),
    (dict(paged_decode=True), "paged_decode=True needs"),
    (dict(paged_prefill=True), "paged_prefill=True needs")],
    ids=["speculate", "lora", "paged_decode", "paged_prefill"])
def test_the_contiguous_loop_refuses_by_name(g2_port, extra, match):
    """What the contiguous loop refuses, by name; ``match`` None is a
    setting it serves (speculative decoding, multi-LoRA): the engine builds
    on that loop with its verify graph or its adapter stacks and answers a
    request."""
    cfg, params = g2_port
    if match is None:
        engine = ServingEngine(cfg, params, ServingConfig(**SC, **extra),
                               device="cpu").start()
        try:
            snap = engine.debug_snapshot()
            assert (snap["paged_decode"], snap["cache_layout"]) == (
                False, "mixed")
            if "lora_rank" in extra:
                assert snap["multi_lora"] and snap["lora_rank"] == 4
            else:
                assert snap["speculate_k"] == 2
                assert set(engine.graphs_snapshot()) == {"decode", "verify"}
            out = engine.submit([5, 6, 7, 5, 6], max_new_tokens=6).result(
                timeout=TIMEOUT)
            assert len(out["tokens"]) == 6
        finally:
            engine.stop()
        return
    with pytest.raises(ValueError, match=match):
        ServingEngine(cfg, params, ServingConfig(**SC, **extra),
                      device="cpu")


def test_a_tensor_mesh_and_a_ring_without_window_are_refused():
    """A tensor mesh on the contiguous loop builds and serves, its batch
    cache head-sharded; a ring without a window is refused."""
    jcfg = jllama.tiny_llama(**SMALL)
    cfg, params = _port(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    engine = ServingEngine(cfg, params,
                           ServingConfig(**SC, prefix_cache_enabled=False),
                           device="cpu",
                           mesh=make_mesh(MeshConfig(tensor=2))).start()
    try:
        snap = engine.debug_snapshot()
        assert (snap["paged_decode"], snap["tensor_parallel"],
                snap["cache_head_shards"], snap["paged_tp_shards"]) == (
                    False, 2, 2, 0)
        out = engine.submit([5, 6, 7], max_new_tokens=4).result(
            timeout=TIMEOUT)
        assert len(out["tokens"]) == 4
    finally:
        engine.stop()
    with pytest.raises(ValueError, match="needs a model with a sliding"):
        ServingEngine(cfg, params, ServingConfig(**SC, ring_cache=True),
                      device="cpu")


def test_loop_selection_follows_the_jax_rule():
    g2 = config_from_jax(G2, torch.float32)
    llama = config_from_jax(jllama.tiny_llama(**SMALL), torch.float32)
    window = config_from_jax(jllama.tiny_llama(**SMALL, sliding_window=8),
                             torch.float32)
    for cfg, extra, want in (
            (llama, {}, (True, True, None)),
            (llama, dict(paged_prefill=False), (True, False, None)),
            (llama, dict(prefix_cache_enabled=False), (False, False, None)),
            (window, {}, (True, True, None)),
            (window, dict(ring_cache=True), (False, False, 128)),
            (window, dict(paged_decode=False), (False, False, 128)),
            (g2, {}, (False, False, 128)),
            (g2, dict(cache_len=128), (False, False, None)),
            (llama, dict(kv_page_tokens=256), (False, False, None))):
        assert ServingEngine.check_loop(
            cfg, ServingConfig(**{**SC, **extra})) == want, extra


# -- serve_main ---------------------------------------------------------------------

def test_serve_flags_parse_with_the_jax_meanings():
    """The knob flags default to None, as the JAX CLI's, so that the
    environment and --config can win; with nothing set they resolve to the
    JAX config's defaults, and a flag to its own value."""
    args = serve_main.parse_args([])
    assert (args.prefix_cache_enabled, args.kv_paged_decode,
            args.kv_paged_prefill, args.kv_page_tokens, args.kv_pool_pages,
            args.config, args.ring_cache) == (None, None, None, None, None,
                                              "", "auto")
    got = serve_main.resolve_settings(args, env={})
    assert (got["prefix_cache_enabled"], got["kv_paged_decode"],
            got["kv_paged_prefill"], got["kv_page_tokens"],
            got["kv_pool_pages"]) == (True, True, True, 16, 0)
    args = serve_main.parse_args(["--model", "gemma3-12b", "--prefix-cache",
                                  "off", "--paged-decode", "off",
                                  "--paged-prefill", "off", "--ring-cache",
                                  "on", "--kv-page-tokens", "32"])
    assert args.model == "gemma3-12b" and args.ring_cache == "on"
    got = serve_main.resolve_settings(args, env={})
    assert (got["prefix_cache_enabled"], got["kv_paged_decode"],
            got["kv_paged_prefill"], got["kv_page_tokens"]) == (
                False, False, False, 32)
    assert "gemma2-9b" in serve_main.parse_args(
        ["--model", "gemma2-9b"]).model


@pytest.mark.parametrize("argv,match", [
    (["--prefix-cache", "off", "--speculate", "2"], None),
    (["--paged-decode", "off", "--lora-rank", "4"], None),
    (["--prefix-cache", "off", "--tensor-parallel", "2"], None),
    (["--ring-cache", "on"], "sliding window")],
    ids=["speculate", "lora", "tensor", "ring"])
def test_serve_flags_are_checked_before_any_weight(monkeypatch, argv, match):
    """Flags the contiguous loop refuses fail before any weight is drawn;
    ``match`` None is a setting it serves (speculative decoding,
    multi-LoRA, a tensor mesh): the flags parse, the engine builds on the
    contiguous loop and answers a request."""
    from k8s_runpod_kubelet_tpu_torch import models

    args = serve_main.parse_args(["--device", "cpu", "--model", "tiny"]
                                 + argv)
    if match is None:
        engine, _ = serve_main.build_engine(args)   # started
        try:
            assert not engine._paged_loop
            snap = engine.debug_snapshot()
            if "--lora-rank" in argv:
                assert engine.multi_lora_enabled
            elif "--speculate" in argv:
                assert snap["speculate_k"] == 2 and "verify" in snap["graphs"]
            else:
                assert snap["tensor_parallel"] == 2
            out = engine.submit([5, 6, 7], max_new_tokens=3).result(
                timeout=TIMEOUT)
            assert len(out["tokens"]) == 3
        finally:
            engine.stop()
        return

    def no_weights(*a, **k):
        raise AssertionError("weights drawn before the flags were checked")

    monkeypatch.setattr(models, "init_params", no_weights)
    with pytest.raises(ValueError, match=match):
        serve_main.build_engine(args)


def test_serve_cli_builds_the_contiguous_loop_on_the_cpu():
    args = serve_main.parse_args(["--device", "cpu", "--model", "tiny",
                                  "--slots", "2", "--cache-len", "64",
                                  "--max-new-tokens", "4", "--prefix-cache",
                                  "off"])
    engine, _ = serve_main.build_engine(args)
    try:
        snap = engine.debug_snapshot()
        assert (snap["paged_decode"], snap["cache_layout"]) == (False,
                                                                "linear")
        assert snap["prefix_cache"]["dense_entries"] == 0
        out = engine.submit([5, 6, 7]).result(timeout=TIMEOUT)
        assert len(out["tokens"]) == 4
        assert engine.graphs_snapshot()["decode"]["replays"] == 0   # CPU
        assert engine.counters["decode_steps"] == 3
    finally:
        engine.stop()
