"""The port's ServingEngine on a DeepSeek-V2-shaped model against the JAX
package's, on the CPU.

The model is JAX ``tests/test_mla.py``'s dense-prefix engine shape in f32:
MLA (4 heads of 16, latent 32, rope 8) over 4 routed experts top-2
without renormalization and 2 shared experts of width 48, its first layer
dense at 112 (DeepSeek-V2-Lite's layout at a tiny size), its parameters
drawn from a seed with numpy (the router decisive, normal * 1.0: at the
JAX init's 0.02 experts score within f32 rounding of each other and the
two packages may pick differently). Both engines serve the same prompts
one at a time and must give identical greedy tokens:

- on the paged loop over the latent arena, with a prefix hit, zero leaked
  pages after drain, and the prefix's ``c_pre``/``kr_pre`` sections in
  the arena and in ``page_bytes``;
- with ``speculate_k=2``;
- with int8 latents (``quantize_kv_int8``);
- with ``prefix_cache_enabled=False``, on the contiguous loop, the shared
  prefix registered in the dense prefix store (whole single caches, the
  ``c_pre``/``kr_pre`` sections with them) and hit by both engines;
- with int4 weights over int8 latents, the JAX quantizer's tree and the
  port's (``quantize_params``, bit-identical, ``test_torch_deepseek.py``);
- a two-member group through the dense-scratch route, and ``embed``
  against the JAX model's hidden states at the serving capacity (atol
  1e-5).
"""

import dataclasses
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
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
JCFG = jllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=3, n_heads=4,
                       n_kv_heads=4, head_dim=16, mla_latent_dim=32,
                       mla_rope_dim=8, mlp_dim=48, max_seq_len=256,
                       n_experts=4, n_experts_per_tok=2, n_shared_experts=2,
                       router_norm_topk=False, n_dense_prefix=1,
                       dense_prefix_mlp_dim=112, dtype=jnp.float32,
                       param_dtype=jnp.float32)
T = 8
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX layout: norms near 1, the
    router at 1.0, every other leaf at 0.08."""
    rng = np.random.default_rng(20261018)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(JCFG, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = 1.0 if name == "router" else 0.08
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=10, kv_page_tokens=T)
    base.update(kw)
    return base


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


def _drain(engine):
    engine.drain()
    deadline = time.monotonic() + TIMEOUT
    while not engine.drained:
        assert time.monotonic() < deadline, "engine did not drain"
        time.sleep(0.02)


def _one_by_one(engine, prompts):
    return [engine.submit(p).result(timeout=TIMEOUT)["tokens"]
            for p in prompts]


MODES = {
    "paged": {},
    "speculate": {"speculate_k": 2},
    "kv_int8": {"quantize_kv_int8": True},
    "prefix_cache_off": {"prefix_cache_enabled": False},
    "int4_kv_int8": {"quantize_int4": True, "quantize_kv_int8": True},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_the_jax_engine(tree, mode):
    flags = MODES[mode]
    prompts = _prompts()
    dense = mode == "prefix_cache_off"
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config(**flags))).start()
    try:
        if dense:
            jeng.register_prefix(SHARED)
        ref = _one_by_one(jeng, prompts)
    finally:
        jeng.stop()
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**_config(**flags)),
                        device="cpu").start()
    try:
        if dense:
            eng.register_prefix(SHARED)
        got = _one_by_one(eng, prompts)
        snap = eng.debug_snapshot()
        assert snap["kv_layout"] == "latent"
        if dense:
            assert eng._kv_store is None
            assert {"c_pre", "kr_pre"} <= set(eng._cache)
            assert eng.prefix_cache_stats()["dense_entries"] == 1
            assert eng.counters["prefix_hits"] >= 2
        else:
            assert eng.counters["prefix_cache_hits"] >= 1
            _drain(eng)
            assert _leak_free(eng)
            arena = eng._kv_store.arena
            assert arena["c_pre"].shape[0] == 1 and arena["c"].shape[0] == 2
            quant = flags.get("quantize_kv_int8", False)
            per_pos = (32 + 8) + 8 if quant else (32 + 8) * 4
            assert snap["prefix_cache"]["page_bytes"] == 3 * T * per_pos
        if mode == "int4_kv_int8":
            assert "q4" in eng.params["layers"]["ws_gate"]
            assert "q4" in eng.params["prefix_layers"]["w_down"]
        if mode == "speculate":
            assert eng.counters["paged_speculative_steps"] > 0
    finally:
        eng.stop()
    assert got == ref
    assert all(len(t) == 10 for t in got)


def test_dense_route_group_and_embed_match_jax(tree):
    prompt = _prompts()[3]
    # 2 slots of 16 pages: the pool's minimum
    sc = _config(slots=2, kv_pool_pages=32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jeng = JaxServingEngine(JCFG, jparams, JaxServingConfig(**sc)).start()
    try:
        ref = [f.result(timeout=TIMEOUT)["tokens"]
               for f in jeng.submit_group(prompt, n=2)]
    finally:
        jeng.stop()
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**sc), device="cpu").start()
    try:
        got = [f.result(timeout=TIMEOUT)["tokens"]
               for f in eng.submit_group(prompt, n=2)]
        assert eng.counters["dense_prefills"] >= 1
        emb = np.array(eng.embed(_prompts()[0]))
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert got == ref and got[0] == got[1]
    # the JAX model's serving routing (capacity factor X/k: no drop)
    no_drop = dataclasses.replace(JCFG, capacity_factor=2.0)
    hidden = jllama.LlamaModel(no_drop).forward(
        jparams, jnp.asarray([_prompts()[0]], jnp.int32),
        return_hidden=True)
    np.testing.assert_allclose(emb, np.asarray(hidden[0]).mean(0), rtol=0,
                               atol=1e-5)
