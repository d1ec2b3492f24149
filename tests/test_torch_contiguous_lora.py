"""Multi-LoRA on the port's contiguous decode loop (the Gemma 2 and 3
interleave, a linear cache with the prefix cache off) against the JAX
package's engine, on the CPU in f32:

- tiny Gemma 2 and Gemma 3 (the JAX tests' ``GEMMA2_CFG``/``GEMMA3_CFG``:
  vocab 128, E 64, window 8 over prompts of 20-60 tokens, so the window
  bites) served with ``lora_rank`` 4 over all seven targets: a batch that
  mixes the base (slot 0) and two adapters, prompts over a registered
  prefix and not, greedy tokens identical to the JAX ``ServingEngine``'s
  on the same weights and adapters; an adapter's tokens differ from the
  base's on the same prompt; the dense store's variant fills and hits
  equal the JAX engine's;
- the registered prefix's adapter variants: filled once on an adapter's
  first prompt over it, copied after, LRU-bounded by ``max_prefixes``,
  dropped when that adapter is registered again (the next prompt fills
  a variant under the new weights, whose tokens equal a fresh engine's);
- every decode step one ``DecodeGraph`` run fed each slot's adapter id
  (``adapter_ids`` section of the staged buffer), mixed ids in one step.
"""

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
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
GEMMA = dict(vocab_size=128, embed_dim=64, n_heads=4, n_kv_heads=2,
             head_dim=32, mlp_dim=128, max_seq_len=256,
             tie_embeddings=True, mlp_activation="gelu_tanh",
             embed_scale=True, norm_zero_centered=True, post_norms=True,
             sliding_window=8, dtype=jnp.float32, param_dtype=jnp.float32)
# tests/test_models_train.py's GEMMA2_CFG and GEMMA3_CFG (max_seq_len 256
# here: the engine's cache_len)
JCFGS = {
    "g2": jllama.tiny_llama(**GEMMA, name="tiny-gemma2", n_layers=4,
                            rope_theta=10_000.0, logit_softcap=30.0,
                            attn_logit_softcap=50.0,
                            query_pre_attn_scalar=64.0,
                            sliding_window_pattern=2),
    "g3": jllama.tiny_llama(**GEMMA, name="tiny-gemma3", n_layers=6,
                            rope_theta=100_000.0, rope_local_theta=10_000.0,
                            rope_scaling={"rope_type": "linear",
                                          "factor": 2.0},
                            query_pre_attn_scalar=32.0, qk_norm=True,
                            sliding_window_pattern=6),
}
PREFIX = [int(t) for t in np.random.default_rng(40).integers(1, 128, 20)]
NAMES = ("a1", "a2")


def _tree(jcfg, seed: int):
    """Seeded weights in the JAX layout, norms away from identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _adapter(jcfg, seed: int, rank: int = 4) -> dict:
    """{t: {"a", "b", "scale"}} numpy over all seven targets, B non-zero."""
    rng = np.random.default_rng(seed)
    e, hd, m, L = (jcfg.embed_dim, jcfg.head_dim_, jcfg.mlp_dim,
                   jcfg.n_layers)
    dims = {"wq": (e, jcfg.n_heads * hd), "wk": (e, jcfg.n_kv_heads * hd),
            "wv": (e, jcfg.n_kv_heads * hd), "wo": (jcfg.n_heads * hd, e),
            "w_gate": (e, m), "w_up": (e, m), "w_down": (m, e)}
    return {t: {"a": (rng.normal(size=(L, dims[t][0], rank))
                      / np.sqrt(dims[t][0])).astype(np.float32),
                "b": (0.3 * rng.normal(size=(L, rank, dims[t][1])))
                .astype(np.float32),
                "scale": np.full((L,), 2.0, np.float32)}
            for t in TARGETS}


def _config(**kw):
    # cache_len 256 over 16-token chunks: the window's rings hold 128
    base = dict(slots=3, max_prefill_len=16, cache_len=256,
                max_new_tokens=10, kv_page_tokens=8, lora_rank=4,
                lora_targets=TARGETS, max_adapters=2, max_prefixes=4)
    base.update(kw)
    return base


def _traffic():
    """(prompt, adapter): base and both adapters over the prefix and off
    it, 4 to 60 tokens."""
    rng = np.random.default_rng(41)

    def toks(n):
        return [int(t) for t in rng.integers(1, 128, n)]

    return [(PREFIX + toks(9), "a1"), (toks(33), ""), (PREFIX + toks(40), ""),
            (PREFIX + toks(5), "a2"), (toks(4), "a2"), (PREFIX + toks(12),
                                                        "a1")]


def _serve(engine, traffic):
    futs = [engine.submit(p, adapter=a) for p, a in traffic]
    return [f.result(timeout=TIMEOUT)["tokens"] for f in futs]


@pytest.fixture(scope="module")
def setups():
    return {name: (jcfg, _tree(jcfg, 20261025 + i),
                   {a: _adapter(jcfg, 7 + i + 2 * j)
                    for j, a in enumerate(NAMES)})
            for i, (name, jcfg) in enumerate(sorted(JCFGS.items()))}


def _port_engine(jcfg, tree, adapters, **kw):
    cfg = config_from_jax(jcfg, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**_config(**kw)), device="cpu")
    for name, ad in adapters.items():
        eng.register_adapter(name, ad)
    return eng


def _jax_tokens(jcfg, tree, adapters, traffic):
    jeng = JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config())).start()
    try:
        for name, ad in adapters.items():
            jeng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                               ad))
        jeng.register_prefix(PREFIX)
        want = _serve(jeng, traffic)
        counts = {k: jeng.metrics.get_counter(f"tpu_serving_{k}")
                  for k in ("prefix_hits", "prefix_adapter_fills")}
        variants = jeng._dense_prefixes.snapshot()
    finally:
        jeng.stop()
    return want, counts, variants


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_mixed_adapter_ids_match_the_jax_engine(setups, name):
    jcfg, tree, adapters = setups[name]
    traffic = _traffic()
    want, jcounts, jvariants = _jax_tokens(jcfg, tree, adapters, traffic)
    eng = _port_engine(jcfg, tree, adapters)
    seen_ids = []
    step = eng.model.decode_step

    def spy(params, token, cache, active, adapters=None, adapter_ids=None,
            check=True):
        # the decode graph's step (eager on the CPU): the staged ids
        seen_ids.append({int(i) for i, a in zip(adapter_ids, active) if a})
        return step(params, token, cache, active, adapters, adapter_ids,
                    check)

    eng.model.decode_step = spy
    eng.start()
    try:
        eng.register_prefix(PREFIX)
        got = _serve(eng, traffic)
        snap = eng.debug_snapshot()
        assert (snap["paged_decode"], snap["cache_layout"]) == (False,
                                                                "mixed")
        assert snap["multi_lora"] and snap["adapters"] == list(NAMES)
        for k, v in jcounts.items():
            assert snap["counters"][k] == v, k
        assert eng._dense_prefixes.snapshot() == jvariants
        base = eng.submit(traffic[0][0]).result(timeout=TIMEOUT)["tokens"]
    finally:
        eng.stop()
    assert got == want
    # non-vacuous: a1 changes the tokens of its prompt; the base (0) and
    # both adapters shared decode steps
    assert got[0] != base
    assert any(len(ids) >= 2 and 0 in ids for ids in seen_ids), seen_ids
    assert jcounts["prefix_adapter_fills"] == 2 and jcounts["prefix_hits"] > 0


def test_prefix_variants_fill_once_evict_and_drop_on_reregistration(setups):
    jcfg, tree, adapters = setups["g2"]
    tail = [3, 1, 4, 1, 5, 9, 2, 6]
    prompt = PREFIX + tail
    eng = _port_engine(jcfg, tree, adapters, max_prefixes=1).start()
    try:
        eng.register_prefix(PREFIX)
        dense = eng._dense_prefixes

        def fills():
            return eng.counters["prefix_adapter_fills"]

        first = eng.submit(prompt, adapter="a1").result(timeout=TIMEOUT)
        assert fills() == 1 and sorted(dense._entries[0].variants) == [0, 1]
        again = eng.submit(prompt, adapter="a1").result(timeout=TIMEOUT)
        assert fills() == 1 and again["tokens"] == first["tokens"]
        # a2's variant evicts a1's: one adapter variant at max_prefixes 1
        eng.submit(prompt, adapter="a2").result(timeout=TIMEOUT)
        assert fills() == 2 and sorted(dense._entries[0].variants) == [0, 2]
        # the base variant stays pinned; a new a2 drops a2's variant
        new_a2 = _adapter(jcfg, 99)
        eng.register_adapter("a2", new_a2)
        assert sorted(dense._entries[0].variants) == [0]
        renewed = eng.submit(prompt, adapter="a2").result(timeout=TIMEOUT)
        assert fills() == 3 and sorted(dense._entries[0].variants) == [0, 2]
    finally:
        eng.stop()
    fresh = _port_engine(jcfg, tree, {"a1": adapters["a1"], "a2": new_a2})
    fresh.start()
    try:
        want = fresh.submit(prompt, adapter="a2").result(timeout=TIMEOUT)
    finally:
        fresh.stop()
    assert renewed["tokens"] == want["tokens"]


def test_linear_cache_with_the_prefix_cache_off_serves_adapters(setups):
    """A Llama-shaped model with the prefix cache off runs the contiguous
    loop over a linear cache; its adapters match the JAX engine's too."""
    jcfg = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, mlp_dim=128,
                             max_seq_len=256, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tree = _tree(jcfg, 5)
    adapters = {a: _adapter(jcfg, 11 + j) for j, a in enumerate(NAMES)}
    traffic = _traffic()[:4]
    jeng = JaxServingEngine(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
        JaxServingConfig(**_config(prefix_cache_enabled=False))).start()
    try:
        for name, ad in adapters.items():
            jeng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                               ad))
        want = _serve(jeng, traffic)
    finally:
        jeng.stop()
    eng = _port_engine(jcfg, tree, adapters,
                       prefix_cache_enabled=False).start()
    try:
        assert eng.debug_snapshot()["cache_layout"] == "linear"
        got = _serve(eng, traffic)
    finally:
        eng.stop()
    assert got == want
