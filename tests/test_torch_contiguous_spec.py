"""Speculative decoding on the port's contiguous loop against the JAX
package's engine (its jitted contiguous ``verify`` and
``_decode_once_speculative``), on the same f32 weights on the CPU:

- tiny Gemma 2 (the mixed cache: rings for the local layers, full length
  for the global ones) and a tiny Llama with the prefix cache off (a
  linear cache), ``speculate_k`` 2 and 3: greedy tokens identical to the
  JAX engine with the same ``speculate_k`` and to the port's own
  ``speculate_k`` 0 run, ``tpu_serving_spec_proposed``/``_accepted``
  equal to the JAX engine's, drafts both accepted and rejected, a sampled
  request riding along; the engine holds a ``decode`` and a ``verify``
  graph;
- the cases where the verify step can break, as cases of one test: a
  prompt past the ring's wraparound with accepted and rejected drafts, the
  mixed cache, rows whose index + K + 1 passes a linear section's end (the
  write dropped), an int8 cache, multi-LoRA with per-slot adapter ids, and
  slots that finish mid-run on eos or their budget.
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

TIMEOUT = 300
SMALL = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
             n_kv_heads=2, mlp_dim=128, max_seq_len=256,
             dtype=jnp.float32, param_dtype=jnp.float32)
G2 = jllama.tiny_llama(**dict(SMALL, n_layers=4), name="tiny-g2",
                       head_dim=32, sliding_window=8,
                       sliding_window_pattern=2, attn_logit_softcap=50.0,
                       query_pre_attn_scalar=64.0, post_norms=True,
                       logit_softcap=30.0)
LLAMA = jllama.tiny_llama(**SMALL)
MODELS = {"g2": (G2, {}), "llama": (LLAMA, dict(prefix_cache_enabled=False))}
# cache_len 256 over 16-token chunks: a window of 8 rings at 128 slots
SC = dict(slots=3, max_prefill_len=16, cache_len=256, max_new_tokens=24,
          kv_page_tokens=8)
COUNTERS = ("spec_proposed", "spec_accepted")
TARGETS = ("wq", "wv", "w_up")


def _toks(rng, n):
    return [int(t) for t in rng.integers(1, 128, n)]


def _traffic(seed: int, long: int = 0):
    """(prompt, submit kwargs): token-repeat prompts whose continuations
    the drafts can match, random ones, a sampled request, and with
    ``long`` a repeat prompt of that many tokens."""
    rng = np.random.default_rng(seed)
    cycle = _toks(rng, 5)
    out = [(cycle * 5, {}), (_toks(rng, 11), {}),
           (_toks(rng, 3) * 6 + _toks(rng, 2), {}),
           (_toks(rng, 9), dict(temperature=0.8, seed=5))]
    if long:
        block = _toks(rng, 13)
        out.append(((block * (long // 13 + 1))[:long], {}))
    return out


def _jax_run(jcfg, jparams, sc: dict, traffic, adapters=None):
    eng = JaxServingEngine(jcfg, jparams, JaxServingConfig(**sc)).start()
    try:
        for name, ad in (adapters or {}).items():
            eng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray,
                                                              ad))
        futs = [eng.submit(p, **kw) for p, kw in traffic]
        toks = [f.result(timeout=TIMEOUT)["tokens"] for f in futs]
        counts = {k: eng.metrics.get_counter(f"tpu_serving_{k}")
                  for k in COUNTERS}
    finally:
        eng.stop()
    return toks, counts


def _port_run(jcfg, jparams, sc: dict, traffic, adapters=None):
    cfg = config_from_jax(jcfg, torch.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**sc), device="cpu")
    for name, ad in (adapters or {}).items():
        eng.register_adapter(name, ad)
    eng.start()
    try:
        futs = [eng.submit(p, **kw) for p, kw in traffic]
        toks = [f.result(timeout=TIMEOUT)["tokens"] for f in futs]
        counts = {k: eng.counters[k] for k in COUNTERS} if sc.get(
            "speculate_k") else {}
        snap = eng.debug_snapshot()
        assert not snap["paged_decode"]
        assert set(snap["graphs"]) == ({"decode", "verify"}
                                       if sc.get("speculate_k")
                                       else {"decode"})
        assert eng.active_slots == 0 and eng.counters["engine_errors"] == 0
    finally:
        eng.stop()
    return toks, counts


def _greedy(traffic, toks):
    return [t for (_, kw), t in zip(traffic, toks) if not kw.get(
        "temperature")]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_speculative_tokens_match_the_jax_engine(model, k):
    jcfg, extra = MODELS[model]
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    traffic = _traffic(60 + k)
    sc = dict(SC, **extra, speculate_k=k)
    want, jcounts = _jax_run(jcfg, jparams, sc, traffic)
    got, counts = _port_run(jcfg, jparams, sc, traffic)
    plain, _ = _port_run(jcfg, jparams, dict(SC, **extra), traffic)
    assert _greedy(traffic, got) == _greedy(traffic, want) \
        == _greedy(traffic, plain)
    assert [len(t) for t in got] == [len(t) for t in want]
    assert counts == jcounts
    # both kinds of draft: some accepted, some rejected
    assert 0 < counts["spec_accepted"] < counts["spec_proposed"]


def _adapter(jcfg, seed: int, rank: int = 4) -> dict:
    """{t: {"a", "b", "scale"}} numpy over TARGETS, B non-zero."""
    rng = np.random.default_rng(seed)
    e, hd, m, L = (jcfg.embed_dim, jcfg.head_dim_, jcfg.mlp_dim,
                   jcfg.n_layers)
    dims = {"wq": (e, jcfg.n_heads * hd), "wv": (e, jcfg.n_kv_heads * hd),
            "w_up": (e, m)}
    return {t: {"a": (rng.normal(size=(L, dims[t][0], rank))
                      / np.sqrt(dims[t][0])).astype(np.float32),
                "b": (0.3 * rng.normal(size=(L, rank, dims[t][1])))
                .astype(np.float32),
                "scale": np.full((L,), 2.0, np.float32)}
            for t in TARGETS}


# case -> (model, ServingConfig fields, traffic seed, long prompt length)
CASES = {
    # a prompt past the 128-slot ring: verify writes wrap, rejected
    # drafts leave abs_pos naming positions past the index
    "ring_wrap": ("g2", {}, 70, 150),
    # the mixed cache at prompts past the window and under the ring
    "mixed": ("g2", dict(max_new_tokens=40), 71, 40),
    # index + K + 1 past cache_len 64: the linear writes drop
    "linear_end": ("llama", dict(prefix_cache_enabled=False, cache_len=64,
                                 max_new_tokens=64), 72, 50),
    "kv_int8": ("g2", dict(quantize_kv_int8=True), 73, 0),
    "multi_lora": ("g2", dict(lora_rank=4, lora_targets=TARGETS,
                              max_adapters=2), 74, 0),
    # budgets that end inside a verify run, and an eos token
    "finish_mid_run": ("llama", dict(prefix_cache_enabled=False,
                                     max_new_tokens=7), 75, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculation_holds_where_it_can_break(case):
    model, extra, seed, long = CASES[case]
    jcfg = MODELS[model][0]
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(4))
    traffic = _traffic(seed, long)
    adapters = None
    if case == "multi_lora":
        adapters = {"a1": _adapter(jcfg, 8), "a2": _adapter(jcfg, 9)}
        traffic = [(p, dict(kw, adapter=a)) for (p, kw), a in
                   zip(traffic, ("a1", "", "a2", "a1"))]
    sc = dict(SC, **extra)
    plain, _ = _port_run(jcfg, jparams, sc, traffic, adapters)
    if case == "finish_mid_run":
        # an eos a greedy stream first reaches mid-run
        sc["eos_token"] = next(t[j] for t in _greedy(traffic, plain)
                               for j in range(3, len(t)) if t[j] not in t[:j])
        plain, _ = _port_run(jcfg, jparams, sc, traffic, adapters)
        assert min(len(t) for t in plain) < sc["max_new_tokens"]
    if case == "linear_end":
        assert any(len(p) + len(t) == sc["cache_len"]
                   for (p, _), t in zip(traffic, plain))
    sc["speculate_k"] = 3
    want, jcounts = _jax_run(jcfg, jparams, sc, traffic, adapters)
    got, counts = _port_run(jcfg, jparams, sc, traffic, adapters)
    assert _greedy(traffic, got) == _greedy(traffic, want) \
        == _greedy(traffic, plain)
    assert [len(t) for t in got] == [len(t) for t in want]
    assert counts == jcounts
    if case in ("ring_wrap", "mixed"):
        assert 0 < counts["spec_accepted"] < counts["spec_proposed"]
