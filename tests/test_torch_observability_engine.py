"""The port engine's metrics and spans against the JAX engine's, on the
same f32 tiny weights and the same prompts, submitted one at a time
(greedy, so every count the requests fix is fixed): the paged loop, the
paged loop with ``speculate_k`` 3, and the contiguous loop with the prefix
cache off, each of the two loops also with chunked prefill
(``serving_chunk_tokens`` 8). Both engines meter costs (the default).
Held:

- the HELP and TYPE lines of every series both engines render are
  identical;
- the counters the requests fix are equal: admitted, prefix-cache hits
  and misses, paged prefill tokens, prefill chunks (0 unless chunked
  prefill is on), drafts proposed and accepted;
- every histogram both render counts the same observations (TTFT,
  latency, queue wait, inter-token gaps, batch utilization, the step
  phases and tokens);
- each request's span tree has the same names, parenting and attribute
  keys, under the caller's trace and parent span;
- ``debug_snapshot()["counters"]`` agrees with ``render()``, and the
  fleet reporter's stats carry the JAX reporter's keys.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.fleet.registry import \
    ReplicaReporter as JaxReplicaReporter
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.fleet.registry import ReplicaReporter
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 300
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
SC = dict(slots=3, max_prefill_len=16, cache_len=128, max_new_tokens=10,
          kv_page_tokens=8)
CASES = {"paged": {}, "speculate": {"speculate_k": 3},
         "contiguous": {"prefix_cache_enabled": False},
         "paged_chunked": {"serving_chunk_tokens": 8},
         "contiguous_chunked": {"prefix_cache_enabled": False,
                                "serving_chunk_tokens": 8}}
COUNTERS = ("tpu_serving_admitted", "tpu_serving_prefix_cache_hits",
            "tpu_serving_prefix_cache_misses",
            "tpu_serving_paged_prefill_tokens", "tpu_serving_spec_proposed",
            "tpu_serving_spec_accepted", "tpu_serving_decode_steps",
            "tpu_serving_prefill_chunks")


def _prompts() -> list:
    rng = np.random.default_rng(41)
    prefix = [int(t) for t in rng.integers(1, 128, 20)]
    # a repeating tail gives the prompt-lookup drafter matches to accept
    return [prefix + [int(t) for t in rng.integers(1, 128, 9)],
            [int(t) for t in rng.integers(1, 128, 7)],
            prefix + [5, 6, 7] * 8,
            [9, 8, 7, 9, 8, 7, 9, 8, 7, 9, 8]]


def _trace(i: int) -> dict:
    return {"trace_id": f"{i + 1:032x}", "parent_span": f"{i + 7:016x}",
            "span_id": f"{i + 100:016x}"}


def _families(text: str) -> dict:
    return {" ".join(line.split(" ", 3)[:3]): line
            for line in text.splitlines() if line.startswith("# ")}


def _hist_counts(snap: dict) -> dict:
    return {(name, tuple(map(tuple, labels))): state["count"]
            for name, labels, state in snap["hists"]}


def _tree(tracer, i: int) -> list:
    spans = tracer.get_trace(_trace(i)["trace_id"])
    root = _trace(i)["span_id"]
    return sorted((s["name"], s["span_id"] == root,
                   s["parent_id"] == (_trace(i)["parent_span"]
                                      if s["span_id"] == root else root),
                   tuple(sorted(s["attrs"])))
                  for s in spans)


@pytest.fixture(scope="module")
def jtree():
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(11)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_and_spans_match_the_jax_engine(jtree, case):
    kw = CASES[case]
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, jtree),
                            JaxServingConfig(**SC, **kw))
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(jtree, cfg, device="cpu"),
                        ServingConfig(**SC, **kw), device="cpu")
    assert eng._paged_loop == (not case.startswith("contiguous"))
    outs = {}
    for name, e in (("jax", jeng.start()), ("port", eng.start())):
        try:
            outs[name] = [e.submit(p, **_trace(i)).result(
                timeout=TIMEOUT)["tokens"] for i, p in enumerate(_prompts())]
        finally:
            e.stop()
    assert outs["port"] == outs["jax"]

    jm, pm = jeng.metrics, eng.metrics
    jfam, pfam = _families(jm.render()), _families(pm.render())
    shared = set(jfam) & set(pfam)
    assert len(shared) > 40
    assert {k: pfam[k] for k in shared} == {k: jfam[k] for k in shared}
    # every series the port renders is the JAX engine's, but its own
    # paged-chunk, dense-route and registry counters
    own = {"tpu_serving_paged_prefill_chunks", "tpu_serving_dense_prefills",
           "tpu_serving_dense_prefill_heads",
           "tpu_serving_dense_prefill_chunks", "tpu_serving_embeds",
           "tpu_serving_adapters_registered"}
    extra = {k.split()[2].removesuffix("_total") for k in set(pfam) - shared}
    assert extra <= own, extra

    for name in COUNTERS:
        assert pm.get_counter(name) == jm.get_counter(name), name
    if case == "speculate":
        assert pm.get_counter("tpu_serving_spec_accepted") > 0
    if eng._paged_loop:
        assert pm.get_counter("tpu_serving_prefix_cache_hits") >= 1
    # the prompts of 29, 7, 44 and 11 tokens, in chunks of 8 on a cold
    # trie; the paged loop's 20-token prefix hit skips two of them
    chunks = 4 + 1 + 6 + 2 - (2 if eng._paged_loop else 0)
    assert pm.get_counter("tpu_serving_prefill_chunks") == (
        chunks if "chunked" in case else 0)
    jh, ph = _hist_counts(jm.snapshot()), _hist_counts(pm.snapshot())
    assert set(ph) <= set(jh) and len(ph) >= 11
    assert ph == {k: jh[k] for k in ph}
    n = len(_prompts())
    assert ph[("tpu_serving_ttft_seconds", ())] == n
    assert ph[("tpu_serving_inter_token_seconds", ())] == sum(
        len(t) - 1 for t in outs["port"])

    for i in range(n):
        tree = _tree(eng.tracer, i)
        assert tree == _tree(jeng.tracer, i)
        assert [t[0] for t in tree] == ["serving.decode", "serving.prefill",
                                        "serving.queue_wait",
                                        "serving.request"]
        assert all(t[2] for t in tree)

    text = pm.render()
    for key, value in eng.debug_snapshot()["counters"].items():
        line = [x for x in text.splitlines()
                if x.startswith(f"tpu_serving_{key}_total ")]
        assert float(line[0].split()[1]) == value if line else value == 0
    assert set(ReplicaReporter(eng, "http://router", "r", "http://r")
               .stats()) == set(JaxReplicaReporter(jeng, "http://router",
                                                   "r", "http://r").stats())
