"""Speculative decoding on the port's paged loop, on the CPU.

- for the plain, int8-KV, MLA and MLA int8-latent layouts of the f32 tiny
  models (the JAX ``test_paged_engine.py`` speculation matrix), the
  port's ``speculate_k=3`` engine gives the JAX paged speculative
  engine's greedy tokens on draft-friendly (repetitive) and draft-hostile
  prompts, and the port's ``speculate_k=0`` engine's tokens on those and
  on a seeded sampled request (the port's sampler draws from its own
  seeded streams, not ``jax.random``'s); drafts are accepted, the hostile
  prompt rolls pages back, and no page leaks after drain;
- ``_propose`` proposes what a naive backward bigram scan proposes;
- a greedy request runs to its cache budget with ``cache_len`` a
  multiple of the page size (the verify rows stop at the budget);
- penalized and ``logit_bias`` requests never take the K-wide greedy
  commit and give the non-speculative engine's tokens.
"""

import threading

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
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (Request,
                                                            ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.scheduler import _Slot

TIMEOUT = 120
SEED = 20261017
REP = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
HOSTILE = [3, 1, 4, 1, 5, 9, 2, 6, 8, 10]
SAMPLED = [11, 12, 13, 11, 12, 13, 11]
DENSE = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                          n_heads=4, n_kv_heads=2, mlp_dim=128,
                          max_seq_len=512, dtype=jnp.float32,
                          param_dtype=jnp.float32)
MLA = jllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
                      max_seq_len=512, dtype=jnp.float32,
                      param_dtype=jnp.float32)
LAYOUTS = {"plain": (DENSE, False), "kv_int8": (DENSE, True),
           "mla": (MLA, False), "mla_int8": (MLA, True)}


@pytest.fixture(scope="module")
def trees():
    return {name: jax_init_params(jcfg, jax.random.PRNGKey(0))
            for name, jcfg in (("dense", DENSE), ("mla", MLA))}


def _port(jcfg, jtree):
    cfg = config_from_jax(jcfg, torch.float32)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                                cfg, device="cpu")


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _drain(engine):
    engine.drain()
    wait = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            return
        wait.wait(0.05)
    raise AssertionError("engine did not drain")


def _one_by_one(engine, requests):
    return [engine.submit(p, **kw).result(timeout=TIMEOUT)["tokens"]
            for p, kw in requests]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_speculative_token_identity_and_rollback(trees, layout):
    jcfg, kv_int8 = LAYOUTS[layout]
    jtree = trees["mla" if jcfg is MLA else "dense"]
    sc = dict(slots=2, max_prefill_len=32, cache_len=256, max_new_tokens=64,
              kv_page_tokens=8, quantize_kv_int8=kv_int8)
    greedy = [(REP, dict(max_new_tokens=24)),
              (HOSTILE, dict(max_new_tokens=24))]
    sampled = [(SAMPLED, dict(max_new_tokens=24, temperature=0.8,
                              seed=SEED))]
    jeng = JaxServingEngine(jcfg, jtree, JaxServingConfig(
        **sc, speculate_k=3)).start()
    try:
        ref = _one_by_one(jeng, greedy)
    finally:
        jeng.stop()
    cfg, params = _port(jcfg, jtree)
    spec = ServingEngine(cfg, params, ServingConfig(**sc, speculate_k=3),
                         device="cpu").start()
    plain = ServingEngine(cfg, params, ServingConfig(**sc),
                          device="cpu").start()
    try:
        got = _one_by_one(spec, greedy[:1])
        rolled = spec.counters["paged_speculative_rollback_pages"]
        got += _one_by_one(spec, greedy[1:])
        hostile_rolled = (spec.counters["paged_speculative_rollback_pages"]
                          - rolled)
        got_sampled = _one_by_one(spec, sampled)
        base = _one_by_one(plain, greedy + sampled)
        assert got == ref, f"{layout}: port != JAX speculative engine"
        assert got + got_sampled == base, f"{layout}: speculation changed " \
            "the tokens"
        c = spec.counters
        assert c["paged_speculative_steps"] > 0 and c["spec_accepted"] > 0
        assert c["spec_proposed"] >= c["spec_accepted"]
        assert hostile_rolled > 0
        assert plain.counters["paged_speculative_steps"] == 0
        _drain(spec)
        assert _leak_free(spec)
        assert spec.debug_snapshot()["speculate_k"] == 3
    finally:
        spec.stop()
        plain.stop()


def test_propose_matches_a_naive_backward_scan():
    def naive(ctx, k):
        draft = []
        if len(ctx) >= 3:
            big = (ctx[-2], ctx[-1])
            for i in range(len(ctx) - 3, -1, -1):
                if (ctx[i], ctx[i + 1]) == big:
                    draft = ctx[i + 2:i + 2 + k]
                    break
        while len(draft) < k:
            draft.append(ctx[-1])
        return draft[:k]

    propose = ServingEngine._propose
    rng = np.random.default_rng(0)
    for _ in range(20):
        prompt = [int(t) for t in rng.integers(0, 5, rng.integers(1, 30))]
        slot = _Slot(request=Request(prompt=prompt, max_new_tokens=64,
                                     rid="t", future=None, submitted_at=0.0,
                                     temperature=0.0))
        for _ in range(30):
            k = int(rng.integers(1, 6))
            ctx = prompt + slot.generated
            assert propose(None, slot, k) == naive(list(ctx), k)
            slot.generated.append(int(rng.integers(0, 5)))


def test_greedy_request_runs_to_its_cache_budget(trees):
    """cache_len a multiple of T: near the budget the verify rows stop at
    it instead of asking for table columns past the slot's width."""
    cfg, params = _port(DENSE, trees["dense"])
    sc = dict(slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=64,
              kv_page_tokens=8)
    spec = ServingEngine(cfg, params, ServingConfig(**sc, speculate_k=3),
                         device="cpu").start()
    plain = ServingEngine(cfg, params, ServingConfig(**sc),
                          device="cpu").start()
    try:
        for prompt in (REP, REP + REP[:5]):
            got = spec.submit(prompt).result(timeout=TIMEOUT)["tokens"]
            want = plain.submit(prompt).result(timeout=TIMEOUT)["tokens"]
            assert got == want and len(got) == 64 - len(prompt)
        assert spec.counters["engine_errors"] == 0
        assert spec.counters["spec_accepted"] > 0
        _drain(spec)
        assert _leak_free(spec)
    finally:
        spec.stop()
        plain.stop()


def test_penalized_and_biased_requests_skip_the_k_commit(trees):
    cfg, params = _port(DENSE, trees["dense"])
    sc = dict(slots=3, max_prefill_len=32, cache_len=128, max_new_tokens=20,
              kv_page_tokens=8)
    modded = [dict(presence_penalty=0.7, frequency_penalty=0.3),
              dict(logit_bias={6: 4.0, 7: -3.0})]
    spec = ServingEngine(cfg, params, ServingConfig(**sc, speculate_k=3),
                         device="cpu").start()
    plain = ServingEngine(cfg, params, ServingConfig(**sc),
                          device="cpu").start()
    try:
        # alone: no greedy slot is live, so no verify step runs
        for kw in modded:
            got = spec.submit(REP, **kw).result(timeout=TIMEOUT)["tokens"]
            assert got == plain.submit(REP, **kw).result(
                timeout=TIMEOUT)["tokens"]
        assert spec.counters["paged_speculative_steps"] == 0
        # beside a greedy stream: they ride the verify steps at one token
        reqs = [(REP, {})] + [(REP, kw) for kw in modded]
        got = [f.result(timeout=TIMEOUT)["tokens"] for f in
               [spec.submit(p, **kw) for p, kw in reqs]]
        want = [f.result(timeout=TIMEOUT)["tokens"] for f in
                [plain.submit(p, **kw) for p, kw in reqs]]
        assert got == want
        assert spec.counters["paged_speculative_steps"] > 0
        _drain(spec)
        assert _leak_free(spec)
    finally:
        spec.stop()
        plain.stop()
