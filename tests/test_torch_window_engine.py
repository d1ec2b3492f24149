"""The port's engine on a uniform sliding window (Mistral's layout, tiny:
a 16-token window over 8-token pages, so ``_win_pages`` = 16 // 8 + 2 = 4)
against the JAX package's ``ServingEngine`` on the same f32 weights:

- prompts longer than the window, decoding far past it: greedy tokens
  identical, and equal ``ring_recycled`` counts summed over the step
  records; no page leaks;
- a prompt page the prefix trie shares is recycled by allocate-on-write:
  the slot swaps it for a private page and the trie's copy stays as it
  was, so the same prompt again hits the cache and decodes the same
  tokens;
- a slot whose prompt fits in the window holds at most ``_win_pages`` + 1
  distinct pages however long it decodes, and never names a page twice in
  its page list;
- ``speculate_k`` > 0 takes no speculative step (and builds no verify
  graph) and decodes the same tokens;
- an n = 2 group (the dense-scratch route) decodes the JAX engine's
  tokens in both members.
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
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, sliding_window=16,
                         dtype=jnp.float32, param_dtype=jnp.float32)
SC = dict(slots=4, max_prefill_len=32, cache_len=128, max_new_tokens=48,
          kv_page_tokens=8)
WIN_PAGES = 16 // 8 + 2


def _prompts():
    rng = np.random.default_rng(17)
    return [[int(t) for t in rng.integers(1, 128, n)]
            for n in (40, 33, 20, 5)]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(4))


@pytest.fixture(scope="module")
def port(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    cfg = config_from_jax(JCFG, torch.float32)
    return cfg, params_from_jax(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_ref(jax_params):
    """The JAX engine's tokens for each prompt, one at a time, and the
    pages its step records say it recycled."""
    eng = JaxServingEngine(JCFG, jax_params, JaxServingConfig(**SC)).start()
    try:
        toks = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
                for p in _prompts()]
        recycled = _recycled(eng)
    finally:
        eng.stop()
    return toks, recycled


def _recycled(engine) -> int:
    steps = engine.recorder.snapshot(512)["steps"]
    return sum(s.get("arena", {}).get("ring_recycled", 0) for s in steps)


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


def _engine(port, **kw):
    cfg, params = port
    return ServingEngine(cfg, params, ServingConfig(**{**SC, **kw}),
                         device="cpu").start()


def test_greedy_tokens_and_ring_recycled_match_the_jax_engine(port,
                                                              jax_ref):
    want, want_recycled = jax_ref
    eng = _engine(port)
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in _prompts()]
        assert eng.debug_snapshot()["sliding_window"] == 16
        recycled = _recycled(eng)
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert got == want
    assert all(len(t) == 48 for t in got)
    assert recycled == want_recycled > 0


def test_trie_shared_prompt_page_is_recycled_by_allocate_on_write(port):
    """The 40-token prompt's five full pages enter the trie; its 47 decode
    steps write positions 40..86, table entries 5..10, each recycling the
    page of entry j - 4 (entries 1..6, the trie's 1..4 among them). The
    trie's pages must keep their bytes, and the same prompt again must hit
    the cache and decode the same tokens."""
    prompt = _prompts()[0]
    eng = _engine(port)
    seen = {}

    def on_token(_tok):
        slot = next(s for s in eng._slots if s.request is not None)
        if "trie" not in seen:
            pages = [n.page for n in eng._kv_store.trie._nodes.values()]
            seen["trie"] = {p: eng._kv_store.arena["k"][:, p].clone()
                            for p in pages}
        seen["max_refs"] = max(seen.get("max_refs", 0), max(
            eng._kv_store.pool.refcount(p) for p in slot.pages))
        assert len(slot.pages) == len(set(slot.pages))

    try:
        first = eng.submit(prompt, on_token=on_token).result(
            timeout=TIMEOUT)["tokens"]
        assert len(seen["trie"]) == 5 and seen["max_refs"] == 2
        assert _recycled(eng) == 6
        for page, k in seen["trie"].items():
            assert eng._kv_store.pool.refcount(page) == 1   # the trie's
            torch.testing.assert_close(eng._kv_store.arena["k"][:, page], k,
                                       rtol=0, atol=0)
        hits = eng.counters["prefix_cache_hits"]
        again = eng.submit(prompt).result(timeout=TIMEOUT)["tokens"]
        assert eng.counters["prefix_cache_hits"] == hits + 1
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert again == first


def test_a_slot_holds_at_most_win_pages_plus_one(port):
    """A 5-token prompt decoding 120 tokens: 16 table entries over at most
    _win_pages + 1 distinct pages."""
    eng = _engine(port, max_new_tokens=120)
    held = []

    def on_token(_tok):
        slot = next(s for s in eng._slots if s.request is not None)
        held.append((len(slot.pages), slot.table_len))

    try:
        out = eng.submit(_prompts()[3], on_token=on_token).result(
            timeout=TIMEOUT)["tokens"]
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert len(out) == 120
    assert max(h for h, _ in held) <= WIN_PAGES + 1
    assert max(n for _, n in held) == 16


def test_speculation_takes_no_step_on_a_window(port, jax_ref):
    eng = _engine(port, speculate_k=3)
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in _prompts()]
        assert eng.counters["paged_speculative_steps"] == 0
        assert set(eng.graphs_snapshot()) == {"paged_step"}
    finally:
        eng.stop()
    assert got == jax_ref[0]


def test_group_on_the_dense_route_decodes_the_jax_tokens(port, jax_ref):
    prompt = _prompts()[1]
    eng = _engine(port)
    try:
        futs = eng.submit_group(prompt, 2)
        got = [f.result(timeout=TIMEOUT)["tokens"] for f in futs]
        assert eng.counters["dense_prefills"] == 1
        assert _recycled(eng) > 0
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert got == [jax_ref[0][1]] * 2
