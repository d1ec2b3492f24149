"""Registered (pinned) prefixes on the port's paged engine, on the CPU.

- ``register_prefix`` is idempotent, validates its tokens and is capped at
  ``max_prefixes`` (ValueError);
- a registered prefix's pages are pinned: eviction pressure from many
  distinct prompts leaves them in the trie, and a later prompt starting
  with the prefix counts a ``prefix_hits`` and decodes what an engine
  without the registration decodes;
- ``POST /prefix`` answers 200 ``{"registered": n}`` and 400 for an
  empty, too-long or over-cap prefix;
- the pool holds zero leaked pages after drain.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models import init_params, tiny_llama
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import \
    PagedKVStore

TIMEOUT = 120
CFG = tiny_llama(vocab_size=128, embed_dim=32, n_layers=2, n_heads=4,
                 n_kv_heads=2, mlp_dim=64, max_seq_len=128,
                 dtype=torch.float32)
PREFIX = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _engine(params, **kw):
    sc = dict(slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=6,
              kv_page_tokens=8)
    sc.update(kw)
    return ServingEngine(CFG, params, ServingConfig(**sc),
                         device="cpu").start()


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


def test_register_prefix_idempotent_and_capped(params):
    eng = _engine(params, max_prefixes=2)
    try:
        eng.register_prefix(PREFIX)
        eng.register_prefix(list(PREFIX))   # the same tokens: a no-op
        stats = eng.prefix_cache_stats()
        assert stats["registered"] == 1 and stats["pinned"] == 3
        eng.register_prefix(PREFIX[:8] + [7] * 16)
        with pytest.raises(ValueError, match="registry full"):
            eng.register_prefix([9] * 20)
        for bad, match in (([], "empty"), ([1, 128], r"\[0, 128\)"),
                           ([1] * 64, "cache budget")):
            with pytest.raises(ValueError, match=match):
                eng.register_prefix(bad)
        stats = eng.prefix_cache_stats()
        # the second prefix shares the first page and pins two more
        assert stats["registered"] == 2 and stats["pinned"] == 5
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()


def test_pinned_pages_survive_eviction_and_hit(params):
    eng = _engine(params)
    plain = _engine(params)
    try:
        eng.register_prefix(PREFIX)
        pinned = sorted(n.page for n in eng._kv_store.trie._nodes.values())
        # 6 prompts of 7 full pages each: 42 cacheable pages in a
        # 32-page pool, so the trie must evict
        rng = np.random.default_rng(5)
        for _ in range(6):
            p = [int(t) for t in rng.integers(1, 128, 60)]
            eng.submit(p, max_new_tokens=2).result(timeout=TIMEOUT)
        store = eng._kv_store
        assert len(store.trie) < 3 + 6 * 7, "no eviction happened"
        kept = sorted(n.page for n in store.trie._nodes.values() if n.pinned)
        assert kept == pinned
        prompt = PREFIX + [3, 1, 4, 1, 5]
        got = eng.submit(prompt).result(timeout=TIMEOUT)["tokens"]
        assert eng.counters["prefix_hits"] == 1
        assert got == plain.submit(prompt).result(timeout=TIMEOUT)["tokens"]
        assert plain.counters["prefix_hits"] == 0
        _drain(eng)
        assert _leak_free(eng)
        assert eng.prefix_cache_stats()["pinned"] == 3
    finally:
        eng.stop()
        plain.stop()


def test_trie_pins_existing_nodes_along_the_walk():
    """insert_ready(pin=True) over a path already cached unpinned pins it;
    eviction then finds no leaf to drop."""
    store = PagedKVStore(4, 2, {"k": torch.zeros((1, 5, 2, 1, 1))})
    pages = store.alloc_run(2)
    assert store.insert_ready(0, [1, 2, 3, 4], pages) == 2
    assert store.insert_ready(0, [1, 2, 3, 4], pages, pin=True) == 0
    store.release(pages)
    assert store.stats()["pinned"] == 2
    assert not store.trie._evict_lru()
    assert store.alloc_run(2) and store.pool.free_count == 0


def _http(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/prefix", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_post_prefix():
    args = serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny", "--tokenizer", "bytes",
         "--slots", "2", "--cache-len", "64", "--max-prefixes", "1"])
    engine, tok = serve_main.build_engine(args)
    httpd = serve_main.serve(engine, port=0, tokenizer=tok, host="127.0.0.1")
    port = httpd.server_address[1]
    try:
        assert _http(port, {"text": "You are a helpful assistant."}) == \
            (200, {"registered": 28})
        assert _http(port, {"tokens": list(range(1, 21))})[0] == 400  # full
        assert _http(port, {"tokens": []})[0] == 400
        assert _http(port, {"tokens": [1] * 64})[0] == 400
        assert engine.prefix_cache_stats()["registered"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
