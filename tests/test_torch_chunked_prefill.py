"""Chunked prefill with decode interleave on the port's paged loop, on the
CPU.

- the ``ChunkArbiter`` contract (the JAX package's three unit tests): an
  idle yield is free, a yield waits for one decode step, and it returns
  when the last slot empties without a step;
- ``serving_chunk_tokens=8`` gives the tokens of monolithic prefill and
  of the JAX package's chunked engine;
- a long prompt arriving beside a decoding stream interleaves decode steps
  between its chunks (read from the counter only: wall-clock comparisons
  are unsteady on the CPU).
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
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.scheduler import \
    ChunkArbiter

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=512, dtype=jnp.float32,
                         param_dtype=jnp.float32)


class TestChunkArbiter:
    def test_idle_yield_is_free(self):
        arb = ChunkArbiter()
        assert arb.yield_for_decode(lambda: False) == 0

    def test_yield_waits_for_a_step(self):
        arb = ChunkArbiter()
        ran = []

        def prefiller():
            ran.append(arb.yield_for_decode(lambda: True, timeout_s=5.0))

        th = threading.Thread(target=prefiller)
        th.start()
        time.sleep(0.05)
        assert not ran, "yield returned before any decode step"
        arb.decode_step_done()
        th.join(timeout=5.0)
        assert not th.is_alive() and ran == [1]

    def test_yield_unblocks_when_slots_empty(self):
        arb = ChunkArbiter()
        active = [True]
        ran = []

        def prefiller():
            ran.append(arb.yield_for_decode(lambda: active[0],
                                            timeout_s=0.2))

        th = threading.Thread(target=prefiller)
        th.start()
        active[0] = False   # last slot completed without a step
        th.join(timeout=5.0)
        assert not th.is_alive() and ran == [0]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(1))


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=256,
                max_new_tokens=12, kv_page_tokens=8)
    base.update(kw)
    return base


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, 128, n)]
            for n in (5, 23, 41, 70, 9)]


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def test_chunked_prefill_matches_monolithic_and_jax(jax_params):
    prompts = _prompts()
    jeng = JaxServingEngine(JCFG, jax_params, JaxServingConfig(
        **_config(serving_chunk_tokens=8))).start()
    try:
        ref = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        jeng.stop()
    cfg = config_from_jax(JCFG, torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             cfg, device="cpu")
    chunked = ServingEngine(cfg, params, ServingConfig(
        **_config(serving_chunk_tokens=8)), device="cpu").start()
    whole = ServingEngine(cfg, params, ServingConfig(**_config()),
                          device="cpu").start()
    try:
        got = [f.result(timeout=TIMEOUT)["tokens"]
               for f in [chunked.submit(p) for p in prompts]]
        base = [f.result(timeout=TIMEOUT)["tokens"]
                for f in [whole.submit(p) for p in prompts]]
        assert got == base == ref
        # 5, 23, 41, 70, 9 tokens in 8-token chunks
        assert chunked.counters["prefill_chunks"] == 1 + 3 + 6 + 9 + 2
        assert chunked.debug_snapshot()["serving_chunk_tokens"] == 8
        chunked.drain()
        for _ in range(TIMEOUT * 20):
            if chunked.drained:
                break
            time.sleep(0.05)
        assert chunked.drained and _leak_free(chunked)
    finally:
        chunked.stop()
        whole.stop()


def test_long_prompt_interleaves_with_a_decoding_stream(jax_params):
    cfg = config_from_jax(JCFG, torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             cfg, device="cpu")
    eng = ServingEngine(cfg, params, ServingConfig(
        **_config(serving_chunk_tokens=8)), device="cpu").start()
    try:
        stream = eng.submit([1, 2, 3], max_new_tokens=200)
        deadline = time.monotonic() + TIMEOUT
        while eng.active_slots == 0:
            assert time.monotonic() < deadline, "the stream never decoded"
            time.sleep(0.001)
        long_prompt = [int(t) for t in
                       np.random.default_rng(4).integers(1, 128, 120)]
        eng.submit(long_prompt, max_new_tokens=2).result(timeout=TIMEOUT)
        # 15 chunks, 14 yields, each waiting out a decode step (or its
        # liveness timeout on a stalled host)
        assert eng.counters["chunk_interleaved_steps"] > 0
        assert len(stream.result(timeout=TIMEOUT)["tokens"]) == 200
    finally:
        eng.stop()
