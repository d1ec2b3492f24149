"""The port's serving engine on an f32 ``tiny_moe`` against the JAX
package's, on the CPU.

Both engines get the same seeded numpy weights (the JAX package's own
quantizer makes each engine's int8 or int4 copy) and the same prompts; the
router is drawn wider than the other leaves so routing depends on the
token. Greedy tokens must be identical:

- ``paged_verify_step`` logits within 1e-4 of the JAX model's over a
  mixed ``n_tokens`` batch (the serving capacity: no drop), raw and int4;
- the engine for raw, int8 and int4 weights, over the compute-dtype arena
  and the int8 arena, with a prefix hit and no leaked page after drain;
- ``speculate_k=3`` against the JAX speculative engine (and the port's
  own plain engine);
- ``serving_chunk_tokens=8`` against the JAX chunked engine, with decode
  steps interleaved beside a long prompt;
- the dense route: a group of n = 2 over one prompt on a pool at its
  minimum (the slots' residency; the group's prefill goes through the
  contiguous ``prefill`` and ``prefill_chunk_step``) against the JAX
  engine's group;
- ``embed`` within 1e-5 of the JAX forward's mean-pooled hidden state at
  the serving capacity (the JAX engine's ``embed`` routes at the training
  capacity factor, 1.25, and may drop assignments; the port routes
  ``embed`` like every serving path, with no drop);
- the serve CLI with ``--model tiny-moe --int4`` over HTTP.

Seeds are chosen so that no token's 2nd and 3rd router probabilities lie
within f32 noise of each other: ``torch.topk`` and ``jax.lax.top_k`` may
order exact ties differently.
"""

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models.quant import \
    quantize_params as jax_quantize_params
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
JCFG = jllama.tiny_moe(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=512,
                       dtype=jnp.float32, param_dtype=jnp.float32)
T = 8
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages
REP = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
HOSTILE = [3, 1, 4, 1, 5, 9, 2, 6, 8, 10]


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX layout: norms near 1, the
    router at 0.3, every other leaf at 0.05."""
    rng = np.random.default_rng(20261017)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(JCFG, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = 0.3 if name == "router" else 0.05
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _port(tree):
    cfg = config_from_jax(JCFG, torch.float32)
    return cfg, params_from_jax(tree, cfg, device="cpu")


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


def _one_by_one(engine, prompts, **kw):
    return [engine.submit(p, **kw).result(timeout=TIMEOUT)["tokens"]
            for p in prompts]


@pytest.mark.parametrize("bits", [0, 4])
def test_paged_verify_step_matches_jax(tree, bits):
    jtree = (jax.tree_util.tree_map(
        np.asarray, jax_quantize_params(JCFG, tree, bits=bits)) if bits
        else tree)
    cfg, _ = _port(tree)
    params = params_from_jax(jtree, cfg, device="cpu")
    jmodel, model = jllama.LlamaModel(JCFG), LlamaModel(cfg, device="cpu")
    table = np.random.default_rng(5).permutation(24)[:16].reshape(2, 8) \
        .astype(np.int32)
    toks = np.random.default_rng(8).integers(1, 128, (2, 20)).astype(
        np.int32)
    n_tok = np.array([20, 13], np.int32)
    zero = np.zeros((2,), np.int32)
    lj, _ = jax.jit(jmodel.paged_verify_step)(
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(toks),
        jmodel.init_paged_arena(24, T), jnp.asarray(table), jnp.asarray(zero),
        n_tokens=jnp.asarray(n_tok))
    lt, _ = model.paged_verify_step(
        params, torch.from_numpy(toks), model.init_paged_arena(24, T),
        torch.from_numpy(table), torch.from_numpy(zero),
        n_tokens=torch.from_numpy(n_tok))
    for b, n in enumerate(n_tok):
        np.testing.assert_allclose(lt[b, :n].numpy(), np.asarray(lj)[b, :n],
                                   rtol=0, atol=1e-4)


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=12, kv_page_tokens=T)
    base.update(kw)
    return base


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)],
           SHARED + [int(t) for t in rng.integers(1, 128, 9)]]
    out += [[int(t) for t in rng.integers(1, 128, n)] for n in (3, 40)]
    return out


@pytest.mark.parametrize("weights,kv_int8", [
    ("raw", False), ("raw", True), ("int8", False), ("int8", True),
    ("int4", False), ("int4", True)])
def test_engine_matches_the_jax_engine(tree, weights, kv_int8):
    flags = dict(quantize_int4=weights == "int4",
                 quantize_int8=weights == "int8", quantize_kv_int8=kv_int8)
    prompts = _prompts()
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config(**flags))).start()
    try:
        ref = _one_by_one(jeng, prompts)
    finally:
        jeng.stop()
    cfg, params = _port(tree)
    eng = ServingEngine(cfg, params, ServingConfig(**_config(**flags)),
                        device="cpu").start()
    try:
        got = _one_by_one(eng, prompts)
        assert eng.counters["prefix_cache_hits"] >= 1
        _drain(eng)
        assert _leak_free(eng)
        snap = eng.debug_snapshot()
        assert snap["weights"] == ("float32" if weights == "raw"
                                   else weights)
        if weights == "int4":
            assert "q4" in eng.params["layers"]["we_gate"]
    finally:
        eng.stop()
    assert got == ref


def test_speculative_engine_matches_the_jax_engine(tree):
    sc = dict(slots=2, max_prefill_len=32, cache_len=256, max_new_tokens=24,
              kv_page_tokens=T)
    greedy = [REP, HOSTILE]
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**sc, speculate_k=3)).start()
    try:
        ref = _one_by_one(jeng, greedy)
    finally:
        jeng.stop()
    cfg, params = _port(tree)
    spec = ServingEngine(cfg, params, ServingConfig(**sc, speculate_k=3),
                         device="cpu").start()
    plain = ServingEngine(cfg, params, ServingConfig(**sc),
                          device="cpu").start()
    try:
        got = _one_by_one(spec, greedy)
        assert got == ref
        assert got == _one_by_one(plain, greedy)
        assert spec.counters["paged_speculative_steps"] > 0
        _drain(spec)
        assert _leak_free(spec)
    finally:
        spec.stop()
        plain.stop()


def test_chunk_interleave_matches_the_jax_engine(tree):
    sc = _config(cache_len=256, max_prefill_len=64, serving_chunk_tokens=8)
    long_prompt = [int(t) for t in
                   np.random.default_rng(9).integers(1, 128, 60)]
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**sc)).start()
    try:
        ref = _one_by_one(jeng, [long_prompt] + _prompts()[:2])
    finally:
        jeng.stop()
    cfg, params = _port(tree)
    eng = ServingEngine(cfg, params, ServingConfig(**sc),
                        device="cpu").start()
    try:
        got = _one_by_one(eng, [long_prompt] + _prompts()[:2])
        # a fresh long prompt beside a decoding stream: decode steps
        # between its chunks
        stream = eng.submit([1, 2, 3], max_new_tokens=120)
        deadline = time.monotonic() + TIMEOUT
        while eng.active_slots == 0:
            assert time.monotonic() < deadline, "the stream never decoded"
            time.sleep(0.001)
        fresh = [int(t) for t in np.random.default_rng(4).integers(1, 128, 64)]
        eng.submit(fresh, max_new_tokens=2).result(timeout=TIMEOUT)
        assert eng.counters["chunk_interleaved_steps"] > 0
        assert len(stream.result(timeout=TIMEOUT)["tokens"]) == 120
    finally:
        eng.stop()
    assert got == ref


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
    cfg, params = _port(tree)
    eng = ServingEngine(cfg, params, ServingConfig(**sc),
                        device="cpu").start()
    try:
        got = [f.result(timeout=TIMEOUT)["tokens"]
               for f in eng.submit_group(prompt, n=2)]
        assert eng.counters["dense_prefills"] >= 1
        emb = np.array(eng.embed(_prompts()[0]))
        assert eng.counters["embeds"] == 1
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
    assert got == ref and got[0] == got[1]
    # the JAX model's serving routing (capacity factor X/k)
    no_drop = dataclasses.replace(JCFG, capacity_factor=2.0)
    hidden = jllama.LlamaModel(no_drop).forward(
        jparams, jnp.asarray([_prompts()[0]], jnp.int32),
        return_hidden=True)
    np.testing.assert_allclose(emb, np.asarray(hidden[0]).mean(0), rtol=0,
                               atol=1e-5)


def test_serve_cli_builds_a_quantized_moe_engine():
    args = serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny-moe", "--int4", "--tokenizer",
         "bytes", "--slots", "2", "--cache-len", "64", "--max-new-tokens",
         "4"])
    engine, tok = serve_main.build_engine(args)
    httpd = serve_main.serve(engine, port=0, tokenizer=tok, host="127.0.0.1")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"text": "hello"}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert 1 <= len(out["tokens"]) <= 4
        lp = engine.params["layers"]
        assert "q4" in lp["we_down"] and lp["router"].dtype == torch.float32
        assert engine.debug_snapshot()["weights"] == "int4"
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
