"""The port's paged ServingEngine and its HTTP front, on the CPU.

- greedy outputs token-identical to the JAX package's ServingEngine on
  the same f32 parameters and prompts (the JAX engine also runs its paged
  loop with paged-native prefill on the CPU), with a prefix-cache hit
  seen and zero leaked pages after drain;
- prompts longer than ``max_prefill_len`` prefill in several chunks and
  decode the same tokens as one-chunk prefill;
- a repeat of a greedy request gives the same tokens; sampled requests
  with a seed repeat too;
- the HTTP front: /generate (token ids and byte-tokenized text),
  /healthz, /readyz, /drain, /debug/engine and its error statuses.
"""

import json
import threading
import urllib.error
import urllib.request

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
from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, init_params,
                                                 tiny_llama)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
    EngineDraining, ServingConfig, ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import ByteTokenizer

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)]]
    out.append(SHARED + [int(t) for t in rng.integers(1, 128, 9)])
    for n in (3, 17, 40, 8):
        out.append([int(t) for t in rng.integers(1, 128, n)])
    return out


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=12, kv_page_tokens=8)
    base.update(kw)
    return base


def _leak_free(engine) -> bool:
    """Every pool page is free or held by exactly one trie node."""
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _drain(engine):
    engine.drain()
    deadline = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            return
        deadline.wait(0.05)
    raise AssertionError("engine did not drain")


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def port_pair(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    cfg = config_from_jax(JCFG, torch.float32)
    return cfg, params_from_jax(tree, cfg, device="cpu")


def _serve_all(engine, prompts, **kw):
    futs = [engine.submit(p, **kw) for p in prompts]
    return [f.result(timeout=TIMEOUT)["tokens"] for f in futs]


def test_greedy_output_matches_the_jax_engine(jax_params, port_pair):
    prompts = _prompts()
    jeng = JaxServingEngine(JCFG, jax_params,
                            JaxServingConfig(**_config())).start()
    try:
        # one at a time: the shared-prefix pair then hits the trie
        ref = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        jeng.stop()
    cfg, params = port_pair
    eng = ServingEngine(cfg, params, ServingConfig(**_config()),
                        device="cpu").start()
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
        assert eng.counters["prefix_cache_hits"] >= 1
        _drain(eng)
        assert _leak_free(eng)
        snap = eng.debug_snapshot()
        assert snap["drained"] and snap["device"] == "cpu"
        assert snap["counters"]["admitted"] == len(prompts)
    finally:
        eng.stop()
    assert got == ref
    assert all(len(t) == 12 for t in got)


def test_chunked_prefill_and_repeats(port_pair):
    cfg, params = port_pair
    prompts = _prompts()
    one = ServingEngine(cfg, params, ServingConfig(**_config(
        max_prefill_len=64)), device="cpu").start()
    many = ServingEngine(cfg, params, ServingConfig(**_config(
        max_prefill_len=8)), device="cpu").start()
    try:
        ref = _serve_all(one, prompts)
        got = _serve_all(many, prompts)
        assert many.counters["paged_prefill_chunks"] > len(prompts)
        assert got == ref
        # repeats: greedy, and sampled with a seed
        assert _serve_all(many, prompts[:2]) == ref[:2]
        s1 = many.submit(prompts[3], temperature=0.9, top_p=0.9, seed=5)
        s2 = many.submit(prompts[3], temperature=0.9, top_p=0.9, seed=5)
        assert s1.result(timeout=TIMEOUT)["tokens"] == \
            s2.result(timeout=TIMEOUT)["tokens"]
        pen = many.submit(prompts[4], frequency_penalty=1.5,
                          logit_bias={5: 100.0})
        assert set(pen.result(timeout=TIMEOUT)["tokens"]) == {5}
        for eng in (one, many):
            _drain(eng)
            assert _leak_free(eng)
        with pytest.raises(EngineDraining):
            many.submit(prompts[0]).result(timeout=TIMEOUT)
    finally:
        one.stop()
        many.stop()


def test_submit_validation(port_pair):
    cfg, params = port_pair
    eng = ServingEngine(cfg, params, ServingConfig(**_config()),
                        device="cpu")
    for bad in (dict(prompt=[]), dict(prompt=[1000]),
                dict(prompt=[1] * 128), dict(prompt=[1], top_p=0.0),
                dict(prompt=[1], temperature=-1.0),
                dict(prompt=[1], max_new_tokens=0)):
        with pytest.raises(ValueError):
            eng.submit(**bad).result(timeout=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(cfg, params, ServingConfig(**_config(cache_len=512)),
                      device="cpu")


# -- HTTP ------------------------------------------------------------------------

def _http(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_front():
    cfg = tiny_llama(vocab_size=260, embed_dim=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=64, max_seq_len=128,
                     dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = ByteTokenizer()
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=4,
        kv_page_tokens=8, eos_token=tok.eos_id), device="cpu").start()
    httpd = serve(eng, port=0, tokenizer=tok, host="127.0.0.1")
    port = httpd.server_address[1]
    try:
        assert _http(port, "GET", "/healthz") == (200, b"ok")
        assert _http(port, "GET", "/readyz") == (200, b"ready")
        status, body = _http(port, "POST", "/generate",
                             {"tokens": [1, 2, 3], "max_new_tokens": 3})
        out = json.loads(body)
        assert status == 200 and set(out) == {"rid", "tokens", "latency_s",
                                              "text"}
        assert 1 <= len(out["tokens"]) <= 3
        status, body = _http(port, "POST", "/generate",
                             {"text": "hello", "temperature": 0.8,
                              "top_k": 5, "seed": 1})
        assert status == 200 and isinstance(json.loads(body)["text"], str)
        assert _http(port, "POST", "/generate", {"tokens": "x"})[0] == 400
        # an engine without lora_rank knows no adapter: the name is
        # unknown (400), and live registration is off without
        # --dynamic-adapters (403)
        status, body = _http(port, "POST", "/generate",
                             {"tokens": [1], "adapter": "lora-a"})
        assert status == 400 and b"unknown adapter 'lora-a'" in body
        assert _http(port, "POST", "/adapters",
                     {"name": "lora-a", "path": "a.npz"})[0] == 403
        status, body = _http(port, "GET", "/v1/models")
        assert status == 200 and [m["id"] for m in json.loads(body)[
            "data"]] == ["tiny"]
        assert _http(port, "POST", "/generate",
                     {"tokens": [1], "top_p": 2.0})[0] == 400
        assert _http(port, "GET", "/nope")[0] == 404
        status, body = _http(port, "GET", "/debug/engine")
        assert status == 200 and json.loads(body)["model"] == "tiny"
        assert _http(port, "POST", "/drain", {})[0] == 200
        assert _http(port, "GET", "/readyz") == (503, b"draining")
        assert _http(port, "GET", "/healthz") == (200, b"draining")
        assert _http(port, "POST", "/generate", {"tokens": [1]})[0] == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.stop()


def test_engine_defaults_to_cuda(port_pair):
    cfg, params = port_pair
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, ServingConfig(**_config()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaModel(cfg)


def test_concurrent_submitters_stress(port_pair):
    """More submitting threads than cores, a tiny switch interval and a
    pool small enough to evict: every request completes with the tokens a
    one-at-a-time run gives, and the pool ends with zero leaked pages."""
    import os
    import sys

    cfg, params = port_pair
    rng = np.random.default_rng(11)
    prompts = []
    for i in range(24):
        head = SHARED[:8 * int(rng.integers(0, 4))] if i % 2 else []
        tail = [int(t) for t in rng.integers(1, 128, int(rng.integers(2, 30)))]
        prompts.append(head + tail)
    sc = _config(slots=2, cache_len=64, max_new_tokens=6, max_prefill_len=16)
    ref_eng = ServingEngine(cfg, params, ServingConfig(**sc),
                            device="cpu").start()
    try:
        ref = [ref_eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        ref_eng.stop()
    eng = ServingEngine(cfg, params, ServingConfig(**sc),
                        device="cpu").start()
    n_threads = max(8, 2 * (os.cpu_count() or 1))
    results: dict[int, list] = {}
    errors: list = []

    def worker(k):
        try:
            futs = [(i, eng.submit(prompts[i]))
                    for i in range(k, len(prompts), n_threads)]
            for i, f in futs:
                results[i] = f.result(timeout=TIMEOUT)["tokens"]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors, errors
        assert [results[i] for i in range(len(prompts))] == ref
        assert eng.counters["prefix_cache_hits"] >= 1
        _drain(eng)
        assert _leak_free(eng)
    finally:
        eng.stop()
