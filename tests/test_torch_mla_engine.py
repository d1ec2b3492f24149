"""The port's ServingEngine on an MLA model against the JAX package's, on
the CPU.

- ``ServingEngine`` on f32 ``tiny_mla`` gives the JAX ``ServingEngine``'s
  greedy tokens on the same parameters and prompts, over a latent arena in
  the compute dtype and over int8 latents (``quantize_kv_int8``), the
  "mla" and "mla_int8" flavours of the JAX package's paged-engine layout
  matrix; a prefix hit is seen, the pool holds zero leaked pages after
  drain, and ``debug_snapshot()`` reports the latent layout and its page
  bytes;
- the HTTP front built from ``--model tiny-mla --device cpu`` (and with
  ``--kv-int8``) answers ``/generate``.
"""

import json
import threading
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
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
JCFG = jllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
                       max_seq_len=512, dtype=jnp.float32,
                       param_dtype=jnp.float32)
T = 8
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(3))


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=12, kv_page_tokens=T)
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
    wait = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            return
        wait.wait(0.05)
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("kv_int8", [False, True], ids=["mla", "mla_int8"])
def test_mla_engine_matches_the_jax_engine(jax_params, kv_int8):
    prompts = _prompts()
    flags = dict(quantize_kv_int8=kv_int8)
    jeng = JaxServingEngine(JCFG, jax_params,
                            JaxServingConfig(**_config(**flags))).start()
    try:
        # one at a time: the shared-prefix pair then hits the trie
        ref = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        jeng.stop()
    cfg = config_from_jax(JCFG, torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             cfg, device="cpu")
    eng = ServingEngine(cfg, params, ServingConfig(**_config(**flags)),
                        device="cpu").start()
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
        assert eng.counters["prefix_cache_hits"] >= 1
        _drain(eng)
        assert _leak_free(eng)
        snap = eng.debug_snapshot()
        assert snap["kv_layout"] == "latent"
        assert snap["kv"] == ("int8" if kv_int8 else "float32")
        assert set(eng._kv_store.arena) == {"c", "kr"} | (
            {"c_scale", "kr_scale"} if kv_int8 else set())
        # per layer and position: r + dr latents (int8 adds two f32 scales)
        per_pos = (64 + 16) + 8 if kv_int8 else (64 + 16) * 4
        assert snap["prefix_cache"]["page_bytes"] == 2 * T * per_pos
    finally:
        eng.stop()
    assert got == ref
    assert all(len(t) == 12 for t in got)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["mla", "mla_int8"])
def test_http_front_serves_tiny_mla(kv_int8):
    args = serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny-mla", "--tokenizer", "bytes",
         "--slots", "2", "--cache-len", "64", "--max-new-tokens", "4"]
        + (["--kv-int8"] if kv_int8 else []))
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
        assert 1 <= len(out["tokens"]) <= 4 and isinstance(out["text"], str)
        snap = engine.debug_snapshot()
        assert (snap["model"], snap["kv_layout"]) == ("tiny-mla", "latent")
        assert snap["kv"] == ("int8" if kv_int8 else "bfloat16")
        assert "w_dkv" in engine.params["layers"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
