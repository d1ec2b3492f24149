"""The port's observability routes beside the JAX package's server, both
over an engine on the same f32 tiny weights with ``ByteTokenizer``:

- ``GET /metrics``: 200, ``text/plain; version=0.0.4``, the engine's
  ``render()``;
- a caller ``traceparent`` on /generate (plain and streamed), the OpenAI
  completion routes and /prefix comes back with the caller's trace id and
  a fresh root span id; ``/debug/traces?trace_id=`` then holds the
  request's four spans under the caller's span (and the JAX server's hold
  the same names); without the header a fresh trace id is minted;
- ``/debug/traces`` without a trace id answers the newest spans;
- ``/debug/profile``: 403 without ``profile_capture``, 400 on a bad or
  out-of-range ``seconds``, each the JAX server's code for the same
  request; on the port 200 with a directory holding a Chrome trace, and
  409 at once while another capture runs.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads import serve_main as jserve
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu.workloads.tokenizer import \
    ByteTokenizer as JaxByteTokenizer
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.tracing import (format_traceparent,
                                                  parse_traceparent)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import ByteTokenizer

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=260, embed_dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                         dtype=jnp.float32, param_dtype=jnp.float32)
SC = dict(slots=4, max_prefill_len=32, cache_len=96, max_new_tokens=6,
          kv_page_tokens=8, eos_token=256)
CALLER = ("4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7")
SPANS = ["serving.request", "serving.queue_wait", "serving.prefill",
         "serving.decode"]


@pytest.fixture(scope="module")
def servers():
    """Per engine two fronts: profile capture off and on."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(7)))
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**SC),
                            decode_fn=JaxByteTokenizer().decode).start()
    cfg = config_from_jax(JCFG, torch.float32)
    tok = ByteTokenizer()
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**SC), device="cpu",
                        decode_fn=tok.decode).start()
    fronts = {
        ("port", False): serve_main.serve(eng, 0, tokenizer=tok,
                                          host="127.0.0.1"),
        ("port", True): serve_main.serve(eng, 0, tokenizer=tok,
                                         host="127.0.0.1",
                                         profile_capture=True),
        ("jax", False): jserve.serve(jeng, 0, tokenizer=JaxByteTokenizer()),
        ("jax", True): jserve.serve(jeng, 0, tokenizer=JaxByteTokenizer(),
                                    profile_capture=True),
    }
    yield {k: h.server_address[1] for k, h in fronts.items()}, eng
    for h in fronts.values():
        h.shutdown()
        h.server_close()
    eng.stop()
    jeng.stop()


def _http(port: int, path: str, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_metrics_route(servers, side):
    ports, eng = servers
    status, headers, body = _http(ports[side, False], "/metrics")
    assert status == 200
    assert headers["Content-Type"] == "text/plain; version=0.0.4"
    text = body.decode()
    # the series the HPA and the router read exist from pod start
    assert "# TYPE tpu_serving_admitted_total counter" in text
    assert "# TYPE tpu_serving_queue_depth gauge" in text
    if side == "port":   # the engine is idle: the same families
        types = {x for x in text.splitlines() if x.startswith("# TYPE")}
        assert types == {x for x in eng.metrics.render().splitlines()
                         if x.startswith("# TYPE")}


ROUTES = {
    "generate": ("/generate", {"text": "hi there", "max_new_tokens": 4}),
    "generate_stream": ("/generate", {"text": "hey", "max_new_tokens": 4,
                                      "stream": True}),
    "completions": ("/v1/completions", {"prompt": "hello", "max_tokens": 4,
                                        "temperature": 0}),
    "chat_stream": ("/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "yo"}],
                     "max_tokens": 3, "temperature": 0, "stream": True}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_traceparent_round_trip_and_debug_traces(servers, route):
    ports, _ = servers
    path, body = ROUTES[route]
    caller = format_traceparent(*CALLER)
    names = {}
    for side in ("port", "jax"):
        status, headers, _ = _http(ports[side, False], path, body,
                                   {"traceparent": caller})
        assert status == 200
        trace_id, root = parse_traceparent(headers["traceparent"])
        assert trace_id == CALLER[0] and root != CALLER[1]
        _, _, raw = _http(ports[side, False],
                          f"/debug/traces?trace_id={trace_id}")
        spans = json.loads(raw)["spans"]
        mine = [s for s in spans if s["span_id"] == root
                or s["parent_id"] == root]
        names[side] = sorted(s["name"] for s in mine)
        top = [s for s in mine if s["span_id"] == root]
        assert len(top) == 1 and top[0]["parent_id"] == CALLER[1]
    assert names["port"] == names["jax"] == sorted(SPANS)


def test_without_a_header_a_trace_is_minted(servers):
    ports, _ = servers
    status, headers, _ = _http(ports["port", False], "/generate",
                               {"tokens": [104, 105], "max_new_tokens": 2})
    assert status == 200
    trace_id, root = parse_traceparent(headers["traceparent"])
    assert trace_id != CALLER[0]
    _, _, raw = _http(ports["port", False],
                      f"/debug/traces?trace_id={trace_id}")
    out = json.loads(raw)
    assert out["trace_id"] == trace_id
    assert sorted(s["name"] for s in out["spans"]) == sorted(SPANS)
    status, headers, _ = _http(ports["port", False], "/prefix",
                               {"tokens": [1, 2, 3, 4, 5, 6, 7, 8, 9]},
                               {"traceparent": format_traceparent(*CALLER)})
    assert status == 200
    assert parse_traceparent(headers["traceparent"])[0] == CALLER[0]
    status, _, raw = _http(ports["port", False], "/debug/traces")
    recent = json.loads(raw)
    assert status == 200 and recent["trace_id"] is None
    assert any(s["trace_id"] == trace_id for s in recent["spans"])


@pytest.mark.parametrize("query,capture", [("?seconds=1", False),
                                           ("?seconds=abc", True),
                                           ("?seconds=0", True),
                                           ("?seconds=31", True),
                                           ("?seconds=-2", True)])
def test_debug_profile_codes_match_the_jax_server(servers, query, capture):
    ports, _ = servers
    got = _http(ports["port", capture], "/debug/profile" + query)
    want = _http(ports["jax", capture], "/debug/profile" + query)
    assert got[0] == want[0] == (403 if not capture else 400)
    assert "error" in json.loads(got[2])


def test_debug_profile_writes_a_chrome_trace(servers):
    ports, _ = servers
    status, _, raw = _http(ports["port", True], "/debug/profile?seconds=0.05")
    assert status == 200
    out = json.loads(raw)
    try:
        assert out["seconds"] == 0.05
        assert os.path.basename(out["profile_dir"]).startswith(
            "tpu-serving-profile-")
        with open(os.path.join(out["profile_dir"], "trace.json")) as f:
            assert "traceEvents" in json.load(f)
    finally:
        shutil.rmtree(out["profile_dir"], ignore_errors=True)


def test_debug_profile_refuses_a_second_capture(servers):
    ports, _ = servers
    assert serve_main._PROFILE_LOCK.acquire(timeout=TIMEOUT)
    try:   # a capture in flight holds the lock
        status, _, raw = _http(ports["port", True],
                               "/debug/profile?seconds=0.05")
    finally:
        serve_main._PROFILE_LOCK.release()
    assert status == 409 and "already running" in json.loads(raw)["error"]


def test_profiler_starts_and_stops_holding_the_engine_lock(servers,
                                                           monkeypatch):
    """The engine steps under ``_prefix_lock``; a profiler stop beside a
    graph replay on another thread deadlocked both on the card, so the
    start and the stop hold the lock and the window does not."""
    import torch.profiler

    _, eng = servers
    seen = []

    class Recording:
        def __init__(self, activities):
            pass

        def start(self):
            seen.append(("start", eng._prefix_lock.locked()))

        def stop(self):
            seen.append(("stop", eng._prefix_lock.locked()))

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write("{}")

    monkeypatch.setattr(torch.profiler, "profile", Recording)
    out = serve_main.capture_profile(
        eng, 0.01, sleep=lambda s: seen.append(
            ("window", eng._prefix_lock.locked())))
    shutil.rmtree(out, ignore_errors=True)
    assert seen == [("start", True), ("window", False), ("stop", True)]
