"""The serving replica's settings and HTTP front against the JAX package's:

- every serving knob of the JAX ``config.py`` (the paged-KV knobs, the
  chunk and handoff-window sizes, the flight recorder and profile capture)
  and ``TPU_FLEET_PREFIX_DIRECTORY_ENABLED``, given by a YAML file, by the
  environment over it and by a flag over both, resolve in
  ``serve_main.resolve_settings`` as the JAX ``config.load`` plus the JAX
  CLI's flag-over-config rule resolve them, and reach the engine's
  ``ServingConfig``; the port's ``config.load`` equals the JAX one on the
  same file and environment, and refuses an unknown YAML key as it does;
- the cost meter (``serving_cost_meter``, on by default as in JAX)
  resolves from every source and reaches ``ServingConfig.cost_meter``;
- the knob the port does not serve (a profiler port) is refused by name
  from the flag, the environment and the file;
- the fleet reporter wakes on prefix publishes only with the prefix
  directory on;
- ``ServingConfig(temperature=T)``: a request that names no temperature
  samples at T on both engines, its first-token draws held to
  softmax(logits / T);
- the HTTP front's connection bound: past ``max_connections`` a connection
  gets a 503 with ``Retry-After: 1``, counted by
  ``tpu_serving_http_rejected`` (zero-seeded at startup), while a
  ``GET /metrics`` is still answered from the reserved pool.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu import config as jconfig
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch import config as pconfig
from k8s_runpod_kubelet_tpu_torch.fleet import registry
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import LlamaModel
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
BASE = ["--device", "cpu", "--model", "tiny", "--slots", "2", "--cache-len",
        "64", "--max-new-tokens", "4"]

# field -> (environment variable, its value, the YAML value, the flag
# argv or None, the ServingConfig field and how it reads the field)
KNOBS = {
    "kv_page_tokens": ("TPU_KV_PAGE_TOKENS", "32", 8,
                       ["--kv-page-tokens", "4"], "kv_page_tokens", None),
    "kv_pool_pages": ("TPU_KV_POOL_PAGES", "300", 400,
                      ["--kv-pool-pages", "500"], "kv_pool_pages", None),
    "prefix_cache_enabled": ("TPU_PREFIX_CACHE_ENABLED", "false", True,
                             ["--prefix-cache", "on"],
                             "prefix_cache_enabled", None),
    "kv_paged_decode": ("TPU_KV_PAGED_DECODE", "false", True,
                        ["--paged-decode", "auto"], "paged_decode",
                        lambda v: None if v else False),
    "kv_paged_prefill": ("TPU_KV_PAGED_PREFILL", "false", True,
                         ["--paged-prefill", "auto"], "paged_prefill",
                         lambda v: None if v else False),
    "kv_arena_sharding": ("TPU_KV_ARENA_SHARDING", "replicate", "auto",
                          ["--kv-arena-sharding", "auto"],
                          "kv_arena_sharding", None),
    "serving_chunk_tokens": ("TPU_SERVING_CHUNK_TOKENS", "8", 16,
                             ["--serving-chunk-tokens", "4"],
                             "serving_chunk_tokens", None),
    "handoff_stream_window": ("TPU_HANDOFF_STREAM_WINDOW", "3", 5,
                              ["--handoff-stream-window", "2"], None, None),
    "serving_flight_recorder": ("TPU_SERVING_FLIGHT_RECORDER", "false", True,
                                ["--flight-recorder", "on"],
                                "flight_recorder", None),
    "serving_profile_capture": ("TPU_SERVING_PROFILE_CAPTURE", "true", False,
                                ["--profile-capture", "off"], None, None),
    "serving_cost_meter": ("TPU_SERVING_COST_METER", "false", True,
                           ["--cost-meter", "on"], "cost_meter", None),
    "fleet_prefix_directory_enabled": (
        "TPU_FLEET_PREFIX_DIRECTORY_ENABLED", "false", True, None, None,
        None),
}
SOURCES = ("default", "yaml", "env", "flag")


def _yaml(tmp_path, values: dict) -> str:
    import yaml

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(values))
    return str(path)


def _jax_resolved(field: str, args, path, env) -> object:
    """The JAX replica's value: ``config.load`` (flags > env > file >
    default for what it holds) under the CLI's rule, the flag when given,
    else the loaded config's field (JAX ``serve_main.main``)."""
    base = jconfig.load(path, env=env)
    flag = getattr(args, field, None)
    if flag is None:
        return getattr(base, field)
    true_by = serve_main.KNOBS[field]
    return flag if true_by is None else flag == true_by


@pytest.mark.parametrize("field,source", [
    (field, source) for field in sorted(KNOBS) for source in SOURCES
    if source != "flag" or KNOBS[field][3] is not None])
def test_knobs_resolve_as_the_jax_replica(tmp_path, monkeypatch, field,
                                          source):
    var, env_value, yaml_value, flag, sc_field, read = KNOBS[field]
    path = (_yaml(tmp_path, {field: yaml_value})
            if source in ("yaml", "env", "flag") else None)
    env = {var: env_value} if source in ("env", "flag") else {}
    argv = BASE + (["--config", path] if path else []) + (
        flag if source == "flag" else [])
    args = serve_main.parse_args(argv)
    got = serve_main.resolve_settings(args, env=env)
    want = _jax_resolved(field, args, path, env)
    assert got[field] == want
    assert pconfig.load(path, env=env) == pconfig.Config(
        **dataclasses.asdict(jconfig.load(path, env=env)))
    if sc_field is None:
        return
    # the engine's ServingConfig carries it (built from the environment
    # the test sets: build_engine resolves os.environ)
    for k in list(pconfig._ENV_MAP):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    engine, _ = serve_main.build_engine(args)
    try:
        value = getattr(engine.sc, sc_field)
        assert value == (read(want) if read else want)
    finally:
        engine.stop()


def test_an_unknown_yaml_key_is_refused_as_in_jax(tmp_path):
    path = _yaml(tmp_path, {"kv_page_tokens": 8, "kv_page_tokenz": 4})
    with pytest.raises(ValueError, match="unknown config keys") as jerr:
        jconfig.load(path, env={})
    with pytest.raises(ValueError, match="unknown config keys") as perr:
        pconfig.load(path, env={})
    assert str(perr.value) == str(jerr.value)
    args = serve_main.parse_args(BASE + ["--config", path])
    with pytest.raises(ValueError, match="kv_page_tokenz"):
        serve_main.resolve_settings(args, env={})
    # an invalid value too, by the same message
    path = _yaml(tmp_path, {"kv_page_tokens": 0})
    with pytest.raises(ValueError, match="kv_page_tokens must be >= 1"):
        serve_main.resolve_settings(
            serve_main.parse_args(BASE + ["--config", path]), env={})


@pytest.mark.parametrize("source", ["flag", "env", "yaml"])
@pytest.mark.parametrize("knob", ["serving_profiler_port"])
def test_unserved_knobs_are_refused_from_every_source(tmp_path, knob,
                                                      source):
    flag, var, value, yaml_value = {
        "serving_profiler_port": (["--profiler-port", "9999"],
                                  "TPU_SERVING_PROFILER_PORT", "9999", 9999),
    }[knob]
    argv, env = list(BASE), {}
    if source == "flag":
        argv += flag
    elif source == "env":
        env = {var: value}
    else:
        argv += ["--config", _yaml(tmp_path, {knob: yaml_value})]
    with pytest.raises(ValueError, match=knob):
        serve_main.resolve_settings(serve_main.parse_args(argv), env=env)
    # the JAX default (no profiler port) is no request, and 0 is served
    got = serve_main.resolve_settings(
        serve_main.parse_args(BASE + ["--profiler-port", "0"]), env={})
    assert not got[knob]
    serve_main.resolve_settings(serve_main.parse_args(BASE), env={})


class _Reporter:
    def __init__(self, engine, router, **kw):
        self.replica_id = kw["replica_id"]

    def start(self):
        return self

    def wake(self):
        pass


@pytest.mark.parametrize("on", [True, False], ids=["directory", "no_dir"])
def test_publish_hook_follows_the_prefix_directory(monkeypatch, on):
    monkeypatch.setattr(registry, "ReplicaReporter", _Reporter)
    args = serve_main.parse_args(BASE + ["--fleet-router",
                                         "http://127.0.0.1:9"])
    env = {} if on else {"TPU_FLEET_PREFIX_DIRECTORY_ENABLED": "false"}
    knobs = serve_main.resolve_settings(args, env=env)
    engine = type("Engine", (), {"prefix_publish_hook": None})()
    reporter = serve_main.start_reporter(engine, args, 8000, knobs)
    assert isinstance(reporter, _Reporter)
    if on:
        assert engine.prefix_publish_hook == reporter.wake
    else:
        assert engine.prefix_publish_hook is None


def test_engine_temperature_samples_requests_that_name_none():
    """A request without a temperature on an engine built with
    ``temperature=T`` samples at T: each engine's first-token draws
    (one prefill fanned out to n seeds) follow softmax(logits / T) over
    the top tokens and the rest, within 4 binomial sigmas, and an engine
    at the default stays greedy."""
    jcfg = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, mlp_dim=128,
                             max_seq_len=128, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(7))
    cfg = config_from_jax(jcfg, torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, 128, 12)]
    sc = dict(slots=4, max_prefill_len=16, cache_len=64, max_new_tokens=1,
              kv_page_tokens=8)
    model_logits = LlamaModel(cfg, "cpu").forward(
        params, torch.tensor([prompt]), train=False)[0, -1].double()
    # a temperature that leaves about half the mass on the argmax
    temp = 1.0
    for _ in range(60):
        p = torch.softmax(model_logits / temp, -1)
        if p.max() < 0.5:
            break
        temp *= 1.25
    assert ServingConfig(temperature=temp).temperature == temp
    n = 240
    draws = {}
    for name, make in (
            ("jax", lambda t: JaxServingEngine(
                jcfg, jparams, JaxServingConfig(**sc, temperature=t))),
            ("port", lambda t: ServingEngine(
                cfg, params, ServingConfig(**sc, temperature=t),
                device="cpu"))):
        for t in (temp, 0.0):
            eng = make(t).start()
            try:
                futs = eng.submit_group(prompt, n, seed=11)
                draws[name, t] = [f.result(timeout=TIMEOUT)["tokens"][0]
                                  for f in futs]
            finally:
                eng.stop()
    top = torch.argsort(p, descending=True)[:3].tolist()
    want = [float(p[i]) for i in top]
    want.append(1.0 - sum(want))
    for name in ("jax", "port"):
        got = np.asarray(draws[name, temp])
        freq = [float(np.mean(got == i)) for i in top]
        freq.append(1.0 - sum(freq))
        for f, q in zip(freq, want):
            assert abs(f - q) <= 4 * np.sqrt(q * (1 - q) / n) + 1e-9, (
                name, freq, want)
        assert len(set(got.tolist())) > 1
        assert set(draws[name, 0.0]) == {top[0]}


def _http(port: int, request: bytes, wait: float = 5.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=wait) as s:
        s.sendall(request)
        out = b""
        while True:
            data = s.recv(65536)
            if not data:
                return out
            out += data


def _until(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_connections_past_the_bound_get_503_and_metrics_still_answer():
    engine, _ = serve_main.build_engine(serve_main.parse_args(BASE))
    httpd = serve_main.serve(engine, 0, host="127.0.0.1", max_connections=1)
    port = httpd.server_address[1]
    held = None
    try:
        scrape = (b"GET /metrics HTTP/1.1\r\nHost: x\r\n"
                  b"Connection: close\r\n\r\n")
        first = _http(port, scrape)
        assert b" 200 " in first.split(b"\r\n")[0]
        assert b"\ntpu_serving_http_rejected_total 0.0" in first
        assert b"# HELP tpu_serving_http_rejected_total" in first
        # one idle connection fills the pool of 1: wait until the server
        # has let the scrape's slot go and holds this one's (under load
        # either can lag the client's view)
        _until(lambda: httpd._conn_sem._value == 1,
               "the scrape's slot released")
        held = socket.create_connection(("127.0.0.1", port), timeout=5)
        _until(lambda: httpd._conn_sem._value == 0,
               "the idle connection's slot taken")
        out = _http(port, b"GET /debug/engine HTTP/1.1\r\nHost: x\r\n\r\n")
        head = out.split(b"\r\n\r\n")[0]
        assert head.startswith(b"HTTP/1.1 503")
        assert b"Retry-After: 1" in head
        assert engine.metrics.get_counter("tpu_serving_http_rejected") == 1
        # the scrape rides the reserved pool while the main one is full
        out = _http(port, scrape)
        assert b" 200 " in out.split(b"\r\n")[0]
        assert b"\ntpu_serving_http_rejected_total 1.0" in out
        assert engine.metrics.get_counter("tpu_serving_http_rejected") == 1
    finally:
        if held is not None:
            held.close()
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
