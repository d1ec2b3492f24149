"""Disaggregated serving over HTTP: the port's ``serve_main`` fronts behind
the JAX package's fleet router (framework-free), all in this process on
the CPU, on f32 tiny weights:

- a torch replica registers with the router as ``prefill`` and another
  as ``decode`` (``ReplicaReporter(role=)``), so the router turns two-hop
  routing on: ``/generate`` through the router runs ``/kv_prefill`` on the
  prefill replica, whose page run the decode replica adopts through
  ``/kv_adopt`` (or ``/kv_adopt_chunk`` when the prefill replica streams),
  and the decode replica answers with the greedy tokens of a unified
  engine;
- the replicas' heartbeats carry their prefix publishes into the router's
  directory under the JAX package's ``prefix_key``;
- with the prefill pool gone, a unified replica that holds nothing gets
  a request over a cached prefix: the router plans a pull, the replica's
  ``/kv_fetch`` adopts the run from the decode replica's ``/kv_pull``, and
  the answer is the unified engine's tokens;
- the CLI's fleet flags resolve as the JAX config does (flag, then the
  environment, then the default).
"""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu.fleet.prefix_directory import (PrefixDirectory,
                                                           prefix_key)
from k8s_runpod_kubelet_tpu.fleet.registry import ReplicaRegistry
from k8s_runpod_kubelet_tpu.fleet.router import (FleetRouter, RouterConfig,
                                                 serve_router)
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu_torch.fleet.registry import (DECODE, PREFILL,
                                                         UNIFIED,
                                                         ReplicaReporter)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
T = 8
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(3)))


def _engine(tree, **kw) -> ServingEngine:
    cfg = config_from_jax(JCFG, torch.float32)
    sc = dict(slots=2, max_prefill_len=32, cache_len=128, max_new_tokens=6,
              kv_page_tokens=T)
    sc.update(kw)
    return ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                         ServingConfig(**sc), device="cpu").start()


def _wait(cond, what: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _unified(engine, prompt) -> list:
    engine.submit(prompt, max_new_tokens=1).result(timeout=TIMEOUT)
    return engine.submit(prompt, max_new_tokens=6).result(
        timeout=TIMEOUT)["tokens"]


def _prompt(seed: int, n: int = 37) -> list:
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 128, n)]


@pytest.mark.parametrize("chunk", [0, T], ids=["monolithic", "streamed"])
def test_the_jax_router_routes_two_hops_and_pulls_through_torch_replicas(
        tree, chunk):
    pre, dec, cold = _engine(tree, serving_chunk_tokens=chunk), \
        _engine(tree), _engine(tree)
    uni = _engine(tree, serving_chunk_tokens=chunk)
    uni_cold = _engine(tree)
    fronts = [serve_main.serve(e, 0, host="127.0.0.1")
              for e in (pre, dec, cold)]
    urls = [f"http://127.0.0.1:{f.server_address[1]}" for f in fronts]
    directory = PrefixDirectory()
    reg = ReplicaRegistry(metrics=jmetrics.Metrics(), heartbeat_timeout_s=60,
                          directory=directory)
    router = FleetRouter(reg, RouterConfig(request_timeout_s=60,
                                           kv_page_tokens=T),
                         metrics=jmetrics.Metrics(), directory=directory)
    rhttpd = serve_router(router, port=0)
    rport = rhttpd.server_address[1]
    reporters = [ReplicaReporter(e, f"http://127.0.0.1:{rport}", rid, url,
                                 interval_s=0.1, role=role)
                 for e, rid, url, role in ((pre, "p1", urls[0], PREFILL),
                                           (dec, "d1", urls[1], DECODE))]
    for r, e in zip(reporters, (pre, dec)):
        e.prefix_publish_hook = r.wake
        r.start()
    cold_rep = None
    try:
        _wait(lambda: router.disagg_ready(), "both pools ready")
        assert (reg.get("p1").role, reg.get("d1").role) == (PREFILL, DECODE)
        prompt = _prompt(1)
        out = _post(rport, "/generate", {"tokens": prompt,
                                         "max_new_tokens": 6})
        assert out["tokens"] == _unified(uni, prompt)
        n = len(prompt) // T
        assert pre.handoffs_total == 1
        assert dec.metrics.get_counter("tpu_serving_kv_handoff_pages") == n
        assert dec.metrics.get_counter(
            "tpu_serving_kv_handoff_stream_frames") == (
                pre.metrics.get_counter(
                    "tpu_serving_kv_handoff_stream_frames"))
        # both replicas published the run under the JAX key
        key = prefix_key(prompt[:n * T], T)
        _wait(lambda: set((directory.lookup([key]) or ("", {}))[1]
                          .get("holders", [])) == {"p1", "d1"},
              "the publishes in the router's directory")
        # the prefill pool leaves; a cold unified replica joins and gets a
        # longer prompt over the cached run: the router plans a pull
        reporters[0].stop()
        reg.deregister("p1")
        cold_rep = ReplicaReporter(cold, f"http://127.0.0.1:{rport}", "u1",
                                   urls[2], interval_s=0.1, role=UNIFIED)
        cold_rep.start()
        _wait(lambda: reg.get("u1") is not None
              and not router.disagg_ready(), "the single-hop fleet")
        longer = prompt + [7, 8, 9]
        chunks0 = cold.counters["paged_prefill_chunks"]
        out = _post(rport, "/generate", {"tokens": longer,
                                         "max_new_tokens": 6})
        if out.get("tokens") != _unified(uni_cold, longer):
            pytest.fail(f"pulled answer {out} differs from the unified one")
        assert cold.metrics.get_counter("tpu_serving_kv_pull_runs") + \
            dec.metrics.get_counter("tpu_serving_kv_pull_runs") == 2
        assert cold.metrics.get_counter("tpu_serving_kv_handoff_pages") == n
        assert cold.counters["paged_prefill_chunks"] - chunks0 == 1
    finally:
        for r in reporters + ([cold_rep] if cold_rep else []):
            r.stop()
        rhttpd.shutdown()
        rhttpd.server_close()
        for f in fronts:
            f.shutdown()
            f.server_close()
        for e in (pre, dec, cold, uni, uni_cold):
            e.stop()


def test_kv_fetch_answers_gone_for_an_evicted_run_and_refuses_other_models(
        tree):
    owner, cold = _engine(tree), _engine(tree)
    fronts = [serve_main.serve(e, 0, host="127.0.0.1") for e in (owner, cold)]
    ports = [f.server_address[1] for f in fronts]
    url = f"http://127.0.0.1:{ports[0]}"
    try:
        prompt = _prompt(4)
        out = _post(ports[1], "/kv_fetch", {"tokens": prompt,
                                            "owner_url": url})
        assert out["ok"] is False and out["gone"] is True
        owner.submit(prompt).result(timeout=TIMEOUT)
        out = _post(ports[1], "/kv_fetch", {"tokens": prompt,
                                            "owner_url": url,
                                            "model": "other"})
        assert out["ok"] is False and "gone" not in out
        out = _post(ports[1], "/kv_fetch", {"tokens": prompt,
                                            "owner_url": url,
                                            "model": cold.cfg.name})
        assert (out["ok"], out["path"], out["pages"]) == \
            (True, "wire", len(prompt) // T)
        assert cold.metrics.get_counter("tpu_serving_kv_pull_failures") == 0
    finally:
        for f in fronts:
            f.shutdown()
            f.server_close()
        owner.stop()
        cold.stop()


FLAGS = {
    "defaults": ([], {}, {"serving_role": "unified",
                          "handoff_stream_window": 8,
                          "fleet_device_transfer_enabled": True,
                          "fleet_pull_timeout_s": 10.0}),
    "flags": (["--serving-role", "decode", "--handoff-stream-window", "3",
               "--device-transfer", "off", "--pull-timeout", "2.5"],
              {"TPU_SERVING_ROLE": "prefill"},
              {"serving_role": "decode", "handoff_stream_window": 3,
               "fleet_device_transfer_enabled": False,
               "fleet_pull_timeout_s": 2.5, "fleet_placement_domain": ""}),
    "environment": ([], {"TPU_SERVING_ROLE": "prefill",
                         "TPU_HANDOFF_STREAM_WINDOW": "4",
                         "TPU_FLEET_DEVICE_TRANSFER_ENABLED": "false",
                         "TPU_FLEET_PULL_TIMEOUT_S": "3"},
                    {"serving_role": "prefill", "handoff_stream_window": 4,
                     "fleet_device_transfer_enabled": False,
                     "fleet_pull_timeout_s": 3.0}),
    "domain": (["--placement-domain", "card:0"], {},
               {"fleet_placement_domain": "card:0"}),
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_fleet_flags_resolve_as_the_jax_config(case):
    argv, env, want = FLAGS[case]
    args = serve_main.parse_args(["--device", "cpu", "--model", "tiny"]
                                 + argv)
    assert args.device == "cpu"
    got = serve_main.resolve_settings(args, env=env)
    assert {k: got[k] for k in want} == want
    if case == "defaults":
        assert got["fleet_placement_domain"].startswith("proc:")
    assert serve_main.parse_args([]).device == "cuda"
