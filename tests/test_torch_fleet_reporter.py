"""The port's ``ReplicaReporter`` against the JAX package's real fleet
router: the router (``FleetRouter``, ``ReplicaRegistry`` with a
``MetricsAggregator``, ``serve_router``) on localhost, and as its replica
the port's HTTP front over a tiny f32 engine on the CPU. Held:

- the torch replica registers (unified role, its pod name) and beats;
  ``ReplicaStats.from_dict`` reads its stats, and the aggregator ingests
  its metric snapshots into the fleet's ``/metrics/fleet`` series;
- ``/generate`` through the router returns the tokens a direct call does;
- a replica the router forgot re-registers at its next beat;
- a drained replica deregisters, and its reporter stops;
- ``stats()`` carries the JAX reporter's key set on a JAX engine.
"""

import json
import time
import urllib.request

import numpy as np

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu.fleet.registry import ReplicaRegistry, ReplicaStats
from k8s_runpod_kubelet_tpu.fleet.registry import \
    ReplicaReporter as JaxReplicaReporter
from k8s_runpod_kubelet_tpu.fleet.router import (FleetRouter, RouterConfig,
                                                 serve_router)
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.fleet.registry import (UNIFIED,
                                                         ReplicaReporter)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
SC = dict(slots=2, max_prefill_len=16, cache_len=64, max_new_tokens=6,
          kv_page_tokens=8)


def _wait(cond, what: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_the_jax_router_registers_routes_to_and_drops_a_torch_replica():
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(3)))
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**SC), device="cpu").start()
    front = serve_main.serve(eng, 0, host="127.0.0.1")
    agg = jmetrics.MetricsAggregator()
    reg = ReplicaRegistry(metrics=jmetrics.Metrics(), heartbeat_timeout_s=60,
                          aggregator=agg)
    router = FleetRouter(reg, RouterConfig(request_timeout_s=60),
                         metrics=jmetrics.Metrics())
    rhttpd = serve_router(router, port=0)
    rport = rhttpd.server_address[1]
    base = f"http://127.0.0.1:{front.server_address[1]}"
    reporter = ReplicaReporter(eng, f"http://127.0.0.1:{rport}", "torch-1",
                               base, pod_name="pod-a", interval_s=0.1,
                               generation="h100", pool="p1").start()
    try:
        _wait(lambda: reg.get("torch-1") is not None
              and reg.get("torch-1").stats.max_slots == SC["slots"],
              "registration and a first beat")
        rep = reg.get("torch-1")
        assert (rep.role, rep.pod_name, rep.base_url, rep.generation,
                rep.pool) == (UNIFIED, "pod-a", base, "h100", "p1")
        stats = ReplicaStats.from_dict(reporter.stats())
        assert stats.free_slots == SC["slots"] and not stats.draining
        assert stats.kv_pages_total == eng.prefix_cache_stats()["pages_total"]

        prompt = [5, 9, 2, 7, 7, 1, 3]
        direct = eng.submit(prompt, max_new_tokens=4).result(60)["tokens"]
        routed = _post(rport, "/generate",
                       {"tokens": prompt, "max_new_tokens": 4})
        assert routed["tokens"] == direct
        _wait(lambda: reg.get("torch-1").stats.requests_total >= 2,
              "a beat after both requests")
        assert agg.stats()["replicas"]["torch-1"] >= 1
        fleet = agg.render()
        assert "tpu_serving_admitted_total 2.0" in fleet
        assert "# TYPE tpu_serving_ttft_seconds histogram" in fleet

        reg.deregister("torch-1")        # the router forgets the replica
        _wait(lambda: reg.get("torch-1") is not None, "a re-registration")

        eng.drain()
        _wait(lambda: reg.get("torch-1") is None, "the deregistration")
        reporter._thread.join(timeout=5)
        assert not reporter._thread.is_alive()
        time.sleep(0.3)
        assert reg.get("torch-1") is None
    finally:
        reporter.stop()
        rhttpd.shutdown()
        rhttpd.server_close()
        front.shutdown()
        front.server_close()
        eng.stop()


def test_stats_keys_match_the_jax_reporter_on_a_jax_engine():
    tree = jax_init_params(JCFG, jax.random.PRNGKey(3))
    jeng = JaxServingEngine(JCFG, tree, JaxServingConfig(**SC))
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu"),
        ServingConfig(**SC), device="cpu")
    posts = []
    port_rep = ReplicaReporter(eng, "http://router", "r", "http://r",
                               post_fn=lambda path, body: posts.append(
                                   (path, body)) or {"registered": False})
    jax_rep = JaxReplicaReporter(jeng, "http://router", "r", "http://r")
    assert set(port_rep.stats()) == set(jax_rep.stats())
    assert port_rep.stats() == {**jax_rep.stats(),
                                "kv_pages_total": port_rep.stats()[
                                    "kv_pages_total"]}
    assert port_rep.beat_once()
    # registered: false answers with a registration
    assert [p for p, _ in posts] == ["/fleet/heartbeat", "/fleet/register"]
    beat = posts[0][1]
    assert beat["metrics"]["schema_version"] == 1
    assert beat["stats"]["requests_total"] == 0
    assert "prefixes" not in beat
    # the cost ledger rides every beat, in the JAX meter's wire shape
    assert beat["costs"]["schema_version"] == 1
    assert set(beat["costs"]) == set(jeng.costmeter.snapshot())
