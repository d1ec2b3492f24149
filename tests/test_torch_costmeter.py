"""The port's cost accounting against the JAX package's, on the CPU.

- ``CostMeter`` (``workloads/serving/costmeter.py``, the port's copy)
  against the JAX one on the same fake request timings and clock: the
  same attribution per request (chip-seconds a phase, KV page-seconds,
  dollars, tenant), the same ledger snapshot (the overflow tenant past
  ``MAX_TENANTS`` included) and the same ``tpu_serving_*`` series and
  HELP lines; the phases telescope to wall x chips; prices come from the
  port's ``generations.py``, whose ``h100`` row has its list price;
- a port engine's ``GET /debug/costs`` with the meter on (the default)
  against the JAX engine's on the same prompts over HTTP: tenants from
  ``X-Tenant``, else the OpenAI ``user`` field, cut to 64 characters; the
  same requests, tokens and prompt tokens a tenant; each tenant's
  chip-seconds the sum of its requests' walls (the ``serving.request``
  spans' latency) x 1 card, the dollars chip-seconds x the price / 3600,
  the spans carrying the same figures; a ``--cost-meter off`` front
  answers 404;
- the JAX fleet router's ``/debug/costs`` folds the torch replica's
  heartbeat ``costs``.

Tolerances: chip-seconds and dollars are the ledger's rounding (6 and 9
decimals); the span sums add a request's rounded phases (1e-6 each).
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu.fleet.registry import (FleetCostLedger,
                                                   ReplicaRegistry)
from k8s_runpod_kubelet_tpu.fleet.router import (FleetRouter, RouterConfig,
                                                 serve_router)
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads import serve_main as jserve
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu.workloads.serving import costmeter as jcost
from k8s_runpod_kubelet_tpu_torch import generations as pgen
from k8s_runpod_kubelet_tpu_torch.fleet.registry import ReplicaReporter
from k8s_runpod_kubelet_tpu_torch.metrics import Metrics
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import \
    costmeter as pcost

JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
SC = dict(slots=2, max_prefill_len=32, cache_len=96, max_new_tokens=5,
          kv_page_tokens=8)
TIMEOUT = 60


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _requests(n: int):
    """Fake requests with seeded stamps: some never dequeued or prefilled
    (a failed prefill leaves 0), tenants among a few names and none."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        sub = 100.0 + float(rng.uniform(0, 5))
        deq = sub + float(rng.uniform(0, 0.2)) if i % 7 else 0.0
        pre = (deq or sub) + float(rng.uniform(0, 0.5)) if i % 5 else 0.0
        end = max(sub, deq, pre) + float(rng.uniform(0, 2))
        out.append((types.SimpleNamespace(
            submitted_at=sub, dequeued_at=deq, prefill_done_at=pre,
            prompt=list(range(int(rng.integers(1, 60)))),
            tenant=["", "acme", "bob", "x" * 64][i % 4], trace_id=""),
            end, int(rng.integers(1, 30)), int(rng.integers(0, 9))))
    return out


def _series(text: str) -> list:
    return sorted(line for line in text.splitlines()
                  if "cost" in line or "chip_seconds" in line
                  or "kv_page_seconds" in line or "metered" in line)


@pytest.mark.parametrize("accelerator", ["v5litepod-8", "v6e-4", ""])
@pytest.mark.parametrize("chips", [1, 4])
def test_cost_meter_matches_jax_on_the_same_timings(accelerator, chips):
    pc, jc = _Clock(), _Clock()
    pm, jm = Metrics(), jmetrics.Metrics()
    port = pcost.CostMeter(pm, model="tiny", accelerator=accelerator,
                           chips=chips, pool="p", clock=pc)
    jaxm = jcost.CostMeter(jm, model="tiny", accelerator=accelerator,
                           chips=chips, pool="p", clock=jc)
    assert _series(pm.render()) == _series(jm.render())
    for req, end, tokens, pages in _requests(30):
        kw = dict(end_at=end, generated_tokens=tokens, pages_end=pages,
                  page_tokens=8)
        a, b = port.meter_request(req, **kw), jaxm.meter_request(req, **kw)
        assert a == b
        assert port.span_attrs(a) == jaxm.span_attrs(b)
        wall = max(end, req.submitted_at) - req.submitted_at
        assert sum(a["chip_seconds"].values()) == pytest.approx(
            wall * chips, abs=1e-9)
    pc.t = jc.t = 110.0
    assert port.snapshot() == jaxm.snapshot()
    assert _series(pm.render()) == _series(jm.render())
    assert pcost.COSTS_SCHEMA_VERSION == jcost.COSTS_SCHEMA_VERSION
    assert (pcost.MAX_TENANTS, pcost.OVERFLOW_TENANT) == (
        jcost.MAX_TENANTS, jcost.OVERFLOW_TENANT)


def test_the_overflow_tenant_and_the_h100_price():
    meter = pcost.CostMeter(Metrics(), accelerator="NVIDIA H100 80GB HBM3",
                            clock=_Clock())
    assert meter.generation == "h100"
    assert meter.price_per_chip_s * 3600 == pgen.cost_per_chip_hr("h100")
    assert pgen.GENERATIONS["h100"].cost_per_chip_hr == pytest.approx(
        88.49 / 8, abs=1e-4)
    # the meter reads the port's table, not the JAX one
    assert pcost.cost_per_chip_hr is pgen.cost_per_chip_hr
    req, end, tokens, pages = _requests(1)[0]
    for i in range(pcost.MAX_TENANTS + 3):
        req.tenant = f"t{i}"
        meter.meter_request(req, end_at=end, generated_tokens=tokens,
                            pages_end=pages, page_tokens=8)
    snap = meter.snapshot()
    assert len(snap["tenants"]) == pcost.MAX_TENANTS + 1
    assert snap["tenants"][pcost.OVERFLOW_TENANT]["requests"] == 3
    assert snap["totals"]["requests"] == pcost.MAX_TENANTS + 3


@pytest.mark.parametrize("env,device,want", [
    ("v5litepod-8", "cuda", "v5litepod-8"),
    ("", "cuda", "NVIDIA H100 80GB HBM3"),
    ("v6e-4", "cpu", "v6e-4"),
    ("", "cpu", ""),
])
def test_the_meter_prices_by_the_environment_first(env, device, want,
                                                   monkeypatch):
    """The engine's meter names its accelerator as the JAX replica does:
    ``TPU_ACCELERATOR_TYPE`` when set, else the card's name (the trainer's
    MFU peak keeps the card first: ``test_torch_train_profile.py``)."""
    import torch

    from k8s_runpod_kubelet_tpu_torch.workloads.serving import engine

    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", env)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert engine.priced_accelerator(torch.device(device)) == want


# -- the engines behind their HTTP fronts -------------------------------------------

def _post(port: int, path: str, body: dict, headers=None) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                **(headers or {})})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


LONG = "t" * 80
# (route, body, headers): X-Tenant wins over user, user alone, neither
CALLS = [
    ("/generate", {"tokens": [5, 9, 2, 7], "max_new_tokens": 4},
     {"X-Tenant": "acme"}),
    ("/generate", {"tokens": [3, 3, 1], "max_new_tokens": 3},
     {"X-Tenant": "bob"}),
    ("/v1/completions", {"prompt": [8, 1, 4, 4, 2], "max_tokens": 4,
                         "user": "carol"}, {}),
    ("/v1/completions", {"prompt": [7, 7], "max_tokens": 2, "user": "zed"},
     {"X-Tenant": "acme"}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "max_tokens": 3, "user": LONG}, {}),
    ("/generate", {"tokens": [1, 2], "max_new_tokens": 2}, {}),
]


@pytest.fixture(scope="module")
def fronts():
    from k8s_runpod_kubelet_tpu.workloads.tokenizer import \
        ByteTokenizer as JaxByteTokenizer
    from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import \
        ByteTokenizer

    tree = jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(4)))
    cfg = config_from_jax(JCFG, torch.float32)
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**SC)).start()
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**SC), device="cpu").start()
    off = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**SC, cost_meter=False),
                        device="cpu").start()
    servers = {"port": serve_main.serve(eng, 0, tokenizer=ByteTokenizer(),
                                        host="127.0.0.1"),
               "jax": jserve.serve(jeng, 0, tokenizer=JaxByteTokenizer()),
               "off": serve_main.serve(off, 0, host="127.0.0.1")}
    ports = {k: s.server_address[1] for k, s in servers.items()}
    for name in ("port", "jax"):
        for route, body, headers in CALLS:
            _post(ports[name], route, body, headers)
    yield ports, eng, jeng
    for s in servers.values():
        s.shutdown()
        s.server_close()
    for e in (eng, jeng, off):
        e.stop()


def test_debug_costs_match_the_jax_replica(fronts):
    ports, eng, _ = fronts
    got, want = (_get(ports[k], "/debug/costs") for k in ("port", "jax"))
    assert got[0] == want[0] == 200
    got, want = got[1], want[1]
    assert set(got) == set(want)
    assert set(got["tenants"]) == set(want["tenants"]) == {
        "acme", "bob", "carol", LONG[:64], jcost.NO_TENANT}
    for t in got["tenants"]:
        for key in ("requests", "tokens", "prompt_tokens"):
            assert got["tenants"][t][key] == want["tenants"][t][key], (t, key)
    assert got["tenants"]["acme"]["requests"] == 2
    assert got["totals"]["requests"] == len(CALLS)
    assert (got["model"], got["generation"], got["chips"]) == (
        eng.cfg.name, "cpu", 1)
    assert _get(ports["off"], "/debug/costs")[0] == 404


def test_chip_seconds_are_the_requests_walls_and_ride_the_spans(fronts):
    ports, eng, _ = fronts
    snap = _get(ports["port"], "/debug/costs")[1]
    price = snap["price_per_chip_hr"] / 3600
    spans = [s for s in eng.tracer.query("")["spans"]
             if s["name"] == "serving.request"]
    assert len(spans) == len(CALLS)
    by_tenant: dict = {}
    for s in spans:
        a = s["attrs"]
        phases = (a["chip_seconds_queue"] + a["chip_seconds_prefill"]
                  + a["chip_seconds_decode"])
        assert phases == pytest.approx(a["latency_s"], abs=3e-6)
        assert a["cost_dollars"] == pytest.approx(phases * price,
                                                  abs=1e-9)
        t = by_tenant.setdefault(a["tenant"], [0.0, 0.0])
        t[0] += a["latency_s"]
        t[1] += a["cost_dollars"]
    for name, bucket in snap["tenants"].items():
        chip_s = sum(bucket["chip_seconds"].values())
        assert chip_s == pytest.approx(by_tenant[name][0],
                                       abs=1e-5 * bucket["requests"])
        assert bucket["cost_dollars"] == pytest.approx(
            chip_s * price, abs=1e-8)
        assert bucket["cost_dollars"] == pytest.approx(by_tenant[name][1],
                                                       abs=1e-8)
    assert "# HELP tpu_serving_metered_requests" in eng.metrics.render()
    assert eng.metrics.get_counter("tpu_serving_metered_requests") == len(
        CALLS)


def test_the_jax_router_folds_a_torch_replicas_costs(fronts):
    ports, eng, _ = fronts
    ledger = FleetCostLedger()
    reg = ReplicaRegistry(metrics=jmetrics.Metrics(), heartbeat_timeout_s=60,
                          cost_ledger=ledger)
    router = FleetRouter(reg, RouterConfig(request_timeout_s=60),
                         metrics=jmetrics.Metrics())
    rhttpd = serve_router(router, port=0)
    rport = rhttpd.server_address[1]
    reporter = ReplicaReporter(
        eng, f"http://127.0.0.1:{rport}", "torch-1",
        f"http://127.0.0.1:{ports['port']}", interval_s=0.1).start()
    try:
        deadline = time.monotonic() + 30
        while not ledger.snapshot()["replicas"]:
            assert time.monotonic() < deadline, "no costs folded"
            time.sleep(0.05)
        code, fleet = _get(rport, "/debug/costs")
        assert code == 200
        mine = eng.costmeter.snapshot()
        assert fleet["replicas"]["torch-1"]["totals"]["requests"] == len(
            CALLS)
        for t, bucket in mine["tenants"].items():
            assert fleet["tenants"][t]["requests"] == bucket["requests"]
            assert fleet["tenants"][t]["tokens"] == bucket["tokens"]
        (group,) = fleet["groups"]
        assert (group["model"], group["replicas"]) == (eng.cfg.name, 1)
    finally:
        reporter.stop()
        rhttpd.shutdown()
        rhttpd.server_close()
