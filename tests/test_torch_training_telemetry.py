"""The port's training telemetry (``workloads/telemetry.py``, ``health.py``,
``generations.py``, the trainer's hooks) against the JAX package's, on
the CPU.

- seeded call sequences on fake clocks drive the port's and the JAX
  ``TrainingTelemetry`` (three hosts, worker 0: steps, durable and staged
  saves, restores, peers' heartbeats, straggler sweeps, the run's end)
  and a restarted attempt that reads the state file: every emitted line,
  payload, snapshot, state file, span and ``Metrics.render()`` identical;
  the ``GoodputLedger`` and ``StragglerWatchdog`` alone the same way;
- the trainers: the port's and the JAX ``Trainer(telemetry=)`` on the
  same tiny f32 tree and batches, both step clocks faked alike, print the
  same protocol lines, and those lines fed to the kubelet's
  ``provider/training_watch.py`` give a pod the same annotations and
  gauges;
- the port's and the JAX ``HealthServer`` give the same status codes and
  bodies for the same requests (``/healthz``, ``/readyz`` both ways,
  ``/metrics``, ``/debug/traces``, ``/debug/engine`` absent,
  ``/debug/train`` and its error, ``POST /heartbeat`` and its error,
  unknown paths);
- ``generations``: the SXM card's name maps to the ``h100`` row at 989
  TFLOP/s (the published SXM specification), the PCIe and NVL cards' to
  ``cpu``, and every TPU name maps as in the JAX table.
"""

import json
import re
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu import generations as jgen
from k8s_runpod_kubelet_tpu import health as jhealth
from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu import tracing as jtracing
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.provider.training_watch import TrainingWatchMixin
from k8s_runpod_kubelet_tpu.workloads import telemetry as jtel
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch import generations as pgen
from k8s_runpod_kubelet_tpu_torch import health as phealth
from k8s_runpod_kubelet_tpu_torch import metrics as pmetrics
from k8s_runpod_kubelet_tpu_torch import tracing as ptracing
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import telemetry as ptel
from k8s_runpod_kubelet_tpu_torch.workloads import train as ptrain

SIDES = {"port": (ptel, pmetrics, ptracing), "jax": (jtel, jmetrics,
                                                     jtracing)}


class FakeClock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _spans(tracer) -> list:
    return [(s["name"], s["start"], s["duration_s"], s["attrs"])
            for s in tracer.recent(10_000)]


def _drive(side: str, state_path: str, seed: int, attempt: int = 0,
           wall0: float = 5000.0) -> dict:
    """One seeded call sequence through a side's telemetry; everything it
    emitted and exposed."""
    tel_mod, metrics_mod, tracing_mod = SIDES[side]
    rng = np.random.default_rng(seed)
    mono, wall = FakeClock(100.0), FakeClock(wall0)
    lines: list = []
    metrics = metrics_mod.Metrics()
    tracer = tracing_mod.Tracer(clock=wall)
    tel = tel_mod.TrainingTelemetry(
        tokens_per_step=4096, model_params=8_030_261_248, n_chips=1,
        accelerator_type="v5p-8", num_hosts=3, host_id=0, metrics=metrics,
        tracer=tracer, clock=wall, mono=mono, straggler_factor=2.0,
        stall_timeout_s=30.0, attempt=attempt, dp_width=1,
        state_path=state_path, telemetry_every=2, state_interval_s=0.0,
        emit_line=lines.append)
    snaps = []

    def tick(dt):
        mono.t += dt
        wall.t += dt

    tel.run_started(0)
    for step in range(1, 13):
        dt = float(rng.uniform(0.5, 2.0))
        tick(dt)
        tel.record_step(step, dt, loss=float(rng.uniform(1, 3)))
        for host in (1, 2):
            if rng.uniform() < 0.7 or step < 3:
                tel.ingest_heartbeat(tel_mod.format_heartbeat(
                    host, step, dt * (4.0 if host == 2 and step > 6
                                      else 1.0)))
        tel.check_stragglers(now=mono.t)
        if step % 4 == 0:
            durable = step not in (8, 12)
            with tel.checkpoint("save", step=step, durable=durable):
                tick(float(rng.uniform(0.1, 0.3)))
            if not durable:
                tick(1.0)
                tel.checkpoint_durable()
        if step == 10:
            with tel.checkpoint("restore", step=8):
                tick(0.2)
        snaps.append(tel.snapshot())
    tick(0.5)
    summary = tel.run_finished({"steps": 12})
    return {"lines": lines, "snapshots": snaps, "summary": summary,
            "payload": tel.telemetry_payload(), "metrics": metrics.render(),
            "metrics_snapshot": metrics.snapshot()["gauges"],
            "spans": _spans(tracer),
            "state": open(state_path).read() if state_path else "",
            "restart_lost_s": tel.restart_lost_s}


def test_telemetry_sequences_are_the_jax_modules(tmp_path):
    runs = {}
    for side in SIDES:
        (tmp_path / side).mkdir()
        runs[side] = _drive(side, str(tmp_path / side / "goodput_state.json"),
                            seed=3)
    port, want = runs["port"], runs["jax"]
    assert port["lines"] == want["lines"]
    assert any(ln.startswith("TPU_STRAGGLER") for ln in port["lines"])
    for key in ("snapshots", "summary", "payload", "metrics",
                "metrics_snapshot", "spans", "state"):
        assert port[key] == want[key], key
    # a relaunch 900 s later charges the lost work alike, read from each
    # state file
    again = {side: _drive(side, str(tmp_path / side / "goodput_state.json"),
                          seed=4, attempt=1, wall0=6000.0) for side in SIDES}
    assert again["port"]["restart_lost_s"] > 0
    for key in ("lines", "snapshots", "summary", "metrics", "spans",
                "state", "restart_lost_s"):
        assert again["port"][key] == again["jax"][key], key


def test_ledger_and_watchdog_alone_are_the_jax_classes():
    out = {}
    for side, (mod, _, _) in SIDES.items():
        clock = FakeClock(10.0)
        ledger = mod.GoodputLedger(clock=clock, start_bucket="idle")
        dog = mod.StragglerWatchdog(4, straggler_factor=2.5,
                                    stall_timeout_s=5.0, clock=clock)
        rng = np.random.default_rng(9)
        events = []
        for i in range(40):
            clock.t += float(rng.uniform(0.1, 1.0))
            ledger.switch(str(rng.choice(["productive", "compile",
                                          "checkpoint_save", "stalled"])))
            host = int(rng.integers(0, 4))
            if host != 3 or i < 10:
                dog.observe(host, i, float(rng.uniform(0.5, 1.5))
                            * (3.0 if host == 2 else 1.0))
            events += dog.check()
        ledger.charge("restart_lost", 7.5)
        out[side] = (ledger.snapshot(), ledger.goodput, dog.snapshot(),
                     events, dict(dog.flagged))
    assert out["port"] == out["jax"]
    assert out["port"][3]


# -- the trainers' lines through the kubelet's scrape ---------------------------

DIMS = dict(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=64)
B, S = 2, 16


class _Ticks:
    """A ``time`` stand-in whose perf_counter advances a fixed 0.25 s a
    call: both trainers read it at the same points."""

    def __init__(self):
        self.t = 50.0

    def perf_counter(self) -> float:
        self.t += 0.25
        return self.t


def _trainer_lines(side: str, tree, batches, monkeypatch) -> list:
    tel_mod, metrics_mod, tracing_mod = SIDES[side]
    ticks, mono = _Ticks(), FakeClock(0.0)

    def mono_clock():
        mono.t += 0.125
        return mono.t

    lines: list = []
    jcfg = jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tel = tel_mod.TrainingTelemetry(
        tokens_per_step=B * S, model_params=jcfg.param_count,
        accelerator_type="", metrics=metrics_mod.Metrics(),
        tracer=tracing_mod.Tracer(clock=FakeClock(0.0)),
        clock=FakeClock(0.0), mono=mono_clock, dp_width=1,
        emit_line=lines.append)
    kw = dict(learning_rate=1e-2, warmup_steps=1, steps=3, batch_size=B,
              seq_len=S)
    if side == "jax":
        monkeypatch.setattr(jtrain, "time", ticks)
        tr = jtrain.Trainer(jcfg, jtrain.TrainConfig(**kw),
                            initial_params=tree, telemetry=tel)
        tr.run(steps=3, batches=iter([jnp.asarray(b) for b in batches]))
    else:
        monkeypatch.setattr(ptrain, "time", ticks)
        cfg = config_from_jax(jcfg, torch.float32)
        tr = ptrain.Trainer(cfg, ptrain.TrainConfig(**kw), device="cpu",
                            initial_params=params_from_jax(tree, cfg, "cpu",
                                                           master=True),
                            telemetry=tel)
        tr.run(steps=3, batches=iter([torch.from_numpy(b)
                                      for b in batches]))
    return lines


class _Kube:
    def __init__(self):
        self.annotations = {}

    def patch_pod(self, ns, name, body):
        self.annotations.update(body["metadata"]["annotations"])
        return {"metadata": {"name": name,
                             "annotations": dict(self.annotations)}}


class _Gang:
    def __init__(self, logs: str):
        self.logs = logs

    def last_in_logs(self, resource, pattern, worker_id=0):
        found = list(re.finditer(pattern, self.logs))
        return found[-1] if found else None


class _Watch(TrainingWatchMixin):
    """The mixin's collaborators, as the kubelet's provider holds them."""

    def __init__(self, logs: str):
        import threading
        self.gang = _Gang(logs)
        self.metrics = jmetrics.Metrics()
        self.tracer = jtracing.Tracer()
        self.kube = _Kube()
        self.lock = threading.Lock()
        self.cfg = types.SimpleNamespace(stall_timeout_s=60.0)
        self.pods = {}
        self.events = []
        self._describe_training_metrics()

    def emit_event(self, pod, reason, message, event_type="Normal"):
        self.events.append(reason)

    def scrape_worker_id(self, info):
        return 0


def _scrape(lines: list) -> tuple:
    watch = _Watch("\n".join(lines))
    info = types.SimpleNamespace(
        workload_launched=True, train_probe_at=None,
        train_first_probe_at=None, train_last_step=None, train_step_at=None,
        train_stalled=False, train_annotated=None, trace_id="t",
        trace_root="r", qr_name="qr")
    pod = {"metadata": {"name": "train", "annotations": {}}}
    watch._scrape_training("default/train", pod, info,
                           types.SimpleNamespace(resource="qr"), now=1.0)
    return watch.kube.annotations, watch.metrics.render(), info.train_last_step


def test_trainer_lines_read_by_the_kubelet_as_a_jax_trainers(monkeypatch):
    jcfg = jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, DIMS["vocab_size"], (B, S + 1))
               .astype(np.int32) for _ in range(3)]
    port = _trainer_lines("port", tree, batches, monkeypatch)
    want = _trainer_lines("jax", tree, batches, monkeypatch)
    assert port == want
    assert sum(ln.startswith("TPU_STEP_HEARTBEAT") for ln in port) == 3
    anns, gauges, step = _scrape(port)
    assert (anns, gauges, step) == _scrape(want)
    assert step == 3 and anns["tpu.dev/last-step"] == "3"


# -- the health server ------------------------------------------------------

def _ask(port: int, path: str, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _serve(side: str, ready: bool, fail_train: bool):
    mod = {"port": phealth, "jax": jhealth}[side]
    _, metrics_mod, tracing_mod = SIDES[side]
    metrics = metrics_mod.Metrics()
    metrics.describe("tpu_training_last_step", "last completed step")
    metrics.set_gauge("tpu_training_last_step", 7.0)
    metrics.incr("tpu_training_lost_seconds", 2.5, {"cause": "compile"})
    beats = []

    def train_status():
        if fail_train:
            raise RuntimeError("snapshot failed")
        return {"step": 7, "goodput": 0.5}

    def sink(body):
        if "bad" in body:
            raise ValueError("bad heartbeat")
        beats.append(body)

    return mod.HealthServer(":0", ready_func=lambda: ready, metrics=metrics,
                            tracer=tracing_mod.Tracer(),
                            train_status=train_status,
                            heartbeat_sink=sink).start()


@pytest.mark.parametrize("ready,fail_train", [(True, False), (False, True)])
def test_health_server_answers_as_the_jax_one(ready, fail_train):
    requests = [("/healthz", None), ("/readyz", None), ("/metrics", None),
                ("/debug/traces", None), ("/debug/traces?trace_id=ab", None),
                ("/debug/engine", None), ("/debug/train", None),
                ("/nope", None),
                ("/heartbeat", b"TPU_STEP_HEARTBEAT host=1 step=3 "
                               b"step_time_s=0.5"),
                ("/heartbeat", b"bad"), ("/elsewhere", b"x")]
    answers = {}
    for side in SIDES:
        hs = _serve(side, ready, fail_train)
        try:
            answers[side] = [_ask(hs.port, p, b) for p, b in requests]
            hs.set_healthy(False)
            answers[side].append(_ask(hs.port, "/healthz"))
        finally:
            hs.stop()
    assert answers["port"] == answers["jax"]
    codes = [a[0] for a in answers["port"]]
    assert codes[1] == (200 if ready else 503)
    assert codes[6] == (500 if fail_train else 200)
    assert codes[5] == codes[7] == 404 and codes[-1] == 503


# -- the generations table --------------------------------------------------

def test_the_card_maps_to_the_h100_row():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB", "h100"):
        assert pgen.generation_of(name) == "h100"
        assert pgen.peak_tflops_per_chip(name) == 989.0
    assert pgen.GENERATIONS["h100"].peak_hbm_gbps == 3350.0
    # the PCIe and NVL cards' published peaks are lower than the SXM row's
    for name in ("", "weird-thing", "NVIDIA A100-SXM4-80GB",
                 "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        assert pgen.generation_of(name) == "cpu"
    for name in list(jgen.GENERATIONS) + ["v5litepod-16", "v5p-128",
                                          "v6e-8", "v4-32"]:
        assert pgen.generation_of(name) == jgen.generation_of(name)
        assert pgen.peak_tflops_per_chip(name) == \
            jgen.peak_tflops_per_chip(name)
    stats = ptel.StepStats(tokens_per_step=1000, model_params=10**9,
                           accelerator_type="NVIDIA H100 80GB HBM3")
    stats.record(1, 1.0)
    assert stats.mfu == pytest.approx(6e12 / 989e12)
    assert ptel.PEAK_TFLOPS_BF16["h100"] == 989.0
    # the port's telemetry reads the port's table, not the JAX one
    assert ptel.peak_tflops_per_chip is pgen.peak_tflops_per_chip
