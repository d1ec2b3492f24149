"""The recorder's metrics and attribution and the watchdog's recompile
series and spans, against the JAX package's ``recorder.py``:

- a forced recapture (a stub graph whose baked arena moves) raises
  ``tpu_serving_recompiles{fn}`` from its zero seed and records a
  ``serving.recompile`` span naming the moved tensor; the same events
  through the JAX watchdog (a jit whose input shape changes) render the
  same series and the same span shapes;
- ``FlightRecorder(metrics=)`` on a fake clock: the step histograms, the
  ring gauges and each request's step attribution (``pop_request``) equal
  the JAX recorder's on the same marks.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu import tracing as jtracing
from k8s_runpod_kubelet_tpu.workloads.serving.recorder import \
    CompileWatchdog as JaxCompileWatchdog
from k8s_runpod_kubelet_tpu.workloads.serving.recorder import \
    FlightRecorder as JaxFlightRecorder
from k8s_runpod_kubelet_tpu_torch import metrics, tracing
from k8s_runpod_kubelet_tpu_torch.workloads.serving.recorder import (
    CompileWatchdog, FlightRecorder)


class _StubGraph:
    """Each call with ``moved`` captures again over a reallocated arena
    section, as a rebuilt arena would make a step graph do."""

    def __init__(self):
        self.captures = 0
        self.arena = {"k": torch.zeros((2, 4)), "v": torch.zeros((2, 4))}

    def __call__(self, moved: bool):
        if moved:
            if self.captures:
                self.arena = dict(self.arena, k=torch.zeros((2, 4)))
            self.captures += 1

    def baked(self):
        return {"arena": self.arena}


def _recompiles(m) -> dict:
    return {dict(labels)["fn"]: v for (name, labels), v in m.counters.items()
            if name == "tpu_serving_recompiles"}


def test_forced_recapture_counts_and_records_a_span():
    m, tr = metrics.Metrics(), tracing.Tracer()
    wd = CompileWatchdog(metrics=m, tracer=tr)
    g = wd.wrap("paged_step", _StubGraph())
    wd.wrap("bucketed", _StubGraph(), budget=None)
    assert _recompiles(m) == {"paged_step": 0.0}   # seeded, budgeted only
    g(True)                                        # the first: free
    assert _recompiles(m) == {"paged_step": 0.0} and len(tr) == 0
    g(True)
    g(False)
    g(True)
    assert _recompiles(m) == {"paged_step": 2.0}
    assert 'tpu_serving_recompiles_total{fn="paged_step"} 2.0' in m.render()
    spans = tr.recent()
    assert [s["name"] for s in spans] == ["serving.recompile"] * 2
    assert [s["attrs"]["compiles"] for s in spans] == [2, 3]
    assert all(s["attrs"]["fn"] == "paged_step" for s in spans)
    diff = spans[-1]["attrs"]["aval_diff"]
    assert diff and all(line[1:].startswith("arena.k:") for line in diff)


@pytest.mark.parametrize("shapes", [(4, 4, 4), (1, 2, 3, 4),
                                    (2, 2, 3, 3, 5)],
                         ids=["stable", "every_call", "pairs"])
def test_recompile_series_and_spans_match_the_jax_watchdog(shapes):
    jm, jtr = jmetrics.Metrics(), jtracing.Tracer()
    pm, ptr = metrics.Metrics(), tracing.Tracer()
    jf = JaxCompileWatchdog(metrics=jm, tracer=jtr).wrap(
        "paged_step", jax.jit(lambda x: x * 2), budget=2)
    pf = CompileWatchdog(metrics=pm, tracer=ptr).wrap(
        "paged_step", _StubGraph(), budget=2)
    last = None
    for n in shapes:
        jf(jnp.zeros((n,), jnp.float32))
        pf(n != last)
        last = n
    assert pm.render() == jm.render()
    assert [(s["name"], sorted(s["attrs"]), s["attrs"]["compiles"])
            for s in ptr.recent()] == \
        [(s["name"], sorted(s["attrs"]), s["attrs"]["compiles"])
         for s in jtr.recent()]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _drive(rec):
    for step in range(40):
        rec.step_begin()
        rec.mark("schedule")
        rec.mark("kernel")
        rec.mark("sample")
        rids = [f"r{i}" for i in range(step % 5)]
        rec.step_end(mode="decode", active=len(rids), tokens=len(rids),
                     rids=rids, arena={"pages_total": 8, "pages_free": 3})
        if step % 7 == 0:
            rec.event("chunk_interleave", steps=1)


def test_recorder_metrics_and_attribution_match_the_jax_recorder():
    pm, jm = metrics.Metrics(), jmetrics.Metrics()
    prec = FlightRecorder(max_steps=16, perf=_Clock(), metrics=pm,
                          max_requests=3)
    jrec = JaxFlightRecorder(max_steps=16, perf=_Clock(), metrics=jm,
                             max_requests=3)
    _drive(prec)
    _drive(jrec)
    assert pm.render() == jm.render()
    assert pm.snapshot() == jm.snapshot()
    assert prec.snapshot(8) == jrec.snapshot(8)
    for rid in ("r0", "r1", "r2", "r3", "r9"):
        assert prec.pop_request(rid) == jrec.pop_request(rid)
    assert prec.pop_request("r1") is None
    assert pm.get_counter("x") == 0.0
    assert len(pm.get_observations("tpu_serving_step_wall_seconds")) == 40
