"""The port's ``metrics.py`` and ``tracing.py`` against the JAX package's.

- seeded call sequences (describe with and without buckets, incr, set and
  remove gauges, observe with and without exemplars, ``time_block`` on an
  injected clock; names and label values that need escaping) drive both
  ``Metrics``: ``render()``, ``snapshot()``, ``get_counter`` and
  ``get_observations`` are identical;
- the JAX router's ``MetricsAggregator`` renders the port's snapshot as it
  renders the JAX one's;
- ``parse_traceparent``/``format_traceparent`` agree on a table of valid
  and malformed headers;
- the ``Tracer``'s ring bound, ``query()`` and the JSONL export's keys.
"""

import json

import numpy as np
import pytest

from k8s_runpod_kubelet_tpu import metrics as jmetrics
from k8s_runpod_kubelet_tpu import tracing as jtracing
from k8s_runpod_kubelet_tpu_torch import metrics, tracing

NAMES = ("tpu_serving_ttft_seconds", "tpu_serving_admitted",
         "tpu_serving_queue_depth", "tpu_serving_step_tokens", "odd_name")
LABELS = ({}, {"fn": "paged_step"}, {"fn": 'a"b'}, {"pod": "x\\y"},
          {"pod": "line\nbreak", "zone": "b"})


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _drive(m, ops):
    for op, *args in ops:
        if op == "time_block":
            with m.time_block(*args):
                pass
        else:
            getattr(m, op)(*args)


def _ops(seed: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for name in NAMES[:3]:
        if rng.random() < 0.8:
            buckets = (None if rng.random() < 0.4 else
                       tuple(sorted(float(b) for b in
                                    rng.choice([0.001, 0.01, 0.5, 1, 2.5, 60],
                                               size=int(rng.integers(1, 5)),
                                               replace=False))))
            ops.append(("describe", name, f"help of {name} \\ with\nbreaks",
                        buckets))
    for _ in range(int(rng.integers(10, 40))):
        name = NAMES[int(rng.integers(len(NAMES)))]
        labels = LABELS[int(rng.integers(len(LABELS)))] or None
        kind = int(rng.integers(6))
        value = float(np.round(rng.exponential(2.0), 4))
        if kind == 0:
            ops.append(("incr", name, value, labels))
        elif kind == 1:
            ops.append(("incr", name + "_c", 1.0, labels))
        elif kind == 2:
            ops.append(("set_gauge", name + "_g", value, labels))
        elif kind == 3:
            ops.append(("remove_gauge", name + "_g", labels))
        elif kind == 4:
            ex = None if rng.random() < 0.5 else f"trace{int(rng.integers(9))}"
            ops.append(("observe", name + "_h", value, labels, ex))
        else:
            ops.append(("time_block", name + "_t", labels))
    return ops


@pytest.mark.parametrize("seed", range(24))
def test_render_and_snapshot_match_the_jax_metrics(seed):
    ops = _ops(seed)
    port, ref = metrics.Metrics(clock=_Clock()), jmetrics.Metrics(
        clock=_Clock())
    _drive(port, ops)
    _drive(ref, ops)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    for name in NAMES:
        for labels in LABELS:
            assert port.get_counter(name, labels) == ref.get_counter(
                name, labels)
            assert port.get_observations(name + "_h", labels) == \
                ref.get_observations(name + "_h", labels)
    # the router's merge reads the port's snapshot as it reads JAX's
    agg_port, agg_ref = (jmetrics.MetricsAggregator(),
                         jmetrics.MetricsAggregator())
    agg_port.ingest("r1", port.snapshot())
    agg_ref.ingest("r1", ref.snapshot())
    assert agg_port.render() == agg_ref.render()


def test_the_snapshot_schema_and_escaping():
    assert metrics.SNAPSHOT_SCHEMA_VERSION == jmetrics.SNAPSHOT_SCHEMA_VERSION
    m = metrics.Metrics()
    m.describe("c", "a \\ b\nc")
    m.incr("c", 2, {"k": 'q"\\\n'})
    m.observe("h", 0.3, exemplar='t"1')
    text = m.render()
    assert "# HELP c_total a \\\\ b\\nc" in text
    assert 'c_total{k="q\\"\\\\\\n"} 2.0' in text
    assert '# {trace_id="t\\"1"} 0.3' in text
    assert m.snapshot()["schema_version"] == 1
    with pytest.raises(ValueError):
        m.describe("h2", "x", buckets=())


HEADERS = [
    None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "01-" + "1" * 32 + "-" + "2" * 16 + "-01-extra",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
    "000-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "  00-" + "c" * 32 + "-" + "d" * 16 + "-01  ",
]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_traceparent_parsing_matches_jax(header):
    got = tracing.parse_traceparent(header)
    assert got == jtracing.parse_traceparent(header)
    if got is not None:
        assert tracing.format_traceparent(*got) == \
            jtracing.format_traceparent(*got)
        assert tracing.parse_traceparent(
            tracing.format_traceparent(*got)) == got


def test_tracer_ring_query_and_export(tmp_path):
    path = tmp_path / "spans.jsonl"
    port = tracing.Tracer(max_spans=4, export_path=str(path))
    ref = jtracing.Tracer(max_spans=4)
    for i in range(6):
        kw = dict(trace_id=f"{i % 2:032x}", span_id=f"{i:016x}",
                  parent_id="" if i < 2 else f"{i - 2:016x}",
                  attrs={"i": i})
        port.record(f"s{i}", 10.0 + i, 10.5 + i, **kw)
        ref.record(f"s{i}", 10.0 + i, 10.5 + i, **kw)
    assert len(port) == 4
    assert port.query() == ref.query()
    assert port.query(f"{1:032x}") == ref.query(f"{1:032x}")
    assert [s["name"] for s in port.query(f"{1:032x}")["spans"]] == \
        ["s3", "s5"]
    with port.span("live", trace_id="e" * 32) as outer:
        with port.span("inner") as inner:
            pass
    assert inner.parent_id == outer.span_id and inner.trace_id == "e" * 32
    port.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 8 and port.dropped_exports == 0
    assert all(set(x) == {"trace_id", "span_id", "parent_id", "name",
                          "start", "duration_s", "attrs"} for x in lines)
    assert [x["name"] for x in lines[-2:]] == ["inner", "live"]
