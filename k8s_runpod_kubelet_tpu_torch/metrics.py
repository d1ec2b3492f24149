"""Prometheus-style metrics registry: counters, gauges and histograms
(port of the replica half of the JAX package's ``metrics.py``; the
router's ``RestartGuard`` and ``MetricsAggregator`` stay there). Stdlib
only.

The serving engine records its SLO histograms (TTFT, inter-token gap,
queue wait, per-step phases, sub-second buckets through ``describe``),
its counters and its gauges here; ``serve_main`` serves ``render()`` at
``GET /metrics`` and the fleet reporter ships ``snapshot()`` on every
heartbeat. The exposition and the snapshot are the JAX package's byte
for byte, so the same HPA rules, router aggregation and dashboards read
a torch replica as they read a JAX one.

Exposition follows the Prometheus text format rules scrapers enforce:
counters are exposed (HELP/TYPE and samples alike) under the
``<name>_total`` family name, every family carries a ``# TYPE`` line, and
label values escape ``\\``, ``"`` and newlines.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600, 1800)

# heartbeat metric-snapshot wire shape (Metrics.snapshot /
# MetricsAggregator.ingest); readers warn, not crash, on unknown versions
SNAPSHOT_SCHEMA_VERSION = 1


class _Hist:
    """Fixed-size cumulative buckets + sum/count, plus a bounded tail of raw
    observations for tests/debugging — memory stays O(buckets) for a process
    meant to run for months. Bucket bounds are per-histogram (describe(...,
    buckets=...)): sub-second TTFT/ITL histograms must not be crushed into a
    0.5s first bucket sized for pod-provisioning latencies.

    Exemplars: each bucket (plus +Inf) keeps at most the LATEST
    ``(trace_id, value)`` pair observed into it — O(buckets) storage, enough
    for "p99 bucket -> trace_id -> /debug/traces waterfall" navigation."""

    __slots__ = ("buckets", "bucket_counts", "sum", "count", "recent",
                 "exemplars")

    def __init__(self, buckets: tuple = _DEFAULT_BUCKETS):
        self.buckets = buckets
        self.bucket_counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0
        self.recent: list[float] = []
        # one slot per bucket + one for +Inf; None or (trace_id, value)
        self.exemplars: list = [None] * (len(buckets) + 1)

    def observe(self, value: float, exemplar: Optional[str] = None):
        placed = exemplar is None
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.bucket_counts[i] += 1
                if not placed:
                    # attach to the LOWEST bucket containing the value (the
                    # bucket a non-cumulative view would file it under)
                    self.exemplars[i] = (exemplar, value)
                    placed = True
        if not placed:
            self.exemplars[len(self.buckets)] = (exemplar, value)
        self.sum += value
        self.count += 1
        self.recent.append(value)
        if len(self.recent) > 1000:
            del self.recent[:500]


class Metrics:
    def __init__(self, clock=time.monotonic):
        # duration source for time_block timers; injectable so soak tests
        # driving a FakeClock see deterministic histogram durations
        self._clock = clock
        self.lock = threading.Lock()
        self.counters: dict[tuple[str, tuple], float] = {}
        self.gauges: dict[tuple[str, tuple], float] = {}
        self.histograms: dict[tuple[str, tuple], _Hist] = {}
        self.help: dict[str, str] = {}
        self.bucket_spec: dict[str, tuple] = {}  # name -> histogram bounds

    @staticmethod
    def _key(name: str, labels: Optional[dict]) -> tuple[str, tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def describe(self, name: str, help_text: str,
                 buckets: Optional[tuple] = None):
        """HELP text for a metric; for histograms, optionally its bucket
        bounds (applied to label-sets created AFTER the describe — declare
        before first observe, as every call site in this repo does)."""
        self.help[name] = help_text
        if buckets is not None:
            bounds = tuple(sorted(float(b) for b in buckets))
            if not bounds:
                raise ValueError(f"{name}: buckets must be non-empty")
            self.bucket_spec[name] = bounds

    def incr(self, name: str, value: float = 1.0, labels: Optional[dict] = None):
        k = self._key(name, labels)
        with self.lock:
            self.counters[k] = self.counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, labels: Optional[dict] = None):
        with self.lock:
            self.gauges[self._key(name, labels)] = value

    def remove_gauge(self, name: str, labels: Optional[dict] = None):
        """Drop one labeled gauge series. For per-entity gauges (per-pod,
        per-replica) whose entity was deleted: a phantom series — e.g. a
        stalled=1 for a pod that no longer exists — must not alert forever."""
        with self.lock:
            self.gauges.pop(self._key(name, labels), None)

    def observe(self, name: str, value: float, labels: Optional[dict] = None,
                exemplar: Optional[str] = None):
        """Record one histogram observation. ``exemplar`` is an optional
        trace_id; the containing bucket keeps the latest one so exposition
        can link a tail bucket straight to a replayable trace."""
        with self.lock:
            key = self._key(name, labels)
            h = self.histograms.get(key)
            if h is None:
                h = self.histograms[key] = _Hist(
                    self.bucket_spec.get(name, _DEFAULT_BUCKETS))
            h.observe(value, exemplar=exemplar)

    def time_block(self, name: str, labels: Optional[dict] = None):
        return _Timer(self, name, labels)

    def get_counter(self, name: str, labels: Optional[dict] = None) -> float:
        return self.counters.get(self._key(name, labels), 0.0)

    def get_observations(self, name: str, labels: Optional[dict] = None) -> list[float]:
        """Most recent raw observations (bounded tail; for tests/debugging)."""
        h = self.histograms.get(self._key(name, labels))
        return list(h.recent) if h else []

    # -- exposition ------------------------------------------------------------

    @staticmethod
    def _esc_label(v) -> str:
        """Label-value escaping per the exposition format: backslash first,
        then quote and newline."""
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _esc_help(v: str) -> str:
        return v.replace("\\", "\\\\").replace("\n", "\\n")

    @classmethod
    def _labels_str(cls, labels: tuple) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{cls._esc_label(v)}"' for k, v in labels)
        return "{" + inner + "}"

    def _header(self, out: list[str], family: str, base_name: str, kind: str):
        """HELP (if described) + TYPE under the EXPOSED family name: a
        counter described as ``foo`` but sampled as ``foo_total`` must put
        its metadata on ``foo_total`` too, or scrapers see two different
        metrics (one with metadata and no samples, one untyped)."""
        if base_name in self.help:
            out.append(f"# HELP {family} {self._esc_help(self.help[base_name])}")
        out.append(f"# TYPE {family} {kind}")

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: list[str] = []
        with self.lock:
            names = sorted({n for n, _ in (*self.counters, *self.gauges, *self.histograms)})
            for name in names:
                counter_items = sorted((k, v) for k, v in self.counters.items()
                                       if k[0] == name)
                gauge_items = sorted((k, v) for k, v in self.gauges.items()
                                     if k[0] == name)
                hist_items = sorted(((k, h) for k, h in self.histograms.items()
                                     if k[0] == name), key=lambda kv: kv[0])
                if counter_items:
                    self._header(out, f"{name}_total", name, "counter")
                    for (_, lbls), v in counter_items:
                        out.append(f"{name}_total{self._labels_str(lbls)} {v}")
                if gauge_items:
                    self._header(out, name, name, "gauge")
                    for (_, lbls), v in gauge_items:
                        out.append(f"{name}{self._labels_str(lbls)} {v}")
                if hist_items:
                    self._header(out, name, name, "histogram")
                    for (_, lbls), h in hist_items:
                        for i, (b, c) in enumerate(zip(h.buckets,
                                                       h.bucket_counts)):
                            lb = dict(lbls)
                            lb["le"] = str(b)
                            out.append(f"{name}_bucket{self._labels_str(tuple(sorted(lb.items())))} {c}"
                                       f"{self._exemplar_str(h.exemplars[i])}")
                        lb = dict(lbls)
                        lb["le"] = "+Inf"
                        out.append(f"{name}_bucket{self._labels_str(tuple(sorted(lb.items())))} {h.count}"
                                   f"{self._exemplar_str(h.exemplars[len(h.buckets)])}")
                        out.append(f"{name}_sum{self._labels_str(lbls)} {h.sum}")
                        out.append(f"{name}_count{self._labels_str(lbls)} {h.count}")
        return "\n".join(out) + "\n"

    @classmethod
    def _exemplar_str(cls, ex) -> str:
        """OpenMetrics exemplar suffix for a _bucket sample:
        ``... # {trace_id="abc"} 0.07``. Timestamp deliberately omitted so
        fleet-merged exposition stays byte-deterministic."""
        if ex is None:
            return ""
        trace_id, value = ex
        return f' # {{trace_id="{cls._esc_label(trace_id)}"}} {value}'

    # -- heartbeat snapshot / fleet merge -------------------------------------

    def snapshot(self) -> dict:
        """Compact JSON-safe dump of every counter/gauge/histogram with
        metadata (help + bucket bounds). Cumulative, so it can ride every
        fleet heartbeat idempotently; ``MetricsAggregator.ingest`` turns a
        stream of these into fleet-wide totals with restart guards."""
        with self.lock:
            hists = []
            for (n, lbls), h in sorted(self.histograms.items()):
                hists.append([n, [list(p) for p in lbls], {
                    "buckets": list(h.buckets),
                    "bucket_counts": list(h.bucket_counts),
                    "sum": h.sum,
                    "count": h.count,
                    "exemplars": [[i, ex[0], ex[1]]
                                  for i, ex in enumerate(h.exemplars)
                                  if ex is not None],
                }])
            return {
                "schema_version": SNAPSHOT_SCHEMA_VERSION,
                "counters": [[n, [list(p) for p in lbls], v]
                             for (n, lbls), v in sorted(self.counters.items())],
                "gauges": [[n, [list(p) for p in lbls], v]
                           for (n, lbls), v in sorted(self.gauges.items())],
                "hists": hists,
                "help": dict(self.help),
                "bucket_spec": {k: list(v)
                                for k, v in self.bucket_spec.items()},
            }


class _Timer:
    def __init__(self, m: Metrics, name: str, labels: Optional[dict]):
        self.m, self.name, self.labels = m, name, labels

    def __enter__(self):
        self.t0 = self.m._clock()
        return self

    def __exit__(self, *exc):
        self.m.observe(self.name, self.m._clock() - self.t0, self.labels)
