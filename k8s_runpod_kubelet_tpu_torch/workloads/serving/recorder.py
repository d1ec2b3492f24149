"""Serving flight recorder and capture watchdog (port of the
``FlightRecorder``, ``CompileWatchdog`` and ``_TrackedJit`` of the JAX
package's ``workloads/serving/recorder.py``). Stdlib only.

- **FlightRecorder**: a bounded ring of per-decode-step records: batch
  composition, the step wall split into contiguous
  schedule/kernel/sample/commit phases (the marks telescope, so the
  phases sum to the step wall by construction), arena page occupancy,
  speculative accounting, and out-of-band events (chunk interleave).
  Served at ``GET /debug/steps``. The phases keep the reference's
  meaning: ``schedule`` is slot-table growth and the step's host inputs,
  ``kernel`` closes when the step is launched, ``sample`` when the next
  tokens are on the host, ``commit`` at the end of the bookkeeping. A
  step graph's replay is asynchronous, as a jitted dispatch is, so
  ``kernel`` is the host's launch time and the wait for the card lands in
  ``sample``, at the sampler's first read of the logits on the host.
  With ``metrics`` each step also feeds the step histograms
  (``tpu_serving_step_*``) and the ring's occupancy gauges, and
  ``step_end(rids=)`` charges each request its even share of the step;
  the engine folds that into the request's span (``pop_request``).
- **CompileWatchdog**: the JAX engine jits its hot-path steps and counts
  every compile past the first: a cache-key flap that recompiles the hot
  loop is the bug that hides until production traffic. The port's
  counterpart of a compile is a CUDA-graph capture
  (``step_graph.StepGraph``): the first capture is the contract, every
  later one a recapture, counted in ``tpu_serving_recompiles{fn=}``
  (zero-seeded for every budgeted graph), recorded as a
  ``serving.recompile`` span with the diff of what the graph bakes in,
  and one past ``budget`` warns once.

A wrapped graph exposes two seams, read only by the watchdog:
``captures``, its capture count (the counterpart of jax.jit's
``_cache_size()``), and ``baked()``, the tree of tensors its graph holds
pointers to. The fingerprint is each tensor's dtype, shape, device and
``data_ptr``, so a recapture caused by a moved arena names the arena.
The counts are read through ``snapshot()`` (the engine's
``debug_snapshot()["graphs"]`` and ``debug_steps()["recompiles"]``).

Threading: phase marks (``step_begin``/``mark``/``step_end``) are
engine-thread-only and lock-free; the ring and the per-request table are
guarded by one lock so ``snapshot()`` (HTTP threads) and ``pop_request``
(engine thread) stay consistent. ``event()`` may be called
from any thread. A disabled recorder is ``None`` on the engine: the hot
path pays one ``is not None`` test per mark site.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


# phase marks in hot-path order; step_end closes "commit"
PHASES = ("schedule", "kernel", "sample", "commit")

# decode steps live in the single-digit-millisecond to ~100 ms band; the
# TTFT ladder's 0.5 s first bucket would crush every sample into one bin
STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)


class FlightRecorder:
    """Bounded ring of per-decode-step records and per-request
    attribution.

    ``max_steps`` bounds the record count and ``max_bytes`` the ring's
    serialized size (each record is JSON-sized once at append; the oldest
    evict until both bounds hold). ``perf`` is the clock (perf_counter,
    injectable), so tests drive the phase math from a fake clock.
    ``metrics`` (a ``metrics.Metrics``) receives the step histograms and
    ring gauges; ``max_requests`` bounds the per-request table."""

    def __init__(self, max_steps: int = 512, max_bytes: int = 262144,
                 perf: Callable[[], float] = time.perf_counter,
                 metrics=None, max_requests: int = 64):
        if max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        if max_bytes < 1024:
            raise ValueError(f"max_bytes must be >= 1024, got {max_bytes}")
        self.max_steps = max_steps
        self.max_bytes = max_bytes
        self.max_requests = max_requests
        self._perf = perf
        self.metrics = metrics
        self._lock = threading.Lock()
        # ring of (record, serialized bytes)
        self._ring: "deque[tuple[dict, int]]" = deque()
        self._bytes = 0
        self._seq = 0
        self.dropped_records = 0
        # per-request step accumulators, folded into the serving.request
        # span at completion; bounded, the oldest dropped first (a dropped
        # entry costs one request its attribution, never memory)
        self._by_request: "OrderedDict[str, dict]" = OrderedDict()
        # engine-thread step state (no lock: marks never cross threads)
        self._t0: Optional[float] = None
        self._marks: list[tuple[str, float]] = []

    # -- hot path (engine thread only) -----------------------------------------

    def step_begin(self):
        """Arm a step: t0 opens the schedule phase."""
        self._t0 = self._perf()
        self._marks = []

    def mark(self, phase: str):
        """Close the named phase at now; the next phase opens here."""
        if self._t0 is None:
            return
        self._marks.append((phase, self._perf()))

    def step_end(self, mode: str = "decode", active: int = 0,
                 draining: bool = False, paged: bool = False,
                 spec_k: int = 0, adapters: int = 0, tokens: int = 0,
                 rids: Optional[list] = None, arena: Optional[dict] = None,
                 spec: Optional[dict] = None, interleaved: bool = False):
        """Close the step ("commit" ends now), append its record, observe
        the step histograms and charge the step to ``rids``."""
        if self._t0 is None:
            return
        t_end = self._perf()
        phases: dict[str, float] = {}
        prev = self._t0
        for name, t in self._marks:
            phases[name] = phases.get(name, 0.0) + (t - prev)
            prev = t
        phases["commit"] = phases.get("commit", 0.0) + (t_end - prev)
        wall = t_end - self._t0
        self._t0 = None
        self._marks = []
        record = {
            "seq": self._seq,
            "t": round(t_end, 6),
            "wall_s": wall,
            "phases": {f"{p}_s": phases.get(p, 0.0) for p in PHASES},
            "batch": {"mode": mode, "active": active,
                      "draining": bool(draining), "paged": bool(paged),
                      "spec_k": spec_k, "adapters": adapters,
                      "interleaved": bool(interleaved)},
            "tokens": tokens,
        }
        if arena:
            record["arena"] = arena
        if spec:
            record["spec"] = spec
        self._seq += 1
        self._append(record)
        if self.metrics is not None:
            m = self.metrics
            m.observe("tpu_serving_step_wall_seconds", wall)
            # one literal a phase, as the reference writes them
            m.observe("tpu_serving_step_schedule_seconds",
                      phases.get("schedule", 0.0))
            m.observe("tpu_serving_step_kernel_seconds",
                      phases.get("kernel", 0.0))
            m.observe("tpu_serving_step_sample_seconds",
                      phases.get("sample", 0.0))
            m.observe("tpu_serving_step_commit_seconds",
                      phases.get("commit", 0.0))
            m.observe("tpu_serving_step_tokens", float(tokens))
        if rids:
            share = wall / len(rids)
            with self._lock:
                for rid in rids:
                    acc = self._by_request.get(rid)
                    if acc is None:
                        while len(self._by_request) >= self.max_requests:
                            self._by_request.popitem(last=False)
                        acc = self._by_request[rid] = {
                            "steps": 0, "step_wall_s": 0.0,
                            "kernel_s": 0.0}
                    acc["steps"] += 1
                    acc["step_wall_s"] += share
                    acc["kernel_s"] += phases.get("kernel", 0.0) / len(rids)

    def event(self, kind: str, **attrs):
        """Out-of-band timeline entry (chunk-interleave yields); any
        thread."""
        record = {"seq": self._seq, "t": round(self._perf(), 6),
                  "event": kind}
        if attrs:
            record.update(attrs)
        self._seq += 1
        self._append(record)

    def _append(self, record: dict):
        try:
            # sized and stored compact, so the byte budget buys more records
            nbytes = len(json.dumps(record, separators=(",", ":")))
        except (TypeError, ValueError):
            # a non-serializable attr must never kill the engine thread
            with self._lock:
                self.dropped_records += 1
            return
        with self._lock:
            if nbytes > self.max_bytes:
                self.dropped_records += 1
                return
            self._ring.append((record, nbytes))
            self._bytes += nbytes
            while (len(self._ring) > self.max_steps
                   or self._bytes > self.max_bytes):
                _, old = self._ring.popleft()
                self._bytes -= old
            n_records, n_bytes = len(self._ring), self._bytes
        # occupancy gauges refresh every 16th append (and the first): the
        # ring turns over many times between scrapes
        if self.metrics is not None and (self._seq & 0xF) == 1:
            self.metrics.set_gauge("tpu_serving_step_ring_records",
                                   n_records)
            self.metrics.set_gauge("tpu_serving_step_ring_bytes", n_bytes)

    # -- request attribution ---------------------------------------------------

    def pop_request(self, rid: str) -> Optional[dict]:
        """Take (and forget) a request's accumulated step attribution."""
        with self._lock:
            return self._by_request.pop(rid, None)

    # -- reads -----------------------------------------------------------------

    @property
    def ring_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def records(self, n: int = 0) -> list[dict]:
        """The newest ``n`` records (0 = all), oldest first."""
        with self._lock:
            recs = [r for r, _ in self._ring]
        return recs[-n:] if n else recs

    def rollup(self) -> dict:
        """Phase medians and batch composition over the current ring."""
        with self._lock:
            recs = [r for r, _ in self._ring]
            nbytes = self._bytes
            dropped = self.dropped_records
        steps = [r for r in recs if "wall_s" in r]
        out: dict[str, Any] = {
            "records": len(recs), "steps": len(steps),
            "events": len(recs) - len(steps), "bytes": nbytes,
            "max_bytes": self.max_bytes, "dropped": dropped,
        }
        if not steps:
            return out
        out["wall_ms_p50"] = _median([r["wall_s"] for r in steps]) * 1e3
        for p in PHASES:
            out[f"{p}_ms_p50"] = _median(
                [r["phases"].get(f"{p}_s", 0.0) for r in steps]) * 1e3
        out["active_p50"] = _median(
            [r["batch"]["active"] for r in steps])
        out["tokens_total"] = sum(r.get("tokens", 0) for r in steps)
        out["spec_steps"] = sum(
            1 for r in steps if r["batch"]["mode"] == "spec_verify")
        return out

    def snapshot(self, n: int = 64) -> dict:
        """The /debug/steps payload: the newest records and the rollup."""
        return {"enabled": True, "steps": self.records(n),
                "rollup": self.rollup()}


def _median(vals: list) -> float:
    s = sorted(vals)
    return float(s[len(s) // 2]) if s else 0.0


def _fingerprint(tree) -> list[str]:
    """One line per leaf of a nested dict/list of tensors: its path, dtype,
    shape, device and data pointer; scalars by value."""
    out: list[str] = []

    def walk(x, path):
        if len(out) >= 512:  # bound pathological trees
            return
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k], f"{path}.{k}" if path else str(k))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif x is None or isinstance(x, (bool, int, float, str)):
            out.append(f"{path}={x!r}")
        else:
            shape = getattr(x, "shape", None)
            desc = (f"{x.dtype}{tuple(shape)}@{x.device}#{x.data_ptr():#x}"
                    if shape is not None and hasattr(x, "data_ptr")
                    else type(x).__name__)
            out.append(f"{path}:{desc}")

    walk(tree, "")
    return out


def _diff(old: list[str], new: list[str], limit: int = 8) -> list[str]:
    """First few lines where two fingerprints disagree (the tensors that
    MOVED are the recapture's cause)."""
    changes = []
    o_set = set(old)
    for line in new:
        if line not in o_set:
            changes.append(f"+{line}")
            if len(changes) >= limit:
                return changes
    n_set = set(new)
    for line in old:
        if line not in n_set:
            changes.append(f"-{line}")
            if len(changes) >= limit:
                break
    return changes


class _TrackedGraph:
    """One wrapped step graph: passes calls (and ``capture``) straight
    through, then reads the graph's capture count: growth means THIS call
    captured."""

    __slots__ = ("name", "fn", "budget", "_watchdog", "_size", "compiles",
                 "_last_fp", "_warned", "last_diff")

    def __init__(self, watchdog: "CompileWatchdog", name: str, fn,
                 budget: Optional[int]):
        self.name = name
        self.fn = fn
        self.budget = budget
        self._watchdog = watchdog
        self._size = self._captures()
        self.compiles = 0
        self._last_fp: Optional[list[str]] = None
        self._warned = False
        self.last_diff: list[str] = []

    def _captures(self) -> Optional[int]:
        # an object without the seam degrades to no detection
        n = getattr(self.fn, "captures", None)
        return None if n is None else int(n)

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self._check()
        return out

    def capture(self, *args, **kwargs):
        out = self.fn.capture(*args, **kwargs)
        self._check()
        return out

    def _check(self):
        size = self._captures()
        if size is not None and self._size is not None \
                and size > self._size:
            self._size = size
            self._on_compile()
        elif size is not None:
            self._size = size

    def _on_compile(self):
        self.compiles += 1
        baked = getattr(self.fn, "baked", None)
        fp = _fingerprint(baked()) if baked is not None else None
        self._watchdog._compiled(self, fp)
        self._last_fp = fp if fp is not None else self._last_fp

    def snapshot(self) -> dict:
        return {"compiles": self.compiles,
                "recompiles": max(0, self.compiles - 1),
                "budget": self.budget, "warned": self._warned}


class CompileWatchdog:
    """Tracks captures across the engine's step graphs.

    ``wrap(name, fn, budget)`` returns a call-compatible ``_TrackedGraph``
    (None passes through, so optional graphs wire transparently). Every
    capture past a graph's FIRST increments ``tpu_serving_recompiles{fn=}``
    (budgeted graphs only) and records a ``serving.recompile`` span
    carrying the fingerprint diff; captures past ``budget`` trip a
    log-once warning. ``budget=None`` tracks without the alarm."""

    DEFAULT_BUDGET = 2

    def __init__(self, metrics=None, tracer=None):
        self.metrics = metrics
        self.tracer = tracer
        self._tracked: dict[str, _TrackedGraph] = {}

    def wrap(self, name: str, fn, budget: Optional[int] = DEFAULT_BUDGET):
        if fn is None:
            return None
        tracked = _TrackedGraph(self, name, fn, budget)
        self._tracked[name] = tracked
        if self.metrics is not None and budget is not None:
            # the per-graph series exists before the first (expected)
            # capture, so dashboards alert on any rise
            self.metrics.incr("tpu_serving_recompiles", 0,
                              labels={"fn": name})
        return tracked

    def _compiled(self, tracked: _TrackedGraph, fp: Optional[list[str]]):
        if tracked.compiles <= 1:
            return  # the first capture is the contract, not a finding
        if self.metrics is not None and tracked.budget is not None:
            self.metrics.incr("tpu_serving_recompiles",
                              labels={"fn": tracked.name})
        diff = (_diff(tracked._last_fp, fp)
                if tracked._last_fp and fp else [])
        tracked.last_diff = diff
        if self.tracer is not None:
            try:
                now = self.tracer.clock()
                self.tracer.record(
                    "serving.recompile", now, now,
                    attrs={"fn": tracked.name,
                           "compiles": tracked.compiles,
                           "aval_diff": diff})
            except Exception:  # noqa: BLE001 — tracing must never fail a step
                log.exception("recompile span for %s failed", tracked.name)
        log.info("serving: step graph %r recaptured (capture %d); moved: %s",
                 tracked.name, tracked.compiles, diff)
        if (tracked.budget is not None
                and tracked.compiles > tracked.budget
                and not tracked._warned):
            tracked._warned = True
            log.warning(
                "serving: hot-path step graph %r captured %d times (budget "
                "%d) — a tensor the graph bakes in keeps moving (params, "
                "arena or static buffers reassigned), so the hot loop "
                "recaptures; moved: %s", tracked.name, tracked.compiles,
                tracked.budget, diff)

    def snapshot(self) -> dict:
        """Per-graph capture counts, the JAX watchdog's keys."""
        return {name: t.snapshot()
                for name, t in sorted(self._tracked.items())}

    def total_recompiles(self) -> int:
        return sum(max(0, t.compiles - 1) for t in self._tracked.values())
