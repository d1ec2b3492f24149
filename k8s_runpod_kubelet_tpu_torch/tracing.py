"""Dependency-free request tracing: spans, bounded ring, JSONL export, W3C
traceparent propagation (the port's own copy of the JAX package's
``tracing.py``, unchanged: the module is framework-free, and a torch
replica's spans and headers must be the ones a JAX replica writes).

The reference has NO per-request observability (SURVEY.md §5.5) and coarse
counters can't answer "why was THIS request slow?". This module is the
timing-attribution backbone both layers share:

- **serving**: every request gets a span tree (queue-wait -> prefill ->
  decode -> finish) keyed by the trace_id the client sent in its W3C
  ``traceparent`` header (or a fresh one), stamped back into the response.
- **kubelet**: pod lifecycle spans (deploy -> provisioning -> gang-launch ->
  ready) share a trace_id stored in the ``tpu.dev/trace-id`` annotation, so
  a slow request on a slice can be joined back to how that slice was born.

Design constraints, in order:
- stdlib only (the control plane must stay dependency-free);
- O(max_spans) memory for a process that runs for months (bounded deque);
- injected-clock-friendly: ``record()`` takes explicit start/end values in
  the caller's clock domain, so the provider's FakeClock tests and the
  engine's perf_counter bookkeeping both work without monkeypatching;
- export is one JSON object per line (JSONL), the format
  ``tools/trace_summary.py`` renders into waterfalls and TTFT/ITL rollups.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
import uuid
from collections import deque
from typing import Callable, Optional

_TRACEPARENT_VERSION = "00"


@dataclasses.dataclass
class Span:
    """One finished span. ``start``/``end`` are in whatever clock domain the
    recorder used (wall seconds for everything this repo exports)."""

    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start: float
    end: float
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "duration_s": self.duration_s,
            "attrs": self.attrs,
        }


def _hex_ok(s: str, n: int) -> bool:
    if len(s) != n or s != s.lower():
        return False
    try:
        return int(s, 16) != 0  # all-zero ids are invalid per the W3C spec
    except ValueError:
        return False


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, str]]:
    """W3C ``traceparent`` -> (trace_id, parent_span_id), or None if the
    header is absent/malformed. Lenient on the flags byte (we don't sample),
    strict on field shapes so a garbage header can't poison the trace store
    with unjoinable ids."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if version == "ff" or len(version) != 2:
        return None
    if not _hex_ok(trace_id, 32) or not _hex_ok(span_id, 16):
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """The header value to stamp into a response (flags 01 = sampled: the
    span IS in the ring / export file)."""
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-01"


class Tracer:
    """Produces spans into a bounded in-memory ring plus optional JSONL file.

    ``clock`` is the wall clock used by the ``span()`` context manager and
    by callers that want "now" in the tracer's domain; ``monotonic`` times
    context-managed durations. Both are injectable for tests (the provider
    passes its FakeClock-compatible ``clock``). ``record()`` bypasses both
    and trusts the caller's numbers."""

    def __init__(self, max_spans: int = 2048, export_path: str = "",
                 clock: Callable[[], float] = time.time,
                 monotonic: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.monotonic = monotonic
        self.export_path = export_path
        self._ring: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._local = threading.local()  # per-thread live-span stack
        self.dropped_exports = 0
        # export is ASYNC (ErrorSinkHandler's pattern): record() runs on the
        # serving engine's decode thread, so a slow/stalling disk must cost
        # a bounded-queue put, never a blocking write. One writer thread
        # owns the file; a full queue counts drops instead of blocking.
        self._export_queue: "queue.Queue[Optional[str]]" = \
            queue.Queue(maxsize=1024)
        self._writer: Optional[threading.Thread] = None
        if export_path:
            self._writer = threading.Thread(target=self._drain_exports,
                                            name="trace-export", daemon=True)
            self._writer.start()

    # -- ids -------------------------------------------------------------------

    @staticmethod
    def new_trace_id() -> str:
        return uuid.uuid4().hex  # 32 hex chars

    @staticmethod
    def new_span_id() -> str:
        return uuid.uuid4().hex[:16]

    # -- recording -------------------------------------------------------------

    def record(self, name: str, start: float, end: float,
               trace_id: Optional[str] = None, span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[dict] = None) -> Span:
        """Record a finished span with caller-supplied times (the engine and
        provider know their intervals retroactively — no live span objects
        cross their threads)."""
        span = Span(trace_id=trace_id or self.new_trace_id(),
                    span_id=span_id or self.new_span_id(),
                    parent_id=parent_id or "",
                    name=name, start=float(start), end=float(end),
                    attrs=dict(attrs or {}))
        with self._lock:
            self._ring.append(span)
        self._export(span)
        return span

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, attrs: Optional[dict] = None):
        """Context manager for live code paths. Nested ``span()`` calls on
        the same thread auto-parent under the enclosing span and inherit its
        trace_id; the yielded object exposes ``trace_id``/``span_id`` and a
        mutable ``attrs`` dict."""
        return _LiveSpan(self, name, trace_id, parent_id, attrs)

    # -- reads -----------------------------------------------------------------

    def get_trace(self, trace_id: str) -> list[dict]:
        """All ringed spans of one trace, oldest first."""
        with self._lock:
            return [s.to_dict() for s in self._ring if s.trace_id == trace_id]

    def recent(self, n: int = 256) -> list[dict]:
        """The most recent finished spans, oldest first."""
        with self._lock:
            spans = list(self._ring)[-n:]
        return [s.to_dict() for s in spans]

    def query(self, trace_id: str = "") -> dict:
        """The /debug/traces response payload — ONE shape for every debug
        surface (serving front end and kubelet health server serve this
        verbatim): one trace's spans when filtered, else the recent ring."""
        return {"spans": (self.get_trace(trace_id) if trace_id
                          else self.recent()),
                "trace_id": trace_id or None}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- export ----------------------------------------------------------------

    def _export(self, span: Span):
        if self._writer is None:
            return
        try:
            self._export_queue.put_nowait(json.dumps(span.to_dict()) + "\n")
        except queue.Full:  # writer far behind (stalled disk): drop, count
            # under the ring lock: callers race the writer thread's OSError
            # path on this counter, and += on an instance attribute is not
            # atomic — two threads can read the same value and lose a drop
            with self._lock:
                self.dropped_exports += 1

    def _drain_exports(self):
        f = None
        try:
            while True:
                line = self._export_queue.get()
                if line is None:
                    return
                try:
                    if f is None:
                        os.makedirs(os.path.dirname(
                            os.path.abspath(self.export_path)), exist_ok=True)
                        f = open(self.export_path, "a",  # noqa: SIM115
                                 encoding="utf-8")
                    f.write(line)
                    f.flush()
                except OSError:
                    # full/readonly disk must never take down serving;
                    # same lock as _export's queue-full path — the two
                    # threads share this counter
                    with self._lock:
                        self.dropped_exports += 1
        finally:
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    def close(self):
        """Flush: FIFO sentinel behind pending lines, bounded join — spans
        recorded before close() reach the file (tests and clean shutdowns
        read it right after)."""
        if self._writer is None:
            return
        try:
            self._export_queue.put(None, timeout=1.0)
        except queue.Full:
            pass  # stalled writer: the bounded join below still applies
        self._writer.join(timeout=5.0)
        self._writer = None

    # -- live-span plumbing ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


class _LiveSpan:
    """The span() context manager: wall start from the tracer's clock, the
    duration from its monotonic clock (wall clocks step; durations must
    not)."""

    def __init__(self, tracer: Tracer, name: str, trace_id, parent_id, attrs):
        self._tracer = tracer
        self.name = name
        self._explicit_trace = trace_id
        self._explicit_parent = parent_id
        self.attrs = dict(attrs or {})
        self.trace_id = ""
        self.span_id = Tracer.new_span_id()
        self.parent_id = ""

    def __enter__(self) -> "_LiveSpan":
        stack = self._tracer._stack()
        enclosing = stack[-1] if stack else None
        self.trace_id = (self._explicit_trace
                         or (enclosing.trace_id if enclosing else None)
                         or Tracer.new_trace_id())
        self.parent_id = (self._explicit_parent
                          or (enclosing.span_id if enclosing else ""))
        self._start_wall = self._tracer.clock()
        self._start_mono = self._tracer.monotonic()
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        duration = self._tracer.monotonic() - self._start_mono
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer.record(self.name, self._start_wall,
                            self._start_wall + duration,
                            trace_id=self.trace_id, span_id=self.span_id,
                            parent_id=self.parent_id, attrs=self.attrs)
        return False
