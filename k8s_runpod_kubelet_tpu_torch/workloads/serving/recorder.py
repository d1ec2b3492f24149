"""Capture watchdog of the engine's step graphs (port of the
``CompileWatchdog`` and ``_TrackedJit`` of the JAX package's
``workloads/serving/recorder.py``).

The JAX engine jits its hot-path steps and counts every compile past the
first: a cache-key flap that recompiles the hot loop is the bug that
hides until production traffic. The port's counterpart of a compile is a
CUDA-graph capture (``step_graph.StepGraph``): the first capture is the
contract, every later one a recapture, logged with the diff of what the
graph bakes in, and one past ``budget`` warns once.

A wrapped object exposes two seams, read only by the watchdog:
``captures``, its capture count (the counterpart of jax.jit's
``_cache_size()``), and ``baked()``, the tree of tensors its graph holds
pointers to. The fingerprint is each tensor's dtype, shape, device and
``data_ptr``, so a recapture caused by a moved arena names the arena.

Metrics, spans and the FlightRecorder are not ported yet; the counts are
read through ``snapshot()`` (the engine's ``debug_snapshot()["graphs"]``).
"""

from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger(__name__)


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
    capture past a graph's FIRST is logged with the fingerprint diff;
    captures past ``budget`` trip a log-once warning. ``budget=None``
    tracks without the alarm."""

    DEFAULT_BUDGET = 2

    def __init__(self):
        self._tracked: dict[str, _TrackedGraph] = {}

    def wrap(self, name: str, fn, budget: Optional[int] = DEFAULT_BUDGET):
        if fn is None:
            return None
        tracked = _TrackedGraph(self, name, fn, budget)
        self._tracked[name] = tracked
        return tracked

    def _compiled(self, tracked: _TrackedGraph, fp: Optional[list[str]]):
        if tracked.compiles <= 1:
            return  # the first capture is the contract, not a finding
        diff = (_diff(tracked._last_fp, fp)
                if tracked._last_fp and fp else [])
        tracked.last_diff = diff
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
