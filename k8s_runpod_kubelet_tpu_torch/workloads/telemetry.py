"""Training telemetry: goodput ledger, step/MFU stats, straggler watchdog
(the port's own copy of the JAX package's ``workloads/telemetry.py``).

A torch training pod prints the same protocol lines as a JAX one, so the
kubelet's scrape (``provider/training_watch.py`` reads ``step``,
``goodput``, ``mfu``, ``tokens_per_sec`` and ``unsaved_work_s`` from the
last ``TPU_TELEMETRY`` line of worker-0's logs) and the fleet scheduler's
eviction order read it unchanged. The lines, payloads, snapshots, state
file and ``tpu_training_*`` series are the JAX module's byte for byte; the
only change is that the MFU peak comes from the port's own
``generations.py``, which knows the H100.

Design constraints, in order:
- stdlib only (runs inside the workload container; imports no torch, and
  nothing of the JAX package);
- injected-clock everywhere: the ledger/watchdog take a ``clock`` callable,
  so every invariant here is provable on a FakeClock with zero real sleeps;
- the GoodputLedger's buckets are EXCLUSIVE (exactly one is open at any
  instant — ``switch`` closes the open bucket and opens the next) and
  therefore sum to wall clock by construction; restart cost carried in from
  a prior attempt (``charge``) extends the wall total so the invariant
  survives preemption attribution;
- one line protocol shared by every consumer: workers print
  ``TPU_STEP_HEARTBEAT ...`` / ``TPU_TELEMETRY {json}`` lines that worker-0
  aggregates (POST /heartbeat) and the kubelet scrapes out of worker-0 logs.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)

# -- peak-FLOPs table ----------------------------------------------------------

# The roofline table lives in the port's generations module; the names
# below stay importable from here for the training-side MFU math.
from ..generations import (PEAK_TFLOPS_BF16, generation_of,  # noqa: F401
                           peak_tflops_per_chip)


# -- the line protocol ---------------------------------------------------------

HEARTBEAT_MARKER = "TPU_STEP_HEARTBEAT"
TELEMETRY_MARKER = "TPU_TELEMETRY"
# the kubelet-side scrape pattern (GangExecutor.last_in_logs): the LAST
# telemetry line in worker-0's recent logs is the pod's current state
TELEMETRY_PATTERN = r"TPU_TELEMETRY (\{.*\})"

_HEARTBEAT_RE = re.compile(
    r"TPU_STEP_HEARTBEAT host=(\d+) step=(\d+) step_time_s=([0-9.eE+-]+)")


def format_heartbeat(host: int, step: int, step_time_s: float) -> str:
    """One worker's per-step progress beat (printed to its own log AND
    POSTed to worker-0's /heartbeat when a telemetry port is wired)."""
    return (f"{HEARTBEAT_MARKER} host={host} step={step} "
            f"step_time_s={step_time_s:.6f}")


def parse_heartbeat(line: str) -> Optional[tuple[int, int, float]]:
    """(host, step, step_time_s) from a heartbeat line, else None."""
    m = _HEARTBEAT_RE.search(line)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), float(m.group(3))


def format_telemetry(payload: dict) -> str:
    """Worker-0's aggregated state line (the kubelet scrape target)."""
    return f"{TELEMETRY_MARKER} {json.dumps(payload, sort_keys=True)}"


def parse_telemetry(text: str) -> Optional[dict]:
    """The LAST well-formed telemetry payload in a log body, else None."""
    out = None
    for m in re.finditer(TELEMETRY_PATTERN, text):
        try:
            out = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
    return out if isinstance(out, dict) else None


# -- goodput ledger ------------------------------------------------------------

class GoodputLedger:
    """Wall-clock accounting into EXCLUSIVE buckets that sum to wall time.

    Exactly one bucket is open at any instant: ``switch(b)`` closes the open
    bucket (crediting it the elapsed interval) and opens ``b``. Because the
    intervals are consecutive measurements of one clock, the bucket totals
    telescope to ``now - start`` — the sum-to-wall-clock invariant is
    structural, not bookkeeping, and the tier-1 test asserts it across a
    simulated preemption/restart cycle.

    Preemption attribution: work a prior attempt did after its last durable
    checkpoint is gone, and so is the downtime between its death and this
    attempt's start. ``charge("restart_lost", s)`` credits that externally-
    known cost; it extends the wall total by the same amount so the
    invariant still holds (lost time IS wall time the run paid for).
    """

    BUCKETS = ("productive", "compile", "checkpoint_save",
               "checkpoint_restore", "restart_lost", "resize", "stalled",
               "idle")

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 start_bucket: str = "idle"):
        if start_bucket not in self.BUCKETS:
            raise ValueError(f"unknown bucket {start_bucket!r}")
        self._clock = clock
        self._lock = threading.Lock()
        self._start = clock()
        self._acc = {b: 0.0 for b in self.BUCKETS}
        self._external = 0.0
        self._open = start_bucket
        self._opened_at = self._start

    @property
    def open_bucket(self) -> str:
        with self._lock:  # _open flips under the lock in switch()
            return self._open

    def switch(self, bucket: str) -> float:
        """Close the open bucket into its accumulator, open ``bucket``.
        Returns the just-closed interval's duration (seconds)."""
        if bucket not in self.BUCKETS:
            raise ValueError(f"unknown bucket {bucket!r}")
        with self._lock:
            now = self._clock()
            closed = now - self._opened_at
            self._acc[self._open] += closed
            self._open = bucket
            self._opened_at = now
            return closed

    def spend(self, bucket: str) -> "_Spend":
        """Context manager: open ``bucket`` on entry, restore the previously
        open bucket on exit (nesting-safe). The yielded object's
        ``.duration_s`` is the interval spent inside."""
        return _Spend(self, bucket)

    def charge(self, bucket: str, seconds: float):
        """Credit an externally-measured cost (a PRIOR attempt's lost work +
        downtime). Extends the wall total so buckets still sum to wall."""
        if bucket not in self.BUCKETS:
            raise ValueError(f"unknown bucket {bucket!r}")
        if seconds < 0:
            raise ValueError("charge must be >= 0")
        with self._lock:
            self._acc[bucket] += seconds
            self._external += seconds

    def total(self, bucket: str) -> float:
        """Bucket total including its open interval, if it is the open one."""
        with self._lock:
            t = self._acc[bucket]
            if bucket == self._open:
                t += self._clock() - self._opened_at
            return t

    def wall_s(self) -> float:
        with self._lock:
            return (self._clock() - self._start) + self._external

    @property
    def goodput(self) -> float:
        """productive / wall (0 when no wall time has passed)."""
        wall = self.wall_s()
        return self.total("productive") / wall if wall > 0 else 0.0

    def snapshot(self) -> dict:
        """Point-in-time view: per-bucket seconds (open interval included),
        wall_s, goodput, and lost_s per non-productive cause."""
        with self._lock:
            now = self._clock()
            acc = dict(self._acc)
            acc[self._open] += now - self._opened_at
            wall = (now - self._start) + self._external
        goodput = acc["productive"] / wall if wall > 0 else 0.0
        lost = {b: round(v, 6) for b, v in acc.items()
                if b != "productive" and v > 0}
        return {"buckets": {b: round(v, 6) for b, v in acc.items()},
                "wall_s": round(wall, 6), "goodput": round(goodput, 6),
                "lost_s": lost}


class _Spend:
    def __init__(self, ledger: GoodputLedger, bucket: str):
        self._ledger = ledger
        self._bucket = bucket
        self.duration_s = 0.0

    def __enter__(self) -> "_Spend":
        self._restore = self._ledger.open_bucket
        self._entered_at = self._ledger._clock()
        self._ledger.switch(self._bucket)
        return self

    def __exit__(self, *exc):
        self._ledger.switch(self._restore)
        # wall duration of the WHOLE spend (nested inner spends included) —
        # the switch return value would only be the tail interval
        self.duration_s = self._ledger._clock() - self._entered_at
        return False


# -- step stats / MFU ----------------------------------------------------------

class StepStats:
    """Per-step wall time -> tokens/sec and achieved-vs-peak MFU.

    MFU uses the 6N model-FLOPs-per-token rule (fwd+bwd) over the
    per-generation bf16 peak table — the same roofline bench.py reports
    against, so a live run's ``mfu_ratio`` gauge and the bench's offline
    number are directly comparable.
    """

    def __init__(self, tokens_per_step: int, model_params: int = 0,
                 n_chips: int = 1, accelerator_type: str = "",
                 peak_tflops: Optional[float] = None, window: int = 32):
        self.tokens_per_step = tokens_per_step
        self.model_params = model_params
        self.n_chips = max(1, n_chips)
        self.peak_tflops = (peak_tflops if peak_tflops is not None
                            else peak_tflops_per_chip(accelerator_type))
        self._window = max(1, window)
        self._recent: list[float] = []   # step wall times, newest last
        self.last_step = -1
        self.last_step_s = 0.0
        self.count = 0

    def record(self, step: int, step_time_s: float):
        self.last_step = step
        self.last_step_s = step_time_s
        self.count += 1
        self._recent.append(step_time_s)
        if len(self._recent) > self._window:
            del self._recent[:-self._window]

    @property
    def mean_step_s(self) -> float:
        return sum(self._recent) / len(self._recent) if self._recent else 0.0

    @property
    def median_step_s(self) -> float:
        if not self._recent:
            return 0.0
        vals = sorted(self._recent)
        return vals[len(vals) // 2]

    @property
    def tokens_per_sec(self) -> float:
        mean = self.mean_step_s
        return self.tokens_per_step / mean if mean > 0 else 0.0

    @property
    def mfu(self) -> float:
        """achieved model FLOPs / peak FLOPs, per chip (0 when unknowable)."""
        if not (self.model_params and self.peak_tflops):
            return 0.0
        tok_s_chip = self.tokens_per_sec / self.n_chips
        return (6.0 * self.model_params * tok_s_chip) / (self.peak_tflops * 1e12)

    def summary(self) -> dict:
        return {"step": self.last_step, "steps_recorded": self.count,
                "step_time_s": round(self.last_step_s, 6),
                "mean_step_s": round(self.mean_step_s, 6),
                "tokens_per_sec": round(self.tokens_per_sec, 3),
                "mfu": round(self.mfu, 6)}


# -- straggler / stall watchdog ------------------------------------------------

class StragglerWatchdog:
    """Flags hosts whose step counter stops advancing (stall) or whose step
    time exceeds ``straggler_factor`` x the median across hosts (slow).

    Worker-0 feeds it: its own steps directly, peers' via the heartbeat line
    protocol (``ingest``). ``check()`` returns only NEWLY-flagged events —
    a host stays flagged (no re-emission) until it recovers, so one stall
    episode is one ``training.straggler`` span, not one per sweep.
    """

    def __init__(self, num_hosts: int, straggler_factor: float = 3.0,
                 stall_timeout_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 window: int = 8):
        self.num_hosts = max(1, num_hosts)
        self.straggler_factor = straggler_factor
        self.stall_timeout_s = stall_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._window = max(1, window)
        self._started_at = clock()
        # the stall clock for never-reported hosts starts at the FIRST
        # heartbeat from ANY host — while nobody has reported the gang is
        # still compiling (first-step XLA compile routinely exceeds any
        # sane stall timeout) and flagging every host would be noise
        self._first_observed_at: Optional[float] = None
        # host -> (last step, time of last ADVANCE, recent step times)
        self._step: dict[int, int] = {}
        self._advanced_at: dict[int, float] = {}
        self._times: dict[int, list[float]] = {}
        self._flagged: dict[int, str] = {}   # host -> kind, while in episode

    def observe(self, host: int, step: int, step_time_s: float = 0.0,
                now: Optional[float] = None):
        now = self._clock() if now is None else now
        with self._lock:
            if self._first_observed_at is None:
                self._first_observed_at = now
            if step > self._step.get(host, -1):
                self._step[host] = step
                self._advanced_at[host] = now
            if step_time_s > 0:
                ts = self._times.setdefault(host, [])
                ts.append(step_time_s)
                if len(ts) > self._window:
                    del ts[:-self._window]

    def ingest(self, line: str, now: Optional[float] = None) -> bool:
        """Feed one heartbeat-protocol line (POST /heartbeat body, or a log
        line); returns True when it parsed."""
        parsed = parse_heartbeat(line)
        if parsed is None:
            return False
        host, step, step_time_s = parsed
        self.observe(host, step, step_time_s, now=now)
        return True

    def _peer_median_step_s(self, host: int) -> float:
        """Median of the OTHER hosts' mean step times. Excluding the
        candidate keeps a 2-host gang's slow member from being half its own
        median (which made 'slow' structurally unflaggable there)."""
        means = sorted(sum(ts) / len(ts)
                       for h, ts in self._times.items() if ts and h != host)
        if not means:
            return 0.0
        n = len(means)
        if n % 2:
            return means[n // 2]
        return (means[n // 2 - 1] + means[n // 2]) / 2.0

    def check(self, now: Optional[float] = None) -> list[dict]:
        """Newly-flagged straggler events. A host that has NEVER reported
        counts as stalled once the timeout passes from the gang's first
        heartbeat — a dead host must not be invisible just because it said
        nothing, but nobody is flagged while the whole gang is still
        compiling (no heartbeats at all yet)."""
        now = self._clock() if now is None else now
        events: list[dict] = []
        with self._lock:
            if self._first_observed_at is None:
                return []
            for host in range(self.num_hosts):
                since = self._advanced_at.get(host, self._first_observed_at)
                lag = now - since
                times = self._times.get(host, [])
                mean = sum(times) / len(times) if times else 0.0
                median = self._peer_median_step_s(host)
                kind = ""
                if lag > self.stall_timeout_s:
                    kind = "stall"
                elif (median > 0 and mean > self.straggler_factor * median
                      and len(times) >= 2):
                    kind = "slow"
                if kind:
                    if self._flagged.get(host) != kind:
                        self._flagged[host] = kind
                        events.append({
                            "host": host, "kind": kind,
                            "last_step": self._step.get(host, -1),
                            "lag_s": round(lag, 3),
                            "step_time_s": round(mean, 6),
                            "median_step_s": round(median, 6)})
                else:
                    self._flagged.pop(host, None)
        return events

    @property
    def flagged(self) -> dict[int, str]:
        with self._lock:
            return dict(self._flagged)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Per-host table for /debug/train and the training.run span."""
        now = self._clock() if now is None else now
        with self._lock:
            out = {}
            for host in range(self.num_hosts):
                times = self._times.get(host, [])
                out[str(host)] = {
                    "step": self._step.get(host, -1),
                    "age_s": round(now - self._advanced_at.get(
                        host, self._started_at), 3),
                    "mean_step_s": round(sum(times) / len(times), 6)
                    if times else 0.0,
                    "flagged": self._flagged.get(host, ""),
                }
            return out


# -- restart-attribution state -------------------------------------------------

STATE_FILE = "goodput_state.json"


def state_path_for(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, STATE_FILE) if checkpoint_dir else ""


def write_state(path: str, *, step: int, unsaved_work_s: float, ts: float,
                attempt: int = 0, resize: int = 0):
    """Atomically persist the running attempt's exposure: how much work
    would be lost if it died right now (productive seconds since the last
    durable checkpoint) plus a wall timestamp for downtime accounting.
    ``attempt``/``resize`` record WHICH launch wrote the state (the requeue
    count and the elastic-resize count), so the next launch can attribute
    the loss to the right cause: ``restart_lost`` for a full requeue,
    ``resize`` for an elastic shrink/grow relaunch."""
    if not path:
        return
    payload = {"step": step, "unsaved_work_s": round(unsaved_work_s, 6),
               "ts": ts, "attempt": attempt, "resize": resize}
    tmp = f"{path}.tmp.{os.getpid()}"  # never share a staging file
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_state(path: str) -> Optional[dict]:
    """The raw persisted exposure record, or None when unreadable."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            prev = json.load(f)
        return prev if isinstance(prev, dict) else None
    except (OSError, ValueError):
        return None


def read_lost_state(path: str, now: float) -> tuple[float, int]:
    """(lost seconds, prior step) a restarting attempt should charge to
    ``restart_lost``: the prior attempt's unsaved work plus the downtime
    between its last state write and now. (0.0, -1) when unknowable."""
    prev = read_state(path)
    if prev is None:
        return 0.0, -1
    try:
        unsaved = max(0.0, float(prev.get("unsaved_work_s", 0.0)))
        downtime = max(0.0, now - float(prev.get("ts", now)))
        return unsaved + downtime, int(prev.get("step", -1))
    except (ValueError, TypeError):
        return 0.0, -1


# -- async heartbeat poster ----------------------------------------------------

class HeartbeatPoster:
    """Best-effort POST of heartbeat lines to worker-0's telemetry server.

    Same shape as the Tracer's export writer: the step loop pays a bounded
    queue put, never a network round-trip; a dead/slow aggregator drops
    beats (counted) instead of stalling training — the watchdog treats a
    silent host as stalled, which is the correct failure reading anyway.
    """

    def __init__(self, address: str, timeout_s: float = 2.0):
        import queue
        self.url = f"http://{address}/heartbeat"
        self.timeout_s = timeout_s
        self.dropped = 0
        self._q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=256)
        self._thread = threading.Thread(target=self._drain,
                                        name="heartbeat-poster", daemon=True)
        self._thread.start()

    def __call__(self, line: str):
        import queue
        try:
            self._q.put_nowait(line)
        except queue.Full:
            self.dropped += 1

    def _drain(self):
        import urllib.request
        while True:
            line = self._q.get()
            if line is None:
                return
            try:
                req = urllib.request.Request(
                    self.url, data=line.encode(),
                    headers={"Content-Type": "text/plain"})
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    pass
            except Exception as e:  # noqa: BLE001 — must never kill a step
                self.dropped += 1
                log.debug("heartbeat POST to %s failed (dropped %d): %s",
                          self.url, self.dropped, e)

    def close(self):
        import queue
        try:
            self._q.put(None, timeout=1.0)
        except queue.Full:
            log.debug("heartbeat queue full at close — abandoning the "
                      "writer after the bounded join")
        self._thread.join(timeout=2.0)


# -- the bundle Trainer feeds --------------------------------------------------

class TrainingTelemetry:
    """Everything one training process records, behind four hooks:
    ``run_started`` / ``record_step`` / ``checkpoint(kind)`` /
    ``run_finished``. Owns the ledger (driving its bucket switches so
    callers can't leave a bucket dangling), the step stats, worker-0's
    watchdog, and the metric/span emission.

    ``emit_line`` receives the protocol lines (heartbeats every step,
    a TPU_TELEMETRY state line every ``telemetry_every`` steps); train_main
    points it at stderr + the worker-0 POSTer, tests capture it.
    """

    def __init__(self, *, tokens_per_step: int, model_params: int = 0,
                 n_chips: int = 1, accelerator_type: str = "",
                 num_hosts: int = 1, host_id: int = 0,
                 metrics=None, tracer=None,
                 clock: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic,
                 straggler_factor: float = 3.0,
                 stall_timeout_s: float = 120.0,
                 attempt: int = 0, resize_attempt: int = 0,
                 dp_width: int = 0, state_path: str = "",
                 telemetry_every: int = 1, state_interval_s: float = 10.0,
                 emit_line: Optional[Callable[[str], None]] = None):
        self.metrics = metrics
        self.tracer = tracer
        self.clock = clock
        self.host_id = host_id
        self.num_hosts = max(1, num_hosts)
        self.attempt = attempt
        # elastic gang training: resize_attempt is the kubelet's
        # cumulative shrink/grow count (TPU_ELASTIC_RESIZE); dp_width is the
        # current data-parallel width, surfaced on the TPU_TELEMETRY line so
        # the kubelet and goodput_summary can render the resize timeline
        self.resize_attempt = resize_attempt
        self.dp_width = dp_width
        # ONLY worker-0 owns the restart-attribution state: the checkpoint
        # dir is shared across hosts (orbax requires it), and N hosts
        # rewriting one goodput_state.json every step would race — worker-0's
        # view is canonical for the whole gang anyway
        self.state_path = state_path if host_id == 0 else ""
        self.telemetry_every = max(1, telemetry_every)
        # exposure persistence is throttled: a per-step synchronous write
        # would put a (possibly GCS-fuse) filesystem round-trip inside the
        # device-synced hot loop this module exists to time. Downtime is
        # part of the restart charge regardless, so coarse granularity only
        # under-counts by < state_interval_s of unsaved work.
        self.state_interval_s = state_interval_s
        self._state_written_at: Optional[float] = None
        self.emit_line = emit_line
        self.trace_id = tracer.new_trace_id() if tracer is not None else ""
        self.ledger = GoodputLedger(clock=mono, start_bucket="idle")
        self.stats = StepStats(tokens_per_step=tokens_per_step,
                               model_params=model_params, n_chips=n_chips,
                               accelerator_type=accelerator_type)
        # worker-0 aggregates the gang; peers carry a watchdog of size 0
        self.watchdog = (StragglerWatchdog(
            num_hosts, straggler_factor=straggler_factor,
            stall_timeout_s=stall_timeout_s, clock=mono)
            if host_id == 0 else None)
        self.straggler_events = 0
        self._lock = threading.Lock()
        self._productive_at_ckpt = 0.0    # ledger's productive total then
        # an async-STAGED save: (step, productive total at staging). The
        # exposure baseline only moves when the background write is durable
        # (checkpoint_durable, called from Trainer.wait_pending) — resetting
        # at staging would under-count restart_lost for a preemption landing
        # while the write is still in flight.
        self._staged_ckpt: Optional[tuple[int, float]] = None
        self._exported_lost: dict[str, float] = {}
        self.restart_lost_s = 0.0
        self.resize_lost_s = 0.0
        self.resumed_from_step = -1
        if (attempt > 0 or resize_attempt > 0) and state_path:
            # ONE read: the lost amount and the (attempt, resize) pair used
            # to attribute it must come from the same state version — a
            # second read could race a writer and mix versions
            prev = read_state(state_path) or {}
            now = clock()
            try:
                unsaved = max(0.0, float(prev.get("unsaved_work_s", 0.0)))
                lost = unsaved + max(0.0, now - float(prev.get("ts", now)))
                prev_step = int(prev.get("step", -1))
            except (ValueError, TypeError):
                lost, prev_step = 0.0, -1
            if lost > 0:
                # Attribute the prior launch's unsaved work + downtime to the
                # cause of THIS relaunch. A bumped requeue attempt means a
                # full restart (restart_lost); an unchanged attempt with a
                # bumped resize count means the kubelet shrank/grew the gang
                # (the new exclusive `resize` bucket) — so elastic downtime
                # never double-charges restart_lost (the A/B the soak runs).
                prev_attempt = int(prev.get("attempt", 0) or 0)
                prev_resize = int(prev.get("resize", 0) or 0)
                if attempt <= prev_attempt and resize_attempt > prev_resize:
                    self.ledger.charge("resize", lost)
                    self.resize_lost_s = lost
                else:
                    self.ledger.charge("restart_lost", lost)
                    self.restart_lost_s = lost
                self.resumed_from_step = prev_step
        if metrics is not None:
            self._describe(metrics)
            if dp_width:
                metrics.set_gauge("tpu_training_resize_dp_width",
                                  float(dp_width) if resize_attempt else 0.0)

    @staticmethod
    def _describe(m):
        m.describe("tpu_training_step_seconds",
                   "optimizer-step wall time (device-synced)",
                   buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
                            10, 30, 60))
        m.describe("tpu_training_tokens_per_second",
                   "training throughput over the recent step window")
        m.describe("tpu_training_mfu_ratio",
                   "achieved model FLOPs / bf16 peak (6N rule, per chip)")
        m.describe("tpu_training_goodput_ratio",
                   "productive seconds / wall seconds (goodput ledger)")
        m.describe("tpu_training_lost_seconds",
                   "non-productive wall seconds by cause (ledger buckets)")
        m.describe("tpu_training_last_step",
                   "last completed optimizer step")
        m.describe("tpu_training_checkpoint_seconds",
                   "blocking checkpoint save/restore time (kind label)")
        m.describe("tpu_training_straggler_events",
                   "hosts newly flagged stalled/slow by the watchdog")
        m.describe("tpu_training_resize_events",
                   "elastic gang resizes seen by this process (kind label: "
                   "shrink/grow)")
        m.describe("tpu_training_resize_seconds",
                   "wall time spent rebuilding the mesh + resharding state "
                   "for an elastic resize",
                   buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300))
        m.describe("tpu_training_resize_dp_width",
                   "current data-parallel width after the last elastic "
                   "resize (0 = never resized)")

    # -- hooks (called by Trainer / train_main) --------------------------------

    def run_started(self, step: int = 0, compiled: bool = False):
        """Loop entered: time accrues to ``compile`` until the first step
        completes (first step = trace+compile), or straight to
        ``productive`` when this process already compiled (bench re-runs)."""
        self.ledger.switch("productive" if compiled else "compile")

    def record_step(self, step: int, step_time_s: float,
                    loss: Optional[float] = None):
        """One optimizer step completed. Closes the open ledger interval
        into whatever phase it was (compile for the first step, productive
        after), records stats/metrics/spans, emits the heartbeat line, and
        runs the straggler sweep on worker-0."""
        closed = self.ledger.switch("productive")
        self.stats.record(step, step_time_s)
        now = self.clock()
        if self.tracer is not None:
            attrs = {"step": step, "host": self.host_id,
                     "tokens": self.stats.tokens_per_step}
            if loss is not None:
                attrs["loss"] = round(loss, 6)
            self.tracer.record("training.step", now - step_time_s, now,
                               trace_id=self.trace_id, attrs=attrs)
        if self.metrics is not None:
            self.metrics.observe("tpu_training_step_seconds", step_time_s)
            self.metrics.set_gauge("tpu_training_tokens_per_second",
                                   self.stats.tokens_per_sec)
            self.metrics.set_gauge("tpu_training_mfu_ratio", self.stats.mfu)
            self.metrics.set_gauge("tpu_training_goodput_ratio",
                                   self.ledger.goodput)
            self.metrics.set_gauge("tpu_training_last_step", float(step))
            self._export_lost()
        if self.emit_line is not None:
            self.emit_line(format_heartbeat(self.host_id, step, step_time_s))
            if step % self.telemetry_every == 0:
                self.emit_line(format_telemetry(self.telemetry_payload()))
        if self.watchdog is not None:
            self.watchdog.observe(self.host_id, step, step_time_s)
            self.check_stragglers()
        if self.state_path:
            mono_now = self.ledger._clock()
            if (self._state_written_at is None
                    or mono_now - self._state_written_at
                    >= self.state_interval_s):
                with self._lock:
                    unsaved = (self.ledger.total("productive")
                               - self._productive_at_ckpt)
                try:
                    write_state(self.state_path, step=step,
                                unsaved_work_s=max(0.0, unsaved), ts=now,
                                attempt=self.attempt,
                                resize=self.resize_attempt)
                    self._state_written_at = mono_now
                except OSError:
                    pass  # read-only checkpoint volume must not kill training
        return closed

    def checkpoint(self, kind: str = "save", step: Optional[int] = None,
                   durable: bool = True):
        """Context manager around a save/restore: charges the
        ``checkpoint_save``/``checkpoint_restore`` bucket, records the
        ``training.checkpoint`` / ``training.restore`` span + histogram.
        ``durable=True`` saves reset the unsaved-work exposure marker;
        ``durable=False`` (async-staged) saves only note the staging point
        — the reset waits for ``checkpoint_durable()``."""
        return _CheckpointSpan(self, kind, step, durable)

    def checkpoint_durable(self):
        """An async-staged save's background write finished (the caller's
        wait-until-finished boundary): move the exposure baseline to the
        STAGING point — steps run while the write was in flight are not in
        the checkpoint and stay exposed."""
        with self._lock:
            staged = self._staged_ckpt
            self._staged_ckpt = None
            if staged is None:
                return
            step, productive_at_stage = staged
            self._productive_at_ckpt = productive_at_stage
            unsaved = self.ledger.total("productive") - productive_at_stage
        if self.state_path:
            try:
                write_state(self.state_path, step=step,
                            unsaved_work_s=max(0.0, unsaved), ts=self.clock(),
                            attempt=self.attempt, resize=self.resize_attempt)
                self._state_written_at = self.ledger._clock()
            except OSError:
                log.debug("state write at durable boundary failed")

    def resize(self, kind: str, *, old_width: int, new_width: int,
               step: Optional[int] = None):
        """Context manager around an IN-PROCESS elastic resize (mesh rebuild
        + reshard-restore): charges the exclusive ``resize`` ledger bucket,
        records a ``training.resize`` span (kind=shrink/grow, old/new DP
        width) and the ``tpu_training_resize_*`` metrics, and updates the
        advertised ``dp_width``. A kubelet-driven resize RELAUNCH instead
        charges the bucket at boot via ``resize_attempt`` (see __init__)."""
        if kind not in ("shrink", "grow"):
            raise ValueError(f"resize kind must be shrink/grow, not {kind!r}")
        return _ResizeSpan(self, kind, old_width, new_width, step)

    def ingest_heartbeat(self, body: str):
        """POST /heartbeat sink (worker-0): one or more protocol lines."""
        if self.watchdog is None:
            return
        for line in body.splitlines():
            if line.strip():
                self.watchdog.ingest(line)

    def check_stragglers(self, now: Optional[float] = None) -> list[dict]:
        """Run the watchdog sweep (worker-0): emit a ``training.straggler``
        span + structured log line + counter per newly-flagged host, and
        reattribute ledger time to ``stalled`` while any host is flagged."""
        if self.watchdog is None:
            return []
        events = self.watchdog.check(now=now)
        for ev in events:
            self.straggler_events += 1
            wall = self.clock()
            if self.tracer is not None:
                self.tracer.record("training.straggler", wall, wall,
                                   trace_id=self.trace_id,
                                   attrs=dict(ev))
            if self.metrics is not None:
                self.metrics.incr("tpu_training_straggler_events",
                                  labels={"host": str(ev["host"]),
                                          "kind": ev["kind"]})
            if self.emit_line is not None:
                self.emit_line(
                    f"TPU_STRAGGLER host={ev['host']} kind={ev['kind']} "
                    f"last_step={ev['last_step']} lag_s={ev['lag_s']}")
        flagged = self.watchdog.flagged
        if flagged and self.ledger.open_bucket == "productive":
            self.ledger.switch("stalled")
        elif not flagged and self.ledger.open_bucket == "stalled":
            self.ledger.switch("productive")
        return events

    def run_finished(self, extra: Optional[dict] = None) -> dict:
        """Loop exited: close into ``idle``, emit the ``training.run`` span
        carrying the full ledger snapshot (the goodput report's source of
        truth — tools/goodput_summary.py renders it), and return the
        summary fields callers merge into their result dict."""
        self.ledger.switch("idle")
        snap = self.snapshot()
        if self.metrics is not None:
            self.metrics.set_gauge("tpu_training_goodput_ratio",
                                   snap["goodput"])
            self._export_lost()
        if self.tracer is not None:
            attrs = {"attempt": self.attempt, "goodput": snap["goodput"],
                     "mfu": snap["mfu"], "wall_s": snap["wall_s"],
                     "step": snap["step"],
                     "tokens_per_sec": snap["tokens_per_sec"],
                     "buckets": snap["buckets"]}
            if self.dp_width:
                attrs["dp_width"] = self.dp_width
            if self.resize_attempt:
                attrs["resize"] = self.resize_attempt
            if self.watchdog is not None:
                attrs["hosts"] = self.watchdog.snapshot()
            if extra:
                attrs.update(extra)
            self.tracer.record("training.run", self.clock() - snap["wall_s"],
                               self.clock(), trace_id=self.trace_id,
                               attrs=attrs)
        if self.emit_line is not None:
            self.emit_line(format_telemetry(self.telemetry_payload()))
        return {"goodput": snap["goodput"], "mfu": snap["mfu"],
                "lost_s": snap["lost_s"]}

    # -- views -----------------------------------------------------------------

    def _export_lost(self):
        """Counter semantics over the monotone ledger totals: incr deltas
        since the last export, per cause."""
        snap = self.ledger.snapshot()
        for cause, total in snap["buckets"].items():
            if cause == "productive" or total <= 0:
                continue
            prev = self._exported_lost.get(cause, 0.0)
            if total > prev:
                self.metrics.incr("tpu_training_lost_seconds", total - prev,
                                  labels={"cause": cause})
                self._exported_lost[cause] = total

    def telemetry_payload(self) -> dict:
        """The compact TPU_TELEMETRY line body (kubelet scrape surface)."""
        s = self.stats
        out = {"step": s.last_step, "tokens_per_sec": round(s.tokens_per_sec, 3),
               "mfu": round(s.mfu, 6), "goodput": round(self.ledger.goodput, 6),
               "attempt": self.attempt, "host": self.host_id,
               "stalled": bool(self.watchdog.flagged)
               if self.watchdog is not None else False}
        # preemption-cost exposure: productive seconds since
        # the last DURABLE checkpoint — what a preemption right now would
        # destroy. Same number the crash-recovery state file records; the
        # kubelet's scrape feeds it to the fleet scheduler, which evicts
        # best-effort gangs lowest-loss-first.
        with self._lock:
            unsaved = (self.ledger.total("productive")
                       - self._productive_at_ckpt)
        out["unsaved_work_s"] = round(max(0.0, unsaved), 3)
        if self.dp_width:
            out["dp_width"] = self.dp_width
        if self.resize_attempt:
            out["resize"] = self.resize_attempt
        return out

    def snapshot(self) -> dict:
        """The /debug/train statusz payload."""
        led = self.ledger.snapshot()
        out = {"step": self.stats.last_step,
               "tokens_per_sec": round(self.stats.tokens_per_sec, 3),
               "mfu": round(self.stats.mfu, 6),
               "step_time_s": round(self.stats.last_step_s, 6),
               "mean_step_s": round(self.stats.mean_step_s, 6),
               "goodput": led["goodput"], "wall_s": led["wall_s"],
               "buckets": led["buckets"], "lost_s": led["lost_s"],
               "attempt": self.attempt, "host": self.host_id,
               "num_hosts": self.num_hosts,
               "restart_lost_s": round(self.restart_lost_s, 6),
               "resize_lost_s": round(self.resize_lost_s, 6),
               "resize_attempt": self.resize_attempt,
               "dp_width": self.dp_width,
               "straggler_events": self.straggler_events}
        if self.watchdog is not None:
            out["hosts"] = self.watchdog.snapshot()
            out["stalled_hosts"] = sorted(self.watchdog.flagged)
        return out


class _ResizeSpan:
    def __init__(self, tel: TrainingTelemetry, kind: str, old_width: int,
                 new_width: int, step: Optional[int]):
        self._tel = tel
        self._kind = kind
        self._old = old_width
        self._new = new_width
        self._step = step
        self.duration_s = 0.0

    def __enter__(self) -> "_ResizeSpan":
        self._spend = self._tel.ledger.spend("resize")
        self._spend.__enter__()
        self._start_wall = self._tel.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._spend.__exit__(exc_type, exc, tb)
        self.duration_s = self._spend.duration_s
        tel = self._tel
        step = self._step if self._step is not None else tel.stats.last_step
        if exc_type is None:
            tel.resize_attempt += 1
            tel.dp_width = self._new
            # the new width changes tokens-per-chip math only through the
            # caller's batch rescale; stats keep their tokens_per_step, which
            # the caller updates when the global batch changed
        attrs = {"kind": self._kind, "old_width": self._old,
                 "new_width": self._new, "step": step,
                 "resize": tel.resize_attempt}
        if exc_type is not None:
            attrs["error"] = exc_type.__name__
        if tel.tracer is not None:
            tel.tracer.record("training.resize", self._start_wall,
                              self._start_wall + self.duration_s,
                              trace_id=tel.trace_id, attrs=attrs)
        if tel.metrics is not None:
            tel.metrics.incr("tpu_training_resize_events",
                             labels={"kind": self._kind})
            tel.metrics.observe("tpu_training_resize_seconds", self.duration_s)
            if exc_type is None:
                # a FAILED resize never reached the new width — the gauge
                # must keep advertising the width the gang actually runs at
                tel.metrics.set_gauge("tpu_training_resize_dp_width",
                                      float(self._new))
        return False


class _CheckpointSpan:
    def __init__(self, tel: TrainingTelemetry, kind: str, step: Optional[int],
                 durable: bool = True):
        if kind not in ("save", "restore"):
            raise ValueError(f"checkpoint kind must be save/restore, not {kind!r}")
        self._tel = tel
        self._kind = kind
        self._step = step
        self._durable = durable
        self.duration_s = 0.0

    def __enter__(self) -> "_CheckpointSpan":
        self._spend = self._tel.ledger.spend(f"checkpoint_{self._kind}")
        self._spend.__enter__()
        self._start_wall = self._tel.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._spend.__exit__(exc_type, exc, tb)
        self.duration_s = self._spend.duration_s
        tel = self._tel
        step = self._step if self._step is not None else tel.stats.last_step
        if self._kind == "save" and exc_type is None:
            if self._durable:
                # durable checkpoint: exposure (work lost if we die now)
                # resets — in memory AND in the persisted state, so a
                # process that dies right after its final save doesn't
                # charge the next attempt for work that is durable
                with tel._lock:
                    tel._productive_at_ckpt = tel.ledger.total("productive")
                    tel._staged_ckpt = None  # superseded
                if tel.state_path:
                    try:
                        write_state(tel.state_path, step=step,
                                    unsaved_work_s=0.0, ts=tel.clock(),
                                    attempt=tel.attempt,
                                    resize=tel.resize_attempt)
                        tel._state_written_at = tel.ledger._clock()
                    except OSError:
                        log.debug("state write after save failed (stale "
                                  "unsaved_work_s until next step)")
            else:
                # async-staged: NOT durable yet — remember the staging
                # point; checkpoint_durable() moves the baseline there once
                # the caller's wait-until-finished boundary passes
                with tel._lock:
                    tel._staged_ckpt = (step,
                                        tel.ledger.total("productive"))
        if tel.tracer is not None:
            name = ("training.checkpoint" if self._kind == "save"
                    else "training.restore")
            attrs = {"step": step, "kind": self._kind}
            if exc_type is not None:
                attrs["error"] = exc_type.__name__
            tel.tracer.record(name, self._start_wall,
                              self._start_wall + self.duration_s,
                              trace_id=tel.trace_id, attrs=attrs)
        if tel.metrics is not None:
            tel.metrics.observe("tpu_training_checkpoint_seconds",
                                self.duration_s,
                                labels={"kind": self._kind})
        return False
