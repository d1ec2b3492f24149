"""Per-request card-second metering and the replica cost ledger (the
port's copy of the JAX package's ``workloads/serving/costmeter.py``;
stdlib only, like the recorder and the tracer).

``CostMeter`` turns the timings every ``Request`` already carries into
chip-seconds (card-seconds on an H100) and dollars:

- phase walls from the span-boundary stamps (queue = submitted ->
  dequeued, prefill = dequeued -> prefill_done, decode = prefill_done ->
  end), clamped monotone, so the phases telescope to wall x chips;
- KV page-seconds of arena occupancy, a trapezoid over the page count at
  prefill end and at completion (one call a request, no sampling);
- dollars through the port's own ``generations.py`` price table
  (``cost_per_chip_hr``), never a literal here.

Attribution is keyed by tenant (``Request.tenant``: the ``X-Tenant``
header, else the OpenAI ``user`` field), with at most ``MAX_TENANTS``
ledgers and the rest under ``OVERFLOW_TENANT``. Each attribution lands
three ways, as in the JAX replica: ``serving.request`` span attributes
(``span_attrs``), zero-seeded ``tpu_serving_*`` series, and the
cumulative ``snapshot`` that ``GET /debug/costs`` serves and the
reporter's heartbeat carries to the fleet registry. It must never fail a
request: the engine wraps every call.
"""

from __future__ import annotations

import threading
import time

from ...generations import cost_per_chip_hr, generation_of

# /debug/costs JSON shape; tools/cost_summary.py warns on unknown versions
COSTS_SCHEMA_VERSION = 1

# $/request lives many decades below the provisioning-latency default
# ladder; sub-cent buckets keep single-request costs distinguishable
COST_BUCKETS = (0.000001, 0.00001, 0.0001, 0.001, 0.01, 0.1, 1.0, 10.0)

# per-tenant ledger cardinality bound: adversarial/typo'd tenant strings
# must not grow the snapshot without limit. Overflow tenants aggregate
# under one bucket (their spend still counts, just not separably).
MAX_TENANTS = 64
OVERFLOW_TENANT = "~other"

# the ledger key for requests that carried no tenant
NO_TENANT = "-"

PHASES = ("queue", "prefill", "decode")


def _zero_bucket() -> dict:
    return {"requests": 0, "tokens": 0, "prompt_tokens": 0,
            "chip_seconds": {p: 0.0 for p in PHASES},
            "kv_page_seconds": 0.0, "cost_dollars": 0.0}


def _fold(bucket: dict, attribution: dict) -> None:
    bucket["requests"] += 1
    bucket["tokens"] += attribution["tokens"]
    bucket["prompt_tokens"] += attribution["prompt_tokens"]
    for p in PHASES:
        bucket["chip_seconds"][p] += attribution["chip_seconds"][p]
    bucket["kv_page_seconds"] += attribution["kv_page_seconds"]
    bucket["cost_dollars"] += attribution["cost_dollars"]


class CostMeter:
    """One per engine. ``meter_request`` is the only hot-path entry point
    (one call per COMPLETED request — never per token or per step, so the
    attribution overhead rides far under the flight-recorder 2% bar)."""

    def __init__(self, metrics, *, model: str = "", accelerator: str = "",
                 chips: int = 1, pool: str = "", clock=time.monotonic):
        self.metrics = metrics
        self.model = model
        self.generation = generation_of(accelerator)
        self.pool = pool or self.generation
        self.chips = max(1, int(chips))
        self.price_per_chip_s = cost_per_chip_hr(self.generation) / 3600.0
        self._clock = clock
        self._started_at = clock()
        self._lock = threading.Lock()
        self._total = _zero_bucket()
        self._tenants: dict[str, dict] = {}
        self._handoff_bytes = 0
        self._describe(metrics)

    @staticmethod
    def _describe(m) -> None:
        """Catalog + zero-seed every meter metric up front (the repo's
        scrape-from-zero discipline)."""
        m.describe("tpu_serving_request_cost_dollars",
                   "attributed $ per completed request (chip-seconds x "
                   "generations.py list price)", buckets=COST_BUCKETS)
        m.describe("tpu_serving_chip_seconds",
                   "attributed chip-seconds by request phase "
                   "(queue/prefill/decode; telescopes to wall x chips)")
        m.describe("tpu_serving_kv_page_seconds",
                   "KV arena occupancy attributed to requests, page-seconds")
        m.describe("tpu_serving_metered_requests",
                   "requests the cost meter attributed")
        m.describe("tpu_serving_idle_chip_seconds",
                   "paid chips x elapsed minus attributed chip-seconds "
                   "(the burn no request is paying for)")
        m.incr("tpu_serving_chip_seconds", 0, labels={"phase": "queue"})
        m.incr("tpu_serving_chip_seconds", 0, labels={"phase": "prefill"})
        m.incr("tpu_serving_chip_seconds", 0, labels={"phase": "decode"})
        m.incr("tpu_serving_kv_page_seconds", 0)
        m.incr("tpu_serving_metered_requests", 0)
        m.set_gauge("tpu_serving_idle_chip_seconds", 0.0)

    def meter_request(self, req, *, end_at: float, generated_tokens: int,
                      pages_end: int, page_tokens: int) -> dict:
        """Attribute one completed request. ``end_at`` is the engine's
        perf-clock completion stamp; ``pages_end`` is the slot's page count
        CAPTURED BEFORE release. Returns the attribution dict the caller
        folds into the serving.request span."""
        # clamp boundaries monotone so phases telescope exactly to
        # end - submitted even when a stamp was never set (failed prefill
        # leaves prefill_done_at = 0)
        b0 = req.submitted_at
        b1 = max(b0, req.dequeued_at or b0)
        b2 = max(b1, req.prefill_done_at or b1)
        b3 = max(b2, end_at)
        walls = {"queue": b1 - b0, "prefill": b2 - b1, "decode": b3 - b2}
        chip_seconds = {p: w * self.chips for p, w in walls.items()}
        page_tokens = max(1, int(page_tokens))
        pages_prefill = -(-len(req.prompt) // page_tokens)  # ceil div
        if pages_end <= 0:
            pages_end = pages_prefill
        kv_page_seconds = (pages_prefill * walls["prefill"]
                           + (pages_prefill + pages_end) / 2.0
                           * walls["decode"])
        cost = sum(chip_seconds.values()) * self.price_per_chip_s
        tenant = req.tenant or NO_TENANT
        attribution = {
            "tenant": tenant,
            "tokens": int(generated_tokens),
            "prompt_tokens": len(req.prompt),
            "chip_seconds": chip_seconds,
            "kv_page_seconds": kv_page_seconds,
            "cost_dollars": cost,
        }
        with self._lock:
            _fold(self._total, attribution)
            if tenant not in self._tenants and len(self._tenants) >= MAX_TENANTS:
                tenant = OVERFLOW_TENANT
            bucket = self._tenants.setdefault(tenant, _zero_bucket())
            _fold(bucket, attribution)
            idle = self._idle_locked()
        m = self.metrics
        m.observe("tpu_serving_request_cost_dollars", cost,
                  exemplar=req.trace_id or None)
        m.incr("tpu_serving_chip_seconds", chip_seconds["queue"],
               labels={"phase": "queue"})
        m.incr("tpu_serving_chip_seconds", chip_seconds["prefill"],
               labels={"phase": "prefill"})
        m.incr("tpu_serving_chip_seconds", chip_seconds["decode"],
               labels={"phase": "decode"})
        m.incr("tpu_serving_kv_page_seconds", kv_page_seconds)
        m.incr("tpu_serving_metered_requests")
        m.set_gauge("tpu_serving_idle_chip_seconds", idle)
        return attribution

    def note_handoff_bytes(self, nbytes: int) -> None:
        """KV handoff traffic attributed to this replica (cumulative)."""
        with self._lock:
            self._handoff_bytes += int(nbytes)

    def _idle_locked(self) -> float:
        paid = self.chips * max(0.0, self._clock() - self._started_at)
        attributed = sum(self._total["chip_seconds"].values())
        return max(0.0, paid - attributed)

    def span_attrs(self, attribution: dict) -> dict:
        """Flatten an attribution into serving.request span attrs."""
        cs = attribution["chip_seconds"]
        return {
            "cost_dollars": round(attribution["cost_dollars"], 9),
            "chip_seconds_queue": round(cs["queue"], 6),
            "chip_seconds_prefill": round(cs["prefill"], 6),
            "chip_seconds_decode": round(cs["decode"], 6),
            "kv_page_seconds": round(attribution["kv_page_seconds"], 6),
            "tenant": attribution["tenant"],
        }

    def snapshot(self) -> dict:
        """Cumulative replica ledger — rides every fleet heartbeat
        (idempotent, restart-guarded registry-side) and serves
        /debug/costs on the replica."""
        with self._lock:
            elapsed = max(0.0, self._clock() - self._started_at)
            return {
                "schema_version": COSTS_SCHEMA_VERSION,
                "model": self.model,
                "pool": self.pool,
                "generation": self.generation,
                "chips": self.chips,
                "price_per_chip_hr": round(self.price_per_chip_s * 3600.0, 6),
                "elapsed_s": round(elapsed, 3),
                "paid_chip_seconds": round(self.chips * elapsed, 3),
                "idle_chip_seconds": round(self._idle_locked(), 3),
                "handoff_bytes": self._handoff_bytes,
                "totals": _round_bucket(self._total),
                "tenants": {t: _round_bucket(b)
                            for t, b in sorted(self._tenants.items())},
            }


def _round_bucket(bucket: dict) -> dict:
    return {
        "requests": bucket["requests"],
        "tokens": bucket["tokens"],
        "prompt_tokens": bucket["prompt_tokens"],
        "chip_seconds": {p: round(v, 6)
                         for p, v in bucket["chip_seconds"].items()},
        "kv_page_seconds": round(bucket["kv_page_seconds"], 6),
        "cost_dollars": round(bucket["cost_dollars"], 9),
    }
