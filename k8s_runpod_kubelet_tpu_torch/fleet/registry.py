"""The replica side of fleet membership (the port's copy of the JAX
package's ``fleet/registry.py`` ``ReplicaReporter`` and the roles it
registers). Stdlib only.

A torch replica registers with the fleet router (the JAX package's
``fleet/router_main.py``, which is framework-free) under its role —
unified, or prefill or decode for disaggregated serving, where the router
plans two-hop routes once both pools have a ready member — and its
placement domain (equal domains hand KV pages without the wire),
heartbeats the load stats the router routes on and the autoscaler scales
on, all computed from the engine's ``debug_snapshot()`` and ``metrics``,
carries its cumulative ``Metrics.snapshot()`` and its pending
prefix-directory publishes on every beat (a failed beat re-queues the
publishes), and deregisters once a drain completes. The heartbeat payload
has the JAX reporter's keys, so the router reads a torch replica as it
reads a JAX one, and its ``costs`` (the engine's ``CostMeter`` ledger,
absent with the meter off) are folded into the router's fleet-wide
``/debug/costs`` as a JAX replica's are.
"""

from __future__ import annotations

import logging
import threading
import urllib.request

log = logging.getLogger(__name__)

# the disaggregated-serving pools a replica registers into: unified
# prefills and decodes its own requests (and is the fallback of a failed
# two-hop route); prefill computes KV and hands pages off (/kv_prefill);
# decode adopts them and streams tokens
UNIFIED = "unified"
PREFILL = "prefill"
DECODE = "decode"
ROLES = (UNIFIED, PREFILL, DECODE)


class ReplicaReporter:
    """Replica-side fleet client: register on start, heartbeat on an
    interval with stats from the engine's own debug/metrics surfaces,
    deregister when the drain completes.

    Runs in serve_main when ``--fleet-router`` is set. ``post_fn(path,
    payload) -> dict|None`` is injectable for tests; the default POSTs
    JSON to the router. A router restart answers heartbeats with
    ``registered: false`` and the reporter re-registers — membership
    self-heals without operator action."""

    def __init__(self, engine, router_url: str, replica_id: str,
                 advertise_url: str, pod_name: str = "",
                 interval_s: float = 2.0, post_fn=None,
                 role: str = UNIFIED, placement_domain: str = "",
                 generation: str = "", pool: str = ""):
        if (role or UNIFIED) not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.engine = engine
        self.router_url = router_url.rstrip("/")
        self.replica_id = replica_id
        self.advertise_url = advertise_url
        self.pod_name = pod_name
        self.role = role or UNIFIED
        # the device-transfer co-location claim; "" = wire only
        self.placement_domain = placement_domain
        # mixed-fleet identity: from TPU_SERVING_GENERATION /
        # TPU_SERVING_POOL stamped by the scheduler-aware pod scaler
        self.generation = generation
        self.pool = pool
        self.interval_s = interval_s
        self._post = post_fn or self._http_post
        self._stop = threading.Event()
        # prefix-directory publish wake: the engine's
        # prefix_publish_hook sets this so a fresh trie insert reaches
        # the directory on the NEXT beat, not up to one interval later
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-reporter", daemon=True)

    def wake(self):
        """Engine-side publish hook target: schedule an early beat."""
        self._wake.set()

    def _http_post(self, path: str, payload: dict):
        import json as _json
        req = urllib.request.Request(
            self.router_url + path, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            raw = resp.read()
            return _json.loads(raw) if raw else None

    def stats(self) -> dict:
        """The heartbeat payload, from surfaces the engine already exports
        (debug_snapshot + the TTFT histogram's recent tail)."""
        snap = self.engine.debug_snapshot()
        recent = sorted(self.engine.metrics.get_observations(
            "tpu_serving_ttft_seconds")[-100:])
        p95 = recent[max(0, int(len(recent) * 0.95) - 1)] if recent else 0.0
        # ITL p95 (recent tail, like TTFT): the DECODE pool's SLO signal —
        # long prefills inflating inter-token gaps is the interference
        # disaggregation exists to remove, so the autoscaler watches it
        itl = sorted(self.engine.metrics.get_observations(
            "tpu_serving_inter_token_seconds")[-200:])
        itl_p95 = itl[max(0, int(len(itl) * 0.95) - 1)] if itl else 0.0
        pool = snap.get("prefix_cache", {})
        # prefix-cache hit rate (paged KV pool): the per-replica
        # signal that shows whether the router's rendezvous prefix-affinity
        # is paying off — fleet_summary.py renders it per replica
        hits = self.engine.metrics.get_counter("tpu_serving_prefix_cache_hits")
        misses = self.engine.metrics.get_counter(
            "tpu_serving_prefix_cache_misses")
        hit_rate = hits / (hits + misses) if hits + misses else 0.0
        # speculative-decode acceptance: accepted/proposed draft
        # tokens — per-replica proof the proposer matches its traffic
        # (fleet_summary.py renders it next to prefix%); None when the
        # replica never proposed (speculate_k=0 or all-sampled traffic)
        spec_prop = self.engine.metrics.get_counter(
            "tpu_serving_spec_proposed")
        spec_acc = self.engine.metrics.get_counter(
            "tpu_serving_spec_accepted")
        return {
            "free_slots": snap["max_slots"] - snap["active_slots"],
            "active_slots": snap["active_slots"],
            "max_slots": snap["max_slots"],
            # pending work the ROUTER/autoscaler should see includes
            # requests mid-hop (in_transit) and prefilled-but-not-inserted
            # (ready_queue): a drain-progress check reading queue_depth==0
            # while a request is between queues would delete the pod under
            # it
            "queue_depth": (snap["queue_depth"]
                            + snap.get("in_transit", 0)
                            + snap.get("ready_queue", 0)
                            # in-flight /kv_prefill hops: a prefill-role
                            # replica's whole load lives here (handler
                            # threads, never the scheduler queue) — the
                            # router's load score and the prefill pool's
                            # queue/TTFT-burn signals must see it
                            + snap.get("handoff_inflight", 0)),
            "max_queue_depth": self.engine.sc.max_queue_depth,
            "kv_cache_tokens": snap["kv_cache_tokens"],
            "ttft_p95_s": p95,
            "itl_p95_s": itl_p95,
            # KV headroom for the decode pool's scale signal. Raw free
            # count is the WRONG number: a healthy prefix trie fills the
            # whole arena over time (pages only evict on allocation
            # pressure), so pages_free trends to ~0 at steady state and a
            # naive free/total floor would pin the pool at max. Headroom
            # = free + evictable-NOW (unpinned, trie-only-referenced
            # pages — kv_manager.stats): it only shrinks when live slots
            # and pins genuinely hold residency.
            "kv_pages_free": int(pool.get("pages_free", 0))
            + int(pool.get("pages_evictable", 0)),
            "kv_pages_total": int(pool.get("pages_total", 0)),
            "handoffs_total": snap.get("handoffs_total", 0),
            # cumulative error/request totals for the router's SLO
            # error-rate burn signal: the tracker diffs
            # successive beats, so cumulative is the right shape
            "errors_total": (
                self.engine.metrics.get_counter("tpu_serving_engine_errors")
                + self.engine.metrics.get_counter(
                    "tpu_serving_prefill_errors")),
            "requests_total": self.engine.metrics.get_counter(
                "tpu_serving_admitted"),
            # cumulative decode steps ~= tokens emitted: the scheduler's
            # serving-throughput signal
            "tokens_total": self.engine.metrics.get_counter(
                "tpu_serving_decode_steps"),
            "prefix_hit_rate": round(hit_rate, 4),
            "spec_acceptance_rate": (round(spec_acc / spec_prop, 4)
                                     if spec_prop else None),
            "draining": self.engine.draining,
        }

    def register(self):
        self._post("/fleet/register",
                   {"replica_id": self.replica_id,
                    "base_url": self.advertise_url,
                    "pod_name": self.pod_name,
                    "role": self.role,
                    "placement_domain": self.placement_domain,
                    "generation": self.generation,
                    "pool": self.pool})

    def beat_once(self) -> bool:
        """One heartbeat (re-registering if the router forgot us); returns
        False once the reporter deregistered (drain complete)."""
        if self.engine.draining and self.engine.drained:
            try:
                self._post("/fleet/deregister",
                           {"replica_id": self.replica_id})
            except Exception as e:  # noqa: BLE001 — best-effort goodbye
                log.warning("fleet: deregister failed: %s", e)
            return False
        # piggyback pending prefix-directory publishes:
        # pending-until-acked — a failed beat puts them back so the
        # directory eventually hears about every inserted run
        pubs = self.engine.take_prefix_publishes()
        body = {"replica_id": self.replica_id, "stats": self.stats()}
        if pubs:
            body["prefixes"] = pubs
        # cost attribution plane: the full metric snapshot +
        # the cost meter's ledger ride every beat. Both are CUMULATIVE —
        # re-ingesting is idempotent at the registry — so unlike
        # prefixes there is no requeue-on-failure: the next beat's
        # snapshot supersedes this one.
        try:
            body["metrics"] = self.engine.metrics.snapshot()
        except Exception:  # noqa: BLE001 — the beat itself must survive
            log.exception("fleet: metrics snapshot failed")
        costmeter = getattr(self.engine, "costmeter", None)
        if costmeter is not None:
            try:
                body["costs"] = costmeter.snapshot()
            except Exception:  # noqa: BLE001
                log.exception("fleet: cost snapshot failed")
        try:
            out = self._post("/fleet/heartbeat", body)
        except Exception:
            if pubs:
                self.engine.requeue_prefix_publishes(pubs)
            raise
        if isinstance(out, dict) and out.get("registered") is False:
            self.register()
        return True

    def _loop(self):
        while not self._stop.is_set():
            try:
                if not self.beat_once():
                    return
            except Exception as e:  # noqa: BLE001 — router may be briefly down
                log.warning("fleet: heartbeat to %s failed: %s",
                            self.router_url, e)
            # interval sleep, interruptible by stop() AND by the engine's
            # publish hook (wake()) so fresh prefixes beat immediately
            self._wake.wait(self.interval_s)
            self._wake.clear()

    def start(self) -> "ReplicaReporter":
        try:
            self.register()
        except Exception as e:  # noqa: BLE001 — the loop keeps retrying
            log.warning("fleet: initial register failed "
                        "(heartbeats will retry): %s", e)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._wake.set()  # break the interval wait immediately
        if self._thread.is_alive():
            self._thread.join(timeout=5)
