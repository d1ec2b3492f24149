"""The serving replica's typed settings: flags > environment > YAML
file, validated at startup (the port's own copy of the JAX package's
``config.py``: its ``Config`` dataclass whole, so that one YAML file loads
in both packages, ``_ENV_MAP``, ``load`` and ``validate``, and of the pool
spec parser ``validate`` checks ``fleet_pools`` with, the JAX
``fleet/scheduler.py``'s ``PoolSpecError``, ``NodePool`` and
``parse_pools``). Stdlib only: ``load`` imports ``yaml`` when it is given a
file, and only then.

``workloads/serve_main.py`` resolves every serving knob through ``load``
(``resolve_settings``); the fields the port does not read are kept so a
shared file still validates.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from .generations import GENERATIONS, GenerationSpec


class PoolSpecError(ValueError):
    """A fleet_pools spec that cannot be parsed or priced."""


@dataclasses.dataclass(frozen=True)
class NodePool:
    """One homogeneous slab of capacity: a generation and a chip count.
    ``name`` defaults to the generation; two pools of one generation
    (``"edge=v5e:16,bulk=v5e:64"``) are told apart by name."""

    name: str
    generation: str
    total_chips: int

    @property
    def spec(self) -> GenerationSpec:
        return GENERATIONS[self.generation]


def parse_pools(spec: str) -> list[NodePool]:
    """``"v5e:32,v5p:64"`` (or ``"name=v5e:32"``) -> NodePool list. The
    generation must be a row of the generations table."""
    pools: list[NodePool] = []
    seen: set[str] = set()
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition("=")
        if not rest:
            name, rest = "", name
        gen, _, chips_s = rest.partition(":")
        gen = gen.strip().lower()
        name = (name.strip() or gen)
        if gen not in GENERATIONS:
            raise PoolSpecError(
                f"pool {part!r}: unknown generation {gen!r} "
                f"(one of {sorted(GENERATIONS)})")
        try:
            chips = int(chips_s)
        except ValueError:
            raise PoolSpecError(
                f"pool {part!r}: chip count {chips_s!r} is not an int")
        if chips <= 0:
            raise PoolSpecError(f"pool {part!r}: chip count must be > 0")
        if name in seen:
            raise PoolSpecError(f"duplicate pool name {name!r}")
        seen.add(name)
        pools.append(NodePool(name=name, generation=gen, total_chips=chips))
    return pools


@dataclasses.dataclass
class Config:
    # identity
    node_name: str = "virtual-tpu"
    namespace: str = "default"
    internal_ip: str = "127.0.0.1"
    operating_system: str = "Linux"

    # cloud
    project: str = "tpu-project"
    zone: str = "us-central2-b"
    zones: list[str] = dataclasses.field(default_factory=list)  # allowed zones filter
    tpu_api_endpoint: str = "https://tpu.googleapis.com"
    # Where to read chip quota (Service Usage consumerQuotaMetrics). Empty =
    # same endpoint/transport as the TPU API — right for fake-server setups
    # whose one listener serves both surfaces; real deployments set
    # https://serviceusage.googleapis.com (the TPU API host itself 404s the
    # quota path, which degrades to the configured capacity ceiling).
    quota_api_endpoint: str = ""
    tpu_api_token: str = ""
    default_generation: str = "v5e"
    default_runtime_version: str = ""
    # how workloads launch + report per-worker status:
    #   "ssh" (default) — drive docker on the TPU VMs over SSH; needs only the
    #          real Cloud TPU v2 CRUD surface (cloud/workload_backend.py)
    #   "api" — POST :workload / GET :detailed extension endpoints (the fake
    #          server, or a worker-agent aggregator service)
    workload_path: str = "ssh"
    max_cost_per_hr: float = 0.0  # 0 = unlimited
    # total google.com/tpu chips this node advertises as allocatable — the
    # operator's cloud-quota ceiling. The K8s scheduler subtracts bound
    # pods' requests from allocatable itself, so this single number is what
    # bounds concurrently-bound chips (pods past it stay Unschedulable
    # instead of queueing invisibly in the cloud). 0 = the largest catalog
    # slice.
    max_total_chips: int = 0
    # non-tty kubectl-exec processes are wrapped so client disconnect can
    # TERM them remotely; requires /bin/sh in the workload image — set
    # False for distroless/scratch images (plain direct exec, no
    # disconnect-kill: kubectl-without-pty parity)
    exec_killable: bool = True

    # control loop timing
    reconcile_interval_s: float = 30.0
    notify_interval_s: float = 10.0
    pending_retry_interval_s: float = 30.0
    max_pending_s: float = 15 * 60
    cleanup_interval_s: float = 5 * 60
    node_status_interval_s: float = 30.0
    # stuck-terminating escalation ladder
    stuck_reterminate_s: float = 5 * 60
    stuck_unreachable_force_s: float = 10 * 60
    stuck_force_delete_s: float = 15 * 60
    # TPU-specific: how long a queued resource may sit ACCEPTED/WAITING before we
    # fail the pod. 0 = forever (QueuedResources legitimately queue for hours;
    # SURVEY.md §7.4 hard-part #3 says don't trip the 15-min ladder on queueing).
    max_provisioning_s: float = 0.0
    # preemption: resubmit the slice instead of failing the pod, this many
    # times. Default 2: preemption is the COMMON case on spot/maintenance TPU
    # capacity (SURVEY.md §5.3), so the headline elasticity feature must be on
    # out of the box. 0 = fail the pod immediately (its Job restarts it).
    preemption_requeue_limit: int = 2

    # chaos hardening: the cloud-API circuit breaker trips OPEN
    # after this many consecutive transport failures and probes again
    # (half-open) after breaker_reset_s. The same threshold bounds the
    # reconcile loop's own API-error streak before the node goes degraded
    # (TpuApiReachable=False condition + tpu.dev/api-unreachable:NoSchedule
    # taint) even without a breaker wired.
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0

    # fleet tier: the replica-aware router + SLO autoscaler.
    # Same env-var conventions as the breaker knobs (TPU_FLEET_* in
    # _ENV_MAP); flags live on fleet/router_main.py and serve_main.py.
    fleet_router_port: int = 8090
    fleet_heartbeat_interval_s: float = 2.0     # replica -> router cadence
    fleet_heartbeat_timeout_s: float = 10.0     # staler = suspect -> probe
    fleet_ttft_slo_s: float = 2.0               # scale-up SLO burn signal
    fleet_target_queue_per_replica: float = 4.0  # scale-up queue signal
    fleet_min_replicas: int = 1
    fleet_max_replicas: int = 4
    fleet_scale_up_cooldown_s: float = 30.0
    fleet_scale_down_cooldown_s: float = 120.0

    # disaggregated prefill/decode serving. serving_role is what
    # a serve_main replica registers to the fleet as: "unified" (default —
    # prefills and decodes, the single-pool mode and the fallback target),
    # "prefill" (computes KV, hands pages off) or "decode" (adopts pages,
    # streams tokens). Configuring BOTH pool ceilings > 0 switches
    # router_main's autoscaler to per-pool loops: the prefill pool scales
    # on TTFT burn + queue depth, the decode pool on ITL p95
    # (fleet_itl_slo_s) + pool-wide free KV pages
    # (fleet_min_free_kv_page_frac). fleet_handoff_timeout_s budgets the
    # prefill hop (compute + page push); past it the router falls back to
    # a single-hop route.
    serving_role: str = "unified"
    fleet_prefill_min_replicas: int = 0
    fleet_prefill_max_replicas: int = 0
    fleet_decode_min_replicas: int = 0
    fleet_decode_max_replicas: int = 0
    fleet_itl_slo_s: float = 0.25
    fleet_min_free_kv_page_frac: float = 0.1
    fleet_handoff_timeout_s: float = 30.0
    # device-native KV transfer: replicas advertising EQUAL
    # non-empty placement domains hand KV pages arena-to-arena (zero host
    # copies) on two-hop routes; every device-path failure downgrades to
    # the wire codec, then the unified fallback. fleet_placement_domain
    # overrides the auto-detected domain (proc:<host>:<pid> — the
    # co-location the in-process bus can prove); operators with a real
    # same-slice ICI transport set it per pool.
    fleet_device_transfer_enabled: bool = True
    fleet_placement_domain: str = ""
    # KV fabric: the fleet-wide prefix directory + pull hop.
    # fleet_placement_domain_mode governs auto-detection when no explicit
    # domain is set: "auto" prefers the gang scheduler's slice identity
    # (TPU_SLICE_NAME, host-qualified for the shm rung) and falls back to
    # proc:<host>:<pid>; "slice" warns when the slice identity is missing;
    # "proc" pins the one-process-per-domain behavior.
    # fleet_prefix_broadcast restores the pre-directory /prefix fan-out
    # (register on EVERY ready replica up front) for operators who prefer
    # eager replication over lazy pulls.
    fleet_prefix_directory_enabled: bool = True
    fleet_pull_timeout_s: float = 10.0      # one pull hop, export->adopt
    fleet_placement_domain_mode: str = "auto"
    fleet_prefix_broadcast: bool = False
    # global prefix-directory size: entries the
    # router-side LRU holds before evicting the least-recently-touched
    # prefix claim. The 4096 default matches the old hardcoded cap.
    fleet_directory_capacity: int = 4096
    # heterogeneous node pools: "[name=]generation:chips"
    # comma-list, e.g. "v5e:32,v5p:64". Non-empty switches router_main to
    # scheduler-routed capacity: autoscalers place through the
    # goodput-per-dollar FleetScheduler instead of creating pods
    # directly. "" = the legacy homogeneous fleet (no scheduler).
    fleet_pools: str = ""

    # training telemetry. telemetry_port is a gang COORDINATION
    # var: injected into every worker's env (TPU_TELEMETRY_PORT +
    # TPU_TELEMETRY_ADDRESS = worker-0) at gang launch so peers can post
    # step heartbeats to worker-0's aggregator; 0 disables injection.
    # stall_timeout_s doubles as the kubelet-side deadline: a Running
    # training pod whose scraped step counter stops advancing for this long
    # gets a TrainingStalled event + pod.training_stalled span.
    # straggler_factor is the workload watchdog's k×median step-time flag.
    telemetry_port: int = 8478
    straggler_factor: float = 3.0
    stall_timeout_s: float = 300.0

    # serving: paged KV prefix cache. kv_page_tokens is the
    # pool's allocation/trie-match granule (tokens per KV page);
    # kv_pool_pages sizes the preallocated HBM arena (0 = auto: one
    # decode-cache's worth); prefix_cache_enabled gates the cross-request
    # radix trie (register_prefix keeps working either way). Flags live on
    # workloads/serve_main.py; the helm chart wires the TPU_KV_* env onto
    # the router, whose autoscaler passes them through to the serving pods
    # it creates.
    kv_page_tokens: int = 16
    kv_pool_pages: int = 0
    prefix_cache_enabled: bool = True
    # paged decode loop: decode on per-slot page tables over the
    # shared arena — prefix hits and handed-off KV referenced zero-copy.
    # True = auto (on whenever the model/layout allows it); False pins the
    # contiguous slot-cache loop.
    kv_paged_decode: bool = True
    # paged-native prefill: scatter prefill chunks straight
    # into arena pages — no dense scratch cache or page-copy on the hot
    # path. True = auto (on whenever the paged loop runs); False pins the
    # dense-scratch prefill + adoption-copy route.
    kv_paged_prefill: bool = True
    # TP paged serving: how the paged arena places over a
    # tensor-parallel serving mesh. "auto" shards each section's kv-heads
    # axis over ``tensor`` like the contiguous cache (MLA latents
    # replicate — headless), degrading to a replicated arena when the
    # mesh doesn't divide the kv-head count; "replicate" pins the
    # replicated layout (pays HBM, keeps paged decode — an
    # odd-geometry/debugging escape hatch).
    kv_arena_sharding: str = "auto"
    # chunked prefill + streamed handoff. serving_chunk_tokens:
    # process prompts in chunks of this many tokens, yielding a decode
    # step to the engine between chunks (bounds co-resident streams' ITL
    # under long prefills) and — on disaggregated prefill replicas —
    # streaming each completed chunk's KV pages to the decode replica
    # while the next chunk computes (two-hop TTFT -> max(compute,
    # transfer)). 0 = monolithic. handoff_stream_window bounds the chunk
    # frames queued between prefill compute and the push (the overlap
    # window; compute blocks when transfer falls that far behind).
    serving_chunk_tokens: int = 0
    handoff_stream_window: int = 8
    # serving observability. serving_flight_recorder gates the
    # engine's per-decode-step flight recorder (bounded ring at GET
    # /debug/steps, phase split folded into serving.request spans);
    # serving_profiler_port starts the on-demand jax.profiler server
    # (train_main parity; 0 = off); serving_profile_capture enables the
    # GET /debug/profile?seconds= trace endpoint — off by default because
    # a capture stalls the device and writes replica-local files.
    serving_flight_recorder: bool = True
    serving_profiler_port: int = 0
    serving_profile_capture: bool = False
    # cost attribution plane: per-request chip-second/dollar
    # metering on the engine (costmeter.py — phase walls priced through
    # the generations.py table, per-tenant ledger at GET /debug/costs,
    # cumulative snapshots riding the fleet heartbeat into the router's
    # fleet-wide /metrics/fleet + /debug/costs).
    serving_cost_meter: bool = True
    # fleet SLO burn rates: multi-window breach fractions over
    # the TTFT/ITL/error-rate objectives, computed from registry
    # heartbeats on the injected clock. A signal "burns" when BOTH the
    # short and the long window consume error budget faster than
    # fleet_slo_burn_threshold x the sustainable rate; the autoscaler
    # uses that crossing (not a latched p95 sample) as its latency
    # corroboration. fleet_slo_budget_frac is the error budget (fraction
    # of time the SLO may be breached); fleet_slo_error_rate is the
    # request-error-ratio objective.
    fleet_slo_short_window_s: float = 300.0
    fleet_slo_long_window_s: float = 3600.0
    fleet_slo_burn_threshold: float = 2.0
    fleet_slo_budget_frac: float = 0.05
    fleet_slo_error_rate: float = 0.01

    # elastic gang training. elastic_resize is the global gate for
    # the tpu.dev/elastic pod annotation: on partial host loss an elastic
    # gang is relaunched on the SURVIVING workers (mesh rebuilt at the
    # surviving DP width, state resharded from the latest checkpoint)
    # instead of requeueing the whole slice, and grown back when capacity
    # returns — preferring a checkpoint boundary, with elastic_grow_grace_s
    # as the fallback deadline for workloads that never checkpoint.
    elastic_resize: bool = True
    elastic_grow_grace_s: float = 120.0

    # servers
    listen_port: int = 10250
    health_address: str = ":8080"
    metrics_enabled: bool = True
    # kubelet API security (exposure-model parity: the reference serves :10250
    # through the virtual-kubelet lib's cert-based server, main.go:217-248).
    # Our /run endpoint can exec on workers, so production deploys must set
    # these; empty = plaintext/unauthenticated (dev only).
    tls_cert_file: str = ""
    tls_key_file: str = ""
    api_auth_token: str = ""

    # logging
    log_level: str = "info"
    sentry_url: str = ""

    # tracing (pod-lifecycle spans; serving has its own --trace-export)
    trace_export_path: str = ""   # JSONL span export; "" = in-memory ring only
    trace_ring_size: int = 2048   # bounded span ring behind /debug/traces

    # paths
    kubeconfig: str = ""

    def validate(self) -> "Config":
        errs = []
        if not self.node_name:
            errs.append("node_name must be set")
        if self.reconcile_interval_s <= 0:
            errs.append("reconcile_interval_s must be > 0")
        for interval in ("notify_interval_s", "pending_retry_interval_s",
                         "cleanup_interval_s", "node_status_interval_s"):
            if getattr(self, interval) <= 0:
                errs.append(f"{interval} must be > 0 (a non-positive "
                            f"interval spins the loop hot)")
        if self.max_pending_s <= 0:
            errs.append("max_pending_s must be > 0")
        # the stuck-terminating ladder must escalate in order, or a pod
        # would be force-deleted before it was ever re-terminated
        if not 0 < self.stuck_reterminate_s <= self.stuck_unreachable_force_s \
                <= self.stuck_force_delete_s:
            errs.append("stuck_* ladder must satisfy 0 < reterminate <= "
                        "unreachable_force <= force_delete")
        if self.max_provisioning_s < 0:
            errs.append("max_provisioning_s must be >= 0 (0 = queue forever)")
        if self.preemption_requeue_limit < 0:
            errs.append("preemption_requeue_limit must be >= 0 (0 = fail "
                        "the pod immediately)")
        if self.max_cost_per_hr < 0:
            errs.append("max_cost_per_hr must be >= 0 (0 = unlimited)")
        if self.max_total_chips < 0:
            errs.append("max_total_chips must be >= 0 (0 = largest catalog "
                        "slice)")
        if not 0 < self.listen_port <= 65535:
            errs.append("listen_port must be in [1, 65535]")
        if self.fleet_ttft_slo_s <= 0:
            errs.append("fleet_ttft_slo_s must be > 0")
        if self.log_level.lower() not in ("debug", "info", "warning", "error"):
            errs.append(f"unknown log_level {self.log_level!r}")
        if self.workload_path not in ("ssh", "api"):
            errs.append(f"workload_path must be 'ssh' or 'api', "
                        f"got {self.workload_path!r}")
        if self.zones and self.zone not in self.zones:
            errs.append(f"zone {self.zone!r} not in allowed zones {self.zones}")
        if self.trace_ring_size <= 0:
            errs.append("trace_ring_size must be > 0")
        if self.breaker_failure_threshold <= 0:
            errs.append("breaker_failure_threshold must be > 0")
        if self.breaker_reset_s <= 0:
            errs.append("breaker_reset_s must be > 0")
        if self.fleet_router_port <= 0:
            errs.append("fleet_router_port must be > 0")
        if self.fleet_heartbeat_interval_s <= 0:
            errs.append("fleet_heartbeat_interval_s must be > 0")
        if self.fleet_heartbeat_timeout_s < self.fleet_heartbeat_interval_s:
            errs.append("fleet_heartbeat_timeout_s must be >= "
                        "fleet_heartbeat_interval_s (a replica must get at "
                        "least one beat per timeout window)")
        if self.fleet_min_replicas < 0:
            errs.append("fleet_min_replicas must be >= 0")
        if self.fleet_max_replicas < max(1, self.fleet_min_replicas):
            errs.append("fleet_max_replicas must be >= max(1, "
                        "fleet_min_replicas)")
        if self.fleet_target_queue_per_replica <= 0:
            errs.append("fleet_target_queue_per_replica must be > 0")
        if self.fleet_scale_up_cooldown_s < 0 \
                or self.fleet_scale_down_cooldown_s < 0:
            errs.append("fleet cooldowns must be >= 0")
        if self.serving_role not in ("unified", "prefill", "decode"):
            errs.append(f"serving_role must be unified/prefill/decode, "
                        f"got {self.serving_role!r}")
        for pool_field in ("fleet_prefill_min_replicas",
                           "fleet_prefill_max_replicas",
                           "fleet_decode_min_replicas",
                           "fleet_decode_max_replicas"):
            if getattr(self, pool_field) < 0:
                errs.append(f"{pool_field} must be >= 0 (0 = pool disabled)")
        if 0 < self.fleet_prefill_max_replicas \
                < self.fleet_prefill_min_replicas:
            errs.append("fleet_prefill_max_replicas must be >= "
                        "fleet_prefill_min_replicas when the pool is on")
        if 0 < self.fleet_decode_max_replicas \
                < self.fleet_decode_min_replicas:
            errs.append("fleet_decode_max_replicas must be >= "
                        "fleet_decode_min_replicas when the pool is on")
        if (self.fleet_prefill_max_replicas > 0) \
                != (self.fleet_decode_max_replicas > 0):
            # half a disaggregated fleet is not a mode: build() would
            # silently run the legacy whole-fleet loop and the operator
            # would believe the configured pool is managed
            errs.append(
                "disaggregated pools are configured together: set BOTH "
                "fleet_prefill_max_replicas and fleet_decode_max_replicas "
                "> 0 (or neither for the single-pool fleet); got "
                f"prefill_max={self.fleet_prefill_max_replicas}, "
                f"decode_max={self.fleet_decode_max_replicas}")
        if self.fleet_itl_slo_s < 0:
            errs.append("fleet_itl_slo_s must be >= 0 (0 = signal off)")
        if not 0 <= self.fleet_min_free_kv_page_frac < 1:
            errs.append("fleet_min_free_kv_page_frac must be in [0, 1) "
                        "(0 = signal off)")
        if self.fleet_handoff_timeout_s <= 0:
            errs.append("fleet_handoff_timeout_s must be > 0")
        if self.fleet_pull_timeout_s <= 0:
            errs.append("fleet_pull_timeout_s must be > 0")
        if self.fleet_directory_capacity <= 0:
            errs.append("fleet_directory_capacity must be > 0 (the "
                        "directory needs room for at least one prefix)")
        if self.fleet_pools:
            # parse errors surface at startup, not at first scale-up
            try:
                parse_pools(self.fleet_pools)
            except PoolSpecError as e:
                errs.append(f"fleet_pools: {e}")
        if self.fleet_placement_domain_mode not in ("auto", "proc", "slice"):
            errs.append(f"fleet_placement_domain_mode must be "
                        f"auto/proc/slice, got "
                        f"{self.fleet_placement_domain_mode!r}")
        if not 0 <= self.telemetry_port <= 65535:
            errs.append("telemetry_port must be in [0, 65535] (0 = off)")
        if self.straggler_factor <= 1.0:
            errs.append("straggler_factor must be > 1 (1x median would flag "
                        "half the fleet)")
        if self.stall_timeout_s <= 0:
            errs.append("stall_timeout_s must be > 0")
        if self.elastic_grow_grace_s < 0:
            errs.append("elastic_grow_grace_s must be >= 0")
        if self.kv_page_tokens < 1:
            errs.append("kv_page_tokens must be >= 1 (tokens per KV page)")
        if self.kv_pool_pages < 0:
            errs.append("kv_pool_pages must be >= 0 (0 = auto-size)")
        if self.kv_arena_sharding not in ("auto", "replicate"):
            errs.append("kv_arena_sharding must be 'auto' or 'replicate'")
        if self.serving_chunk_tokens < 0:
            errs.append("serving_chunk_tokens must be >= 0 (0 = "
                        "monolithic prefill)")
        if self.handoff_stream_window < 1:
            errs.append("handoff_stream_window must be >= 1 (at least one "
                        "frame in flight, or the stream cannot move)")
        if not 0 <= self.serving_profiler_port <= 65535:
            errs.append("serving_profiler_port must be in [0, 65535] "
                        "(0 = off)")
        if self.fleet_slo_short_window_s <= 0:
            errs.append("fleet_slo_short_window_s must be > 0")
        if self.fleet_slo_long_window_s < self.fleet_slo_short_window_s:
            errs.append("fleet_slo_long_window_s must be >= "
                        "fleet_slo_short_window_s (the long window "
                        "confirms the short one)")
        if self.fleet_slo_burn_threshold <= 0:
            errs.append("fleet_slo_burn_threshold must be > 0")
        if not 0 < self.fleet_slo_budget_frac < 1:
            errs.append("fleet_slo_budget_frac must be in (0, 1) — it is "
                        "the fraction of time the SLO may be breached")
        if not 0 < self.fleet_slo_error_rate < 1:
            errs.append("fleet_slo_error_rate must be in (0, 1)")
        if errs:
            raise ValueError("invalid config: " + "; ".join(errs))
        return self


_ENV_MAP = {
    "KUBELET_API_TOKEN": "api_auth_token",
    "TPU_API_TOKEN": "tpu_api_token",
    "TPU_API_ENDPOINT": "tpu_api_endpoint",
    "TPU_QUOTA_API_ENDPOINT": "quota_api_endpoint",
    "TPU_PROJECT": "project",
    "TPU_ZONE": "zone",
    "TPU_ZONES": "zones",
    "NODE_NAME": "node_name",
    "NAMESPACE": "namespace",
    "SENTRY_URL": "sentry_url",
    "LOG_LEVEL": "log_level",
    "TPU_DEFAULT_GENERATION": "default_generation",
    "TPU_DEFAULT_RUNTIME_VERSION": "default_runtime_version",
    "TPU_WORKLOAD_PATH": "workload_path",
    "TPU_MAX_COST_PER_HR": "max_cost_per_hr",
    "TPU_MAX_TOTAL_CHIPS": "max_total_chips",
    "TPU_LISTEN_PORT": "listen_port",
    "TPU_HEALTH_ADDRESS": "health_address",
    "TPU_RECONCILE_INTERVAL_S": "reconcile_interval_s",
    "TPU_MAX_PROVISIONING_S": "max_provisioning_s",
    "TPU_PREEMPTION_REQUEUE_LIMIT": "preemption_requeue_limit",
    "TPU_BREAKER_FAILURE_THRESHOLD": "breaker_failure_threshold",
    "TPU_BREAKER_RESET_S": "breaker_reset_s",
    "TPU_TRACE_EXPORT_PATH": "trace_export_path",
    "TPU_FLEET_ROUTER_PORT": "fleet_router_port",
    "TPU_FLEET_HEARTBEAT_INTERVAL_S": "fleet_heartbeat_interval_s",
    "TPU_FLEET_HEARTBEAT_TIMEOUT_S": "fleet_heartbeat_timeout_s",
    "TPU_FLEET_TTFT_SLO_S": "fleet_ttft_slo_s",
    "TPU_FLEET_TARGET_QUEUE_PER_REPLICA": "fleet_target_queue_per_replica",
    "TPU_FLEET_MIN_REPLICAS": "fleet_min_replicas",
    "TPU_FLEET_MAX_REPLICAS": "fleet_max_replicas",
    "TPU_FLEET_SCALE_UP_COOLDOWN_S": "fleet_scale_up_cooldown_s",
    "TPU_FLEET_SCALE_DOWN_COOLDOWN_S": "fleet_scale_down_cooldown_s",
    "TPU_KV_PAGE_TOKENS": "kv_page_tokens",
    "TPU_KV_POOL_PAGES": "kv_pool_pages",
    "TPU_PREFIX_CACHE_ENABLED": "prefix_cache_enabled",
    "TPU_KV_PAGED_DECODE": "kv_paged_decode",
    "TPU_KV_PAGED_PREFILL": "kv_paged_prefill",
    "TPU_KV_ARENA_SHARDING": "kv_arena_sharding",
    "TPU_SERVING_CHUNK_TOKENS": "serving_chunk_tokens",
    "TPU_HANDOFF_STREAM_WINDOW": "handoff_stream_window",
    "TPU_SERVING_FLIGHT_RECORDER": "serving_flight_recorder",
    "TPU_SERVING_PROFILER_PORT": "serving_profiler_port",
    "TPU_SERVING_PROFILE_CAPTURE": "serving_profile_capture",
    "TPU_SERVING_COST_METER": "serving_cost_meter",
    "TPU_FLEET_SLO_SHORT_WINDOW_S": "fleet_slo_short_window_s",
    "TPU_FLEET_SLO_LONG_WINDOW_S": "fleet_slo_long_window_s",
    "TPU_FLEET_SLO_BURN_THRESHOLD": "fleet_slo_burn_threshold",
    "TPU_FLEET_SLO_BUDGET_FRAC": "fleet_slo_budget_frac",
    "TPU_FLEET_SLO_ERROR_RATE": "fleet_slo_error_rate",
    "TPU_SERVING_ROLE": "serving_role",
    "TPU_FLEET_PREFILL_MIN_REPLICAS": "fleet_prefill_min_replicas",
    "TPU_FLEET_PREFILL_MAX_REPLICAS": "fleet_prefill_max_replicas",
    "TPU_FLEET_DECODE_MIN_REPLICAS": "fleet_decode_min_replicas",
    "TPU_FLEET_DECODE_MAX_REPLICAS": "fleet_decode_max_replicas",
    "TPU_FLEET_ITL_SLO_S": "fleet_itl_slo_s",
    "TPU_FLEET_MIN_FREE_KV_PAGE_FRAC": "fleet_min_free_kv_page_frac",
    "TPU_FLEET_HANDOFF_TIMEOUT_S": "fleet_handoff_timeout_s",
    "TPU_FLEET_DEVICE_TRANSFER_ENABLED": "fleet_device_transfer_enabled",
    "TPU_FLEET_PLACEMENT_DOMAIN": "fleet_placement_domain",
    "TPU_FLEET_PREFIX_DIRECTORY_ENABLED": "fleet_prefix_directory_enabled",
    "TPU_FLEET_PULL_TIMEOUT_S": "fleet_pull_timeout_s",
    "TPU_FLEET_PLACEMENT_DOMAIN_MODE": "fleet_placement_domain_mode",
    "TPU_FLEET_PREFIX_BROADCAST": "fleet_prefix_broadcast",
    "TPU_FLEET_DIRECTORY_CAPACITY": "fleet_directory_capacity",
    "TPU_FLEET_POOLS": "fleet_pools",
    "TPU_TELEMETRY_PORT": "telemetry_port",
    "TPU_STRAGGLER_FACTOR": "straggler_factor",
    "TPU_STALL_TIMEOUT_S": "stall_timeout_s",
    "TPU_ELASTIC_RESIZE_ENABLED": "elastic_resize",
    "TPU_ELASTIC_GROW_GRACE_S": "elastic_grow_grace_s",
}


def load(file_path: Optional[str] = None, env: Optional[dict] = None,
         overrides: Optional[dict] = None) -> Config:
    """Build config with precedence: overrides (flags) > env > file > defaults."""
    values: dict = {}
    if file_path:
        import yaml
        with open(file_path) as f:
            loaded = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(Config)}
        unknown = set(loaded) - known
        if unknown:
            raise ValueError(f"unknown config keys in {file_path}: {sorted(unknown)}")
        values.update(loaded)
    env = os.environ if env is None else env
    for env_key, field in _ENV_MAP.items():
        if env.get(env_key):
            values[field] = env[env_key]
    if overrides:
        values.update({k: v for k, v in overrides.items() if v is not None})
    # coerce numerics/lists that may arrive as strings from env/flags
    cfg = Config()
    for f in dataclasses.fields(Config):
        if f.name not in values:
            continue
        v = values[f.name]
        cur = getattr(cfg, f.name)
        if isinstance(cur, bool) and isinstance(v, str):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, float) and not isinstance(v, float):
            v = float(v)
        elif isinstance(cur, int) and not isinstance(v, (int, bool)):
            v = int(v)
        elif isinstance(cur, list) and isinstance(v, str):
            v = [s.strip() for s in v.split(",") if s.strip()]
        setattr(cfg, f.name, v)
    return cfg.validate()
