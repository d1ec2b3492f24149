"""Continuous-batching serving engine (port of the JAX package's
``workloads/serving/engine.py``): the paged loop over a KV arena, and the
contiguous loop over one batch cache.

The paged loop runs whenever the layout pages (not a windowed interleave,
not ``ring_cache=True``), the prefix cache is on and ``paged_decode`` does
not turn it off, as in the JAX engine; everything else serves from the
contiguous loop (the last item below). The items before it describe the
paged loop.

- **Prefill thread**: pops submitted requests, matches each prompt against
  the prefix trie, allocates the prompt's whole page run up front and
  scatters it chunk by chunk (at most ``max_prefill_len`` tokens a chunk)
  straight into arena pages through ``paged_prefill_chunk_step``. Matched
  prefix pages join the run in place; the finished run's full pages enter
  the trie by reference. It samples the first token and hands
  (request, page run, first token) to the engine thread.
- **Dense-scratch route**: when the pool cannot hold a prompt's run up
  front, and for an n > 1 group (``submit_group``: a run's partial tail
  page can belong to one slot only), the prompt prefills into a dense
  single-request cache instead (``LlamaModel.prefill``, the flash kernel,
  for the head; ``prefill_chunk_step`` for the rest), after gathering any
  cached prefix pages from the arena; its full pages enter the trie by
  copy. Binding a slot then references the cached full pages and fills
  private tail pages from the cache; only tail pages that cannot be had
  fail the request (``EngineOverloaded``). An MLA model's single cache
  holds its latent sections, which its prefill computes in the direct
  form (the flash kernels at head_dim + rope_dim).
- **Engine thread**: binds ready runs to free slots (the run's pages become
  the slot's page-table row) and runs one ``paged_decode_step`` per step
  for every live slot, growing each slot's table by a private page when
  its next write crosses a page boundary (a uniform sliding window's slot
  recycles instead, below). With ``speculate_k`` > 0 and a
  greedy slot live, a step is instead one ``paged_verify_step`` over
  [last token, k prompt-lookup drafts]: greedy slots commit the matched
  drafts plus the corrected token, sampled slots ride along at one token,
  and rejected rows roll back by dropping the table's pages past the
  committed length.
- **Sliding window**: a model whose every layer attends a window of W
  positions (Mistral) keeps its slots' pages in a ring run: the prompt's
  pages stay a linear run, and past ``W // T + 2`` table entries a slot's
  entry j reuses the physical page of entry j - (W // T + 2), whose
  positions lie wholly behind the window by then (the paged kernels never
  read such entries). A page only the slot holds is reused in place; one
  the prefix trie shares is swapped for a private page (allocate on
  write), and the trie's copy stays cached. So a slot whose prompt fits in
  the window holds at most W // T + 2 pages however long it decodes; the
  step records count ``ring_recycled``. Such an engine decodes one token
  a step: speculative rollback cannot untangle aliased table entries.
- **Chunk interleave**: with ``serving_chunk_tokens`` set, the prefill
  thread waits for one decode step between a prompt's chunks whenever a
  slot is decoding (``ChunkArbiter``).
- **Registered prefixes**: ``register_prefix`` prefills a shared prefix
  once and pins its full pages in the trie.
- **Streaming and stops**: ``on_token`` sees each token as it commits;
  ``stop`` token sequences and ``stop_text`` strings (matched on the
  decoded tail) end a request; ``logprobs`` returns log P of each token
  under the distribution it was sampled from.
- **Embeddings**: ``embed`` mean-pools the final-norm hidden states of an
  exact-length ``forward`` (the flash kernel) on the caller's thread.
- **Flight recorder**: with ``flight_recorder`` on, every decode step's
  wall splits into schedule/kernel/sample/commit phases in a bounded ring
  (``recorder.FlightRecorder``), read through ``debug_steps()``, and feeds
  the step histograms and each request's share of its steps.
- **Metrics and spans**: every counter, gauge and histogram lives in
  ``self.metrics`` (``metrics.Metrics``) under the JAX engine's
  ``tpu_serving_`` names and HELP texts, served by ``GET /metrics``; at
  completion a request records its ``serving.request`` span with
  contiguous ``queue_wait``, ``prefill`` and ``decode`` children in
  ``self.tracer`` (``tracing.Tracer``), under the caller's trace id when
  ``submit`` got one.
- **Tensor parallelism**: with ``mesh`` (``parallel.Mesh``, ``tensor`` N
  > 1, in one process) the engine quantizes its weights first, then lays
  them out over the N shards (``parallel.shard_params``), and its arena
  shards the kv-head axis (``kv_arena_sharding`` "auto" where N divides
  both head counts) or replicates; every step, chunk and dense-route
  prefill runs tensor-parallel (``LlamaModel`` under the mesh), the JAX
  engine under a mesh with a ``tensor`` axis, on either loop. An
  ``expert`` axis beside it (an MoE model) shards the MoE layers' expert
  FFN (``models/moe.py``), as the JAX engine's ``expert`` x ``tensor``
  mesh does.
- **Cost accounting**: with ``cost_meter`` on (the default) each
  completed request is metered (``costmeter.CostMeter``: chip-seconds a
  phase, KV page-seconds, dollars at the ``generations.py`` price of the
  replica's accelerator, by ``tenant``) onto its ``serving.request`` span,
  the ``tpu_serving_*cost*`` series and the ledger ``GET /debug/costs``
  serves.
- **Step graphs**: the decode and verify steps run through
  ``StepGraph`` (``step_graph.py``), the JAX engine's jitted
  ``paged_step``/``paged_verify``: on a card each is captured as a CUDA
  graph at ``start()`` and every step is one replay fed by one
  host-to-card copy; on the CPU the same staged buffers feed the eager
  step. ``CompileWatchdog`` (``recorder.py``) counts the captures;
  ``debug_snapshot()["graphs"]`` reads them with the replays. Prefill
  chunks stay eager.
- **Contiguous loop**: one batch cache of ``slots`` rows (linear, a ring
  of ``_pick_ring_len`` slots for a uniform window, or for Gemma 2 and 3
  rings for the local layers and full length for the global ones), each
  step one replay of ``decode_step`` (``step_graph.DecodeGraph``, the
  watchdog's ``decode``). The prefill thread fills a single-request cache
  (``prefill`` for the head, ``prefill_chunk_step`` for the rest) and the
  engine thread copies it into the free row in place
  (``insert_into_slot``). With the prefix cache on and a linear layout,
  prompts match the paged prefix pool and gather from it (the
  dense-scratch route); otherwise registered prefixes live whole in a
  ``DensePrefixStore`` and a prompt copies the longest one's cache before
  appending to it. Multi-LoRA rides this loop too: each decode replay
  takes every slot's adapter id and the stacks, a prompt prefills under
  its adapter, and a registered prefix keeps one variant for each adapter,
  filled on that adapter's first prompt over it (LRU-bounded, dropped
  when the adapter is registered again). With ``speculate_k`` > 0 and a
  greedy slot live a step is one replay of the K + 1-wide verify graph
  (the watchdog's ``verify``): the paged loop's commit (``_spec_commit``),
  then each row's index advances by what it committed, so a rejected
  draft's K/V lies past the index until the next write covers it. Under
  an in-process tensor mesh the batch cache, the prefill singles and the
  dense store's caches hold each shard's kv heads apart (the arena's
  layout), and each shard's q heads attend its own.
- **Disaggregated serving**: a prefill replica's ``export_handoff``
  (wire codec blob), ``export_handoff_device`` (fresh copies on the card
  and the event after them) or ``export_handoff_stream`` (each chunk's
  full pages as the chunk lands, cached pages first) prefills a prompt on
  the caller's thread and hands its full pages to a decode replica, whose
  ``adopt_handoff``/``adopt_handoff_device``/``adopt_handoff_chunk``
  (``_device``) check them against its arena's ``section_spec`` and insert
  them through the trie, all or nothing; the decode replica's next match
  references them and prefills only the sub-page tail. ``export_pull``
  and ``export_pull_device`` serve a directory pull match-only
  (KVPullMiss when the run is gone). Every run inserted or adopted queues
  its ``prefix_key`` for the fleet directory (``take_prefix_publishes``).
  Every export and adoption runs under ``_prefix_lock``, beside the step
  replays that write the arena in place.
- **Multi-LoRA**: with ``lora_rank`` > 0 the engine holds zero stacks for
  ``max_adapters`` adapters over ``lora_targets`` (slot 0 stays zero: the
  base model), allocated once on its device. ``register_adapter`` writes
  an adapter into its slot in place, so no step graph recaptures; each
  request picks one by name (``submit(adapter=)``), every step and chunk
  applies each slot's own adapter, and the prefix trie keeps one root per
  adapter. A re-registration waits for in-flight prefills of that adapter
  to finish, then drops its cached prefix pages. ``embed`` is base-only.

Every launch that touches the arena, and every pool or trie call, runs
under ``_prefix_lock``: the two threads issue onto PyTorch's one current
stream in lock order, so each step sees the arena the previous one left.
``counters`` is a read-only view of ``self.metrics``'s counters (one
store: ``debug_snapshot()["counters"]`` and ``/metrics`` never disagree);
``decode_steps``, ``paged_prefill_chunks`` and the dense route's heads
and chunks count under that lock with their step, so a reader holding it
sees them agree with the kernels' launch counters. ``prefill_chunks`` is
the JAX engine's series: it counts only with ``serving_chunk_tokens`` set.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from collections.abc import Mapping
from concurrent.futures import Future
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...device import resolve_device
from ...fleet.handoff import (HandoffError, HandoffStreamAssembler,
                              KVPullMiss, check_device_sections,
                              deserialize_pages, serialize_pages)
from ...fleet.prefix_directory import prefix_key
from ...metrics import Metrics
from ...models.llama import LlamaConfig, LlamaModel, Params
from ...models.lora import LORA_TARGETS, is_lora
from ...models.quant import quantize_params
from ...parallel.sharding import shard_params
from ...tracing import Tracer
from .costmeter import CostMeter
from .kv_manager import DensePrefixStore, PagedKVStore, PoolExhausted
from .recorder import STEP_BUCKETS, CompileWatchdog, FlightRecorder
from .sampler import (_apply_penalties, _bias_row, _logit_modded,
                      _penalized, _sample)
from .scheduler import (ITL_BUCKETS, TTFT_BUCKETS, UTIL_BUCKETS,
                        ChunkArbiter, EngineDraining, EngineOverloaded,
                        Request, ServingConfig, _fail_future, _Slot)
from .step_graph import DecodeGraph, StepGraph

log = logging.getLogger(__name__)

# the counters ``debug_snapshot()`` reports, each the series
# ``tpu_serving_<name>`` of the engine's metrics. The last six are the
# port's own (its launch accounting of paged chunks, its dense route and
# adapter registry; the JAX engine counts no such series)
COUNTERS = ("admitted", "decode_steps", "engine_errors", "prefill_errors",
            "prefix_cache_hits", "prefix_cache_misses", "paged_prefill_tokens",
            "prefill_chunks", "admission_rejected", "drain_rejected",
            "cancelled", "spec_proposed", "spec_accepted",
            "paged_speculative_steps", "paged_speculative_rollback_pages",
            "chunk_interleaved_steps", "prefix_hits", "stream_cancelled",
            "prefix_cache_evictions", "prefix_adapter_fills",
            "paged_prefill_chunks", "dense_prefills", "dense_prefill_heads",
            "dense_prefill_chunks", "embeds", "adapters_registered")


class _CounterView(Mapping):
    """``COUNTERS`` read from the engine's metrics: ``view["decode_steps"]``
    is ``tpu_serving_decode_steps``, as an int."""

    __slots__ = ("_metrics",)

    def __init__(self, metrics: Metrics):
        self._metrics = metrics

    def __getitem__(self, name: str) -> int:
        if name not in COUNTERS:
            raise KeyError(name)
        return int(self._metrics.get_counter("tpu_serving_" + name))

    def __iter__(self):
        return iter(COUNTERS)

    def __len__(self) -> int:
        return len(COUNTERS)


class _PagedRun:
    """A finished prefill: the prompt's KV sits in arena pages this run
    holds references to. ``store`` pins which arena they belong to: after
    a crash rebuild a stale run fails its request instead of binding."""

    __slots__ = ("pages", "kv_len", "store")

    def __init__(self, pages: list, kv_len: int, store: PagedKVStore):
        self.pages = pages
        self.kv_len = kv_len
        self.store = store


class ServingEngine:
    def __init__(self, cfg: LlamaConfig, params: Params, sc: ServingConfig,
                 seed: int = 0, device=None,
                 decode_fn: Optional[Callable[[list], str]] = None,
                 mesh=None, metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None, perf=None):
        """``decode_fn`` (token ids -> text, a tokenizer's ``decode``)
        enables ``stop_text``. ``mesh`` with ``tensor`` > 1 serves
        tensor-parallel in one process; the engine then takes ``params``
        over: unless it quantizes them first (its own copy), the given
        tree's leaves are replaced by their shards, so that an 8B bf16 tree
        is never held twice. ``metrics`` and ``tracer`` receive the
        engine's series and spans (fresh ones when None); ``perf`` is the
        clock of every duration (perf_counter, injectable)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sc = sc
        self._decode_fn = decode_fn
        self._perf = perf if perf is not None else time.perf_counter
        # ``is not None``, not ``or``: a caller's still-empty tracer is
        # falsy (len 0), and ``or`` would orphan its export file
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics or Metrics()
        self._describe_metrics(self.metrics)
        # the HPA scrapes from pod start: the signal exists before traffic
        self.metrics.set_gauge("tpu_serving_queue_depth", 0)
        self.metrics.set_gauge("tpu_serving_active_slots", 0)
        self.metrics.set_gauge("tpu_serving_kv_cache_tokens", 0)
        self.metrics.set_gauge("tpu_serving_draining", 0)
        # series dashboards divide, visible from pod start: hit rate,
        # chunks against interleaved steps, tokens prefilled into pages,
        # rollback pages against drafts
        self.metrics.incr("tpu_serving_prefix_cache_hits", 0)
        self.metrics.incr("tpu_serving_prefix_cache_misses", 0)
        self.metrics.incr("tpu_serving_prefix_cache_evictions", 0)
        self.metrics.incr("tpu_serving_prefill_chunks", 0)
        self.metrics.incr("tpu_serving_chunk_interleaved_steps", 0)
        self.metrics.incr("tpu_serving_paged_prefill_tokens", 0)
        self.metrics.incr("tpu_serving_paged_speculative_steps", 0)
        self.metrics.incr("tpu_serving_paged_speculative_rollback_pages", 0)
        # the handoff and pull series from pod start: dashboards join the
        # sender and receiver sides and divide device runs by hops
        for name in ("pages", "bytes", "failures", "stream_frames",
                     "stream_rejects", "device_runs", "device_bytes",
                     "device_downgrades"):
            self.metrics.incr("tpu_serving_kv_handoff_" + name, 0)
        for name in ("runs", "bytes", "failures"):
            self.metrics.incr("tpu_serving_kv_pull_" + name, 0)
        if sc.speculate_k > 0:
            self.metrics.incr("tpu_serving_spec_proposed", 0)
            self.metrics.incr("tpu_serving_spec_accepted", 0)
        self.counters = _CounterView(self.metrics)
        if sc.quantize_int8 and sc.quantize_int4:
            raise ValueError("quantize_int8 and quantize_int4 are mutually "
                             "exclusive — pick one weight precision")
        if sc.kv_arena_sharding not in ("auto", "replicate"):
            raise ValueError(f"kv_arena_sharding must be 'auto' or "
                             f"'replicate', got {sc.kv_arena_sharding!r}")
        if mesh is not None and (mesh.seq > 1 or not mesh.in_process):
            raise ValueError(
                f"{mesh}: the engine serves on an in-process expert x "
                "tensor mesh; a sequence mesh is a training mesh, and the "
                "engine over a process group (rank 0 scheduling, each "
                "step's inputs broadcast) is ROADMAP Queue 1 #6")
        if sc.slots < 1 or sc.max_prefill_len < 1:
            raise ValueError("slots and max_prefill_len must be >= 1")
        if min(sc.speculate_k, sc.serving_chunk_tokens, sc.max_prefixes) < 0:
            raise ValueError("speculate_k, serving_chunk_tokens and "
                             "max_prefixes must be >= 0")
        t = sc.kv_page_tokens
        if t < 1:
            raise ValueError(f"kv_page_tokens must be >= 1, got {t}")
        if sc.cache_len > cfg.max_seq_len:
            raise ValueError(f"cache_len {sc.cache_len} exceeds the model's "
                             f"max_seq_len {cfg.max_seq_len}")
        if sc.kv_pool_pages < 0 or sc.max_queue_depth < 0:
            raise ValueError("kv_pool_pages (0 = auto) and max_queue_depth "
                             "(0 = unbounded) must be >= 0")
        slot_pages = -(-sc.cache_len // t)
        self._paged_loop, self._paged_prefill_on, self._ring_len = \
            self.check_loop(cfg, sc)
        uniform_window = (cfg.sliding_window is not None
                          and cfg.sliding_window_pattern == 1)
        # a uniform sliding window's ring run on the paged loop (the JAX
        # engine's _window and _win_pages): table entry j >= _win_pages
        # recycles entry j - _win_pages; the +2 covers the window's edge
        # inside a page and the entry being written
        self._window = (cfg.sliding_window
                        if self._paged_loop and uniform_window else None)
        self._win_pages = (self._window // t + 2
                           if self._window is not None else 0)
        # pages recycled since the last step record (engine thread only)
        self._ring_recycled = 0
        # the paged prefix pool: on the paged loop, and on the contiguous
        # loop over a linear layout with the prefix cache on; otherwise
        # registered prefixes live whole in the dense store
        pageable = (sc.prefix_cache_enabled and self._ring_len is None
                    and t < sc.cache_len)
        # auto: on the paged loop one decode cache's worth for the slots
        # plus as much again for the shared prefix pool, else one decode
        # cache's worth (the JAX engine's auto sizing)
        n_pages = sc.kv_pool_pages or max(
            1, 2 * sc.slots * slot_pages if self._paged_loop
            else sc.slots * sc.cache_len // t)
        dims = self.lora_dims(cfg, sc)
        if sc.quantize_int8 or sc.quantize_int4:
            # on the params' device, one layer slice at a time; leaves
            # already quantized (init_quantized_params) are kept as they are
            params = quantize_params(cfg, params,
                                     bits=4 if sc.quantize_int4 else 8)
        # quantize first, then shard, as the JAX engine does
        self.params = shard_params(cfg, params, mesh)
        self.model = LlamaModel(cfg, self.device, mesh)
        self._kv_store: Optional[PagedKVStore] = None
        self._dense_prefixes: Optional[DensePrefixStore] = None
        self._arena_shards = 1
        if pageable:
            arena = self.model.init_paged_arena(
                n_pages, t, quantize=sc.quantize_kv_int8,
                shard_kv=sc.kv_arena_sharding == "auto")
            # the arena's kv-head shards (1: one arena every shard reads)
            self._arena_shards = self.model.kv_shards(arena)
            self._kv_store = PagedKVStore(n_pages, t, arena,
                                          shards=self._arena_shards)
        else:
            self._dense_prefixes = DensePrefixStore(
                max_adapter_variants=sc.max_prefixes)
        # the contiguous loop's batch cache; the paged loop's slots live
        # in the arena
        self._cache = (None if self._paged_loop
                       else self._fresh_cache(sc.slots))
        # multi-LoRA: zero stacks over max_adapters + 1 slots, slot 0 the
        # base model forever, whole on every shard (adapters are small)
        self._adapters: Optional[dict] = None
        if dims:
            n, r, dt = sc.max_adapters + 1, sc.lora_rank, cfg.dtype
            self._adapters = {t: {
                "a": torch.zeros((cfg.n_layers, n, dims[t][0], r), dtype=dt,
                                 device=self.device),
                "b": torch.zeros((cfg.n_layers, n, r, dims[t][1]), dtype=dt,
                                 device=self.device),
                "scale": torch.zeros((cfg.n_layers, n), dtype=torch.float32,
                                     device=self.device)}
                for t in sc.lora_targets}
        self._adapter_names: dict[str, int] = {}
        self._adapter_lock = threading.Lock()
        # one registration at a time; it waits until no prefill of its
        # slot is in flight (readers) and holds new ones off (writing)
        self._register_lock = threading.Lock()
        self._adapter_cond = threading.Condition()
        self._adapter_readers: dict[int, int] = {}
        self._adapter_writing: set = set()
        self._slot_adapter = np.zeros((sc.slots,), np.int32)
        self._slot_pages_max = slot_pages
        # the decode and verify steps as CUDA graphs over static slot
        # buffers, captured at start() on a card (the JAX engine's jitted
        # paged_step / paged_verify); the watchdog counts every capture
        self.watchdog = CompileWatchdog(metrics=self.metrics,
                                        tracer=self.tracer)
        # the per-step timeline; None when off, so a mark site costs one
        # ``is not None`` test
        self.recorder: Optional[FlightRecorder] = (
            FlightRecorder(max_steps=sc.recorder_steps,
                           max_bytes=sc.recorder_bytes, perf=self._perf,
                           metrics=self.metrics,
                           max_requests=max(64, 4 * sc.slots))
            if sc.flight_recorder else None)
        paged = self._paged_loop
        self._paged_step = self.watchdog.wrap(
            "paged_step", StepGraph(self.model, 1, sc.slots, slot_pages)
            if paged else None)
        # a windowed engine decodes one token a step: no verify graph
        self._paged_verify = self.watchdog.wrap(
            "paged_verify", StepGraph(self.model, sc.speculate_k + 1,
                                      sc.slots, slot_pages)
            if paged and sc.speculate_k > 0 and self._window is None
            else None)
        # the contiguous loop's decode step over the batch cache (the JAX
        # engine's jitted ``decode``), and with speculate_k its verify step
        # (the jitted ``verify``)
        self._decode = self.watchdog.wrap(
            "decode", None if paged else DecodeGraph(self.model, sc.slots))
        self._verify = self.watchdog.wrap(
            "verify", DecodeGraph(self.model, sc.slots, sc.speculate_k + 1)
            if not paged and sc.speculate_k > 0 else None)
        # per-slot page tables, host side; entries past a slot's run stay
        # 0, a valid page id the kernel never reads (it stops at the run)
        self._page_tables_np = np.zeros((sc.slots, slot_pages), np.int32)
        self._slots = [_Slot() for _ in range(sc.slots)]
        self._slot_seed = [0] * sc.slots
        self._slot_draws = [0] * sc.slots
        # per-slot penalty counts and logit_bias rows, allocated at the
        # first request that needs them
        self._tok_counts: Optional[torch.Tensor] = None
        self._logit_bias: Optional[torch.Tensor] = None
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._queue_event = threading.Event()
        # fanout members queued behind their group's head: an n-member
        # group is one queue entry but n requests
        self._queued_fanout = 0
        self._fanout_lock = threading.Lock()
        # prefill thread -> engine thread, bounded to the slot count:
        # (request, _PagedRun or dense single cache, first token, its
        # logprob or None)
        self._ready: "queue.Queue[tuple[Request, Any, int, Any]]" = \
            queue.Queue(maxsize=sc.slots)
        self._prefix_lock = threading.Lock()
        # in-flight /kv_prefill hops (a prefill-role replica's load: they
        # run on handler threads, never in the queue or a slot) and the
        # completed ones, which heartbeats carry cumulative
        self._handoff_lock = threading.Lock()
        self.handoff_inflight = 0
        self.handoffs_total = 0
        # the decode side's chunk-stream assembly, built at the first
        # streamed frame (it needs the arena's section spec); fed under
        # _handoff_lock, the arena moves only when a whole stream checks out
        self._stream_assembler: Optional[HandoffStreamAssembler] = None
        # the global prefix directory's pending publishes: the longest
        # page-boundary key of each run this arena inserted or adopted,
        # until a heartbeat carries them (take_prefix_publishes; a failed
        # beat re-queues). Keyed by prefix key, oldest dropped past 256
        self._publish_lock = threading.Lock()
        self._prefix_publishes: "OrderedDict[str, dict]" = OrderedDict()
        # serve_main points this at the reporter's wake, so a publish rides
        # the next beat; called outside the engine's locks, best effort
        self.prefix_publish_hook: Optional[Callable[[], None]] = None
        self._admit_lock = threading.Lock()
        self._draining = threading.Event()
        self._chunk_tokens = min(sc.serving_chunk_tokens,
                                 sc.max_prefill_len)
        self._arbiter = ChunkArbiter()
        # register_prefix() token lists, deduplicated, at most max_prefixes
        self._registered: list[list[int]] = []
        # requests popped from a queue but not yet in a slot: ``drained``
        # reads queues and transit under this lock so no request is ever
        # in neither place
        self._transit_lock = threading.Lock()
        self._transit = 0
        # the pool's stats at the last arena change, for the page gauges
        # and the step records (walking refcounts every step costs more
        # than the step)
        self._page_stats: Optional[dict] = None
        self._update_page_gauges()
        self.metrics.set_gauge("tpu_serving_paged_decode",
                               1 if self._paged_loop else 0)
        # the tensor degree the paged loop runs at: 1 on one device, 0
        # with the loop off
        self.metrics.set_gauge("tpu_serving_paged_tp_shards",
                               self.model.tp if self._paged_loop else 0)
        self.total_generated = 0
        self.last_error: Optional[str] = None
        # per-request chip-second and dollar attribution (None when off:
        # a completion pays one `is not None` test). Its chips are the
        # cards the replica holds: an in-process mesh lives on one
        self.costmeter: Optional[CostMeter] = None
        if sc.cost_meter:
            self.costmeter = CostMeter(
                self.metrics, model=cfg.name,
                accelerator=priced_accelerator(self.device),
                chips=1 if mesh is None or mesh.in_process else mesh.shards,
                pool=os.environ.get("TPU_SERVING_POOL", ""),
                clock=self._perf)
        self._seed_rng = np.random.default_rng(seed)
        self._seed_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-engine", daemon=True)
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, name="serving-prefill", daemon=True)

    # -- public API ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        if self.device.type == "cuda":
            # before the threads start: a capture is not safe against
            # another thread's CUDA calls (the prefill thread builds its
            # chunk tensors outside the arena lock)
            pool = torch.cuda.graph_pool_handle()
            for g in self._graphs():
                g.capture(self.params, self._step_state(), pool,
                          self._adapters)
        self._thread.start()
        self._prefill_thread.start()
        return self

    @staticmethod
    def _describe_metrics(m: Metrics):
        """HELP/TYPE of every serving series the port emits, the JAX
        engine's texts word for word (they are the contract with the HPA,
        the router and the README catalogue), the KV handoff and pull
        series among them."""
        m.describe("tpu_serving_queue_depth",
                   "requests waiting for a decode slot (HPA signal)")
        m.describe("tpu_serving_active_slots",
                   "decode slots currently holding a live request")
        m.describe("tpu_serving_kv_cache_tokens",
                   "tokens (prompt + generated) held in active KV slots")
        m.describe("tpu_serving_admitted",
                   "requests admitted into a decode slot")
        m.describe("tpu_serving_admission_rejected",
                   "submits rejected at max_queue_depth (mapped to HTTP 429)")
        m.describe("tpu_serving_drain_rejected",
                   "submits rejected while draining (mapped to HTTP 503)")
        m.describe("tpu_serving_draining",
                   "1 while the engine is draining (fleet scale-down)")
        m.describe("tpu_serving_cancelled",
                   "requests cancelled by their caller (timeout/disconnect)")
        m.describe("tpu_serving_stream_cancelled",
                   "streamed requests cancelled by a failing token callback")
        m.describe("tpu_serving_decode_steps",
                   "batched decode/verify steps executed by the engine loop")
        m.describe("tpu_serving_engine_errors",
                   "engine-loop steps that raised (in-flight requests failed)")
        m.describe("tpu_serving_prefill_errors",
                   "prefills that raised (poisoned prompt; request failed)")
        m.describe("tpu_serving_prefix_hits",
                   "prompts that skipped a registered prefix's prefill")
        m.describe("tpu_serving_prefix_adapter_fills",
                   "lazy per-adapter prefix variants computed on first use")
        m.describe("tpu_serving_prefix_cache_hits",
                   "prompts that reused >= 1 shared KV page (prefill skipped "
                   "for the matched span)")
        m.describe("tpu_serving_prefix_cache_misses",
                   "prompts the prefix trie matched nothing for (full "
                   "prefill)")
        m.describe("tpu_serving_prefix_cache_evictions",
                   "KV pages evicted from the prefix trie (LRU leaves) to "
                   "make room")
        m.describe("tpu_serving_kv_pages_total",
                   "KV pages in the preallocated paged-prefix arena")
        m.describe("tpu_serving_kv_pages_free",
                   "KV pages on the free list (unreferenced)")
        m.describe("tpu_serving_kv_pages_shared",
                   "KV pages serving more than one cached sequence "
                   "(trie-interior or multiply-referenced: the dedup win)")
        m.describe("tpu_serving_paged_decode",
                   "1 when the decode hot loop runs on per-slot page "
                   "tables over the shared arena (zero-copy prefix/"
                   "handoff adoption), 0 on the contiguous slot cache")
        m.describe("tpu_serving_paged_tp_shards",
                   "tensor-parallel shards the paged decode step runs "
                   "over (shard_mapped arena; 1 = single device, 0 = "
                   "paged loop off)")
        m.describe("tpu_serving_kv_handoff_pages",
                   "KV pages moved by prefill->decode handoffs (sender "
                   "counts serialized pages, receiver counts adopted)")
        m.describe("tpu_serving_kv_handoff_bytes",
                   "serialized KV bytes moved by prefill->decode handoffs")
        m.describe("tpu_serving_kv_handoff_failures",
                   "KV handoffs that failed (serialization, validation, "
                   "or adoption) — the router falls back to a full "
                   "prefill on the target")
        m.describe("tpu_serving_kv_handoff_stream_frames",
                   "streamed-handoff chunk frames moved (sender counts "
                   "pushed frames, receiver counts accepted)")
        m.describe("tpu_serving_kv_handoff_stream_rejects",
                   "chunk frames rejected on the decode side (torn/"
                   "duplicate/reordered/stale stream) — the whole stream "
                   "drops, nothing is adopted")
        m.describe("tpu_serving_kv_handoff_device_runs",
                   "KV page runs moved DEVICE-NATIVE (arena-to-arena, "
                   "zero host copies) between co-located replicas — "
                   "sender counts exports, receiver counts adoptions")
        m.describe("tpu_serving_kv_handoff_device_bytes",
                   "device-array bytes moved by device-native handoffs "
                   "(payload never touches numpy or HTTP)")
        m.describe("tpu_serving_kv_handoff_device_downgrades",
                   "device-path hops that fell back to the wire codec "
                   "(bus miss, domain mismatch, geometry/adoption "
                   "failure) — the ladder is device -> wire -> unified")
        m.describe("tpu_serving_kv_pull_runs",
                   "KV page runs moved by directory-planned pulls "
                   "(owner counts exports, cold replica counts "
                   "adoptions)")
        m.describe("tpu_serving_kv_pull_bytes",
                   "bytes moved by directory pulls (serialized blob "
                   "bytes on the shm/wire rungs, device-array bytes on "
                   "the device rung)")
        m.describe("tpu_serving_kv_pull_failures",
                   "pull hops that failed in transport or validation — "
                   "a GONE miss (owner evicted the pages since publish) "
                   "is counted by the directory's invalidations series "
                   "instead, not here")
        m.describe("tpu_serving_prefill_chunks",
                   "prompt chunks processed by chunked prefill "
                   "(serving_chunk_tokens > 0)")
        m.describe("tpu_serving_chunk_interleaved_steps",
                   "decode steps the engine ran BETWEEN prefill chunks "
                   "(the co-resident ITL protection chunking exists for)")
        m.describe("tpu_serving_spec_proposed",
                   "speculative draft tokens proposed")
        m.describe("tpu_serving_spec_accepted",
                   "speculative draft tokens accepted (committed for free)")
        m.describe("tpu_serving_paged_prefill_tokens",
                   "prompt tokens prefilled STRAIGHT INTO arena pages "
                   "(paged-native chunks — no dense scratch cache, no "
                   "fill_pages copy on the admission path)")
        m.describe("tpu_serving_paged_speculative_steps",
                   "speculative verify steps run on the paged loop "
                   "(multi-token paged kernels over per-slot page tables)")
        m.describe("tpu_serving_paged_speculative_rollback_pages",
                   "tail pages dropped by speculative rejection rollback "
                   "on the paged loop (uncommitted drafts' pages returned "
                   "to the pool)")
        m.describe("tpu_serving_request_latency_seconds",
                   "submit -> completion, whole request")
        m.describe("tpu_serving_ttft_seconds",
                   "submit -> first generated token (time to first token)",
                   buckets=TTFT_BUCKETS)
        m.describe("tpu_serving_inter_token_seconds",
                   "gap between consecutive streamed tokens of one request",
                   buckets=ITL_BUCKETS)
        m.describe("tpu_serving_queue_wait_seconds",
                   "submit -> prefill start (admission queue wait)",
                   buckets=TTFT_BUCKETS)
        m.describe("tpu_serving_batch_utilization",
                   "filled slots / max slots per decode step",
                   buckets=UTIL_BUCKETS)
        m.describe("tpu_serving_step_wall_seconds",
                   "decode-step wall time (flight recorder; the four "
                   "phase histograms below sum to it per step)",
                   buckets=STEP_BUCKETS)
        m.describe("tpu_serving_step_schedule_seconds",
                   "step phase: host-side batch assembly — slot-table "
                   "growth, lengths/page-table staging, draft proposals",
                   buckets=STEP_BUCKETS)
        m.describe("tpu_serving_step_kernel_seconds",
                   "step phase: device DISPATCH of the decode/verify jit "
                   "(async — materialization lands in the sample phase)",
                   buckets=STEP_BUCKETS)
        m.describe("tpu_serving_step_sample_seconds",
                   "step phase: logits materialization + per-slot "
                   "sampling (temperature/top-k/top-p, penalties, "
                   "logprobs)",
                   buckets=STEP_BUCKETS)
        m.describe("tpu_serving_step_commit_seconds",
                   "step phase: host-side token commit — stream "
                   "emission, stop checks, slot bookkeeping, rollback",
                   buckets=STEP_BUCKETS)
        m.describe("tpu_serving_step_tokens",
                   "tokens committed per decode step (speculative steps "
                   "commit several per slot)",
                   buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        m.describe("tpu_serving_step_ring_records",
                   "records currently held by the flight-recorder ring")
        m.describe("tpu_serving_step_ring_bytes",
                   "serialized bytes held by the flight-recorder ring "
                   "(hard-bounded by recorder_bytes)")
        m.describe("tpu_serving_recompiles",
                   "hot-path jit compiles BEYOND the first, per alarmed "
                   "function — any rise is a cache-key flap (changed "
                   "avals, shardings, or donation pattern recompiling "
                   "the hot loop)")
        # the port's own counters (its launch accounting of paged chunks,
        # its dense route, embeddings and adapter registry; the JAX engine
        # has no such series)
        m.describe("tpu_serving_paged_prefill_chunks",
                   "prompt chunks prefilled straight into arena pages, "
                   "whatever serving_chunk_tokens is (one paged chunk "
                   "step each)")
        m.describe("tpu_serving_dense_prefills",
                   "prompts prefilled through the dense-scratch route (a "
                   "full pool, an n > 1 group, or paged prefill off)")
        m.describe("tpu_serving_dense_prefill_heads",
                   "dense-route prefill heads (the flash forward over a "
                   "prompt's first chunk)")
        m.describe("tpu_serving_dense_prefill_chunks",
                   "dense-route prompt chunks appended after the head")
        m.describe("tpu_serving_embeds",
                   "embedding forwards (/v1/embeddings inputs)")
        m.describe("tpu_serving_adapters_registered",
                   "LoRA adapter registrations (new or rewritten)")
        # zero-seed every counter the fleet heartbeat reads cumulative:
        # the router differences them per beat, and a series that first
        # appears mid-flight reads as a restart to its guards
        m.incr("tpu_serving_admitted", 0)
        m.incr("tpu_serving_decode_steps", 0)
        m.incr("tpu_serving_engine_errors", 0)
        m.incr("tpu_serving_prefill_errors", 0)

    def _step_state(self) -> dict:
        """What the decode graphs step over: the arena, or the contiguous
        loop's batch cache."""
        return self._kv_store.arena if self._paged_loop else self._cache

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self._prefill_thread.join(timeout=10)

    def submit(self, prompt: list[int], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               logit_bias: Optional[dict] = None,
               seed: Optional[int] = None, stop: Optional[list] = None,
               stop_text: Optional[list] = None, logprobs: bool = False,
               on_token: Optional[Callable[[int], Any]] = None,
               adapter: str = "", trace_id: str = "", parent_span: str = "",
               span_id: str = "", tenant: str = "") -> Future:
        """Enqueue a generation request; resolves to {rid, tokens,
        latency_s, ttft_s} (+ "logprobs", one per token, with
        ``logprobs``). ``stop``: token sequences that end the request when
        the output's tail equals one; ``stop_text``: strings that end it
        when the decoded output contains one (needs ``decode_fn``);
        ``on_token(tok)`` sees each token from the engine thread, and a
        raising callback cancels the request. Invalid arguments resolve
        to ValueError; a queue at ``max_queue_depth`` to
        EngineOverloaded. ``adapter`` names a registered LoRA adapter
        ("" = the base model); an unknown name resolves to ValueError.
        ``trace_id``, ``parent_span`` and ``span_id`` place the request's
        spans in the caller's trace (the W3C traceparent the HTTP front
        parsed; ``span_id`` names the request's root span). ``tenant``
        is the cost meter's accounting label."""
        try:
            req = self._build_request(prompt, max_new_tokens, temperature,
                                      top_k, top_p, presence_penalty,
                                      frequency_penalty, logit_bias, seed,
                                      stop, stop_text, logprobs, on_token,
                                      adapter, trace_id, parent_span,
                                      span_id, tenant)
        except ValueError as exc:
            return _failed(exc)
        return self._enqueue(req, 1)[0]

    def submit_group(self, prompt: list[int], n: int,
                     seed: Optional[int] = None, **kw) -> list[Future]:
        """n requests over the identical prompt (OpenAI n > 1): the prompt
        prefills ONCE, through the dense-scratch route, and fans out to n
        slots. Member i samples with ``seed + i`` (when a seed is given),
        so sampled choices differ; ``kw`` are ``submit``'s. The caller's
        ``span_id`` names member 0's root span; the others mint their own
        in the same trace."""
        if not _is_int(n) or n < 1:
            return [_failed(ValueError(f"n must be a positive int, got "
                                       f"{n!r}"))]
        reqs = []
        try:
            for i in range(n):
                # member 0 carries the validation (a bad seed type fails
                # before any arithmetic)
                s_i = seed if seed is None or i == 0 else seed + i
                reqs.append(self._build_request(prompt, seed=s_i, **kw))
                kw.pop("span_id", None)
        except ValueError as exc:
            return [_failed(exc) for _ in range(n)]
        reqs[0].fanout = reqs[1:]
        return self._enqueue(reqs[0], n)

    def _enqueue(self, head: Request, n: int) -> list[Future]:
        """Admit ``head`` (with its fanout members, n requests in all) or
        fail all n at once: draining, or the queue at max_queue_depth."""
        members = [head] + list(head.fanout or [])
        with self._admit_lock:  # atomic check + put against racing submits
            if self._draining.is_set():
                self.metrics.incr("tpu_serving_drain_rejected")
                exc: Exception = EngineDraining(
                    "engine is draining; submit to another replica")
                return [_failed(exc) for _ in members]
            depth = self.queue_depth
            if self.sc.max_queue_depth and (
                    depth + n > self.sc.max_queue_depth):
                # the bounded-latency contract: an immediate typed
                # rejection, not an unbounded wait
                self.metrics.incr("tpu_serving_admission_rejected")
                exc = EngineOverloaded(
                    f"queue depth {depth} + {n} exceeds max_queue_depth "
                    f"{self.sc.max_queue_depth}; retry later")
                return [_failed(exc) for _ in members]
            with self._fanout_lock:
                self._queued_fanout += n - 1
            self._queue.put(head)
            self._queue_event.set()
        self.metrics.set_gauge("tpu_serving_queue_depth", self.queue_depth)
        return [r.future for r in members]

    def drain(self):
        """Stop admitting (submits resolve to EngineDraining) and finish
        everything in flight or queued. Idempotent."""
        with self._admit_lock:
            self._draining.set()
        self.metrics.set_gauge("tpu_serving_draining", 1)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def drained(self) -> bool:
        """Draining and nothing queued, in transit, ready or decoding."""
        if not self._draining.is_set():
            return False
        with self._transit_lock:
            if self._transit or self.queue_depth or self._ready.qsize():
                return False
        return self.active_slots == 0

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def queue_depth(self) -> int:
        """Every pending request: an n-member group counts n."""
        with self._fanout_lock:
            fanout = self._queued_fanout
        return self._queue.qsize() + fanout

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    def prefix_cache_stats(self) -> dict:
        with self._prefix_lock:
            if self._kv_store is not None:
                out = self._kv_store.stats()
                out["page_bytes"] = self._kv_store.page_bytes
                out["page_bytes_per_shard"] = \
                    self._kv_store.page_bytes_per_shard
            else:
                out = {"pages_total": 0, "pages_free": 0, "pages_shared": 0,
                       "pages_evictable": 0, "nodes": 0, "pinned": 0,
                       "adapters": [],
                       "dense_entries": len(self._dense_prefixes)}
            out["registered"] = len(self._registered)
        out["page_tokens"] = self.sc.kv_page_tokens
        return out

    def register_prefix(self, tokens: list[int]) -> None:
        """Prefill a shared prompt prefix (a system prompt) once and PIN
        its full pages in the trie: they are never evicted, so every later
        prompt starting with it skips those pages' prefill. Idempotent for
        the same tokens, and capped at ``max_prefixes`` distinct prefixes
        (ValueError past it: each pins arena pages for the engine's life).
        The prefix's tail past its last full page still prefills per
        request. A pool too full for an up-front run prefills through the
        dense-scratch route and pins the pages it can cache. Without a
        paged pool (a ring or mixed cache, or the prefix cache off) the
        prefix's whole single-request cache enters the dense store."""
        vocab = self.cfg.vocab_size
        if not tokens:
            raise ValueError("empty prefix")
        if not all(_is_int(t) and 0 <= t < vocab for t in tokens):
            raise ValueError(f"prefix tokens must be ints in [0, {vocab})")
        if len(tokens) > self.sc.cache_len - 1:
            raise ValueError(f"prefix length {len(tokens)} > cache budget "
                             f"{self.sc.cache_len - 1}")
        tokens = list(tokens)
        with self._prefix_lock:
            if tokens in self._registered:
                return
            self._check_registry_room()
        logits, single, _ = self._prefill_tokens(tokens)
        run = single if isinstance(single, _PagedRun) else None
        with self._prefix_lock:
            try:
                if tokens in self._registered:
                    return   # raced with an identical registration
                # re-check: a concurrent registration may have filled the
                # registry while this one prefilled outside the lock
                self._check_registry_room()
                self._registered.append(tokens)
                if self._dense_prefixes is not None:
                    if not self._dense_prefixes.has(tokens):
                        self._dense_prefixes.add(tokens, (logits, single))
                elif run is None:
                    _, evicted = self._kv_store.insert(0, tokens, single,
                                                       pin=True)
                    if evicted:
                        self.metrics.incr(
                            "tpu_serving_prefix_cache_evictions", evicted)
                elif run.store is self._kv_store:
                    # the prefill adopted the pages unpinned; this second
                    # walk pins them, then the run's own references drop
                    run.store.insert_ready(0, tokens, run.pages, pin=True)
            finally:
                if run is not None:
                    run.store.release(run.pages)
        if self._kv_store is not None:
            self._publish_prefix(0, tokens)
        self._update_page_gauges()

    def _check_registry_room(self) -> None:
        if len(self._registered) >= self.sc.max_prefixes:
            raise ValueError(
                f"prefix registry full ({self.sc.max_prefixes}); each entry "
                "pins KV pages — raise max_prefixes or restart to clear")

    def _covers_registered(self, tokens: list[int]) -> bool:
        """Does this prompt start with a registered prefix?"""
        return any(len(r) <= len(tokens) and tokens[:len(r)] == r
                   for r in self._registered)

    @property
    def adapter_names(self) -> tuple[str, ...]:
        with self._adapter_lock:
            return tuple(self._adapter_names)

    @property
    def multi_lora_enabled(self) -> bool:
        return self._adapters is not None

    @staticmethod
    def lora_dims(cfg: LlamaConfig, sc: ServingConfig) -> Optional[dict]:
        """The JAX engine's checks of the multi-LoRA settings; returns each
        target's (in, out) widths, or None with ``lora_rank`` 0."""
        if sc.lora_rank <= 0:
            return None
        if cfg.is_mla:
            raise ValueError("multi-LoRA serving does not support MLA "
                             "models (adapters target the wq/wk/wv "
                             "layout; MLA has w_dkv/w_uk/w_uv)")
        unknown = set(sc.lora_targets) - set(LORA_TARGETS)
        if unknown or not sc.lora_targets:
            raise ValueError(f"unknown lora_targets {sorted(unknown)}"
                             if unknown else "lora_targets is empty")
        if cfg.n_experts and set(sc.lora_targets) & {"w_gate", "w_up",
                                                     "w_down"}:
            raise ValueError("MoE configs have no dense mlp weights to "
                             "adapt; use attention targets")
        if sc.max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1 with lora_rank, "
                             f"got {sc.max_adapters}")
        e, hd, m = cfg.embed_dim, cfg.head_dim_, cfg.mlp_dim
        return {"wq": (e, cfg.n_heads * hd), "wk": (e, cfg.n_kv_heads * hd),
                "wv": (e, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, e),
                "w_gate": (e, m), "w_up": (e, m), "w_down": (m, e)}

    def register_adapter(self, name: str, source) -> int:
        """Install a LoRA adapter into a slot of the preallocated stacks and
        return the slot. ``source``: a LoRA-wrapped params tree
        (``models.lora.apply_lora``) or {target: {"a": (L, in, r), "b": (L,
        r, out), "scale": (L,) or a scalar}} of tensors or numpy arrays
        (``load_adapter``). Targets the source lacks are zero in its slot
        (the base projection); targets outside ``lora_targets`` are
        refused. A new name takes the next free slot ("adapter registry
        full" past ``max_adapters``); a registered name is rewritten in
        its slot. The write is in place (``copy_``) under the arena lock,
        after every in-flight prefill of that slot has finished and while
        new ones wait, so a prompt never mixes two versions of an adapter
        and no step graph recaptures; decoding requests of the slot read
        the new weights from the next step. The slot's cached prefix
        pages are dropped."""
        if self._adapters is None:
            raise ValueError("engine built without lora_rank; set "
                             "ServingConfig.lora_rank to enable adapters")
        if not name or not isinstance(name, str):
            raise ValueError("adapter name required")
        if isinstance(source, dict) and "layers" in source:
            src = {t: {"a": w["lora_a"], "b": w["lora_b"],
                       "scale": w["scale"]}
                   for t, w in source["layers"].items() if is_lora(w)}
        else:
            src = source
        if not src:
            raise ValueError("source carries no LoRA adapters")
        extra = set(src) - set(self.sc.lora_targets)
        if extra:
            raise ValueError(f"adapter targets {sorted(extra)} not in "
                             f"lora_targets {self.sc.lora_targets}")
        rows = {}
        for t, ad in src.items():
            stack = self._adapters[t]
            a = _as_tensor(ad["a"], stack["a"].dtype, self.device)
            b = _as_tensor(ad["b"], stack["b"].dtype, self.device)
            want_a = (stack["a"].shape[0],) + tuple(stack["a"].shape[2:])
            want_b = (stack["b"].shape[0],) + tuple(stack["b"].shape[2:])
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(
                    f"{t}: adapter shapes {tuple(a.shape)}/{tuple(b.shape)}"
                    f" don't match rank-{self.sc.lora_rank} stacks for "
                    "this model")
            scale = _as_tensor(ad["scale"], torch.float32, self.device)
            rows[t] = (a, b, scale.expand(stack["scale"].shape[0]))
        with self._register_lock:
            with self._adapter_lock:
                slot = self._adapter_names.get(name)
                if slot is None:
                    slot = len(self._adapter_names) + 1
                    if slot > self.sc.max_adapters:
                        raise ValueError(f"adapter registry full "
                                         f"({self.sc.max_adapters})")
            with self._adapter_cond:
                self._adapter_writing.add(slot)
                self._adapter_cond.wait_for(
                    lambda: not self._adapter_readers.get(slot))
            try:
                with self._prefix_lock:
                    for t, stack in self._adapters.items():
                        if t in rows:
                            for key, row in zip(("a", "b", "scale"),
                                                rows[t]):
                                stack[key][:, slot].copy_(row)
                        else:
                            for v in stack.values():
                                v[:, slot].zero_()
                    # KV cached under the old weights is stale: the
                    # trie's subtree, or the dense store's variants
                    if self._kv_store is not None:
                        self._kv_store.trie.drop_adapter(slot)
                    else:
                        self._dense_prefixes.drop_adapter(slot)
                with self._adapter_lock:
                    self._adapter_names[name] = slot
                self.metrics.incr("tpu_serving_adapters_registered")
            finally:
                with self._adapter_cond:
                    self._adapter_writing.discard(slot)
                    self._adapter_cond.notify_all()
        self._update_page_gauges()
        return slot

    def _adapter_kw(self, adapter_id: int) -> dict:
        """A single-request step's adapter arguments: the stacks and the
        request's slot, or nothing when the engine serves no adapters."""
        if self._adapters is None:
            return {}
        return {"adapters": self._adapters,
                "adapter_ids": torch.tensor([adapter_id], dtype=torch.int32,
                                            device=self.device)}

    def _step_adapter_kw(self) -> dict:
        """A decode or verify step's adapter arguments: the stacks and
        every slot's adapter id."""
        if self._adapters is None:
            return {}
        return {"adapters": self._adapters,
                "adapter_ids": self._slot_adapter}

    def _prefill_reader(self, adapter_id: int):
        """Hold ``adapter_id`` against re-registration for one prefill
        (a registration in progress makes it wait). Returns the release
        callable."""
        if adapter_id == 0:
            return lambda: None
        with self._adapter_cond:
            self._adapter_cond.wait_for(
                lambda: adapter_id not in self._adapter_writing)
            self._adapter_readers[adapter_id] = \
                self._adapter_readers.get(adapter_id, 0) + 1

        def release():
            with self._adapter_cond:
                self._adapter_readers[adapter_id] -= 1
                self._adapter_cond.notify_all()
        return release

    def _graphs(self) -> list:
        return [g for g in (self._paged_step, self._paged_verify,
                            self._decode, self._verify) if g is not None]

    def graphs_snapshot(self) -> dict:
        """The watchdog's per-graph capture counts, with each graph's
        width, replays and the device memory around its capture."""
        out = self.watchdog.snapshot()
        for g in self._graphs():
            out[g.name].update(width=g.fn.width, replays=g.fn.replays,
                               capture_memory=g.fn.capture_memory)
        return out

    def debug_steps(self, n: int = 64) -> dict:
        """The GET /debug/steps payload: the recorder's newest ``n`` step
        records and its rollup (when on), and the watchdog's per-graph
        capture counts (always)."""
        out = ({"enabled": False} if self.recorder is None
               else self.recorder.snapshot(n))
        out["recompiles"] = self.watchdog.snapshot()
        return out

    def embed(self, tokens: list[int]) -> list[float]:
        """Mean-pooled final-norm hidden state of ``tokens`` (the
        /v1/embeddings backing): one exact-length ``forward`` (the flash
        kernel; int4 weights through ``int4_matmul``), pooled in f32. Runs
        on the caller's thread under the arena lock, which orders its
        launches with the engine's steps and keeps them out of a
        capture."""
        if not tokens:
            raise ValueError("empty input")
        if len(tokens) > self.sc.max_prefill_len:
            # rejecting beats truncating: usage must reflect what was
            # embedded
            raise ValueError(
                f"input length {len(tokens)} exceeds this server's "
                f"embedding context ({self.sc.max_prefill_len} tokens)")
        if not all(_is_int(t) and 0 <= t < self.cfg.vocab_size
                   for t in tokens):
            raise ValueError("input token ids must be within the vocabulary")
        toks = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        with self._prefix_lock, torch.no_grad():
            hidden = self.model.forward(self.params, toks,
                                        return_hidden=True, train=False)
            # pool in f32: bf16 sums over hundreds of positions lose
            # ~1e-2 relative
            pooled = hidden[0].float().mean(dim=0)
            self.metrics.incr("tpu_serving_embeds")
        return pooled.tolist()

    def debug_snapshot(self) -> dict:
        """/debug/engine: per-slot state, queue depths, pool occupancy and
        the counters. Fields are single reads; a snapshot may straddle a
        step."""
        now = self._perf()
        slots = []
        for i, s in enumerate(self._slots):
            r = s.request
            if r is None:
                slots.append({"slot": i, "state": "free"})
                continue
            entry = {"slot": i, "state": "decoding", "rid": r.rid,
                     "trace_id": r.trace_id or None,
                     "age_s": round(now - r.submitted_at, 4),
                     "prompt_tokens": len(r.prompt),
                     "generated_tokens": len(s.generated),
                     "remaining_tokens": s.remaining,
                     "adapter_id": r.adapter_id}
            if self._paged_loop:
                entry["pages"] = len(s.pages)
            slots.append(entry)
        counters = dict(self.counters)
        with self._handoff_lock:
            handoff_inflight = self.handoff_inflight
            handoffs_total = self.handoffs_total
        kv_tokens = sum(s.get("prompt_tokens", 0) + s.get("generated_tokens", 0)
                        for s in slots)
        sc, dtype = self.sc, str(self.cfg.dtype).removeprefix("torch.")
        weights = ("int4" if sc.quantize_int4 else
                   "int8" if sc.quantize_int8 else dtype)
        return {"schema_version": 1, "model": self.cfg.name,
                "weights": weights,
                "kv": "int8" if sc.quantize_kv_int8 else dtype,
                # MLA caches one headless latent row a position
                "kv_layout": "latent" if self.cfg.is_mla else "heads",
                "device": str(self.device), "alive": self.alive,
                "draining": self.draining, "drained": self.drained,
                "slots": slots, "active_slots": self.active_slots,
                "max_slots": self.sc.slots, "queue_depth": self.queue_depth,
                "ready_queue": self._ready.qsize(),
                "in_transit": self._transit, "kv_cache_tokens": kv_tokens,
                # the prefill role's load (handler-thread hops) and its
                # completed hops, for the fleet reporter
                "handoff_inflight": handoff_inflight,
                "handoffs_total": handoffs_total,
                "cache_len": self.sc.cache_len,
                "paged_decode": self._paged_loop,
                "paged_prefill": self._paged_prefill_on,
                # the contiguous loop's batch cache: linear, a ring (a
                # uniform window) or mixed (rings and full-length sections)
                "cache_layout": self._cache_layout(),
                "ring_len": self._ring_len,
                # the tensor degree the paged loop runs at (the JAX
                # engine's tpu_serving_paged_tp_shards): 1 on one device,
                # 0 with the loop off
                "paged_tp_shards": self.model.tp if self._paged_loop else 0,
                # the tensor degree either loop runs at, and the kv-head
                # shards of the contiguous loop's batch cache
                "tensor_parallel": self.model.tp,
                # the expert degree the MoE layers' expert FFN runs at
                "expert_parallel": (self.model.mesh.expert
                                    if self.model.mesh is not None else 1),
                "cache_head_shards": (None if self._paged_loop else
                                      self.model.cache_shards(self._cache)),
                "kv_arena_shards": self._arena_shards,
                "speculate_k": sc.speculate_k,
                "sliding_window": self._window,
                "serving_chunk_tokens": self._chunk_tokens,
                "multi_lora": self.multi_lora_enabled,
                "lora_rank": sc.lora_rank if self._adapters else 0,
                "adapters": list(self.adapter_names),
                "prefix_cache": self.prefix_cache_stats(),
                "counters": counters,
                "graphs": self.graphs_snapshot(),
                "total_generated": self.total_generated,
                "last_error": self.last_error}

    def _cache_layout(self) -> str:
        """The contiguous loop's cache layout ("paged" on the paged
        loop)."""
        if self._paged_loop:
            return "paged"
        return self.contiguous_layout(self.cfg, self._ring_len)

    @staticmethod
    def contiguous_layout(cfg: LlamaConfig, ring_len: Optional[int]) -> str:
        """The layout ``contiguous_cache`` builds for ``ring_len``."""
        if ring_len is None:
            return "linear"
        return "mixed" if cfg.sliding_window_pattern > 1 else "ring"

    # -- submission -----------------------------------------------------------

    def _build_request(self, prompt, max_new_tokens=None, temperature=None,
                       top_k=0, top_p=1.0, presence_penalty=0.0,
                       frequency_penalty=0.0, logit_bias=None, seed=None,
                       stop=None, stop_text=None, logprobs=False,
                       on_token=None, adapter="", trace_id="",
                       parent_span="", span_id="", tenant="") -> Request:
        """``submit``'s arguments, validated, as a Request (ValueError
        when one is invalid)."""
        sc, vocab = self.sc, self.cfg.vocab_size
        if not prompt:
            raise ValueError("empty prompt")
        if not all(isinstance(t, int) and not isinstance(t, bool)
                   and 0 <= t < vocab for t in prompt):
            # an out-of-range id would index past the embedding table
            raise ValueError(f"prompt tokens must be ints in [0, {vocab})")
        if len(prompt) > sc.cache_len - 1:
            raise ValueError(f"prompt length {len(prompt)} > cache budget "
                             f"{sc.cache_len - 1}")
        if max_new_tokens is None:
            max_new_tokens = sc.max_new_tokens
        if not _is_int(max_new_tokens) or max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be a positive int, got "
                             f"{max_new_tokens!r}")
        if temperature is None:
            temperature = sc.temperature   # the engine's default
        if not _is_num(temperature) or temperature < 0.0:
            raise ValueError(f"temperature must be a non-negative number, "
                             f"got {temperature!r}")
        if not _is_int(top_k) or top_k < 0:
            raise ValueError(f"top_k must be a non-negative int, got "
                             f"{top_k!r}")
        if not _is_num(top_p) or not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p!r}")
        for name, pv in (("presence_penalty", presence_penalty),
                         ("frequency_penalty", frequency_penalty)):
            if not _is_num(pv) or not -2.0 <= pv <= 2.0:
                raise ValueError(f"{name} must be in [-2, 2], got {pv!r}")
        if logit_bias:
            try:
                logit_bias = {int(t): float(b) for t, b in logit_bias.items()}
            except (TypeError, ValueError, AttributeError):
                raise ValueError("logit_bias must map token ids to numbers")
            if not all(0 <= t < vocab and -100.0 <= b <= 100.0
                       for t, b in logit_bias.items()):
                raise ValueError("logit_bias keys must be valid token ids "
                                 "and biases in [-100, 100]")
        stop = stop or []
        if not (isinstance(stop, list) and all(
                isinstance(q, list) and q and all(_is_int(t) for t in q)
                for q in stop)):
            raise ValueError("stop must be a list of non-empty token lists")
        stop_text = stop_text or []
        if not (isinstance(stop_text, list)
                and all(isinstance(q, str) and q for q in stop_text)):
            raise ValueError("stop_text must be a list of non-empty strings")
        if stop_text and self._decode_fn is None:
            raise ValueError("stop_text needs an engine decode_fn "
                             "(tokenizer)")
        adapter_id = 0
        if adapter:
            with self._adapter_lock:
                adapter_id = self._adapter_names.get(adapter)
            if adapter_id is None:
                raise ValueError(f"unknown adapter {adapter!r}")
        if seed is None:
            with self._seed_lock:
                seed = int(self._seed_rng.integers(0, 2 ** 32))
        elif not _is_int(seed):
            raise ValueError(f"seed must be an int, got {seed!r}")
        return Request(prompt=list(prompt),
                       max_new_tokens=min(max_new_tokens,
                                          sc.cache_len - len(prompt)),
                       rid=uuid.uuid4().hex[:8], future=Future(),
                       submitted_at=self._perf(),
                       temperature=float(temperature), top_k=top_k,
                       top_p=float(top_p),
                       presence_penalty=float(presence_penalty),
                       frequency_penalty=float(frequency_penalty),
                       logit_bias=logit_bias or None,
                       seed=seed & 0xFFFFFFFF, stop=[list(q) for q in stop],
                       stop_texts=list(stop_text), logprobs=bool(logprobs),
                       on_token=on_token, adapter_id=adapter_id,
                       trace_id=str(trace_id or ""),
                       span_id=str(span_id or ""),
                       parent_span_id=str(parent_span or ""),
                       tenant=str(tenant or ""))

    # -- prefill thread -------------------------------------------------------

    def _prefill_loop(self):
        while not self._stop.is_set():
            with self._transit_lock:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    req = None
                else:
                    self._transit += 1
            if req is None:
                self._queue_event.wait(0.05)
                self._queue_event.clear()
                continue
            try:
                self._prefill_one(req)
            finally:
                with self._transit_lock:
                    self._transit -= 1

    def _prefill_one(self, req: Request):
        """One dequeued request and its fanout members: one prefill, then
        one ready entry per live member, each with its own first token
        sampled from the shared last-position logits."""
        self.metrics.set_gauge("tpu_serving_queue_depth", self.queue_depth)
        members = [req] + list(req.fanout or [])
        with self._fanout_lock:
            self._queued_fanout -= len(members) - 1
        live = [r for r in members if not r.future.cancelled()]
        self.metrics.incr("tpu_serving_cancelled", len(members) - len(live))
        if not live:
            return
        dequeued = self._perf()
        for r in live:
            r.dequeued_at = dequeued
            self.metrics.observe("tpu_serving_queue_wait_seconds",
                                 dequeued - r.submitted_at)
        single = None
        entries = []
        try:
            # a group needs one bindable cache per member, and a page
            # run's partial tail page can belong to one slot only
            release = self._prefill_reader(req.adapter_id)
            try:
                last_logits, single, matched = self._prefill_tokens(
                    req.prompt, single_only=len(live) > 1,
                    adapter_id=req.adapter_id)
            finally:
                release()
            prefill_done = self._perf()
            for r in live:
                r.prefill_done_at = prefill_done
                r.matched_prefix_tokens = matched
            for r in live:
                row = last_logits
                if r.logit_bias:
                    brow = torch.from_numpy(_bias_row(r.logit_bias,
                                                      self.cfg.vocab_size))
                    row = row.float() + brow.to(self.device)[None, :]
                # penalties count generated tokens only: none apply here
                first = _sample(row, [r.seed], [0], [r.temperature],
                                [r.top_k], [r.top_p])[0]
                first_lp = None
                if r.logprobs:
                    # of the distribution sampled (biased, never penalized)
                    first_lp = float(torch.log_softmax(row[0].float(),
                                                       dim=-1)[first])
                entries.append((r, single, first, first_lp))
        except EngineOverloaded as exc:   # no route can hold the prompt
            self.metrics.incr("tpu_serving_admission_rejected", len(live))
            for r in live:
                _fail_future(r.future, exc)
            return
        except Exception as exc:  # noqa: BLE001 — one poisoned prompt only
            log.exception("prefill of %s failed", req.rid)
            self.metrics.incr("tpu_serving_prefill_errors")
            if isinstance(single, _PagedRun):
                with self._prefix_lock:
                    single.store.release(single.pages)
            for r in live:
                _fail_future(r.future, exc)
            return
        for entry in entries:
            while not self._stop.is_set():
                try:
                    self._ready.put(entry, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _prefill_tokens(self, tokens: list[int], single_only: bool = False,
                        adapter_id: int = 0
                        ) -> tuple[torch.Tensor, Any, int]:
        """A whole prompt -> (last logits (1, V), a _PagedRun or a dense
        single-request cache, tokens served from the prefix cache). The
        native route scatters straight into an up-front page run; when the
        pool cannot hold that run, with ``single_only`` (fanout groups),
        with ``paged_prefill`` off and on the contiguous loop over a paged
        pool, the prompt takes the dense-scratch route. Without a paged
        pool it goes through the dense prefix store (``_prefill_dense``).
        ``adapter_id`` picks the adapter and the trie root."""
        if self._kv_store is None:
            return self._prefill_dense(tokens, adapter_id)
        if self._paged_prefill_on and not single_only:
            out = self._prefill_paged_native(tokens, adapter_id)
            if out is not None:
                return out
            # pool too full for an up-front run: the dense route below
            # needs pages only for what it caches, and at binding
        return self._prefill_paged_dense(tokens, adapter_id)

    def _count_miss(self, tokens: list[int], adapter_id: int) -> None:
        """A prefix-cache miss; an adapter's first prompt over a registered
        prefix fills that adapter's own copy of the prefix's pages."""
        self.metrics.incr("tpu_serving_prefix_cache_misses")
        if adapter_id and self._covers_registered(tokens):
            self.metrics.incr("tpu_serving_prefix_adapter_fills")

    def _prefill_paged_dense(self, tokens: list[int], adapter_id: int = 0
                             ) -> tuple[torch.Tensor, dict, int]:
        """The dense-scratch route: the prompt's cached full pages gather
        from the arena into a fresh single-request cache (at least the
        last token recomputes, for its logits) and the rest appends
        through ``prefill_chunk_step``, or with no hit the whole prompt
        prefills through ``_prefill_raw``. Then the prompt's full pages
        enter the trie by copy (evicting as they go; best effort)."""
        store = self._kv_store
        single = None
        self.metrics.incr("tpu_serving_dense_prefills")
        with self._prefix_lock:
            m = store.match(adapter_id, tokens)
            if m.pages:
                try:
                    single = store.gather(m.pages, self._fresh_cache())
                finally:
                    store.release(m.pages)
        if single is not None:
            self.metrics.incr("tpu_serving_prefix_cache_hits")
            if self._covers_registered(tokens):
                self.metrics.incr("tpu_serving_prefix_hits")
            last_logits, single = self._append_chunks(
                single, tokens[m.matched_tokens:], None, adapter_id)
        else:
            self._count_miss(tokens, adapter_id)
            last_logits, single = self._prefill_raw(tokens, adapter_id)
        try:
            with self._prefix_lock:
                _, evicted = store.insert(adapter_id, tokens, single)
            if evicted:
                self.metrics.incr("tpu_serving_prefix_cache_evictions",
                                  evicted)
            self._publish_prefix(adapter_id, tokens)
        except Exception:  # noqa: BLE001 — caching is best-effort
            log.exception("prefix-cache insert failed; serving uncached")
        self._update_page_gauges()
        return last_logits, single, m.matched_tokens

    def _prefill_dense(self, tokens: list[int], adapter_id: int = 0
                       ) -> tuple[torch.Tensor, dict, int]:
        """The registered-prefix path of the contiguous loop without a
        paged pool (the JAX ``_prefill_dense``): the longest registered
        prefix wins and the rest of the prompt appends to a copy of its
        cache under the request's adapter (the store's stays as
        registered). An adapter's first prompt over the prefix prefills
        the prefix under that adapter once and stores the variant, LRU
        bounded (``tpu_serving_prefix_adapter_fills``); later ones copy
        it. No hit: the whole prompt through ``_prefill_raw``."""
        dense = self._dense_prefixes
        with self._prefix_lock:
            entry = dense.lookup(tokens)
            var = entry.variants.get(adapter_id) if entry is not None else None
            if var is not None:
                if adapter_id != 0:
                    dense.touch(entry, adapter_id)
                last_logits, cached = var
                single = {k: v.clone() for k, v in cached.items()}
        if entry is None:
            last_logits, single = self._prefill_raw(tokens, adapter_id)
            return last_logits, single, 0
        if var is None:
            # this adapter's first prompt over the prefix: its variant
            # (adapter deltas reach the prefix's K/V)
            last_logits, cached = self._prefill_raw(entry.tokens, adapter_id)
            with self._prefix_lock:
                dense.put_variant(entry, adapter_id, (last_logits, cached))
            self.metrics.incr("tpu_serving_prefix_adapter_fills")
            single = {k: v.clone() for k, v in cached.items()}
        else:
            self.metrics.incr("tpu_serving_prefix_hits")
        last_logits, single = self._append_chunks(
            single, tokens[len(entry.tokens):], last_logits, adapter_id)
        return last_logits, single, len(entry.tokens)

    def _fresh_cache(self, batch: int = 1) -> dict:
        """One construction path for every contiguous cache (the batch
        cache and prefill singles; the JAX ``_fresh_cache``): linear, or
        with a ring length a ring (uniform window) or a mixed cache
        (interleave)."""
        return self.contiguous_cache(self.model, self.sc, self._ring_len,
                                     batch)

    @staticmethod
    def contiguous_cache(model: LlamaModel, sc: ServingConfig,
                         ring_len: Optional[int], batch: int = 1) -> dict:
        """A contiguous cache of ``batch`` rows for ``sc``: linear without
        a ring length, else a ring (uniform window) or a mixed cache
        (interleave) of ``ring_len`` slots a windowed layer."""
        quant = sc.quantize_kv_int8
        if ring_len is None:
            return model.init_cache(batch, sc.cache_len, quantize=quant)
        if model.cfg.sliding_window_pattern > 1:
            return model.init_mixed_cache(batch, sc.cache_len, ring_len,
                                          quantize=quant)
        return model.init_ring_cache(batch, ring_len, quantize=quant)

    @staticmethod
    def _pick_ring_len(cfg: LlamaConfig, sc: ServingConfig) -> Optional[int]:
        """The ring length of the windowed layers on the contiguous loop,
        or None for a linear cache (the JAX ``_pick_ring_len``, verbatim,
        so the two engines' caches have one shape): the window plus the
        most tokens one call writes, a prefill chunk padded to the JAX
        engine's pow2 bucket (capped at max_prefill_len; the port's chunks
        are exact, so this is slack to spare) or a verify width, rounded
        up to 128. Auto stays linear when the ring would not be shorter
        than cache_len."""
        windowed = cfg.sliding_window is not None
        if sc.ring_cache is False or (sc.ring_cache is None and not windowed):
            return None
        if not windowed:
            raise ValueError("ring_cache=True needs a model with a "
                             "sliding window")
        if sc.serving_chunk_tokens:
            b = 16
            while b < sc.serving_chunk_tokens:
                b *= 2
            eff = max(sc.serving_chunk_tokens, min(b, sc.max_prefill_len))
        else:
            eff = sc.max_prefill_len
        slack = max(eff, sc.speculate_k + 1)
        ring = -(-(cfg.sliding_window + slack) // 128) * 128
        if sc.ring_cache is None and ring >= sc.cache_len:
            return None  # no memory win: stay linear
        return ring

    @staticmethod
    def check_loop(cfg: LlamaConfig, sc: ServingConfig
                   ) -> tuple[bool, bool, Optional[int]]:
        """The decode loop ``sc`` selects for ``cfg`` (the JAX engine's
        eligibility rule): (the paged loop, paged-native prefill, the
        contiguous loop's ring length or None). The paged loop runs when
        the layout pages (a uniform window does, the interleave's split
        cache does not), the prefix cache is on (the arena holds the
        slots), pages are smaller than a slot, an explicit pool holds every
        slot's residency and neither ``paged_decode`` False nor
        ``ring_cache`` True turns it off.
        Raises ValueError for a setting that cannot hold. Both loops serve
        speculation and every tensor degree the mesh serves
        (``parallel.sharding.check_tensor_parallel``)."""
        t = sc.kv_page_tokens
        slot_pages = -(-sc.cache_len // t)
        ring_len = ServingEngine._pick_ring_len(cfg, sc)
        layout_pageable = (cfg.sliding_window is None
                           or cfg.sliding_window_pattern == 1)
        pageable = (sc.prefix_cache_enabled and t < sc.cache_len
                    and layout_pageable and sc.ring_cache is not True)
        if (pageable and sc.paged_decode is not False
                and 0 < sc.kv_pool_pages < sc.slots * slot_pages):
            # the port refuses where the JAX engine would quietly leave the
            # paged loop: the decode slots live in the arena
            raise ValueError(
                f"kv_pool_pages must be 0 (auto) or >= slots * "
                f"ceil(cache_len / kv_page_tokens) = {sc.slots * slot_pages}"
                f", got {sc.kv_pool_pages} (paged_decode=False serves a "
                "smaller pool from the contiguous loop)")
        eligible = pageable and (sc.kv_pool_pages == 0
                                 or sc.kv_pool_pages >= sc.slots * slot_pages)
        if sc.paged_decode is True and not eligible:
            raise ValueError(
                "paged_decode=True needs a pageable KV layout (plain dense, "
                "int8-KV, MLA, MLA+int8, or a UNIFORM sliding window — the "
                "windowed interleave's split ring/global cache cannot page, "
                "and ring_cache=True pins the contiguous ring), "
                "prefix_cache_enabled, "
                "kv_page_tokens < cache_len, and kv_pool_pages 0 (auto) or "
                f">= slots * ceil(cache_len / kv_page_tokens) = "
                f"{sc.slots * slot_pages}")
        paged = eligible and sc.paged_decode is not False
        if sc.paged_prefill is True and not paged:
            raise ValueError(
                "paged_prefill=True needs the paged decode loop (a "
                "paged_decode-eligible layout with paged_decode not "
                "disabled) — the prefilled pages ARE the slot storage")
        if paged:
            # the window's memory win comes back as page recycling
            return True, sc.paged_prefill is not False, None
        return False, False, ring_len

    def _prefill_raw(self, tokens: list[int], adapter_id: int = 0,
                     on_chunk=None) -> tuple[torch.Tensor, dict]:
        """Prefill into a fresh single-request cache (linear, ring or
        mixed), no prefix cache: the head (a chunk's length) through
        ``prefill``, the flash kernel, the rest through
        ``_append_chunks``. ``on_chunk(cache, tokens done)`` fires after
        the head and each chunk (the streamed handoff's hook)."""
        single = self._fresh_cache()
        head = tokens[:self._chunk_tokens or self.sc.max_prefill_len]
        toks = torch.tensor([head], dtype=torch.int32, device=self.device)
        with self._prefix_lock:   # behind the engine thread's replays
            last_logits, single = self.model.prefill(
                self.params, toks, single, **self._adapter_kw(adapter_id))
            self.metrics.incr("tpu_serving_dense_prefill_heads")
            if self._chunk_tokens:   # the head is a chunk, as in JAX
                self.metrics.incr("tpu_serving_prefill_chunks")
        if on_chunk is not None:
            on_chunk(single, len(head))
        if self._chunk_tokens and len(tokens) > len(head):
            self._yield_between_chunks()
        return self._append_chunks(single, tokens[len(head):], last_logits,
                                   adapter_id, on_chunk, len(head))

    def _append_chunks(self, single: dict, toks: list[int], last_logits,
                       adapter_id: int = 0, on_chunk=None, done: int = 0
                       ) -> tuple[torch.Tensor, dict]:
        """Append ``toks`` to a single-request cache chunk by chunk through
        ``prefill_chunk_step``; chunks are ``serving_chunk_tokens`` long
        when set (one decode step between them while a slot decodes), else
        ``max_prefill_len``. ``on_chunk(cache, tokens done)`` fires after
        each chunk, before the yield, ``done`` counting the tokens already
        in the cache. Returns (last logits, cache)."""
        step = self._chunk_tokens or self.sc.max_prefill_len
        for start in range(0, len(toks), step):
            chunk = toks[start:start + step]
            ctoks = torch.tensor([chunk], dtype=torch.int32,
                                 device=self.device)
            true_len = torch.tensor([len(chunk)], dtype=torch.int32,
                                    device=self.device)
            with self._prefix_lock:
                last_logits, single = self.model.prefill_chunk_step(
                    self.params, ctoks, single, true_len,
                    **self._adapter_kw(adapter_id))
                self.metrics.incr("tpu_serving_dense_prefill_chunks")
                if self._chunk_tokens:
                    self.metrics.incr("tpu_serving_prefill_chunks")
            done += len(chunk)
            if on_chunk is not None:
                on_chunk(single, done)
            if self._chunk_tokens and start + step < len(toks):
                self._yield_between_chunks()
        return last_logits, single

    def _yield_between_chunks(self) -> None:
        """Wait for one decode step while a slot decodes (ChunkArbiter)."""
        ran = self._arbiter.yield_for_decode(lambda: self.active_slots > 0)
        if ran:
            self.metrics.incr("tpu_serving_chunk_interleaved_steps", ran)
            if self.recorder is not None:
                self.recorder.event("chunk_interleave", steps=ran)

    def _prefill_paged_native(self, tokens: list[int], adapter_id: int = 0,
                              on_chunk=None
                              ) -> Optional[tuple[torch.Tensor, _PagedRun,
                                                  int]]:
        """Prefill straight into the arena: allocate the prompt's page run
        up front (a prefix hit's matched pages join it in place), scatter
        each chunk's K/V into those pages, then insert the run's full pages
        into the trie by reference. Chunks are ``serving_chunk_tokens``
        long when set, and then the thread yields one decode step between
        them while a slot decodes; else ``max_prefill_len``.
        ``on_chunk(pages, tokens done)`` fires after each chunk, before the
        yield (the streamed handoff exports the pages the chunk just
        wrote). Returns (last logits (1, V), run, tokens matched), or None
        when the pool cannot hold the run."""
        store = self._kv_store
        t = self.sc.kv_page_tokens
        n_pages = -(-len(tokens) // t)
        with self._prefix_lock:
            m = store.match(adapter_id, tokens)
            try:
                tail = (store.alloc_run(n_pages - len(m.pages))
                        if n_pages > len(m.pages) else [])
            except PoolExhausted:
                store.release(m.pages)
                return None
        covered = m.matched_tokens
        pages = list(m.pages) + tail
        if covered:
            self.metrics.incr("tpu_serving_prefix_cache_hits")
            if self._covers_registered(tokens):
                self.metrics.incr("tpu_serving_prefix_hits")
        else:
            self._count_miss(tokens, adapter_id)
        ad_kw = self._adapter_kw(adapter_id)
        row = np.zeros((1, self._slot_pages_max), np.int32)
        row[0, :len(pages)] = pages
        dev = self.device
        table = torch.tensor(row, device=dev)
        lengths = torch.tensor([covered], dtype=torch.int32, device=dev)
        rest = tokens[covered:]
        step = self._chunk_tokens or self.sc.max_prefill_len
        last_logits = None
        try:
            for start in range(0, len(rest), step):
                chunk = rest[start:start + step]
                ctoks = torch.tensor([chunk], dtype=torch.int32, device=dev)
                true_len = torch.tensor([len(chunk)], dtype=torch.int32,
                                        device=dev)
                with self._prefix_lock:
                    last_logits, _, lengths = \
                        self.model.paged_prefill_chunk_step(
                            self.params, ctoks, store.arena, table, lengths,
                            true_len, **ad_kw)
                    self.metrics.incr("tpu_serving_paged_prefill_chunks")
                    if self._chunk_tokens:
                        self.metrics.incr("tpu_serving_prefill_chunks")
                self.metrics.incr("tpu_serving_paged_prefill_tokens",
                                  len(chunk))
                if on_chunk is not None:
                    on_chunk(pages, covered + start + len(chunk))
                if self._chunk_tokens and start + step < len(rest):
                    self._yield_between_chunks()
            with self._prefix_lock:
                store.insert_ready(adapter_id, tokens, pages)
            self._publish_prefix(adapter_id, tokens)
        except Exception:
            with self._prefix_lock:
                store.release(pages)
            raise
        self._update_page_gauges()
        return last_logits, _PagedRun(pages, len(tokens), store), covered

    # -- fleet KV movement: directory publishes, handoffs, pulls -------------

    def _adapter_name_for(self, adapter_id: int) -> Optional[str]:
        """The registered name behind an adapter slot ("" for the base
        slot 0); None when no live name holds the slot, and the caller
        skips the publish rather than key the run under the wrong
        adapter."""
        if adapter_id == 0:
            return ""
        with self._adapter_lock:
            for name, slot in self._adapter_names.items():
                if slot == adapter_id:
                    return name
        return None

    def _adapter_root_id(self, adapter: str) -> int:
        """Adapter NAME -> trie root slot ("" is the base root 0). An
        unknown name raises KVPullMiss: the directory claimed an adapter
        this replica does not hold, the same fall back to prefill as
        evicted pages."""
        if not adapter:
            return 0
        with self._adapter_lock:
            slot = self._adapter_names.get(adapter)
        if slot is None:
            raise KVPullMiss(f"adapter {adapter!r} is not registered on "
                             "this replica")
        return slot

    def _publish_prefix(self, adapter_id: int, tokens: list) -> None:
        """Queue this run's LONGEST page-boundary key for the global prefix
        directory (the ReplicaReporter drains the queue into heartbeats).
        One key a run suffices: the router walks a request's chain
        longest-first, and every extension's chain holds this key. Best
        effort: a lost publish costs the fleet one pull, never a
        request."""
        try:
            t = self.sc.kv_page_tokens
            n_pages = len(tokens) // t
            if n_pages < 1:
                return
            adapter = self._adapter_name_for(adapter_id)
            if adapter is None:
                return
            key = prefix_key(tokens[:n_pages * t], t, adapter)
            with self._publish_lock:
                self._prefix_publishes[key] = {
                    "key": key, "pages": n_pages,
                    "model": self.cfg.name, "adapter": adapter}
                self._prefix_publishes.move_to_end(key)
                while len(self._prefix_publishes) > 256:
                    self._prefix_publishes.popitem(last=False)
            hook = self.prefix_publish_hook
            if hook is not None:
                hook()
        except Exception:  # noqa: BLE001 — publishing is best-effort
            log.exception("prefix publish failed; the directory misses "
                          "this run until its next insert")

    def take_prefix_publishes(self) -> list:
        """Drain the pending directory publishes for a heartbeat; the
        reporter re-queues them if the beat fails."""
        with self._publish_lock:
            out = list(self._prefix_publishes.values())
            self._prefix_publishes.clear()
        return out

    def requeue_prefix_publishes(self, publishes: list) -> None:
        """Give back the publishes of a FAILED heartbeat; a newer pending
        entry wins a key collision (it carries the fresher page count)."""
        with self._publish_lock:
            for pub in publishes:
                key = pub.get("key")
                if key and key not in self._prefix_publishes:
                    self._prefix_publishes[key] = pub
                    self._prefix_publishes.move_to_end(key, last=False)
            while len(self._prefix_publishes) > 256:
                self._prefix_publishes.popitem(last=False)

    def _need_arena(self, verb: str) -> None:
        if self._kv_store is None:
            raise HandoffError("this replica has no paged KV arena "
                               "(ring/mixed layout or prefix cache "
                               f"disabled) — it cannot {verb} KV")

    def _export_prompt(self, tokens) -> list:
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) > self.sc.cache_len - 1:
            raise ValueError(f"prompt length {len(tokens)} > cache budget "
                             f"{self.sc.cache_len - 1}")
        return tokens

    def _copy_event(self):
        """An event after the copies this thread just issued, for the
        thread or engine that reads them (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _wait_copies(self, ready) -> None:
        """Order this thread's stream after an exporter's copies."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)

    def _export_cached(self, root: int, tokens: list, miss) -> tuple:
        """(match, fresh copies of its pages, their event) for every full
        page of ``tokens`` cached under ``root``; ``miss()`` builds the
        error raised when none is. ONE store reference from match through
        release: crash recovery may rebind ``_kv_store`` in between, and
        releasing this store's page ids on a rebuilt pool would corrupt
        its refcounts (a release on the discarded store is harmless). The
        copies are issued under the lock, before any later step can write
        those pages in place, so the references drop right after."""
        with self._prefix_lock:
            store = self._kv_store
            m = store.match_full(root, tokens)
            try:
                if not m.pages:
                    raise miss()
                frags = store.export_pages(m.pages)
                ready = self._copy_event()
            finally:
                store.release(m.pages)
        return m, frags, ready

    def _prefill_for_export(self, tokens: list) -> int:
        """Prefill ``tokens`` through the prefix-cache path (cached pages
        skip compute) so their full pages sit in the trie; drops a page
        run's own references (the trie holds its own). Returns the tokens
        the trie already held."""
        _, out, matched = self._prefill_tokens(tokens)
        if isinstance(out, _PagedRun):
            with self._prefix_lock:
                out.store.release(out.pages)
        return matched

    def _no_pages(self, tokens: list):
        return lambda: HandoffError(
            f"no full pages to hand off for a {len(tokens)}-token prompt "
            f"at page size {self.sc.kv_page_tokens} (prompt shorter than "
            "one page, or the pool evicted it)")

    def _gone(self, tokens: list):
        return lambda: KVPullMiss(
            f"no cached full pages for a {len(tokens)}-token prompt at "
            f"page size {self.sc.kv_page_tokens} (evicted since the "
            "directory publish)")

    def _hop_started(self) -> float:
        with self._handoff_lock:
            self.handoff_inflight += 1
        return self._perf()

    def _hop_ended(self, ok: bool, started: float) -> None:
        """A prefill hop's load accounting; a completed hop is this
        replica's TTFT contribution (the prefill pool's TTFT signal)."""
        with self._handoff_lock:
            self.handoff_inflight -= 1
            self.handoffs_total += ok
        if ok:
            self.metrics.observe("tpu_serving_ttft_seconds",
                                 self._perf() - started)

    def export_handoff(self, tokens: list[int]) -> dict:
        """Prefill-role half of a handoff: run ``tokens`` through the
        prefix-cache prefill path (cached pages skip compute; the prompt's
        full pages land in this arena) and serialize the run for a decode
        replica to adopt. Returns {"blob", "pages", "covered_tokens",
        "matched_tokens"}, matched_tokens being what this replica's cache
        held before the prefill. Runs on the caller's (HTTP handler)
        thread: the hop is this replica's load, never a queue entry or a
        slot, so ``handoff_inflight`` and a TTFT observation let the
        prefill pool's signals see it."""
        return self._export_handoff(tokens, wire=True)

    def export_handoff_device(self, tokens: list[int]) -> dict:
        """``export_handoff`` without the host: the run's fresh copies on
        the card, the event after them ("ready") and the tokens they
        cover, for an engine of this process to adopt
        (``fleet/device_transfer.device_push``). The same load accounting
        as the wire export."""
        return self._export_handoff(tokens, wire=False)

    def _export_handoff(self, tokens: list[int], wire: bool) -> dict:
        self._need_arena("hand off")
        tokens = self._export_prompt(tokens)
        started, ok = self._hop_started(), False
        try:
            matched = self._prefill_for_export(tokens)
            m, frags, ready = self._export_cached(0, tokens,
                                                  self._no_pages(tokens))
            out = self._export_out(m, tokens, frags, ready, wire)
            ok = True
        except Exception:
            self.metrics.incr("tpu_serving_kv_handoff_failures")
            raise
        finally:
            self._hop_ended(ok, started)
        self.metrics.incr("tpu_serving_kv_handoff_pages", out["pages"])
        if wire:
            self.metrics.incr("tpu_serving_kv_handoff_bytes", out["bytes"])
        else:
            self.metrics.incr("tpu_serving_kv_handoff_device_runs")
            self.metrics.incr("tpu_serving_kv_handoff_device_bytes",
                              out["bytes"])
        out["matched_tokens"] = matched
        return out

    def _export_out(self, m, tokens: list, frags: dict, ready,
                    wire: bool) -> dict:
        """An export's reply: the wire codec's blob of the run, or its
        copies on the card with their event and the tokens they cover."""
        out = {"pages": len(m.pages), "covered_tokens": m.matched_tokens}
        if wire:
            sections, words = host_sections(frags, ready, self.device)
            out["blob"] = serialize_pages(tokens[:m.matched_tokens],
                                          self.sc.kv_page_tokens, sections,
                                          model=self.cfg.name, dtypes=words)
            out["bytes"] = len(out["blob"])
        else:
            out.update(tokens=tokens[:m.matched_tokens], sections=frags,
                       ready=ready, model=self.cfg.name,
                       bytes=sum(int(a.nbytes) for a in frags.values()))
        return out

    def _adopt(self, root: int, tokens: list, sections: dict) -> tuple:
        """A checked run into the trie and the arena: the sections reach
        the device before the arena lock (a wire blob's copy to the card
        must not hold up the decode steps), the insert under it."""
        store = self._kv_store
        sections = {name: store.section_tensor(name, a)
                    for name, a in sections.items()}
        with self._prefix_lock:
            added, evicted = self._kv_store.adopt(root, tokens, sections)
        if evicted:
            self.metrics.incr("tpu_serving_prefix_cache_evictions", evicted)
        self._update_page_gauges()
        # adopted pages are as pullable as prefilled ones
        self._publish_prefix(root, tokens)
        return added, evicted

    def _section_spec(self) -> dict:
        with self._prefix_lock:
            return self._kv_store.section_spec()

    def adopt_handoff(self, blob, adapter: str = "") -> dict:
        """Decode-role half: validate a serialized page run (bytes, or an
        mmap of a tmpfs blob) against this arena and adopt it through the
        trie, so the engine's next prompt match references the pages and
        only the sub-page tail recomputes. The handoff counters move only
        after the adoption landed. ``adapter`` names the trie root the run
        belongs under ("" = base; directory pulls adopt adapter runs).
        Returns {pages, added, tokens, bytes, evicted}."""
        try:
            self._need_arena("adopt")
            root = self._adapter_root_id(adapter)
            header, sections = deserialize_pages(
                blob, expect_page_tokens=self.sc.kv_page_tokens,
                expect_sections=self._section_spec(),
                expect_model=self.cfg.name)
            if len(header["tokens"]) > self.sc.cache_len:
                raise HandoffError(
                    f"handoff spans {len(header['tokens'])} tokens, over "
                    f"this replica's cache budget {self.sc.cache_len}")
            added, evicted = self._adopt(root, header["tokens"], sections)
        except Exception:
            self.metrics.incr("tpu_serving_kv_handoff_failures")
            raise
        self.metrics.incr("tpu_serving_kv_handoff_pages", header["n_pages"])
        self.metrics.incr("tpu_serving_kv_handoff_bytes", len(blob))
        return {"pages": header["n_pages"], "added": added,
                "tokens": len(header["tokens"]), "bytes": len(blob),
                "evicted": evicted}

    def adopt_handoff_device(self, tokens: list, sections: dict, *,
                             model: str = "", adapter: str = "",
                             ready=None) -> dict:
        """Decode half of a device-path handoff: check the run's geometry
        against this arena (``check_device_sections``, the one contract the
        stream assembler shares), wait on the exporter's event, and adopt
        the tensors through the trie: the copy into the arena is the only
        data movement. Counters move only after the adoption landed."""
        try:
            self._need_arena("adopt")
            tokens = [int(tk) for tk in tokens]
            if len(tokens) > self.sc.cache_len:
                raise HandoffError(
                    f"device run spans {len(tokens)} tokens, over this "
                    f"replica's cache budget {self.sc.cache_len}")
            root = self._adapter_root_id(adapter)
            n, trimmed, nbytes = check_device_sections(
                tokens, sections,
                expect_page_tokens=self.sc.kv_page_tokens,
                expect_sections=self._section_spec(),
                expect_model=self.cfg.name, model=model, allow_padded=True)
            self._wait_copies(ready)
            added, evicted = self._adopt(root, tokens, trimmed)
        except Exception:
            self.metrics.incr("tpu_serving_kv_handoff_failures")
            raise
        self.metrics.incr("tpu_serving_kv_handoff_pages", n)
        self.metrics.incr("tpu_serving_kv_handoff_device_runs")
        self.metrics.incr("tpu_serving_kv_handoff_device_bytes", nbytes)
        return {"pages": n, "added": added, "tokens": len(tokens),
                "bytes": nbytes, "evicted": evicted}

    def _assembler(self) -> HandoffStreamAssembler:
        """The decode side's stream assembler, built at the first frame.
        Caller holds _handoff_lock."""
        if self._stream_assembler is None:
            self._stream_assembler = HandoffStreamAssembler(
                expect_page_tokens=self.sc.kv_page_tokens,
                expect_sections=self._section_spec(),
                expect_model=self.cfg.name, clock=self._perf)
        return self._stream_assembler

    def _adopt_chunk(self, feed) -> dict:
        """One streamed frame or fragment through the assembler
        (``feed(assembler)``); the arena moves only when the final one
        closes a whole, valid stream."""
        try:
            self._need_arena("adopt")
            with self._handoff_lock:
                try:
                    done = feed(self._assembler())
                except HandoffError:
                    self.metrics.incr(
                        "tpu_serving_kv_handoff_stream_rejects")
                    raise
            self.metrics.incr("tpu_serving_kv_handoff_stream_frames")
            if not done["final"]:
                return {"ok": True, "final": False, "seq": done["seq"]}
            if len(done["tokens"]) > self.sc.cache_len:
                raise HandoffError(
                    f"stream spans {len(done['tokens'])} tokens, over "
                    f"this replica's cache budget {self.sc.cache_len}")
            frames = done["section_frames"]
            store = self._kv_store
            # a stream may mix wire frames (numpy) and device fragments
            # on one seq lane: each becomes a tensor before the concat
            merged = {name: torch.cat([store.section_tensor(name, f[name])
                                       for f in frames], dim=1)
                      for name in frames[0]}
            added, evicted = self._adopt(0, done["tokens"], merged)
        except Exception:
            self.metrics.incr("tpu_serving_kv_handoff_failures")
            raise
        n_pages = len(done["tokens"]) // self.sc.kv_page_tokens
        self.metrics.incr("tpu_serving_kv_handoff_pages", n_pages)
        return {"ok": True, "final": True, "seq": done["seq"],
                "pages": n_pages, "added": added,
                "tokens": len(done["tokens"]), "bytes": done["bytes"],
                "frames": done["frames"], "evicted": evicted}

    def adopt_handoff_chunk(self, blob: bytes) -> dict:
        """Decode-role half of a STREAMED handoff: one sequence-numbered
        chunk frame in, buffered on the host in strict order
        (``HandoffStreamAssembler``); the arena, and every counter but the
        frames', moves only when the final frame closes a stream that
        checks out whole, so a torn, duplicate, reordered or stale stream
        drops and the arena stays as it was. Returns {"ok": True,
        "final": False} mid-stream, the adoption's numbers on the final
        frame."""
        out = self._adopt_chunk(lambda asm: asm.feed(blob))
        if out["final"]:
            self.metrics.incr("tpu_serving_kv_handoff_bytes", out["bytes"])
        return out

    def adopt_handoff_chunk_device(self, stream_id: str, seq: int,
                                   tokens: list, sections: dict, *,
                                   final: bool = False, total_tokens=None,
                                   model: str = "", ready=None) -> dict:
        """Decode half of a STREAMED device handoff: one fragment of
        tensors through the same assembler state machine as the wire
        frames (strict order, idle expiry, all-or-nothing close), without
        serialization; this thread's stream waits on the exporter's event
        at once, so the final adoption reads every fragment's copies."""
        self._wait_copies(ready)
        out = self._adopt_chunk(lambda asm: asm.feed_fragment(
            stream_id, seq, tokens, sections, final=final,
            total_tokens=total_tokens, model=model))
        if out["final"]:
            self.metrics.incr("tpu_serving_kv_handoff_device_runs")
            self.metrics.incr("tpu_serving_kv_handoff_device_bytes",
                              out["bytes"])
        return out

    def export_pull(self, tokens: list[int], adapter: str = "") -> dict:
        """Owner half of a directory pull: serialize the pages this trie
        ALREADY holds for ``tokens``, match-only, never prefilling. An
        owner that lost them since its publish raises KVPullMiss (the
        /kv_pull door answers 404 gone, the router invalidates the entry
        and the cold replica prefills itself). Returns {"blob", "pages",
        "covered_tokens", "bytes"}."""
        return self._export_pull(tokens, adapter, wire=True)

    def export_pull_device(self, tokens: list[int],
                           adapter: str = "") -> dict:
        """``export_pull`` without serialization: fresh copies of the
        matched run on the card and their event, adopted in-process by
        ``device_pull`` on the cold engine, with the owner's model name
        so the puller's adopt door refuses another model's run."""
        return self._export_pull(tokens, adapter, wire=False)

    def _export_pull(self, tokens: list[int], adapter: str,
                     wire: bool) -> dict:
        if self._kv_store is None:
            raise KVPullMiss("this replica has no paged KV arena — "
                             "nothing to pull")
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prompt")
        root = self._adapter_root_id(adapter)
        with self._handoff_lock:
            self.handoff_inflight += 1
        try:
            m, frags, ready = self._export_cached(root, tokens,
                                                  self._gone(tokens))
            out = self._export_out(m, tokens, frags, ready, wire)
        except KVPullMiss:
            raise  # a clean GONE: directory staleness, not a failure
        except Exception:
            self.metrics.incr("tpu_serving_kv_pull_failures")
            raise
        finally:
            with self._handoff_lock:
                self.handoff_inflight -= 1
        self.metrics.incr("tpu_serving_kv_pull_runs")
        self.metrics.incr("tpu_serving_kv_pull_bytes", out["bytes"])
        return out

    def export_handoff_stream(self, tokens: list[int], emit) -> dict:
        """Streamed half of a handoff: run ``tokens`` through the CHUNKED
        prefill, and after each chunk hand the pages it completed to
        ``emit`` while the next chunk computes (the caller's sender thread
        copies and pushes them), so a two-hop TTFT approaches max(compute,
        transfer) instead of their sum.

        ``emit(fragment)`` fires in strict order with {"seq", "final",
        "tokens", "sections", "ready"}: sections are fresh copies on the
        card valid while later steps write the arena, "ready" the event
        after them that a consumer waits on; the closing fragment carries
        empty sections and ``total_tokens``. A raising emit aborts the
        export. Pages the trie already holds stream FIRST, before any
        compute. Eviction racing the stream closes it short with the
        contiguous prefix it could export (a partial handoff is valid).
        Needs ``serving_chunk_tokens`` > 0 (callers use
        ``export_handoff`` otherwise). Returns {"pages", "chunks",
        "frames", "covered_tokens", "matched_tokens"}."""
        self._need_arena("hand off")
        if not self._chunk_tokens:
            raise HandoffError("streamed handoff needs chunked prefill "
                               "(serving_chunk_tokens > 0); use "
                               "export_handoff")
        tokens = self._export_prompt(tokens)
        t = self.sc.kv_page_tokens
        total_pages = len(tokens) // t
        if total_pages == 0:
            raise HandoffError(
                f"no full pages to hand off for a {len(tokens)}-token "
                f"prompt at page size {t}")
        state = {"seq": 0, "sent": 0, "stopped": False}

        def flush(done: int):
            """Export pages [sent, done // t): the contiguous prefix the
            trie still holds, one store reference a flush."""
            want = min(done // t, total_pages)
            if state["stopped"] or want <= state["sent"]:
                return
            with self._prefix_lock:
                store = self._kv_store
                m = store.match_full(0, tokens[:done])
                take = min(want, m.matched_tokens // t)
                if take > state["sent"]:
                    frags = store.export_run(m.pages[state["sent"]:take])
                    ready = self._copy_event()
                store.release(m.pages)
            if take <= state["sent"]:
                state["stopped"] = True   # eviction raced the stream
                return
            emit({"seq": state["seq"], "final": False,
                  "tokens": tokens[state["sent"] * t:take * t],
                  "sections": frags, "ready": ready})
            state["seq"] += 1
            state["sent"] = take
            if take < want:
                state["stopped"] = True

        started, ok, run = self._hop_started(), False, None
        try:
            if self._paged_prefill_on:
                with self._prefix_lock:
                    m0 = self._kv_store.match(0, tokens)
                    self._kv_store.release(m0.pages)
                flush(m0.matched_tokens)   # cached pages move first

                def on_chunk_native(pages, done):
                    # the chunk's full pages join the trie by reference,
                    # then stream out; a failed insert closes the stream
                    # short and never fails the prefill
                    try:
                        with self._prefix_lock:
                            self._kv_store.insert_ready(0, tokens[:done],
                                                        pages)
                    except Exception:  # noqa: BLE001 — best-effort
                        log.exception("chunk insert_ready failed; handoff "
                                      "stream closes short")
                    flush(done)

                out = self._prefill_paged_native(tokens, 0,
                                                 on_chunk=on_chunk_native)
                if out is not None:
                    _, run, matched = out
            if run is None:
                matched = self._stream_dense(tokens, flush)
            flush(len(tokens))
            if run is not None:
                # the export holds no slot: the trie's references keep the
                # pages cached once the run's own drop
                with self._prefix_lock:
                    run.store.release(run.pages)
                run = None
            if state["sent"] == 0:
                raise HandoffError("no pages survived to hand off (the "
                                   "pool evicted the stream as it was "
                                   "computed)")
            data_frames = state["seq"]
            emit({"seq": state["seq"], "final": True, "tokens": [],
                  "sections": {}, "ready": None,
                  "total_tokens": state["sent"] * t})
            state["seq"] += 1
            ok = True
        except Exception:
            if run is not None:
                with self._prefix_lock:
                    run.store.release(run.pages)
            self.metrics.incr("tpu_serving_kv_handoff_failures")
            raise
        finally:
            self._hop_ended(ok, started)
        self.metrics.incr("tpu_serving_kv_handoff_pages", state["sent"])
        self.metrics.incr("tpu_serving_kv_handoff_stream_frames",
                          state["seq"])
        self._update_page_gauges()
        # "chunks" counts DATA frames; "frames" the close frame too
        return {"pages": state["sent"], "chunks": data_frames,
                "frames": state["seq"], "covered_tokens": state["sent"] * t,
                "matched_tokens": matched}

    def _stream_dense(self, tokens: list, flush) -> int:
        """The streamed export's dense-scratch route (paged prefill off,
        or a pool that cannot hold the run up front): cached pages gather
        into a single cache and stream first, then each chunk's full pages
        enter the trie by copy and stream. Returns the tokens matched."""
        self.metrics.incr("tpu_serving_dense_prefills")
        with self._prefix_lock:
            store = self._kv_store
            m = store.match(0, tokens)
            single = None
            if m.pages:
                try:
                    single = store.gather(m.pages, self._fresh_cache())
                finally:
                    store.release(m.pages)
        covered = m.matched_tokens if single is not None else 0
        self.metrics.incr("tpu_serving_prefix_cache_hits" if single
                          is not None else "tpu_serving_prefix_cache_misses")
        flush(covered)

        def on_chunk(sgl, done):
            try:
                with self._prefix_lock:
                    _, evicted = self._kv_store.insert(0, tokens[:done], sgl)
                if evicted:
                    self.metrics.incr("tpu_serving_prefix_cache_evictions",
                                      evicted)
            except Exception:  # noqa: BLE001 — caching is best-effort
                log.exception("chunk insert failed; handoff stream closes "
                              "short")
            flush(done)

        if single is None:
            self._prefill_raw(tokens, 0, on_chunk=on_chunk)
        else:
            self._append_chunks(single, tokens[covered:], None, 0,
                                on_chunk=on_chunk, done=covered)
        return covered

    # -- engine thread --------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                admitted = self._admit()
                if self.active_slots == 0:
                    if not admitted:
                        self._stop.wait(0.002)
                    continue
                self._decode_once()
                # wake a chunked prefill waiting for its one-step turn
                self._arbiter.decode_step_done()
            except Exception as exc:  # noqa: BLE001 — survive a bad step
                log.exception("serving engine step failed; failing "
                              "in-flight requests and continuing")
                self._recover(exc)

    def _recover(self, exc: Exception):
        """Fail everything in flight so no caller hangs, then zero the
        arena and rebuild the pool and trie around it: the failed step may
        have left the arena half written. The arena stays in place, since
        the captured step graphs hold its pointers (a new one would make
        them recapture)."""
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.metrics.incr("tpu_serving_engine_errors")
        for slot in self._slots:
            req, slot.request = slot.request, None
            if req is not None:
                _fail_future(req.future, exc)
            slot.pages = []
            slot.kv_len = 0
            slot.table_len = 0
        drained_fanout = 0
        for q in (self._queue, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, Request):
                    members = [item] + list(item.fanout or [])
                    drained_fanout += len(members) - 1
                else:
                    members = [item[0]]
                for req in members:
                    _fail_future(req.future, exc)
        # only the groups drained here: a submit may have counted its
        # group and not queued it yet
        with self._fanout_lock:
            self._queued_fanout -= drained_fanout
        self.metrics.set_gauge("tpu_serving_queue_depth", self.queue_depth)
        self.metrics.set_gauge("tpu_serving_active_slots", 0)
        self.metrics.set_gauge("tpu_serving_kv_cache_tokens", 0)
        self._page_tables_np[:] = 0
        self._slot_adapter[:] = 0
        with self._prefix_lock:
            if self._cache is not None:
                # in place, as the arena: the decode graph holds pointers
                for name, section in self._cache.items():
                    section.fill_(-1 if name == "abs_pos" else 0)
            if self._kv_store is not None:
                arena = self._kv_store.arena
                for section in arena.values():
                    section.zero_()
                self._kv_store = PagedKVStore(self._kv_store.pool.n_pages,
                                              self.sc.kv_page_tokens, arena,
                                              shards=self._arena_shards)
        self._update_page_gauges()

    def _admit(self) -> bool:
        admitted = False
        for slot_id, slot in enumerate(self._slots):
            if slot.request is not None:
                continue
            with self._transit_lock:
                try:
                    req, single, first, first_lp = self._ready.get_nowait()
                except queue.Empty:
                    break
                self._transit += 1
            try:
                self._admit_into_slot(slot_id, slot, req, single, first,
                                      first_lp)
            finally:
                with self._transit_lock:
                    self._transit -= 1
            admitted = True
            if slot.request is not None and self._finished(slot):
                self._complete(slot_id, slot)
        self.metrics.set_gauge("tpu_serving_active_slots", self.active_slots)
        self._update_kv_gauge()
        return admitted

    def _bind_paged_slot(self, slot_id: int, slot: _Slot, req: Request,
                         single) -> bool:
        """Build the slot's page-table row. A _PagedRun's pages, references
        and all, become the slot's. A dense single cache references the
        prompt's cached full pages read-only (the prefill inserted them)
        and fills private pages for the rest from the cache. Returns False
        (request failed, slot free) when the run belongs to an arena a
        recovery replaced, or the pool cannot supply the tail pages. Only
        the page-table row changes, so the step graphs never recapture."""
        store = self._kv_store
        if isinstance(single, _PagedRun):
            if single.store is not store:
                _fail_future(req.future, RuntimeError(
                    f"engine recovered while {req.rid} was in flight; its "
                    "prefilled pages were discarded — retry"))
                self.metrics.incr("tpu_serving_admission_rejected")
                return False
            slot.pages = list(single.pages)
            slot.kv_len = single.kv_len
        else:
            t = self.sc.kv_page_tokens
            n_prompt = len(req.prompt)
            with self._prefix_lock:
                m = store.match_full(req.adapter_id, req.prompt)
                covered = m.matched_tokens
                n_tail = -(-(n_prompt - covered) // t)
                try:
                    tail = store.alloc_run(n_tail) if n_tail else []
                except PoolExhausted as exc:
                    store.release(m.pages)
                    _fail_future(req.future, EngineOverloaded(
                        f"KV pool exhausted admitting {req.rid}: {exc}; "
                        "retry later or raise kv_pool_pages"))
                    self.metrics.incr("tpu_serving_admission_rejected")
                    return False
                store.fill_pages(single, tail, covered)
            slot.pages = list(m.pages) + tail
            slot.kv_len = n_prompt
        row = self._page_tables_np[slot_id]
        row[:] = 0
        row[:len(slot.pages)] = slot.pages
        slot.table_len = len(slot.pages)
        return True

    def _admit_into_slot(self, slot_id: int, slot: _Slot, req: Request,
                         single, first: int, first_lp: Optional[float]):
        """Bind the prefill's pages to a free slot (the paged loop), or copy
        its single cache into the slot's row of the batch cache in place
        (the contiguous loop), and emit the first token."""
        if self._paged_loop:
            if not self._bind_paged_slot(slot_id, slot, req, single):
                return
        else:
            with self._prefix_lock:   # ordered with the decode replays
                LlamaModel.insert_into_slot(self._cache, single, slot_id)
            slot.kv_len = len(req.prompt)
        slot.bigram_index = {}
        slot.indexed_upto = 0
        slot.stop_tail = []
        slot.stop_tail_upto = 0
        self._slot_seed[slot_id] = req.seed
        self._slot_draws[slot_id] = 1  # draw 0 was the prefill's token
        self._slot_adapter[slot_id] = req.adapter_id
        self._set_slot_rows(slot_id, req, first)
        slot.request = req
        slot.generated = [first]
        slot.logprobs = [first_lp] if first_lp is not None else []
        slot.remaining = req.max_new_tokens - 1
        slot.last_token = first
        # the first token becomes caller-visible here
        now = self._perf()
        req.first_token_at = now
        slot.last_emit_at = now
        # the exemplar links the TTFT bucket to a replayable trace
        self.metrics.observe("tpu_serving_ttft_seconds",
                             now - req.submitted_at,
                             exemplar=req.trace_id or None)
        self._emit(slot, first)
        self.metrics.incr("tpu_serving_admitted")

    def _set_slot_rows(self, slot_id: int, req: Request, first: int):
        """Penalty counts start from the first generated token (the prompt
        never counts); logit_bias rows are the request's map."""
        v = self.cfg.vocab_size
        if _penalized(req) and self._tok_counts is None:
            self._tok_counts = torch.zeros((self.sc.slots, v),
                                           dtype=torch.int32,
                                           device=self.device)
        if self._tok_counts is not None:
            self._tok_counts[slot_id] = 0
            if _penalized(req):
                self._tok_counts[slot_id, first] = 1
        if req.logit_bias and self._logit_bias is None:
            self._logit_bias = torch.zeros((self.sc.slots, v),
                                           dtype=torch.float32,
                                           device=self.device)
        if self._logit_bias is not None:
            self._logit_bias[slot_id] = (
                torch.from_numpy(_bias_row(req.logit_bias, v))
                .to(self.device) if req.logit_bias else 0.0)

    def _grow_slot_table(self, slot_id: int, slot: _Slot, need: int) -> bool:
        """Extend the slot's table to cover positions [0, kv_len + need)
        with PRIVATE pages (shared prefix pages are never written). Under a
        sliding window, entry j >= _win_pages recycles the page of entry
        j - _win_pages (the JAX engine's ``_grow_slot_table``): in place
        when only this slot holds it, else the slot swaps its reference
        for a fresh private page and the shared copy stays cached. On pool
        exhaustion this request fails and every other slot keeps going."""
        t = self.sc.kv_page_tokens
        row = self._page_tables_np[slot_id]
        store = self._kv_store
        while slot.table_len * t < slot.kv_len + need:
            j = slot.table_len
            with self._prefix_lock:
                try:
                    if self._window is not None and j >= self._win_pages:
                        old = int(row[j - self._win_pages])
                        if store.pool.refcount(old) == 1:
                            page = old
                        else:
                            page = store.alloc_run(1)[0]
                            store.pool.unref(old)
                            slot.pages.remove(old)
                            slot.pages.append(page)
                        self._ring_recycled += 1
                    else:
                        page = store.alloc_run(1)[0]
                        slot.pages.append(page)
                except PoolExhausted as exc:
                    store.release(slot.pages)
                    slot.pages = []
                    slot.kv_len = 0
                    slot.table_len = 0
                    row[:] = 0
                    self._slot_adapter[slot_id] = 0
                    req, slot.request = slot.request, None
                    _fail_future(req.future, RuntimeError(
                        f"KV pool exhausted mid-decode for {req.rid}: "
                        f"{exc}"))
                    return False
            row[j] = page
            slot.table_len = j + 1
        return True

    def _decode_once(self):
        """One decode step of the loop the engine runs: on the contiguous
        loop one replay of the verify graph when a greedy slot is live and
        speculation is on (``_decode_once_speculative``), else of the
        decode graph over the batch cache and its active mask (the JAX
        ``_decode_once``), then ``_commit_decode``."""
        if self._paged_loop:
            return self._decode_once_paged()
        if self._verify is not None and self._decode_once_speculative():
            return
        rec = self.recorder
        if rec is not None:
            rec.step_begin()
        active = [s.request is not None for s in self._slots]
        if rec is not None:
            rec.mark("schedule")
        with self._prefix_lock:
            logits = self._decode(self.params, self._cache,
                                  [s.last_token for s in self._slots],
                                  active, **self._step_adapter_kw())
            self.metrics.incr("tpu_serving_decode_steps")
        if rec is not None:
            rec.mark("kernel")
        self._commit_decode(logits)

    def _decode_once_speculative(self) -> bool:
        """One replay of the contiguous verify graph over [last token, k
        drafts] per slot (the JAX contiguous ``_decode_once_speculative``):
        ``_spec_commit`` commits, then each row's ``index`` advances by
        what it appended. That is the rollback: a rejected draft's K/V
        stays past the index (a ring's ``abs_pos`` names it until then) and
        the next write covers it. Returns False, deferring to the plain
        step, when no live slot is greedy."""
        k = self.sc.speculate_k
        slots = self._slots
        active = [s.request is not None for s in slots]
        is_greedy = [_spec_greedy(s.request) for s in slots]
        if not any(is_greedy):
            return False
        rec = self.recorder
        if rec is not None:
            rec.step_begin()
        adapters = int((self._slot_adapter != 0).sum())
        toks_in = np.zeros((len(slots), k + 1), np.int32)
        for i, slot in enumerate(slots):
            if active[i]:
                toks_in[i] = slot.last_token   # drafts of non-greedy: unread
                if is_greedy[i]:
                    toks_in[i, 1:] = self._propose(slot, k)
        widths = [min(k + 1, s.remaining) if g else 1
                  for s, g in zip(slots, is_greedy)]
        if rec is not None:
            rec.mark("schedule")
        with self._prefix_lock:
            logits = self._verify(self.params, self._cache, toks_in, active,
                                  **self._step_adapter_kw())
            self.metrics.incr("tpu_serving_decode_steps")
        if rec is not None:
            rec.mark("kernel")
        appended, accepted, proposed = self._spec_commit(
            logits, toks_in, widths, active, is_greedy)
        with self._prefix_lock:   # ordered with the replays
            self._cache["index"] += torch.tensor(appended, dtype=torch.int32,
                                                 device=self.device)
        self._observe_step(sum(active))
        if rec is not None:
            rec.step_end(mode="spec_verify", active=sum(active),
                         draining=self._draining.is_set(), paged=False,
                         spec_k=k, adapters=adapters, tokens=sum(appended),
                         rids=[s.request.rid for s in slots
                               if s.request is not None],
                         spec={"proposed": proposed, "accepted": accepted,
                               "rolled_back_pages": 0})
        return True

    def _decode_once_paged(self):
        """One decode step: slot-table growth, one replay of the decode
        graph (the recorder's schedule and kernel phases), then
        ``_commit_decode`` (sample and commit). A windowed engine never
        verifies drafts (no verify graph is built)."""
        if (self._paged_verify is not None
                and self._decode_once_speculative_paged()):
            return
        rec = self.recorder
        if rec is not None:
            rec.step_begin()
        for slot_id, slot in enumerate(self._slots):
            if slot.request is not None:
                self._grow_slot_table(slot_id, slot, 1)
        active = [s.request is not None for s in self._slots]
        if not any(active):
            self.metrics.set_gauge("tpu_serving_active_slots", 0)
            return
        if rec is not None:
            rec.mark("schedule")
        with self._prefix_lock:
            logits = self._paged_step(
                self.params, self._kv_store.arena,
                [s.last_token for s in self._slots],
                [s.kv_len for s in self._slots], self._page_tables_np,
                active, **self._step_adapter_kw())
            self.metrics.incr("tpu_serving_decode_steps")
        if rec is not None:
            rec.mark("kernel")
        self._commit_decode(logits)

    def _propose(self, slot: _Slot, k: int) -> list[int]:
        """Prompt-lookup drafting: the k tokens that followed the latest
        earlier occurrence of the context's final bigram, padded with the
        last token (a wrong draft costs only rows the verify pass already
        pays for). The bigram index grows incrementally, amortized O(1) a
        committed token; the latest occurrence wins, as in a backward scan
        that stops at position len - 3."""
        prompt = slot.request.prompt
        np_ = len(prompt)
        gen = slot.generated
        n = np_ + len(gen)

        def tok(p: int) -> int:
            return prompt[p] if p < np_ else gen[p - np_]

        idx = slot.bigram_index
        while slot.indexed_upto <= n - 3:
            i = slot.indexed_upto
            idx[(tok(i), tok(i + 1))] = i
            slot.indexed_upto += 1
        draft: list[int] = []
        if n >= 3:
            i = idx.get((tok(n - 2), tok(n - 1)))
            if i is not None:
                draft = [tok(p) for p in range(i + 2, min(i + 2 + k, n))]
        last = tok(n - 1)
        while len(draft) < k:
            draft.append(last)
        return draft[:k]

    def _decode_once_speculative_paged(self) -> bool:
        """One ``paged_verify_step`` over [last token, k drafts] per slot.
        ``_spec_commit`` commits: greedy slots the matched drafts plus the
        corrected token; sampled, penalized and biased slots ride along at
        n_tokens = 1, whose KV write and logits[:, 0] are the plain
        step's. Rejected rows roll back page-natively: the table's pages
        past ceil(kv_len / T) return to the pool. Returns False, deferring
        to the plain step, when no live slot is greedy."""
        k = self.sc.speculate_k
        slots = self._slots
        t = self.sc.kv_page_tokens
        if not any(_spec_greedy(s.request) for s in slots):
            return False
        rec = self.recorder
        if rec is not None:
            rec.step_begin()
        # table growth BEFORE the step: a greedy slot writes up to k + 1
        # rows, never past its budget (the table is ceil(cache_len / T)
        # pages wide), a sampled slot 1
        widths = [0] * len(slots)
        for i, slot in enumerate(slots):
            if slot.request is not None:
                widths[i] = (min(k + 1, slot.remaining)
                             if _spec_greedy(slot.request) else 1)
                self._grow_slot_table(i, slot, widths[i])
        active = [s.request is not None for s in slots]   # growth may fail
        if not any(active):
            self.metrics.set_gauge("tpu_serving_active_slots", 0)
            return True
        is_greedy = [_spec_greedy(s.request) for s in slots]
        # slots decoding with an adapter (the step record's count)
        adapters = int((self._slot_adapter != 0).sum())
        toks_in = np.zeros((len(slots), k + 1), np.int32)
        n_tokens = np.where(active, widths, 0).astype(np.int32)
        for i, slot in enumerate(slots):
            if active[i]:
                toks_in[i] = slot.last_token   # drafts of non-greedy: unread
                if is_greedy[i]:
                    toks_in[i, 1:] = self._propose(slot, k)
        if rec is not None:
            rec.mark("schedule")
        with self._prefix_lock:
            logits = self._paged_verify(
                self.params, self._kv_store.arena, toks_in,
                [s.kv_len for s in slots], self._page_tables_np, active,
                n_tokens, **self._step_adapter_kw())
            self.metrics.incr("tpu_serving_decode_steps")
            self.metrics.incr("tpu_serving_paged_speculative_steps")
        if rec is not None:
            rec.mark("kernel")
        appended, accepted, proposed = self._spec_commit(
            logits, toks_in, n_tokens, active, is_greedy)
        rolled_back = 0
        for i, slot in enumerate(slots):
            if slot.request is None:
                continue   # idle, or _complete released every page
            keep = -(-slot.kv_len // t)
            if len(slot.pages) > keep:
                # pages past the committed length hold only rejected rows,
                # all private (shared prefix pages lie below kv_len)
                dropped = slot.pages[keep:]
                del slot.pages[keep:]
                slot.table_len = keep
                self._page_tables_np[i, keep:] = 0
                with self._prefix_lock:
                    self._kv_store.release(dropped)
                rolled_back += len(dropped)
        if rolled_back:
            self.metrics.incr("tpu_serving_paged_speculative_rollback_pages",
                              rolled_back)
        self._observe_step(sum(active))
        if rec is not None:
            rec.step_end(mode="spec_verify", active=sum(active),
                         draining=self._draining.is_set(), paged=True,
                         spec_k=k, adapters=adapters, tokens=sum(appended),
                         rids=[s.request.rid for s in slots
                               if s.request is not None],
                         arena=self._arena_step_stats(),
                         spec={"proposed": proposed, "accepted": accepted,
                               "rolled_back_pages": rolled_back})
        return True

    def _spec_commit(self, logits: torch.Tensor, toks_in: np.ndarray,
                     widths, active: list, is_greedy: list
                     ) -> tuple[list, int, int]:
        """A verify step's sampling and commit, on either loop: logits (B,
        K + 1, V) of [last token, drafts] per slot. A greedy slot commits
        the drafts its argmax matches plus the corrected token, at most
        ``widths[i]``; a sampled, penalized or biased slot draws token 1
        from logits[:, 0] after ``_maybe_penalize``. Greedy logprobs are
        max - logsumexp. Counts ``tpu_serving_spec_proposed`` and
        ``_accepted`` (drafts consumed, so an early finish does not count
        the rest), observes the inter-token gaps and marks the recorder's
        sample phase. Returns (tokens appended per slot, drafts accepted,
        drafts proposed)."""
        k = self.sc.speculate_k
        slots = self._slots
        # one device -> host copy of every slot's K-wide argmax; logprobs
        # and sampled draws are read from the logits now, before the next
        # replay overwrites the graph's output
        greedy_np = logits.argmax(dim=-1).cpu().numpy()
        reqs = [s.request for s in slots]
        greedy_lp = None
        if any(r is not None and r.logprobs and g
               for r, g in zip(reqs, is_greedy)):
            greedy_lp = (logits.max(dim=-1).values
                         - torch.logsumexp(logits, dim=-1)).cpu().numpy()
        sampled = sampled_lp = None
        if not all(g for g, a in zip(is_greedy, active) if a):
            l0 = self._maybe_penalize(logits[:, 0], reqs)
            sampled = _sample(l0, self._slot_seed, self._slot_draws,
                              [r.temperature if r else 0.0 for r in reqs],
                              [r.top_k if r else 0 for r in reqs],
                              [r.top_p if r else 1.0 for r in reqs])
            if any(r is not None and r.logprobs and not g
                   for r, g in zip(reqs, is_greedy)):
                sampled_lp = _token_logprobs(l0, sampled)
            if self._tok_counts is not None:
                for i, r in enumerate(reqs):
                    if _penalized(r):
                        self._tok_counts[i, sampled[i]] += 1
        self._slot_draws = [d + 1 for d in self._slot_draws]
        proposed = k * sum(is_greedy)
        self.metrics.incr("tpu_serving_spec_proposed", proposed)
        if self.recorder is not None:
            self.recorder.mark("sample")
        step_now = self._perf()
        appended_by_slot = [0] * len(slots)
        accepted = 0
        for i, slot in enumerate(slots):
            if not active[i]:
                continue
            if is_greedy[i]:
                committed = []
                for j in range(widths[i]):
                    g = int(greedy_np[i, j])
                    committed.append(g)
                    if j + 1 >= widths[i] or g != toks_in[i, j + 1]:
                        break   # a mismatch: g is the corrected token
            else:
                committed = [sampled[i]]
            appended = 0
            for j, tok in enumerate(committed):
                if slot.request is None:
                    break   # finished mid-run (eos, stop or budget)
                # committing token j commits the step's row j at kv_len
                slot.kv_len += 1
                slot.generated.append(tok)
                if slot.request.logprobs:
                    slot.logprobs.append(float(
                        greedy_lp[i, j] if is_greedy[i] else sampled_lp[i]))
                slot.last_token = tok
                slot.remaining -= 1
                appended += 1
                self.total_generated += 1
                self._emit(slot, tok)
                if self._finished(slot):
                    self._complete(i, slot)
            self._observe_itl(slot, appended, step_now)
            appended_by_slot[i] = appended
            if is_greedy[i] and appended > 1:
                accepted += appended - 1   # drafts actually consumed
        if accepted:
            self.metrics.incr("tpu_serving_spec_accepted", accepted)
        return appended_by_slot, accepted, proposed

    def _commit_decode(self, logits: torch.Tensor):
        """Per-slot sampling, logprobs, stream emission, stop checks and
        slot bookkeeping (the recorder's sample and commit phases). The
        tokens and logprobs are read from the logits here, before the next
        replay overwrites the graph's output."""
        reqs = [s.request for s in self._slots]
        logits = self._maybe_penalize(logits, reqs)
        nxt = _sample(logits, self._slot_seed, self._slot_draws,
                      [r.temperature if r else 0.0 for r in reqs],
                      [r.top_k if r else 0 for r in reqs],
                      [r.top_p if r else 1.0 for r in reqs])
        self._slot_draws = [d + 1 for d in self._slot_draws]
        if self._tok_counts is not None:
            for i, r in enumerate(reqs):
                if _penalized(r):
                    self._tok_counts[i, nxt[i]] += 1
        lps = None
        if any(r is not None and r.logprobs for r in reqs):
            lps = _token_logprobs(logits, nxt)
        rec = self.recorder
        if rec is not None:
            rec.mark("sample")
        # slots that decoded with an adapter (before completions free them)
        adapters = int((self._slot_adapter != 0).sum())
        step_now = self._perf()
        n_active = 0
        for slot_id, slot in enumerate(self._slots):
            if slot.request is None:
                continue
            n_active += 1
            slot.kv_len += 1  # the step wrote the input token's KV
            tok = nxt[slot_id]
            slot.generated.append(tok)
            if slot.request.logprobs:
                slot.logprobs.append(lps[slot_id])
            slot.last_token = tok
            slot.remaining -= 1
            self.total_generated += 1
            self._emit(slot, tok)
            self._observe_itl(slot, 1, step_now)
            if self._finished(slot):
                self._complete(slot_id, slot)
        self._observe_step(n_active)
        if rec is not None:
            arena = ({"arena": self._arena_step_stats()}
                     if self._paged_loop else {})
            rec.step_end(mode="decode", active=n_active,
                         draining=self._draining.is_set(),
                         paged=self._paged_loop, adapters=adapters,
                         tokens=n_active,
                         rids=[s.request.rid for s in self._slots
                               if s.request is not None], **arena)

    def _observe_itl(self, slot: _Slot, appended: int, now: float):
        """The inter-token gap: the step's gap spread evenly over the
        tokens it committed, one sample a token (a verify step commits
        several at once)."""
        if not appended:
            return
        if slot.last_emit_at:
            per_tok = (now - slot.last_emit_at) / appended
            for _ in range(appended):
                self.metrics.observe("tpu_serving_inter_token_seconds",
                                     per_tok)
        slot.last_emit_at = now

    def _observe_step(self, n_active: int):
        """Per decode step: the slots' fill fraction and KV occupancy."""
        self.metrics.observe("tpu_serving_batch_utilization",
                             n_active / max(1, self.sc.slots))
        self._update_kv_gauge()

    def _update_kv_gauge(self):
        self.metrics.set_gauge("tpu_serving_kv_cache_tokens", sum(
            len(s.request.prompt) + len(s.generated)
            for s in self._slots if s.request is not None))

    def _update_page_gauges(self):
        """The arena's page gauges, after every change of the pool (and
        the stats the step records read between changes)."""
        if self._kv_store is None:
            self.metrics.set_gauge("tpu_serving_kv_pages_total", 0)
            self.metrics.set_gauge("tpu_serving_kv_pages_free", 0)
            self.metrics.set_gauge("tpu_serving_kv_pages_shared", 0)
            return
        with self._prefix_lock:
            stats = self._kv_store.stats()
        self._page_stats = stats
        self.metrics.set_gauge("tpu_serving_kv_pages_total",
                               stats["pages_total"])
        self.metrics.set_gauge("tpu_serving_kv_pages_free",
                               stats["pages_free"])
        self.metrics.set_gauge("tpu_serving_kv_pages_shared",
                               stats["pages_shared"])

    def _arena_step_stats(self) -> dict:
        """O(1) arena occupancy for a step record, and the window-ring
        pages recycled since the last record."""
        pool = self._kv_store.pool
        recycled, self._ring_recycled = self._ring_recycled, 0
        stats = self._page_stats
        return {"pages_total": pool.n_pages, "pages_free": pool.free_count,
                "pages_shared": stats["pages_shared"] if stats else 0,
                "ring_recycled": recycled}

    def _maybe_penalize(self, logits: torch.Tensor, reqs) -> torch.Tensor:
        if self._tok_counts is not None and any(_penalized(r) for r in reqs):
            dev = logits.device
            pres = torch.tensor([r.presence_penalty if r else 0.0
                                 for r in reqs], device=dev)
            freq = torch.tensor([r.frequency_penalty if r else 0.0
                                 for r in reqs], device=dev)
            logits = _apply_penalties(logits, self._tok_counts, pres, freq)
        if self._logit_bias is not None and any(
                r is not None and r.logit_bias for r in reqs):
            logits = logits.float() + self._logit_bias
        return logits

    def _emit(self, slot: _Slot, tok: int):
        """Stream a token to the requester; a raising callback means the
        client is gone: the request finishes now with what it has."""
        req = slot.request
        if req is None or req.on_token is None:
            return
        try:
            req.on_token(tok)
        except Exception:  # noqa: BLE001 — client callback, not engine state
            log.info("stream callback failed for %s; cancelling", req.rid)
            req.on_token = None
            slot.remaining = 0
            self.metrics.incr("tpu_serving_stream_cancelled")

    def _finished(self, slot: _Slot) -> bool:
        req = slot.request
        if req.future.cancelled():
            return True
        if slot.remaining <= 0 or slot.last_token == self.sc.eos_token:
            return True
        gen = slot.generated
        if any(len(q) <= len(gen) and gen[-len(q):] == q for q in req.stop):
            return True
        if req.stop_texts:
            # BPE-exact: a stop string straddling a token boundary is in
            # the decoded text, never in a token tail. A running tail of
            # ids, trimmed from the front only while the rest still
            # decodes to >= the longest stop + 8 chars, keeps each check
            # O(stop length)
            need = max(len(q) for q in req.stop_texts) + 8
            tail = slot.stop_tail
            tail.extend(gen[slot.stop_tail_upto:])
            slot.stop_tail_upto = len(gen)
            while len(tail) > 1 and (
                    len(tail) > 4 * need   # zero-char specials: a hard cap
                    or len(self._decode_fn(tail[1:])) >= need):
                tail.pop(0)
            text = self._decode_fn(tail)
            return any(q in text for q in req.stop_texts)
        return False

    def _complete(self, slot_id: int, slot: _Slot):
        req = slot.request
        slot.request = None
        # the meter's page-seconds read the page count at completion,
        # before the release empties it (0 on the contiguous loop: the
        # meter then counts the prompt's pages)
        pages_end = len(slot.pages)
        # shared prefix pages stay in the trie for the next hit; private
        # tail pages free now (the contiguous loop's slots hold none)
        if slot.pages:
            with self._prefix_lock:
                self._kv_store.release(slot.pages)
        slot.pages = []
        slot.kv_len = 0
        slot.table_len = 0
        self._page_tables_np[slot_id][:] = 0
        self._slot_adapter[slot_id] = 0
        latency = self._perf() - req.submitted_at
        self.metrics.observe("tpu_serving_request_latency_seconds", latency,
                             exemplar=req.trace_id or None)
        cost = None
        if self.costmeter is not None:
            try:
                cost = self.costmeter.meter_request(
                    req, end_at=req.submitted_at + latency,
                    generated_tokens=len(slot.generated),
                    pages_end=pages_end, page_tokens=self.sc.kv_page_tokens)
            except Exception:  # noqa: BLE001 — metering must never fail a request
                log.exception("cost metering for %s failed", req.rid)
        try:
            self._record_request_spans(req, slot, latency, cost)
        except Exception:  # noqa: BLE001 — tracing must never fail a request
            log.exception("span recording for %s failed", req.rid)
        out = {"rid": req.rid, "tokens": slot.generated,
               "latency_s": latency,
               "ttft_s": req.first_token_at - req.submitted_at}
        if req.logprobs:
            out["logprobs"] = slot.logprobs
        try:
            # the atomic claim: False iff the client's cancel won
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(out)
            else:
                self.metrics.incr("tpu_serving_cancelled")
        except Exception:  # noqa: BLE001 — future already resolved
            pass
        self.metrics.set_gauge("tpu_serving_active_slots", self.active_slots)

    def _record_request_spans(self, req: Request, slot: _Slot,
                              latency: float, cost: Optional[dict] = None):
        """The request's span tree, recorded after the fact from the
        threads' timestamps: ``serving.request`` and its contiguous
        children ``serving.queue_wait`` (submit -> dequeue),
        ``serving.prefill`` (dequeue -> prefill done) and
        ``serving.decode`` (prefill done -> finish, the ready-queue wait
        included), whose durations sum to the request's latency. The
        recorder's attribution (steps ridden, their wall and kernel share)
        and the cost meter's (``cost``: dollars, chip-seconds a phase, KV
        page-seconds, tenant) ride the root."""
        tr = self.tracer
        now_perf = self._perf()
        now_wall = tr.clock()

        def wall(t_perf: float) -> float:
            return now_wall - (now_perf - t_perf)

        trace_id = req.trace_id or Tracer.new_trace_id()
        root = req.span_id or Tracer.new_span_id()
        end = wall(req.submitted_at + latency)
        ttft = (req.first_token_at - req.submitted_at
                if req.first_token_at else None)
        attrs = {"rid": req.rid, "prompt_tokens": len(req.prompt),
                 "tokens": len(slot.generated),
                 "ttft_s": ttft, "latency_s": latency,
                 "adapter_id": req.adapter_id,
                 "prefix_hit": req.matched_prefix_tokens > 0,
                 "matched_prefix_tokens": req.matched_prefix_tokens}
        if self.recorder is not None:
            acc = self.recorder.pop_request(req.rid)
            if acc is not None:
                attrs["decode_steps"] = acc["steps"]
                attrs["step_wall_share_s"] = round(acc["step_wall_s"], 6)
                attrs["step_kernel_share_s"] = round(acc["kernel_s"], 6)
        if cost is not None:
            attrs.update(self.costmeter.span_attrs(cost))
        tr.record("serving.request", wall(req.submitted_at), end,
                  trace_id=trace_id, span_id=root,
                  parent_id=req.parent_span_id, attrs=attrs)
        if req.dequeued_at:
            tr.record("serving.queue_wait", wall(req.submitted_at),
                      wall(req.dequeued_at), trace_id=trace_id,
                      parent_id=root, attrs={"rid": req.rid})
        if req.prefill_done_at:
            tr.record("serving.prefill", wall(req.dequeued_at),
                      wall(req.prefill_done_at), trace_id=trace_id,
                      parent_id=root,
                      attrs={"rid": req.rid,
                             "prompt_tokens": len(req.prompt),
                             "matched_prefix_tokens":
                                 req.matched_prefix_tokens})
            tr.record("serving.decode", wall(req.prefill_done_at), end,
                      trace_id=trace_id, parent_id=root,
                      attrs={"rid": req.rid,
                             "tokens": len(slot.generated)})


def priced_accelerator(device) -> str:
    """The accelerator the cost meter prices a replica by, as the JAX
    replica names it: ``TPU_ACCELERATOR_TYPE`` when the environment sets
    it, else the card's name (``generations.generation_of`` maps either;
    empty on the CPU)."""
    named = os.environ.get("TPU_ACCELERATOR_TYPE", "")
    if named or device.type != "cuda":
        return named
    return torch.cuda.get_device_name(device)


def host_sections(sections: dict, ready, device) -> tuple[dict, dict]:
    """Host copies of an export's sections for the wire codec, after the
    exporter's event: ({name: numpy array}, {name: dtype name} for those
    carried as raw words). bfloat16 leaves as its 2-byte words (numpy has
    no bfloat16), so the blob holds the arena's bytes."""
    if ready is not None:
        torch.cuda.current_stream(device).wait_event(ready)
    out, words = {}, {}
    for name, t in sections.items():
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            words[name] = "bfloat16"
            out[name] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[name] = t.numpy()
    return out, words


def _token_logprobs(logits: torch.Tensor, tokens: list[int]) -> list:
    """log P(tokens[b]) under row b's softmax of (B, V) logits, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = torch.tensor(tokens, dtype=torch.long, device=logits.device)
    return logp.gather(1, idx[:, None])[:, 0].tolist()


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """An adapter leaf (a tensor or a numpy array) on ``device`` in
    ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=dtype)


def _failed(exc: BaseException) -> Future:
    f: Future = Future()
    f.set_exception(exc)
    return f


def _spec_greedy(req: Optional[Request]) -> bool:
    """A live request a verify step drafts for: greedy and unmodded (a
    penalty or logit bias changes the next token's logits with every
    committed token, so a K-wide greedy run is stale after one)."""
    return (req is not None and req.temperature <= 0.0
            and not _logit_modded(req))


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)
