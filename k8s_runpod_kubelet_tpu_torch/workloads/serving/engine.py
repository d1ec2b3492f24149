"""Continuous-batching serving engine over a paged KV arena (port of the
paged loop of the JAX package's ``workloads/serving/engine.py``).

- **Prefill thread**: pops submitted requests, matches each prompt against
  the prefix trie, allocates the prompt's whole page run up front and
  scatters it chunk by chunk (at most ``max_prefill_len`` tokens a chunk)
  straight into arena pages through ``paged_prefill_chunk_step``. Matched
  prefix pages join the run in place; the finished run's full pages enter
  the trie by reference. It samples the first token and hands
  (request, page run, first token) to the engine thread.
- **Engine thread**: binds ready runs to free slots (the run's pages become
  the slot's page-table row) and runs one ``paged_decode_step`` per step
  for every live slot, growing each slot's table by a private page when
  its next write crosses a page boundary. With ``speculate_k`` > 0 and a
  greedy slot live, a step is instead one ``paged_verify_step`` over
  [last token, k prompt-lookup drafts]: greedy slots commit the matched
  drafts plus the corrected token, sampled slots ride along at one token,
  and rejected rows roll back by dropping the table's pages past the
  committed length.
- **Chunk interleave**: with ``serving_chunk_tokens`` set, the prefill
  thread waits for one decode step between a prompt's chunks whenever a
  slot is decoding (``ChunkArbiter``).
- **Registered prefixes**: ``register_prefix`` prefills a shared prefix
  once and pins its full pages in the trie.
- **Step graphs**: the decode and verify steps run through
  ``StepGraph`` (``step_graph.py``), the JAX engine's jitted
  ``paged_step``/``paged_verify``: on a card each is captured as a CUDA
  graph at ``start()`` and every step is one replay fed by one
  host-to-card copy; on the CPU the same staged buffers feed the eager
  step. ``CompileWatchdog`` (``recorder.py``) counts the captures;
  ``debug_snapshot()["graphs"]`` reads them with the replays. Prefill
  chunks stay eager.

Every launch that touches the arena, and every pool or trie call, runs
under ``_prefix_lock``: the two threads issue onto PyTorch's one current
stream in lock order, so each step sees the arena the previous one left.
Counters are plain integers, read through ``debug_snapshot()``;
``decode_steps`` and ``prefill_chunks`` count under that lock with their
step, so a reader holding it sees them agree with the kernels' launch
counters.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from ...models.llama import LlamaConfig, LlamaModel, Params
from ...models.quant import quantize_params
from .kv_manager import PagedKVStore, PoolExhausted
from .recorder import CompileWatchdog
from .sampler import (_apply_penalties, _bias_row, _logit_modded,
                      _penalized, _sample)
from .scheduler import (ChunkArbiter, EngineDraining, EngineOverloaded,
                        Request, ServingConfig, _fail_future, _Slot)
from .step_graph import StepGraph

log = logging.getLogger(__name__)

COUNTERS = ("admitted", "decode_steps", "engine_errors", "prefill_errors",
            "prefix_cache_hits", "prefix_cache_misses", "paged_prefill_tokens",
            "prefill_chunks", "admission_rejected", "drain_rejected",
            "cancelled", "spec_proposed", "spec_accepted",
            "paged_speculative_steps", "paged_speculative_rollback_pages",
            "chunk_interleaved_steps", "prefix_hits")


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
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sc = sc
        if sc.quantize_int8 and sc.quantize_int4:
            raise ValueError("quantize_int8 and quantize_int4 are mutually "
                             "exclusive — pick one weight precision")
        if sc.slots < 1 or sc.max_prefill_len < 1:
            raise ValueError("slots and max_prefill_len must be >= 1")
        if min(sc.speculate_k, sc.serving_chunk_tokens, sc.max_prefixes) < 0:
            raise ValueError("speculate_k, serving_chunk_tokens and "
                             "max_prefixes must be >= 0")
        t = sc.kv_page_tokens
        if not 1 <= t < sc.cache_len:
            raise ValueError(f"kv_page_tokens must be in [1, cache_len), "
                             f"got {t}")
        if sc.cache_len > cfg.max_seq_len:
            raise ValueError(f"cache_len {sc.cache_len} exceeds the model's "
                             f"max_seq_len {cfg.max_seq_len}")
        slot_pages = -(-sc.cache_len // t)
        # one decode cache's worth for the slots plus as much again for
        # the shared prefix pool (the JAX engine's auto sizing)
        n_pages = 2 * sc.slots * slot_pages
        if sc.quantize_int8 or sc.quantize_int4:
            # on the params' device, one layer slice at a time
            params = quantize_params(cfg, params,
                                     bits=4 if sc.quantize_int4 else 8)
        self.params = params
        self.model = LlamaModel(cfg, self.device)
        self._kv_store = PagedKVStore(n_pages, t, self.model.init_paged_arena(
            n_pages, t, quantize=sc.quantize_kv_int8))
        self._slot_pages_max = slot_pages
        # the decode and verify steps as CUDA graphs over static slot
        # buffers, captured at start() on a card (the JAX engine's jitted
        # paged_step / paged_verify); the watchdog counts every capture
        self.watchdog = CompileWatchdog()
        self._paged_step = self.watchdog.wrap(
            "paged_step", StepGraph(self.model, 1, sc.slots, slot_pages))
        self._paged_verify = self.watchdog.wrap(
            "paged_verify", StepGraph(self.model, sc.speculate_k + 1,
                                      sc.slots, slot_pages)
            if sc.speculate_k > 0 else None)
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
        # prefill thread -> engine thread, bounded to the slot count
        self._ready: "queue.Queue[tuple[Request, _PagedRun, int]]" = \
            queue.Queue(maxsize=sc.slots)
        self._prefix_lock = threading.Lock()
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
        self._count_lock = threading.Lock()
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.total_generated = 0
        self.last_error: Optional[str] = None
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
                g.capture(self.params, self._kv_store.arena, pool)
        self._thread.start()
        self._prefill_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self._prefill_thread.join(timeout=10)

    def submit(self, prompt: list[int], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               logit_bias: Optional[dict] = None,
               seed: Optional[int] = None) -> Future:
        """Enqueue a generation request; resolves to {rid, tokens,
        latency_s, ttft_s}. Invalid arguments resolve to ValueError."""
        try:
            req = self._build_request(prompt, max_new_tokens, temperature,
                                      top_k, top_p, presence_penalty,
                                      frequency_penalty, logit_bias, seed)
        except ValueError as exc:
            return _failed(exc)
        with self._admit_lock:  # atomic check + put against racing submits
            if self._draining.is_set():
                self._count("drain_rejected")
                return _failed(EngineDraining(
                    "engine is draining; submit to another replica"))
            self._queue.put(req)
            self._queue_event.set()
        return req.future

    def drain(self):
        """Stop admitting (submits resolve to EngineDraining) and finish
        everything in flight or queued. Idempotent."""
        with self._admit_lock:
            self._draining.set()

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
        return self._queue.qsize()

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    def prefix_cache_stats(self) -> dict:
        with self._prefix_lock:
            out = self._kv_store.stats()
            out["page_bytes"] = self._kv_store.page_bytes
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
        request. EngineOverloaded when the pool cannot hold it now."""
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
        out = self._prefill_paged_native(tokens)
        if out is None:
            raise EngineOverloaded(f"KV pool cannot hold the "
                                   f"{len(tokens)}-token prefix; retry later")
        run = out[1]
        with self._prefix_lock:
            try:
                if tokens in self._registered:
                    return   # raced with an identical registration
                # re-check: a concurrent registration may have filled the
                # registry while this one prefilled outside the lock
                self._check_registry_room()
                self._registered.append(tokens)
                if run.store is self._kv_store:
                    # the prefill adopted the pages unpinned; this second
                    # walk pins them, then the run's own references drop
                    run.store.insert_ready(0, tokens, run.pages, pin=True)
            finally:
                run.store.release(run.pages)

    def _check_registry_room(self) -> None:
        if len(self._registered) >= self.sc.max_prefixes:
            raise ValueError(
                f"prefix registry full ({self.sc.max_prefixes}); each entry "
                "pins KV pages — raise max_prefixes or restart to clear")

    def _covers_registered(self, tokens: list[int]) -> bool:
        """Does this prompt start with a registered prefix?"""
        return any(len(r) <= len(tokens) and tokens[:len(r)] == r
                   for r in self._registered)

    def _graphs(self) -> list:
        return [g for g in (self._paged_step, self._paged_verify)
                if g is not None]

    def graphs_snapshot(self) -> dict:
        """The watchdog's per-graph capture counts, with each graph's
        width, replays and the device memory around its capture."""
        out = self.watchdog.snapshot()
        for g in self._graphs():
            out[g.name].update(width=g.fn.width, replays=g.fn.replays,
                               capture_memory=g.fn.capture_memory)
        return out

    def debug_snapshot(self) -> dict:
        """/debug/engine: per-slot state, queue depths, pool occupancy and
        the counters. Fields are single reads; a snapshot may straddle a
        step."""
        now = time.perf_counter()
        slots = []
        for i, s in enumerate(self._slots):
            r = s.request
            if r is None:
                slots.append({"slot": i, "state": "free"})
                continue
            slots.append({"slot": i, "state": "decoding", "rid": r.rid,
                          "age_s": round(now - r.submitted_at, 4),
                          "prompt_tokens": len(r.prompt),
                          "generated_tokens": len(s.generated),
                          "remaining_tokens": s.remaining,
                          "pages": len(s.pages)})
        with self._count_lock:
            counters = dict(self.counters)
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
                "in_transit": self._transit, "cache_len": self.sc.cache_len,
                "paged_decode": True, "paged_prefill": True,
                "speculate_k": sc.speculate_k,
                "serving_chunk_tokens": self._chunk_tokens,
                "prefix_cache": self.prefix_cache_stats(),
                "counters": counters,
                "graphs": self.graphs_snapshot(),
                "total_generated": self.total_generated,
                "last_error": self.last_error}

    # -- submission -----------------------------------------------------------

    def _build_request(self, prompt, max_new_tokens, temperature, top_k,
                       top_p, presence_penalty, frequency_penalty,
                       logit_bias, seed) -> Request:
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
            temperature = 0.0   # greedy
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
        if seed is None:
            with self._seed_lock:
                seed = int(self._seed_rng.integers(0, 2 ** 32))
        elif not _is_int(seed):
            raise ValueError(f"seed must be an int, got {seed!r}")
        return Request(prompt=list(prompt),
                       max_new_tokens=min(max_new_tokens,
                                          sc.cache_len - len(prompt)),
                       rid=uuid.uuid4().hex[:8], future=Future(),
                       submitted_at=time.perf_counter(),
                       temperature=float(temperature), top_k=top_k,
                       top_p=float(top_p),
                       presence_penalty=float(presence_penalty),
                       frequency_penalty=float(frequency_penalty),
                       logit_bias=logit_bias or None,
                       seed=seed & 0xFFFFFFFF)

    def _count(self, name: str, n: int = 1) -> None:
        with self._count_lock:
            self.counters[name] += n

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
        if req.future.cancelled():
            self._count("cancelled")
            return
        run = None
        try:
            out = self._prefill_paged_native(req.prompt)
            if out is None:
                self._count("admission_rejected")
                _fail_future(req.future, EngineOverloaded(
                    f"KV pool cannot hold the {len(req.prompt)}-token "
                    f"prompt of {req.rid}; retry later"))
                return
            last_logits, run = out
            if req.logit_bias:
                brow = torch.from_numpy(_bias_row(req.logit_bias,
                                                  self.cfg.vocab_size))
                last_logits = last_logits + brow.to(self.device)[None, :]
            # penalties count generated tokens only: none apply to the first
            first = _sample(last_logits, [req.seed], [0], [req.temperature],
                            [req.top_k], [req.top_p])[0]
        except Exception as exc:  # noqa: BLE001 — one poisoned prompt only
            log.exception("prefill of %s failed", req.rid)
            self._count("prefill_errors")
            if run is not None:
                with self._prefix_lock:
                    run.store.release(run.pages)
            _fail_future(req.future, exc)
            return
        while not self._stop.is_set():
            try:
                self._ready.put((req, run, first), timeout=0.1)
                return
            except queue.Full:
                continue

    def _prefill_paged_native(self, tokens: list[int]
                              ) -> Optional[tuple[torch.Tensor, _PagedRun]]:
        """Prefill straight into the arena: allocate the prompt's page run
        up front (a prefix hit's matched pages join it in place), scatter
        each chunk's K/V into those pages, then insert the run's full pages
        into the trie by reference. Chunks are ``serving_chunk_tokens``
        long when set, and then the thread yields one decode step between
        them while a slot decodes; else ``max_prefill_len``. Returns (last
        logits (1, V), run), or None when the pool cannot hold the run."""
        store = self._kv_store
        t = self.sc.kv_page_tokens
        n_pages = -(-len(tokens) // t)
        with self._prefix_lock:
            m = store.match(0, tokens)
            try:
                tail = (store.alloc_run(n_pages - len(m.pages))
                        if n_pages > len(m.pages) else [])
            except PoolExhausted:
                store.release(m.pages)
                return None
        covered = m.matched_tokens
        pages = list(m.pages) + tail
        self._count("prefix_cache_hits" if covered else "prefix_cache_misses")
        if covered and self._covers_registered(tokens):
            self._count("prefix_hits")
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
                            true_len)
                    self._count("prefill_chunks")
                self._count("paged_prefill_tokens", len(chunk))
                if self._chunk_tokens and start + step < len(rest):
                    ran = self._arbiter.yield_for_decode(
                        lambda: self.active_slots > 0)
                    if ran:
                        self._count("chunk_interleaved_steps", ran)
            with self._prefix_lock:
                store.insert_ready(0, tokens, pages)
        except Exception:
            with self._prefix_lock:
                store.release(pages)
            raise
        return last_logits, _PagedRun(pages, len(tokens), store)

    # -- engine thread --------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                admitted = self._admit()
                if self.active_slots == 0:
                    if not admitted:
                        self._stop.wait(0.002)
                    continue
                self._decode_once_paged()
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
        self._count("engine_errors")
        for slot in self._slots:
            req, slot.request = slot.request, None
            if req is not None:
                _fail_future(req.future, exc)
            slot.pages = []
            slot.kv_len = 0
        for q in (self._queue, self._ready):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                req = item if isinstance(item, Request) else item[0]
                _fail_future(req.future, exc)
        self._page_tables_np[:] = 0
        with self._prefix_lock:
            arena = self._kv_store.arena
            for section in arena.values():
                section.zero_()
            self._kv_store = PagedKVStore(self._kv_store.pool.n_pages,
                                          self.sc.kv_page_tokens, arena)

    def _admit(self) -> bool:
        admitted = False
        for slot_id, slot in enumerate(self._slots):
            if slot.request is not None:
                continue
            with self._transit_lock:
                try:
                    req, run, first = self._ready.get_nowait()
                except queue.Empty:
                    break
                self._transit += 1
            try:
                self._admit_into_slot(slot_id, slot, req, run, first)
            finally:
                with self._transit_lock:
                    self._transit -= 1
            admitted = True
            if slot.request is not None and self._finished(slot):
                self._complete(slot_id, slot)
        return admitted

    def _admit_into_slot(self, slot_id: int, slot: _Slot, req: Request,
                         run: _PagedRun, first: int):
        """The run's pages, references and all, become the slot's table."""
        if run.store is not self._kv_store:
            _fail_future(req.future, RuntimeError(
                f"engine recovered while {req.rid} was in flight; its "
                "prefilled pages were discarded — retry"))
            self._count("admission_rejected")
            return
        slot.pages = list(run.pages)
        slot.kv_len = run.kv_len
        slot.bigram_index = {}
        slot.indexed_upto = 0
        row = self._page_tables_np[slot_id]
        row[:] = 0
        row[:len(slot.pages)] = slot.pages
        self._slot_seed[slot_id] = req.seed
        self._slot_draws[slot_id] = 1  # draw 0 was the prefill's token
        self._set_slot_rows(slot_id, req, first)
        slot.request = req
        slot.generated = [first]
        slot.remaining = req.max_new_tokens - 1
        slot.last_token = first
        req.first_token_at = time.perf_counter()
        self._count("admitted")

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
        with PRIVATE pages (shared prefix pages are never written). On pool
        exhaustion this request fails and every other slot keeps going."""
        t = self.sc.kv_page_tokens
        row = self._page_tables_np[slot_id]
        store = self._kv_store
        while len(slot.pages) * t < slot.kv_len + need:
            with self._prefix_lock:
                try:
                    page = store.alloc_run(1)[0]
                except PoolExhausted as exc:
                    store.release(slot.pages)
                    slot.pages = []
                    slot.kv_len = 0
                    row[:] = 0
                    req, slot.request = slot.request, None
                    _fail_future(req.future, RuntimeError(
                        f"KV pool exhausted mid-decode for {req.rid}: "
                        f"{exc}"))
                    return False
            row[len(slot.pages)] = page
            slot.pages.append(page)
        return True

    def _decode_once_paged(self):
        if self.sc.speculate_k > 0 and self._decode_once_speculative_paged():
            return
        for slot_id, slot in enumerate(self._slots):
            if slot.request is not None:
                self._grow_slot_table(slot_id, slot, 1)
        active = [s.request is not None for s in self._slots]
        if not any(active):
            return
        with self._prefix_lock:
            logits = self._paged_step(
                self.params, self._kv_store.arena,
                [s.last_token for s in self._slots],
                [s.kv_len for s in self._slots], self._page_tables_np,
                active)
            self._count("decode_steps")
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
        Greedy slots commit the matched drafts plus the corrected token;
        sampled, penalized and biased slots ride along at n_tokens = 1,
        whose KV write and logits[:, 0] are the plain step's, and draw
        with the plain step's draw index. Rejected rows roll back page-
        natively: the committed length stops at the first mismatch and the
        table's pages past ceil(kv_len / T) return to the pool. Returns
        False, deferring to the plain step, when no live slot is greedy."""
        k = self.sc.speculate_k
        slots = self._slots
        t = self.sc.kv_page_tokens

        def greedy(slot: _Slot) -> bool:
            r = slot.request
            return (r is not None and r.temperature <= 0.0
                    and not _logit_modded(r))

        if not any(greedy(s) for s in slots):
            return False
        # table growth BEFORE the step: a greedy slot writes up to k + 1
        # rows, never past its budget (the table is ceil(cache_len / T)
        # pages wide), a sampled slot 1
        widths = [0] * len(slots)
        for i, slot in enumerate(slots):
            if slot.request is not None:
                widths[i] = min(k + 1, slot.remaining) if greedy(slot) else 1
                self._grow_slot_table(i, slot, widths[i])
        active = [s.request is not None for s in slots]   # growth may fail
        if not any(active):
            return True
        is_greedy = [greedy(s) for s in slots]
        toks_in = np.zeros((len(slots), k + 1), np.int32)
        n_tokens = np.where(active, widths, 0).astype(np.int32)
        for i, slot in enumerate(slots):
            if active[i]:
                toks_in[i] = slot.last_token   # drafts of non-greedy: unread
                if is_greedy[i]:
                    toks_in[i, 1:] = self._propose(slot, k)
        with self._prefix_lock:
            logits = self._paged_verify(
                self.params, self._kv_store.arena, toks_in,
                [s.kv_len for s in slots], self._page_tables_np, active,
                n_tokens)
            self._count("decode_steps")
            self._count("paged_speculative_steps")
        # one device -> host copy of every slot's K-wide argmax
        greedy_np = logits.argmax(dim=-1).cpu().numpy()
        reqs = [s.request for s in slots]
        sampled = None
        if not all(g for g, a in zip(is_greedy, active) if a):
            l0 = self._maybe_penalize(logits[:, 0], reqs)
            sampled = _sample(l0, self._slot_seed, self._slot_draws,
                              [r.temperature if r else 0.0 for r in reqs],
                              [r.top_k if r else 0 for r in reqs],
                              [r.top_p if r else 1.0 for r in reqs])
            if self._tok_counts is not None:
                for i, r in enumerate(reqs):
                    if _penalized(r):
                        self._tok_counts[i, sampled[i]] += 1
        self._slot_draws = [d + 1 for d in self._slot_draws]
        self._count("spec_proposed", k * sum(is_greedy))
        accepted = rolled_back = 0
        for i, slot in enumerate(slots):
            if not active[i]:
                continue
            if is_greedy[i]:
                committed = []
                for j in range(n_tokens[i]):
                    g = int(greedy_np[i, j])
                    committed.append(g)
                    if j + 1 >= n_tokens[i] or g != toks_in[i, j + 1]:
                        break   # a mismatch: g is the corrected token
            else:
                committed = [sampled[i]]
            appended = 0
            for tok in committed:
                if slot.request is None:
                    break   # finished mid-run (eos or budget)
                # committing token j commits the step's row j at kv_len
                slot.kv_len += 1
                slot.generated.append(tok)
                slot.last_token = tok
                slot.remaining -= 1
                appended += 1
                self.total_generated += 1
                if self._finished(slot):
                    self._complete(i, slot)
            if is_greedy[i] and appended > 1:
                accepted += appended - 1   # drafts actually consumed
            if slot.request is None:
                continue   # _complete released every page
            keep = -(-slot.kv_len // t)
            if len(slot.pages) > keep:
                # pages past the committed length hold only rejected rows,
                # all private (shared prefix pages lie below kv_len)
                dropped = slot.pages[keep:]
                del slot.pages[keep:]
                self._page_tables_np[i, keep:] = 0
                with self._prefix_lock:
                    self._kv_store.release(dropped)
                rolled_back += len(dropped)
        self._count("spec_accepted", accepted)
        self._count("paged_speculative_rollback_pages", rolled_back)
        return True

    def _commit_decode(self, logits: torch.Tensor):
        """Per-slot sampling, stop checks and slot bookkeeping."""
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
        for slot_id, slot in enumerate(self._slots):
            if slot.request is None:
                continue
            slot.kv_len += 1  # the step wrote the input token's KV
            tok = nxt[slot_id]
            slot.generated.append(tok)
            slot.last_token = tok
            slot.remaining -= 1
            self.total_generated += 1
            if self._finished(slot):
                self._complete(slot_id, slot)

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

    def _finished(self, slot: _Slot) -> bool:
        if slot.request.future.cancelled():
            return True
        return slot.remaining <= 0 or slot.last_token == self.sc.eos_token

    def _complete(self, slot_id: int, slot: _Slot):
        req = slot.request
        slot.request = None
        # shared prefix pages stay in the trie for the next hit; private
        # tail pages free now
        with self._prefix_lock:
            self._kv_store.release(slot.pages)
        slot.pages = []
        slot.kv_len = 0
        self._page_tables_np[slot_id][:] = 0
        now = time.perf_counter()
        out = {"rid": req.rid, "tokens": slot.generated,
               "latency_s": now - req.submitted_at,
               "ttft_s": req.first_token_at - req.submitted_at}
        try:
            # the atomic claim: False iff the client's cancel won
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(out)
            else:
                self._count("cancelled")
        except Exception:  # noqa: BLE001 — future already resolved
            pass


def _failed(exc: BaseException) -> Future:
    f: Future = Future()
    f.set_exception(exc)
    return f


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)
