"""Serving request/slot state, admission types and the chunk arbiter (port
of the JAX package's ``workloads/serving/scheduler.py``, restricted to the
fields the port's two decode loops use, the paged loop and the
contiguous one)."""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Optional

# SLO histograms live sub-second: the default bucket ladder (0.5 s first
# bucket, sized for pod provisioning) would crush every TTFT/ITL sample
# into one bin (the JAX package's buckets, so fleet merges line up)
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0)
ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
               1.0, 2.5)
UTIL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


@dataclasses.dataclass
class ServingConfig:
    slots: int = 4               # concurrent decode streams
    # longest prefill chunk: a prompt past it prefills in several chunks
    max_prefill_len: int = 512
    cache_len: int = 1024        # per-slot KV budget (prompt + generation)
    max_new_tokens: int = 128
    eos_token: int = -1          # -1 = never stop on a token
    # the temperature a request that names none samples at (0 = greedy)
    temperature: float = 0.0
    # tokens per KV page (the pool's allocation and prefix-match granule)
    kv_page_tokens: int = 16
    # pages in the arena. 0 = auto: twice the slots' residency (slots *
    # ceil(cache_len / kv_page_tokens)), one share for the decode slots and
    # one for the shared prefix pool. At least the slots' residency: the
    # decode slots live in the arena
    kv_pool_pages: int = 0
    # admission bound: a submit that finds this many requests queued
    # resolves to EngineOverloaded (HTTP 429). 0 = unbounded
    max_queue_depth: int = 0
    # weight-only int8 (models/quant.py): per-output-channel scales, the
    # dequant multiply after each matmul
    quantize_int8: bool = False
    # weight-only int4: two weights a byte, group-wise scales, the
    # int4_matmul kernel; a quarter of bf16's weight bytes. Mutually
    # exclusive with quantize_int8
    quantize_int4: bool = False
    # int8 KV arena with per-(position, kv head) f32 scales: half the
    # arena's bytes, read through paged_attention_multi_quant
    quantize_kv_int8: bool = False
    # ring KV cache for windowed models on the contiguous loop: a
    # uniform window rings every layer, an interleave (Gemma 2 and 3) its
    # local layers, at ~window + write slack positions while cache_len
    # stays the logical budget. None = auto: on whenever the model has a
    # window and the ring is smaller than cache_len; True forces it (an
    # error without a window, and it keeps the paged loop off); False
    # disables it
    ring_cache: Optional[bool] = None
    # the cross-request paged prefix cache: a trie of shared KV pages in
    # one arena, which the paged loop's slots live in too. Off: no arena,
    # the contiguous loop, and register_prefix through the dense store
    prefix_cache_enabled: bool = True
    # the decode loop on page tables over the arena. None = auto: on
    # whenever the layout pages (not a windowed interleave, not
    # ring_cache=True), the prefix cache is on, kv_page_tokens < cache_len
    # and an explicit kv_pool_pages holds every slot; True raises if not;
    # False keeps the contiguous loop
    paged_decode: Optional[bool] = None
    # paged-native prefill on the paged loop: chunks scatter straight into
    # the prompt's pages. None = auto (on with the paged loop); False
    # sends every prompt down the dense-scratch route; True raises
    # without the paged loop
    paged_prefill: Optional[bool] = None
    # speculative decoding by prompt lookup: draft this many tokens a step
    # and verify them in ONE step at K = speculate_k + 1 (paged_verify_step
    # on the paged loop, verify_step over the contiguous loop's cache).
    # Greedy slots commit every matched draft plus the corrected token;
    # sampled (and penalized or biased) slots commit one token a step.
    # Greedy output equals the non-speculative engine's where no two
    # logits tie within the K-wide and 1-wide steps' rounding difference
    # (exact on the f32 test models). 0 = off
    speculate_k: int = 0
    # chunked prefill: prompts prefill in chunks of this many tokens (at
    # most max_prefill_len), and between chunks the prefill thread waits
    # for one decode step when a slot is decoding (ChunkArbiter), so a long
    # prompt no longer holds every stream's next token until it is done.
    # Token-identical to monolithic prefill. 0 = chunks of
    # max_prefill_len, back to back
    serving_chunk_tokens: int = 0
    # how many distinct prefixes register_prefix() pins in the trie (each
    # pins its pages for the engine's life)
    max_prefixes: int = 8
    # under a tensor mesh: how the paged arena places over the shards.
    # "auto" shards the kv-head axis when the mesh divides both head counts
    # (ops.attention.paged_head_shards), else replicates; "replicate" pins
    # one arena every shard reads whole
    kv_arena_sharding: str = "auto"
    # multi-LoRA serving: adapters of this rank over lora_targets, up to
    # max_adapters registered at once (register_adapter), selected per
    # request; the stacks are allocated once, so registering never
    # recaptures a step graph. 0 = off
    lora_rank: int = 0
    lora_targets: tuple = ("wq", "wv")
    max_adapters: int = 8
    # per-decode-step timeline (recorder.FlightRecorder), served at GET
    # /debug/steps: at most recorder_steps records and recorder_bytes of
    # serialized payload (oldest evict first). Off: the engine holds no
    # recorder at all
    flight_recorder: bool = True
    recorder_steps: int = 512
    recorder_bytes: int = 262144
    # per-request card-second metering (costmeter.py): the phase walls
    # the engine stamps priced through generations.py, KV page-seconds,
    # a ledger per tenant at GET /debug/costs and on the reporter's
    # heartbeat. Off: the engine holds no meter
    cost_meter: bool = True


class EngineOverloaded(RuntimeError):
    """Request rejected at admission: the queue is at max_queue_depth, or
    the KV pool cannot supply a dense-route prompt's tail pages."""


class EngineDraining(RuntimeError):
    """Request rejected at admission: the engine is draining. In-flight and
    queued requests still finish."""


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int
    rid: str
    future: Future
    submitted_at: float
    temperature: float
    top_k: int = 0          # 0 = no top-k filter
    top_p: float = 1.0      # 1.0 = no nucleus filter
    # OpenAI penalties over tokens sampled during generation, applied to
    # the logits before temperature and filtering
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: Optional[dict] = None   # {token_id: bias in [-100, 100]}
    # sampling seed: draw i of this request comes from (seed, i), whatever
    # slot it lands in and whatever shares the batch
    seed: int = 0
    # stop token SEQUENCES: generation ends when the generated tail equals
    # one (the matched sequence stays in the output; callers strip it)
    stop: list = dataclasses.field(default_factory=list)
    # stop STRINGS matched on the decoded text (needs the engine's
    # decode_fn): exact for BPE vocabularies, where a stop string can
    # straddle a token boundary
    stop_texts: list = dataclasses.field(default_factory=list)
    # return log P(token | prefix) of each generated token
    logprobs: bool = False
    # streaming: called with each generated token id from the engine
    # thread; a raising callback cancels the request
    on_token: Optional[Any] = None
    # co-submitted requests over the IDENTICAL prompt (OpenAI n > 1): one
    # prefill fans out to every member, each sampling its own first token
    fanout: Optional[list] = None
    # distributed-tracing context (W3C traceparent): trace_id groups this
    # request's spans with the caller's trace; span_id is the request's
    # root span id (the HTTP layer mints it, so it can stamp the response
    # header before the request finishes); parent_span_id is the caller's
    # inbound span. Empty: the engine mints ids at completion
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    # span boundaries (perf_counter, like submitted_at): queue wait =
    # submitted -> dequeued, prefill = dequeued -> prefill_done, decode =
    # prefill_done -> finish (contiguous, so the children sum to the
    # request's latency)
    dequeued_at: float = 0.0
    prefill_done_at: float = 0.0
    first_token_at: float = 0.0
    # prompt tokens served from the prefix cache (0 = full prefill),
    # stamped by the prefill thread for the request span
    matched_prefix_tokens: int = 0
    # multi-LoRA: the adapter slot this request decodes with (0 = base)
    adapter_id: int = 0
    # the cost meter's tenant (X-Tenant, else the OpenAI user field); an
    # accounting label only ("" = none)
    tenant: str = ""


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: list[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    last_token: int = 0
    # the slot's page-table row: page ids in position order, one pool
    # reference held per page (shared prefix pages read-only, tail pages
    # private); kv_len is the committed token count = next write position
    pages: list[int] = dataclasses.field(default_factory=list)
    kv_len: int = 0
    # entries of the page-table row in use: len(pages), until a windowed
    # slot recycles (its row then names some of its pages twice)
    table_len: int = 0
    # prompt-lookup drafting: bigram -> latest start position over
    # prompt + generated, indexed lazily in _propose (amortized O(1) a
    # token where a rescan would be O(context) a step)
    bigram_index: dict = dataclasses.field(default_factory=dict)
    indexed_upto: int = 0
    logprobs: list = dataclasses.field(default_factory=list)
    # stop_texts: a running tail of token ids trimmed by decoded length
    stop_tail: list = dataclasses.field(default_factory=list)
    stop_tail_upto: int = 0
    # when the slot last emitted a token (perf_counter): the inter-token
    # gap's left end
    last_emit_at: float = 0.0


class ChunkArbiter:
    """Chunk-vs-decode arbitration for chunked prefill.

    The prefill thread calls ``yield_for_decode`` between chunks; when a
    slot is decoding it blocks until the engine thread reports one
    COMPLETED decode step (``decode_step_done`` after every step), so the
    device order becomes chunk, decode step, chunk, ... With no live slot
    the yield is free. The timeout is a liveness backstop only (the last
    slot can complete between the check and the wait; the engine's crash
    path fails slots without a step): correctness never depends on it.
    Several prefilling threads (``register_prefix`` runs on HTTP handler
    threads) share one arbiter; every step wakes them all."""

    def __init__(self):
        self._cond = threading.Condition()
        self._steps = 0

    def decode_step_done(self) -> None:
        with self._cond:
            self._steps += 1
            self._cond.notify_all()

    def yield_for_decode(self, active_fn, timeout_s: float = 0.5) -> int:
        """Block until >= 1 decode step ran (returns how many), or return 0
        at once when ``active_fn()`` says nothing is decoding. The timeout
        must comfortably exceed one decode step: timing out while a step
        runs would let chunks queue ahead of it again."""
        with self._cond:
            start = self._steps
            if not active_fn():
                return 0
            self._cond.wait_for(
                lambda: self._steps > start or not active_fn(),
                timeout=timeout_s)
            return self._steps - start


def _fail_future(fut: Future, exc: BaseException) -> None:
    """set_exception tolerant of a client cancel landing between a done()
    check and the call."""
    try:
        if not fut.done():
            fut.set_exception(exc)
    except Exception:  # noqa: BLE001 — racing future.cancel()
        pass
