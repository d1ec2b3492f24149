"""Serving request/slot state and admission types (port of the JAX
package's ``workloads/serving/scheduler.py``, restricted to the fields the
paged loop of this port uses)."""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Optional


@dataclasses.dataclass
class ServingConfig:
    slots: int = 4               # concurrent decode streams
    # longest prefill chunk: a prompt past it prefills in several chunks
    max_prefill_len: int = 512
    cache_len: int = 1024        # per-slot KV budget (prompt + generation)
    max_new_tokens: int = 128
    eos_token: int = -1          # -1 = never stop on a token
    # tokens per KV page (the pool's allocation and prefix-match granule)
    kv_page_tokens: int = 16
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


class EngineOverloaded(RuntimeError):
    """Request rejected at admission: the KV pool cannot hold its
    prompt."""


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
    first_token_at: float = 0.0


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


def _fail_future(fut: Future, exc: BaseException) -> None:
    """set_exception tolerant of a client cancel landing between a done()
    check and the call."""
    try:
        if not fut.done():
            fut.set_exception(exc)
    except Exception:  # noqa: BLE001 — racing future.cancel()
        pass
