"""HTTP front over the port's ServingEngine (a port of the JAX package's
``workloads/serve_main.py``).

Endpoints:
  POST /generate      {"tokens": [...]} or {"text": "..."} (with a
                      tokenizer), plus optional "max_new_tokens",
                      "temperature", "top_k", "top_p", "presence_penalty",
                      "frequency_penalty", "logit_bias", "seed", "stop"
                      (token lists, or strings with a tokenizer),
                      "logprobs" -> {"rid", "tokens", "latency_s"} (+
                      "logprobs", + "text" with a tokenizer);
                      with "stream": true, chunked NDJSON: one {"token": N}
                      line per token, then the result object. "adapter"
                      names a registered LoRA adapter (400 when unknown)
  POST /v1/completions  OpenAI completions: prompt (string with a
                      tokenizer, or token list), max_tokens, temperature,
                      top_p, stop, logprobs, seed, n (one prefill fanned
                      out to n slots), presence/frequency_penalty,
                      logit_bias, stream (SSE), usage; with --lora-rank
                      the "model" field selects a registered adapter (the
                      base model's name or none: the base; 404 when
                      unknown)
  POST /v1/chat/completions  OpenAI chat: messages through the
                      tokenizer's chat template, the same options
  POST /v1/embeddings OpenAI embeddings: the mean-pooled final-norm
                      hidden state of each input (string, token list or
                      lists of either); 400 past max_prefill_len tokens;
                      base model only (an adapter's name 400, another
                      404)
  POST /prefix        the /generate body's "tokens" or "text": prefill
                      the prefix once and pin its full KV pages, so later
                      prompts starting with it skip them -> {"registered":
                      n}; 400 on an empty or too-long prefix or a full
                      registry (--max-prefixes)
  POST /adapters      {"name": ..., "path": adapter.npz}: register a LoRA
                      adapter (``models.lora.save_adapter``'s file, or the
                      JAX package's ``train_main --export-adapter``) live
                      -> {"registered": name}; 403 unless
                      --dynamic-adapters, 400 on a bad file (the detail
                      goes to the server log)
  GET  /v1/models     the served model and its registered adapters
  GET  /healthz       liveness: 200 while the engine thread lives (body
                      "draining" while draining), 503 once it died
  GET  /readyz        routability: 503 while draining or dead
  POST /drain         stop admitting, finish in-flight work
  GET  /debug/engine  the engine's debug snapshot
  GET  /debug/costs   the cost meter's ledger (chip-seconds a phase, KV
                      page-seconds and dollars, in total and by tenant);
                      404 with --cost-meter off
  GET  /debug/steps   ?n= the flight recorder's newest n step records and
                      phase medians, and the step graphs' capture counts
  GET  /metrics       Prometheus text 0.0.4: the engine's counters, gauges
                      and histograms (``tpu_serving_*``, the JAX engine's
                      names and HELP texts)
  GET  /debug/traces  ?trace_id= one trace's spans, else the newest spans
  GET  /debug/profile ?seconds= (0, 30]: a torch.profiler capture (CPU, and
                      the card's kernels when the engine is on one) written
                      as a Chrome trace into a fresh temporary directory ->
                      {"profile_dir", "seconds"}; 403 unless
                      --profile-capture on, 409 while another capture runs
  POST /kv_prefill    disaggregated prefill hop (router -> prefill replica):
                      {"path", "request", "handoff_to": decode URL,
                      "device", "device_domain"}: prefill the request's
                      prompt through the prefix cache and hand its full
                      pages to the decode replica — arena to arena when the
                      router annotated "device" and the replica is an
                      engine of this process, through a tmpfs blob for a
                      vouched domain in another process (shm), else the
                      wire codec; streamed chunk by chunk with
                      --serving-chunk-tokens. Every device-rung failure
                      downgrades (tpu_serving_kv_handoff_device_downgrades);
                      a prompt under one page answers {"skip": true}
  POST /kv_adopt      a pushed page run (the wire codec's blob) adopted into
                      this arena through the prefix trie; 400 on a refused
                      blob, the arena untouched
  POST /kv_adopt_chunk  one frame of a streamed run, held in order; the
                      arena moves when the final frame closes a valid
                      stream
  POST /kv_adopt_shm  {"path"}: a tmpfs blob parked by a sender of this host
  POST /kv_pull       owner side of a directory pull: an already-cached run
                      as the response body, or {"via": "shm"} a tmpfs path;
                      404 {"gone": true} when the arena no longer holds it
  POST /kv_fetch      cold-replica side of a directory pull: fetch the run
                      from {"owner_url"} over device -> shm -> wire and adopt
                      it; always 200 (a failed pull just prefills)

/generate, /prefix and the OpenAI completion routes take a W3C
``traceparent`` header: its trace id and span become the request's trace
and parent span, and every response carries the request's own
``traceparent`` (feed its trace id to /debug/traces). /generate and the
OpenAI completion routes meter each request to a tenant: the ``X-Tenant``
header, else the OpenAI ``user`` field (64 characters at most). A submit past
--max-queue-depth answers 429 (the OpenAI error shape on /v1/*) with
Retry-After; a draining engine 503. With --fleet-router the replica
registers with the fleet router as its --serving-role (unified, prefill or
decode) and --placement-domain, and heartbeats its load, its metrics
snapshot and its prefix-directory publishes
(``fleet.registry.ReplicaReporter``).

Run: python -m k8s_runpod_kubelet_tpu_torch.workloads.serve_main \
        --model llama3-8b --slots 8 --cache-len 2048 --port 8000 \
        [--tokenizer bytes|DIR] [--int4 | --int8] [--kv-int8]
        [--speculate K] [--serving-chunk-tokens N] [--max-prefixes N]
        [--config YAML] [--kv-page-tokens N] [--kv-pool-pages N]
        [--max-queue-depth N] [--max-connections N] [--flight-recorder off]
        [--hf-checkpoint DIR] [--tensor-parallel N] [--expert-parallel E]
        [--lora-rank R [--lora-targets wq,wv] [--max-adapters N]
         [--dynamic-adapters]] [--trace-export PATH]
        [--profile-capture on|off] [--cost-meter on|off]
        [--fleet-router URL
         [--fleet-advertise URL] [--fleet-replica-id ID]
         [--fleet-heartbeat-interval S]] [--serving-role ROLE]
        [--handoff-stream-window N] [--device-transfer on|off]
        [--placement-domain D] [--placement-domain-mode auto|proc|slice]
        [--pull-timeout S]
(``--model mla-8b`` serves Multi-head Latent Attention from a latent
arena; ``--kv-int8`` then makes the latents int8. ``--model
deepseek-v2-lite`` serves DeepSeek-V2-Lite: the latent arena, with its
dense first layer's own sections, over 64 routed and 2 shared experts.
``deepseek-v3`` is in the registry but is no serve target. ``--model
gemma2-9b`` and ``gemma3-12b``, and any model with ``--prefix-cache off``
or ``--paged-decode off``, serve from the contiguous loop, ``--lora-rank``
and ``POST /adapters`` included: an adapter ``train_main --model
gemma2-9b --lora-rank R --export-adapter`` wrote registers there, and
``--speculate K`` and ``--tensor-parallel N`` serve there too. An MoE
model serves under ``--expert-parallel E``, with ``--tensor-parallel N``
beside it for Mixtral; DeepSeek's latent attention keeps N at 1.)

Every serving knob resolves as the JAX replica resolves it
(``resolve_settings``): the flag, else its TPU_* environment variable (the
JAX autoscaler puts them on every serving pod it creates), else the
``--config`` YAML, else the ``config.Config`` default. ``--profiler-port``
is refused by name. Past ``--max-connections`` connections in flight a
connection gets an immediate 503 with ``Retry-After: 1``
(``tpu_serving_http_rejected``); GET /metrics and /healthz keep a reserve
of two.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import itertools
import json
import logging
import os
import queue
import socket
import struct
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..device import resolve_device
from ..fleet.device_transfer import (BUS, ShmBlobGC, detect_placement_domain,
                                     device_pull, device_push, open_shm_blob,
                                     write_shm_blob)
from ..fleet.handoff import (KVPullMiss, serialize_chunk_frame,
                             serialize_pages)
from ..tracing import Tracer, format_traceparent, parse_traceparent
from .serving import (EngineDraining, EngineOverloaded, ServingConfig,
                      ServingEngine)
from .serving.engine import host_sections
from .tokenizer import get_tokenizer

log = logging.getLogger("serve-main")

# the request-id tail: unique even when the wall clock stands still
_RID_SEQ = itertools.count()
# one torch.profiler capture at a time (the profiler is process-wide)
_PROFILE_LOCK = threading.Lock()


class ProfileBusy(RuntimeError):
    """A ``torch.profiler`` capture is already running in this process."""


def _or(value, default):
    """JSON null falls back to the default, like an absent key."""
    return default if value is None else value


def _close_map(blob) -> None:
    """Close a mapped tmpfs blob; while a failed adoption's traceback still
    holds views of it, the mapping closes when the last view dies."""
    try:
        blob.close()
    except BufferError:
        pass


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine = None  # bound by serve()
    tokenizer = None              # None = token-ids-only API
    allow_adapters = False        # POST /adapters (--dynamic-adapters)
    request_timeout_s = 120.0
    # wall clock for OpenAI "created" stamps and ids, monotonic deadlines
    clock = staticmethod(time.time)
    mono = staticmethod(time.monotonic)
    # GET /debug/profile: a capture slows the engine and writes to the
    # replica's disk, so it stays 403 unless the operator opted in; the
    # capture window's sleep is a seam like the clocks
    profile_capture = False
    sleep = staticmethod(time.sleep)
    # streamed handoff: chunk fragments queued between the chunked prefill
    # and the sender thread pushing them (compute waits when it is full)
    handoff_stream_window = 8
    # this replica's placement domain ("": every hop rides the wire)
    device_domain = ""
    # budget of one directory-pull hop (owner export, transfer, adoption)
    pull_timeout_s = 10.0
    # owner-side sweep of pull blobs a dead puller never unlinked
    shm_gc = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, status: int, payload, ctype: str = "application/json",
              extra_headers: dict | None = None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _overloaded(self, e, openai: bool = False):
        """429 + Retry-After for EngineOverloaded, 503 for
        EngineDraining (retry another replica)."""
        status = 503 if isinstance(e, EngineDraining) else 429
        err = ({"error": {"message": str(e), "type": "overloaded_error"}}
               if openai else {"error": str(e)})
        return self._send(status, err, extra_headers={"Retry-After": "1"})

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(length)) if length else {}

    def _trace_ctx(self) -> tuple[dict, dict]:
        """(submit kwargs, response headers) of this request's trace: an
        inbound W3C ``traceparent`` donates the trace id and the parent
        span, else a fresh trace id is minted. The request's root span id
        is minted here, before it runs, so every response (streamed or
        not) can stamp the ``traceparent`` a caller feeds to
        /debug/traces."""
        inbound = parse_traceparent(self.headers.get("traceparent"))
        trace_id = inbound[0] if inbound else Tracer.new_trace_id()
        parent = inbound[1] if inbound else ""
        root = Tracer.new_span_id()
        return ({"trace_id": trace_id, "parent_span": parent,
                 "span_id": root},
                {"traceparent": format_traceparent(trace_id, root)})

    def _tenant_kw(self, body: dict) -> dict:
        """The cost meter's tenant, as the JAX front takes it: the
        ``X-Tenant`` header wins (the fleet router forwards it as it is),
        else the OpenAI ``user`` field; cut to 64 characters (it becomes
        a ledger key)."""
        tenant = self.headers.get("X-Tenant") or body.get("user") or ""
        return {"tenant": str(tenant)[:64]}

    def do_GET(self):
        eng = self.engine
        url = urllib.parse.urlparse(self.path)
        if url.path in ("/healthz", "/readyz"):
            if not eng.alive:
                return self._send(503, b"engine thread dead", "text/plain")
            if eng.draining:
                status = 200 if url.path == "/healthz" else 503
                return self._send(status, b"draining", "text/plain")
            return self._send(200, b"ok" if url.path == "/healthz"
                              else b"ready", "text/plain")
        if url.path == "/v1/models":
            # the base model, then every registered adapter
            now = int(self.clock())
            data = [{"id": eng.cfg.name, "object": "model", "created": now,
                     "owned_by": "base"}]
            data += [{"id": n, "object": "model", "created": now,
                      "owned_by": "adapter"} for n in eng.adapter_names]
            return self._send(200, {"object": "list", "data": data})
        if url.path == "/debug/engine":
            return self._send(200, eng.debug_snapshot())
        if url.path == "/debug/costs":
            # the replica's cost ledger; the same snapshot rides the
            # reporter's heartbeat into the router's fleet-wide one
            if eng.costmeter is None:
                return self._send(404, {"error": "cost meter disabled "
                                                 "(--cost-meter off)"})
            return self._send(200, eng.costmeter.snapshot())
        if url.path == "/debug/steps":
            q = urllib.parse.parse_qs(url.query)
            try:
                n = int((q.get("n") or ["64"])[0])
            except ValueError:
                return self._send(400, {"error": "n must be an integer"})
            return self._send(200, eng.debug_steps(n))
        if url.path == "/metrics":
            return self._send(200, eng.metrics.render().encode(),
                              "text/plain; version=0.0.4")
        if url.path == "/debug/traces":
            q = urllib.parse.parse_qs(url.query)
            return self._send(200, eng.tracer.query(
                (q.get("trace_id") or [""])[0]))
        if url.path == "/debug/profile":
            if not self.profile_capture:
                return self._send(
                    403, {"error": "profile capture disabled; start with "
                                   "--profile-capture on to enable"})
            q = urllib.parse.parse_qs(url.query)
            try:
                seconds = float((q.get("seconds") or ["1"])[0])
            except ValueError:
                return self._send(400, {"error": "seconds must be a number"})
            if not 0 < seconds <= 30:
                return self._send(
                    400, {"error": "seconds must be in (0, 30]"})
            try:
                out_dir = capture_profile(eng, seconds, self.sleep)
            except ProfileBusy:
                # a second capture never queues behind the first: a
                # capture that does not return would hold every later one
                return self._send(
                    409, {"error": "a profile capture is already running"})
            return self._send(200, {"profile_dir": out_dir,
                                    "seconds": seconds})
        self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        hop = {"/kv_prefill": self._kv_prefill, "/kv_adopt": self._kv_adopt,
               "/kv_adopt_chunk": self._kv_adopt_chunk,
               "/kv_adopt_shm": self._kv_adopt_shm,
               "/kv_pull": self._kv_pull,
               "/kv_fetch": self._kv_fetch}.get(self.path)
        if hop is not None:
            return hop()
        if self.path == "/drain":
            self._read_json()  # unread bytes would poison keep-alive
            self.engine.drain()
            return self._send(200, {"draining": True,
                                    "queue_depth": self.engine.queue_depth,
                                    "active_slots": self.engine.active_slots})
        if self.path == "/v1/completions":
            return self._openai_completion(chat=False)
        if self.path == "/v1/chat/completions":
            return self._openai_completion(chat=True)
        if self.path == "/v1/embeddings":
            return self._openai_embeddings()
        if self.path == "/adapters":
            return self._register_adapter()
        if self.path not in ("/generate", "/prefix"):
            return self._send(404, {"error": f"no route {self.path}"})
        try:
            req = self._read_json()
            tokens = self._request_tokens(self.path, req)
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            return self._send(400, {"error": f"bad request: {e}"})
        if self.path == "/prefix":
            _, trace_hdrs = self._trace_ctx()
            try:
                self.engine.register_prefix(tokens)
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except EngineOverloaded as e:   # an MLA engine's full pool
                return self._overloaded(e)
            return self._send(200, {"registered": len(tokens)},
                              extra_headers=trace_hdrs)
        if req.get("stream"):
            return self._generate_stream(tokens, req)
        try:
            stop, stop_strs = self._parse_stop(req.get("stop"))
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        trace_kw, trace_hdrs = self._trace_ctx()
        fut = self.engine.submit(
            tokens, req.get("max_new_tokens"), req.get("temperature"),
            top_k=_or(req.get("top_k"), 0), top_p=_or(req.get("top_p"), 1.0),
            presence_penalty=_or(req.get("presence_penalty"), 0.0),
            frequency_penalty=_or(req.get("frequency_penalty"), 0.0),
            logit_bias=req.get("logit_bias"), seed=req.get("seed"),
            stop=stop, stop_text=stop_strs,
            logprobs=bool(req.get("logprobs")),
            adapter=req.get("adapter") or "", **trace_kw,
            **self._tenant_kw(req))
        try:
            out = fut.result(timeout=self.request_timeout_s)
        except FutureTimeout:
            fut.cancel()  # the engine frees the slot at its next step
            return self._send(504, {"error": "generation timed out"})
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        except (EngineOverloaded, EngineDraining) as e:
            return self._overloaded(e)
        except Exception as e:  # noqa: BLE001 — engine failure: JSON 500
            return self._send(500, {"error": str(e)})
        body = {k: out[k] for k in ("rid", "tokens", "latency_s",
                                    "logprobs") if k in out}
        if self.tokenizer is not None:
            text = self.tokenizer.decode(out["tokens"])
            if stop_strs:  # a text stop: cut at its first occurrence
                text, _ = self._cut_at_stop(text, stop_strs)
            body["text"] = text
        self._send(200, body, extra_headers=trace_hdrs)

    # -- disaggregated serving: the KV handoff and pull doors ---------------

    def _hop_trace(self) -> tuple[str, str]:
        """(trace id, parent span) of an inbound ``traceparent``, or a
        fresh trace id: a hop's spans join the router's trace."""
        inbound = parse_traceparent(self.headers.get("traceparent"))
        if inbound:
            return inbound[0], inbound[1]
        return Tracer.new_trace_id(), ""

    def _span_fn(self, name: str, started: float, trace_id: str,
                 parent: str, span_id: str = "", **fixed):
        """span(ok, attrs) recording ``name`` from ``started``; tracing
        never fails a hop."""
        tr = self.engine.tracer

        def span(ok: bool, attrs: dict):
            try:
                tr.record(name, started, tr.clock(), trace_id=trace_id,
                          span_id=span_id or None, parent_id=parent,
                          attrs={"ok": ok, **fixed, **attrs})
            except Exception:  # noqa: BLE001 — tracing never fails the hop
                log.exception("%s span failed", name)
        return span

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _kv_prefill(self):
        """Disaggregated prefill hop (router -> prefill replica): compute
        the prompt's KV through the engine's prefix-cache prefill and
        hand the page run to the decode replica named by "handoff_to" —
        arena to arena when the router annotated ``device`` (the ladder:
        an engine of this process, else the shm rung for a vouched
        domain, else the wire), through the wire codec otherwise, streamed
        chunk by chunk with ``serving_chunk_tokens`` set. A prompt under
        one page answers a quiet ``skip``. The serving.kv_prefill span
        parents under the router's fleet.handoff."""
        trace_id, parent = self._hop_trace()
        span_id = Tracer.new_span_id()
        span = self._span_fn("serving.kv_prefill", self.engine.tracer.clock(),
                             trace_id, parent, span_id)
        try:
            req = self._read_json()
            target = req.get("handoff_to")
            if not (isinstance(target, str) and target):
                raise ValueError('need "handoff_to" (decode replica URL)')
        except (json.JSONDecodeError, ValueError, TypeError,
                AttributeError) as e:
            span(False, {"error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        try:
            tokens = self._request_tokens(str(req.get("path") or "/generate"),
                                          req.get("request") or {})
            # before any compute: a prompt under one full page has
            # nothing to hand off, and prefilling it here would only
            # double the fallback replica's prefill
            if len(tokens) < self.engine.sc.kv_page_tokens:
                raise ValueError(
                    f"prompt of {len(tokens)} tokens is under one "
                    f"{self.engine.sc.kv_page_tokens}-token page")
        except (ValueError, TypeError) as e:
            # an expected decline, not a failure: the router falls back
            # quietly and no failure counter moves
            span(False, {"skip": True, "error": str(e)})
            return self._send(200, {"ok": False, "skip": True,
                                    "error": str(e)})
        if req.get("device") and self.device_domain:
            try:
                out = device_push(self.engine, target, tokens,
                                  domain=self.device_domain,
                                  window=self.handoff_stream_window,
                                  target_domain=str(
                                      req.get("device_domain") or ""),
                                  timeout_s=self.request_timeout_s)
            except Exception as e:  # noqa: BLE001 — every device failure
                # downgrades to the wire below (and a wire failure to the
                # router's unified fallback): an observability event,
                # never a client error
                self.engine.metrics.incr(
                    "tpu_serving_kv_handoff_device_downgrades")
                log.warning("device handoff to %s downgraded to wire: %s",
                            target, e)
            else:
                span(True, {"path": out.get("path", "device"),
                            "tokens": len(tokens), "pages": out["pages"],
                            "bytes": out["bytes"],
                            "streamed": out["streamed"],
                            "chunks": out.get("chunks"),
                            "matched_tokens": out["matched_tokens"]})
                return self._send(200, {"ok": True, **out})
        if self.engine.sc.serving_chunk_tokens > 0:
            return self._kv_prefill_streamed(tokens, target, trace_id,
                                             span_id, span)
        try:
            out = self.engine.export_handoff(tokens)
        except Exception as e:  # noqa: BLE001 — export counts its failures
            span(False, {"tokens": len(tokens), "error": str(e)})
            return self._send(502, {"ok": False, "error": str(e)})
        blob = out["blob"]
        try:
            push = urllib.request.Request(
                target.rstrip("/") + "/kv_adopt", data=blob,
                headers={"Content-Type": "application/octet-stream",
                         "traceparent": format_traceparent(trace_id,
                                                           span_id)},
                method="POST")
            with urllib.request.urlopen(
                    push, timeout=self.request_timeout_s) as resp:
                adopted = json.loads(resp.read() or b"{}")
            if not adopted.get("ok"):
                raise OSError(f"decode replica refused adoption: {adopted}")
        except Exception as e:  # noqa: BLE001 — any push failure = failed hop
            self.engine.metrics.incr("tpu_serving_kv_handoff_failures")
            span(False, {"tokens": len(tokens), "pages": out["pages"],
                         "error": str(e)})
            return self._send(502, {"ok": False, "error": str(e)})
        span(True, {"path": "wire", "tokens": len(tokens),
                    "pages": out["pages"], "bytes": len(blob),
                    "matched_tokens": out["matched_tokens"]})
        return self._send(200, {
            "ok": True, "path": "wire", "pages": out["pages"],
            "bytes": len(blob), "covered_tokens": out["covered_tokens"],
            "matched_tokens": out["matched_tokens"],
            "adopted": adopted.get("pages")})

    def _kv_prefill_streamed(self, tokens: list, target: str,
                             trace_id: str, span_id: str, span):
        """The chunked prefill hop: ``export_handoff_stream`` computes
        chunk by chunk and hands each chunk's pages to a SENDER THREAD
        here, which copies them to the host, frames them and POSTs them to
        the decode replica's /kv_adopt_chunk over one keep-alive
        connection while the next chunk computes. The queue between them
        holds ``handoff_stream_window`` fragments: compute waits when
        transfer falls that far behind. serving.kv_chunk (compute) and
        serving.kv_push (copy, frame, POST) spans parent under the hop's
        serving.kv_prefill. Any frame failure aborts the stream with a
        502; the decode side's partial stream expires without touching
        its arena."""
        eng = self.engine
        tr = eng.tracer
        stream_id = uuid.uuid4().hex
        page_tokens = eng.sc.kv_page_tokens
        sendq: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(self.handoff_stream_window)))
        push_err: list = []
        stats = {"frames": 0, "bytes": 0, "push_s": 0.0}

        def child_span(name, t0, attrs):
            try:
                tr.record(name, t0, tr.clock(), trace_id=trace_id,
                          parent_id=span_id, attrs=attrs)
            except Exception:  # noqa: BLE001 — tracing never fails the hop
                log.exception("%s span failed", name)

        def sender():
            parsed = urllib.parse.urlsplit(target)
            path = parsed.path.rstrip("/") + "/kv_adopt_chunk"
            conn = None
            try:
                while True:
                    frag = sendq.get()
                    if frag is None:
                        return
                    t0w, t0 = tr.clock(), self.mono()
                    try:
                        payload = b""
                        if frag["sections"]:
                            # the host copy happens here, never on the
                            # compute thread
                            sections, words = host_sections(
                                frag["sections"], frag["ready"], eng.device)
                            payload = serialize_pages(
                                frag["tokens"], page_tokens, sections,
                                model=eng.cfg.name, dtypes=words)
                        blob = serialize_chunk_frame(
                            stream_id, frag["seq"], payload,
                            final=frag["final"],
                            total_tokens=frag.get("total_tokens"))
                        if conn is None:
                            cls = (http.client.HTTPSConnection
                                   if parsed.scheme == "https"
                                   else http.client.HTTPConnection)
                            conn = cls(parsed.hostname, parsed.port or (
                                443 if parsed.scheme == "https" else 80),
                                timeout=self.request_timeout_s)
                            conn.connect()
                            # headers and body go out as two writes: with
                            # Nagle on, delayed ACKs cost ~40 ms a frame
                            conn.sock.setsockopt(socket.IPPROTO_TCP,
                                                 socket.TCP_NODELAY, 1)
                        conn.request(
                            "POST", path, body=blob,
                            headers={"Content-Type":
                                     "application/octet-stream",
                                     "traceparent": format_traceparent(
                                         trace_id, span_id)})
                        resp = conn.getresponse()
                        reply = json.loads(resp.read() or b"{}")
                        if resp.status != 200 or not reply.get("ok"):
                            raise OSError(f"decode replica refused frame "
                                          f"{frag['seq']}: {resp.status} "
                                          f"{reply}")
                        stats["frames"] += 1
                        stats["bytes"] += len(blob)
                        stats["push_s"] += self.mono() - t0
                        eng.metrics.incr("tpu_serving_kv_handoff_bytes",
                                         len(blob))
                        child_span("serving.kv_push", t0w,
                                   {"seq": frag["seq"],
                                    "final": frag["final"],
                                    "bytes": len(blob),
                                    "pages": len(frag["tokens"])
                                    // page_tokens})
                    except Exception as e:  # noqa: BLE001 — a failed
                        # frame fails the hop: emit sees push_err
                        push_err.append(e)
                        child_span("serving.kv_push", t0w,
                                   {"seq": frag["seq"], "ok": False,
                                    "error": str(e)})
                        return
            finally:
                if conn is not None:
                    conn.close()

        chunk_t0 = [tr.clock()]

        def emit(frag):
            child_span("serving.kv_chunk", chunk_t0[0],
                       {"seq": frag["seq"], "final": frag["final"],
                        "tokens": len(frag["tokens"]),
                        "pages": len(frag["tokens"]) // page_tokens})
            chunk_t0[0] = tr.clock()
            while True:
                if push_err:
                    raise OSError(f"stream push failed: {push_err[0]}")
                try:
                    sendq.put(frag, timeout=0.1)
                    return
                except queue.Full:
                    continue

        thread = threading.Thread(target=sender, name="kv-handoff-sender",
                                  daemon=True)

        def finish_sender(abort: bool):
            """Land the close sentinel whatever happened (a stranded
            sender leaks a thread a hop): on abort drop the stale frames
            first; on success wait for room, the sender still pushing."""
            if not abort:
                while not push_err:
                    try:
                        sendq.put(None, timeout=0.1)
                        thread.join(timeout=self.request_timeout_s)
                        return
                    except queue.Full:
                        continue
            while True:
                try:
                    sendq.get_nowait()
                except queue.Empty:
                    break
            sendq.put(None)
            thread.join(timeout=self.request_timeout_s)

        t_start = self.mono()
        thread.start()
        try:
            out = eng.export_handoff_stream(tokens, emit)
            compute_s = self.mono() - t_start
        except Exception as e:  # noqa: BLE001 — export counts its failures
            span(False, {"streamed": True, "tokens": len(tokens),
                         "error": str(e)})
            finish_sender(abort=True)
            return self._send(502, {"ok": False, "error": str(e)})
        finish_sender(abort=False)
        wall_s = self.mono() - t_start
        if thread.is_alive():
            # the final frame's adoption is unconfirmed: fail the hop
            push_err.append(OSError(
                f"transfer outlived request_timeout_s="
                f"{self.request_timeout_s}; adoption unconfirmed"))
        if push_err:
            eng.metrics.incr("tpu_serving_kv_handoff_failures")
            span(False, {"streamed": True, "tokens": len(tokens),
                         "chunks": out["chunks"],
                         "error": str(push_err[0])})
            return self._send(502, {"ok": False,
                                    "error": str(push_err[0])})
        # how much of the smaller leg hid behind the other
        floor = min(compute_s, stats["push_s"])
        overlap = max(0.0, compute_s + stats["push_s"] - wall_s)
        overlap_ratio = (round(min(1.0, overlap / floor), 3)
                         if floor > 1e-9 else 0.0)
        span(True, {"path": "wire", "streamed": True, "tokens": len(tokens),
                    "pages": out["pages"], "chunks": out["chunks"],
                    "bytes": stats["bytes"],
                    "matched_tokens": out["matched_tokens"],
                    "overlap_ratio": overlap_ratio})
        return self._send(200, {
            "ok": True, "path": "wire", "streamed": True,
            "pages": out["pages"], "bytes": stats["bytes"],
            "chunks": out["chunks"], "covered_tokens": out["covered_tokens"],
            "matched_tokens": out["matched_tokens"],
            "overlap_ratio": overlap_ratio, "compute_s": round(compute_s, 6),
            "push_s": round(stats["push_s"], 6), "wall_s": round(wall_s, 6)})

    def _kv_adopt_chunk(self):
        """Decode side of a STREAMED handoff: one chunk frame in, held in
        strict order; the arena moves only when the final frame closes a
        valid stream. 400 on any refusal (the sender aborts, the router
        falls back)."""
        trace_id, parent = self._hop_trace()
        span = self._span_fn("serving.kv_adopt_chunk",
                             self.engine.tracer.clock(), trace_id, parent)
        blob = self._read_body()
        try:
            out = self.engine.adopt_handoff_chunk(blob)
        except Exception as e:  # noqa: BLE001 — the engine counts failures
            span(False, {"bytes": len(blob), "error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        span(True, {"bytes": len(blob), "seq": out.get("seq"),
                    "final": out["final"],
                    **({"pages": out["pages"]} if out["final"] else {})})
        return self._send(200, out)

    def _kv_adopt(self):
        """Decode side: adopt a pushed page run into this engine's arena
        (its prefix trie), so the request that follows references it."""
        trace_id, parent = self._hop_trace()
        span = self._span_fn("serving.kv_adopt", self.engine.tracer.clock(),
                             trace_id, parent)
        blob = self._read_body()
        try:
            out = self.engine.adopt_handoff(blob)
        except Exception as e:  # noqa: BLE001 — adopt counts its failures
            span(False, {"bytes": len(blob), "error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        span(True, out)
        return self._send(200, {"ok": True, **out})

    def _kv_adopt_shm(self):
        """Receiver of the cross-process push rung: the sender parked a
        handoff blob in the shm dir and POSTs only its path; map it and
        adopt it through the wire door's validation. The sender owns the
        file (it unlinks it whether or not this lands); 400 on any
        refusal, and the sender downgrades to the wire."""
        trace_id, parent = self._hop_trace()
        span = self._span_fn("serving.kv_adopt", self.engine.tracer.clock(),
                             trace_id, parent, path="shm")
        try:
            req = self._read_json()
            blob = open_shm_blob(str(req.get("path") or ""))
        except Exception as e:  # noqa: BLE001 — a vanished, foreign or
            # torn path is the sender's downgrade signal
            span(False, {"error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        try:
            out = self.engine.adopt_handoff(blob)
        except Exception as e:  # noqa: BLE001 — adopt counts its failures
            span(False, {"bytes": len(blob), "error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        finally:
            _close_map(blob)
        span(True, out)
        return self._send(200, {"ok": True, **out})

    def _kv_pull(self):
        """OWNER side of a directory pull: a cold replica's /kv_fetch asks
        for an already-computed page run. ``export_pull`` only matches, so
        a run the arena evicted answers 404 {"gone": true} (every rung
        reads this one trie: the puller reports gone and the request
        prefills). ``via: "shm"`` parks the blob in tmpfs and answers its
        path (the puller maps it and unlinks it; ShmBlobGC sweeps what a
        dead puller leaves); else the blob is the response body."""
        trace_id, parent = self._hop_trace()
        span = self._span_fn("serving.kv_pull", self.engine.tracer.clock(),
                             trace_id, parent, side="owner")
        try:
            req = self._read_json()
            tokens = req.get("tokens")
            if not (isinstance(tokens, list)
                    and all(isinstance(t, int) for t in tokens)):
                raise ValueError("tokens must be a list of ints")
            adapter = str(req.get("adapter") or "")
            via = str(req.get("via") or "wire")
        except (json.JSONDecodeError, ValueError, TypeError,
                AttributeError) as e:
            span(False, {"error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        try:
            out = self.engine.export_pull(tokens, adapter=adapter)
        except KVPullMiss as e:
            # not a failure: directory staleness, which the router's
            # invalidations count
            span(False, {"gone": True, "error": str(e)})
            return self._send(404, {"ok": False, "gone": True,
                                    "error": str(e)})
        except Exception as e:  # noqa: BLE001 — export counts its failures
            span(False, {"error": str(e)})
            return self._send(502, {"ok": False, "error": str(e)})
        blob = out["blob"]
        if via == "shm":
            gc = self.shm_gc
            if gc is not None:
                gc.sweep()   # blobs a dead puller never unlinked
            try:
                path = write_shm_blob(blob)
            except OSError as e:
                self.engine.metrics.incr("tpu_serving_kv_pull_failures")
                span(False, {"via": "shm", "error": str(e)})
                return self._send(502, {"ok": False, "error": str(e)})
            if gc is not None:
                gc.track(path)
            span(True, {"via": "shm", "pages": out["pages"],
                        "bytes": len(blob)})
            return self._send(200, {
                "ok": True, "path": path, "pages": out["pages"],
                "bytes": len(blob), "covered_tokens": out["covered_tokens"]})
        span(True, {"via": "wire", "pages": out["pages"],
                    "bytes": len(blob)})
        return self._send(200, blob, "application/octet-stream",
                          extra_headers={
                              "X-KV-Pages": str(out["pages"]),
                              "X-KV-Covered-Tokens":
                                  str(out["covered_tokens"])})

    def _owner_pull(self, owner_url: str, payload: dict, trace_id: str,
                    span_id: str):
        """One control POST to the owner's /kv_pull: ("gone", message)
        when the run no longer exists there, ("blob", bytes) for a wire
        reply, ("json", dict) for a shm path; OSError on a transport
        failure (the caller walks down a rung)."""
        req = urllib.request.Request(
            owner_url.rstrip("/") + "/kv_pull",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": format_traceparent(trace_id, span_id)},
            method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.pull_timeout_s) as resp:
                ctype = resp.headers.get("Content-Type") or ""
                raw = resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                parsed = json.loads(body or b"{}")
            except json.JSONDecodeError:
                parsed = {}
            if e.code == 404 and parsed.get("gone"):
                return ("gone", str(parsed.get("error") or "gone"))
            raise OSError(f"owner /kv_pull answered {e.code}: "
                          f"{parsed.get('error') or body[:200]!r}") from e
        if "octet-stream" in ctype:
            return ("blob", raw)
        out = json.loads(raw or b"{}")
        if not isinstance(out, dict):
            raise OSError(f"owner /kv_pull answered non-object: {out!r}")
        if out.get("gone"):
            return ("gone", str(out.get("error") or "gone"))
        if not out.get("ok"):
            raise OSError(f"owner /kv_pull refused: {out}")
        return ("json", out)

    def _kv_fetch(self):
        """COLD-REPLICA side of a directory pull: the router found the
        prompt's prefix in the fleet directory under ANOTHER replica and
        asks this engine to fetch the pages before the request lands.
        The pull ladder, fastest first: device (the owner is an engine of
        this process) -> shm (same host, blob through tmpfs) -> wire (blob
        in the owner's response). A transport failure walks down a rung;
        a KVPullMiss at any rung answers {"gone": true} at once (every
        rung reads the owner's one trie). Always HTTP 200: a failed pull
        is a missed optimization, the request then prefills."""
        trace_id, parent = self._hop_trace()
        span_id = Tracer.new_span_id()
        span = self._span_fn("serving.kv_pull", self.engine.tracer.clock(),
                             trace_id, parent, span_id, side="puller")
        try:
            req = self._read_json()
            tokens = req.get("tokens")
            if not (isinstance(tokens, list) and tokens
                    and all(isinstance(t, int) for t in tokens)):
                raise ValueError("tokens must be a non-empty list of ints")
            owner_url = str(req.get("owner_url") or "")
            if not owner_url:
                raise ValueError('need "owner_url"')
            adapter = str(req.get("adapter") or "")
            owner_domain = str(req.get("owner_domain") or "")
            model = str(req.get("model") or "")
        except (json.JSONDecodeError, ValueError, TypeError,
                AttributeError) as e:
            span(False, {"error": str(e)})
            return self._send(400, {"ok": False, "error": str(e)})
        # this side's half of the adoption contract, before any owner
        # traffic: neither miss means the OWNER's pages are gone, so a
        # plain failure (the router does not invalidate)
        msg = ""
        if model and model != self.engine.cfg.name:
            msg = (f"directory entry is for model {model!r}, this replica "
                   f"serves {self.engine.cfg.name!r}")
        elif adapter and adapter not in self.engine.adapter_names:
            msg = f"adapter {adapter!r} is not registered on this replica"
        if msg:
            span(False, {"owner": owner_url, "error": msg})
            return self._send(200, {"ok": False, "error": msg})

        def gone(e):
            span(False, {"gone": True, "owner": owner_url, "error": str(e)})
            return self._send(200, {"ok": False, "gone": True,
                                    "error": str(e)})

        def pulled(pages: int, nbytes: int, covered: int, rung: str):
            self.engine.metrics.incr("tpu_serving_kv_pull_runs")
            self.engine.metrics.incr("tpu_serving_kv_pull_bytes", nbytes)
            span(True, {"path": rung, "owner": owner_url, "pages": pages,
                        "bytes": nbytes, "covered_tokens": covered})
            return self._send(200, {"ok": True, "path": rung,
                                    "pages": pages,
                                    "covered_tokens": covered})

        errors = []
        if self.device_domain and owner_domain == self.device_domain:
            try:   # rung 1: the owner is an engine of this process
                out = device_pull(self.engine, owner_url, tokens,
                                  adapter=adapter, domain=self.device_domain)
                return pulled(out["pages"], out["bytes"],
                              out["covered_tokens"], "device")
            except KVPullMiss as e:
                return gone(e)
            except Exception as e:  # noqa: BLE001 — a bus miss: the owner
                # is another process; the shm rung reads the same trie
                errors.append(f"device: {e}")
            try:   # rung 2: same host, the blob through tmpfs
                kind, reply = self._owner_pull(
                    owner_url, {"tokens": tokens, "adapter": adapter,
                                "via": "shm"}, trace_id, span_id)
                if kind == "gone":
                    return gone(reply)
                path = str(reply.get("path") or "")
                blob = open_shm_blob(path)
                try:
                    out = self.engine.adopt_handoff(blob, adapter=adapter)
                finally:
                    _close_map(blob)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass   # the owner's GC sweeps it
                return pulled(out["pages"], out["bytes"], out["tokens"],
                              "shm")
            except KVPullMiss as e:
                return gone(e)
            except Exception as e:  # noqa: BLE001 — walk to the wire rung
                errors.append(f"shm: {e}")
        try:   # rung 3: the blob in the owner's response body
            kind, reply = self._owner_pull(
                owner_url, {"tokens": tokens, "adapter": adapter},
                trace_id, span_id)
            if kind == "gone":
                return gone(reply)
            if kind != "blob":
                raise OSError(f"owner answered a {kind} reply to a wire "
                              "pull")
            out = self.engine.adopt_handoff(reply, adapter=adapter)
            return pulled(out["pages"], out["bytes"], out["tokens"], "wire")
        except KVPullMiss as e:
            return gone(e)
        except Exception as e:  # noqa: BLE001 — the ladder is exhausted;
            # the request prefills (the unified fallback)
            errors.append(f"wire: {e}")
        self.engine.metrics.incr("tpu_serving_kv_pull_failures")
        span(False, {"owner": owner_url, "error": "; ".join(errors)})
        return self._send(200, {"ok": False, "error": "; ".join(errors)})

    def _register_adapter(self):
        """POST /adapters: register a LoRA adapter from a ``.npz`` path the
        server reads. Opt-in (--dynamic-adapters): it lets a client open a
        path and replace a live tenant's weights. Any failure (a missing
        or corrupt file, wrong shapes, a full registry) is a 400 whose
        detail goes to the server log only, so the answer is no probe of
        the filesystem."""
        if not self.allow_adapters:
            self._read_json()   # unread bytes would poison keep-alive
            return self._send(403, {
                "error": "dynamic adapter registration is disabled (start "
                         "with --dynamic-adapters)"})
        try:
            req = self._read_json()
            name, path = req.get("name"), req.get("path")
            if not (isinstance(name, str) and name
                    and isinstance(path, str) and path):
                raise ValueError('need "name" and "path" (adapter .npz)')
            from ..models.lora import load_adapter
            self.engine.register_adapter(name, load_adapter(path))
        except Exception as e:  # noqa: BLE001 — corrupt files raise anything
            log.warning("adapter registration failed: %s: %s",
                        type(e).__name__, e)
            return self._send(400, {"error": "adapter registration failed "
                                             "(see server log)"})
        return self._send(200, {"registered": name})

    def _parse_stop(self, raw) -> tuple[list, list]:
        """OpenAI ``stop``: a string, a list of strings (needs the
        tokenizer) or a list of token lists. Returns (token sequences,
        stop strings): strings encode without special tokens; a BPE
        tokenizer also matches them on the decoded text, so a stop
        straddling a token boundary still stops (a byte tokenizer's token
        match is already text-exact)."""
        if raw is None:
            return [], []
        if isinstance(raw, str):
            raw = [raw]
        if not isinstance(raw, list):
            raise ValueError("stop must be string(s) or token lists")
        toks_out, strs_out = [], []
        for q in raw:
            if isinstance(q, str):
                if self.tokenizer is None:
                    raise ValueError("string stop sequences need "
                                     "--tokenizer")
                toks = self.tokenizer.encode_plain(q)
                if toks:
                    toks_out.append(toks)
                if q and not getattr(self.tokenizer, "byte_exact", False):
                    strs_out.append(q)
            elif isinstance(q, list):
                toks_out.append(q)
            else:
                raise ValueError("stop must be string(s) or token lists")
        return toks_out, strs_out

    @staticmethod
    def _cut_at_stop(text: str, stop_strs: list) -> tuple[str, bool]:
        """Truncate at the first occurrence of any stop string (the stop
        text never reaches the client)."""
        idxs = [i for i in (text.find(q) for q in stop_strs) if i >= 0]
        if idxs:
            return text[:min(idxs)], True
        return text, False

    def _request_tokens(self, path: str, body) -> list:
        """A request body's prompt token ids, for every generation route
        and /prefix."""
        if not isinstance(body, dict):
            raise ValueError("request must be an object")
        if path == "/v1/chat/completions":
            messages = body.get("messages")
            if not (isinstance(messages, list) and messages and all(
                    isinstance(m, dict) and isinstance(m.get("role"), str)
                    and isinstance(m.get("content"), str)
                    for m in messages)):
                raise ValueError("messages must be a non-empty list of "
                                 "{role, content} objects")
            if self.tokenizer is None:
                raise ValueError("chat completions need --tokenizer")
            tokens = list(self.tokenizer.apply_chat(messages))
            if not tokens:
                raise ValueError("empty prompt")
            return tokens
        if path == "/v1/completions":
            prompt = body.get("prompt", "")
            if isinstance(prompt, list) and all(
                    isinstance(t, int) for t in prompt):
                tokens = prompt
            elif isinstance(prompt, str):
                if self.tokenizer is None:
                    raise ValueError("string prompts need --tokenizer; "
                                     "send a token list instead")
                tokens = self.tokenizer.encode(prompt)
            else:
                raise ValueError("prompt must be a string or token list")
            if not tokens:
                raise ValueError("empty prompt")
            return tokens
        # /generate and /prefix share the tokens/text body
        if "text" in body and "tokens" not in body:
            if self.tokenizer is None:
                raise ValueError('server has no tokenizer (start with '
                                 '--tokenizer bytes or a tokenizer '
                                 'directory) — send "tokens"')
            if not isinstance(body["text"], str):
                raise ValueError("text must be a string")
            tokens = self.tokenizer.encode(body["text"])
            if not tokens:
                raise ValueError("text tokenized to nothing")
            return tokens
        tokens = body.get("tokens")
        if not isinstance(tokens, list) or not all(
                isinstance(t, int) for t in tokens):
            raise ValueError("tokens must be a list of ints")
        return tokens

    def _stream_pump(self, tokens: list, kw: dict, ctype: str, fmt: dict,
                     extra_headers: dict | None = None):
        """Streamed generation (NDJSON /generate and SSE /v1/*): the engine
        thread pushes tokens into a queue, this handler thread writes them
        out as HTTP chunks. A broken pipe raises in the engine's next
        ``on_token`` call, which cancels the request. ``request_timeout_s``
        bounds the whole request. ``fmt`` callbacks each return a list of
        body chunks: token(t), timeout(), error(msg), end(result), an
        optional start() sent right after the headers, and badreq(msg) /
        overloaded(msg) for a submit that fails at once. ``extra_headers``
        ride the 200's headers."""
        q: "queue.Queue" = queue.Queue()
        dead = threading.Event()

        def on_token(t):
            if dead.is_set():  # the client is gone: cancels in the engine
                raise ConnectionError("stream client disconnected")
            q.put(("tok", t))

        fut = self.engine.submit(tokens, on_token=on_token, **kw)
        if fut.done() and fut.exception() is not None:
            exc = fut.exception()
            if isinstance(exc, (EngineOverloaded, EngineDraining)):
                overloaded = fmt.get("overloaded", fmt["badreq"])
                return self._send(
                    503 if isinstance(exc, EngineDraining) else 429,
                    overloaded(str(exc)), extra_headers={"Retry-After": "1"})
            return self._send(400, fmt["badreq"](str(exc)))
        fut.add_done_callback(lambda f: q.put(("end", f)))
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()

        def chunk(body: bytes):
            self.wfile.write(f"{len(body):x}\r\n".encode() + body + b"\r\n")
            self.wfile.flush()

        deadline = self.mono() + self.request_timeout_s
        try:
            for body in fmt.get("start", lambda: [])():
                chunk(body)
            while True:
                try:
                    remaining = deadline - self.mono()
                    if remaining <= 0:
                        raise queue.Empty
                    kind, val = q.get(timeout=remaining)
                except queue.Empty:
                    # past the deadline: tell the client and stop the
                    # request (cancel() reaches one still queued)
                    dead.set()
                    fut.cancel()
                    for body in fmt["timeout"]():
                        chunk(body)
                    break
                if kind == "tok":
                    for body in fmt["token"](val):
                        chunk(body)
                else:
                    exc = val.exception()
                    for body in (fmt["error"](str(exc)) if exc
                                 else fmt["end"](val.result())):
                        chunk(body)
                    break
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            dead.set()  # the engine cancels at its next on_token call

    def _openai_embeddings(self):
        """OpenAI /v1/embeddings: ``input`` is a string, a token list, or
        a list of either."""
        try:
            req = self._read_json()
            name = self.engine.cfg.name
            model_req = req.get("model")
            if model_req and model_req != name:
                # the embedding forward runs the base weights: an adapter's
                # name is refused (400), any other name is unknown (404)
                known = model_req in self.engine.adapter_names
                return self._send(400 if known else 404, {"error": {
                    "message": f"model {model_req!r} is not served by "
                               f"/v1/embeddings (base model {name!r} only)",
                    "type": "invalid_request_error"}})
            enc = req.get("encoding_format", "float")
            if enc not in ("float", "base64"):
                raise ValueError(f"encoding_format must be 'float' or "
                                 f"'base64', got {enc!r}")
            dims = req.get("dimensions")
            if dims is not None and dims != self.engine.cfg.embed_dim:
                raise ValueError(
                    f"dimensions={dims} is not supported (embeddings are "
                    f"the model's hidden size, {self.engine.cfg.embed_dim})")
            raw = req.get("input")
            if raw is None:
                raise ValueError("missing input")
            if isinstance(raw, str) or (
                    isinstance(raw, list) and raw
                    and all(isinstance(t, int) for t in raw)):
                raw = [raw]
            if not isinstance(raw, list) or not raw:
                raise ValueError("input must be a non-empty string/list")
            data, total = [], 0
            for i, item in enumerate(raw):
                if isinstance(item, str):
                    if self.tokenizer is None:
                        raise ValueError("string input needs --tokenizer")
                    toks = self.tokenizer.encode(item)
                elif (isinstance(item, list) and item
                      and all(isinstance(t, int) for t in item)):
                    toks = item
                else:
                    raise ValueError(f"input[{i}] must be a string or a "
                                     "non-empty token list")
                total += len(toks)
                vec = self.engine.embed(toks)
                if enc == "base64":   # little-endian f32, as OpenAI's
                    vec = base64.b64encode(struct.pack(
                        f"<{len(vec)}f", *vec)).decode("ascii")
                data.append({"object": "embedding", "index": i,
                             "embedding": vec})
        except (json.JSONDecodeError, ValueError, TypeError,
                OverflowError) as e:
            return self._send(400, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        return self._send(200, {
            "object": "list", "data": data, "model": self.engine.cfg.name,
            "usage": {"prompt_tokens": total, "total_tokens": total}})

    def _openai_completion(self, chat: bool):
        """OpenAI POST /v1/completions and /v1/chat/completions. A matched
        stop sequence or EOS never reaches the returned text, streamed or
        not: streaming holds back the longest tail that could still
        become a stop."""
        try:
            req = self._read_json()
            tokens = self._request_tokens(
                "/v1/chat/completions" if chat else "/v1/completions", req)
            stop, stop_strs = self._parse_stop(req.get("stop"))
            n = _or(req.get("n"), 1)
            if not isinstance(n, int) or isinstance(n, bool) \
                    or not 1 <= n <= 16:
                raise ValueError(f"n must be an int in [1, 16], got {n!r}")
            if n > 1 and req.get("stream"):
                raise ValueError("streaming supports n=1")
            seed = req.get("seed")
            if seed is not None and (not isinstance(seed, int)
                                     or isinstance(seed, bool)):
                raise ValueError(f"seed must be an int, got {seed!r}")
            # logprobs: completions only, not streamed (SSE chunks do not
            # carry them)
            want_lp = (bool(req.get("logprobs")) and not chat
                       and not req.get("stream"))
            # with multi-LoRA the "model" field selects an adapter (the
            # base model's name, or none, the base); an unknown name is a
            # 404, never another tenant's weights. Without it the field is
            # only echoed: clients send placeholders
            model_req = req.get("model") or ""
            adapter = ""
            if (self.engine.multi_lora_enabled and model_req
                    and model_req != self.engine.cfg.name):
                if model_req not in self.engine.adapter_names:
                    return self._send(404, {"error": {
                        "message": f"model {model_req!r} does not exist "
                                   "(not the base model or a registered "
                                   "adapter)",
                        "type": "invalid_request_error"}})
                adapter = model_req
            kw = dict(max_new_tokens=req.get("max_tokens"),
                      temperature=_or(req.get("temperature"), 1.0),
                      top_p=_or(req.get("top_p"), 1.0), stop=stop,
                      stop_text=stop_strs,
                      presence_penalty=_or(req.get("presence_penalty"), 0.0),
                      frequency_penalty=_or(req.get("frequency_penalty"),
                                            0.0),
                      logit_bias=req.get("logit_bias"), logprobs=want_lp,
                      adapter=adapter)
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            return self._send(400, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        trace_kw, trace_hdrs = self._trace_ctx()
        kw.update(trace_kw)
        kw.update(self._tenant_kw(req))
        ns = int(self.clock() * 1e9) + next(_RID_SEQ)
        rid = f"chatcmpl-{ns:x}" if chat else f"cmpl-{ns:x}"
        created = int(self.clock())
        model_name = req.get("model") or self.engine.cfg.name
        eos = self.engine.sc.eos_token

        def finish_reason(toks: list) -> tuple[str, list]:
            """(reason, tokens with a matched stop or EOS tail cut)."""
            for q in stop:
                if len(q) <= len(toks) and toks[-len(q):] == q:
                    return "stop", toks[:-len(q)]
            if toks and toks[-1] == eos:
                return "stop", toks[:-1]
            return "length", toks

        def decode(toks: list) -> str:
            return (self.tokenizer.decode(toks) if self.tokenizer is not None
                    else "")

        def finish_text(all_toks: list) -> tuple[str, list, str]:
            """(reason, cut tokens, final text): the token cut first, then
            the text cut at the first stop string."""
            reason, toks = finish_reason(all_toks)
            text = decode(toks)
            if stop_strs:
                text, hit = self._cut_at_stop(text, stop_strs)
                if hit:
                    reason = "stop"
            return reason, toks, text

        first_chunk = [True]

        def chunk_obj(text: str, reason=None) -> dict:
            if chat:
                delta: dict = {"content": text} if text else {}
                if first_chunk[0]:
                    delta = {"role": "assistant", **delta}
                    first_chunk[0] = False
                return {"id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": model_name,
                        "choices": [{"delta": delta, "index": 0,
                                     "finish_reason": reason}]}
            return {"id": rid, "object": "text_completion",
                    "created": created, "model": model_name,
                    "choices": [{"text": text, "index": 0,
                                 "finish_reason": reason}]}

        def sse(payload) -> bytes:
            data = payload if isinstance(payload, str) else json.dumps(payload)
            return f"data: {data}\n\n".encode()

        if req.get("stream"):
            # hold back the longest tail that could still become a stop or
            # EOS match
            holdback = max([len(q) for q in stop] or [0])
            if eos >= 0:
                holdback = max(holdback, 1)
            pending: list = []   # tokens inside the stop-tail window
            released: list = []  # tokens cleared for emission
            sent = [0]           # chars of decode(released) streamed
            # text stops also hold back (longest stop - 1) chars: a partial
            # stop at the text's tail may still complete
            char_hold = max([len(q) for q in stop_strs] or [1]) - 1
            text_hit = [False]

            def text_delta(final: bool) -> str:
                """Incremental decode by cumulative difference (a
                multi-byte char or a BPE merge may straddle chunks); a
                trailing U+FFFD may be an incomplete char mid-stream."""
                text = decode(released)
                if not final and text.endswith("�"):
                    text = text[:-1]
                if stop_strs:
                    cut, hit = self._cut_at_stop(text, stop_strs)
                    if hit:
                        text_hit[0] = True
                        text = cut
                    elif not final and char_hold:
                        text = text[:max(sent[0], len(text) - char_hold)]
                delta = text[sent[0]:]
                sent[0] += len(delta)
                return delta

            def fmt_token(t) -> list:
                pending.append(t)
                if len(pending) > holdback:
                    released.extend(pending[:len(pending) - holdback])
                    del pending[:len(pending) - holdback]
                    delta = text_delta(final=False)
                    if delta:
                        return [sse(chunk_obj(delta))]
                return []

            def fmt_end(out) -> list:
                reason, cut = finish_reason(out["tokens"])
                n_cut = len(out["tokens"]) - len(cut)
                released.extend(pending[:len(pending) - n_cut]
                                if n_cut else pending)
                bodies = []
                delta = text_delta(final=True)
                if text_hit[0]:
                    reason = "stop"
                if delta:
                    bodies.append(sse(chunk_obj(delta)))
                bodies.append(sse(chunk_obj("", reason)))
                bodies.append(sse("[DONE]"))
                return bodies

            return self._stream_pump(
                tokens, dict(kw, seed=seed), "text/event-stream",
                {"token": fmt_token, "end": fmt_end,
                 # chat leads with the role delta, as OpenAI's own stream
                 "start": lambda: [sse(chunk_obj(""))] if chat else [],
                 "timeout": lambda: [sse({"error": {
                     "message": "generation timed out",
                     "type": "timeout"}}), sse("[DONE]")],
                 "error": lambda msg: [sse({"error": {
                     "message": msg, "type": "server_error"}}),
                     sse("[DONE]")],
                 "badreq": lambda msg: {"error": {
                     "message": msg, "type": "invalid_request_error"}},
                 "overloaded": lambda msg: {"error": {
                     "message": msg, "type": "overloaded_error"}}},
                extra_headers=trace_hdrs)

        # n choices share one prefill; with a seed, member i samples with
        # seed + i, so sampled choices differ
        futs = self.engine.submit_group(tokens, n, seed=seed, **kw)
        deadline = self.mono() + self.request_timeout_s  # shared by all n
        try:
            outs = [f.result(timeout=max(0.0, deadline - self.mono()))
                    for f in futs]
        except FutureTimeout:
            for f in futs:
                f.cancel()
            return self._send(504, {"error": {
                "message": "generation timed out", "type": "timeout"}})
        except ValueError as e:
            for f in futs:
                f.cancel()
            return self._send(400, {"error": {
                "message": str(e), "type": "invalid_request_error"}})
        except (EngineOverloaded, EngineDraining) as e:
            for f in futs:
                f.cancel()
            return self._overloaded(e, openai=True)
        except Exception as e:  # noqa: BLE001 — engine failure: JSON 500
            for f in futs:
                f.cancel()
            return self._send(500, {"error": {"message": str(e),
                                              "type": "server_error"}})
        choices = []
        for i, out in enumerate(outs):
            reason, toks, text = finish_text(out["tokens"])
            if chat:
                choice: dict = {"index": i, "finish_reason": reason,
                                "message": {"role": "assistant",
                                            "content": text}}
            else:
                choice = {"text": text, "index": i, "logprobs": None,
                          "finish_reason": reason}
                if want_lp:
                    choice["logprobs"] = {
                        "token_logprobs": out["logprobs"][:len(toks)],
                        "tokens": [decode([t]) for t in toks],
                        "top_logprobs": None}
            choices.append(choice)
        gen = sum(len(o["tokens"]) for o in outs)
        return self._send(200, {
            "id": rid, "object": "chat.completion" if chat
            else "text_completion", "created": created, "model": model_name,
            "choices": choices,
            "usage": {"prompt_tokens": len(tokens), "completion_tokens": gen,
                      "total_tokens": len(tokens) + gen}},
            extra_headers=trace_hdrs)

    def _generate_stream(self, tokens: list, req: dict):
        """Chunked NDJSON: one {"token": N} line per token, then the
        result object (or {"error": ...})."""
        try:
            stop, stop_strs = self._parse_stop(req.get("stop"))
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        trace_kw, trace_hdrs = self._trace_ctx()
        kw = dict(max_new_tokens=req.get("max_new_tokens"),
                  temperature=req.get("temperature"),
                  top_k=_or(req.get("top_k"), 0),
                  top_p=_or(req.get("top_p"), 1.0), stop=stop,
                  stop_text=stop_strs,
                  presence_penalty=_or(req.get("presence_penalty"), 0.0),
                  frequency_penalty=_or(req.get("frequency_penalty"), 0.0),
                  logit_bias=req.get("logit_bias"), seed=req.get("seed"),
                  logprobs=bool(req.get("logprobs")),
                  adapter=req.get("adapter") or "", **trace_kw,
                  **self._tenant_kw(req))

        def line(payload: dict) -> bytes:
            return (json.dumps(payload) + "\n").encode()

        def fmt_end(out) -> list:
            if self.tokenizer is not None:
                out = dict(out)
                text = self.tokenizer.decode(out["tokens"])
                if stop_strs:
                    text, _ = self._cut_at_stop(text, stop_strs)
                out["text"] = text
            return [line(out)]

        return self._stream_pump(
            tokens, kw, "application/x-ndjson",
            {"token": lambda t: [line({"token": t})], "end": fmt_end,
             "timeout": lambda: [line({"error": "generation timed out"})],
             "error": lambda msg: [line({"error": msg})],
             "badreq": lambda msg: {"error": msg}},
            extra_headers=trace_hdrs)


def capture_profile(engine: ServingEngine, seconds: float,
                    sleep=time.sleep) -> str:
    """One ``torch.profiler`` capture of ``seconds`` while the engine
    serves: CPU activity, and the card's kernels (CUPTI sees every
    thread's launches, graph replays' nodes included) when the engine is
    on one. Writes ``trace.json`` (Chrome trace format) into a fresh
    ``tpu-serving-profile-`` temporary directory and returns it. The
    engine's step graphs were captured in ``start()``, before the front
    took a request: a graph that is not captured yet, or a capture inside
    the window, is a bug here and raises. Raises ``ProfileBusy`` at once
    while another capture runs.

    The profiler starts and stops holding the engine's ``_prefix_lock``,
    under which the engine issues every step: a stop beside another
    thread's ``CUDAGraph.replay`` deadlocked both (the stop inside the
    profiler's ``__exit__``, the replay inside its launch; 2 captures of
    17 on an NVIDIA H100 80GB HBM3). The window itself runs unlocked."""
    from torch.profiler import profile

    def captures() -> int:
        return sum(g["compiles"] for g in engine.watchdog.snapshot().values())

    activities = _profiler_activities(engine)
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfileBusy("a profile capture is already running")
    try:
        out_dir = tempfile.mkdtemp(prefix="tpu-serving-profile-")
        before = captures()
        prof = profile(activities=activities)
        with engine._prefix_lock:
            prof.start()
        try:
            sleep(seconds)
        finally:
            with engine._prefix_lock:
                prof.stop()
        if captures() != before:
            raise RuntimeError("a step graph was captured under the "
                               "profiler")
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    finally:
        _PROFILE_LOCK.release()
    return out_dir


def _profiler_activities(engine: ServingEngine) -> list:
    """CPU activity, and CUDA's for an engine on a card, whose step graphs
    must all be captured already (the profiler never wraps a capture)."""
    from torch.profiler import ProfilerActivity

    if engine.device.type != "cuda":
        return [ProfilerActivity.CPU]
    if any(g["compiles"] < 1 for g in engine.watchdog.snapshot().values()):
        raise RuntimeError("a step graph is not captured yet; the profiler "
                           "must never wrap a CUDA-graph capture")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def init_profiler(engine: ServingEngine) -> None:
    """Start and stop the profiler once on the calling thread. Kineto sets
    its tracer up at its first start, and only on the thread that
    registered it (the one that imported torch; a first start on a
    handler thread logs "External init callback must run in same thread
    as registerClient"); on a card the first start also brings CUPTI up,
    seconds of work better paid before any request. Holds the engine's
    ``_prefix_lock`` as ``capture_profile`` does."""
    from torch.profiler import profile

    with _PROFILE_LOCK, engine._prefix_lock, \
            profile(activities=_profiler_activities(engine)):
        pass


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """Thread-per-connection with a hard bound on connections in flight
    (the JAX package's server, copied): past ``max_connections`` a new
    connection gets an immediate 503 with ``Retry-After: 1`` on the raw
    socket, no handler thread and no engine work, counted by
    ``tpu_serving_http_rejected``, so overload degrades crisply instead of
    by thread or descriptor exhaustion. The engine's queue bound is the
    model-level backpressure; this bounds the HTTP layer itself (idle
    keep-alives, slow clients).

    While the main pool is full, GET /metrics and /healthz (recognised by
    a non-consuming ``MSG_PEEK`` of the request line) ride a reserved pool
    of ``_OBS_RESERVE``: the scrape that should see the incident is not
    shed by it."""

    _REJECT = (b"HTTP/1.1 503 Service Unavailable\r\n"
               b"Retry-After: 1\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: 31\r\n"
               b"Connection: close\r\n\r\n"
               b'{"error": "server overloaded"}\n')
    _OBS_RESERVE = 2

    def __init__(self, addr, handler, max_connections: int = 128,
                 mono=time.monotonic):
        super().__init__(addr, handler)
        self._mono = mono   # the overflow drain's deadline clock
        self.max_connections = max_connections
        self._conn_sem = threading.BoundedSemaphore(max_connections)
        self._obs_sem = threading.BoundedSemaphore(self._OBS_RESERVE)
        self._req_sem: dict[int, threading.BoundedSemaphore] = {}

    def _is_observability(self, request) -> bool:
        try:
            request.settimeout(0.3)
            head = request.recv(64, socket.MSG_PEEK)
            return head.startswith((b"GET /metrics", b"GET /healthz"))
        except OSError:
            return False
        finally:
            try:
                request.settimeout(None)
            except OSError:
                pass

    def process_request(self, request, client_address):
        if self._conn_sem.acquire(blocking=False):
            self._req_sem[id(request)] = self._conn_sem
            try:
                super().process_request(request, client_address)
            except BaseException:  # thread spawn failed: free the slot
                self._req_sem.pop(id(request), None)
                self._conn_sem.release()
                raise
            return
        # overload: triage off the accept thread, since the peek and the
        # reject's drain wait on the peer, and one slow peer must not stall
        # the accept loop (that would shed /metrics too)
        threading.Thread(target=self._triage_overflow,
                         args=(request, client_address), daemon=True).start()

    def _triage_overflow(self, request, client_address):
        if (self._is_observability(request)
                and self._obs_sem.acquire(blocking=False)):
            self._req_sem[id(request)] = self._obs_sem
            # already on a thread of its own: run the handler here
            self.process_request_thread(request, client_address)
            return
        try:
            engine = getattr(self.RequestHandlerClass, "engine", None)
            if engine is not None:
                engine.metrics.incr("tpu_serving_http_rejected")
        except Exception:  # noqa: BLE001 — metrics must never block a 503
            pass
        try:
            request.sendall(self._REJECT)
            # drain so the close does not reset the buffered 503 away,
            # bounded by wall time and bytes (a dribbling client must not
            # pin the thread)
            deadline = self._mono() + 1.0
            drained = 0
            request.settimeout(0.25)
            try:
                while self._mono() < deadline and drained < 65536:
                    data = request.recv(4096)
                    if not data:
                        break
                    drained += len(data)
            except OSError:
                pass
        except OSError:
            pass
        self.shutdown_request(request)

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            sem = self._req_sem.pop(id(request), None)
            if sem is not None:
                sem.release()


def serve(engine: ServingEngine, port: int = 8000, tokenizer=None,
          request_timeout_s: float = 120.0, host: str = "0.0.0.0",
          clock=time.time, mono=time.monotonic,
          allow_adapters: bool = False,
          profile_capture: bool = False, handoff_stream_window: int = 8,
          device_domain: str = "", pull_timeout_s: float = 10.0,
          max_connections: int = 128) -> BoundedThreadingHTTPServer:
    """Start the HTTP front on a daemon thread; ``port`` 0 picks a free
    port (read ``httpd.server_address[1]``). Stop with
    ``httpd.shutdown(); httpd.server_close()``. ``clock``/``mono`` are the
    wall and monotonic clocks (injectable for tests); ``allow_adapters``
    opens POST /adapters, ``profile_capture`` GET /debug/profile (and
    then brings the profiler up here, on the caller's thread:
    ``init_profiler``). ``handoff_stream_window`` bounds a streamed hop's
    fragments in flight, ``device_domain`` is this replica's placement
    domain ("" keeps every hop on the wire; in a domain the replica also
    answers shm pulls, its blobs swept by a ``ShmBlobGC``), and
    ``pull_timeout_s`` budgets one directory-pull hop, and
    ``max_connections`` the connections in flight
    (``BoundedThreadingHTTPServer``). Registering the engine on the device
    bus (``fleet.device_transfer.BUS``) under its
    advertise URL is the caller's step, as ``main`` does."""
    # the HTTP layer's shed counter belongs to this server (the engine
    # never sees a rejected connection), from startup on
    engine.metrics.describe(
        "tpu_serving_http_rejected",
        "connections 503-shed at the HTTP concurrency bound")
    engine.metrics.incr("tpu_serving_http_rejected", 0)
    if profile_capture:
        init_profiler(engine)
    handler = type("BoundHandler", (_Handler,),
                   {"engine": engine, "tokenizer": tokenizer,
                    "allow_adapters": allow_adapters,
                    "profile_capture": profile_capture,
                    "handoff_stream_window": handoff_stream_window,
                    "device_domain": device_domain,
                    "pull_timeout_s": pull_timeout_s,
                    "shm_gc": ShmBlobGC(clock=mono) if device_domain
                    else None,
                    "request_timeout_s": request_timeout_s,
                    "clock": staticmethod(clock), "mono": staticmethod(mono)})
    httpd = BoundedThreadingHTTPServer((host, port), handler,
                                       max_connections=max_connections,
                                       mono=mono)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, name="serve-http",
                     daemon=True).start()
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    from ..models import MODEL_CONFIGS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # deepseek-v3 (671 B) is more than one replica serves: its config
    # converts and is tested, but it is no serve target
    serveable = [n for n in MODEL_CONFIGS if n != "deepseek-v3"]
    p.add_argument("--model", default="llama3-8b", choices=serveable)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--cache-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tokenizer", default="", metavar="bytes|DIR",
                   help='"bytes" (UTF-8 byte ids, any vocab >= 257) or a '
                        "Hugging Face tokenizer directory: enables text "
                        "prompts, chat and string stops")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 quantization (halves the weight "
                        "bytes a decode step reads)")
    p.add_argument("--int4", action="store_true",
                   help="weight-only int4 quantization (group-wise scales, "
                        "two weights per byte, the int4_matmul kernel): a "
                        "quarter of bf16's weight bytes; costs more "
                        "accuracy than --int8")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV arena with per-(position, kv head) scales, "
                        "or for MLA int8 latents with per-position scales "
                        "(half the arena's bytes)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding: verify K "
                        "drafts a step in one K+1-wide pass (greedy "
                        "requests; 0 = off)")
    p.add_argument("--serving-chunk-tokens", type=int, default=None,
                   metavar="N",
                   help="prefill in N-token chunks, one decode step "
                        "between chunks while streams decode (0 = chunks "
                        "of cache_len / 2, back to back; default from "
                        "config/TPU_SERVING_CHUNK_TOKENS, 0)")
    p.add_argument("--max-prefixes", type=int, default=8,
                   help="distinct prefixes POST /prefix may pin")
    p.add_argument("--config", default="", metavar="YAML",
                   help="the provider-config YAML file (the JAX package's "
                        "and this one's ``config.Config`` fields): every "
                        "serving knob below that has no flag reads it; "
                        "its TPU_* environment variable overrides the "
                        "file, the flag overrides both")
    p.add_argument("--kv-page-tokens", type=int, default=None,
                   help="tokens per KV page, the pool's allocation and "
                        "prefix-match granule (default from config/"
                        "TPU_KV_PAGE_TOKENS, 16)")
    p.add_argument("--kv-pool-pages", type=int, default=None,
                   help="pages in the KV arena (0 = auto: twice the slots' "
                        "residency; at least slots * cache_len / page "
                        "tokens; default from config/TPU_KV_POOL_PAGES, 0)")
    p.add_argument("--max-queue-depth", type=int, default=0,
                   help="requests queued past this get 429 + Retry-After "
                        "(0 = unbounded)")
    p.add_argument("--prefix-cache", default=None, choices=["on", "off"],
                   dest="prefix_cache_enabled",
                   help="the cross-request paged prefix cache (off: no KV "
                        "arena, the contiguous decode loop, and POST /prefix "
                        "through the dense prefix store; default from "
                        "config/TPU_PREFIX_CACHE_ENABLED, on)")
    p.add_argument("--paged-decode", default=None, choices=["auto", "off"],
                   dest="kv_paged_decode",
                   help="the decode loop on page tables over the arena "
                        "(auto: whenever the layout pages; off: the "
                        "contiguous loop over one batch cache; default from "
                        "config/TPU_KV_PAGED_DECODE, auto)")
    p.add_argument("--paged-prefill", default=None, choices=["auto", "off"],
                   dest="kv_paged_prefill",
                   help="prefill chunks straight into the prompt's arena "
                        "pages (auto: with the paged loop; off: the "
                        "dense-scratch route and a page copy at admission; "
                        "default from config/TPU_KV_PAGED_PREFILL, auto)")
    p.add_argument("--ring-cache", default="auto",
                   choices=["auto", "on", "off"],
                   help="ring KV cache for windowed models on the "
                        "contiguous loop: the windowed layers keep ~window "
                        "positions while --cache-len stays the budget "
                        "(auto: when the ring is shorter than --cache-len)")
    p.add_argument("--flight-recorder", default=None, choices=["on", "off"],
                   dest="serving_flight_recorder",
                   help="the per-decode-step timeline at GET /debug/steps "
                        "(default from config/TPU_SERVING_FLIGHT_RECORDER, "
                        "on)")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="N",
                   help="serve over N tensor-parallel shards in this "
                        "process, on --device (weights and KV heads split "
                        "as the JAX engine's tensor mesh splits them); N "
                        "must divide the model's head counts")
    p.add_argument("--expert-parallel", type=int, default=1, metavar="E",
                   help="shard an MoE model's experts over E expert shards "
                        "in this process (the JAX expert x tensor mesh; "
                        "composes with --tensor-parallel): each shard runs "
                        "n_experts/E experts; E must divide n_experts")
    p.add_argument("--kv-arena-sharding", default=None,
                   choices=["auto", "replicate"],
                   help="under --tensor-parallel: shard the KV arena's heads "
                        "(auto) or keep one arena every shard reads "
                        "(default from config/TPU_KV_ARENA_SHARDING, auto)")
    p.add_argument("--max-connections", type=int, default=128,
                   help="HTTP connections in flight at once: past this a "
                        "connection gets an immediate 503 with Retry-After "
                        "(GET /metrics and /healthz keep a reserve of 2)")
    p.add_argument("--hf-checkpoint", default="", metavar="DIR",
                   help="load the weights from a Hugging Face model "
                        "directory (*.safetensors or pytorch_model*.bin) "
                        "instead of random init from --seed")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="multi-LoRA serving at this adapter rank: register "
                        "adapters with POST /adapters and pick one a "
                        'request with "adapter" (or the OpenAI "model" '
                        "field); 0 = off")
    p.add_argument("--lora-targets", default="wq,wv",
                   help="the projections the adapters cover, of "
                        "wq,wk,wv,wo,w_gate,w_up,w_down (as they were "
                        "trained)")
    p.add_argument("--max-adapters", type=int, default=8,
                   help="adapters registered at once")
    p.add_argument("--dynamic-adapters", action="store_true",
                   help="enable POST /adapters (live registration from a "
                        ".npz path the server reads); off by default, since "
                        "it lets clients open paths and replace a live "
                        "tenant's weights")
    p.add_argument("--trace-export", default="", metavar="PATH",
                   help="append finished request spans to this JSONL file; "
                        "empty = the in-memory ring only (/debug/traces)")
    p.add_argument("--profile-capture", default=None, choices=["on", "off"],
                   dest="serving_profile_capture",
                   help="enable GET /debug/profile?seconds= (a torch.profiler "
                        "capture written to the replica's disk); off by "
                        "default, since any client could otherwise slow the "
                        "card (default from config/"
                        "TPU_SERVING_PROFILE_CAPTURE)")
    p.add_argument("--profiler-port", type=int, default=None,
                   dest="serving_profiler_port",
                   help="the JAX replica's profiler server: refused here, "
                        "PyTorch has none (use --profile-capture on)")
    p.add_argument("--cost-meter", default=None, choices=["on", "off"],
                   dest="serving_cost_meter",
                   help="per-request chip-second and dollar attribution "
                        "by tenant (X-Tenant, else the OpenAI user field), "
                        "served at GET /debug/costs and carried on the "
                        "fleet heartbeat (default from config/"
                        "TPU_SERVING_COST_METER, on)")
    p.add_argument("--fleet-router", default="", metavar="URL",
                   help="fleet router URL: register this replica and "
                        "heartbeat its load stats and metrics so the router "
                        "balances traffic here; empty = standalone")
    p.add_argument("--fleet-advertise", default="", metavar="URL",
                   help="URL the router reaches this replica at (defaults "
                        "to http://<hostname>:<port>)")
    p.add_argument("--fleet-replica-id", default="",
                   help="stable replica identity (defaults to the hostname)")
    p.add_argument("--fleet-heartbeat-interval", type=float, default=2.0,
                   help="seconds between heartbeats to the fleet router")
    p.add_argument("--serving-role", default=None,
                   choices=["unified", "prefill", "decode"],
                   help="disaggregated-serving pool this replica registers "
                        "into: prefill computes KV and hands pages off, "
                        "decode adopts KV and streams tokens, unified does "
                        "both (default from config/TPU_SERVING_ROLE, "
                        "unified)")
    p.add_argument("--handoff-stream-window", type=int, default=None,
                   help="streamed handoff: max chunk frames queued between "
                        "prefill compute and the push to the decode "
                        "replica (default from config/"
                        "TPU_HANDOFF_STREAM_WINDOW, 8)")
    p.add_argument("--device-transfer", default=None, choices=["on", "off"],
                   dest="fleet_device_transfer_enabled",
                   help="device-native KV handoff: replicas of one placement "
                        "domain hand pages arena to arena (engines of one "
                        "process) or through a tmpfs blob (processes of one "
                        "host); any failure downgrades to the wire codec "
                        "(default from config/"
                        "TPU_FLEET_DEVICE_TRANSFER_ENABLED, on)")
    p.add_argument("--placement-domain", default=None,
                   dest="fleet_placement_domain",
                   help="placement domain this replica advertises; replicas "
                        "with EQUAL domains skip the wire (default from "
                        "config/TPU_FLEET_PLACEMENT_DOMAIN, else "
                        "proc:<host>:<pid> or the slice's domain, see "
                        "--placement-domain-mode)")
    p.add_argument("--placement-domain-mode", default=None,
                   dest="fleet_placement_domain_mode",
                   choices=["auto", "proc", "slice"],
                   help="how the domain is detected without an explicit one: "
                        "auto prefers TPU_SLICE_NAME (host-qualified) and "
                        "falls back to the process; slice warns without it; "
                        "proc pins one process a domain")
    p.add_argument("--pull-timeout", type=float, default=None,
                   dest="fleet_pull_timeout_s",
                   help="seconds for one KV directory-pull hop (owner "
                        "export, transfer, adoption; default from "
                        "config/TPU_FLEET_PULL_TIMEOUT_S, 10)")
    return p.parse_args(argv)


# the serving knobs with a flag: flag dest (the ``config.Config`` field)
# -> (the value an on/off or auto/off flag means True by, or None for a
# flag whose value is the setting). The JAX ``serve_main`` resolves each
# as flag > TPU_* environment > --config file > default
KNOBS = {
    "kv_page_tokens": None, "kv_pool_pages": None,
    "prefix_cache_enabled": "on", "kv_paged_decode": "auto",
    "kv_paged_prefill": "auto", "kv_arena_sharding": None,
    "serving_role": None, "serving_chunk_tokens": None,
    "handoff_stream_window": None, "fleet_device_transfer_enabled": "on",
    "fleet_placement_domain": None, "fleet_placement_domain_mode": None,
    "fleet_pull_timeout_s": None, "serving_flight_recorder": "on",
    "serving_profile_capture": "on", "serving_profiler_port": None,
    "serving_cost_meter": "on",
}


def resolve_settings(args: argparse.Namespace, env=None) -> dict:
    """Every serving knob of ``args`` resolved as the JAX replica resolves
    it: the flag, else its TPU_* environment variable, else ``--config``'s
    YAML, else the ``config.Config`` default (``config.load``, which also
    validates the file and refuses its unknown keys). Returns the
    ``KNOBS`` fields plus ``fleet_prefix_directory_enabled`` (no flag),
    with ``fleet_placement_domain`` detected ("" when device transfer is
    off). Raises ValueError for what the port does not serve, from any
    source: a profiler port (PyTorch has no profiler server, a deliberate
    difference)."""
    from ..config import load

    env = os.environ if env is None else env
    base = load(args.config or None, env=env)
    out = {"fleet_prefix_directory_enabled":
           base.fleet_prefix_directory_enabled}
    for field, true_by in KNOBS.items():
        flag = getattr(args, field)
        out[field] = (getattr(base, field) if flag is None
                      else flag if true_by is None else flag == true_by)
    if out["serving_profiler_port"]:
        raise ValueError("serving_profiler_port (--profiler-port, "
                         "TPU_SERVING_PROFILER_PORT): PyTorch has no "
                         "profiler server, a deliberate difference; use "
                         "--profile-capture on")
    out["fleet_placement_domain"] = (detect_placement_domain(
        out["fleet_placement_domain"], env=env,
        mode=out["fleet_placement_domain_mode"])
        if out["fleet_device_transfer_enabled"] else "")
    return out


def build_engine(args: argparse.Namespace, params=None,
                 settings: Optional[dict] = None):
    """(started engine, tokenizer or None) for the CLI's arguments and
    their resolved knobs (``settings``, ``resolve_settings(args)`` when
    None); the weights are ``params`` (of the model's config, on the
    device) when given, else ``--hf-checkpoint``'s, else random from
    ``--seed`` (with --int4 or --int8 drawn and quantized a layer at a
    time, so the bf16 tree never exists whole: Mixtral-8x7B's is 93 GB).
    With
    ``--tensor-parallel N`` the engine serves over an in-process tensor
    mesh of N shards (and takes a given bf16 tree over), with
    ``--expert-parallel E`` of E x N shards, an MoE model's experts split
    E ways. Raises ValueError for --int8 with --int4, and with the JAX
    CLI's checks in its order: a tensor or expert degree below 1, an
    expert degree without an MoE model whose expert count it divides, a
    tensor degree that does not divide the head counts; then an MLA or
    DeepSeek-MoE model under N > 1; all before any weight is drawn or
    loaded, as are ``--lora-rank`` with an MLA model and what the decode
    loop the flags select refuses. (The JAX CLI's last check, E x N
    devices, has no counterpart: the shards of one process share the
    card.)
    ``--paged-decode off``, ``--prefix-cache off`` or a windowed
    interleave serve from the contiguous loop, ``--speculate``,
    ``--lora-rank`` and ``--tensor-parallel`` included."""
    from ..models import MODEL_CONFIGS, init_params
    from ..models.convert import load_hf
    from ..models.quant import init_quantized_params
    from ..parallel import MeshConfig, make_mesh
    from ..parallel.sharding import check_tensor_parallel

    if args.int8 and args.int4:
        raise ValueError("--int8 and --int4 are mutually exclusive — pick "
                         "one weight precision")
    cfg = MODEL_CONFIGS[args.model]()
    if args.lora_rank > 0 and cfg.is_mla:
        raise ValueError(f"--lora-rank does not compose with MLA models "
                         f"(adapters target the wq/wk/wv layout; {cfg.name} "
                         "uses w_dkv/w_uk/w_uv)")
    n, ep = args.tensor_parallel, args.expert_parallel
    if n < 1 or ep < 1:
        raise ValueError(f"--tensor-parallel and --expert-parallel must be "
                         f">= 1 (got {n}, {ep})")
    if ep > 1 and (not cfg.n_experts or cfg.n_experts % ep):
        raise ValueError(f"--expert-parallel {ep} needs an MoE model whose "
                         f"n_experts it divides ({cfg.name} has "
                         f"n_experts={cfg.n_experts})")
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(f"--tensor-parallel {n} must divide the model's "
                         f"head counts (n_heads={cfg.n_heads}, "
                         f"n_kv_heads={cfg.n_kv_heads})")
    check_tensor_parallel(cfg, n)
    knobs = resolve_settings(args) if settings is None else settings
    # before the weights: a bad tokenizer directory fails fast
    tokenizer = get_tokenizer(args.tokenizer)
    sc = ServingConfig(
        slots=args.slots, cache_len=args.cache_len,
        max_new_tokens=args.max_new_tokens,
        max_prefill_len=args.cache_len // 2,
        eos_token=tokenizer.eos_id if tokenizer is not None else -1,
        quantize_int8=args.int8, quantize_int4=args.int4,
        quantize_kv_int8=args.kv_int8, speculate_k=args.speculate,
        serving_chunk_tokens=knobs["serving_chunk_tokens"],
        max_prefixes=args.max_prefixes,
        kv_page_tokens=knobs["kv_page_tokens"],
        kv_pool_pages=knobs["kv_pool_pages"],
        max_queue_depth=args.max_queue_depth,
        flight_recorder=knobs["serving_flight_recorder"],
        cost_meter=knobs["serving_cost_meter"],
        kv_arena_sharding=knobs["kv_arena_sharding"],
        lora_rank=args.lora_rank,
        lora_targets=tuple(t for t in args.lora_targets.split(",") if t),
        max_adapters=args.max_adapters,
        prefix_cache_enabled=knobs["prefix_cache_enabled"],
        # config True is auto (the engine decides), False pins it off
        paged_decode=None if knobs["kv_paged_decode"] else False,
        paged_prefill=None if knobs["kv_paged_prefill"] else False,
        ring_cache={"auto": None, "on": True, "off": False}[args.ring_cache])
    # the engine's checks of these settings, before any weight
    ServingEngine.lora_dims(cfg, sc)
    ServingEngine.check_loop(cfg, sc)
    mesh = (make_mesh(MeshConfig(data=1, expert=ep, tensor=n))
            if n > 1 or ep > 1 else None)
    device = resolve_device(args.device)
    if params is None and args.hf_checkpoint:
        params = load_hf(cfg, args.hf_checkpoint, device=device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = (init_quantized_params(cfg, gen, 4 if args.int4 else 8,
                                        device)
                  if args.int4 or args.int8 else
                  init_params(cfg, gen, device))
    # a quantizing engine keeps only its quantized copy of params
    return ServingEngine(
        cfg, params, sc, device=device,
        decode_fn=tokenizer.decode if tokenizer is not None else None,
        mesh=mesh, tracer=Tracer(export_path=args.trace_export)
    ).start(), tokenizer


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        knobs = resolve_settings(args)
        engine, tokenizer = build_engine(args, settings=knobs)
    except ValueError as e:
        log.error("%s", e)
        return 1
    httpd = serve(engine, args.port, tokenizer=tokenizer,
                  allow_adapters=args.dynamic_adapters,
                  profile_capture=knobs["serving_profile_capture"],
                  handoff_stream_window=knobs["handoff_stream_window"],
                  device_domain=knobs["fleet_placement_domain"],
                  pull_timeout_s=knobs["fleet_pull_timeout_s"],
                  max_connections=args.max_connections)
    snap = engine.debug_snapshot()
    log.info("serving %s on :%d (%s, weights %s, kv %s, cache %s, "
             "tensor-parallel %d, expert-parallel %d, role %s)",
             snap["model"], httpd.server_address[1], snap["device"],
             snap["weights"], snap["kv"], snap["cache_layout"],
             snap["tensor_parallel"], snap["expert_parallel"],
             knobs["serving_role"])
    advertise = advertise_url(args, httpd.server_address[1])
    domain = knobs["fleet_placement_domain"]
    if domain:
        # a prefill replica of this process resolves this engine by the
        # URL the router hands it for the wire push
        BUS.register(advertise, engine, domain)
        log.info("device transfer: %s registered in domain %s", advertise,
                 domain)
    reporter = start_reporter(engine, args, httpd.server_address[1], knobs)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    if reporter is not None:
        reporter.stop()
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    engine.tracer.close()   # flush the JSONL export queue
    return 0


def advertise_url(args: argparse.Namespace, port: int) -> str:
    """The URL the router (and a prefill replica's device push) reaches
    this replica at: --fleet-advertise, else http://<hostname>:<port>."""
    return args.fleet_advertise or f"http://{socket.gethostname()}:{port}"


def start_reporter(engine: ServingEngine, args: argparse.Namespace,
                   port: int, knobs: dict):
    """The fleet reporter of ``--fleet-router`` (None without it), started:
    registered as ``knobs["serving_role"]`` in
    ``knobs["fleet_placement_domain"]`` (``resolve_settings``) with the
    hostname as its pod name (the autoscaler's delete handle) and the
    generation and pool the pod scaler stamps into
    ``TPU_SERVING_GENERATION``/``TPU_SERVING_POOL``. With the prefix
    directory on, the engine's prefix publishes wake it, so they ride the
    next beat."""
    if not args.fleet_router:
        return None
    from ..fleet.registry import ReplicaReporter

    host = socket.gethostname()
    reporter = ReplicaReporter(
        engine, args.fleet_router,
        replica_id=args.fleet_replica_id or host,
        advertise_url=advertise_url(args, port),
        pod_name=host, interval_s=args.fleet_heartbeat_interval,
        role=knobs["serving_role"],
        placement_domain=knobs["fleet_placement_domain"],
        generation=os.environ.get("TPU_SERVING_GENERATION", ""),
        pool=os.environ.get("TPU_SERVING_POOL", "")).start()
    if knobs["fleet_prefix_directory_enabled"]:
        engine.prefix_publish_hook = reporter.wake
    log.info("fleet: reporting to %s as %s (role %s)", args.fleet_router,
             reporter.replica_id, knobs["serving_role"])
    return reporter


if __name__ == "__main__":
    raise SystemExit(main())
