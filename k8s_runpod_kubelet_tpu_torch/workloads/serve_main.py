"""HTTP front over the port's ServingEngine (the ``/generate`` half of the
JAX package's ``workloads/serve_main.py``).

Endpoints:
  POST /generate      {"tokens": [...]} or {"text": "..."} (with
                      ``--tokenizer bytes``), plus optional
                      "max_new_tokens", "temperature", "top_k", "top_p",
                      "presence_penalty", "frequency_penalty",
                      "logit_bias", "seed"
                      -> {"rid": ..., "tokens": [...], "latency_s": ...}
                      (+ "text" with a tokenizer). Fields this port does
                      not serve yet ("stream", "stop", "logprobs",
                      "adapter") answer 400 instead of being ignored.
  GET  /healthz       liveness: 200 while the engine thread lives (body
                      "draining" while draining), 503 once it died
  GET  /readyz        routability: 503 while draining or dead
  POST /drain         stop admitting, finish in-flight work
  GET  /debug/engine  the engine's debug snapshot

Run: python -m k8s_runpod_kubelet_tpu_torch.workloads.serve_main \
        --model llama3-8b --slots 8 --cache-len 2048 --port 8000 \
        [--int4 | --int8] [--kv-int8]
(``--model mla-8b`` serves Multi-head Latent Attention from a latent
arena; ``--kv-int8`` then makes the latents int8.)
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..device import resolve_device
from .serving import (EngineDraining, EngineOverloaded, ServingConfig,
                      ServingEngine)
from .tokenizer import ByteTokenizer

log = logging.getLogger("serve-main")

# request fields the JAX front accepts that this port does not serve yet
_UNSUPPORTED = ("stream", "stop", "logprobs", "adapter")


def _or(value, default):
    """JSON null falls back to the default, like an absent key."""
    return default if value is None else value


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine = None  # bound by serve()
    tokenizer = None              # None = token-ids-only API
    request_timeout_s = 120.0
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

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(length)) if length else {}

    def do_GET(self):
        eng = self.engine
        if self.path in ("/healthz", "/readyz"):
            if not eng.alive:
                return self._send(503, b"engine thread dead", "text/plain")
            if eng.draining:
                status = 200 if self.path == "/healthz" else 503
                return self._send(status, b"draining", "text/plain")
            return self._send(200, b"ok" if self.path == "/healthz"
                              else b"ready", "text/plain")
        if self.path == "/debug/engine":
            return self._send(200, eng.debug_snapshot())
        self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path == "/drain":
            self._read_json()  # unread bytes would poison keep-alive
            self.engine.drain()
            return self._send(200, {"draining": True,
                                    "queue_depth": self.engine.queue_depth,
                                    "active_slots": self.engine.active_slots})
        if self.path != "/generate":
            return self._send(404, {"error": f"no route {self.path}"})
        try:
            req = self._read_json()
            tokens = self._request_tokens(req)
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            return self._send(400, {"error": f"bad request: {e}"})
        fut = self.engine.submit(
            tokens, req.get("max_new_tokens"), req.get("temperature"),
            top_k=_or(req.get("top_k"), 0), top_p=_or(req.get("top_p"), 1.0),
            presence_penalty=_or(req.get("presence_penalty"), 0.0),
            frequency_penalty=_or(req.get("frequency_penalty"), 0.0),
            logit_bias=req.get("logit_bias"), seed=req.get("seed"))
        try:
            out = fut.result(timeout=self.request_timeout_s)
        except FutureTimeout:
            fut.cancel()  # the engine frees the slot at its next step
            return self._send(504, {"error": "generation timed out"})
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        except (EngineOverloaded, EngineDraining) as e:
            return self._send(503 if isinstance(e, EngineDraining) else 429,
                              {"error": str(e)},
                              extra_headers={"Retry-After": "1"})
        except Exception as e:  # noqa: BLE001 — engine failure: JSON 500
            return self._send(500, {"error": str(e)})
        body = {"rid": out["rid"], "tokens": out["tokens"],
                "latency_s": out["latency_s"]}
        if self.tokenizer is not None:
            body["text"] = self.tokenizer.decode(out["tokens"])
        self._send(200, body)

    def _request_tokens(self, body) -> list:
        if not isinstance(body, dict):
            raise ValueError("request must be an object")
        bad = [f for f in _UNSUPPORTED if body.get(f)]
        if bad:
            raise ValueError(f"fields {bad} are not served by this port")
        if "text" in body and "tokens" not in body:
            if self.tokenizer is None:
                raise ValueError('server has no tokenizer (start with '
                                 '--tokenizer bytes) — send "tokens"')
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


def serve(engine: ServingEngine, port: int = 8000, tokenizer=None,
          request_timeout_s: float = 120.0,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the HTTP front on a daemon thread; ``port`` 0 picks a free
    port (read ``httpd.server_address[1]``). Stop with
    ``httpd.shutdown(); httpd.server_close()``."""
    handler = type("BoundHandler", (_Handler,),
                   {"engine": engine, "tokenizer": tokenizer,
                    "request_timeout_s": request_timeout_s})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, name="serve-http",
                     daemon=True).start()
    return httpd


def parse_args(argv=None) -> argparse.Namespace:
    from ..models import MODEL_CONFIGS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="llama3-8b", choices=list(MODEL_CONFIGS))
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--cache-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tokenizer", default="", choices=["", "bytes"],
                   help='"bytes": UTF-8 byte ids, enables {"text": ...}')
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
    return p.parse_args(argv)


def build_engine(args: argparse.Namespace, params=None):
    """(started engine, tokenizer or None) for the CLI's arguments; random
    weights from ``--seed`` unless ``params`` (of the model's config, on
    the device) are given. Raises ValueError for --int8 with --int4."""
    from ..models import MODEL_CONFIGS, init_params

    if args.int8 and args.int4:
        raise ValueError("--int8 and --int4 are mutually exclusive — pick "
                         "one weight precision")
    tokenizer = ByteTokenizer() if args.tokenizer == "bytes" else None
    sc = ServingConfig(
        slots=args.slots, cache_len=args.cache_len,
        max_new_tokens=args.max_new_tokens,
        max_prefill_len=args.cache_len // 2,
        eos_token=tokenizer.eos_id if tokenizer is not None else -1,
        quantize_int8=args.int8, quantize_int4=args.int4,
        quantize_kv_int8=args.kv_int8)
    device = resolve_device(args.device)
    cfg = MODEL_CONFIGS[args.model]()
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
    # a quantizing engine keeps only its quantized copy of params
    return ServingEngine(cfg, params, sc, device=device).start(), tokenizer


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        engine, tokenizer = build_engine(args)
    except ValueError as e:
        log.error("%s", e)
        return 1
    httpd = serve(engine, args.port, tokenizer=tokenizer)
    snap = engine.debug_snapshot()
    log.info("serving %s on :%d (%s, weights %s, kv %s)", snap["model"],
             httpd.server_address[1], snap["device"], snap["weights"],
             snap["kv"])
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
