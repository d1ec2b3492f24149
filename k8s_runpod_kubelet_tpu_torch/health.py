"""Health, metrics and debug server (the port's own copy of the JAX
package's ``health.py``), for a process that has no serving engine: the
trainer's telemetry port (``train_main --telemetry-port``). Stdlib only,
on the port's ``metrics.Metrics`` and ``tracing.Tracer``; the routes,
status codes and bodies are the JAX server's:

  /healthz       liveness flag (200 "ok" / 503 "unhealthy")
  /readyz        the flag AND the injected ready callable
  /metrics       Prometheus text (counters/gauges/histograms)
  /debug/traces  recent finished spans as JSON; ?trace_id= filters to one
                 trace
  /debug/engine  statusz-style snapshot from the injected callable (404
                 when the process has no engine, as a trainer has none)
  /debug/train   training-telemetry statusz from the injected callable: the
                 goodput ledger buckets, step/MFU stats, per-host watchdog
                 table on a training worker-0
  /heartbeat     POST (training worker-0 only): peers' step-heartbeat
                 protocol lines, fed to the straggler watchdog
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import Metrics
from .tracing import Tracer

log = logging.getLogger(__name__)


class _Handler(BaseHTTPRequestHandler):
    server_ref: "HealthServer"

    def log_message(self, *a):
        pass

    def _send(self, status: int, body: bytes, ctype: str = "text/plain"):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json")

    def do_GET(self):
        hs = self.server_ref
        path = urllib.parse.urlparse(self.path)
        if path.path == "/healthz":
            if hs.healthy.is_set():
                return self._send(200, b"ok")
            return self._send(503, b"unhealthy")
        if path.path == "/readyz":
            ready = hs.healthy.is_set()
            if ready and hs.ready_func is not None:
                try:
                    ready = bool(hs.ready_func())
                except Exception as e:  # noqa: BLE001
                    log.warning("readyz probe errored: %s", e)
                    ready = False
            return self._send(200 if ready else 503,
                              b"ready" if ready else b"not ready")
        if path.path == "/metrics" and hs.metrics is not None:
            return self._send(200, hs.metrics.render().encode(),
                              "text/plain; version=0.0.4")
        if path.path == "/debug/traces" and hs.tracer is not None:
            q = urllib.parse.parse_qs(path.query)
            return self._send_json(200, hs.tracer.query(
                (q.get("trace_id") or [""])[0]))
        if path.path == "/debug/engine" and hs.engine_status is not None:
            try:
                return self._send_json(200, hs.engine_status())
            except Exception as e:  # noqa: BLE001 — debug must not 500-loop
                return self._send_json(500, {"error": str(e)})
        if path.path == "/debug/train" and hs.train_status is not None:
            try:
                return self._send_json(200, hs.train_status())
            except Exception as e:  # noqa: BLE001 — debug must not 500-loop
                return self._send_json(500, {"error": str(e)})
        self._send(404, b"not found")

    def do_POST(self):
        hs = self.server_ref
        path = urllib.parse.urlparse(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if path.path == "/heartbeat" and hs.heartbeat_sink is not None:
            try:
                hs.heartbeat_sink(body.decode("utf-8", errors="replace"))
            except Exception as e:  # noqa: BLE001 — a bad beat must not 500-loop
                log.debug("heartbeat ingest failed: %s", e)
                return self._send_json(400, {"error": str(e)})
            return self._send_json(200, {"ok": True})
        self._send(404, b"not found")


class HealthServer:
    def __init__(self, address: str = ":8080",
                 ready_func: Optional[Callable[[], bool]] = None,
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 engine_status: Optional[Callable[[], dict]] = None,
                 train_status: Optional[Callable[[], dict]] = None,
                 heartbeat_sink: Optional[Callable[[str], None]] = None):
        host, _, port = address.rpartition(":")
        self.ready_func = ready_func
        self.metrics = metrics
        self.tracer = tracer
        self.engine_status = engine_status
        self.train_status = train_status
        self.heartbeat_sink = heartbeat_sink
        self.healthy = threading.Event()
        self.healthy.set()
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="health-server", daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HealthServer":
        self._thread.start()
        log.info("health server on :%d (/healthz /readyz /metrics "
                 "/debug/traces /debug/engine /debug/train)", self.port)
        return self

    @property
    def started(self) -> bool:
        return self._thread.is_alive()

    def set_healthy(self, healthy: bool):
        if healthy:
            self.healthy.set()
        else:
            self.healthy.clear()

    def stop(self):
        # shutdown() deadlocks if serve_forever never ran — only call it on a
        # live server thread
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
