"""Proxy health checking — the `pkg/proxy/healthcheck/healthcheck.go` seat.

Two servers, as in the reference:

  * `ProxierHealthServer` — the proxier's own /healthz: 200 while the
    last successful syncProxyRules pass is younger than the timeout,
    503 once the proxier is stale (healthcheck.go healthzServer).
  * `ServiceHealthServer` — per-service healthCheckNodePort listeners for
    `externalTrafficPolicy: Local` services: 200 + the local endpoint
    count when this node has local endpoints for the service, 503 when
    it has none — that is how external load balancers learn which nodes
    can serve a Local service (healthcheck.go hcInstance).

Responses carry the reference's JSON shape
(`{"service": {"namespace": ..., "name": ...}, "localEndpoints": N}`).

(A copy of the JAX package's proxy/healthcheck.py.)
"""

from __future__ import annotations

import json
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional, Tuple


class _ThreadingHTTPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ProxierHealthServer:
    """healthz for the proxier itself: stale sync → 503."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 healthy_timeout: float = 60.0, clock=time.monotonic):
        self.clock = clock
        self.healthy_timeout = healthy_timeout
        self._last_updated = 0.0
        self._queued_update = 0.0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                healthy, last = outer.is_healthy()
                body = json.dumps({
                    "lastUpdated": last,
                    "currentTime": outer.clock()}).encode()
                self.send_response(200 if healthy else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = _ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="proxier-healthz")

    def start(self) -> "ProxierHealthServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def queued_update(self) -> None:
        """A sync is PENDING: the proxier saw changes it has not yet
        programmed (healthcheck.go QueuedUpdate). Only the OLDEST pending
        time is kept — re-stamping on every event would let steady churn
        mask a wedged sync loop forever."""
        if self._queued_update == 0.0:
            self._queued_update = self.clock()

    def updated(self) -> None:
        """syncProxyRules completed (healthcheck.go Updated)."""
        self._last_updated = self.clock()
        self._queued_update = 0.0

    def is_healthy(self) -> Tuple[bool, float]:
        """Healthy while no pending update is older than the timeout —
        a proxier that keeps syncing promptly stays 200 even under
        constant churn."""
        now = self.clock()
        pending_stale = (self._queued_update > 0.0
                         and now - self._queued_update
                         > self.healthy_timeout)
        never_synced = self._last_updated == 0.0
        return (not pending_stale and not never_synced), self._last_updated


class ServiceHealthServer:
    """Per-service healthCheckNodePort listeners.

    `sync(services)` takes {(ns, name): (port, local_endpoint_count)} and
    reconciles listeners: new ports open, dropped ports close, counts
    update in place (healthcheck.go SyncServices + SyncEndpoints)."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self._mu = threading.Lock()
        # (ns, name) → (port, server, thread)
        self._listeners: Dict[Tuple[str, str], tuple] = {}
        self._counts: Dict[Tuple[str, str], int] = {}

    def sync(self, services: Dict[Tuple[str, str], Tuple[int, int]]) -> None:
        with self._mu:
            for key in [k for k in self._listeners if k not in services]:
                _, httpd, _ = self._listeners.pop(key)
                self._counts.pop(key, None)
                httpd.shutdown()
                httpd.server_close()
            for key, (port, count) in services.items():
                self._counts[key] = count
                cur = self._listeners.get(key)
                if cur is not None and cur[0] == port:
                    continue
                if cur is not None:  # port moved: reopen
                    cur[1].shutdown()
                    cur[1].server_close()
                    self._listeners.pop(key, None)
                try:
                    self._listeners[key] = self._open(key, port)
                except OSError:
                    # the reference logs a per-service listen failure
                    # (port in use) and keeps serving the others; a
                    # failed bind must never abort the caller's sync pass
                    pass

    def _open(self, key: Tuple[str, str], port: int) -> tuple:
        outer = self
        ns, name = key

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_GET(self):
                with outer._mu:
                    count = outer._counts.get(key, 0)
                body = json.dumps({
                    "service": {"namespace": ns, "name": name},
                    "localEndpoints": count}).encode()
                self.send_response(200 if count > 0 else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("X-Content-Type-Options", "nosniff")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = _ThreadingHTTPServer((self.host, port), Handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True,
                             name=f"svc-healthcheck-{ns}-{name}")
        t.start()
        return (httpd.server_address[1], httpd, t)

    def port_of(self, ns: str, name: str) -> Optional[int]:
        with self._mu:
            cur = self._listeners.get((ns, name))
            return cur[0] if cur else None

    def stop(self) -> None:
        with self._mu:
            for _, httpd, _ in self._listeners.values():
                httpd.shutdown()
                httpd.server_close()
            self._listeners.clear()
            self._counts.clear()
