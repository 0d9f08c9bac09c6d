"""HTTP server exposing the device backend at the scheduler-extender boundary
(a copy of the JAX package's extender/server.py).

The stock kube-scheduler's HTTPExtender POSTs JSON to
``{URLPrefix}/{FilterVerb|PrioritizeVerb|PreemptVerb|BindVerb}``
(core/extender.go:424-450 send(): POST, Content-Type application/json, decode
into the result struct). This server speaks exactly that: point a stock
binary's policy at us with::

    {"extenders": [{"urlPrefix": "http://host:port/scheduler",
                    "filterVerb": "filter", "prioritizeVerb": "prioritize",
                    "preemptVerb": "preemption", "bindVerb": "bind",
                    "weight": 1, "nodeCacheCapable": true}]}

and every Filter/Prioritize call is answered from the device lattice.
A /healthz endpoint mirrors the reference's healthz mux (server.go:216-227).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .backend import ExtenderBackend
from .wire import (
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderPreemptionArgs,
)

DEFAULT_VERBS = {
    "filter": "filter",
    "prioritize": "prioritize",
    "preemption": "preemption",
    "bind": "bind",
}


class ExtenderServer:
    """Threaded HTTP server over an ExtenderBackend (test: httptest.NewServer
    analog — extender_test.go:290-312 spins real HTTP servers the same way)."""

    def __init__(
        self,
        backend: ExtenderBackend,
        host: str = "127.0.0.1",
        port: int = 0,
        url_prefix: str = "/scheduler",
        verbs: Optional[dict] = None,
    ) -> None:
        self.backend = backend
        self.url_prefix = url_prefix.rstrip("/")
        self.verbs = dict(DEFAULT_VERBS, **(verbs or {}))
        self.requests_served = 0

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"ok")
                else:
                    self._reply(404, {"Error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._reply(400, {"Error": f"bad json: {e}"})
                    return
                verb = self.path[len(server.url_prefix):].strip("/")
                server.requests_served += 1
                try:
                    if verb == server.verbs["filter"]:
                        res = server.backend.filter(ExtenderArgs.from_json(payload))
                        self._reply(200, res.to_json())
                    elif verb == server.verbs["prioritize"]:
                        prios = server.backend.prioritize(ExtenderArgs.from_json(payload))
                        self._reply(200, [p.to_json() for p in prios])
                    elif verb == server.verbs["preemption"]:
                        res = server.backend.process_preemption(
                            ExtenderPreemptionArgs.from_json(payload))
                        self._reply(200, res.to_json())
                    elif verb == server.verbs["bind"]:
                        res = server.backend.bind(ExtenderBindingArgs.from_json(payload))
                        self._reply(200, res.to_json())
                    else:
                        self._reply(404, {"Error": f"unknown verb {verb!r}"})
                except Exception as e:  # noqa: BLE001 — wire boundary
                    self._reply(500, {"Error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}{self.url_prefix}"

    def start(self) -> "ExtenderServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ExtenderServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
