"""Live observability endpoints over stdlib ``http.server``.

A copy of the JAX package's ``serve/http.py`` (no device code).

A production engine is scraped, not imported: Prometheus pulls
``/metrics``, an orchestrator probes ``/healthz`` for liveness/readiness,
and an operator curls ``/stats`` for the full JSON picture.  ``ObsHTTP``
serves all three from a daemon thread wrapping a live
:class:`~repro_torch.serve.server.InferenceServer` — no framework, no new
dependency, no impact on the decode path (every request is a read-only
snapshot the server already computes under its own locks).

Endpoint contract:

- ``GET /metrics``  → 200, ``text/plain; version=0.0.4``; strict
  Prometheus exposition (round-trips through
  :func:`~repro_torch.serve.telemetry.parse_exposition`).  Includes the live
  co-execution efficiency/balance gauges.
- ``GET /healthz``  → 200 when the batcher thread is alive, the server is
  accepting, and at least one member group is not draining; 503
  otherwise.  Body is JSON either way (status, per-group readiness,
  admission pressure, paged-pool blocks).
- ``GET /stats``    → 200, JSON of ``server.stats()`` (scheduler decision
  journal included under ``"decisions"``).

Anything else is 404; handler exceptions surface as 500 instead of
killing the serving thread.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.core.obs import jsonable


class ObsHTTP:
    """Serve ``/metrics``, ``/healthz``, ``/stats`` for a live server.

    Binds immediately (``port=0`` picks an ephemeral port — read
    ``.port``); the accept loop runs on a daemon thread so an abandoned
    instance never blocks interpreter exit.  ``close()`` is idempotent.
    """

    def __init__(self, server, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.server = server
        obs_http = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = obs_http.server.prometheus().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                        code = 200
                    elif path == "/healthz":
                        code, doc = obs_http.server.health()
                        body = json.dumps(jsonable(doc), indent=1).encode()
                        ctype = "application/json"
                    elif path == "/stats":
                        body = json.dumps(jsonable(obs_http.server.stats()),
                                          indent=1).encode()
                        ctype = "application/json"
                        code = 200
                    else:
                        body = b'{"error": "not found"}'
                        ctype = "application/json"
                        code = 404
                except Exception as exc:  # diagnostics must not die mid-reply
                    body = json.dumps({"error": repr(exc)}).encode()
                    ctype = "application/json"
                    code = 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:  # keep stderr clean
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True)
        self._thread.start()
        self._closed = False

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
