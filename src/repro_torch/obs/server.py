"""Tiny stdlib HTTP endpoint for scrapes and flight dumps.

The counterpart of the JAX package's ``obs/server.py``.
``MetricsServer`` serves whatever callables it was handed — it holds no
engine reference and no lock discipline of its own, because every
handler calls back into host-side snapshot methods (``scrape()`` builds
from a deep-copied ``stats()``; flight dumps serialize to plain dicts).
Routes:

* ``GET /metrics``       — Prometheus text exposition
* ``GET /metrics.json``  — the same registry as JSON
* ``GET /flights``       — completed flight ring (JSON list)
* ``GET /flights/<rid>`` — one flight's span tree (404 if evicted)
* ``GET /trace``         — Chrome trace-event JSON of the recording

Binds 127.0.0.1 only (this is a debug/scrape port, not a frontend);
``port=0`` picks a free port (exposed as ``.port``), which is what the
tests and the serve CLI's round trip use.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class MetricsServer:
    def __init__(self, port: int,
                 scrape_text: Callable[[], str],
                 scrape_json: Optional[Callable[[], dict]] = None,
                 flights: Optional[Callable[[], list]] = None,
                 flight: Optional[Callable[[int], Optional[dict]]] = None,
                 trace: Optional[Callable[[], list]] = None):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # no stderr chatter per scrape
                pass

            def _send(self, code, body, ctype):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        self._send(200, scrape_text(),
                                   "text/plain; version=0.0.4")
                    elif path == "/metrics.json" and scrape_json:
                        self._send(200, json.dumps(scrape_json()),
                                   "application/json")
                    elif path == "/flights" and flights:
                        self._send(200, json.dumps(flights()),
                                   "application/json")
                    elif path.startswith("/flights/") and flight:
                        try:
                            rid = int(path.rsplit("/", 1)[1])
                        except ValueError:
                            self._send(400, "bad rid\n", "text/plain")
                            return
                        f = flight(rid)
                        if f is None:
                            self._send(404, "unknown rid\n", "text/plain")
                        else:
                            self._send(200, json.dumps(f),
                                       "application/json")
                    elif path == "/trace" and trace:
                        self._send(200, json.dumps(
                            {"traceEvents": trace(),
                             "displayTimeUnit": "ms"}),
                            "application/json")
                    else:
                        self._send(404, "unknown route\n", "text/plain")
                except Exception as e:          # scrape must never kill serve
                    self._send(500, f"scrape error: {e}\n", "text/plain")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
