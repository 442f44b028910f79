"""The scrape endpoint: a daemon-thread HTTP server (the port's copy of
the JAX package's).

Serves the registry + span recorder over loopback HTTP so the
resident sweepd process is observable at runtime, not just post-hoc
in bench artifacts:

    GET /metrics        Prometheus text exposition
    GET /metrics.json   JSON lines, one metric family per line
    GET /trace.json     Chrome trace-event JSON (load in Perfetto)
    GET /healthz        204 liveness

``port=0`` binds an ephemeral port (``server.port`` is the bound
one).  stdlib only (http.server / ThreadingHTTPServer) — no new
dependencies; request logging is silenced (scrapes at 1/s would spam
the serving log).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["ScrapeServer"]


class ScrapeServer:
    def __init__(self, metrics, spans=None, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.metrics = metrics
        self.spans = spans
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, body=b"", ctype="text/plain"):
                self.send_response(code)
                self.send_header("Content-Type",
                                 f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, outer.metrics.render_prometheus()
                               .encode())
                elif path == "/metrics.json":
                    self._send(200, outer.metrics.render_json_lines()
                               .encode(), "application/json")
                elif path == "/trace.json":
                    if outer.spans is None:
                        self._send(404, b"no span recorder attached\n")
                    else:
                        self._send(
                            200,
                            json.dumps(outer.spans.chrome_trace())
                            .encode(), "application/json")
                elif path == "/healthz":
                    self._send(204)
                else:
                    self._send(
                        404, b"paths: /metrics /metrics.json "
                             b"/trace.json /healthz\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "ScrapeServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval":
                                                      0.2},
            name="obs-scrape", daemon=True)
        self._thread.start()
        return self

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
