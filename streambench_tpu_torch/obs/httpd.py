"""Opt-in localhost Prometheus scrape endpoint (stdlib only).

``GET /metrics`` renders the registry in text exposition format 0.0.4;
``GET /healthz`` answers 200 while the process lives.  Bound to
127.0.0.1 on the configured ``jax.metrics.port`` (0 = OS-assigned
ephemeral port, reported via ``.port`` and the engine's startup line).
A ``ThreadingHTTPServer`` on a daemon thread: scrapes never touch the
host loop, and an abandoned endpoint cannot keep the process alive.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serves one registry.  ``refresh`` (optional) runs before every
    scrape — wire the sampler's ``collect_now`` there so scrape values
    are current, not last-tick."""

    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1",
                 refresh=None):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # scrapes are not news
                pass

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    body = b"ok\n"
                    ctype = "text/plain"
                elif path in ("/", "/metrics"):
                    if server.refresh is not None:
                        try:
                            server.refresh()
                        except Exception:
                            pass  # stale values beat a failed scrape
                    body = server.registry.render_prometheus().encode()
                    ctype = PROM_CONTENT_TYPE
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.registry = registry
        self.refresh = refresh
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="metrics-httpd")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
