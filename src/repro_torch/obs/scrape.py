"""Live Prometheus scrape endpoint (DESIGN.md §13).

``metrics.prom`` is written at exit; long runs want to be scraped *while*
training.  ``ScrapeServer`` is a stdlib ``ThreadingHTTPServer`` on a daemon
thread serving ``GET /metrics`` straight from the process-default registry's
``prometheus_text()`` — no new dependencies, no background work between
requests, and ``stop()`` shuts the listener down and joins the thread so
launchers exit cleanly.

The registry is resolved *per request*, not at construction: a launcher may
start the server before ``enable_telemetry`` swaps instruments live, and the
scrape must always reflect the current default registry.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ScrapeServer:
    """Serve ``registry.prometheus_text()`` over HTTP until ``stop()``.

    ``port=0`` binds an ephemeral port (tests); read the bound port back
    from ``.port`` after ``start()``.
    """

    def __init__(self, registry=None, host: str = "127.0.0.1", port: int = 0):
        self._registry = registry
        self._host = host
        self._requested_port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def _text(self) -> str:
        registry = self._registry
        if registry is None:
            from repro_torch.obs.metrics import default_registry

            registry = default_registry()
        return registry.prometheus_text()

    def start(self) -> "ScrapeServer":
        if self._server is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                if self.path.split("?")[0].rstrip("/") in ("", "/metrics"):
                    body = outer._text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):  # silence per-request stderr noise
                pass

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="obs-scrape",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        assert self._server is not None, "start() first"
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}/metrics"

    def stop(self, timeout: float = 5.0) -> None:
        """Shut the listener down and join the serving thread. Idempotent."""
        server, thread = self._server, self._thread
        self._server = None
        self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout)


def start_scrape_server(port: int, registry=None, host: str = "127.0.0.1") -> ScrapeServer:
    """Launcher-facing one-liner: bind, start, return the running server."""
    return ScrapeServer(registry=registry, host=host, port=port).start()
