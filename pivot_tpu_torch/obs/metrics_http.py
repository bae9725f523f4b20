"""Stdlib HTTP scrape endpoint for the unified metrics registry.

``serve --metrics-port N`` (round 15 satellite): a Prometheus scraper
pointed at ``http://127.0.0.1:N/metrics`` sees the live service's text
exposition mid-soak, instead of waiting for the post-run
``--metrics-out`` file.  Pure stdlib (``http.server``) — the serve
layer must not grow a web-framework dependency for one GET route.

Thread safety: the handler calls the injected ``render`` callable on
the HTTP server's worker thread while the serve driver's session /
producer / autoscaler threads are live.  The contract is that
``render`` returns a *snapshot* string assembled under the owners'
locks (``ServeDriver.publish_metrics`` snapshots the pool under its
cv; ``MetricsRegistry.to_prometheus`` runs under the registry lock) —
the scrape-during-soak test in ``tests/test_profiler.py`` hammers the
endpoint mid-run to pin this.

A render failure answers 500 with the error text instead of killing
the worker thread: a scrape must never be able to take the service
down.

JAX-free copy of ``pivot_tpu/obs/metrics_http.py``, import paths rewritten.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

__all__ = ["MetricsHTTPServer"]


class MetricsHTTPServer:
    """Background ``/metrics`` (Prometheus text, version 0.0.4) and
    ``/metrics.json`` (unified JSON snapshot) endpoint.

    ``port=0`` binds an ephemeral port (tests); read :attr:`port` after
    :meth:`start`.  ``render`` returns the exposition text;
    ``render_json`` (optional) the JSON document — omitted, the JSON
    route answers 404.
    """

    def __init__(
        self,
        render: Callable[[], str],
        render_json: Optional[Callable[[], dict]] = None,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self._render = render
        self._render_json = render_json
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> int:
        render, render_json = self._render, self._render_json

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args):  # quiet: no per-scrape stderr
                pass

            def _answer(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?")[0]
                try:
                    if path in ("/metrics", "/"):
                        body = render().encode()
                        self._answer(
                            200, body,
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/metrics.json" and render_json:
                        body = json.dumps(render_json()).encode()
                        self._answer(200, body, "application/json")
                    else:
                        self._answer(404, b"not found\n", "text/plain")
                except Exception as exc:  # noqa: BLE001 — scrape-safe
                    self._answer(
                        500, f"render failed: {exc}\n".encode(),
                        "text/plain",
                    )

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="metrics-http", daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
