"""A Prometheus ``/metrics`` endpoint for a process without an HTTP server.

Counterpart of ``zero_transformer_tpu/obs/exporter.py`` (a copy: that
module imports no JAX). The trainer has no HTTP surface of its own; this
daemon-threaded stdlib server renders its ``Registry`` at ``GET /metrics``
in the ``text/plain; version=0.0.4`` format. The gauges are read from
callbacks at scrape time, so the step loop pays nothing.

Usage (``train --metrics-port``)::

    exporter = MetricsExporter(trainer.registry, port=9100)
    ...
    exporter.close()
"""
from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from zero_transformer_tpu_torch.obs.metrics import Registry

log = logging.getLogger("zero_transformer_tpu_torch")


class MetricsExporter:
    """Serve ``registry.render()`` at GET /metrics on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port``. Render errors return 500 rather than killing the
    serving thread — a broken gauge callback must not take the scrape
    endpoint (or the training loop) down with it."""

    def __init__(self, registry: Registry, port: int = 9100,
                 host: str = "0.0.0.0"):
        self.registry = registry

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = exporter.registry.render().encode()
                except Exception:  # noqa: BLE001 — see class docstring
                    log.exception("metrics exporter: render failed")
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", Registry.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not run events
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        log.info("metrics exporter: /metrics on %s:%d", host, self.port)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
