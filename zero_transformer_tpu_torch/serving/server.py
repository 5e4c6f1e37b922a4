"""Streaming HTTP front end for the continuous-batching engine.

Counterpart of ``zero_transformer_tpu/serving/server.py`` (``run_server``
:893), the subset the slice needs, on the standard library's threading HTTP
server:

- ``POST /generate``: JSON body ``{"prompt": str | "tokens": [int],
  "max_new_tokens": int, "seed": int, "timeout": float, "stream": bool}``.
  With ``stream`` (default true) the response is ``text/event-stream``: one
  ``data: {"token": id, "text": piece}`` event per token (``text`` is empty
  while the detokenizer holds back an incomplete UTF-8 sequence) and a final
  ``data: {"done": true, "status": ..., "text": full}``. Without, one JSON
  document ``{"status", "tokens", "text", "request_id"}``. A full queue
  answers 429 with ``Retry-After``, an invalid request 400, a dead engine 503.
- ``GET /healthz``: 200 only when the engine is READY and its scheduler
  thread is alive, 503 otherwise (starting, stopped).
- ``GET /metrics``: the engine's JSON metrics snapshot.

One scheduler thread drives ``engine.step()``; handler threads only submit
and drain per-request event queues, so a slow client never stalls decode.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from zero_transformer_tpu_torch.serving.detok import StreamDecoder, decode_tokens
from zero_transformer_tpu_torch.serving.engine import FAILED, READY, REJECTED, ServingEngine

_LIVENESS_POLL_S = 1.0


class ServingServer:
    """Own the HTTP server and the engine's scheduler thread."""

    def __init__(self, engine: ServingEngine, tokenizer, host: str = "127.0.0.1",
                 port: int = 8000, max_body_bytes: int = 1 << 20):
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_body_bytes = max_body_bytes
        self._stop = threading.Event()
        self._scheduler = threading.Thread(
            target=engine.run, args=(self._stop,), name="serve-scheduler", daemon=True,
        )
        self._server_thread: Optional[threading.Thread] = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def _json(self, code: int, obj, headers=None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.partition("?")[0]
                if path == "/healthz":
                    self._json(*outer._healthz())
                elif path == "/metrics":
                    self._json(200, outer.engine.metrics_snapshot())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path != "/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if length < 0 or length > outer.max_body_bytes:
                    # bound BEFORE reading; the unread body would
                    # desynchronise the connection, so close it
                    self.close_connection = True
                    self._json(413 if length > 0 else 400,
                               {"error": f"body must be 0..{outer.max_body_bytes} bytes"})
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._json(400, {"error": "malformed JSON body"})
                    return
                if not isinstance(req, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                outer._generate(self, req)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, start_scheduler: bool = True) -> None:
        """Serve HTTP in a background thread. ``start_scheduler=False`` keeps
        the engine STARTING (``/healthz`` answers 503) until
        ``start_scheduler()``."""
        if start_scheduler:
            self.start_scheduler()
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True,
        )
        self._server_thread.start()

    def start_scheduler(self) -> None:
        if not self._scheduler.ident:
            self._scheduler.start()

    def serve_forever(self) -> None:
        self.start_scheduler()
        try:
            self._httpd.serve_forever()
        finally:
            self.stop()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the scheduler (outstanding requests finish as failed) and
        the HTTP server, and wait for both threads."""
        self._stop.set()
        if self._server_thread is not None:
            self._httpd.shutdown()
            self._server_thread.join(timeout)
        self._httpd.server_close()
        if self._scheduler.ident:
            self._scheduler.join(timeout)

    def _healthz(self):
        state = self.engine.state
        alive = self._scheduler.is_alive()
        ok = state == READY and alive
        return (200 if ok else 503), {
            "state": state if alive or not self._scheduler.ident else "scheduler dead",
            "queue_depth": self.engine.queue_depth,
            "slot_occupancy": self.engine.active_count,
        }

    def _submit(self, req: dict):
        if "tokens" in req:
            ids = [int(t) for t in req["tokens"]]
        else:
            ids = self.tokenizer.encode(str(req.get("prompt", "")).strip())
        return self.engine.submit(
            ids,
            max_new_tokens=int(req.get("max_new_tokens", 32)),
            seed=int(req.get("seed", 0)),
            timeout=float(req["timeout"]) if "timeout" in req else None,
        )

    def _generate(self, handler, req: dict) -> None:
        try:
            handle = self._submit(req)
        except (TypeError, ValueError) as exc:
            handler._json(400, {"error": f"bad request field: {exc}"})
            return
        rid_hdr = {"X-Request-Id": handle.rid}
        if handle.status == REJECTED:
            if handle.retryable:
                handler._json(429, {"error": handle.error, "status": handle.status,
                                    "request_id": handle.rid},
                              headers={"Retry-After": "1", **rid_hdr})
            else:
                handler._json(400, {"error": handle.error, "status": handle.status,
                                    "request_id": handle.rid}, headers=rid_hdr)
            return
        if handle.status == FAILED:
            handler._json(503, {"error": handle.error, "status": handle.status,
                                "request_id": handle.rid}, headers=rid_hdr)
            return
        if not req.get("stream", True):
            tokens = handle.result()
            if handle.status == FAILED:
                handler._json(503, {"error": handle.error, "status": handle.status,
                                    "request_id": handle.rid}, headers=rid_hdr)
                return
            handler._json(200, {
                "status": handle.status, "tokens": tokens, "text": self._full_text(tokens),
                "request_id": handle.rid,
            }, headers=rid_hdr)
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("X-Request-Id", handle.rid)
        handler.end_headers()
        self._stream_events(handler, handle)

    def _stream_events(self, handler, handle) -> None:
        decoder = StreamDecoder(self.tokenizer)
        pieces: List[str] = []
        eos = self.engine.eos_token_id
        try:
            while True:
                event = handle.next_event(timeout=_LIVENESS_POLL_S)
                if event is None:
                    continue
                kind, token = event
                if kind != "token":
                    break
                if eos is not None and token == eos:
                    continue
                piece = decoder.push(token)
                if piece is not None:
                    pieces.append(piece)
                self._event(handler, {"token": token, "text": piece or ""})
            tail = decoder.flush()
            if tail is not None:
                pieces.append(tail)
                self._event(handler, {"text": tail})
            self._event(handler, {
                "done": True, "status": handle.status, "text": "".join(pieces),
                "error": handle.error, "retryable": handle.retryable,
                "request_id": handle.rid,
            })
        except (BrokenPipeError, ConnectionResetError):
            # the client went away: free the slot instead of decoding into the void
            handle.cancel()

    @staticmethod
    def _event(handler, obj) -> None:
        handler.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        handler.wfile.flush()

    def _full_text(self, tokens) -> str:
        eos = self.engine.eos_token_id
        return decode_tokens(self.tokenizer, [t for t in tokens if t != eos])


def run_server(engine: ServingEngine, tokenizer, host: str = "127.0.0.1", port: int = 8000,
               background: bool = False) -> Optional[ServingServer]:
    """Start the serving front end. ``background=True`` returns the running
    server; otherwise block until interrupted."""
    server = ServingServer(engine, tokenizer, host=host, port=port)
    if background:
        server.start()
        return server
    print(
        f"serving on http://{host}:{server.port} ({engine.n_slots} slots, cache_len "
        f"{engine.cache_len}, {engine.device}) - POST /generate, GET /healthz, GET /metrics",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return None
