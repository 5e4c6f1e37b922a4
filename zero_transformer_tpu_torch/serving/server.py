"""Streaming HTTP front end for the continuous-batching engine.

Counterpart of ``zero_transformer_tpu/serving/server.py`` on the standard
library's threading HTTP server, with the same wire format for every route
it serves:

- ``POST /generate``: JSON body ``{"prompt": str | "tokens": [int],
  "max_new_tokens": int, "seed": int, "timeout": float, "stream": bool,
  "tenant": str, "qos": str, "request_id": str, "prefill_to": url}``. With ``stream`` (default
  true) the response is ``text/event-stream``: one ``data: {"token": id,
  "text": piece}`` event per token (``text`` is empty while the
  detokenizer holds back an incomplete UTF-8 sequence) and a final ``data:
  {"done": true, "status", "text", "error", "retryable", "request_id",
  "ledger"}``. Without, one JSON document ``{"status", "tokens", "text",
  "request_id", "ledger"}``. A stream that moved to another replica (a
  ``prefill_to`` handoff or a live migration) ends ``migrated`` with
  ``"migrated_to": url`` in either. ``X-Request-Id`` (or the body's
  ``request_id``) is echoed in the response headers and the final event;
  ``X-Tenant-Key`` and ``X-QoS-Class`` win over the body's ``tenant`` and
  ``qos``. A retryable rejection answers 429 (full queue, tenant quota,
  brownout) or 503 (draining, shed) with ``Retry-After``; an invalid
  request 400; a dead engine 503; a body over the bound 413.
- ``GET /healthz``: 200 only when the engine is READY and its scheduler
  thread is alive; 503 while starting, degraded, draining or stopped.
- ``GET /metrics``: the JSON snapshot, or the Prometheus text exposition
  when ``Accept`` names ``text/plain`` or ``openmetrics`` (or with
  ``?format=prometheus``).
- ``POST /admin/reload`` (``{"params": path}``, optional), ``POST
  /admin/profile`` (``{"ticks": N}``), ``POST /admin/brownout``
  (``{"rung": ...}``), ``GET /admin/spans?request_id=&tail=``: loopback
  peers, or others with ``Authorization: Bearer <admin token>``.
- ``POST /ingest``: a migrated stream's page span in the wire format
  (``wire.py``), bounded by ``max_ingest_bytes`` (256 MiB); the imported
  stream waits in the pending-stream table (dropped and cancelled after
  ``attach_ttl_s``) for its ``POST /attach {"request_id"}``, which streams
  its continuation as SSE and consumes the entry. 400 on a torn blob, 503
  (retryable) or 409 when the engine refuses it.
- ``POST /admin/migrate {"request_id", "target"}`` and ``POST
  /admin/migrate_all {"target"}`` (202; 404 for an unknown stream) tag live
  streams; the engine exports them between ticks and the shipper thread
  POSTs each payload to ``<target>/ingest`` with ``http.client``, so the
  tick thread never waits on a peer.

``install_signal_handlers``: SIGTERM drains (admission closes, in-flight
streams finish up to the drain deadline, then the server stops and
``serve_forever`` returns, so the process exits 0); SIGHUP hot-reloads
from the configured source. One scheduler thread drives ``engine.step()``;
handler threads only submit and drain per-request event queues, so a slow
client never stalls decode.
"""
from __future__ import annotations

import http.client
import json
import math
import queue as queue_mod
import select
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from zero_transformer_tpu_torch.serving.detok import StreamDecoder, decode_tokens
from zero_transformer_tpu_torch.serving.engine import FAILED, MIGRATED, READY, REJECTED, STOPPED, ServingEngine
from zero_transformer_tpu_torch.serving.resilience import ReloadError
from zero_transformer_tpu_torch.serving.wire import page_span_from_wire, page_span_to_wire

# how long an SSE handler blocks on the next token before checking that the
# client is still connected
_LIVENESS_POLL_S = 0.5

_POST_ROUTES = ("/generate", "/attach", "/ingest", "/admin/reload", "/admin/profile", "/admin/migrate",
                "/admin/migrate_all", "/admin/brownout")


def _client_gone(conn) -> bool:
    """True when the peer has closed its end: an SSE client sends nothing
    after the POST body, so a readable socket whose peek returns b'' is a
    FIN."""
    try:
        readable, _, _ = select.select([conn], [], [], 0)
        if readable:
            return conn.recv(1, socket.MSG_PEEK) == b""
    except OSError:
        return True
    return False


def _load_state(path: str):
    """The default reload loader: the port's state dict from ``path``
    (``.npz``, flax ``.msgpack`` or a trainer step directory)."""
    from zero_transformer_tpu_torch.convert import params_from_jax, read_params_tree

    return params_from_jax(read_params_tree(path))


class ServingServer:
    """Own the HTTP server and the engine's scheduler thread.
    ``reload_source``: a path, or a loader called with the request's path
    (or with none) that returns a state dict. ``admin_token``: the bearer
    token non-loopback peers need for ``/admin/*``. ``max_ingest_bytes``
    bounds an ``/ingest`` body (raw KV pages) apart from the JSON bound.
    Unless the engine has a page shipper, the server installs its own."""

    def __init__(self, engine: ServingEngine, tokenizer, host: str = "127.0.0.1", port: int = 8000,
                 max_body_bytes: int = 1 << 20, reload_source=None, admin_token: Optional[str] = None,
                 max_ingest_bytes: int = 256 << 20):
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_body_bytes = max_body_bytes
        self.max_ingest_bytes = max_ingest_bytes
        # imported streams awaiting their /attach: rid -> (handle, ingested
        # at); the attach pops (consume-once) and a TTL sweep cancels orphans
        self._pending_streams: Dict[str, tuple] = {}
        self._streams_lock = threading.Lock()
        self.attach_ttl_s = 300.0
        # the page shipper: the tick thread enqueues (payload, target,
        # on_done), this thread encodes and POSTs to <target>/ingest
        self._ship_queue: "queue_mod.Queue" = queue_mod.Queue()
        self._ship_thread = threading.Thread(target=self._ship_loop, name="serve-shipper", daemon=True)
        if engine.page_shipper is None:
            engine.page_shipper = self._enqueue_ship
        self.reload_source = reload_source
        self.admin_token = admin_token
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()
        self._stopped = False
        # /generate responses still being written: a drain waits for them
        # before it stops the server, so a drained stream's last events land
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._serving = False
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
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._json(*outer._healthz())
                elif path == "/admin/spans":
                    if not outer._admin_allowed(self):
                        self._json(403, {"error": "admin endpoint: loopback or bearer token required"})
                        return
                    self._json(*outer._admin_spans(query))
                elif path == "/metrics":
                    accept = self.headers.get("Accept") or ""
                    if "format=prometheus" in query or "text/plain" in accept or "openmetrics" in accept:
                        body = outer.engine.prometheus_text().encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json(200, outer.engine.metrics_snapshot())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path not in _POST_ROUTES:
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if self.path == "/ingest":
                    # raw page bytes: their own bound, no JSON parse
                    if length < 0 or length > outer.max_ingest_bytes:
                        self.close_connection = True
                        self._json(413 if length > 0 else 400,
                                   {"error": f"ingest body must be 0..{outer.max_ingest_bytes} bytes"})
                        return
                    outer._ingest(self, self.rfile.read(length))
                    return
                if length < 0:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if length > outer.max_body_bytes:
                    # bound BEFORE reading; the unread body would
                    # desynchronise the connection, so close it
                    self.close_connection = True
                    self._json(413, {"error": f"body exceeds {outer.max_body_bytes} bytes"})
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._json(400, {"error": "malformed JSON body"})
                    return
                if not isinstance(req, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                if self.path.startswith("/admin/"):
                    if not outer._admin_allowed(self):
                        self._json(403, {"error": "admin endpoint: loopback or bearer token required"})
                        return
                    if self.path == "/admin/reload":
                        self._json(*outer._reload(req))
                    elif self.path == "/admin/brownout":
                        self._json(*outer._brownout(req))
                    elif self.path == "/admin/migrate":
                        self._json(*outer._migrate(req))
                    elif self.path == "/admin/migrate_all":
                        self._json(*outer._migrate_all(req))
                    else:
                        self._json(*outer._profile(req))
                elif self.path == "/attach":
                    with outer._inflight_lock:
                        outer._inflight += 1
                    try:
                        outer._attach(self, req)
                    finally:
                        with outer._inflight_lock:
                            outer._inflight -= 1
                else:
                    with outer._inflight_lock:
                        outer._inflight += 1
                    try:
                        outer._generate(self, req)
                    finally:
                        with outer._inflight_lock:
                            outer._inflight -= 1

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # ------------------------------------------------------------ lifecycle

    def start(self, start_scheduler: bool = True) -> None:
        """Serve HTTP in a background thread. ``start_scheduler=False`` keeps
        the engine STARTING (``/healthz`` answers 503) until
        ``start_scheduler()``."""
        self._start_shipper()
        if start_scheduler:
            self.start_scheduler()
        self._serving = True
        self._server_thread = threading.Thread(target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._server_thread.start()

    def start_scheduler(self) -> None:
        self._start_shipper()
        if not self._scheduler.ident:
            self._scheduler.start()

    def _start_shipper(self) -> None:
        if not self._ship_thread.ident:
            self._ship_thread.start()

    def serve_forever(self) -> None:
        """Serve in the calling thread until ``stop()`` (a drain ends with
        it) or an interrupt."""
        self.start_scheduler()
        self._serving = True
        try:
            self._httpd.serve_forever()
        finally:
            self._serving = False
            self.stop()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the scheduler (outstanding requests finish as failed) and
        the HTTP server, and wait for both threads. Idempotent; safe from
        any thread but the one running ``serve_forever``."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._stop.set()
            if self._serving:
                self._httpd.shutdown()
            if self._server_thread is not None:
                self._server_thread.join(timeout)
            self._httpd.server_close()
            if self._scheduler.ident and self._scheduler is not threading.current_thread():
                self._scheduler.join(timeout)
            if self._ship_thread.ident:
                self._ship_thread.join(timeout)

    def drain(self, deadline_s: Optional[float] = 30.0) -> None:
        """Begin a graceful drain and, once the engine is STOPPED (or the
        deadline plus a 10 s grace has passed) and the responses in flight
        are written (up to 5 s more), stop the server. ``deadline_s=None``
        waits for in-flight generations however long they take."""
        self.engine.begin_drain(deadline_s)
        give_up = None if deadline_s is None else time.monotonic() + deadline_s + 10.0
        while self.engine.lifecycle.state != STOPPED and (give_up is None or time.monotonic() < give_up):
            time.sleep(0.05)
        written_by = time.monotonic() + 5.0
        while self._inflight and time.monotonic() < written_by:
            time.sleep(0.01)
        self.stop()

    def install_signal_handlers(self, drain_deadline_s: Optional[float] = 30.0) -> None:
        """SIGTERM -> ``drain`` in a helper thread (a handler must return
        at once); SIGHUP -> a hot reload from ``reload_source``. Call from
        the main thread."""

        def on_term(signum, frame):
            threading.Thread(target=self.drain, args=(drain_deadline_s,), name="serve-drain", daemon=True).start()

        def on_hup(signum, frame):
            if self.reload_source is None:
                return
            # the engine counts and records a rejected reload itself
            threading.Thread(target=self._reload, args=({},), name="serve-reload", daemon=True).start()

        signal.signal(signal.SIGTERM, on_term)
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, on_hup)

    # ------------------------------------------------------------ endpoints

    def _healthz(self):
        """(code, body) for /healthz: 200 ONLY when the engine is READY and
        its scheduler thread is alive. The health poll (routers probe every
        replica) also sweeps imported streams nobody attached."""
        self._sweep_pending_streams()
        eng = self.engine
        state = eng.lifecycle.state
        alive = self._scheduler.is_alive() or not self._scheduler.ident
        if not alive and state != STOPPED:
            state = "scheduler dead"
        ok = state == READY and alive
        return (200 if ok else 503), {
            "status": "ok" if ok else state,
            "state": state,
            "clock_monotonic": eng.now(),
            "uptime_s": round(eng.lifecycle.uptime_s, 3),
            "reloads": eng.stats["reloads"],
            "breaker_open": eng._breaker.open,
            "slots": eng.n_slots,
            "active": eng.active_count,
            "prefilling": len(eng._prefilling),
            "queued": eng.queue_depth,
            "itl_ewma_ms": round((eng._itl_ewma.value or 0.0) * 1e3, 4),
            "queue_depth": eng.queue_depth,
            "active_slots": eng.active_count,
            "free_pages": eng.free_pages,
            "role": eng.role,
            "kv_layout": eng.kv_layout,
            "draft_k": eng.draft_k,
            "migrations_in_flight": eng.migrations_in_flight,
            "page_faults": eng.stats["page_faults"],
            "cow_copies": eng.cow_copies,
            "kernel_paged_attention": eng.kernel_paged_attention,
            "brownout_rung": eng.brownout_rung,
            "queue_by_class": eng._queue.counts(),
        }

    def _admin_allowed(self, handler) -> bool:
        peer = handler.client_address[0]
        if peer in ("127.0.0.1", "::1", "::ffff:127.0.0.1"):
            return True
        if self.admin_token:
            return handler.headers.get("Authorization", "") == f"Bearer {self.admin_token}"
        return False

    def _admin_spans(self, query: str):
        """(code, body) for GET /admin/spans?request_id=<rid>[&tail=N]."""
        params = parse_qs(query)
        rid = (params.get("request_id") or [None])[0]
        try:
            tail = int((params.get("tail") or [2000])[0])
        except (TypeError, ValueError):
            return 400, {"error": "tail must be an integer"}
        spans = self.engine.tracer.track_dicts(track=rid if rid else None, tail=max(1, min(tail, 20000)))
        return 200, {"request_id": rid or "", "clock_monotonic": self.engine.now(), "role": self.engine.role,
                     "spans": spans, "spans_dropped": self.engine.tracer.dropped}

    def _reload(self, req: dict):
        """(code, body) for POST /admin/reload: load and validate in this
        thread, swap between ticks; 409 on a corrupt or mismatched artifact
        (the engine stays READY on the old weights)."""
        path = req.get("params")
        if callable(self.reload_source):
            loader = self.reload_source
            source = (lambda: loader(path)) if path else loader
        elif path or isinstance(self.reload_source, str):
            load_path = path or self.reload_source
            source = lambda: _load_state(load_path)  # noqa: E731
        else:
            return 400, {"error": "no reload source: pass {\"params\": <path>}"}
        try:
            info = self.engine.reload_params(source)
        except ReloadError as exc:
            return 409, {"error": str(exc), "state": self.engine.lifecycle.state,
                         "reloads": self.engine.stats["reloads"]}
        swapped = info["swapped"].wait(timeout=30.0)
        return (200 if swapped else 202), {"reloaded": swapped, "reloads": self.engine.stats["reloads"],
                                           "state": self.engine.lifecycle.state}

    def _profile(self, req: dict):
        """(code, body) for POST /admin/profile: 202, the capture runs on
        the tick thread; 409 while draining, while a capture runs, or
        without an obs directory."""
        try:
            ticks = int(req.get("ticks", 20))
        except (TypeError, ValueError):
            return 400, {"error": "ticks must be an integer"}
        try:
            info = self.engine.request_profile(ticks)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        except RuntimeError as exc:
            return 409, {"error": str(exc), "state": self.engine.lifecycle.state}
        return 202, {"accepted": True, **info}

    def _brownout(self, req: dict):
        """(code, body) for POST /admin/brownout ``{"rung": ...}``."""
        rung = req.get("rung")
        if not isinstance(rung, str):
            return 400, {"error": "rung must be a string"}
        try:
            return 200, self.engine.set_brownout(rung)
        except ValueError as exc:
            return 400, {"error": str(exc)}

    # ------------------------------------------------ disaggregation / migration

    def _enqueue_ship(self, payload: dict, target: str, on_done) -> None:
        """The engine's ``page_shipper``: hand the export to the shipper
        thread and return at once."""
        self._ship_queue.put((payload, target, on_done))

    def _ship_loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload, target, on_done = self._ship_queue.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            try:
                err = self._ship_once(payload, target)
            except Exception as exc:  # a shipper crash fails ONE migration, not the thread
                err = f"{type(exc).__name__}: {exc}"
            on_done(err)

    def _ship_once(self, payload: dict, target: str) -> Optional[str]:
        """POST one payload to ``<target>/ingest``: None once the target
        accepted it, else the reason."""
        blob = page_span_to_wire(payload)
        parts = urlsplit(target if "//" in target else f"http://{target}")
        conn = http.client.HTTPConnection(parts.hostname or "127.0.0.1", parts.port or 80, timeout=30.0)
        try:
            conn.request("POST", "/ingest", blob, {"Content-Type": "application/octet-stream",
                                                   "X-Request-Id": str(payload.get("request_id", ""))})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                try:
                    doc = json.loads(body or b"{}")
                except ValueError:
                    doc = {}
                return f"ingest at {target} returned {resp.status}: {doc.get('error', '')}"
            return None
        except (OSError, http.client.HTTPException) as exc:
            return f"ship to {target} failed: {type(exc).__name__}: {exc}"
        finally:
            conn.close()

    def _ingest(self, handler, blob: bytes) -> None:
        """POST /ingest: accept a migrated stream; its handle waits in the
        pending-stream table for the attach (tokens decoded meanwhile wait
        in its event queue)."""
        try:
            payload = page_span_from_wire(blob)
        except ValueError as exc:
            handler._json(400, {"error": f"bad page-span body: {exc}"})
            return
        handle = self.engine.import_stream(payload)
        if handle.status in (REJECTED, FAILED):
            handler._json(503 if handle.retryable else 409,
                          {"error": handle.error, "status": handle.status, "request_id": handle.rid},
                          headers={"X-Request-Id": handle.rid})
            return
        self._sweep_pending_streams()
        with self._streams_lock:
            displaced = self._pending_streams.pop(handle.rid, None)
            self._pending_streams[handle.rid] = (handle, time.monotonic())
        if displaced is not None:
            # a re-shipped stream: the new import is the live one
            displaced[0].cancel()
        handler._json(200, {"accepted": True, "request_id": handle.rid}, headers={"X-Request-Id": handle.rid})

    def _sweep_pending_streams(self) -> None:
        """Cancel and drop imported streams nobody attached within the TTL."""
        cutoff = time.monotonic() - self.attach_ttl_s
        with self._streams_lock:
            stale = [rid for rid, (_, t0) in self._pending_streams.items() if t0 < cutoff]
            dropped = [self._pending_streams.pop(rid) for rid in stale]
        for handle, _ in dropped:
            handle.cancel()

    def _attach(self, handler, req: dict) -> None:
        """POST /attach {"request_id"}: stream an imported stream's
        continuation as SSE. Consume-once; an unknown id is a 404 (the
        router then recomputes)."""
        self._sweep_pending_streams()
        rid = str(req.get("request_id", ""))
        with self._streams_lock:
            handle, _ = self._pending_streams.pop(rid, (None, 0.0))
        if handle is None:
            handler._json(404, {"error": f"no pending stream {rid!r}", "request_id": rid},
                          headers={"X-Request-Id": rid})
            return
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("X-Request-Id", handle.rid)
            handler.end_headers()
        except OSError:
            # the attacher left before the headers: the entry is consumed,
            # so the stream must not decode into the void
            handle.cancel()
            return
        self._stream_events(handler, handle)

    def _migrate(self, req: dict):
        """(code, body) for POST /admin/migrate {"request_id", "target"}."""
        rid, target = str(req.get("request_id", "")), str(req.get("target", ""))
        if not rid or not target:
            return 400, {"error": "request_id and target are required"}
        if self.engine.request_migration(rid, target):
            return 202, {"requested": True, "request_id": rid, "target": target}
        return 404, {"error": f"no live stream {rid!r}", "request_id": rid}

    def _migrate_all(self, req: dict):
        """(code, body) for POST /admin/migrate_all {"target"}."""
        target = str(req.get("target", ""))
        if not target:
            return 400, {"error": "target is required"}
        return 202, {"requested": self.engine.request_migrate_all(target), "target": target}

    # -------------------------------------------------------------- request

    def _submit(self, req: dict, request_id: Optional[str] = None, trace_hop: Optional[int] = None,
                tenant: Optional[str] = None, qos: Optional[str] = None):
        if "tokens" in req:
            ids = [int(t) for t in req["tokens"]]
        else:
            ids = self.tokenizer.encode(str(req.get("prompt", "")).strip())
        return self.engine.submit(
            ids,
            max_new_tokens=int(req.get("max_new_tokens", 32)),
            seed=int(req.get("seed", 0)),
            timeout=float(req["timeout"]) if "timeout" in req else None,
            request_id=request_id,
            prefill_to=str(req["prefill_to"]) if req.get("prefill_to") else None,
            trace_hop=trace_hop,
            tenant=str(tenant or req.get("tenant") or "anon"),
            qos=qos if qos is not None else req.get("qos"),
        )

    @staticmethod
    def _trace_hop_of(handler) -> Optional[int]:
        """The router's hop index (X-Trace-Hop); a garbled header is a
        dropped span attribute, never a rejected request."""
        try:
            return int(handler.headers["X-Trace-Hop"])
        except (KeyError, TypeError, ValueError):
            return None

    def _generate(self, handler, req: dict) -> None:
        rid_in = handler.headers.get("X-Request-Id") or req.get("request_id")
        try:
            handle = self._submit(req, request_id=rid_in, trace_hop=self._trace_hop_of(handler),
                                  tenant=handler.headers.get("X-Tenant-Key"), qos=handler.headers.get("X-QoS-Class"))
        except (TypeError, ValueError) as exc:
            handler._json(400, {"error": f"bad request field: {exc}"})
            return
        rid_hdr = {"X-Request-Id": handle.rid}
        if handle.status == REJECTED:
            if handle.retryable:
                err = handle.error or ""
                code = 429 if ("queue full" in err or "quota" in err or "brownout" in err) else 503
                handler._json(code, {"error": handle.error, "status": handle.status, "request_id": handle.rid},
                              headers={"Retry-After": str(max(1, math.ceil(handle.retry_after or 1.0))), **rid_hdr})
            else:
                handler._json(400, {"error": handle.error, "status": handle.status, "request_id": handle.rid},
                              headers=rid_hdr)
            return
        if handle.status == FAILED:
            handler._json(503, {"error": handle.error, "status": handle.status, "request_id": handle.rid},
                          headers=rid_hdr)
            return
        if not req.get("stream", True):
            tokens = handle.result()
            if handle.status == FAILED:
                handler._json(503, {"error": handle.error, "status": handle.status, "request_id": handle.rid},
                              headers=rid_hdr)
                return
            doc = {"status": handle.status, "tokens": tokens, "text": self._full_text(tokens),
                   "request_id": handle.rid, "ledger": handle.ledger_snapshot()}
            if handle.status == MIGRATED:
                doc["migrated_to"] = handle.migrated_to
            handler._json(200, doc, headers=rid_hdr)
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
        # a live consumer drains the events from here on: arm the bound
        handle.consumer_attached = True
        chaos = self.engine._chaos
        events_out = 0
        try:
            # the EOS token is swallowed, not broken on: the loop ends on the
            # done event, so the status the final event reports is terminal
            while True:
                event = handle.next_event(timeout=_LIVENESS_POLL_S)
                if event is None:
                    # no token yet: a disconnected client must not hold a
                    # queue position or a slot
                    if _client_gone(handler.connection):
                        handle.cancel()
                        return
                    continue
                kind, token = event
                if kind != "token":
                    break
                events_out += 1
                if chaos is not None:
                    stall = chaos.client_stall_s(events_out)
                    if stall > 0:
                        time.sleep(stall)
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
            done = {"done": True, "status": handle.status, "text": "".join(pieces), "error": handle.error,
                    "retryable": handle.retryable, "request_id": handle.rid, "ledger": handle.ledger_snapshot()}
            if handle.status == MIGRATED:
                # the stream continues there: a router attaches at it
                done["migrated_to"] = handle.migrated_to
            self._event(handler, done)
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
               background: bool = False, reload_source=None, drain_deadline_s: Optional[float] = 30.0,
               max_body_bytes: int = 1 << 20, admin_token: Optional[str] = None) -> Optional[ServingServer]:
    """Start the serving front end. ``background=True`` returns the running
    server; otherwise block until SIGTERM (a graceful drain, then return:
    the process exits 0) or an interrupt, with SIGHUP hot-reloading from
    ``reload_source``."""
    server = ServingServer(engine, tokenizer, host=host, port=port, max_body_bytes=max_body_bytes,
                           reload_source=reload_source, admin_token=admin_token)
    if background:
        server.start()
        return server
    server.install_signal_handlers(drain_deadline_s=drain_deadline_s)
    print(
        f"serving on http://{host}:{server.port} ({engine.n_slots} slots, cache_len {engine.cache_len}, "
        f"{engine.device}, role {engine.role}) - POST /generate, GET /healthz, GET /metrics (JSON; Prometheus text "
        f"via Accept: text/plain), POST /attach, POST /ingest, POST /admin/reload, POST /admin/profile, POST "
        f"/admin/migrate, POST /admin/migrate_all; SIGTERM drains ({drain_deadline_s}s deadline), SIGHUP reloads",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return None
