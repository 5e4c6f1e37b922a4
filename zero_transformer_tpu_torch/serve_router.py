"""The fleet router's entry point, and its harness processes.

    python -m zero_transformer_tpu_torch.serve_router \\
        --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002

Counterpart of ``scripts/serve_router.py``, with its three modes:

- **router** (the default): front N running replicas (``serve --server``
  processes, or the workers below) with ``serving.router.RouterServer``:
  prefix-aware and least-loaded routing, health probing with ejection and
  backoff, mid-stream failover, a rolling ``POST /admin/reload``, the
  prefill/decode split, the SLO engine on ``/slo``, the fleet ``/metrics``
  and the stitched trace on ``/admin/trace``. ``--port 0`` binds a free
  port and prints it;
- **--replica-worker**: one serving process of the port on the zoo model
  ``--model`` with weights initialised from ``--init-seed`` (no checkpoint:
  what is under test is the orchestration). It runs on the CUDA card
  unless ``--device cpu`` is given, and prints ``REPLICA_PORT=<n>`` once it
  listens;
- **--stub**: ``StubReplica``, a paced stub replica (stdlib only) that
  answers the replica surface and "decodes" deterministic token ids at a
  fixed inter-token interval, so a resumed stream provably continues
  where the dead replica stopped. Prints ``STUB_PORT=<n>``.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


# --------------------------------------------------------------------- stub


class StubReplica:
    """Paced fake replica speaking the replica HTTP surface (stdlib only).
    Deterministic by construction:

    - ``/generate`` emits ``max_new_tokens`` SSE token events, one every
      ``itl_s`` seconds, ids ``token_base + prompt_len, token_base +
      prompt_len + 1, ...`` — a resumed request (prompt + generated-so-far)
      continues the same arithmetic sequence, so stream-continuity is
      assertable to the token.
    - ``slots`` bounds concurrent generations with a semaphore; excess
      requests wait (reported as ``queue_depth`` in ``/healthz``), which is
      what makes the router's least-loaded policy measurable.
    - ``die_after_tokens=k`` arms a one-shot mid-stream death: the FIRST
      stream to reach k emitted tokens is cut without a done event (the
      exact wire signature of a SIGKILLed replica).
    """

    def __init__(self, port: int = 0, itl_s: float = 0.002, slots: int = 2,
                 die_after_tokens: int | None = None,
                 fail_5xx_requests: int = 0,
                 backpressure_retry_after: float = 0.0,
                 reload_delay_s: float = 0.0, token_base: int = 1000):
        self.itl_s = itl_s
        self.n_slots = slots
        self.token_base = token_base
        self.reload_delay_s = reload_delay_s
        self._sem = threading.Semaphore(slots)
        self._lock = threading.Lock()
        self._die_after = die_after_tokens
        # fleet-obs surface, stdlib-only like the rest of the stub:
        # a bounded per-request span list (the router's /admin/spans pull),
        # and fixed-bucket TTFT samples for the /metrics exposition the
        # router's aggregator folds
        self._spans: list = []  # dicts: track/name/t0/t1/attrs
        self._span_cap = 4096
        self._ttft_buckets = (0.005, 0.025, 0.1, 0.5, 2.0)
        self._ttft_counts = [0] * (len(self._ttft_buckets) + 1)
        self._ttft_sum = 0.0
        self._ttft_n = 0
        # pre-stream server errors: the first N /generate requests answer
        # 500 before any SSE bytes (a crashed handler, not a dead process)
        self._fail_5xx = fail_5xx_requests
        # when > 0: every /generate answers 503 + a Retry-After HEADER (the
        # replica wire format — the body has no retry_after field)
        self._backpressure_ra = backpressure_retry_after
        self.died = False
        self.state = "ready"
        self.requests = 0
        self.tokens_emitted = 0
        self.reloads = 0
        self.active = 0
        self.waiting = 0
        self.seen_request_ids: list = []
        self.seen_bodies: list = []
        self._born = time.monotonic()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def _json(self, code, obj, headers=None):
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
                if path == "/admin/spans":
                    rid = ""
                    for part in query.split("&"):
                        if part.startswith("request_id="):
                            rid = part[len("request_id="):]
                    with outer._lock:
                        spans = [
                            s for s in outer._spans
                            if not rid or s["track"] == rid
                        ]
                    self._json(200, {
                        "request_id": rid,
                        "clock_monotonic": time.monotonic(),
                        "role": "mixed",
                        "spans": spans,
                        "spans_dropped": 0,
                    })
                    return
                if path == "/metrics":
                    body = outer._metrics_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path != "/healthz":
                    self._json(404, {"error": "no route"})
                    return
                ok = outer.state == "ready"
                self._json(200 if ok else 503, {
                    "status": "ok" if ok else outer.state,
                    "state": outer.state,
                    "clock_monotonic": time.monotonic(),
                    "uptime_s": round(time.monotonic() - outer._born, 3),
                    "reloads": outer.reloads,
                    "breaker_open": False,
                    "slots": outer.n_slots,
                    "active": outer.active,
                    "prefilling": 0,
                    "queued": outer.waiting,
                    "itl_ewma_ms": outer.itl_s * 1e3,
                    "queue_depth": outer.waiting,
                    "active_slots": outer.active,
                    "free_pages": max(0, outer.n_slots - outer.active),
                })

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._json(400, {"error": "malformed JSON"})
                    return
                if self.path == "/admin/reload":
                    if outer.reload_delay_s:
                        time.sleep(outer.reload_delay_s)
                    with outer._lock:
                        outer.reloads += 1
                    self._json(200, {"reloaded": True,
                                     "reloads": outer.reloads,
                                     "state": outer.state})
                    return
                if self.path != "/generate":
                    self._json(404, {"error": "no route"})
                    return
                outer._generate(self, req)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "StubReplica":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting connections (the 'process gone' signature for
        connect-level failover tests: subsequent connects are refused)."""
        self.state = "stopped"
        self._httpd.shutdown()
        self._httpd.server_close()

    def _add_span(self, track, name, t0, t1, attrs=None) -> None:
        with self._lock:
            if len(self._spans) >= self._span_cap:
                del self._spans[: self._span_cap // 4]
            self._spans.append({
                "track": str(track), "name": name, "t0": t0, "t1": t1,
                "attrs": attrs,
            })

    def _observe_ttft(self, ttft_s: float) -> None:
        with self._lock:
            i = len(self._ttft_buckets)
            for j, bound in enumerate(self._ttft_buckets):
                if ttft_s <= bound:
                    i = j
                    break
            self._ttft_counts[i] += 1
            self._ttft_sum += ttft_s
            self._ttft_n += 1

    def _metrics_text(self) -> str:
        """Minimal 0.0.4 exposition so the router's fleet aggregator (and
        its latency SLO objectives) have real families to fold — the same
        names the real replica exports."""
        with self._lock:
            counts = list(self._ttft_counts)
            total, s = self._ttft_n, self._ttft_sum
            tokens = self.tokens_emitted
            requests = self.requests
            active = self.active
            queued = self.waiting
        lines = [
            "# HELP serve_tokens_out_total Tokens emitted to clients",
            "# TYPE serve_tokens_out_total counter",
            f"serve_tokens_out_total {tokens}",
            "# HELP serve_submitted_total Requests submitted",
            "# TYPE serve_submitted_total counter",
            f"serve_submitted_total {requests}",
            "# HELP serve_queue_depth Requests waiting for a slot",
            "# TYPE serve_queue_depth gauge",
            f"serve_queue_depth {queued}",
            "# HELP serve_slot_occupancy Slots actively decoding",
            "# TYPE serve_slot_occupancy gauge",
            f"serve_slot_occupancy {active}",
            "# HELP serve_ttft_seconds Submit-to-first-token latency",
            "# TYPE serve_ttft_seconds histogram",
        ]
        cum = 0
        for bound, c in zip(self._ttft_buckets, counts):
            cum += c
            lines.append(f'serve_ttft_seconds_bucket{{le="{bound}"}} {cum}')
        lines.append(f'serve_ttft_seconds_bucket{{le="+Inf"}} {total}')
        lines.append(f"serve_ttft_seconds_sum {s:.6f}")
        lines.append(f"serve_ttft_seconds_count {total}")
        return "\n".join(lines) + "\n"

    def _generate(self, handler, req: dict) -> None:
        rid = handler.headers.get("X-Request-Id") or req.get("request_id")
        try:
            hop = int(handler.headers.get("X-Trace-Hop", ""))
        except (TypeError, ValueError):
            hop = None
        t_req = time.monotonic()
        with self._lock:
            self.requests += 1
            self.seen_request_ids.append(rid)
            self.seen_bodies.append(req)
            if self._fail_5xx > 0:
                self._fail_5xx -= 1
                handler._json(500, {"error": "injected server error",
                                    "request_id": rid})
                return
            if self._backpressure_ra > 0:
                handler._json(
                    503, {"error": "draining", "request_id": rid},
                    headers={"Retry-After": str(int(self._backpressure_ra))},
                )
                return
            self.waiting += 1
        self._sem.acquire()
        t_acq = time.monotonic()
        with self._lock:
            self.waiting -= 1
            self.active += 1

        def ledger(n_tokens: int, now: float) -> dict:
            return {
                "decode_ticks": n_tokens, "tokens_out": n_tokens,
                "prefill_chunks": 1, "migrations": 0,
                "queue_ms": round((t_acq - t_req) * 1e3, 3),
                "prefill_ms": 0.0,
                "decode_ms": round((now - t_acq) * 1e3, 3),
            }

        def emit_spans(now: float, n_tokens: int, outcome: str) -> None:
            if rid:
                attrs = {"outcome": outcome, "tokens": n_tokens}
                if hop is not None:
                    attrs["hop"] = hop
                self._add_span(rid, "request", t_req, now, attrs)
                self._add_span(rid, "queue", t_req, t_acq)
                self._add_span(rid, "decode", t_acq, now)

        try:
            prompt = req.get("tokens") or [0] * len(str(req.get("prompt", "x")))
            max_new = int(req.get("max_new_tokens", 8))
            first = self.token_base + len(prompt)
            ids = list(range(first, first + max_new))
            stream = req.get("stream", True)
            if not stream:
                with self._lock:
                    self.tokens_emitted += len(ids)
                now = time.monotonic()
                self._observe_ttft(t_acq - t_req + self.itl_s)
                emit_spans(now, len(ids), "done")
                handler._json(200, {
                    "status": "done", "tokens": ids,
                    "text": "".join(f"<{t}>" for t in ids),
                    "request_id": rid,
                    "ledger": ledger(len(ids), now),
                })
                return
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.end_headers()
            sent = []
            first_at = None
            for t in ids:
                time.sleep(self.itl_s)
                with self._lock:
                    armed = (
                        self._die_after is not None
                        and len(sent) >= self._die_after
                    )
                    if armed:
                        self._die_after = None
                        self.died = True
                if armed:
                    # mid-stream death: cut the connection with no done
                    # event — exactly what a SIGKILL looks like on the wire
                    try:
                        handler.connection.close()
                    except OSError:
                        pass
                    return
                event = {"token": t, "text": f"<{t}>"}
                try:
                    handler.wfile.write(
                        b"data: " + json.dumps(event).encode() + b"\n\n"
                    )
                    handler.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return  # client (router) went away; stop decoding
                if first_at is None:
                    first_at = time.monotonic()
                    self._observe_ttft(first_at - t_req)
                sent.append(t)
                with self._lock:
                    self.tokens_emitted += 1
            with self._lock:
                # die_after_tokens == max_new_tokens: the death lands in
                # the gap between the LAST token and the done event
                armed = (
                    self._die_after is not None
                    and len(sent) >= self._die_after
                )
                if armed:
                    self._die_after = None
                    self.died = True
            if armed:
                try:
                    handler.connection.close()
                except OSError:
                    pass
                return
            now = time.monotonic()
            emit_spans(now, len(sent), "done")
            done = {"done": True, "status": "done",
                    "text": "".join(f"<{t}>" for t in sent),
                    "retryable": False, "request_id": rid,
                    "ledger": ledger(len(sent), now)}
            try:
                handler.wfile.write(
                    b"data: " + json.dumps(done).encode() + b"\n\n"
                )
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
        finally:
            with self._lock:
                self.active -= 1
            self._sem.release()


# ----------------------------------------------------------- replica worker


def run_replica_worker(args) -> None:
    """A single-replica serving process of the port on ``--model`` with
    seed-initialised weights: the fleet tests' SIGKILL target. The device
    is ``--device`` (CUDA unless the caller asks for the CPU; without a
    card that raises)."""
    import torch

    from zero_transformer_tpu_torch.config import resolve_device
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.serving import ServingEngine, ServingServer

    device = resolve_device(args.device)
    model = model_getter(args.model, dtype=getattr(torch, args.dtype), device=device, seed=args.init_seed,
                         dropout=0.0)
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k, greedy=args.greedy)
    engine = ServingEngine(
        model, n_slots=args.slots, cache_len=args.cache_len or model.cfg.max_seq_len, sampling=sampling,
        prefill_chunk=args.prefill_chunk,
        prefix_cache_chunks=args.prefix_cache if args.prefill_chunk else 0,
        kv_layout="paged" if args.prefill_chunk else "slab",
        page_size=args.page_size, role=args.role, device=device,
    )
    vocab = model.cfg.vocab_size

    class _TokenTokenizer:
        eos_token_id = None

        def encode(self, text):
            return [1 + (b % (vocab - 1)) for b in text.encode()]

        def decode(self, ids, **kw):
            return "".join(f"<{t}>" for t in ids)

    server = ServingServer(engine, _TokenTokenizer(), port=args.port)
    server.install_signal_handlers(drain_deadline_s=args.drain_deadline)
    # the parent reads this line to learn the bound port
    print(f"REPLICA_PORT={server.port}", flush=True)
    server.serve_forever()


def run_stub(args) -> None:
    stub = StubReplica(
        port=args.port, itl_s=args.itl_ms / 1e3, slots=args.slots,
        die_after_tokens=args.die_after if args.die_after >= 0 else None,
    ).start()
    print(f"STUB_PORT={stub.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stub.stop()


# ------------------------------------------------------------------- router


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.serve_router",
                                description=__doc__.split("\n")[0])
    p.add_argument("--replica", action="append", default=[],
                   help="replica base URL (repeatable): http://host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--probe-interval", type=float, default=0.25,
                   help="seconds between /healthz probes per replica")
    p.add_argument("--probe-timeout", type=float, default=1.0)
    p.add_argument("--eject-threshold", type=int, default=3,
                   help="consecutive probe failures before ejection")
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="first re-probe backoff after ejection (doubles up "
                        "to --backoff-max)")
    p.add_argument("--backoff-max", type=float, default=8.0)
    p.add_argument("--chunk-tokens", type=int, default=8,
                   help="prefix-affinity granularity; match the replicas' "
                        "--prefill-chunk so affinity aligns with their "
                        "prefix caches")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="replica dispatch attempts per request (failover "
                        "budget)")
    p.add_argument("--connect-timeout", type=float, default=2.0)
    p.add_argument("--stream-timeout", type=float, default=30.0,
                   help="max seconds between SSE events before the replica "
                        "is considered dead mid-stream")
    p.add_argument("--admin-token", default=None)
    p.add_argument("--obs-dir", default=None,
                   help="flight-recorder dumps (replica ejections) + traces")
    p.add_argument("--slo", default=None, metavar="SPEC_JSON",
                   help="SLO objectives config (a JSON list of objectives, "
                        "or a dict with an 'objectives' list); 'off' disables "
                        "the SLO engine; default: the built-in objectives")
    p.add_argument("--metrics-scrape-interval", type=float, default=1.0,
                   help="seconds between per-replica /metrics scrapes "
                        "folded into the router's fleet_* rollups "
                        "(0 disables aggregation + SLO evaluation)")
    p.add_argument("--disaggregate", default="auto",
                   choices=("auto", "off"),
                   help="split requests prefill/decode by phase whenever the "
                        "fleet advertises both roles on /healthz (auto), or "
                        "force the classic single-replica path (off)")
    p.add_argument("--no-migrate-drain", action="store_true",
                   help="rolling reload: wait out in-flight generations "
                        "instead of migrating them")
    p.add_argument("--role", default="mixed",
                   choices=("mixed", "prefill", "decode"),
                   help="replica-worker mode: the engine role "
                        "(see serve --role)")
    # harness modes (testing / benching):
    p.add_argument("--replica-worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--stub", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--model", default="test", help=argparse.SUPPRESS)
    p.add_argument("--slots", type=int, default=2, help=argparse.SUPPRESS)
    p.add_argument("--cache-len", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--prefill-chunk", type=int, default=8,
                   help=argparse.SUPPRESS)
    p.add_argument("--prefix-cache", type=int, default=64,
                   help=argparse.SUPPRESS)
    p.add_argument("--page-size", type=int, default=4, help=argparse.SUPPRESS)
    p.add_argument("--temperature", type=float, default=0.9,
                   help=argparse.SUPPRESS)
    p.add_argument("--top-k", type=int, default=20, help=argparse.SUPPRESS)
    p.add_argument("--greedy", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--init-seed", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--drain-deadline", type=float, default=10.0,
                   help=argparse.SUPPRESS)
    p.add_argument("--itl-ms", type=float, default=2.0, help=argparse.SUPPRESS)
    p.add_argument("--die-after", type=int, default=-1,
                   help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="replica-worker mode: cuda (default) or cpu")
    p.add_argument("--dtype", default="float32", choices=("bfloat16", "float32"),
                   help="replica-worker mode: the compute dtype")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.replica_worker:
        run_replica_worker(args)
        return
    if args.stub:
        run_stub(args)
        return
    if not args.replica:
        build_parser().error("router mode needs at least one --replica URL")
    from zero_transformer_tpu_torch.serving.router import run_router

    slo = None  # None -> the built-in default objectives
    if args.slo == "off":
        slo = ()
    elif args.slo:
        slo = json.loads(Path(args.slo).read_text())

    run_router(
        args.replica, host=args.host, port=args.port,
        probe_interval=args.probe_interval, probe_timeout=args.probe_timeout,
        eject_threshold=args.eject_threshold,
        backoff_base_s=args.backoff_base, backoff_max_s=args.backoff_max,
        chunk_tokens=args.chunk_tokens, max_attempts=args.max_attempts,
        connect_timeout=args.connect_timeout,
        stream_timeout=args.stream_timeout, admin_token=args.admin_token,
        obs_dir=args.obs_dir,
        disaggregate=args.disaggregate,
        migrate_drain=not args.no_migrate_drain,
        slo=slo,
        metrics_scrape_interval=args.metrics_scrape_interval,
    )


if __name__ == "__main__":
    main()
