"""Fault-tolerant fleet router: a control-plane tier over N engine replicas.

A copy of ``zero_transformer_tpu/serving/router.py`` (``Replica`` :128,
``ReplicaRegistry`` :205, ``chunk_prefix_key`` :470, ``PrefixAffinity``
:515, ``pick_replica`` :567, ``pick_decode_replica`` :585, ``RouterServer``
:607, ``run_router`` :2819) with its imports pointed at the port's
``obs`` and ``serving`` modules: the port keeps its own copy and imports
nothing of the JAX package. Its names, replica states, request-id charset,
HTTP surface and Prometheus names are JAX's, so it fronts port replicas
(``serve --server``, ``serve_router --replica-worker``) and JAX ones alike.

Everything below this module hardens ONE ``ServingEngine`` replica
(lifecycle /healthz, supervised ticks, drain, hot reload). This router is the
tier that makes a *fleet* of them survive what a single process cannot:
replica death mid-stream, slow/sick replicas, and fleet-wide weight rollouts. Stdlib-only HTTP (same discipline as
``server.py``), so the fleet surface runs anywhere the replicas do.

Pieces, each independently unit-testable without sockets:

- **ReplicaRegistry**: active health probing of each replica's ``/healthz``,
  honoring the replica lifecycle states — READY routes, DEGRADED stays in
  rotation but deprioritized, DRAINING/STOPPED leave rotation (they answer,
  so they are *not* probe failures). Consecutive probe failures feed a
  per-replica ``CircuitBreaker`` (the engine's primitive, reused); a trip EJECTS
  the replica with exponential-backoff re-probing, and one successful probe
  recovers it. The probe also scrapes the replica's admission inputs
  (``itl_ewma_ms``, ``queue_depth``, ``active_slots``, ``free_pages`` —
  served in the ``/healthz`` body exactly so the router needs one cheap
  poll, not a ``/metrics`` scrape).
- **Routing policy** (pure functions): prefix-aware first — the prompt's
  chunk-aligned token prefix is mapped to the replica that served it last
  (``PrefixAffinity``), so repeated/shared prefixes land where their K/V is
  already cached and N per-replica prefix caches behave like one
  distributed cache. Affinity only holds within the healthy pool: a READY
  replica always beats a DEGRADED one, and ties break by least-loaded
  admission (scraped queue depth + active slots + the router's own
  in-flight relays, weighted by the replica's measured ITL EWMA).
- **Failover**: requests relay with bounded retry + backoff across
  replicas. Pre-stream failures (connect refused, 5xx/429) simply try the
  next replica. The hard case is **mid-stream** death: the router counts
  every token it has relayed, and when a replica dies under an active SSE
  stream it re-dispatches the request to a survivor with ``prompt +
  generated-so-far`` as the new prompt and the token budget reduced by what
  was already delivered — the client sees a stall, then the stream resumes
  (greedy sampling continues the exact trajectory; seeded stochastic
  sampling continues *a* consistent trajectory). Non-resumable cases (text
  prompt the router cannot re-tokenize, retry budget exhausted) terminate
  with a retryable SSE error event — never a silent hang.
- **Rolling fleet reload** (``POST /admin/reload`` on the router): one
  replica at a time is cordoned (no new requests routed to it), the
  router's in-flight relays to it drain to zero, the replica hot-reloads
  via its own ``/admin/reload`` path, the router waits for READY, then
  uncordons and moves on — ``dropped_streams == 0`` by construction, chaos-
  proven by the router tests.

Observability: the router carries its own ``Tracer`` (every relayed request
gets a span tree on its ``X-Request-Id`` track, each hop tagged with the
``replica`` that served it — a Perfetto view shows exactly which replicas a
failover crossed), a Prometheus ``Registry`` (``GET /metrics`` content-
negotiates JSON vs text exposition like the replica server), and a
``FlightRecorder`` that dumps the recent probe/relay window whenever a
replica is ejected. ``X-Request-Id`` propagates verbatim: client → router →
replica → back, so one id keys the request's spans on every tier.
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import math
import re
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple
from urllib.parse import urlsplit

from zero_transformer_tpu_torch.obs.flight import FlightRecorder
from zero_transformer_tpu_torch.obs.fleet import (
    FleetAggregator,
    TenantLedger,
    complete_ledger,
    estimate_clock_offset,
    request_ids_in,
    stitch_spans,
    verify_stitched,
)
from zero_transformer_tpu_torch.obs.metrics import Registry
from zero_transformer_tpu_torch.obs.slo import (
    Objective,
    SLOEngine,
    default_objectives,
    parse_slo_config,
)
from zero_transformer_tpu_torch.obs.spans import Tracer
from zero_transformer_tpu_torch.serving.qos import (
    BrownoutController,
    QosPolicy,
    TenantBuckets,
    rung_at_least,
)
from zero_transformer_tpu_torch.serving.resilience import (
    DEGRADED,
    DRAINING,
    READY,
    CircuitBreaker,
)

# Replica states as the ROUTER sees them (a superset of the replica's own
# lifecycle: the router must also represent "I cannot reach it at all").
UNKNOWN = "unknown"  # never probed successfully yet
EJECTED = "ejected"  # consecutive probe failures tripped the breaker

# EXACTLY the engine's charset (engine.py _RID_UNSAFE): the id must survive
# router -> replica re-sanitation verbatim or cross-tier span correlation
# silently breaks for the characters the tiers disagree on
_RID_UNSAFE = re.compile(r"[^A-Za-z0-9._:/=-]")


def _clean_rid(request_id: Optional[str]) -> str:
    """Same header-safe sanitation as the engine: the id is echoed into a
    response header, so CR/LF injection and non-latin-1 must be impossible."""
    if request_id:
        clean = _RID_UNSAFE.sub("", str(request_id))[:128]
        if clean:
            return clean
    return uuid.uuid4().hex


# ------------------------------------------------------------------ registry


@dataclasses.dataclass
class Replica:
    """One replica as the router tracks it: identity, probed lifecycle
    state, scraped admission inputs, and router-side relay bookkeeping."""

    id: str
    url: str
    host: str
    port: int
    state: str = UNKNOWN
    cordoned: bool = False  # rolling reload: out of rotation, not ejected
    consecutive_failures: int = 0
    ejections: int = 0
    backoff_s: float = 0.0
    next_probe_at: float = 0.0
    last_probe_at: Optional[float] = None
    # admission inputs scraped from the replica's /healthz body (satellite:
    # the body carries them so routing costs one poll, not a /metrics scrape)
    itl_ewma_ms: float = 0.0
    queue_depth: int = 0
    active_slots: int = 0
    free_pages: int = 0
    breaker_open: bool = False
    # disaggregation: the replica's engine role (prefill/decode/mixed) and
    # its in-flight page shipments, both scraped from /healthz — plus the
    # page-pool pressure stats the router mirrors as per-replica gauges
    role: str = "mixed"
    migrations_in_flight: int = 0
    page_faults: int = 0
    cow_copies: int = 0
    # importability: pages can only ship to a paged-layout engine; "" until
    # the first successful probe (treated as NOT importable — never ship
    # into the unknown). ``draft_k`` rides along because an import's
    # veto/rewind carry is draft_k-shaped — a mismatched target rejects
    # every ship, so placement filters on it up front.
    kv_layout: str = ""
    draft_k: int = 0
    # per-process clock offset (replica monotonic clock minus the router's):
    # estimated NTP-style from each probe's round trip against the
    # ``clock_monotonic`` the /healthz body carries; the trace stitcher
    # subtracts it to place this replica's spans on the fleet timeline.
    # rtt is the error bar (the true offset is within ±rtt/2).
    clock_offset_s: float = 0.0
    clock_rtt_s: float = float("inf")
    clock_at: float = 0.0

    @property
    def importable(self) -> bool:
        return self.kv_layout == "paged"
    # router-side live view (fresher than the last probe)
    active_relays: int = 0
    tokens_relayed: int = 0
    requests_routed: int = 0
    breaker: CircuitBreaker = dataclasses.field(
        default_factory=lambda: CircuitBreaker(threshold=3, cooldown=1)
    )

    @property
    def routable(self) -> bool:
        return self.state in (READY, DEGRADED) and not self.cordoned

    def load_score(self) -> Tuple[float, int, str]:
        """Estimated backlog drain time: requests ahead (scraped queue +
        active slots + the router's own in-flight relays) weighted by the
        replica's measured ITL EWMA. The EWMA floor keeps a cold replica
        (no samples yet) attractive without dividing by zero; the id
        tie-break keeps the policy deterministic."""
        backlog = self.queue_depth + self.active_slots + self.active_relays
        return (backlog * max(self.itl_ewma_ms, 0.1), backlog, self.id)


def _parse_url(url: str) -> Tuple[str, str, int]:
    parts = urlsplit(url if "//" in url else f"http://{url}")
    host = parts.hostname or "127.0.0.1"
    port = parts.port or 80
    return f"{host}:{port}", host, port


class ReplicaRegistry:
    """Thread-safe replica table + the probe-outcome state machine.

    Pure logic: no sockets. The server feeds it probe outcomes
    (``observe_probe``) and relay failures (``observe_relay_failure``); it
    answers "who is due a probe" (``due``, honoring the exponential backoff
    of ejected replicas) and "who can take traffic" (``routable``).
    """

    def __init__(
        self,
        urls: Sequence[str],
        clock=time.monotonic,
        probe_interval: float = 0.25,
        eject_threshold: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 8.0,
    ):
        if not urls:
            raise ValueError("router needs at least one replica URL")
        if eject_threshold < 1:
            raise ValueError("eject_threshold must be >= 1")
        self.clock = clock
        self.probe_interval = probe_interval
        self.eject_threshold = eject_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._lock = threading.Lock()
        self.replicas: "OrderedDict[str, Replica]" = OrderedDict()
        for url in urls:
            rid, host, port = _parse_url(url)
            if rid in self.replicas:
                raise ValueError(f"duplicate replica {rid}")
            self.replicas[rid] = Replica(
                id=rid, url=url, host=host, port=port,
                breaker=CircuitBreaker(threshold=eject_threshold, cooldown=1),
            )

    def __len__(self) -> int:
        return len(self.replicas)

    # ------------------------------------------------------------- observing

    def observe_probe(
        self,
        rid: str,
        ok: bool,
        code: Optional[int] = None,
        body: Optional[dict] = None,
        rtt_window: Optional[Tuple[float, float]] = None,
    ) -> List[Tuple[str, str]]:
        """Fold one probe outcome into the replica's state. ``ok`` means the
        probe got an HTTP response with a parseable body (whatever the
        status code — a 503 from a draining replica is an ANSWER, not a
        failure). Returns lifecycle events for the caller to surface:
        ``("ejected", rid)`` / ``("recovered", rid)``."""
        now = self.clock()
        events: List[Tuple[str, str]] = []
        # parse the remote clock OUTSIDE the lock (lint: no conversions of
        # foreign values while holding the registry lock)
        clock_remote: Optional[float] = None
        if body is not None and body.get("clock_monotonic") is not None:
            try:
                clock_remote = float(body["clock_monotonic"])
            except (TypeError, ValueError):
                clock_remote = None
        with self._lock:
            r = self.replicas.get(rid)
            if r is None:
                return events  # removed (autoscale retire) mid-probe
            r.last_probe_at = now
            if ok:
                state = str((body or {}).get("state", ""))
                was_ejected = r.state == EJECTED
                r.breaker.record_clean()
                r.consecutive_failures = 0
                r.backoff_s = 0.0
                if state == READY:
                    r.state = READY
                elif state == DEGRADED:
                    r.state = DEGRADED
                elif state in (DRAINING, "stopped", "scheduler dead"):
                    # answers, but is leaving: out of rotation without the
                    # ejection machinery (no backoff — it may restart READY)
                    r.state = DRAINING
                else:  # "starting" or an unrecognized body
                    r.state = UNKNOWN
                if was_ejected and r.state in (READY, DEGRADED):
                    events.append(("recovered", rid))
                if body:
                    r.itl_ewma_ms = float(body.get("itl_ewma_ms", 0.0) or 0.0)
                    r.queue_depth = int(
                        body.get("queue_depth", body.get("queued", 0)) or 0
                    )
                    r.active_slots = int(
                        body.get("active_slots", body.get("active", 0)) or 0
                    )
                    r.free_pages = int(body.get("free_pages", 0) or 0)
                    r.breaker_open = bool(body.get("breaker_open", False))
                    r.role = str(body.get("role", "mixed") or "mixed")
                    r.migrations_in_flight = int(
                        body.get("migrations_in_flight", 0) or 0
                    )
                    r.page_faults = int(body.get("page_faults", 0) or 0)
                    r.cow_copies = int(body.get("cow_copies", 0) or 0)
                    r.kv_layout = str(body.get("kv_layout", "") or "")
                    r.draft_k = int(body.get("draft_k", 0) or 0)
                    if rtt_window is not None and clock_remote is not None:
                        # per-process clock offset from this round trip
                        # (keeps the tighter-rtt estimate until it ages)
                        prev = (
                            None if r.clock_rtt_s == float("inf")
                            else (r.clock_offset_s, r.clock_rtt_s, r.clock_at)
                        )
                        r.clock_offset_s, r.clock_rtt_s, r.clock_at = (
                            estimate_clock_offset(
                                clock_remote,
                                rtt_window[0], rtt_window[1],
                                prev=prev, now=now,
                            )
                        )
                r.next_probe_at = now + self.probe_interval
            else:
                r.consecutive_failures += 1
                tripped = r.breaker.record_fault()
                if r.state == EJECTED:
                    # still dead on a backed-off re-probe: double the wait
                    r.backoff_s = min(r.backoff_s * 2.0, self.backoff_max_s)
                    r.next_probe_at = now + r.backoff_s
                elif tripped:
                    r.state = EJECTED
                    r.ejections += 1
                    r.backoff_s = self.backoff_base_s
                    r.next_probe_at = now + r.backoff_s
                    events.append(("ejected", rid))
                else:
                    r.next_probe_at = now + self.probe_interval
        return events

    def observe_relay_failure(self, rid: str, reason: str = "") -> List[Tuple[str, str]]:
        """A relay hit a dead connection: count it like a probe failure (the
        relay IS evidence of unreachability) and schedule an immediate
        re-probe so the registry converges faster than the probe interval."""
        events = self.observe_probe(rid, ok=False)
        with self._lock:
            r = self.replicas.get(rid)
            if r is not None and r.state != EJECTED:
                r.next_probe_at = self.clock()  # probe now, not next tick
        return events

    # --------------------------------------------------------------- queries

    def due(self, now: Optional[float] = None) -> List[Replica]:
        """Replicas whose next probe is due (ejected ones respect their
        exponential backoff; everyone else the base interval)."""
        t = self.clock() if now is None else now
        with self._lock:
            return [r for r in self.replicas.values() if r.next_probe_at <= t]

    def routable(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas.values() if r.routable]

    def get(self, rid: str) -> Replica:
        return self.replicas[rid]

    # ------------------------------------------------------- fleet elasticity

    def add(self, url: str, replace: bool = False) -> str:
        """Register a new replica (autoscale spawn): it enters UNKNOWN and
        joins rotation on its first clean READY probe. Returns its id.

        ``replace=True`` re-registers an EXISTING id with a completely
        fresh row (fresh breaker, no cordon, zeroed failure counts). A
        process that died and came back under the same identity — a
        SIGKILLed training worker rejoining the fleet, a replica restarted
        in place — must not inherit its dead predecessor's cordon or
        tripped breaker: that stale state would keep the NEW process out of
        rotation forever (pinned by the router tests). The default
        stays ``False`` for idempotent admin adds: re-adding a LIVE replica
        mid-drain must not silently uncordon it."""
        rid, host, port = _parse_url(url)
        with self._lock:
            if rid in self.replicas and not replace:
                return rid
            self.replicas[rid] = Replica(
                id=rid, url=url, host=host, port=port,
                breaker=CircuitBreaker(
                    threshold=self.eject_threshold, cooldown=1
                ),
            )
        return rid

    def remove(self, rid: str) -> None:
        """Forget a replica (autoscale retire). The caller owns cordoning
        and draining/migrating first — removal is pure bookkeeping."""
        with self._lock:
            self.replicas.pop(rid, None)

    # -------------------------------------------------- router-side bookkeeping

    def cordon(self, rid: str) -> None:
        with self._lock:
            if rid in self.replicas:
                self.replicas[rid].cordoned = True

    def uncordon(self, rid: str) -> None:
        with self._lock:
            if rid in self.replicas:
                self.replicas[rid].cordoned = False

    def inc_relay(self, rid: str) -> None:
        with self._lock:
            r = self.replicas.get(rid)
            if r is not None:
                r.active_relays += 1
                r.requests_routed += 1

    def dec_relay(self, rid: str) -> None:
        with self._lock:
            r = self.replicas.get(rid)
            if r is not None:
                r.active_relays -= 1

    def add_tokens(self, rid: str, n: int) -> None:
        with self._lock:
            r = self.replicas.get(rid)
            if r is not None:
                r.tokens_relayed += n

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                r.id: {
                    "url": r.url,
                    "state": r.state,
                    "cordoned": r.cordoned,
                    "consecutive_failures": r.consecutive_failures,
                    "ejections": r.ejections,
                    "backoff_s": r.backoff_s,
                    "itl_ewma_ms": r.itl_ewma_ms,
                    "queue_depth": r.queue_depth,
                    "active_slots": r.active_slots,
                    "free_pages": r.free_pages,
                    "role": r.role,
                    "kv_layout": r.kv_layout,
                    "migrations_in_flight": r.migrations_in_flight,
                    "page_faults": r.page_faults,
                    "cow_copies": r.cow_copies,
                    "active_relays": r.active_relays,
                    "tokens_relayed": r.tokens_relayed,
                    "requests_routed": r.requests_routed,
                    "clock_offset_s": r.clock_offset_s,
                    "clock_rtt_s": (
                        r.clock_rtt_s
                        if r.clock_rtt_s != float("inf") else None
                    ),
                }
                for r in self.replicas.values()
            }


# ------------------------------------------------------------ routing policy


def chunk_prefix_key(
    tokens: Optional[Sequence[int]], chunk_tokens: int
) -> Optional[Tuple[int, ...]]:
    """The affinity key: the prompt's LONGEST chunk-aligned token prefix —
    the exact granularity the per-replica prefix cache banks K/V at
    (``prefix_cache.py`` keys entries by whole chunk-aligned prefixes), so
    "same key" really means "that replica has reusable K/V". Prompts
    shorter than one chunk have nothing cacheable to be affine to."""
    if tokens is None or chunk_tokens < 1:
        return None
    n = (len(tokens) // chunk_tokens) * chunk_tokens
    if n == 0:
        return None
    return tuple(int(t) for t in tokens[:n])


# PrefixAffinity keys levels by (length, rolling hash) instead of the prefix
# tuple itself: recording L/chunk levels of materialized tuples is O(L^2)
# time and memory per long prompt; one rolling-hash sweep is O(L) total.
# A collision (~2^-61 birthday odds at LRU capacity) merely routes one
# request to a replica without the prefix — a cache miss, never corruption.
_HASH_MOD = (1 << 61) - 1
_HASH_BASE = 1_000_003


def _level_keys(
    tokens: Optional[Sequence[int]], chunk_tokens: int
) -> List[Tuple[int, int]]:
    """(n_tokens, prefix_hash) for every chunk-aligned prefix of ``tokens``,
    deepest first, in one O(len) pass."""
    if tokens is None or chunk_tokens < 1:
        return []
    n = (len(tokens) // chunk_tokens) * chunk_tokens
    if n == 0:
        return []
    out: List[Tuple[int, int]] = []
    h = 0
    for i in range(n):
        h = (h * _HASH_BASE + int(tokens[i]) + 1) % _HASH_MOD
        if (i + 1) % chunk_tokens == 0:
            out.append((i + 1, h))
    out.reverse()
    return out


class PrefixAffinity:
    """Bounded LRU of chunk-aligned prefix keys -> the replica that served
    them last, with LONGEST-match lookup: a route records every aligned
    prefix level of the prompt (``tokens[:chunk]``, ``tokens[:2*chunk]``,
    ...), and a lookup walks its own levels deepest-first — so two prompts
    sharing a system prefix but diverging in their tails still land on the
    same replica (the one whose prefix cache holds the shared chunks).
    Host-side bookkeeping only; a stale entry is harmless (the pick falls
    back to least-loaded when the remembered replica is unhealthy)."""

    def __init__(self, chunk_tokens: int, capacity: int = 4096):
        self.chunk_tokens = max(0, int(chunk_tokens))
        self.capacity = max(1, int(capacity))
        self._map: "OrderedDict[Tuple[int, int], str]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._map)

    def _levels(
        self, tokens: Optional[Sequence[int]]
    ) -> List[Tuple[int, int]]:
        """Every chunk-aligned prefix level of ``tokens`` as an O(1)-sized
        (length, hash) key, deepest first."""
        return _level_keys(tokens, self.chunk_tokens)

    def lookup(self, tokens: Optional[Sequence[int]]) -> Optional[str]:
        with self._lock:
            for key in self._levels(tokens):
                rid = self._map.get(key)
                if rid is not None:
                    self._map.move_to_end(key)
                    return rid
        return None

    def record(self, tokens: Optional[Sequence[int]], rid: str) -> None:
        with self._lock:
            for key in self._levels(tokens):
                self._map[key] = rid
                self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def forget_replica(self, rid: str) -> None:
        """Drop every affinity pointing at a replica (its cache is gone:
        ejection, reload — the next request should re-spread, not chase a
        cold or dead replica)."""
        with self._lock:
            for key in [k for k, v in self._map.items() if v == rid]:
                del self._map[key]


def pick_replica(
    candidates: Sequence[Replica], affinity_id: Optional[str] = None
) -> Optional[Replica]:
    """The routing decision, pure: READY beats DEGRADED (a DEGRADED replica
    serves only when nothing READY exists — it is mid-rebuild and slow);
    within the chosen tier, prefix affinity wins (its K/V is there), else
    least-loaded by ``Replica.load_score``. Deterministic for tests."""
    ready = [c for c in candidates if c.state == READY]
    pool = ready or [c for c in candidates if c.state == DEGRADED]
    if not pool:
        return None
    if affinity_id is not None:
        for c in pool:
            if c.id == affinity_id:
                return c
    return min(pool, key=Replica.load_score)


def pick_decode_replica(candidates: Sequence[Replica]) -> Optional[Replica]:
    """Decode PLACEMENT for a disaggregated handoff, pure: most free KV
    pages first (the pages are about to land there), then lowest measured
    ITL EWMA (the stream lives out its decode at that pace), then the
    least-loaded tie-break. READY beats DEGRADED as everywhere else."""
    ready = [c for c in candidates if c.state == READY]
    pool = ready or [c for c in candidates if c.state == DEGRADED]
    if not pool:
        return None
    return min(
        pool,
        key=lambda c: (-c.free_pages, c.itl_ewma_ms, c.load_score()),
    )


# ------------------------------------------------------------------- server


class _HopDead(Exception):
    """The current replica hop failed in a way failover should handle."""


class RouterServer:
    """The router process: HTTP front end + health-probe loop + relay core.

    Endpoints (mirroring the replica surface where it makes sense):

    - ``POST /generate``: relayed to a replica chosen by the routing
      policy; SSE streams pass through token-by-token with mid-stream
      failover; JSON (non-stream) requests retry wholesale on failure.
    - ``GET /healthz``: 200 while >= 1 replica is routable; body carries
      the full per-replica registry snapshot (states, failures, load).
    - ``GET /metrics``: JSON snapshot, or Prometheus text exposition under
      the same content negotiation as the replica server.
    - ``POST /admin/reload``: rolling fleet reload (loopback/bearer-token
      gated like the replica admin surface).
    """

    def __init__(
        self,
        replicas: Sequence[str],
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        probe_interval: float = 0.25,
        probe_timeout: float = 1.0,
        eject_threshold: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 8.0,
        chunk_tokens: int = 8,
        affinity_capacity: int = 4096,
        max_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        connect_timeout: float = 2.0,
        stream_timeout: float = 30.0,
        max_body_bytes: int = 1 << 20,
        admin_token: Optional[str] = None,
        obs_dir: Optional[str] = None,
        trace: bool = True,
        trace_capacity: int = 8192,
        clock=time.monotonic,
        disaggregate: str = "auto",
        migrate_drain: bool = True,
        scaler=None,
        autoscale_interval: float = 0.0,
        min_replicas: int = 1,
        max_replicas: int = 8,
        scale_up_queue: float = 4.0,
        scale_up_itl_ms: float = 0.0,
        scale_up_free_pages: int = 0,
        scale_down_active: int = 0,
        scale_patience: int = 3,
        scale_drain_timeout_s: float = 15.0,
        metrics_scrape_interval: float = 1.0,
        slo: Optional[Sequence] = None,
        slo_eval_interval: float = 0.5,
        tenant_ledger_capacity: int = 1024,
    ):
        self.clock = clock
        self.probe_timeout = probe_timeout
        self.max_attempts = max(1, int(max_attempts))
        self.retry_backoff_s = retry_backoff_s
        self.connect_timeout = connect_timeout
        self.stream_timeout = stream_timeout
        self.max_body_bytes = max_body_bytes
        self.admin_token = admin_token
        # disaggregated prefill/decode dispatch: "auto" engages whenever the
        # fleet advertises at least one prefill-role AND one decode-capable
        # replica on /healthz; "off" forces the classic single-replica path
        if disaggregate not in ("auto", "off"):
            raise ValueError("disaggregate must be auto|off")
        self.disaggregate = disaggregate
        # drain-as-migrate: rolling reload and autoscale retire ask the
        # replica to SHIP its live streams (zero-recompute handoff) instead
        # of waiting out every in-flight generation; the recompute resume
        # stays as the fallback when the source can't comply
        self.migrate_drain = bool(migrate_drain)
        # autoscaler: a control loop over the load signals every probe
        # already scrapes (queue depth, ITL EWMA, free_pages), acting
        # through ``scaler`` — an object with ``spawn() -> url`` and
        # ``retire(url)`` — and the same cordon/drain machinery the rolling
        # reload rides. Off unless both an interval and a scaler are given.
        self.scaler = scaler
        self.autoscale_interval = float(autoscale_interval)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.scale_up_queue = float(scale_up_queue)
        self.scale_up_itl_ms = float(scale_up_itl_ms)
        self.scale_up_free_pages = int(scale_up_free_pages)
        self.scale_down_active = int(scale_down_active)
        self.scale_patience = max(1, int(scale_patience))
        self.scale_drain_timeout_s = float(scale_drain_timeout_s)
        self._hot_ticks = 0
        self._idle_ticks = 0
        self.registry = ReplicaRegistry(
            replicas, clock=clock, probe_interval=probe_interval,
            eject_threshold=eject_threshold, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s,
        )
        self.affinity = PrefixAffinity(chunk_tokens, affinity_capacity)
        self.stats: Dict[str, int] = {
            "requests": 0,
            "streams": 0,
            "json_requests": 0,
            "tokens_relayed": 0,
            "routed": 0,
            "retries": 0,
            "failovers": 0,
            "resumed_streams": 0,
            "aborted_streams": 0,
            "dropped_streams": 0,
            "client_disconnects": 0,
            "rejected_no_replica": 0,
            "rejected_invalid": 0,
            "affinity_hits": 0,
            "affinity_misses": 0,
            "probes": 0,
            "probe_failures": 0,
            "ejections": 0,
            "recoveries": 0,
            "rolling_reloads": 0,
            "reload_steps": 0,
            "reload_failures": 0,
            # disaggregation / migration / autoscale counters
            "disagg_dispatches": 0,
            "disagg_fallbacks": 0,
            "migration_resumes": 0,
            "migrations_requested": 0,
            # tokens the RECOMPUTE fallback re-sent as prompt on a resume
            # hop (an attach resume adds 0 — the zero-replay proof pins
            # this counter)
            "resume_replayed_tokens": 0,
            "autoscale_ups": 0,
            "autoscale_downs": 0,
            "autoscale_aborts": 0,
            # fleet observability plane
            "metrics_scrapes": 0,
            "slo_evaluations": 0,
            "slo_fast_burns": 0,
            "stitched_traces": 0,
            # overload isolation plane: fleet-level quota and
            # brownout rejections at the front door, controller rung
            # transitions, tenant-affinity routing, and ledger-eviction
            # honesty (a silently dropped tenant row would under-bill)
            "rejected_quota": 0,
            "rejected_brownout": 0,
            "brownout_transitions": 0,
            "tenant_affinity_hits": 0,
            "tenant_affinity_misses": 0,
            "tenant_ledger_evictions": 0,
        }
        # handler threads bump stats concurrently; += on a dict entry is a
        # read-modify-write, so every increment goes through _bump
        self._stats_lock = threading.Lock()
        self.obs_dir = str(obs_dir) if obs_dir else None
        self.tracer = Tracer(enabled=trace, capacity=trace_capacity, clock=clock)
        self.metrics = Registry()
        self.flight = FlightRecorder(
            directory=self.obs_dir, tracer=self.tracer, clock=clock
        )
        # fleet observability plane: the per-replica /metrics
        # scrapes fold into fleet_* rollups, terminal-event cost ledgers
        # roll up per tenant, and the SLO engine evaluates declared
        # objectives over the aggregated streams on the obs loop
        self.metrics_scrape_interval = float(metrics_scrape_interval)
        self.aggregator = FleetAggregator()
        self.tenants = TenantLedger(
            capacity=tenant_ledger_capacity,
            on_evict=self._on_tenant_evicted,
        )
        self.slo_eval_interval = float(slo_eval_interval)
        # overload isolation plane: the QoS policy + brownout
        # config ride in the same dict as the SLO objectives (one file,
        # ``configs/slo_default.json``) — a plain objective list still
        # works and leaves the inert default policy in place
        qos_spec = slo.get("qos") if isinstance(slo, dict) else None
        brownout_spec = (
            slo.get("brownout") if isinstance(slo, dict) else None
        ) or {}
        self.qos = QosPolicy.from_config(qos_spec)
        # fleet-level tenant quotas: one bucket set at the front door,
        # scaled by the routable-replica count at take() time so fleet
        # allotment tracks fleet capacity
        self._fleet_buckets = TenantBuckets(self.qos)
        self.brownout = BrownoutController(
            calm_evals=int(brownout_spec.get("calm_evals", 3)),
        )
        protected = brownout_spec.get("protected_classes")
        self._brownout_protected: Tuple[str, ...] = tuple(
            protected if protected else ("gold", "standard")
        )
        # tenant -> replica-id routing affinity (LRU, same bound as the
        # prefix map); prefix affinity is more specific and wins
        self._tenant_affinity: OrderedDict = OrderedDict()
        self._tenant_affinity_capacity = max(1, int(affinity_capacity))
        self._tenant_aff_lock = threading.Lock()
        self.slo = self._build_slo(slo)
        self._slo_hot = False  # fast-burn up-signal the autoscaler consumes
        self._slo_lock = threading.Lock()
        self._obs_thread = threading.Thread(
            target=self._obs_loop, name="router-obs", daemon=True
        )
        self._register_exports()
        self._stop = threading.Event()
        self._reload_busy = threading.Lock()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True
        )
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, name="router-autoscale", daemon=True
        )
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
                elif path == "/slo":
                    # the declared objectives' verdict: budget remaining +
                    # burn rate per objective over the aggregated streams
                    self._json(200, outer.slo_snapshot())
                elif path == "/admin/trace":
                    if not outer._admin_allowed(self):
                        self._json(403, {"error": "admin endpoint: loopback "
                                                  "or bearer token required"})
                        return
                    self._json(*outer._admin_trace(query))
                elif path == "/metrics":
                    accept = self.headers.get("Accept") or ""
                    if (
                        "format=prometheus" in query
                        or "text/plain" in accept
                        or "openmetrics" in accept
                    ):
                        # router-local families + the fleet_* rollups the
                        # aggregator folded from the per-replica scrapes:
                        # ONE scrape sees the whole fleet
                        body = (
                            outer.metrics.render() + outer.aggregator.render()
                        ).encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json(200, outer.metrics_snapshot())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path not in (
                    "/generate", "/admin/reload", "/admin/brownout",
                ):
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if length < 0:
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if length > outer.max_body_bytes:
                    self.close_connection = True
                    self._json(413, {
                        "error": f"body exceeds {outer.max_body_bytes} bytes",
                    })
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._json(400, {"error": "malformed JSON body"})
                    return
                if not isinstance(req, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                if self.path.startswith("/admin/"):
                    if not outer._admin_allowed(self):
                        self._json(403, {"error": "admin endpoint: loopback "
                                                  "or bearer token required"})
                        return
                    if self.path == "/admin/brownout":
                        self._json(*outer._admin_brownout(req))
                    else:
                        self._json(*outer._admin_reload(req))
                else:
                    outer._generate(self, req)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # ------------------------------------------------------------- lifecycle

    def start(self, probe: bool = True) -> None:
        if probe and not self._probe_thread.ident:
            self._probe_thread.start()
        if probe and self._obs_enabled() and not self._obs_thread.ident:
            self._obs_thread.start()
        if self._autoscale_enabled() and not self._autoscale_thread.ident:
            self._autoscale_thread.start()
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http", daemon=True
        )
        self._server_thread.start()

    def serve_forever(self) -> None:
        if not self._probe_thread.ident:
            self._probe_thread.start()
        if self._obs_enabled() and not self._obs_thread.ident:
            self._obs_thread.start()
        if self._autoscale_enabled() and not self._autoscale_thread.ident:
            self._autoscale_thread.start()
        try:
            self._httpd.serve_forever()
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()  # release the listening socket

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """Block until at least one replica is routable (first probes have
        landed) or the timeout expires."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.registry.routable():
                return True
            time.sleep(0.01)
        return bool(self.registry.routable())

    # --------------------------------------------------------------- probing

    def _probe_loop(self) -> None:
        tick = min(self.registry.probe_interval / 4.0, 0.05)
        while not self._stop.wait(tick):
            for rep in self.registry.due():
                if self._stop.is_set():
                    return
                self.probe_once(rep.id)

    def probe_once(self, rid: str) -> bool:
        """One /healthz probe of one replica; folds the outcome into the
        registry and surfaces ejection/recovery events."""
        rep = self.registry.get(rid)
        self._bump("probes")
        ok, code, body = False, None, None
        conn = None
        t0 = self.clock()
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.probe_timeout
            )
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            code = resp.status
            body = json.loads(resp.read() or b"{}")
            ok = isinstance(body, dict)
        except (OSError, ValueError, http.client.HTTPException):
            ok = False
        finally:
            if conn is not None:
                conn.close()
        t1 = self.clock()
        if not ok:
            self._bump("probe_failures")
        self._registry_events(
            self.registry.observe_probe(rid, ok, code, body,
                                        rtt_window=(t0, t1))
        )
        return ok

    def _registry_events(self, events: List[Tuple[str, str]]) -> None:
        for name, rid in events:
            if name == "ejected":
                self._bump("ejections")
                self.affinity.forget_replica(rid)
                with self._tenant_aff_lock:
                    for t in [
                        t for t, r in self._tenant_affinity.items()
                        if r == rid
                    ]:
                        del self._tenant_affinity[t]
                self.flight.event("replica_ejected", replica=rid)
                # the post-mortem window: what the fleet looked like when
                # the replica dropped out (probe history, relay counters)
                self.flight.dump(
                    f"replica_ejected_{rid.replace(':', '_')}",
                    extra={"replica": rid, "registry": self.registry.snapshot()},
                )
            elif name == "recovered":
                self._bump("recoveries")
                self.flight.event("replica_recovered", replica=rid)

    # ---------------------------------------------- fleet observability plane

    def _obs_enabled(self) -> bool:
        return self.metrics_scrape_interval > 0

    def _obs_loop(self) -> None:
        """Scrape every routable replica's /metrics into the aggregator,
        then evaluate the SLO engine over the fresh rollups — one loop so
        an evaluation never reads half-updated aggregates."""
        last_eval = 0.0
        while not self._stop.wait(self.metrics_scrape_interval):
            try:
                self.scrape_fleet_metrics()
                now = self.clock()
                if self.slo is not None and (
                    now - last_eval >= self.slo_eval_interval
                ):
                    last_eval = now
                    self.brownout_tick(self.evaluate_slo())
            except Exception:  # noqa: BLE001 — the obs loop must outlive any one bad scrape
                self.flight.event("obs_loop_error")

    def scrape_fleet_metrics(self) -> int:
        """One aggregation pass: GET /metrics (Prometheus text) from every
        routable replica, fold into the aggregator, and drop replicas that
        left the registry. Returns how many scrapes landed."""
        live = {r.id: r for r in self.registry.routable()}
        for rid in self.aggregator.replicas():
            if rid not in self.registry.replicas:
                self.aggregator.drop(rid)
        landed = 0
        for rid, rep in live.items():
            conn = None
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=self.probe_timeout
                )
                conn.request(
                    "GET", "/metrics?format=prometheus",
                    headers={"Accept": "text/plain;version=0.0.4"},
                )
                resp = conn.getresponse()
                text = resp.read().decode("utf-8", "replace")
                if resp.status == 200:
                    self.aggregator.update(rid, rep.role, text)
                    landed += 1
            except (OSError, http.client.HTTPException):
                pass  # probe failures own reachability; a missed scrape just ages the rollup
            finally:
                if conn is not None:
                    conn.close()
        if landed:
            self._bump("metrics_scrapes", landed)
        return landed

    def _build_slo(self, spec) -> Optional[SLOEngine]:
        """The SLO engine from declared objectives: None/default list,
        dicts (config file shape), or ready Objective instances. An empty
        sequence disables SLO evaluation."""
        if spec is None:
            objectives = default_objectives()
        elif isinstance(spec, dict):
            # config-file shape: {"qos": ..., "brownout": ..., "objectives":
            # [...]} — the qos/brownout blocks were consumed in __init__
            objectives = parse_slo_config(spec)
            if not objectives:
                return None
        elif not spec:
            return None
        elif all(isinstance(o, Objective) for o in spec):
            objectives = list(spec)
        else:
            objectives = parse_slo_config(list(spec))
        engine = SLOEngine(clock=self.clock)
        for obj in objectives:
            engine.add_objective(obj, self._bind_slo_source(obj))
        engine.on_fast_burn(self._on_slo_fast_burn)
        return engine

    def _bind_slo_source(self, obj: Objective):
        """(bad, total) cumulative source for one declared metric: latency
        objectives read the fleet-merged histograms (aggregated streams),
        availability and dropped_streams read the router's own counters."""
        # a qos_class binds the objective to that class's OWN histogram
        # stream (``serve_ttft_seconds_gold``) — the engine emits one
        # family per declared class, and the aggregator merges any family
        # name, so a per-class objective needs no aggregator changes
        suffix = f"_{obj.qos_class}" if obj.qos_class else ""
        if obj.metric == "ttft_p99":
            return lambda: self._latency_source(
                f"serve_ttft_seconds{suffix}", obj.threshold_s
            )
        if obj.metric == "itl_p99":
            return lambda: self._latency_source(
                f"serve_itl_seconds{suffix}", obj.threshold_s
            )
        if obj.metric == "availability":
            def availability():
                with self._stats_lock:
                    total = self.stats["requests"]
                    bad = self.stats["rejected_no_replica"]
                return (bad, total)
            return availability
        if obj.metric == "dropped_streams":
            def dropped():
                with self._stats_lock:
                    return (self.stats["dropped_streams"],
                            max(1, self.stats["streams"]))
            return dropped
        raise ValueError(f"no source for SLO metric {obj.metric!r}")

    def _latency_source(self, family: str, threshold_s: float):
        gt = self.aggregator.good_total_below(family, threshold_s)
        if gt is None:
            return None  # no replica scrape yet; the objective waits
        good, total = gt
        return (total - good, total)

    def evaluate_slo(self) -> Dict[str, Any]:
        """One SLO evaluation over the current aggregates (the obs loop's
        cadence; tests call it directly). Returns the /slo payload."""
        if self.slo is None:
            return {"objectives": {}, "verdict": "disabled", "evaluated": 0,
                    "window_clipped": True}
        self._bump("slo_evaluations")
        return self.slo.evaluate()

    def slo_snapshot(self) -> Dict[str, Any]:
        if self.slo is None:
            return {"objectives": {}, "verdict": "disabled", "evaluated": 0,
                    "window_clipped": True}
        return self.slo.snapshot()

    def _on_slo_fast_burn(self, obj: Objective, snap: Dict[str, Any]) -> None:
        """Fast burn = the error budget dies in hours: fire the EXISTING
        machinery — a flight-recorder dump with the fleet snapshot (the
        3am post-mortem), an event the autoscaler consumes as an up-signal
        on its next tick, and the engine's own loud log."""
        self._bump("slo_fast_burns")
        with self._slo_lock:
            self._slo_hot = True
        self.flight.event("slo_fast_burn", objective=obj.name, **{
            k: v for k, v in snap.items() if not isinstance(v, dict)
        })
        self.flight.dump(
            f"slo_fast_burn_{obj.name}",
            extra={
                "objective": obj.name,
                "snapshot": snap,
                "registry": self.registry.snapshot(),
                "slo": self.slo.snapshot() if self.slo else {},
            },
        )

    def consume_slo_hot(self) -> bool:
        """Autoscaler side of the up-signal: reads AND clears the flag so
        one burn episode contributes one round of up-pressure."""
        with self._slo_lock:
            hot, self._slo_hot = self._slo_hot, False
        return hot

    # ------------------------------------------------ fleet brownout control

    def _brownout_hot(self, evaluation: Dict[str, Any]) -> bool:
        """One evaluation's verdict for the brownout ladder: a PROTECTED
        class's own objective is burning fast or violated. Fleet-wide
        (classless) objectives feed the autoscaler, not the ladder — the
        ladder exists to sacrifice batch for gold, and only a per-class
        signal says WHO is hurting."""
        for snap in (evaluation.get("objectives") or {}).values():
            if (
                snap.get("qos_class") in self._brownout_protected
                and snap.get("state") in ("fast_burn", "violated")
            ):
                return True
        return False

    def brownout_tick(self, evaluation: Dict[str, Any]) -> None:
        """One controller step, driven by the obs loop right after each
        SLO evaluation (tests call it directly with a synthetic payload).
        Escalations and reverts both propagate to every routable replica;
        a non-normal rung is also re-asserted each tick so a replica that
        restarted (back at ``normal``) reconverges without an event."""
        transition = self.brownout.observe(self._brownout_hot(evaluation))
        if transition is not None:
            old, new = transition
            self._bump("brownout_transitions")
            self.flight.event("fleet_brownout", old=old, new=new,
                              rung_index=self.brownout.rung_index)
            if rung_at_least(new, "shrink_batch") and not rung_at_least(
                old, "shrink_batch"
            ):
                # crossing into actively degrading batch output is the
                # post-mortem-worthy moment — dump the fleet state once
                self.flight.dump(f"fleet_brownout_{new}", extra={
                    "old": old, "new": new,
                    "registry": self.registry.snapshot(),
                    "slo": self.slo.snapshot() if self.slo else {},
                })
        if transition is not None or self.brownout.rung_index > 0:
            self._push_brownout(self.brownout.rung)

    def _push_brownout(self, rung: str) -> None:
        """POST the current rung to every routable replica (idempotent on
        the replica side). A replica that misses the push converges on the
        next tick; an unreachable one is the probe loop's problem."""
        for rep in self.registry.routable():
            try:
                self._post_replica(
                    rep, "/admin/brownout", {"rung": rung},
                    timeout=self.probe_timeout,
                )
            except (OSError, http.client.HTTPException):
                pass

    def _admin_brownout(self, req: dict):
        """(code, body) for POST /admin/brownout on the ROUTER: operator
        override of the fleet rung (``{"rung": "normal"}`` clears it).
        The forced rung propagates immediately; the controller keeps
        running from there, so sustained calm still walks it back."""
        rung = req.get("rung")
        if not isinstance(rung, str):
            return 400, {"error": "rung must be a string"}
        try:
            transition = self.brownout.force(rung)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        if transition is not None:
            old, new = transition
            self._bump("brownout_transitions")
            self.flight.event("fleet_brownout_forced", old=old, new=new)
        self._push_brownout(self.brownout.rung)
        return 200, self.brownout.snapshot()

    def _on_tenant_evicted(self, tenant: str) -> None:
        """TenantLedger capacity-eviction honesty: a
        dropped rollup row is a billing gap — count it and leave a
        flight-recorder breadcrumb naming the tenant."""
        self._bump("tenant_ledger_evictions")
        self.flight.event("tenant_ledger_evicted", tenant=tenant)

    # ---- cross-process trace stitching

    def fetch_replica_spans(
        self, rep: Replica, request_id: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """One replica's span tail (GET /admin/spans) — None when the
        replica is unreachable or does not serve spans (a stub fleet
        member mid-upgrade): stitching degrades to fewer tracks, never
        fails the request."""
        conn = None
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.probe_timeout
            )
            path = "/admin/spans"
            if request_id:
                path += f"?request_id={request_id}"
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            doc = json.loads(body or b"{}")
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            if conn is not None:
                conn.close()

    def merged_trace(self, request_id: Optional[str] = None) -> Dict[str, Any]:
        """ONE Perfetto document for a request (or the whole recent window
        with ``request_id=None``): the router's spans as the reference
        track plus every reachable replica's span tail, each replica's
        timestamps corrected by its probe-estimated clock offset onto the
        router clock, one pid per process. This is the artifact that makes
        a disaggregated request's latency readable — router, prefill,
        ship, decode, and attach hops on separate tracks of one timeline."""
        groups: List[Dict[str, Any]] = [{
            "process": "router",
            "offset_s": 0.0,
            "spans": self.tracer.track_dicts(track=request_id),
        }]
        for rep in list(self.registry.replicas.values()):
            doc = self.fetch_replica_spans(rep, request_id)
            if doc is None:
                continue
            spans = doc.get("spans") or []
            if not spans:
                continue
            groups.append({
                "process": f"{doc.get('role', rep.role)}:{rep.id}",
                "offset_s": rep.clock_offset_s,
                "spans": spans,
            })
        self._bump("stitched_traces")
        merged = stitch_spans(groups)
        if request_id:
            merged["otherData"]["request_id"] = request_id
            merged["otherData"]["stitch"] = verify_stitched(
                merged, request_id, slack_s=self._stitch_slack_s()
            )
        return merged

    def _stitch_slack_s(self) -> float:
        """Orphan/ordering tolerance for stitched traces: the clock-offset
        error bar is rtt/2 per replica — use the worst live estimate,
        floored at 50 ms (scheduler jitter on loaded boxes)."""
        rtts = [
            r.clock_rtt_s for r in self.registry.replicas.values()
            if r.clock_rtt_s != float("inf")
        ]
        return max(0.05, max(rtts) / 2.0 if rtts else 0.0)

    def export_merged_trace(
        self, path: str, request_id: Optional[str] = None,
    ) -> str:
        from zero_transformer_tpu_torch.obs.fleet import write_trace

        return write_trace(path, self.merged_trace(request_id))

    def verify_run_traces(self) -> Dict[str, Any]:
        """Per-run stitched-trace verification: one merged doc for the
        whole recent window, then every request id with a ``route`` root
        checked for coverage / orphans / hop order."""
        doc = self.merged_trace()
        slack = self._stitch_slack_s()
        rids = request_ids_in(doc)
        checks = {
            rid: verify_stitched(doc, rid, slack_s=slack) for rid in rids
        }
        return {
            "requests": len(rids),
            "coverage_min": min(
                (c["coverage"] for c in checks.values()), default=0.0
            ),
            "orphans": sum(c["orphans"] for c in checks.values()),
            "hops_ordered": all(
                c["hops_ordered"] for c in checks.values()
            ) if checks else False,
            "per_request": checks,
        }

    def _admin_trace(self, query: str):
        """(code, body) for GET /admin/trace?request_id=<rid>: the merged
        fleet trace (Perfetto JSON) for one request, stitch verification
        included in otherData."""
        from urllib.parse import parse_qs

        rid = (parse_qs(query).get("request_id") or [None])[0]
        if not rid:
            return 400, {"error": "request_id is required"}
        return 200, self.merged_trace(_clean_rid(rid))

    # --------------------------------------------------------------- routing

    def _route(
        self, tokens: Optional[Sequence[int]], exclude: Set[str],
        tenant: Optional[str] = None,
    ) -> Optional[Replica]:
        # prefill-role replicas never take a whole request (their engine
        # rejects anything without a decode target) — the classic path and
        # the recompute fallback route only to decode-capable replicas
        candidates = [
            r for r in self.registry.routable()
            if r.id not in exclude and r.role != "prefill"
        ]
        chunk = self.affinity.chunk_tokens
        affine = tokens is not None and chunk >= 1 and len(tokens) >= chunk
        prefix_aff = self.affinity.lookup(tokens)
        # tenant affinity: a tenant with no prefix match still
        # lands on its last replica — its per-tenant state there (prefix
        # cache, warm pages) keeps paying off, and a flooding tenant's
        # damage stays concentrated instead of smeared fleet-wide. Prefix
        # affinity is more specific and wins when both exist. The
        # anonymous pool is excluded: pinning all untagged traffic to one
        # replica would defeat least-loaded balancing.
        named = tenant is not None and tenant != "anon"
        tenant_aff = None
        aff = prefix_aff
        if aff is None and named:
            tenant_aff = self._tenant_affinity_lookup(tenant)
            aff = tenant_aff
        rep = pick_replica(candidates, aff)
        if rep is not None:
            if affine:
                if prefix_aff == rep.id:
                    self._bump("affinity_hits")
                else:
                    self._bump("affinity_misses")
                self.affinity.record(tokens, rep.id)
            if named:
                if tenant_aff is not None:
                    self._bump(
                        "tenant_affinity_hits" if tenant_aff == rep.id
                        else "tenant_affinity_misses"
                    )
                self._tenant_affinity_record(tenant, rep.id)
            self._bump("routed")
        return rep

    def _tenant_affinity_lookup(self, tenant: str) -> Optional[str]:
        with self._tenant_aff_lock:
            return self._tenant_affinity.get(tenant)

    def _tenant_affinity_record(self, tenant: str, rid: str) -> None:
        with self._tenant_aff_lock:
            self._tenant_affinity[tenant] = rid
            self._tenant_affinity.move_to_end(tenant)
            while len(self._tenant_affinity) > self._tenant_affinity_capacity:
                self._tenant_affinity.popitem(last=False)

    # ------------------------------------------- disaggregated dispatch

    def _disagg_enabled(self) -> bool:
        """True when the fleet can split a request by phase: at least one
        prefill-role replica AND one decode-capable one in rotation."""
        if self.disaggregate == "off":
            return False
        reps = self.registry.routable()
        return any(r.role == "prefill" for r in reps) and any(
            r.role != "prefill" for r in reps
        )

    def _plan_disagg(
        self, tokens: Optional[Sequence[int]]
    ) -> Optional[Tuple[Replica, Replica]]:
        """(prefill replica, decode replica) for a fresh request: admission
        is prefix-affine WITHIN the prefill pool (its chunk cache is what
        affinity is for); decode placement goes where the pages fit best —
        most free_pages, then lowest ITL EWMA (both scraped on /healthz)."""
        reps = self.registry.routable()
        prefills = [r for r in reps if r.role == "prefill"]
        # pages can only land on a paged-layout engine with a MATCHING
        # draft_k (prefill replicas never speculate, so their handoffs
        # carry draft_k 0): a slab or speculative replica in the fleet
        # must not silently turn every handoff into a failed ship +
        # recompute fallback
        decodes = [
            r for r in reps
            if r.role != "prefill" and r.importable and r.draft_k == 0
        ]
        if not prefills or not decodes:
            return None
        aff = self.affinity.lookup(tokens) if tokens is not None else None
        P = pick_replica(prefills, aff)
        D = pick_decode_replica(decodes)
        if P is None or D is None:
            return None
        return P, D

    def _replica_for_url(self, url: str) -> Replica:
        """The registry's replica for a ``migrated_to`` URL, or an ad-hoc
        row when the target is outside the registry (still relayed — the
        page shipper trusted it, so the attach must follow the pages)."""
        rid, host, port = _parse_url(url)
        rep = self.registry.replicas.get(rid)
        if rep is None:
            rep = Replica(id=rid, url=url, host=host, port=port, state=READY)
        return rep

    def _disagg_dispatch(
        self, P: Replica, D: Replica, req: dict, rid: str, state: dict,
    ) -> Tuple[bool, str]:
        """Phase 1 of the split request: a prefill-only JSON dispatch to
        ``P`` naming ``D`` as the page target. On success the stream's next
        hop is an ATTACH at the decode replica (``state['attach']``); any
        failure degrades to the classic path (False, reason)."""
        body = dict(req)
        body.pop("request_id", None)
        body["stream"] = False
        body["prefill_to"] = (
            D.url if "//" in D.url else f"http://{D.url}"
        )
        self.registry.inc_relay(P.id)
        hop0 = self.clock()
        hop_idx = state.get("hops", 0)
        state["hops"] = hop_idx + 1
        state.setdefault("replica_ids", []).append(P.id)
        status: Optional[int] = None
        try:
            status, doc = self._post_replica(P, "/generate", body, rid=rid,
                                             hop=hop_idx)
        except (OSError, http.client.HTTPException) as exc:
            self._registry_events(
                self.registry.observe_relay_failure(P.id, str(exc))
            )
            return False, f"prefill replica {P.id} failed: {exc}"
        finally:
            self.registry.dec_relay(P.id)
            self.tracer.add("relay", rid, hop0, self.clock(), {
                "replica": P.id, "mode": "prefill", "hop": hop_idx,
                "status": status if status is not None else "dead",
            })
        if status == 200 and doc.get("status") == "migrated" and doc.get(
            "migrated_to"
        ):
            if req.get("tokens") is not None:
                # prefill affinity: the NEXT prompt sharing this prefix
                # should land on the same prefill replica's chunk cache
                self.affinity.record(req["tokens"], P.id)
            state["attach"] = str(doc["migrated_to"])
            self._bump("disagg_dispatches")
            self._bump("routed")
            return True, ""
        return False, (
            f"prefill dispatch to {P.id} returned {status}: "
            f"{doc.get('error', doc.get('status', ''))}"
        )

    def _attach_collect(
        self, url: str, rid: str, hop: int = 0
    ) -> Tuple[List[int], Optional[dict]]:
        """Attach to an imported stream and collect it wholesale (the JSON
        non-stream path's tail of a migrated request)."""
        rep = self._replica_for_url(url)
        conn = None
        try:
            conn = self._connect(rep)
            conn.request(
                "POST", "/attach", json.dumps({"request_id": rid}),
                {"Content-Type": "application/json", "X-Request-Id": rid,
                 "X-Trace-Hop": str(hop)},
            )
            resp = conn.getresponse()
            if resp.status != 200:
                return [], None
            ids: List[int] = []
            texts: List[str] = []
            while True:
                line = resp.readline()
                if not line:
                    return ids, None
                if not line.startswith(b"data: "):
                    continue
                event = json.loads(line[6:])
                if event.get("done"):
                    event["text"] = "".join(texts) if texts else event.get(
                        "text", ""
                    )
                    return ids, event
                if "token" in event:
                    ids.append(int(event["token"]))
                if event.get("text"):
                    texts.append(str(event["text"]))
        except (OSError, ValueError, http.client.HTTPException):
            return [], None
        finally:
            if conn is not None:
                conn.close()

    # ---------------------------------------------------------------- health

    def _healthz(self):
        routable = self.registry.routable()
        alive = self._probe_thread.is_alive() or not self._probe_thread.ident
        ok = bool(routable) and alive
        return (200 if ok else 503), {
            "status": "ok" if ok else (
                "no_routable_replicas" if alive else "probe thread dead"
            ),
            "routable": len(routable),
            "replicas": self.registry.snapshot(),
            "rolling_reload_active": self._reload_busy.locked(),
            # fleet brownout state: visible on the same poll every LB and
            # operator already watches — rung changes are never silent
            "brownout_rung": self.brownout.rung,
            "brownout": self.brownout.snapshot(),
        }

    def _admin_allowed(self, handler) -> bool:
        peer = handler.client_address[0]
        if peer in ("127.0.0.1", "::1", "::ffff:127.0.0.1"):
            return True
        if self.admin_token:
            auth = handler.headers.get("Authorization", "")
            return auth == f"Bearer {self.admin_token}"
        return False

    # --------------------------------------------------------------- metrics

    def metrics_snapshot(self) -> Dict[str, Any]:
        with self._stats_lock:
            snap: Dict[str, Any] = dict(self.stats)
        aff_total = snap["affinity_hits"] + snap["affinity_misses"]
        snap["routable_replicas"] = len(self.registry.routable())
        snap["affinity_hit_rate"] = (
            snap["affinity_hits"] / aff_total if aff_total else 0.0
        )
        snap["replicas"] = self.registry.snapshot()
        snap["tenants"] = self.tenants.snapshot()
        snap["slo_verdict"] = (
            self.slo.snapshot()["verdict"] if self.slo is not None
            else "disabled"
        )
        snap["brownout_rung"] = self.brownout.rung
        snap["qos_classes"] = self.qos.snapshot()
        return snap

    def _register_exports(self) -> None:
        reg = self.metrics
        for key, help_text in (
            ("requests", "Requests received by the router"),
            ("tokens_relayed", "Tokens relayed to clients"),
            ("routed", "Routing decisions made"),
            ("retries", "Pre-stream retries (connect/5xx/backpressure)"),
            ("failovers", "Replica failovers (mid-stream + pre-stream)"),
            ("resumed_streams", "Streams resumed on a survivor mid-generation"),
            ("aborted_streams", "Streams terminated with a retryable error event"),
            ("dropped_streams", "Streams left without a terminal event (must stay 0)"),
            ("client_disconnects", "Client-side disconnects mid-stream"),
            ("rejected_no_replica", "Requests rejected: no routable replica"),
            ("affinity_hits", "Prefix-affinity routing hits"),
            ("affinity_misses", "Prefix-affinity routing misses"),
            ("probes", "Health probes sent"),
            ("probe_failures", "Health probes that failed"),
            ("ejections", "Replica ejections"),
            ("recoveries", "Replica recoveries after ejection"),
            ("rolling_reloads", "Rolling fleet reloads started"),
            ("reload_steps", "Per-replica rolling-reload steps completed"),
            ("reload_failures", "Per-replica rolling-reload steps failed"),
            ("disagg_dispatches", "Requests split prefill/decode by phase"),
            ("disagg_fallbacks", "Disagg dispatches degraded to the classic path"),
            ("migration_resumes", "Streams attach-resumed after a migration"),
            ("migrations_requested", "Streams asked to migrate (drain/retire)"),
            ("resume_replayed_tokens",
             "Tokens re-sent as prompt by the recompute fallback (attach adds 0)"),
            ("autoscale_ups", "Replicas spawned by the autoscaler"),
            ("autoscale_downs", "Replicas retired by the autoscaler"),
            ("autoscale_aborts", "Scale-downs aborted over undrainable streams"),
            ("metrics_scrapes", "Per-replica /metrics scrapes folded into the fleet rollups"),
            ("slo_evaluations", "SLO engine evaluation passes"),
            ("slo_fast_burns", "SLO fast-burn escalations fired"),
            ("stitched_traces", "Merged fleet traces assembled"),
            ("rejected_quota", "Requests rejected: fleet tenant quota"),
            ("rejected_brownout", "Requests rejected: fleet brownout"),
            ("brownout_transitions", "Fleet brownout rung transitions"),
            ("tenant_affinity_hits", "Tenant-affinity routing hits"),
            ("tenant_affinity_misses", "Tenant-affinity routing misses"),
            ("tenant_ledger_evictions",
             "Tenant rollup rows evicted at ledger capacity"),
        ):
            reg.counter_func(
                f"router_{key}", help_text, (lambda k=key: self.stats[k])
            )
        reg.gauge_func(
            "router_routable_replicas", "Replicas currently in rotation",
            lambda: len(self.registry.routable()),
        )
        reg.gauge_func(
            "router_brownout_rung",
            "Fleet brownout rung index (0=normal .. 3=suspend_batch)",
            lambda: self.brownout.rung_index,
        )
        # bounded-ring honesty, fleet-standard name: the
        # router's own trace truncation is as silent-failure-prone as a
        # replica's
        reg.gauge_func(
            "obs_spans_dropped",
            "Spans dropped by ring overflow (trace truncation honesty)",
            lambda: self.tracer.dropped,
        )
        # SLO engine exposition: one labeled series per declared objective
        # (values read from the last evaluation — a scrape never triggers
        # an evaluation of its own)

        def slo_rows(field: str):
            if self.slo is None:
                return []
            snap = self.slo.snapshot()
            return [
                ({"objective": name}, obj[field])
                for name, obj in sorted(snap["objectives"].items())
            ]

        reg.gauge_func(
            "slo_budget_remaining",
            "Error budget remaining per objective (1 = untouched)",
            lambda: slo_rows("budget_remaining"),
        )
        reg.gauge_func(
            "slo_burn_rate_short",
            "Burn rate over the objective's short window",
            lambda: slo_rows("burn_rate_short"),
        )
        reg.gauge_func(
            "slo_burn_rate_long",
            "Burn rate over the objective's long window",
            lambda: slo_rows("burn_rate_long"),
        )
        reg.gauge_func(
            "slo_fast_burn",
            "1 while the objective is fast-burning",
            lambda: [
                (labels, 1 if state == "fast_burn" else 0)
                for labels, state in slo_rows("state")
            ],
        )
        reg.gauge_func(
            "slo_violated",
            "1 while any objective is burning or out of budget",
            lambda: (
                1 if self.slo is not None
                and self.slo.snapshot()["verdict"] == "violated" else 0
            ),
        )
        # per-tenant cost rollups (the capacity-planning scrape)
        for field, help_text in (
            ("requests", "Requests completed per tenant"),
            ("tokens_relayed", "Tokens relayed per tenant"),
            ("pages_held_ticks", "KV page x tick capacity consumed per tenant"),
            ("decode_ticks", "Decode ticks consumed per tenant"),
            ("migrations", "Stream migrations per tenant"),
        ):
            reg.counter_func(
                f"router_tenant_{field}", help_text,
                (lambda f=field: self.tenants.samples(f)),
            )
        # the four per-replica families share ONE registry snapshot per
        # scrape: render() calls the callbacks in registration order, so the
        # first (router_replica_up) refreshes the cell and the other three
        # reuse it — keep these four registrations together and in order
        snap_cell: Dict[str, Any] = {}

        def fleet(refresh: bool = False) -> Dict[str, Any]:
            if refresh or "snap" not in snap_cell:
                snap_cell["snap"] = self.registry.snapshot()
            return snap_cell["snap"]

        reg.gauge_func(
            "router_replica_up", "1 while the replica is in rotation",
            lambda: [
                ({"replica": rid}, 1 if info["state"] in (READY, DEGRADED)
                 and not info["cordoned"] else 0)
                for rid, info in fleet(refresh=True).items()
            ],
        )
        reg.gauge_func(
            "router_replica_queue_depth", "Scraped per-replica queue depth",
            lambda: [
                ({"replica": rid}, info["queue_depth"])
                for rid, info in fleet().items()
            ],
        )
        reg.gauge_func(
            "router_replica_active_relays",
            "Router-side in-flight relays per replica",
            lambda: [
                ({"replica": rid}, info["active_relays"])
                for rid, info in fleet().items()
            ],
        )
        reg.counter_func(
            "router_replica_tokens_relayed", "Tokens relayed per replica",
            lambda: [
                ({"replica": rid}, info["tokens_relayed"])
                for rid, info in fleet().items()
            ],
        )
        # engine page-pool stats mirrored fleet-wide: every scrape of the
        # router shows per-replica KV pressure and migration load
        reg.gauge_func(
            "router_replica_free_pages", "Scraped per-replica free KV pages",
            lambda: [
                ({"replica": rid}, info["free_pages"])
                for rid, info in fleet().items()
            ],
        )
        reg.counter_func(
            "router_replica_page_faults", "Scraped per-replica page faults",
            lambda: [
                ({"replica": rid}, info["page_faults"])
                for rid, info in fleet().items()
            ],
        )
        reg.counter_func(
            "router_replica_cow_copies",
            "Scraped per-replica copy-on-write page copies",
            lambda: [
                ({"replica": rid}, info["cow_copies"])
                for rid, info in fleet().items()
            ],
        )
        reg.gauge_func(
            "router_replica_migrations_in_flight",
            "Scraped per-replica in-flight page shipments",
            lambda: [
                ({"replica": rid}, info["migrations_in_flight"])
                for rid, info in fleet().items()
            ],
        )

    # ----------------------------------------------------------------- relay

    def _connect(self, rep: Replica) -> http.client.HTTPConnection:
        """Connect with the short connect timeout, then widen the socket
        timeout to the stream budget (a healthy replica may legitimately
        take longer between tokens than it may take to accept a TCP
        connection)."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=self.connect_timeout
        )
        conn.connect()
        conn.sock.settimeout(self.stream_timeout)
        return conn

    def _post_replica(
        self, rep: Replica, path: str, body: dict,
        rid: Optional[str] = None, timeout: Optional[float] = None,
        hop: Optional[int] = None,
    ) -> Tuple[int, dict]:
        """Small JSON POST helper (admin + probe paths, not the relay)."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=timeout or self.stream_timeout
        )
        try:
            headers = {"Content-Type": "application/json"}
            if rid:
                headers["X-Request-Id"] = rid
            if hop is not None:
                headers["X-Trace-Hop"] = str(hop)
            conn.request("POST", path, json.dumps(body), headers)
            resp = conn.getresponse()
            payload = resp.read()
            try:
                doc = json.loads(payload or b"{}")
            except ValueError:
                doc = {"error": "unparseable replica response"}
            # the replica advertises its backoff as an HTTP header, not a
            # body field — fold it in so _retry_after_of sees it
            ra = resp.getheader("Retry-After")
            if ra is not None and "retry_after" not in doc:
                doc["retry_after"] = ra
            return resp.status, doc
        finally:
            conn.close()

    def _generate(self, handler, req: dict) -> None:
        rid = _clean_rid(
            handler.headers.get("X-Request-Id") or req.get("request_id")
        )
        self._bump("requests")
        tokens = req.get("tokens")
        if tokens is not None:
            try:
                tokens = [int(t) for t in tokens]
                req = {**req, "tokens": tokens}
            except (TypeError, ValueError):
                self._bump("rejected_invalid")
                handler._json(400, {"error": "tokens must be integers",
                                    "request_id": rid},
                              headers={"X-Request-Id": rid})
                return
        # the numeric fields the ROUTER itself does arithmetic on (resume
        # budgets, deadline shrinking) must parse here: a malformed value
        # raising mid-relay would tear the connection with no response and
        # pollute dropped_streams — the counter the chaos proofs pin to 0
        try:
            req = {**req, "max_new_tokens": int(req.get("max_new_tokens", 32))}
            if "timeout" in req:
                req["timeout"] = float(req["timeout"])
        except (TypeError, ValueError):
            self._bump("rejected_invalid")
            handler._json(400, {
                "error": "max_new_tokens/timeout must be numeric",
                "request_id": rid,
            }, headers={"X-Request-Id": rid})
            return
        # tenant key for the cost-ledger rollup and the quota/affinity
        # planes (header wins over body field; absent traffic pools under
        # "anon"); the QoS class rides the same precedence, normalized so
        # an unknown class degrades to default service, never a 400
        tenant = str(
            handler.headers.get("X-Tenant-Key") or req.get("tenant") or "anon"
        )[:64]
        qos_name = self.qos.normalize(
            handler.headers.get("X-QoS-Class") or req.get("qos")
        )
        # tenant + class ride the relay BODY: _hop_body forwards dict(req)
        # verbatim, so the replica's own admission sees the same identity
        req = {**req, "tenant": tenant, "qos": qos_name}
        cls = self.qos.classes[qos_name]
        # fleet brownout, final rung: the lowest class is suspended at the
        # front door — no replica dispatch, class-aware Retry-After
        if rung_at_least(self.brownout.rung, "suspend_batch") and (
            self.qos.rank(qos_name) == len(self.qos.names()) - 1
        ):
            self._bump("rejected_brownout")
            handler._json(503, {
                "error": (
                    f"fleet brownout ({self.brownout.rung}): {qos_name} "
                    "admission suspended; retry later"
                ),
                "status": "rejected", "request_id": rid,
            }, headers={
                "Retry-After": str(max(1, math.ceil(cls.retry_after_s))),
                "X-Request-Id": rid,
            })
            return
        # fleet-level tenant quota: the per-class bucket scaled by current
        # routable capacity — one tenant's flood burns its own allotment
        # before any replica queue sees it
        quota_wait = self._fleet_buckets.take(
            tenant, qos_name,
            len(req.get("tokens") or ()) + int(req.get("max_new_tokens", 32)),
            self.clock(),
            scale=max(1, len(self.registry.routable())),
        )
        if quota_wait > 0:
            self._bump("rejected_quota")
            handler._json(429, {
                "error": (
                    f"tenant quota exhausted ({qos_name}); retry later"
                ),
                "status": "rejected", "request_id": rid,
            }, headers={
                "Retry-After": str(max(1, math.ceil(quota_wait))),
                "X-Request-Id": rid,
            })
            return
        if req.get("stream", True):
            self._bump("streams")
            state = {"ids": [], "texts": [], "terminal": False,
                     "headers_sent": False, "failover_count": 0,
                     "hops": 0, "replica_ids": [], "ledger": None,
                     "replayed": 0, "tenant": tenant}
            try:
                self._relay_stream(handler, req, rid, state)
            finally:
                if not state["terminal"]:
                    # every exit path above must have delivered a terminal
                    # event (done, error event, or observed client
                    # disconnect); anything else is a DROPPED stream — the
                    # counter the chaos proofs pin to zero
                    self._bump("dropped_streams")
        else:
            self._bump("json_requests")
            self._relay_json(handler, req, rid, tenant=tenant)

    # ---- JSON (non-stream) relay: nothing reaches the client until the
    # replica's full response is in hand, so every failure mode is a safe
    # wholesale retry on another replica.

    def _relay_json(self, handler, req: dict, rid: str,
                    tenant: str = "anon") -> None:
        t0 = self.clock()
        tried: Set[str] = set()
        retry_after = 1.0
        last_error = "no routable replica"
        hops = 0
        failovers = 0
        attach_hops = 0
        for attempt in range(self.max_attempts):
            rep = self._route(req.get("tokens"), tried,
                              tenant=req.get("tenant"))
            if rep is None:
                break
            tried.add(rep.id)
            self.registry.inc_relay(rep.id)
            hop0 = self.clock()
            hop_idx = hops
            hops += 1
            status, doc, dead = None, None, None
            try:
                code_doc = self._post_replica(rep, "/generate", req, rid=rid,
                                              hop=hop_idx)
                status, doc = code_doc
            except (OSError, http.client.HTTPException) as exc:
                dead = f"{type(exc).__name__}: {exc}"
            finally:
                self.registry.dec_relay(rep.id)
                self.tracer.add("relay", rid, hop0, self.clock(), {
                    "replica": rep.id, "mode": "json", "hop": hop_idx,
                    "status": status if status is not None else "dead",
                })
            if dead is not None:
                self._registry_events(
                    self.registry.observe_relay_failure(rep.id, dead)
                )
                self._bump("failovers")
                failovers += 1
                last_error = f"replica {rep.id} failed: {dead}"
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                continue
            if status in (429, 503):
                retry_after = max(retry_after, _retry_after_of(doc))
                self._bump("retries")
                last_error = str(doc.get("error", f"replica {status}"))
                continue
            if status >= 500:
                # replica-side failure (500/502/504...): nothing reached the
                # client — retry elsewhere, with suspicion like a dead socket
                self._registry_events(
                    self.registry.observe_relay_failure(
                        rep.id, f"replica {status}"
                    )
                )
                self._bump("failovers")
                failovers += 1
                last_error = str(doc.get("error", f"replica {status}"))
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                continue
            if status == 200 and doc.get("status") == "failed":
                # the replica admitted, then its engine failed the request
                # retryably (tick fault); nothing reached the client — retry
                self._bump("failovers")
                failovers += 1
                last_error = str(doc.get("error", "replica engine failure"))
                continue
            replicas_crossed = {rep.id}
            if status == 200 and doc.get("status") == "migrated" and doc.get(
                "migrated_to"
            ):
                # the stream moved mid-request (drain-as-migrate or a
                # disaggregated handoff): collect the continuation at its
                # new home — zero tokens replayed
                ids2, done2 = self._attach_collect(
                    doc["migrated_to"], rid, hop=hops
                )
                if done2 is None or done2.get("status") != "done":
                    self._bump("failovers")
                    failovers += 1
                    last_error = (
                        f"migrated stream lost at {doc['migrated_to']}"
                    )
                    continue
                self._bump("migration_resumes")
                attach_hops += 1
                replicas_crossed.add(_parse_url(doc["migrated_to"])[0])
                doc = {
                    "status": "done",
                    "tokens": (doc.get("tokens") or []) + ids2,
                    "text": (doc.get("text") or "") + str(
                        done2.get("text", "")
                    ),
                    # the attach hop's done event carries the CUMULATIVE
                    # engine ledger (it rode the page-span payload)
                    "ledger": done2.get("ledger", doc.get("ledger")),
                }
            n_tokens = len(doc.get("tokens") or ())
            self.registry.add_tokens(rep.id, n_tokens)
            self._bump("tokens_relayed", n_tokens)
            doc["request_id"] = rid
            doc["replica"] = rep.id
            doc["ledger"] = complete_ledger(
                doc.get("ledger"),
                replicas_crossed=len(replicas_crossed),
                failovers=failovers,
                attach_hops=attach_hops,
                resume_replayed_tokens=0,
                tokens_relayed=n_tokens,
                relay_ms=round((self.clock() - t0) * 1e3, 3),
            )
            self.tenants.record(tenant, doc["ledger"])
            self._finish_trace(rid, t0, doc.get("status", str(status)),
                               failovers=len(tried) - 1)
            handler._json(status, doc, headers={"X-Request-Id": rid})
            return
        self._bump("rejected_no_replica")
        self._finish_trace(rid, t0, "rejected", failovers=max(0, len(tried) - 1))
        handler._json(503, {
            "error": last_error, "status": "rejected", "request_id": rid,
        }, headers={
            "Retry-After": str(max(1, math.ceil(retry_after))),
            "X-Request-Id": rid,
        })

    # ---- SSE relay with mid-stream failover.

    def _relay_stream(self, handler, req: dict, rid: str, state: dict) -> None:
        t0 = self.clock()
        orig_tokens = req.get("tokens")
        max_new = int(req.get("max_new_tokens", 32))
        tried: Set[str] = set()
        retry_after = 1.0
        last_error = "no routable replica"
        attempt = 0
        disagg_tried = False
        # a pending attach always gets its hop: attach hops don't consume
        # the dispatch budget (they are migrations, not failures), so a
        # stream migrated on its FINAL permitted dispatch must still follow
        # its pages instead of dying "retry budget exhausted"
        while attempt < self.max_attempts or state.get("attach"):
            relayed = len(state["ids"])
            attach_to = state.pop("attach", None)
            if attach_to is not None:
                # zero-recompute hop: the stream's pages moved; follow them
                # with an attach (no prompt re-send, no token replay). A
                # ping-ponging fleet is bounded by the attach budget — past
                # it the recompute fallback takes over.
                state["attach_hops"] = state.get("attach_hops", 0) + 1
                if state["attach_hops"] > 2 * self.max_attempts:
                    # break to the terminal-error path below (headers are
                    # sent by now): falling into the recompute branch here
                    # would bypass its non-resumable-text-prompt guard
                    last_error = "attach budget exhausted (migration loop)"
                    break
                rep = self._replica_for_url(attach_to)
                hop_path = "/attach"
                body = {"request_id": rid}
            if attach_to is None:
                if (
                    not disagg_tried
                    and not tried
                    and not state["ids"]
                    and self._disagg_enabled()
                ):
                    # fresh request on a disaggregated fleet: split it —
                    # prefill at max batch on a prefill replica, pages
                    # shipped to the decode replica we name, then attach
                    disagg_tried = True
                    plan = self._plan_disagg(orig_tokens)
                    if plan is not None:
                        ok, why = self._disagg_dispatch(
                            plan[0], plan[1], req, rid, state
                        )
                        if ok:
                            continue  # attach hop next
                        last_error = why
                        self._bump("disagg_fallbacks")
                rep = self._route(orig_tokens, tried,
                                  tenant=req.get("tenant"))
                if rep is None:
                    break
                attempt += 1
                tried.add(rep.id)
                hop_path = "/generate"
                body = self._hop_body(req, state["ids"], self.clock() - t0)
                if relayed:
                    # the recompute fallback re-sends every relayed token
                    # as prompt — O(tokens) replay, the cost the attach
                    # path exists to avoid (and the counter the
                    # zero-replay proof pins)
                    self._bump("resume_replayed_tokens", relayed)
                    state["replayed"] = state.get("replayed", 0) + relayed
            self.registry.inc_relay(rep.id)
            hop0 = self.clock()
            hop_idx = state.get("hops", 0)
            state["hops"] = hop_idx + 1
            state.setdefault("replica_ids", []).append(rep.id)
            hop_tokens_before = relayed
            conn = None
            outcome, detail = "dead", "connect"
            finish_done = None
            abort_error = None
            try:
                try:
                    conn = self._connect(rep)
                    conn.request(
                        "POST", hop_path, json.dumps(body),
                        {"Content-Type": "application/json",
                         "X-Request-Id": rid,
                         "X-Trace-Hop": str(hop_idx)},
                    )
                    resp = conn.getresponse()
                except (OSError, http.client.HTTPException) as exc:
                    raise _HopDead(f"connect: {type(exc).__name__}: {exc}")
                if hop_path == "/attach":
                    if resp.status != 200:
                        # the imported stream is not there (ingest failed,
                        # got consumed, or the replica restarted):
                        # recompute fallback — with suspicion only for 5xx
                        # (a wedged handler must accrue ejection pressure;
                        # a clean 404 is just a miss)
                        resp.read()
                        outcome = (
                            "replica_5xx" if resp.status >= 500
                            else "attach_miss"
                        )
                        detail = str(resp.status)
                        raise _HopDead(
                            f"attach at {rep.id} returned {resp.status}"
                        )
                    # counted on attach SUCCESS (matching the JSON path's
                    # collect-then-count), not when the migrated done event
                    # was merely seen — an attach miss is a fallback, not
                    # a zero-replay resume
                    self._bump("migration_resumes")
                if resp.status != 200:
                    payload = resp.read()
                    try:
                        doc = json.loads(payload or b"{}")
                    except ValueError:
                        doc = {}
                    ra = resp.getheader("Retry-After")
                    if ra is not None and "retry_after" not in doc:
                        doc["retry_after"] = ra
                    if resp.status in (429, 503):
                        # backpressure/drain: honest retry elsewhere, the
                        # replica is alive — no suspicion, no failover count
                        retry_after = max(retry_after, _retry_after_of(doc))
                        self._bump("retries")
                        last_error = str(doc.get("error", f"replica {resp.status}"))
                        outcome, detail = "backpressure", str(resp.status)
                        continue
                    if resp.status >= 500:
                        # replica-side failure before any stream bytes
                        # (500/502/504...): silently try the next replica,
                        # with suspicion — repeated 5xx should eject
                        outcome, detail = "replica_5xx", str(resp.status)
                        raise _HopDead(
                            f"replica {resp.status}: "
                            f"{doc.get('error', 'server error')}"
                        )
                    # client error (400 etc): the request itself is bad —
                    # forward verbatim, no retry can fix it
                    outcome, detail = "client_error", str(resp.status)
                    if not state["headers_sent"]:
                        doc.setdefault("request_id", rid)
                        try:
                            handler._json(resp.status, doc,
                                          headers={"X-Request-Id": rid})
                        except (BrokenPipeError, ConnectionResetError,
                                OSError):
                            self._bump("client_disconnects")
                        state["terminal"] = True
                    else:
                        self._finish_stream(
                            handler, rid, state, t0, "failed",
                            str(doc.get("error", f"replica {resp.status}")),
                            retryable=False,
                        )
                    return
                if not state["headers_sent"]:
                    try:
                        handler.send_response(200)
                        handler.send_header(
                            "Content-Type", "text/event-stream"
                        )
                        handler.send_header("Cache-Control", "no-cache")
                        handler.send_header("X-Request-Id", rid)
                        handler.end_headers()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        # the client left while we were still setting up:
                        # an ordinary disconnect, not a dropped stream
                        self._bump("client_disconnects")
                        state["terminal"] = True
                        outcome, detail = "client_gone", "headers"
                        return
                    state["headers_sent"] = True
                kind, payload = self._pump_sse(resp, handler, state)
                if kind == "client_gone":
                    self._bump("client_disconnects")
                    state["terminal"] = True
                    outcome, detail = "client_gone", ""
                    return
                if kind == "done":
                    status = str(payload.get("status", "done"))
                    if payload.get("ledger") is not None:
                        # the engine's cumulative cost ledger for this
                        # stream (migration hops carry it forward, so the
                        # LAST done event always holds the full total)
                        state["ledger"] = payload["ledger"]
                    if status == "migrated" and payload.get("migrated_to"):
                        # the replica shipped this stream's pages (live
                        # migration / drain-as-migrate): follow them with
                        # an attach hop — zero tokens replayed (counted at
                        # attach success, not here)
                        state["attach"] = str(payload["migrated_to"])
                        outcome, detail = "migrated", state["attach"]
                        continue
                    if status == "failed" and payload.get("retryable", True):
                        # the replica's engine failed this request retryably
                        # (tick fault / poisoned slot): a clean SSE ending,
                        # but the generation is incomplete — fail over with
                        # what was already relayed
                        last_error = str(payload.get("error", "replica engine failure"))
                        outcome, detail = "engine_failed", last_error
                        raise _HopDead(last_error)
                    # finish AFTER the finally's bookkeeping: the terminal
                    # event is the client's cue that stats/spans are final
                    outcome, detail = "done", status
                    finish_done = (
                        status, payload.get("error"),
                        bool(payload.get("retryable", False)),
                    )
                else:
                    # kind == "dead": mid-stream death (EOF/reset/timeout/torn)
                    raise _HopDead(str(payload))
            except _HopDead as exc:
                last_error = str(exc)
                self._bump("failovers")
                state["failover_count"] += 1
                if outcome in ("dead", "replica_5xx"):
                    self._registry_events(
                        self.registry.observe_relay_failure(rep.id, last_error)
                    )
                if outcome == "dead":
                    # the survivor taking over also takes over the prefix
                    # (a 5xx answer means the replica — and its prefix
                    # cache — is still alive, so affinity stays)
                    self.affinity.forget_replica(rep.id)
                if state["ids"] and len(state["ids"]) >= max_new:
                    # died between its last token and the done event — the
                    # budget is spent, nothing left to resume: the client
                    # has the whole generation, so it IS done (via the
                    # post-finally finish, not here, so the dead hop's
                    # bookkeeping lands before the terminal write)
                    finish_done = ("done", None, False)
                elif state["ids"] and orig_tokens is None:
                    # non-resumable: the router cannot reconstruct the token
                    # prompt a text request was tokenized into, and tokens
                    # already reached the client — degrade gracefully into a
                    # retryable terminal error, never a hang (written after
                    # the finally's bookkeeping, like every terminal event)
                    abort_error = (
                        f"replica failed mid-stream and the text prompt is "
                        f"not resumable ({last_error})"
                    )
                else:
                    if state["ids"]:
                        # a resume hop is about to dispatch; it only counts
                        # as a resumed stream once a survivor actually
                        # completes it (see _finish_stream) — not on the
                        # attempt
                        state["was_resumed"] = True
                    time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
                    continue
            finally:
                if conn is not None:
                    conn.close()
                self.registry.dec_relay(rep.id)
                hop_n = len(state["ids"]) - hop_tokens_before
                self.registry.add_tokens(rep.id, hop_n)
                self.tracer.add("relay", rid, hop0, self.clock(), {
                    "replica": rep.id, "tokens": hop_n, "hop": hop_idx,
                    "resumed": hop_tokens_before > 0,
                    "outcome": outcome, "detail": detail,
                })
            if finish_done is not None:
                self._finish_stream(
                    handler, rid, state, t0, finish_done[0], finish_done[1],
                    retryable=finish_done[2],
                )
                return
            if abort_error is not None:
                self._bump("aborted_streams")
                self._finish_stream(
                    handler, rid, state, t0, "failed", abort_error,
                    retryable=True,
                )
                return
        # retry budget exhausted / nothing routable
        if state["headers_sent"]:
            self._bump("aborted_streams")
            self._finish_stream(
                handler, rid, state, t0, "failed",
                f"retry budget exhausted: {last_error}", retryable=True,
            )
        else:
            self._bump("rejected_no_replica")
            state["terminal"] = True
            self._finish_trace(rid, t0, "rejected", 0)
            handler._json(503, {
                "error": last_error, "status": "rejected", "request_id": rid,
            }, headers={
                "Retry-After": str(max(1, math.ceil(retry_after))),
                "X-Request-Id": rid,
            })

    def _hop_body(
        self, req: dict, relayed: List[int], elapsed: float
    ) -> dict:
        """The request body for this hop: verbatim on the first dispatch; on
        a resume, prompt = original tokens + everything already relayed,
        budget reduced by the same amount (the seed rides along — greedy
        continues the exact trajectory, seeded sampling a consistent one),
        and any client deadline shrunk by the time already spent."""
        body = dict(req)
        body.pop("request_id", None)
        if relayed:
            body["tokens"] = list(req["tokens"]) + list(relayed)
            body.pop("prompt", None)
            body["max_new_tokens"] = (
                int(req.get("max_new_tokens", 32)) - len(relayed)
            )
        if "timeout" in req:
            body["timeout"] = max(0.05, float(req["timeout"]) - elapsed)
        return body

    def _pump_sse(self, resp, handler, state: dict):
        """Relay SSE events replica -> client until the done event, the
        stream dies, or the client leaves. Token events forward as raw bytes
        (one readline + one write per token); every forwarded token id is
        recorded in ``state`` — that record IS the resume point."""
        while True:
            try:
                line = resp.readline()
            except (OSError, http.client.HTTPException) as exc:
                return "dead", f"read: {type(exc).__name__}: {exc}"
            if not line:
                return "dead", "stream ended before the done event"
            if not line.strip():
                continue  # SSE event separator
            if not line.startswith(b"data: "):
                continue
            try:
                event = json.loads(line[6:])
            except ValueError:
                return "dead", "torn SSE event"
            if event.get("done"):
                return "done", event
            try:
                handler.wfile.write(line.rstrip(b"\r\n") + b"\n\n")
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                return "client_gone", None
            if "token" in event:
                state["ids"].append(int(event["token"]))
                self._bump("tokens_relayed")
            if event.get("text"):
                state["texts"].append(str(event["text"]))

    def _finish_stream(
        self, handler, rid: str, state: dict, t0: float, status: str,
        error: Optional[str], retryable: bool = False,
    ) -> None:
        """The terminal SSE event is always ROUTER-built: accumulated text
        across every hop (a resumed stream's per-replica done event only
        knows its own segment), the failover count, and the correlation id."""
        event: Dict[str, Any] = {
            "done": True,
            "status": status,
            "text": "".join(state["texts"]),
            "request_id": rid,
            "failovers": state.get("failover_count", 0),
            # the complete per-request cost ledger: the engine's cumulative
            # counters (from the final hop's done event) + the fleet-side
            # fields only the router knows — also rolled up per tenant
            "ledger": complete_ledger(
                state.get("ledger"),
                replicas_crossed=len(set(state.get("replica_ids", []))),
                failovers=state.get("failover_count", 0),
                attach_hops=state.get("attach_hops", 0),
                resume_replayed_tokens=state.get("replayed", 0),
                tokens_relayed=len(state["ids"]),
                relay_ms=round((self.clock() - t0) * 1e3, 3),
            ),
        }
        if error:
            event["error"] = error
            event["retryable"] = retryable
        # bookkeeping BEFORE the terminal write: the done event is the
        # client's cue that the stream is settled, so a client that reads it
        # and immediately scrapes /metrics must see these counters landed
        if status == "done" and state.get("was_resumed"):
            # the survivor finished what a dead replica started: one resumed
            # stream, however many hops the failover chain crossed
            self._bump("resumed_streams")
        self.tenants.record(state.get("tenant", "anon"), event["ledger"])
        state["terminal"] = True
        self._finish_trace(rid, t0, status, event["failovers"])
        try:
            handler.wfile.write(b"data: " + json.dumps(event).encode() + b"\n\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            self._bump("client_disconnects")

    def _finish_trace(
        self, rid: str, t0: float, outcome: str, failovers: int
    ) -> None:
        if self.tracer.enabled:
            self.tracer.add("route", rid, t0, self.clock(), {
                "id": rid, "outcome": outcome, "failovers": failovers,
            })

    # --------------------------------------------------------- rolling reload

    def _admin_reload(self, req: dict):
        """(code, body) for POST /admin/reload on the ROUTER: a rolling
        fleet reload. 409 while one is already running."""
        if not self._reload_busy.acquire(blocking=False):
            return 409, {"error": "rolling reload already in progress"}
        try:
            ok, steps = self._rolling_reload(
                params_path=req.get("params"),
                drain_timeout_s=float(req.get("drain_timeout", 30.0)),
                ready_timeout_s=float(req.get("ready_timeout", 60.0)),
            )
            return (200 if ok else 502), {
                "reloaded": ok,
                "replicas": steps,
                "dropped_streams": self.stats["dropped_streams"],
            }
        finally:
            self._reload_busy.release()

    def rolling_reload(
        self,
        params_path: Optional[str] = None,
        drain_timeout_s: float = 30.0,
        ready_timeout_s: float = 60.0,
    ) -> Tuple[bool, List[Dict[str, Any]]]:
        """Public in-process entry (the HTTP handler and tests share it)."""
        if not self._reload_busy.acquire(blocking=False):
            raise RuntimeError("rolling reload already in progress")
        try:
            return self._rolling_reload(params_path, drain_timeout_s,
                                        ready_timeout_s)
        finally:
            self._reload_busy.release()

    def _rolling_reload(
        self,
        params_path: Optional[str],
        drain_timeout_s: float,
        ready_timeout_s: float,
    ) -> Tuple[bool, List[Dict[str, Any]]]:
        """One replica at a time: cordon -> drain the router's in-flight
        relays to it -> replica /admin/reload -> wait READY -> uncordon.
        The fleet always keeps N-1 replicas taking traffic, and no stream
        is ever cut: new requests route around the cordoned replica while
        its in-flight ones finish at their own pace."""
        self._bump("rolling_reloads")
        self.flight.event("rolling_reload_begin", params=params_path or "")
        results: List[Dict[str, Any]] = []
        all_ok = True
        for rid in list(self.registry.replicas):
            rep = self.registry.get(rid)
            if rep.state == EJECTED:
                results.append({"replica": rid, "ok": False,
                                "error": "ejected; nothing to reload"})
                all_ok = False
                continue
            step: Dict[str, Any] = {"replica": rid, "ok": False}
            t0 = self.clock()
            self.registry.cordon(rid)
            try:
                migrated = self._migrate_off(rep)
                if migrated:
                    step["migrated_streams"] = migrated
                if not self._await_zero_relays(rid, drain_timeout_s):
                    step["error"] = (
                        f"drain timeout: {rep.active_relays} relays still "
                        f"in flight after {drain_timeout_s}s"
                    )
                    all_ok = False
                    results.append(step)
                    continue
                drained_at = self.clock()
                self.tracer.add("reload_drain", "router", t0, drained_at,
                                {"replica": rid})
                try:
                    code, doc = self._post_replica(
                        rep, "/admin/reload",
                        {"params": params_path} if params_path else {},
                    )
                except (OSError, http.client.HTTPException) as exc:
                    code, doc = 0, {"error": f"{type(exc).__name__}: {exc}"}
                if code != 200:
                    step["error"] = (
                        f"replica reload returned {code}: "
                        f"{doc.get('error', '')}"
                    )
                    self._bump("reload_failures")
                    all_ok = False
                    results.append(step)
                    continue
                if not self._await_ready(rid, ready_timeout_s):
                    step["error"] = f"not READY within {ready_timeout_s}s"
                    self._bump("reload_failures")
                    all_ok = False
                    results.append(step)
                    continue
                self.tracer.add("reload_swap", "router", drained_at,
                                self.clock(), {"replica": rid})
                # its prefix cache flushed on reload: old affinities point
                # at K/V that no longer exists
                self.affinity.forget_replica(rid)
                self._bump("reload_steps")
                self.flight.event("rolling_reload_step", replica=rid,
                                  reloads=doc.get("reloads"))
                step.update(ok=True, reloads=doc.get("reloads"),
                            drained_s=round(drained_at - t0, 3))
                results.append(step)
            finally:
                self.registry.uncordon(rid)
        self.flight.event("rolling_reload_end", ok=all_ok)
        return all_ok, results

    def _migrate_off(self, rep: Replica) -> int:
        """Drain-as-migrate: ask a cordoned replica to ship every live
        stream to the best surviving decode-capable replica. Cost O(pages)
        per stream instead of O(remaining tokens) of waiting; the open
        relays see ``migrated`` done events and attach-resume at the
        target. Best-effort: on any failure the classic wait-out drain
        still runs (and mid-stream death still has the recompute path)."""
        if not self.migrate_drain:
            return 0
        target = pick_decode_replica([
            r for r in self.registry.routable()
            if r.id != rep.id and r.role != "prefill" and r.importable
            and r.draft_k == rep.draft_k
        ])
        if target is None:
            return 0
        target_url = (
            target.url if "//" in target.url else f"http://{target.url}"
        )
        try:
            code, doc = self._post_replica(
                rep, "/admin/migrate_all", {"target": target_url},
                timeout=5.0,
            )
        except (OSError, http.client.HTTPException):
            return 0
        if code != 202:
            return 0
        n = int(doc.get("requested", 0) or 0)
        if n:
            self._bump("migrations_requested", n)
            self.flight.event(
                "drain_migrate", replica=rep.id, target=target.id, streams=n,
            )
        return n

    # ------------------------------------------------------------ autoscaler

    def _autoscale_enabled(self) -> bool:
        return self.autoscale_interval > 0 and self.scaler is not None

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(self.autoscale_interval):
            try:
                self._autoscale_tick()
            except Exception as exc:  # noqa: BLE001 — the control loop must outlive any one bad decision
                self.flight.event("autoscale_error", error=repr(exc))

    def _load_signals(self) -> Dict[str, Any]:
        reps = self.registry.routable()
        return {
            "routable": len(reps),
            "total": len(self.registry),
            "queued": sum(r.queue_depth for r in reps),
            "active": sum(r.active_slots + r.active_relays for r in reps),
            "max_itl_ewma_ms": max(
                (r.itl_ewma_ms for r in reps), default=0.0
            ),
            "min_free_pages": min((r.free_pages for r in reps), default=0),
        }

    def _autoscale_tick(self) -> None:
        """One control-loop decision over the signals every probe already
        scrapes. Deliberately hysteretic: ``scale_patience`` consecutive
        breaches before acting, and up-pressure always resets the idle
        streak (flapping costs replica churn AND migrations)."""
        sig = self._load_signals()
        n = sig["routable"]
        if n == 0:
            return  # nothing routable is an outage, not a scaling problem
        slo_hot = self.consume_slo_hot()
        if slo_hot:
            sig["slo_fast_burn"] = True
        brownout_hot = self.brownout.rung_index > 0
        if brownout_hot:
            sig["brownout_rung"] = self.brownout.rung
        hot = (
            sig["queued"] / n >= self.scale_up_queue
            or (
                self.scale_up_itl_ms > 0
                and sig["max_itl_ewma_ms"] >= self.scale_up_itl_ms
            )
            or (
                self.scale_up_free_pages > 0
                and sig["min_free_pages"] < self.scale_up_free_pages
            )
            # the SLO engine's fast-burn up-signal: the declared objective
            # is dying faster than its budget — capacity now, diagnose later
            or slo_hot
            # an engaged brownout is the fleet ALREADY degrading service:
            # capacity is the fix, degradation is the stopgap
            or brownout_hot
        )
        idle = (
            sig["queued"] == 0 and sig["active"] <= self.scale_down_active
        )
        if hot and sig["total"] < self.max_replicas:
            self._idle_ticks = 0
            self._hot_ticks += 1
            if self._hot_ticks >= self.scale_patience:
                self._hot_ticks = 0
                self._scale_up(sig)
        elif idle and sig["total"] > self.min_replicas:
            self._hot_ticks = 0
            self._idle_ticks += 1
            if self._idle_ticks >= self.scale_patience:
                self._idle_ticks = 0
                self._scale_down(sig)
        else:
            self._hot_ticks = self._idle_ticks = 0

    def _scale_up(self, sig: Dict[str, Any]) -> None:
        try:
            url = self.scaler.spawn()
        except Exception as exc:  # noqa: BLE001 — a failed spawn is an event, not a router crash
            self.flight.event("autoscale_spawn_failed", error=repr(exc))
            return
        if not url:
            self.flight.event("autoscale_spawn_failed", error="no url")
            return
        rid = self.registry.add(url)
        self._bump("autoscale_ups")
        # the decision and its inputs, post-hoc diagnosable (obs satellite)
        self.flight.event("autoscale_up", replica=rid, **sig)

    def _pick_retire_victim(self) -> Optional[Replica]:
        """Least-loaded routable replica that the fleet can lose: never the
        last decode-capable replica, never the last prefill replica while
        disaggregation is serving."""
        reps = self.registry.routable()
        decodes = [r for r in reps if r.role != "prefill"]
        prefills = [r for r in reps if r.role == "prefill"]
        candidates = []
        for r in reps:
            if r.role == "prefill" and len(prefills) <= 1 and decodes:
                continue  # keep the disaggregated split alive
            if r.role != "prefill" and len(decodes) <= 1:
                continue  # never retire the last decode-capable replica
            candidates.append(r)
        if not candidates:
            return None
        return min(candidates, key=Replica.load_score)

    def _scale_down(self, sig: Dict[str, Any]) -> None:
        victim = self._pick_retire_victim()
        if victim is None:
            return
        rid = victim.id
        self.registry.cordon(rid)
        try:
            migrated = self._migrate_off(victim)
            if not self._await_zero_relays(rid, self.scale_drain_timeout_s):
                # live streams that could not move: abort the scale-down —
                # capacity is cheaper than a dropped stream
                self._bump("autoscale_aborts")
                self.flight.event(
                    "autoscale_down_aborted", replica=rid,
                    active_relays=self.registry.get(rid).active_relays,
                    **sig,
                )
                self.registry.uncordon(rid)
                return
        except Exception as exc:  # noqa: BLE001 — an aborted retire must leave the replica serving
            self.flight.event("autoscale_error", error=repr(exc))
            self.registry.uncordon(rid)
            return
        try:
            self.scaler.retire(victim.url)
        except Exception as exc:  # noqa: BLE001 — retire-hook failures are the operator's event to act on
            self.flight.event(
                "autoscale_retire_failed", replica=rid, error=repr(exc)
            )
        self.registry.remove(rid)
        self.affinity.forget_replica(rid)
        self._bump("autoscale_downs")
        self.flight.event(
            "autoscale_down", replica=rid, migrated=migrated, **sig
        )

    def _await_zero_relays(self, rid: str, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.registry.get(rid).active_relays == 0:
                return True
            time.sleep(0.01)
        return self.registry.get(rid).active_relays == 0

    def _await_ready(self, rid: str, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.probe_once(rid)
            if self.registry.get(rid).state == READY:
                return True
            time.sleep(0.05)
        return False

    # ----------------------------------------------------------------- misc

    def export_trace(self, path: str) -> str:
        return self.tracer.write_chrome_trace(path)


def _retry_after_of(doc: dict) -> float:
    try:
        return float(doc.get("retry_after", 1.0) or 1.0)
    except (TypeError, ValueError):
        return 1.0


def run_router(
    replicas: Sequence[str],
    host: str = "127.0.0.1",
    port: int = 8080,
    background: bool = False,
    **kwargs,
) -> Optional[RouterServer]:
    """Start the fleet router. ``background=True`` returns the running
    router (tests); otherwise blocks until interrupted."""
    router = RouterServer(replicas, host=host, port=port, **kwargs)
    if background:
        router.start()
        return router
    import signal

    def on_term(signum, frame):
        threading.Thread(target=router.stop, daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    print(
        f"routing on http://{host}:{router.port} over "
        f"{len(router.registry)} replicas — POST /generate, GET /healthz, "
        "GET /metrics (JSON; Prometheus via Accept: text/plain), "
        "POST /admin/reload (rolling fleet reload)",
        flush=True,
    )
    router.serve_forever()
    return None
