"""Fleet-level observability: cross-process trace stitching, /metrics
aggregation, and the per-request cost ledger.

A copy of ``zero_transformer_tpu/obs/fleet.py`` (``new_engine_ledger`` :81,
``complete_ledger`` :85, ``TenantLedger`` :105, ``parse_exposition`` :182,
``FleetAggregator`` :249, ``estimate_clock_offset`` :415, ``stitch_spans``
:442, ``verify_stitched`` :513, ``detect_stragglers`` :567,
``request_ids_in`` :619, ``write_trace`` :628; stdlib only, the port keeps
its own copy and imports nothing of the JAX package).

The ``obs/`` layer is strictly per-process: each router/replica process
holds its own span ring, its own Prometheus registry, its own flight
recorder. A disaggregated request (router -> prefill replica -> page ship ->
decode replica -> attach) therefore leaves four disjoint span files and four
``/metrics`` endpoints, and nothing answers "where did this request's
latency go" at the level the control decisions (routing, autoscaling,
tuning) are made. This module is the stitch layer:

- **trace stitching**: every process already keys a request's spans on the
  propagated ``X-Request-Id``; the router pulls each replica's span tail
  (``GET /admin/spans?request_id=``), maps the remote monotonic clocks onto
  its own via the per-replica offset estimated from probe round-trips, and
  merges everything into ONE Perfetto document with one ``pid`` per process
  — ``verify_stitched`` then checks the merged tree programmatically
  (wall-latency coverage, orphan spans, hop ordering);
- **metrics aggregation**: ``parse_exposition`` reads the replica's
  ``text/plain; version=0.0.4`` scrape and ``FleetAggregator`` folds the
  per-replica families into fleet rollups (counters/histograms summed,
  gauges summed or maxed per ``MAX_GAUGES``) with per-role and per-replica
  labels, rendered as ``fleet_*`` families on the router's own /metrics;
- **cost ledger**: the schema for the per-request resource ledger the
  engine accumulates on its tick thread and the router completes with
  fleet-side fields, plus ``TenantLedger`` — the bounded per-tenant rollup
  the router exposes so capacity decisions stop being guesses.

Everything here is pure stdlib + pure functions where possible; sockets and
threads stay in ``serving/router.py``.
"""
from __future__ import annotations

import json
import logging
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("zero_transformer_tpu_torch")

# ------------------------------------------------------------- cost ledger

# accumulated on the ENGINE's tick thread (plain-int increments; the dict
# rides the request handle and ships with the page span on migration, so
# the counts stay cumulative across replicas)
ENGINE_LEDGER_KEYS = (
    "prefill_chunks",     # chunk-prefill dispatches this request paid for
    "decode_ticks",       # decode ticks a slot was held
    "tokens_out",         # tokens emitted to the client
    "draft_tokens",       # speculative drafts proposed for this request
    "accepted_tokens",    # drafts the verify step accepted
    "pages_held_ticks",   # sum over ticks of KV pages held (0 on slab)
    "migrations",         # times the stream's pages crossed processes
    "queue_ms",           # submit -> slot admission
    "prefill_ms",         # admission -> K/V installed
    "decode_ms",          # installed -> terminal state
)

# added by the ROUTER when it builds the terminal event (fleet-side facts a
# replica cannot know)
ROUTER_LEDGER_KEYS = (
    "replicas_crossed",        # distinct replicas that served a hop
    "failovers",               # hops lost to failures
    "attach_hops",             # zero-recompute attach hops followed
    "resume_replayed_tokens",  # tokens re-sent as prompt by the recompute fallback
    "tokens_relayed",          # tokens the router relayed to the client
    "relay_ms",                # client-observed wall time at the router
)

LEDGER_KEYS = ENGINE_LEDGER_KEYS + ROUTER_LEDGER_KEYS

# the schema-pinned payload contracts (tests/test_serve_bench.py): a
# terminal event's ledger and a /slo response must carry at least these
FLEET_OBS_REQUIRED_KEYS = {
    "ledger": set(LEDGER_KEYS),
    "slo": {"objectives", "verdict", "evaluated", "window_clipped"},
}


def new_engine_ledger() -> Dict[str, float]:
    return {k: 0 for k in ENGINE_LEDGER_KEYS}


def complete_ledger(
    engine_ledger: Optional[Dict[str, Any]],
    **router_fields: Any,
) -> Dict[str, Any]:
    """The terminal event's ledger: the engine's cumulative counters (zeros
    when a hop died before its done event could deliver them) plus the
    router-side fields. Every LEDGER_KEYS key is always present."""
    out: Dict[str, Any] = {k: 0 for k in LEDGER_KEYS}
    if isinstance(engine_ledger, dict):
        for k in ENGINE_LEDGER_KEYS:
            try:
                out[k] = round(float(engine_ledger.get(k, 0)), 3)
            except (TypeError, ValueError):
                out[k] = 0
    for k in ROUTER_LEDGER_KEYS:
        if k in router_fields:
            out[k] = router_fields[k]
    return out


class TenantLedger:
    """Bounded per-tenant rollup of completed-request ledgers. The router
    records every terminal event's ledger under its tenant key (the
    ``X-Tenant-Key`` header / ``tenant`` body field, ``anon`` otherwise);
    a capacity question ("who is burning the pages?") becomes one scrape.
    LRU-bounded so a tenant-id cardinality attack cannot balloon the
    router."""

    def __init__(self, capacity: int = 1024, on_evict=None):
        from collections import OrderedDict

        self.capacity = max(1, int(capacity))
        # true LRU: record() refreshes recency, so a key-churn flood
        # evicts idle one-off tenants, never the continuously active one
        self._totals: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        self._lock = threading.Lock()
        # eviction is billing-data loss — never silent: count it and let
        # the owner (the router) turn each drop into a flight event
        self.on_evict = on_evict
        self.evictions = 0

    def record(self, tenant: str, ledger: Dict[str, Any]) -> None:
        tenant = str(tenant or "anon")[:64]
        evicted: Optional[str] = None
        with self._lock:
            row = self._totals.get(tenant)
            if row is None:
                if len(self._totals) >= self.capacity:
                    evicted, _ = self._totals.popitem(last=False)  # idle LRU
                    self.evictions += 1
                row = self._totals[tenant] = {k: 0.0 for k in LEDGER_KEYS}
                row["requests"] = 0.0
            self._totals.move_to_end(tenant)
            row["requests"] += 1
            for k in LEDGER_KEYS:
                try:
                    row[k] += float(ledger.get(k, 0) or 0)
                except (TypeError, ValueError):
                    pass
        if evicted is not None and self.on_evict is not None:
            try:  # outside the lock: the callback may re-enter snapshot()
                self.on_evict(evicted)
            except Exception:
                log.exception("tenant ledger on_evict callback failed")

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {t: dict(row) for t, row in self._totals.items()}

    def totals(self) -> Dict[str, float]:
        """Fleet-wide aggregate across every tenant (the BENCH artifact's
        ``ledger`` block)."""
        agg = {k: 0.0 for k in LEDGER_KEYS}
        agg["requests"] = 0.0
        for row in self.snapshot().values():
            for k, v in row.items():
                agg[k] = agg.get(k, 0.0) + v
        return agg

    def samples(self, key: str) -> List[Tuple[Dict[str, str], float]]:
        """``[({"tenant": t}, value)]`` rows for a labeled gauge_func."""
        return [
            ({"tenant": t}, row.get(key, 0.0))
            for t, row in sorted(self.snapshot().items())
        ]


# ------------------------------------------- Prometheus exposition parsing

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(.*)\})?"
    r" (NaN|[+-]Inf|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse a ``text/plain; version=0.0.4`` scrape into
    ``{family: {"type": t, "help": h, "samples": [(labels, value)]}}``.

    Histogram sub-series (``_bucket``/``_sum``/``_count``) fold under their
    base family name so one entry carries the whole histogram."""
    fams: Dict[str, Dict[str, Any]] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 4 and parts[1] == "HELP":
                fams.setdefault(
                    parts[2], {"type": "untyped", "help": "", "samples": []}
                )["help"] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value_raw = m.groups()
        base = name
        sub = ""
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[: -len(suffix)] if name.endswith(suffix) else None
            if stem and types.get(stem) == "histogram":
                base, sub = stem, suffix[1:]
                break
        fam = fams.setdefault(
            base, {"type": "untyped", "help": "", "samples": []}
        )
        labels = (
            {k: v.replace('\\"', '"').replace("\\\\", "\\")
             for k, v in _LABEL_RE.findall(labels_raw)}
            if labels_raw else {}
        )
        if sub:
            labels["__sub__"] = sub
        try:
            value = float(value_raw)
        except ValueError:
            continue
        fam["samples"].append((labels, value))
    for base, t in types.items():
        if base in fams:
            fams[base]["type"] = t
    return fams


# gauges where the honest fleet rollup is the MAX, not the sum (a fleet's
# uptime is its oldest replica, its breaker state is "any open", its ITL
# estimate is the slowest replica a request could land on)
MAX_GAUGES = frozenset({
    "serve_uptime_seconds",
    "serve_breaker_open",
    "serve_itl_ewma_seconds",
    "serve_page_pool_util",
    "hbm_used_gigabytes_max",
    "obs_spans_dropped",
    "serve_trace_spans_dropped",
})


class FleetAggregator:
    """Fold per-replica /metrics scrapes into fleet rollups.

    ``update(replica, role, text)`` stores one replica's latest parsed
    scrape; ``render()`` emits every family as ``fleet_<name>`` with
    per-role series (labels ``{role}``, values folded across the role's
    replicas) AND per-replica series (labels ``{replica, role}``) for
    scalar families, so one scrape of the router sees the whole fleet and
    the per-role sums are pin-testable against the per-replica scrapes
    they fold. Aggregation semantics: counters and histogram
    buckets/sums/counts are SUMMED; gauges are summed except the
    ``MAX_GAUGES`` set, which are MAXED (docs/OBSERVABILITY.md)."""

    def __init__(self):
        self._lock = threading.Lock()
        # replica id -> (role, families)
        self._scrapes: Dict[str, Tuple[str, Dict[str, Dict[str, Any]]]] = {}

    def update(self, replica: str, role: str, text: str) -> None:
        fams = parse_exposition(text)
        with self._lock:
            self._scrapes[replica] = (str(role or "mixed"), fams)

    def drop(self, replica: str) -> None:
        with self._lock:
            self._scrapes.pop(replica, None)

    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._scrapes)

    def _snapshot(self):
        with self._lock:
            return dict(self._scrapes)

    @staticmethod
    def _fold(name: str, mtype: str, values: Sequence[float]) -> float:
        if mtype == "gauge" and name in MAX_GAUGES:
            return max(values) if values else 0.0
        return sum(values)

    def merged(self) -> Dict[str, Dict[str, Any]]:
        """``{family: {"type", "by_role": {(role, labelkey): value},
        "by_replica": {(replica, role, labelkey): value}}}`` where labelkey
        is the family's own labels (``le``, ``device``...) as a sorted
        tuple. The render path and the SLO sources both read this."""
        scrapes = self._snapshot()
        out: Dict[str, Dict[str, Any]] = {}
        for replica, (role, fams) in scrapes.items():
            for name, fam in fams.items():
                entry = out.setdefault(name, {
                    "type": fam["type"], "help": fam["help"],
                    "by_role": {}, "by_replica": {},
                })
                for labels, value in fam["samples"]:
                    key = tuple(sorted(labels.items()))
                    entry["by_role"].setdefault((role, key), []).append(value)
                    entry["by_replica"][(replica, role, key)] = value
        for name, entry in out.items():
            entry["by_role"] = {
                k: self._fold(name, entry["type"], vs)
                for k, vs in entry["by_role"].items()
            }
        return out

    def merged_histogram(self, name: str) -> Optional[Dict[str, Any]]:
        """The fleet-wide histogram for ``name`` (buckets summed across
        replicas): ``{"buckets": [(le, cumulative)], "count", "sum"}`` —
        the SLO engine's latency-objective source. None when no replica
        exported it yet."""
        entry = self.merged().get(name)
        if entry is None or entry["type"] != "histogram":
            return None
        buckets: Dict[str, float] = {}
        count = 0.0
        total = 0.0
        for (_, key), value in entry["by_role"].items():
            labels = dict(key)
            sub = labels.get("__sub__")
            if sub == "bucket":
                le = labels.get("le", "+Inf")
                buckets[le] = buckets.get(le, 0.0) + value
            elif sub == "count":
                count += value
            elif sub == "sum":
                total += value

        def le_key(le: str) -> float:
            return float("inf") if le == "+Inf" else float(le)

        return {
            "buckets": sorted(buckets.items(), key=lambda kv: le_key(kv[0])),
            "count": count,
            "sum": total,
        }

    def good_total_below(self, name: str, threshold: float) -> Optional[Tuple[float, float]]:
        """(good, total) cumulative event counts for a latency objective.

        A cumulative histogram can only be evaluated AT a bucket bound, so
        the threshold rounds UP to the smallest finite bound >= it (a
        2.0 s objective over 1.0/2.5 buckets grades at 2.5 s). Rounding
        down instead would damn every observation in the straddling bucket
        — including ones under the threshold. Declare thresholds on bucket
        bounds (obs.metrics.LATENCY_BUCKETS) for exact grading."""
        hist = self.merged_histogram(name)
        if hist is None or not hist["buckets"]:
            return None
        good = 0.0
        for le, cum in hist["buckets"]:
            bound = float("inf") if le == "+Inf" else float(le)
            if bound != float("inf"):
                good = cum
            if bound >= threshold:
                break
        return good, hist["count"]

    def render(self) -> str:
        """``fleet_*`` exposition text, appended to the router's own
        registry render by the /metrics handler."""
        merged = self.merged()
        lines: List[str] = []
        for name in sorted(merged):
            entry = merged[name]
            mtype = entry["type"] if entry["type"] != "untyped" else "gauge"
            out_name = f"fleet_{name}"
            lines.append(
                f"# HELP {out_name} fleet rollup of {name} "
                f"(per-role + per-replica)"
            )
            lines.append(f"# TYPE {out_name} {mtype}")
            scalar = mtype != "histogram"
            for (role, key), value in sorted(entry["by_role"].items()):
                labels = dict(key)
                sub = labels.pop("__sub__", None)
                labels["role"] = role
                lines.append(self._line(out_name, sub, labels, value))
            if scalar:
                for (replica, role, key), value in sorted(
                    entry["by_replica"].items()
                ):
                    labels = dict(key)
                    sub = labels.pop("__sub__", None)
                    labels["replica"] = replica
                    labels["role"] = role
                    lines.append(self._line(out_name, sub, labels, value))
        return ("\n".join(lines) + "\n") if lines else ""

    @staticmethod
    def _line(name: str, sub: Optional[str], labels: Dict[str, str],
              value: float) -> str:
        if sub:
            name = f"{name}_{sub}"
        inner = ",".join(
            f'{k}="{v}"' for k, v in sorted(labels.items())
        )
        if value == int(value) and abs(value) < 1e15:
            rendered = str(int(value))
        else:
            rendered = format(value, ".10g")
        return f"{name}{{{inner}}} {rendered}" if inner else f"{name} {rendered}"


# ------------------------------------------------------------- clock offset


def estimate_clock_offset(
    remote_clock: float, t0: float, t1: float,
    prev: Optional[Tuple[float, float]] = None,
    max_age_s: float = 30.0,
    now: Optional[float] = None,
) -> Tuple[float, float, float]:
    """One probe round-trip's clock-offset estimate, NTP-style: the remote
    read ``remote_clock`` happened somewhere inside [t0, t1] on the local
    clock, best guess the midpoint, so ``offset = remote - (t0+t1)/2`` with
    uncertainty rtt/2. Keeps the previous estimate when it came from a
    tighter round trip (smaller rtt = smaller error bar), unless it has
    aged out (clocks drift). Returns ``(offset_s, rtt_s, at)``."""
    rtt = max(0.0, t1 - t0)
    offset = remote_clock - (t0 + t1) / 2.0
    at = t1 if now is None else now
    if prev is not None:
        prev_offset, prev_rtt, prev_at = prev[0], prev[1], (
            prev[2] if len(prev) > 2 else 0.0
        )
        if rtt > prev_rtt and (at - prev_at) <= max_age_s:
            return prev_offset, prev_rtt, prev_at
    return offset, rtt, at


# ----------------------------------------------------------- trace stitching


def stitch_spans(groups: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-process span groups into ONE Perfetto/Chrome-trace doc.

    ``groups``: ``[{"process": label, "offset_s": off, "spans": [span
    dicts with track/name/t0/t1/attrs]}]`` — ``offset_s`` is the group's
    clock minus the reference clock (``t_ref = t - offset_s``), 0.0 for
    the reference process (the router). One ``pid`` per group, one ``tid``
    per (group, track); timestamps land on the shared reference clock so
    hop ordering is readable straight off the timeline."""
    events: List[dict] = []
    meta: List[dict] = []
    for pid, group in enumerate(groups):
        off = float(group.get("offset_s", 0.0) or 0.0)
        meta.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": str(group.get("process", f"proc{pid}"))},
        })
        tids: Dict[str, int] = {}
        for s in group.get("spans", []):
            track = str(s.get("track", "main"))
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                meta.append({
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": track},
                })
            t0 = float(s["t0"]) - off
            t1 = float(s["t1"]) - off
            ev = {
                "ph": "X",
                "name": str(s.get("name", "span")),
                "cat": track,
                "ts": t0 * 1e6,
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": pid,
                "tid": tid,
            }
            if s.get("attrs"):
                ev["args"] = s["attrs"]
            events.append(ev)
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"stitched_processes": len(groups)},
    }


def _merged_coverage(root: Tuple[float, float],
                     children: Sequence[Tuple[float, float]]) -> float:
    r0, r1 = root
    if r1 <= r0:
        return 1.0
    ivs = sorted((max(r0, a), min(r1, b)) for a, b in children)
    covered = 0.0
    cur0 = cur1 = None
    for a, b in ivs:
        if b < a:
            continue
        if cur0 is None:
            cur0, cur1 = a, b
        elif a <= cur1:
            cur1 = max(cur1, b)
        else:
            covered += cur1 - cur0
            cur0, cur1 = a, b
    if cur0 is not None:
        covered += cur1 - cur0
    return covered / (r1 - r0)


def verify_stitched(
    doc: Dict[str, Any], request_id: str, slack_s: float = 0.05,
) -> Dict[str, Any]:
    """Programmatic check of one request's merged trace — the acceptance
    bar, executable: the root is the router's ``route`` span on the
    request's track; every other span of that track (relay hops, each
    replica's request tree) must (a) sit inside the root ± ``slack_s``
    (anything outside is an ORPHAN — a stitching or clock-offset bug), (b)
    union-cover >= 95% of the root's wall time, and (c) where spans carry a
    propagated ``hop`` attr, start in hop order after clock correction.

    Returns ``{"coverage", "orphans", "hops_ordered", "spans", "wall_s"}``.
    """
    xs = [
        e for e in doc.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") == request_id
    ]
    root = next((e for e in xs if e["name"] == "route"), None)
    if root is None:
        return {"coverage": 0.0, "orphans": 0, "hops_ordered": False,
                "spans": len(xs), "wall_s": 0.0}
    r0 = root["ts"] / 1e6
    r1 = r0 + root["dur"] / 1e6
    children = []
    orphans = 0
    hops: List[Tuple[int, float]] = []
    for e in xs:
        if e is root:
            continue
        t0 = e["ts"] / 1e6
        t1 = t0 + e["dur"] / 1e6
        if t0 < r0 - slack_s or t1 > r1 + slack_s:
            orphans += 1
            continue
        children.append((t0, t1))
        hop = (e.get("args") or {}).get("hop")
        if hop is not None:
            try:
                hops.append((int(hop), t0))
            except (TypeError, ValueError):
                pass
    hops.sort(key=lambda h: h[0])
    hops_ordered = all(
        b[1] >= a[1] - slack_s for a, b in zip(hops, hops[1:])
    )
    return {
        "coverage": round(_merged_coverage((r0, r1), children), 4),
        "orphans": orphans,
        "hops_ordered": hops_ordered,
        "spans": len(xs),
        "wall_s": round(r1 - r0, 6),
    }


def detect_stragglers(
    groups: Sequence[Dict[str, Any]],
    span_name: str = "compute",
    factor: float = 3.0,
    min_spans: int = 4,
    window: int = 8,
) -> Dict[str, Dict[str, Any]]:
    """Fleet-relative straggler detection over per-process span groups —
    the SAME shape ``stitch_spans`` takes, so the training coordinator
    feeds the identical data structure to the trace stitcher and the
    straggler detector (one observability plane, two consumers).

    Per process: the mean duration of its most recent ``window`` spans
    named ``span_name``. Fleet baseline: the MEDIAN of those means (robust
    to the straggler itself — a mean-of-means baseline would be dragged
    toward the slow worker and mask it). A process is a straggler when its
    mean exceeds ``factor`` x the fleet median and it has produced at
    least ``min_spans`` samples (cold starts and compile steps must not
    trip it). Returns ``{process: {"mean_s", "n", "ratio", "straggler"}}``.
    """
    means: Dict[str, Tuple[float, int]] = {}
    for g in groups:
        durs = [
            float(s["t1"]) - float(s["t0"])
            for s in g.get("spans", [])
            if s.get("name") == span_name
        ][-window:]
        if durs:
            means[str(g.get("process"))] = (sum(durs) / len(durs), len(durs))
    if not means:
        return {}
    ordered = sorted(m for m, _ in means.values())
    mid = len(ordered) // 2
    median = (
        ordered[mid]
        if len(ordered) % 2
        else (ordered[mid - 1] + ordered[mid]) / 2.0
    )
    out: Dict[str, Dict[str, Any]] = {}
    for proc, (mean, n) in means.items():
        ratio = mean / median if median > 0 else 1.0
        out[proc] = {
            "mean_s": mean,
            "n": n,
            "ratio": ratio,
            "straggler": bool(
                n >= min_spans and len(means) >= 2 and ratio >= factor
            ),
        }
    return out


def request_ids_in(doc: Dict[str, Any]) -> List[str]:
    """Every request id with a ``route`` root in a merged doc (per-run
    verification sweeps these)."""
    return sorted({
        e.get("cat") for e in doc.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("name") == "route" and e.get("cat")
    })


def write_trace(path, doc: Dict[str, Any]) -> str:
    from pathlib import Path

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc) + "\n")
    return str(p)
