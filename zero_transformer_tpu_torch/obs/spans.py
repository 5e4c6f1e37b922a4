"""Span tracing: a ring-buffered timeline of named intervals.

Counterpart of ``zero_transformer_tpu/obs/spans.py`` (a copy: that module
imports no JAX). The trainer records its step loop here (``data_fetch``,
``dispatch``, ``device_sync``, ``checkpoint_save``, ``replica_audit``,
``evaluate``):

- recording a span is one ``deque.append`` of a fixed tuple: no
  formatting, no IO. The ring is bounded (``capacity``) and its overflow
  is counted (``dropped``);
- timestamps are caller-supplied floats on one monotonic clock;
- ``chrome_trace()`` renders Perfetto/Chrome ``traceEvents`` JSON
  (complete "X" events, one ``tid`` per track); ``write_jsonl`` appends the
  spans not yet written to a ``spans.jsonl`` (incremental: safe to call at
  every log point).

Tracks are correlation keys: ``"train"`` for the step loop, a request id
for a request's span tree (``span_tree``, ``coverage_fraction``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("zero_transformer_tpu_torch")

# span record layout (fixed tuple, index-addressed):
# (seq, track, name, t0_s, t1_s, attrs_or_None)
SEQ, TRACK, NAME, T0, T1, ATTRS = range(6)


class Tracer:
    """Bounded span ring. Thread-safe: ``deque.append`` is atomic under the
    GIL and readers snapshot with ``list(ring)``; no lock on the hot path."""

    def __init__(
        self,
        enabled: bool = True,
        capacity: int = 8192,
        clock=time.monotonic,
    ):
        self.enabled = enabled
        self.clock = clock
        self._ring: deque = deque(maxlen=capacity)
        self._seq = itertools.count()
        self._added = 0
        self._capacity = capacity
        # warn ONCE at first overflow: the drop count is exported on
        # /metrics (obs_spans_dropped), but an operator reading logs must
        # also learn that trace truncation started — silently losing the
        # head of every trace is the failure mode this flag makes loud
        self._overflow_warned = False
        # JSONL cursor: seq of the last span already flushed to disk
        self._flushed_seq = -1

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Spans pushed out of the ring by overflow (bounded-buffer honesty:
        a trace that silently lost its head must say so)."""
        return max(0, self._added - len(self._ring))

    # ------------------------------------------------------------- recording

    def add(
        self,
        name: str,
        track: str,
        t0: float,
        t1: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a finished span [t0, t1] (seconds on this tracer's clock)."""
        if not self.enabled:
            return
        self._ring.append((next(self._seq), track, name, t0, t1, attrs))
        self._added += 1
        if self._added > self._capacity and not self._overflow_warned:
            self._overflow_warned = True
            log.warning(
                "tracer: span ring overflowed (capacity %d) — oldest spans "
                "are being dropped; obs_spans_dropped counts them on "
                "/metrics", self._capacity,
            )

    def instant(self, name: str, track: str, t: Optional[float] = None,
                attrs: Optional[Dict[str, Any]] = None) -> None:
        """Zero-duration marker event (renders as a thin slice)."""
        if not self.enabled:
            return
        ts = self.clock() if t is None else t
        self.add(name, track, ts, ts, attrs)

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **attrs):
        """Context-manager form for host-side phases. The span is recorded
        even when the body raises — a fault's timeline is the one that
        matters most."""
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(name, track, t0, self.clock(), attrs or None)

    # --------------------------------------------------------------- reading

    def spans(self) -> List[tuple]:
        """Snapshot of the current ring, oldest first."""
        return list(self._ring)

    def by_track(self, track: str) -> List[tuple]:
        return [s for s in self._ring if s[TRACK] == track]

    def track_dicts(self, track: Optional[str] = None,
                    tail: Optional[int] = None) -> List[Dict[str, Any]]:
        """Spans as JSON-ready dicts (the /admin/spans wire shape and the
        stitching input): one track's spans, or the whole ring tail."""
        spans = self.by_track(track) if track is not None else self.spans()
        if tail is not None:
            spans = spans[-tail:]
        return [span_dict(s) for s in spans]

    # --------------------------------------------------------------- export

    def chrome_trace(self, tail: Optional[int] = None) -> Dict[str, Any]:
        """Perfetto/Chrome ``traceEvents`` document (complete events).

        ``ts``/``dur`` are microseconds; each track gets its own ``tid``
        plus a ``thread_name`` metadata event so Perfetto labels the rows.
        """
        spans = self.spans()
        if tail is not None:
            spans = spans[-tail:]
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for s in spans:
            tid = tids.get(s[TRACK])
            if tid is None:
                tid = tids[s[TRACK]] = len(tids) + 1
            ev = {
                "ph": "X",
                "name": s[NAME],
                "cat": s[TRACK],
                "ts": s[T0] * 1e6,
                "dur": max(0.0, (s[T1] - s[T0]) * 1e6),
                "pid": 0,
                "tid": tid,
            }
            if s[ATTRS]:
                ev["args"] = s[ATTRS]
            events.append(ev)
        meta = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in tids.items()
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped},
        }

    def write_chrome_trace(self, path, tail: Optional[int] = None) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.chrome_trace(tail=tail)) + "\n")
        return str(path)

    def write_jsonl(self, path) -> int:
        """Append spans not yet flushed (incremental: call at log points).
        Returns the number of spans written."""
        fresh = [s for s in self.spans() if s[SEQ] > self._flushed_seq]
        if not fresh:
            return 0
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            for s in fresh:
                f.write(json.dumps({
                    "track": s[TRACK],
                    "name": s[NAME],
                    "t0": s[T0],
                    "t1": s[T1],
                    "dur_ms": round((s[T1] - s[T0]) * 1e3, 6),
                    "attrs": s[ATTRS],
                }) + "\n")
        self._flushed_seq = fresh[-1][SEQ]
        return len(fresh)


def span_dict(s: tuple) -> Dict[str, Any]:
    """One ring record as the cross-process wire/stitch shape."""
    return {
        "track": s[TRACK], "name": s[NAME], "t0": s[T0], "t1": s[T1],
        "attrs": s[ATTRS],
    }


def span_tree(spans: List[tuple], track: str) -> Dict[str, Any]:
    """Assemble one track's spans into {root, children} where root is the
    span named ``request`` (the full lifetime) — the shape the span-parity
    tests assert on. Returns {} when the track has no root."""
    mine = [s for s in spans if s[TRACK] == track]
    root = next((s for s in mine if s[NAME] == "request"), None)
    if root is None:
        return {}
    children = [s for s in mine if s is not root]
    return {"root": root, "children": children}


def coverage_fraction(tree: Dict[str, Any]) -> float:
    """Fraction of the root span's wall time covered by the union of its
    child spans (the >=95% acceptance bar). Children are clamped into the
    root interval and overlaps merged, so the result is in [0, 1]."""
    root = tree.get("root")
    if root is None:
        return 0.0
    r0, r1 = root[T0], root[T1]
    if r1 <= r0:
        return 1.0  # zero-length lifetime (e.g. rejected at submit)
    ivs = sorted(
        (max(r0, s[T0]), min(r1, s[T1])) for s in tree["children"]
    )
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
