"""SLO engine: declared objectives, multi-window burn rates, budget-driven
escalation.

A copy of ``zero_transformer_tpu/obs/slo.py`` (``Objective`` :56,
``parse_slo_config`` :83, ``default_objectives`` :109, ``SLOEngine`` :148;
stdlib only, the port keeps its own copy and imports nothing of the JAX
package). The fleet router (``serving/router.py``) owns one and serves it
on ``/slo``.

Automap's thesis applied to objectives (PAPERS.md 2112.02958): declare the
SLO ONCE — "TTFT p99 <= 2s for 99% of requests", "dropped_streams == 0" —
and derive the monitoring and the reactions instead of hand-wiring a
dashboard, an alert rule, and a scaling trigger that drift apart. The
engine is deliberately small and classical (the SRE-workbook multi-window
burn-rate alert):

- an **objective** says what fraction of events must be good
  (``target``) over what horizon; its error budget is ``1 - target``;
- a **source** is a callable returning cumulative ``(bad, total)`` event
  counts — latency objectives read the fleet-merged histogram's cumulative
  buckets (bad = observations above the threshold), availability reads the
  router's request counters, ``kind="zero"`` objectives (dropped_streams)
  treat ANY bad event as budget-gone;
- each evaluation appends a ``(t, bad, total)`` sample to a bounded ring
  and computes the **burn rate** over a short and a long window:
  ``(Δbad/Δtotal) / (1 - target)`` — 1.0 means "spending exactly the
  budget", ``fast_burn`` (default 14.4, the 1h/5m page threshold) means
  "the budget dies in hours, act now";
- a **fast burn** (both windows above the threshold — the long window
  de-flaps the short one) fires the registered callbacks ONCE per episode:
  the router wires these to the existing machinery (FlightRecorder dump
  with the fleet snapshot, an autoscaler up-signal, a loud log) rather
  than inventing an alerting stack.

Pure stdlib, no threads of its own: the owner calls ``evaluate()`` on its
own cadence (the router's obs loop) and reads ``snapshot()`` for the
``/slo`` endpoint and the ``slo_*`` gauges.
"""
from __future__ import annotations

import bisect
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("zero_transformer_tpu_torch")

# metric names an owner can bind without custom sources; anything else
# needs an explicit source callable (a typo'd objective must fail loudly
# at construction, not silently never burn)
KNOWN_METRICS = (
    "ttft_p99", "itl_p99", "availability", "dropped_streams",
)

OK, FAST_BURN, VIOLATED = "ok", "fast_burn", "violated"


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared objective. ``threshold_s`` only applies to latency
    metrics (an event is good when its latency lands at or under it)."""

    name: str
    metric: str
    target: float = 0.99          # fraction of events that must be good
    threshold_s: float = 0.0      # latency bound (latency metrics only)
    short_window_s: float = 60.0
    long_window_s: float = 3600.0
    fast_burn: float = 14.4       # burn-rate threshold on BOTH windows
    kind: str = "ratio"           # "ratio" | "zero"
    qos_class: Optional[str] = None  # bind to one class's metric stream

    def __post_init__(self):
        if not (0.0 < self.target < 1.0) and self.kind != "zero":
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1)"
            )
        if self.short_window_s <= 0 or self.long_window_s < self.short_window_s:
            raise ValueError(
                f"objective {self.name!r}: need 0 < short <= long window"
            )
        if self.fast_burn <= 0:
            raise ValueError(f"objective {self.name!r}: fast_burn must be > 0")


def parse_slo_config(spec: Sequence[Dict[str, Any]]) -> List[Objective]:
    """Objectives from a config list (e.g. ``configs/slo_default.json``).
    Also accepts the dict shape ``{"objectives": [...], "qos": ...,
    "brownout": ...}`` — the qos/brownout blocks belong to their owners
    (``QosPolicy.from_config`` / the router) and are ignored here.
    Unknown keys are an error — a typo must not silently weaken an SLO."""
    if isinstance(spec, dict):
        spec = spec.get("objectives") or []
    out: List[Objective] = []
    allowed = {f.name for f in dataclasses.fields(Objective)}
    for raw in spec:
        unknown = set(raw) - allowed
        if unknown:
            raise ValueError(
                f"SLO objective {raw.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)} (allowed: {sorted(allowed)})"
            )
        if raw.get("metric") not in KNOWN_METRICS:
            raise ValueError(
                f"SLO objective {raw.get('name', '?')!r}: unknown metric "
                f"{raw.get('metric')!r} (known: {KNOWN_METRICS})"
            )
        out.append(Objective(**raw))
    return out


def default_objectives() -> List[Objective]:
    """The committed defaults (mirrors configs/slo_default.json): latency
    objectives sized for production serving, availability, and the
    zero-tolerance dropped-streams objective the chaos proofs pin.
    Latency thresholds sit ON LATENCY_BUCKETS bounds — the histogram can
    only grade at a bound, so an off-bound threshold silently grades at
    the next bound up."""
    return [
        Objective(name="ttft_p99", metric="ttft_p99", target=0.99,
                  threshold_s=2.5),
        Objective(name="itl_p99", metric="itl_p99", target=0.99,
                  threshold_s=0.25),
        Objective(name="availability", metric="availability", target=0.999),
        Objective(name="dropped_streams", metric="dropped_streams",
                  kind="zero", target=0.999999),
    ]


class _ObjectiveState:
    __slots__ = ("objective", "source", "ring", "state", "last_fired_at",
                 "burn_short", "burn_long", "budget_remaining", "bad",
                 "total", "window_clipped")

    def __init__(self, objective: Objective, source):
        self.objective = objective
        self.source = source
        # (t, bad, total) cumulative samples, oldest first, clipped to the
        # long window (+ slack so the window edge always has a sample)
        self.ring: deque = deque()
        self.state = OK
        self.last_fired_at: Optional[float] = None
        self.burn_short = 0.0
        self.burn_long = 0.0
        self.budget_remaining = 1.0
        self.bad = 0.0
        self.total = 0.0
        self.window_clipped = True  # less history than the long window


class SLOEngine:
    """Evaluate declared objectives over cumulative (bad, total) sources.

    ``add_objective(obj, source)`` binds one objective; ``evaluate(now)``
    samples every source, updates burn rates, and fires ``on_fast_burn``
    callbacks on the OK -> FAST_BURN edge (re-armed after one short window
    back under the threshold). ``snapshot()`` is the /slo payload."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._objectives: Dict[str, _ObjectiveState] = {}
        self._callbacks: List[Callable[[Objective, Dict[str, Any]], None]] = []
        self._evaluations = 0
        # evaluate() runs on the owner's obs loop AND on direct callers
        # (tests, the loadgen's fleet-obs segment): the ring/window math
        # must never see a concurrent mutation. Callbacks fire OUTSIDE the
        # lock — they may legitimately read snapshot().
        self._lock = threading.Lock()

    def add_objective(
        self,
        objective: Objective,
        source: Callable[[], Optional[Tuple[float, float]]],
    ) -> None:
        if objective.name in self._objectives:
            raise ValueError(f"duplicate objective {objective.name!r}")
        self._objectives[objective.name] = _ObjectiveState(objective, source)

    def on_fast_burn(
        self, callback: Callable[[Objective, Dict[str, Any]], None]
    ) -> None:
        self._callbacks.append(callback)

    def __len__(self) -> int:
        return len(self._objectives)

    # ------------------------------------------------------------ evaluation

    @staticmethod
    def _window_delta(ring, now: float, window_s: float):
        """(Δbad, Δtotal, clipped): deltas vs the newest sample at or
        before ``now - window_s`` (the youngest sample OUTSIDE the window,
        so the delta covers at least the window). clipped=True when
        history is shorter than the window."""
        t_new, bad_new, total_new = ring[-1]
        cutoff = now - window_s
        times = [s[0] for s in ring]
        i = bisect.bisect_right(times, cutoff) - 1
        if i < 0:
            t0, bad0, total0 = ring[0]
            return bad_new - bad0, total_new - total0, True
        t0, bad0, total0 = ring[i]
        return bad_new - bad0, total_new - total0, False

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        t = self.clock() if now is None else now
        # sources run OUTSIDE the lock (they may take their owner's locks)
        samples: Dict[str, Optional[Tuple[float, float]]] = {}
        for name, st in self._objectives.items():
            try:
                samples[name] = st.source()
            except Exception:  # a broken source must not kill the obs loop
                log.exception("slo: source for %r failed", st.objective.name)
                samples[name] = None
        with self._lock:
            fired = self._evaluate_locked(t, samples)
        for obj, snap in fired:
            log.warning(
                "SLO FAST BURN: objective %r burning at %.1fx/%.1fx "
                "(short/long window) — budget_remaining %.3f",
                obj.name, snap["burn_rate_short"], snap["burn_rate_long"],
                snap["budget_remaining"],
            )
            for cb in self._callbacks:
                try:
                    cb(obj, snap)
                except Exception:
                    log.exception("slo: fast-burn callback failed")
        return self.snapshot()

    def _evaluate_locked(
        self, t: float, samples: Dict[str, Optional[Tuple[float, float]]],
    ) -> List[Tuple[Objective, Dict[str, Any]]]:
        self._evaluations += 1
        fired: List[Tuple[Objective, Dict[str, Any]]] = []
        for name, st in self._objectives.items():
            obj = st.objective
            sample = samples.get(name)
            if sample is None:
                continue
            bad, total = float(sample[0]), float(sample[1])
            st.bad, st.total = bad, total
            st.ring.append((t, bad, total))
            horizon = obj.long_window_s * 1.25
            while len(st.ring) > 2 and st.ring[0][0] < t - horizon:
                st.ring.popleft()
            budget = max(1e-9, 1.0 - obj.target)
            d_bad_s, d_total_s, _ = self._window_delta(
                st.ring, t, obj.short_window_s
            )
            d_bad_l, d_total_l, clipped = self._window_delta(
                st.ring, t, obj.long_window_s
            )
            st.window_clipped = clipped
            if obj.kind == "zero":
                # zero-tolerance: any bad event in the window IS the burn
                st.burn_short = float("inf") if d_bad_s > 0 else 0.0
                st.burn_long = float("inf") if d_bad_l > 0 else 0.0
                st.budget_remaining = 0.0 if bad > 0 else 1.0
            else:
                st.burn_short = (
                    (d_bad_s / d_total_s) / budget if d_total_s > 0 else 0.0
                )
                st.burn_long = (
                    (d_bad_l / d_total_l) / budget if d_total_l > 0 else 0.0
                )
                err_long = d_bad_l / d_total_l if d_total_l > 0 else 0.0
                st.budget_remaining = max(0.0, 1.0 - err_long / budget)
            burning = (
                st.burn_short >= obj.fast_burn
                and st.burn_long >= obj.fast_burn
            )
            if burning:
                was = st.state
                st.state = FAST_BURN
                rearmed = (
                    st.last_fired_at is None
                    or t - st.last_fired_at >= obj.short_window_s
                )
                if was != FAST_BURN and rearmed:
                    st.last_fired_at = t
                    fired.append((obj, self._objective_snapshot(st)))
            elif st.budget_remaining <= 0.0:
                st.state = VIOLATED
            else:
                st.state = OK
        return fired

    # -------------------------------------------------------------- reading

    @staticmethod
    def _objective_snapshot(st: _ObjectiveState) -> Dict[str, Any]:
        obj = st.objective

        def finite(v: float) -> float:
            return round(min(v, 1e9), 4)

        return {
            "metric": obj.metric,
            "kind": obj.kind,
            "qos_class": obj.qos_class,
            "target": obj.target,
            "threshold_s": obj.threshold_s,
            "state": st.state,
            "burn_rate_short": finite(st.burn_short),
            "burn_rate_long": finite(st.burn_long),
            "budget_remaining": round(st.budget_remaining, 4),
            "fast_burn_threshold": obj.fast_burn,
            "short_window_s": obj.short_window_s,
            "long_window_s": obj.long_window_s,
            "bad": st.bad,
            "total": st.total,
            "window_clipped": st.window_clipped,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The /slo payload: per-objective burn rates + budget, and one
        fleet verdict — ``violated`` when any objective is fast-burning or
        out of budget (the bench guard's gate), ``ok`` otherwise."""
        with self._lock:
            objectives = {
                name: self._objective_snapshot(st)
                for name, st in self._objectives.items()
            }
        verdict = OK
        if any(o["state"] in (FAST_BURN, VIOLATED) for o in objectives.values()):
            verdict = VIOLATED
        return {
            "objectives": objectives,
            "verdict": verdict,
            "evaluated": self._evaluations,
            "window_clipped": any(
                o["window_clipped"] for o in objectives.values()
            ),
        }
