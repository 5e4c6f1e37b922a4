"""Prometheus metric types and the text exposition format.

Counterpart of ``zero_transformer_tpu/obs/metrics.py`` (a copy: that
module imports no JAX):

- ``Counter`` / ``Gauge``: one float behind a small lock;
- ``Histogram``: fixed buckets chosen at construction: ``observe`` is one
  bisect and three adds, a quantile read is O(buckets) with linear
  interpolation inside the landing bucket, and the exposition renders
  cumulative ``_bucket{le=...}`` lines;
- ``counter_func`` / ``gauge_func``: metrics read from a callback at scrape
  time, so the loop that owns the value pays nothing per step;
- ``Registry.render()``: the ``text/plain; version=0.0.4`` exposition.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# default latency buckets (seconds): 100us .. 60s, roughly x2.5 per step —
# wide enough for small CPU runs and card runs both
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing value; renders as ``<name>_total``."""

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> List[str]:
        n = self.name if self.name.endswith("_total") else self.name + "_total"
        return [
            f"# HELP {n} {_escape_help(self.help)}",
            f"# TYPE {n} counter",
            f"{n} {_fmt(self._value)}",
        ]


class Gauge:
    """Value that can go up and down."""

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
            f"{self.name} {_fmt(self._value)}",
        ]


class Histogram:
    """Fixed-bucket histogram: O(log buckets) observe, O(buckets) quantile.

    ``__len__`` is the observation count, as JAX's.
    """

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        # counts[i] = observations in (buckets[i-1], buckets[i]];
        # counts[-1] = overflow (> buckets[-1], the +Inf bucket)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def __len__(self) -> int:
        return self._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) by linear interpolation inside
        the landing bucket. Returns 0.0 with no observations; the overflow
        bucket clamps to the top finite bound (a histogram cannot honestly
        extrapolate past its widest bucket)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def render(self) -> List[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        cum = 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            lines.append(
                f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}'
            )
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum {_fmt(s)}")
        lines.append(f"{self.name}_count {total}")
        return lines


class _FuncMetric:
    """Callback-backed counter/gauge: the callback returns a scalar, or a
    list of ``(labels_dict, value)`` pairs for labeled families (e.g. one
    ``hbm_used_gigabytes{device="N"}`` sample per local device)."""

    def __init__(self, name: str, help: str, mtype: str,
                 fn: Callable[[], Any]):
        self.name = name
        self.help = help
        self.mtype = mtype
        self.fn = fn

    def render(self) -> List[str]:
        n = self.name
        if self.mtype == "counter" and not n.endswith("_total"):
            n = n + "_total"
        lines = [
            f"# HELP {n} {_escape_help(self.help)}",
            f"# TYPE {n} {self.mtype}",
        ]
        try:
            out = self.fn()
        except Exception:
            # a scrape must never take the server down with it
            return lines
        if isinstance(out, list):
            for labels, value in out:
                lines.append(f"{n}{_labels_str(labels)} {_fmt(value)}")
        elif out is not None:
            lines.append(f"{n} {_fmt(out)}")
        return lines


class Registry:
    """Ordered collection of metrics with one ``render()`` to the
    ``text/plain; version=0.0.4`` exposition format.

    Get-or-create semantics: asking for an existing name returns the
    existing metric when the type matches (idempotent wiring), and raises
    when it does not (two meanings for one name is a scrape-side bug)."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, name: str, kind, factory):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, kind):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}"
                    )
                return existing
            metric = factory()
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str) -> Counter:
        return self._get_or_make(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str) -> Gauge:
        return self._get_or_make(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_make(
            name, Histogram, lambda: Histogram(name, help, buckets)
        )

    def _func(self, name: str, help: str, mtype: str, fn: Callable[[], Any]):
        metric = self._get_or_make(
            name, _FuncMetric, lambda: _FuncMetric(name, help, mtype, fn)
        )
        if metric.mtype != mtype:
            # both func flavors share _FuncMetric, so the class check alone
            # would silently hand a counter back to a gauge registration
            raise ValueError(
                f"metric {name!r} already registered as a {metric.mtype} func"
            )
        return metric

    def counter_func(self, name: str, help: str, fn: Callable[[], Any]):
        return self._func(name, help, "counter", fn)

    def gauge_func(self, name: str, help: str, fn: Callable[[], Any]):
        return self._func(name, help, "gauge", fn)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
