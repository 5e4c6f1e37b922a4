"""Overload isolation: QoS classes, token-bucket quotas, weighted-fair
admission and brownout degradation.

A copy of ``zero_transformer_tpu/serving/qos.py`` (host-side, stdlib only;
the port keeps its own copy and imports nothing of the JAX package). The
engine uses every primitive here; ``BrownoutController`` is the fleet
router's ladder, kept for the router slice (the engine takes rungs through
``set_brownout`` / ``POST /admin/brownout``):

- ``QosPolicy`` / ``QosClassConfig``: the declared classes (``gold`` >
  ``standard`` > ``batch``), each with a DWRR weight, slot/page
  reservation floors, per-tenant token-bucket parameters, and a
  class-aware ``Retry-After``. The code defaults are inert (no floors,
  unlimited buckets), so a policy-less engine admits FIFO as before.
- ``TokenBucket`` / ``TenantBuckets``: per-(tenant, class) admission
  quotas priced in tokens of work (prompt + max_new_tokens); a failed
  ``take`` returns the honest Retry-After.
- ``ClassQueue``: the admission queue as per-class deficit-weighted
  round-robin; floors enter as an ``eligible`` predicate.
- ``BrownoutController``: the degradation ladder (``normal -> no_spec ->
  shrink_batch -> suspend_batch``) with hysteresis.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict, deque
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple,
)

# Rank order IS priority order: index 0 is the most protected class.
QOS_CLASSES = ("gold", "standard", "batch")
DEFAULT_CLASS = "standard"

# Degradation ladder, mildest first. Every rung includes the effects of
# the rungs before it (suspend_batch implies shrunk budgets and no
# speculation).
BROWNOUT_RUNGS = ("normal", "no_spec", "shrink_batch", "suspend_batch")


@dataclasses.dataclass(frozen=True)
class QosClassConfig:
    """One declared QoS class.

    weight: DWRR weight — relative share of admission work-rate under
      contention (gold 8 : standard 4 : batch 1 by default).
    slot_floor: decode slots held back for this class: a lower class may
      not take a slot while doing so would leave fewer free slots than
      this class's unmet floor.
    page_floor_frac: same reservation for the paged-KV pool, as a
      fraction of total pool pages.
    rate / burst: per-tenant token-bucket refill (work-tokens/s) and
      capacity. The committed defaults are effectively unlimited — quotas
      bind only where a config declares finite ones.
    retry_after_s: the class-aware Retry-After floor for quota/brownout
      rejections (batch waits longer than gold by design).
    brownout_max_new_tokens: the shrunken per-request budget this class
      gets at the ``shrink_batch`` rung and above (None = never shrunk).
    """

    name: str
    weight: float = 1.0
    slot_floor: int = 0
    page_floor_frac: float = 0.0
    rate: float = float("inf")
    burst: float = float("inf")
    retry_after_s: float = 1.0
    brownout_max_new_tokens: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"qos class {self.name!r}: weight must be > 0")
        if self.slot_floor < 0 or not (0.0 <= self.page_floor_frac <= 1.0):
            raise ValueError(
                f"qos class {self.name!r}: floors must be >= 0 "
                f"(page_floor_frac in [0, 1])"
            )
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(
                f"qos class {self.name!r}: rate and burst must be > 0"
            )


_DEFAULT_CLASSES: Tuple[QosClassConfig, ...] = (
    QosClassConfig(name="gold", weight=8.0, retry_after_s=0.5),
    QosClassConfig(name="standard", weight=4.0, retry_after_s=1.0),
    QosClassConfig(name="batch", weight=1.0, retry_after_s=5.0,
                   brownout_max_new_tokens=16),
)


class QosPolicy:
    """The declared class set plus lookup helpers. Unknown or missing
    class names resolve to ``default_class`` — a client typo degrades to
    standard treatment, never to a 500."""

    def __init__(
        self,
        classes: Optional[Iterable[QosClassConfig]] = None,
        default_class: str = DEFAULT_CLASS,
    ):
        classes = tuple(classes) if classes is not None else _DEFAULT_CLASSES
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate qos class names: {names}")
        if default_class not in names:
            raise ValueError(
                f"default_class {default_class!r} not in classes {names}"
            )
        self.classes: "OrderedDict[str, QosClassConfig]" = OrderedDict(
            (c.name, c) for c in classes
        )
        self.default_class = default_class
        self._rank = {name: i for i, name in enumerate(self.classes)}

    @classmethod
    def from_config(cls, spec: Optional[Dict[str, Any]]) -> "QosPolicy":
        """Policy from a ``qos`` config block:
        ``{"default_class": ..., "classes": {name: {weight: ...}}}``.
        Unknown keys fail loudly (a typo'd knob must not silently weaken
        isolation). ``None``/empty -> the inert committed defaults."""
        if not spec:
            return cls()
        if not isinstance(spec, dict):
            raise ValueError(f"qos config must be a dict, got {type(spec)}")
        unknown = set(spec) - {"default_class", "classes"}
        if unknown:
            raise ValueError(f"qos config: unknown keys {sorted(unknown)}")
        allowed = {f.name for f in dataclasses.fields(QosClassConfig)}
        defaults = {c.name: c for c in _DEFAULT_CLASSES}
        out: List[QosClassConfig] = []
        for name, raw in (spec.get("classes") or {}).items():
            bad = set(raw) - (allowed - {"name"})
            if bad:
                raise ValueError(
                    f"qos class {name!r}: unknown keys {sorted(bad)} "
                    f"(allowed: {sorted(allowed - {'name'})})"
                )
            base = defaults.get(name)
            merged = dict(dataclasses.asdict(base)) if base else {}
            merged.update(raw)
            merged["name"] = name
            out.append(QosClassConfig(**merged))
        # classes the config omits keep their committed defaults, in rank
        # order, so a partial config never drops a class from the ladder
        declared = {c.name for c in out}
        for c in _DEFAULT_CLASSES:
            if c.name not in declared:
                out.append(c)
        out.sort(key=lambda c: (
            QOS_CLASSES.index(c.name) if c.name in QOS_CLASSES else len(
                QOS_CLASSES)
        ))
        return cls(out, default_class=spec.get("default_class", DEFAULT_CLASS))

    def normalize(self, name: Optional[str]) -> str:
        name = str(name or "").strip().lower()
        return name if name in self.classes else self.default_class

    def class_of(self, name: Optional[str]) -> QosClassConfig:
        return self.classes[self.normalize(name)]

    def rank(self, name: Optional[str]) -> int:
        """0 = most protected. Lower rank preempts / outranks higher."""
        return self._rank[self.normalize(name)]

    def names(self) -> Tuple[str, ...]:
        return tuple(self.classes)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: dataclasses.asdict(cfg)
            for name, cfg in self.classes.items()
        }


# ------------------------------------------------------------- token buckets


class TokenBucket:
    """Work-token bucket (not thread-safe; owners lock around it).

    ``take(cost, now)`` returns 0.0 on success (cost deducted) or the
    seconds until the bucket will hold ``cost`` — the honest Retry-After.
    ``scale`` multiplies rate and burst at take-time: the router scales a
    tenant's fleet bucket by the number of routable replicas, so fleet
    capacity and fleet quota move together."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self._last: Optional[float] = None

    def take(self, cost: float, now: float, scale: float = 1.0) -> float:
        rate = self.rate * max(1e-9, scale)
        burst = self.burst * max(1e-9, scale)
        if self._last is None:
            # first take: start full AT THE CURRENT SCALE (the router's
            # fleet bucket opens with the whole fleet's burst, not one
            # replica's worth)
            self._last = now
            self.level = burst
        if math.isinf(burst):
            return 0.0
        self.level = min(burst, self.level + rate * max(0.0, now - self._last))
        self._last = now
        if cost <= self.level:
            self.level -= cost
            return 0.0
        if rate <= 0 or not math.isfinite(rate):
            return 1.0
        return (cost - self.level) / rate


class TenantBuckets:
    """Bounded LRU of per-(tenant, class) ``TokenBucket``s. Thread-safe.
    LRU-bounded for the same reason as ``TenantLedger``: a tenant-id
    cardinality attack must not balloon the host."""

    def __init__(self, policy: QosPolicy, capacity: int = 4096):
        self.policy = policy
        self.capacity = max(1, int(capacity))
        self._buckets: "OrderedDict[Tuple[str, str], TokenBucket]" = (
            OrderedDict()
        )
        self._lock = threading.Lock()

    def take(
        self, tenant: str, qos: Optional[str], cost: float, now: float,
        scale: float = 1.0,
    ) -> float:
        """0.0 = admitted (cost charged); > 0 = Retry-After seconds."""
        cls = self.policy.class_of(qos)
        key = (str(tenant or "anon")[:64], cls.name)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self.capacity:
                    self._buckets.popitem(last=False)
                bucket = self._buckets[key] = TokenBucket(
                    cls.rate, cls.burst
                )
            self._buckets.move_to_end(key)
            wait = bucket.take(cost, now, scale=scale)
        return max(wait, cls.retry_after_s) if wait > 0 else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)


# ------------------------------------------------------- DWRR admission queue


class ClassQueue:
    """Per-class deficit-weighted-round-robin admission queue.

    Deque-compatible where the engine needs it (``len``, ``bool``,
    iteration in rank-then-FIFO order, ``append``/``appendleft``,
    ``clear``, ``rebuild``) so the sweep/drain/abort paths keep their
    shape. ``popleft(eligible=...)`` is the fair pop; ``cost`` prices a
    waiting request in work-tokens (default 1 per request)."""

    def __init__(
        self,
        policy: Optional[QosPolicy] = None,
        cost: Optional[Callable[[Any], float]] = None,
        class_of: Optional[Callable[[Any], str]] = None,
        quantum: float = 1.0,
    ):
        self.policy = policy or QosPolicy()
        self._cost = cost or (lambda h: 1.0)
        self._class_of = class_of or (
            lambda h: getattr(getattr(h, "request", h), "qos", None)
        )
        self.quantum = float(quantum)
        self._q: Dict[str, deque] = {
            name: deque() for name in self.policy.names()
        }
        self._deficit: Dict[str, float] = {
            name: 0.0 for name in self.policy.names()
        }

    def _cls(self, handle: Any) -> str:
        return self.policy.normalize(self._class_of(handle))

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __bool__(self) -> bool:
        return any(self._q.values())

    def __iter__(self) -> Iterator[Any]:
        for name in self.policy.names():
            yield from self._q[name]

    def counts(self) -> Dict[str, int]:
        return {name: len(q) for name, q in self._q.items()}

    def append(self, handle: Any) -> None:
        self._q[self._cls(handle)].append(handle)

    def appendleft(self, handle: Any) -> None:
        """Push back a popped-but-unadmittable head, refunding its DWRR
        charge so a paged-admission miss does not count against the
        class's fair share."""
        cls = self._cls(handle)
        self._q[cls].appendleft(handle)
        self._deficit[cls] += max(1.0, float(self._cost(handle)))

    def refund(self, handle: Any) -> None:
        """Refund a pop that admitted nothing (cancelled/expired head)."""
        cls = self._cls(handle)
        self._deficit[cls] += max(1.0, float(self._cost(handle)))

    def clear(self) -> None:
        for q in self._q.values():
            q.clear()
        for name in self._deficit:
            self._deficit[name] = 0.0

    def rebuild(self, handles: Iterable[Any]) -> None:
        """Replace contents (the sweep path), preserving arrival order
        within each class; deficits persist so a sweep is not a fairness
        reset."""
        for q in self._q.values():
            q.clear()
        for handle in handles:
            self.append(handle)

    def popleft(
        self, eligible: Optional[Callable[[str], bool]] = None,
    ) -> Optional[Any]:
        """Fair pop. Exact DWRR, O(classes): compute how many quantum
        rounds each contending head needs, advance every contender by the
        winning round count, serve the winner and charge its cost.
        ``eligible(class_name)`` gates contention (reservation floors) —
        an ineligible class neither serves nor accrues deficit."""
        contenders: List[Tuple[float, int, str, float]] = []
        for name in self.policy.names():
            q = self._q[name]
            if not q:
                # standard DWRR: an empty class forfeits its deficit, so
                # idle classes cannot bank unbounded credit
                self._deficit[name] = 0.0
                continue
            if eligible is not None and not eligible(name):
                continue
            cost = max(1.0, float(self._cost(q[0])))
            inc = self.quantum * self.policy.classes[name].weight
            need = max(0.0, cost - self._deficit[name])
            rounds = math.ceil(need / inc) if need > 0 else 0
            contenders.append((rounds, self.policy.rank(name), name, cost))
        if not contenders:
            return None
        contenders.sort()
        rounds, _, winner, cost = contenders[0]
        if rounds:
            for _, _, name, _ in contenders:
                self._deficit[name] += (
                    rounds * self.quantum * self.policy.classes[name].weight
                )
        self._deficit[winner] -= cost
        handle = self._q[winner].popleft()
        if not self._q[winner]:
            self._deficit[winner] = 0.0
        return handle

    def pop_lowest_class(self, above_rank: int = 0) -> Optional[Any]:
        """Shed candidate: the most recently queued request of the lowest
        class whose rank is strictly greater than ``above_rank`` (queue-
        full pressure evicts the newest batch request first, never a
        higher class)."""
        for name in reversed(self.policy.names()):
            if self.policy.rank(name) <= above_rank:
                continue
            if self._q[name]:
                return self._q[name].pop()
        return None

    def best_waiting_rank(self) -> Optional[int]:
        for name in self.policy.names():
            if self._q[name]:
                return self.policy.rank(name)
        return None


# ------------------------------------------------------ reservation floors


def reserved_above(
    policy: QosPolicy,
    cls: str,
    floors: Dict[str, float],
    in_use: Dict[str, float],
) -> float:
    """Capacity held back from class ``cls``: the unmet reservation floors
    of every strictly higher class. A higher class already using its
    floor releases that much back to the pool."""
    rank = policy.rank(cls)
    held = 0.0
    for name in policy.names():
        if policy.rank(name) >= rank:
            continue
        held += max(0.0, floors.get(name, 0.0) - in_use.get(name, 0.0))
    return held


# --------------------------------------------------------------- brownout


class BrownoutController:
    """The degradation ladder with hysteresis. ``observe(hot)`` once per
    SLO evaluation: a hot evaluation (a protected class is burning)
    escalates one rung; ``calm_evals`` consecutive calm evaluations
    de-escalate one rung — so a sustained calm spell walks the ladder all
    the way back to ``normal`` (full revert), while a single calm blip
    mid-overload changes nothing. Thread-safe."""

    def __init__(
        self,
        rungs: Tuple[str, ...] = BROWNOUT_RUNGS,
        calm_evals: int = 3,
    ):
        if len(rungs) < 2:
            raise ValueError("brownout needs at least 2 rungs")
        self.rungs = tuple(rungs)
        self.calm_evals = max(1, int(calm_evals))
        self._idx = 0
        self._calm = 0
        self._lock = threading.Lock()

    @property
    def rung(self) -> str:
        return self.rungs[self._idx]

    @property
    def rung_index(self) -> int:
        return self._idx

    def observe(self, hot: bool) -> Optional[Tuple[str, str]]:
        """Returns ``(old_rung, new_rung)`` on a transition, else None."""
        with self._lock:
            old = self._idx
            if hot:
                self._calm = 0
                if self._idx < len(self.rungs) - 1:
                    self._idx += 1
            else:
                self._calm += 1
                if self._calm >= self.calm_evals and self._idx > 0:
                    self._idx -= 1
                    self._calm = 0
            if self._idx != old:
                return (self.rungs[old], self.rungs[self._idx])
            return None

    def force(self, rung: str) -> Optional[Tuple[str, str]]:
        """Operator override (``POST /admin/brownout`` on the router)."""
        if rung not in self.rungs:
            raise ValueError(
                f"unknown brownout rung {rung!r} (rungs: {self.rungs})"
            )
        with self._lock:
            old = self.rungs[self._idx]
            self._idx = self.rungs.index(rung)
            self._calm = 0
            return (old, rung) if old != rung else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rung": self.rungs[self._idx],
                "rung_index": self._idx,
                "rungs": list(self.rungs),
                "calm_streak": self._calm,
                "calm_evals": self.calm_evals,
            }


def rung_at_least(rung: str, floor: str) -> bool:
    """True when ``rung`` is at or beyond ``floor`` on the default ladder
    (unknown rungs compare as ``normal``)."""
    order = {name: i for i, name in enumerate(BROWNOUT_RUNGS)}
    return order.get(rung, 0) >= order.get(floor, 0)
