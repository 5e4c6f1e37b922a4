"""Serving-side resilience: lifecycle, circuit breaker, load shedding, hot
reload validation and serving chaos.

Counterpart of ``zero_transformer_tpu/serving/resilience.py``:

- ``Lifecycle``: the engine's state machine (STARTING -> READY ->
  DEGRADED -> DRAINING -> STOPPED) that ``/healthz`` reflects, so a load
  balancer routes around a replica that is warming up, sick or draining;
- ``CircuitBreaker``: consecutive decode-tick faults; at the threshold the
  engine goes DEGRADED and rebuilds its device state (bounded by the
  engine's ``max_rebuilds``);
- ``ItlEwma`` and ``infeasible_deadline``: the measured inter-token
  latency that deadline-aware shedding prices admission against;
- ``validate_reload``: a standby state dict checked against the serving
  one (names, shapes, dtype kinds) and for finite values on the host
  before a hot swap; a bad artifact raises ``ReloadError`` and the engine
  stays READY on the old weights;
- ``ServeFault`` / ``ServingChaosMonkey``: the serving faults on the
  port's ``resilience.chaos`` bookkeeping (decode-tick faults, prefill
  faults, NaN logits, slow ticks, SIGTERM, a corrupt reload, a stalled
  SSE client).

Host-side only.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault

# ----------------------------------------------------------------- lifecycle

STARTING = "starting"  # constructed; scheduler loop not yet running
READY = "ready"  # serving; /healthz 200
DEGRADED = "degraded"  # breaker open after consecutive tick faults; rebuilt
DRAINING = "draining"  # admission closed; finishing in-flight generations
STOPPED = "stopped"  # terminal: drained, aborted, or stopped

_STATES = (STARTING, READY, DEGRADED, DRAINING, STOPPED)


class Lifecycle:
    """Thread-safe engine state machine with a transition history.

    Legal moves: STARTING -> {READY, DRAINING, STOPPED}; READY <-> DEGRADED;
    any live state -> DRAINING; DRAINING -> STOPPED only; STOPPED is
    terminal. Illegal transitions are refused (return False), not raised:
    the tick thread, a signal handler and HTTP threads race, and the first
    writer wins."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STARTING
        self._born = clock()
        self.history: List[Tuple[str, float, str]] = [(STARTING, self._born, "init")]

    @property
    def state(self) -> str:
        return self._state

    @property
    def uptime_s(self) -> float:
        return self._clock() - self._born

    def to(self, state: str, reason: str = "") -> bool:
        assert state in _STATES, state
        with self._lock:
            cur = self._state
            if state == cur or cur == STOPPED:
                return False
            if cur == DRAINING and state != STOPPED:
                return False
            if state == DEGRADED and cur not in (READY, STARTING):
                return False
            self._state = state
            self.history.append((state, self._clock(), reason))
            return True


# ------------------------------------------------------------ circuit breaker


class CircuitBreaker:
    """Consecutive-tick-fault breaker. ``record_fault`` returns True on the
    fault that OPENS it (every ``threshold``-th of an unbroken streak, so a
    rebuilt engine that keeps faulting keeps tripping and the rebuild
    budget can run out); ``record_clean`` returns True on the clean tick
    that closes it after ``cooldown`` clean ticks."""

    def __init__(self, threshold: int = 3, cooldown: int = 1):
        if threshold < 1 or cooldown < 1:
            raise ValueError("threshold and cooldown must be >= 1")
        self.threshold = threshold
        self.cooldown = cooldown
        self.open = False
        self.consecutive_faults = 0
        self.trips = 0
        self._clean_streak = 0

    def record_fault(self) -> bool:
        self.consecutive_faults += 1
        self._clean_streak = 0
        if self.consecutive_faults % self.threshold == 0:
            self.open = True
            self.trips += 1
            return True
        return False

    def record_clean(self) -> bool:
        self.consecutive_faults = 0
        if not self.open:
            return False
        self._clean_streak += 1
        if self._clean_streak >= self.cooldown:
            self.open = False
            self._clean_streak = 0
            return True
        return False


# -------------------------------------------------------------- load shedding


class ItlEwma:
    """Measured inter-token latency EWMA. ``floor_s`` is the conservative
    read shedding uses: clamped from below by the fastest sample seen, so
    only PROVABLY infeasible deadlines are shed."""

    def __init__(self, decay: float = 0.9, warmup: int = 8):
        self.decay = decay
        self.warmup = warmup
        self.value: Optional[float] = None
        self.count = 0
        self._min = float("inf")

    def update(self, sample: float) -> None:
        self.count += 1
        self._min = min(self._min, sample)
        if self.value is None:
            self.value = sample
        else:
            self.value = self.decay * self.value + (1.0 - self.decay) * sample

    @property
    def warm(self) -> bool:
        return self.count >= self.warmup and self.value is not None

    def floor_s(self) -> float:
        return min(self.value, self._min) if self.value is not None else 0.0


def infeasible_deadline(deadline: float, now: float, max_new_tokens: int, queue_depth: int, n_slots: int,
                        itl: ItlEwma) -> bool:
    """True when ``deadline`` cannot be met even under best-case
    scheduling: ``max_new_tokens`` ticks at the fastest measured ITL, after
    the queue ahead has pushed ``queue_depth / n_slots`` tick-slots through.
    Inert until the EWMA is warm."""
    if not itl.warm:
        return False
    tick = itl.floor_s()
    lower_bound = tick * (max_new_tokens + queue_depth / max(1, n_slots))
    return now + lower_bound > deadline


# ----------------------------------------------------------------- hot reload


class ReloadError(RuntimeError):
    """A standby state dict failed validation (corrupt artifact, wrong
    model); the engine stays READY on the old weights."""


def validate_reload(current: Dict[str, torch.Tensor], candidate) -> None:
    """Reject a candidate state dict whose names or shapes differ from the
    serving one, whose dtype kind differs (floating where the serving
    tensor is floating: the engine casts it to the serving dtype; integer
    tensors such as int8 weights must match exactly), or that holds a
    non-finite value. Raises ``ReloadError`` naming the first mismatch."""
    if not isinstance(candidate, dict) or not all(isinstance(v, torch.Tensor) for v in candidate.values()):
        raise ReloadError(f"unreadable state dict: {type(candidate).__name__}")
    if set(current) != set(candidate):
        missing, extra = sorted(set(current) - set(candidate)), sorted(set(candidate) - set(current))
        raise ReloadError(f"state dict structure mismatch: missing {missing[:4]}, unexpected {extra[:4]}")
    for name, a in current.items():
        b = candidate[name]
        kind_ok = (a.dtype.is_floating_point and b.dtype.is_floating_point) or a.dtype == b.dtype
        if tuple(a.shape) != tuple(b.shape) or not kind_ok:
            raise ReloadError(f"state dict entry {name} mismatch: serving {tuple(a.shape)}/{a.dtype} "
                              f"vs reload {tuple(b.shape)}/{b.dtype}")
        if b.dtype.is_floating_point and not bool(torch.isfinite(b).all()):
            raise ReloadError(f"state dict entry {name} holds non-finite values")


# --------------------------------------------------------------- serving chaos

SERVE_KINDS = ("tick_fault", "prefill_fault", "nan_logits", "slow_tick", "sigterm", "corrupt_reload",
               "slow_client")


@dataclasses.dataclass
class ServeFault(Fault):
    """A serving fault. ``step`` is the scheduler TICK it keys on (the
    engine's busy-tick counter, 0-based): ``sigterm`` / ``slow_tick`` fire
    once at the first tick >= step; ``tick_fault`` / ``prefill_fault`` /
    ``nan_logits`` fire for ``duration`` consecutive ticks. ``slow_client``
    stalls the server's SSE pump for ``duration`` seconds once it has
    delivered ``step`` events. ``slots``: the rows ``nan_logits`` poisons
    (None = every row)."""

    exc: type = RuntimeError
    slots: Optional[Sequence[int]] = None

    def __post_init__(self):
        if self.kind not in SERVE_KINDS:
            raise ValueError(f"unknown serving fault kind {self.kind!r}; kinds: {SERVE_KINDS}")


class ServingChaosMonkey(ChaosMonkey):
    """Fault plan for the serving engine, injected where real serving
    faults enter: ``on_tick`` at the top of every supervised decode tick
    (raise, sleep, or SIGTERM this process), ``on_prefill_chunk`` at the top
    of a chunk prefill, ``poison_logits`` into the post-step logits (so the
    non-finite guard sees them as it sees real ones), ``corrupt_reload``
    between a reload's load and its validation, and ``client_stall_s`` in
    the SSE pump."""

    def on_tick(self, tick: int) -> None:
        for f in self._of_kind("slow_tick"):
            if not f.fired and tick >= f.step:
                self.record(f)
                time.sleep(float(f.duration))
        for f in self._of_kind("sigterm"):
            if not f.fired and tick >= f.step:
                self.record(f)
                os.kill(os.getpid(), signal.SIGTERM)
        for f in self._of_kind("tick_fault"):
            if f.step <= tick < f.step + int(f.duration):
                if not f.fired:
                    self.record(f)
                raise f.exc(f"{f.message} (decode tick {tick})")

    def client_stall_s(self, events_delivered: int) -> float:
        stall = 0.0
        for f in self._of_kind("slow_client"):
            if not f.fired and events_delivered >= f.step:
                self.record(f)
                stall += float(f.duration)
        return stall

    def on_prefill_chunk(self, tick: int) -> None:
        for f in self._of_kind("prefill_fault"):
            if f.step <= tick < f.step + int(f.duration):
                if not f.fired:
                    self.record(f)
                raise f.exc(f"{f.message} (prefill chunk, tick {tick})")

    def poison_logits(self, tick: int, logits: torch.Tensor) -> torch.Tensor:
        for f in self._of_kind("nan_logits"):
            if f.step <= tick < f.step + int(f.duration):
                if not f.fired:
                    self.record(f)
                rows = list(f.slots) if f.slots is not None else list(range(logits.shape[0]))
                logits = logits.clone()
                logits[torch.tensor(rows, device=logits.device)] = float("nan")
        return logits

    def corrupt_reload(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Truncate the first entry to ones of shape (1, ...): what a
        half-written artifact looks like after it parses."""
        fault = next((f for f in self._of_kind("corrupt_reload") if not f.fired), None)
        if fault is None:
            return state
        self.record(fault)
        out = dict(state)
        name = next(iter(out))
        out[name] = torch.zeros((1,) * max(1, out[name].ndim), dtype=out[name].dtype)
        return out
