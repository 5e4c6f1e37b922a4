"""Run supervisor: bounded in-process restarts with exponential backoff.

Counterpart of ``zero_transformer_tpu/resilience/supervisor.py``, on the
port's ``Config`` and ``Trainer``. ``Supervisor.run`` builds a trainer,
trains, and on a retryable failure (loader or storage IO, a watchdog hang,
a preemption) builds a fresh trainer that resumes from the newest verified
checkpoint, after a backoff, within ``resilience.max_restarts``. Fatal
errors (config and shape mistakes, anomaly halts) propagate at once:
restarting cannot fix a wrong config, and retrying a deterministic
divergence burns the budget. ``max_steps`` is a budget for the whole run:
the first attempt fixes the target step, each retry trains to it.

The restart is exact because a step directory carries the loader's
position and the optimizer's count, and a resume continues both: a
supervised run that was interrupted ends where an uninterrupted one does,
bit for bit. One process only: a world of several ranks would need every
rank to restart together (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, List, Optional

from zero_transformer_tpu_torch.config import Config
from zero_transformer_tpu_torch.resilience import AnomalyHalt, RetryableError

log = logging.getLogger("zero_transformer_tpu_torch")

# exception types a restart can never fix; FileNotFoundError (an OSError)
# is fatal by its place before the OSError check
_FATAL_TYPES = (
    AnomalyHalt,
    ValueError,
    TypeError,
    KeyError,
    AttributeError,
    NotImplementedError,
    FileNotFoundError,
    IsADirectoryError,
    PermissionError,
)

# transient-failure fingerprints in foreign exception messages (runtime
# status codes, storage and network strings), matched case-insensitively
_RETRYABLE_PATTERNS = (
    "resource_exhausted",
    "deadline_exceeded",
    "unavailable",
    "data_loss",
    "aborted",
    "cancelled",
    "connection",
    "socket",
    "timed out",
    "timeout",
    "preempt",
    "temporarily",
    "transient",
    "too many requests",
    "service unavailable",
)


def _cause_chain(exc: BaseException, limit: int = 50):
    """``exc`` and its ``__cause__``/``__context__`` chain, innermost last;
    cycle-safe and depth-bounded."""
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen and limit > 0:
        yield cur
        seen.add(id(cur))
        cur = cur.__cause__ if cur.__cause__ is not None else cur.__context__
        limit -= 1


def classify(exc: BaseException) -> str:
    """``"retryable"`` or ``"fatal"`` for a train-loop exception (JAX's
    order): an interrupt or exit is fatal; a ``RetryableError`` anywhere in
    the cause chain is retryable; then the fatal types; then OSError,
    ConnectionError and TimeoutError are retryable, as are messages with a
    transient fingerprint; anything else is fatal, because restarting an
    unknown bug blindly loops."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "fatal"
    if any(isinstance(e, RetryableError) for e in _cause_chain(exc)):
        return "retryable"
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    if isinstance(exc, (OSError, ConnectionError, TimeoutError)):
        return "retryable"
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(pat in msg for pat in _RETRYABLE_PATTERNS):
        return "retryable"
    return "fatal"


def backoff_delay(base_s: float, max_s: float, attempt: int, jitter: float = 0.0,
                  rng: Callable[[], float] = random.random) -> float:
    """``min(base * 2^(attempt-1), max)`` spread uniformly over ``[1 - jitter,
    1 + jitter]``: workers restarting after a shared failure do not all hit
    the checkpoint store at the same instant."""
    delay = min(base_s * (2.0 ** (attempt - 1)), max_s)
    if jitter <= 0.0:
        return delay
    return delay * (1.0 + jitter * (2.0 * rng() - 1.0))


@dataclasses.dataclass
class RestartRecord:
    attempt: int
    step: Optional[int]  # the last step the attempt reached
    reason: str
    backoff_s: float


class Supervisor:
    """``Trainer.train`` under bounded restarts (``train --supervise``).

    ``trainer_factory(cfg)`` builds each attempt's trainer (default: the
    port's ``Trainer`` on ``device``; the tests pass trainers wired to one
    ``ChaosMonkey``, whose fired faults stay fired). After the first
    attempt the config resumes (``checkpoint.resume``). ``sleep_fn`` and
    ``rng`` are the backoff's sleep and jitter source."""

    def __init__(self, cfg: Config, trainer_factory: Optional[Callable[[Config], object]] = None,
                 device="cuda", sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] = random.random):
        from zero_transformer_tpu_torch.training.trainer import needs_process_group

        if needs_process_group(cfg):
            raise NotImplementedError(
                "the supervisor restarts one process; a world of several ranks would need every rank to "
                "restart together (ROADMAP Queue 1 item 15)")
        self.cfg = cfg
        self.res = cfg.resilience
        self.sleep_fn = sleep_fn
        self.rng = rng
        self.history: List[RestartRecord] = []
        if trainer_factory is None:

            def trainer_factory(run_cfg: Config):
                from zero_transformer_tpu_torch.training.trainer import Trainer

                return Trainer(run_cfg, device=device)

        self.trainer_factory = trainer_factory

    def _backoff(self, attempt: int) -> float:
        return backoff_delay(self.res.backoff_base_s, self.res.backoff_max_s, attempt,
                             jitter=self.res.backoff_jitter, rng=self.rng)

    def _resumed_cfg(self, attempt: int) -> Config:
        if attempt == 0 or self.cfg.checkpoint.resume:
            return self.cfg
        return dataclasses.replace(self.cfg, checkpoint=dataclasses.replace(self.cfg.checkpoint, resume=True))

    def run(self, max_steps: Optional[int] = None):
        """Train to the end or spend the restart budget; returns the final
        ``TrainState``. A preempted attempt (SIGTERM: saved and stopped) is
        resumed like a retryable failure."""
        attempt = 0
        target: Optional[int] = None  # the absolute step target, once max_steps is known
        while True:
            trainer = None
            step: Optional[int] = None
            try:
                # inside the try: building touches storage, which fails
                # transiently like the loop does
                trainer = self.trainer_factory(self._resumed_cfg(attempt))
                run_max = max_steps
                if max_steps is not None:
                    resumed_at = trainer.state.step
                    if target is None:
                        target = resumed_at + max_steps
                    run_max = target - resumed_at
                    if run_max <= 0:
                        log.info("supervisor: step target %d already reached", target)
                        return trainer.state
                state = trainer.train(max_steps=run_max)
                step = state.step
                if not getattr(trainer, "preempted", False):
                    if attempt:
                        log.info("supervisor: run completed at step %d after %d restart(s)", step, attempt)
                    return state
                reason = f"preempted at step {step}"
            except BaseException as e:
                kind = classify(e)
                if trainer is not None:
                    step = getattr(trainer, "last_step", None)
                if kind == "fatal":
                    log.error("supervisor: fatal %s at step %s, not restarting: %s", type(e).__name__, step, e)
                    raise
                reason = f"{type(e).__name__}: {e}"
            finally:
                if trainer is not None:
                    try:
                        trainer.close()
                    except Exception:
                        log.exception("supervisor: trainer.close() failed (ignored)")

            attempt += 1
            if attempt > self.res.max_restarts:
                raise RetryableError(f"restart budget exhausted ({self.res.max_restarts}); last failure: {reason}")
            delay = self._backoff(attempt)
            self.history.append(RestartRecord(attempt=attempt, step=step, reason=reason, backoff_s=delay))
            log.warning("supervisor: restart %d/%d in %.1fs (%s)", attempt, self.res.max_restarts, delay, reason)
            self.sleep_fn(delay)
