"""Hang watchdog: a heartbeat deadline on the train loop.

Counterpart of ``zero_transformer_tpu/resilience/watchdog.py`` (a copy,
with the card's allocator stats in place of JAX's live arrays). A wedged
collective, a deadlocked host thread and a storage stall look the same
from outside: the loop stops completing steps. The watchdog turns that
into a bounded, diagnosable, retryable failure:

- the loop calls ``beat()`` once per step (a monotonic-clock store);
- a daemon thread checks the deadline; on expiry it (1) logs every Python
  thread's stack and the card's memory, (2) runs ``on_hang`` on a side
  thread with a bounded join (the trainer force-saves there, if it is
  between steps), and (3) raises ``KeyboardInterrupt`` in the main thread
  with ``_thread.interrupt_main()``;
- the trainer turns that ``KeyboardInterrupt`` into ``HangError``, which
  ``--supervise`` restarts from the newest checkpoint.

``interrupt_main`` lands between Python bytecodes only: it breaks a host
stall (a loader deadlock, a retry loop, a sleep), not one blocking native
call such as a CUDA synchronisation or a collective that never returns.
There the stacks are still logged, and the process must be killed from
outside (JAX has the same limit).
"""
from __future__ import annotations

import _thread
import logging
import sys
import threading
import time
import traceback
from typing import Callable, Optional

import torch

log = logging.getLogger("zero_transformer_tpu_torch")


def dump_stacks(reason: str = "watchdog") -> str:
    """Every live thread's Python stack and the card's memory, logged."""
    lines = [f"=== {reason}: thread stacks ==="]
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(line.rstrip() for line in traceback.format_stack(frame))
    try:
        if torch.cuda.is_available():
            lines.append(f"--- device memory: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
                         f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved ---")
    except Exception as e:  # diagnostics must never mask the hang itself
        lines.append(f"--- device memory stats unavailable: {e!r} ---")
    text = "\n".join(lines)
    log.error("%s", text)
    return text


class Watchdog:
    """A deadline thread over a heartbeat the owner touches each step.
    ``fired_after_s`` is how long the loop had been silent when it fired."""

    def __init__(self, timeout_s: float, on_hang: Optional[Callable[[], None]] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError("watchdog timeout must be > 0 (0 disables upstream)")
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self.poll_s = poll_s if poll_s is not None else min(timeout_s / 4.0, 1.0)
        self.fired = False
        self.fired_after_s: Optional[float] = None
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def start(self) -> "Watchdog":
        self.beat()
        self._thread = threading.Thread(target=self._watch, daemon=True, name="zt-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4 + 1.0)
            self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled = time.monotonic() - self._last_beat
            if stalled <= self.timeout_s:
                continue
            self.fired = True
            self.fired_after_s = stalled
            log.error("watchdog: no heartbeat for %.1fs (deadline %.1fs): dumping stacks, force-saving, "
                      "aborting retryably", stalled, self.timeout_s)
            dump_stacks("watchdog deadline expired")
            if self.on_hang is not None:
                # a side thread with a bounded join: the hook may hang on the
                # very stall that fired the watchdog, and the abort must not
                # depend on it
                hook = threading.Thread(target=self._run_hook, daemon=True, name="zt-watchdog-hook")
                hook.start()
                hook.join(timeout=self.timeout_s)
                if hook.is_alive():
                    log.error("watchdog: on_hang hook still running after %.1fs; aborting without it",
                              self.timeout_s)
            # KeyboardInterrupt in the main thread at its next bytecode; the
            # trainer re-raises it as HangError
            _thread.interrupt_main()
            return

    def _run_hook(self) -> None:
        try:
            self.on_hang()
        except Exception:
            log.exception("watchdog on_hang hook failed (continuing abort)")
