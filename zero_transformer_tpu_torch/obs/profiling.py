"""Profile capture windows over the train loop.

Counterpart of ``zero_transformer_tpu/obs/profiling.py``:
``parse_profile_window`` is the same parser of ``train --profile-window
START:LEN``, and ``ProfileWindow`` the same single-owner window
(``request`` stages a capture of N loop iterations, ``poll`` at the top of
each iteration starts it and stops it N iterations later). The capture is
``torch.profiler`` with CPU and CUDA activity (CPU only off a card),
written as a Chrome trace, ``<directory>/<name>/trace.json`` (the trainer's
``directory`` is ``training.profile_dir``, by default
``<checkpoint.directory>/profile``; the serving engine's is
``<obs_dir>/profiles``, staged by ``POST /admin/profile``).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import torch

log = logging.getLogger("zero_transformer_tpu_torch")


def parse_profile_window(spec: str) -> Tuple[int, int]:
    """``"START:LEN"`` -> (start_step, n_steps); both must be positive."""
    try:
        start_s, _, len_s = spec.partition(":")
        start, length = int(start_s), int(len_s)
    except ValueError:
        raise ValueError(
            f"--profile-window expects START:LEN (e.g. 100:20), got {spec!r}"
        ) from None
    if start < 1 or length < 1:
        raise ValueError(
            f"--profile-window START and LEN must be >= 1, got {spec!r}"
        )
    return start, length


class ProfileWindow:
    """``request(n, name)`` stages a capture (any thread); ``poll(tick)``,
    called by the owning loop before each iteration's work, starts it, and
    stops it once ``tick`` reaches the start tick plus ``n``; ``abort``
    stops a live capture at once. A stopped capture is written."""

    def __init__(self, directory: Optional[str]):
        self.directory = str(directory) if directory else None
        self._pending: Optional[Tuple[int, str]] = None
        self._active: Optional[list] = None  # [target tick, path, profiler]
        self._busy = False
        self.completed: list = []  # directories of finished captures

    @property
    def active(self) -> bool:
        return self._busy

    def request(self, ticks: int, name: str) -> dict:
        """Stage a capture of the next ``ticks`` iterations into
        ``<directory>/<name>``. Raises RuntimeError without a directory or
        while a capture is staged or running (one profiler at a time)."""
        if ticks < 1:
            raise ValueError("profile ticks must be >= 1")
        if self.directory is None:
            raise RuntimeError("profiling is disabled: no profile directory configured")
        if self._busy:
            raise RuntimeError("a profile capture is already in progress")
        self._busy = True
        path = str(Path(self.directory) / name)
        self._pending = (int(ticks), path)
        return {"path": path, "ticks": int(ticks)}

    def poll(self, tick: int) -> None:
        if self._active is not None and tick >= self._active[0]:
            self._stop()
        if self._pending is not None and self._active is None:
            ticks, path = self._pending
            self._pending = None
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            try:
                Path(path).mkdir(parents=True, exist_ok=True)
                prof = profile(activities=activities)
                prof.start()
            except Exception:
                log.exception("profiler: start failed (capture skipped)")
                self._busy = False
                return
            self._active = [tick + ticks, path, prof]
            log.info("profiler: capturing %d iterations to %s", ticks, path)

    def abort(self) -> None:
        self._pending = None
        if self._active is not None:
            self._stop()
        self._busy = False

    def _stop(self) -> None:
        _, path, prof = self._active
        self._active = None
        self._busy = False
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the captured steps finish on the card first
            prof.stop()
            trace = str(Path(path) / "trace.json")
            prof.export_chrome_trace(trace)
        except Exception:
            log.exception("profiler: stop or export failed")
            return
        self.completed.append(path)
        log.info("profiler: capture finished -> %s", trace)
