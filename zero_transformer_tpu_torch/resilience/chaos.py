"""Chaos injection: deterministic faults that prove the resilience layer.

Counterpart of ``zero_transformer_tpu/resilience/chaos.py`` for the kinds
one trainer process can meet. ``ChaosMonkey`` injects them at exact steps,
so a test can hold a faulted, supervised run against an undisturbed one:

- ``step_poison``: the train step's seam (``parallel/zero.py``). Inside a
  ``nan_step`` window of ``state.step`` it adds NaN to the loss and to the
  reduced grads before the norm, so the norm and the would-be update go
  non-finite as in a real blow-up, and the anomaly guard sees it through
  the same metrics. The window is decided on the device, by a step counter
  of its own: no host branch, no sync (JAX poisons inside the jitted step,
  ``wrap_train_step``);
- ``wrap_loader`` / ``wrap_checkpoint``: proxies that raise, delay or
  corrupt at a chosen batch or save;
- ``on_step``: host faults the trainer calls after each completed step
  (SIGTERM to this process; a hang the watchdog must break);
- ``perturb_state``: ``replica_perturb``, one data rank's copy of the
  replicated params desynced (what the replica audit exists to catch).

A ``Fault`` records having fired and stays fired when the same monkey is
reused across supervisor restarts, so "fault once, recover, complete" can
end. The fleet's process-level kinds (``sigkill``, ``sigstop``,
``hb_blackhole``, ``slow_worker``) are not ported.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

log = logging.getLogger("zero_transformer_tpu_torch")

KINDS = ("nan_step", "loader_error", "sigterm", "ckpt_fail", "ckpt_slow", "ckpt_truncate", "ckpt_bitflip",
         "hang", "replica_perturb")


@dataclasses.dataclass
class Fault:
    """One injectable fault.

    ``step``: for ``nan_step`` the 0-based ``state.step`` being computed;
    for ``sigterm``, ``hang`` and ``replica_perturb`` the first completed
    step (1-based) at or after which it fires; for ``loader_error`` the
    0-based index of the batch whose fetch raises (counted from the start
    of this trainer's iteration); for ``ckpt_fail`` / ``ckpt_slow`` the
    first save at or after it; for ``ckpt_truncate`` / ``ckpt_bitflip`` the
    first save at or after it that writes, whose committed step directory
    is then corrupted. ``duration``: poisoned steps (``nan_step``) or
    seconds (``ckpt_slow``, the ``hang`` cap). ``exc`` and ``message``:
    what ``loader_error`` and ``ckpt_fail`` raise."""

    kind: str
    step: int
    duration: float = 1
    exc: type = OSError
    message: str = "chaos: injected fault"
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; the port injects {KINDS}")


class _ChaosLoader:
    """A loader proxy that raises ``fault.exc`` before yielding batch N."""

    def __init__(self, inner, fault: Fault, monkey: "ChaosMonkey"):
        self._inner = inner
        self._fault = fault
        self._monkey = monkey

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __iter__(self):
        inner = iter(self._inner)
        try:
            for i, batch in enumerate(inner):
                f = self._fault
                if not f.fired and i >= f.step:
                    self._monkey.record(f)
                    raise f.exc(f"{f.message} (loader batch {i})")
                yield batch
        finally:
            inner.close()  # stops the loader's read-ahead thread


def corrupt_step_dir(step_dir, kind: str) -> List[str]:
    """Storage-level corruption of a committed step directory
    (``checkpoint.py``'s safetensors files). ``ckpt_truncate`` halves each
    tensor file (a torn write: the restore cannot parse it);
    ``ckpt_bitflip`` flips the low bit of one byte in every 64 over the
    back half of each tensor file, which holds tensor data: the files
    still parse and the tensors come back silently wrong, which only the
    manifest's digests catch. Either way ``restore_verified`` quarantines
    the step. Returns the files touched."""
    files = sorted(Path(str(step_dir)).glob("*.safetensors"))
    touched = []
    for f in files:
        data = bytearray(f.read_bytes())
        if kind == "ckpt_truncate":
            data = data[: len(data) // 2]
        else:
            for off in range(len(data) // 2, len(data), 64):
                data[off] ^= 0x01
        f.write_bytes(bytes(data))
        touched.append(str(f))
    return touched


class _ChaosCheckpoint:
    """A ``CheckpointManager`` proxy: a failing, slow or corrupted ``save``."""

    def __init__(self, inner, faults: List[Fault], monkey: "ChaosMonkey"):
        self._inner = inner
        self._faults = faults
        self._monkey = monkey

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, step: int, leaves, meta=None, force: bool = False):
        for f in self._faults:
            if f.fired or step < f.step or f.kind in ("ckpt_truncate", "ckpt_bitflip"):
                continue
            self._monkey.record(f)
            if f.kind == "ckpt_fail":
                raise f.exc(f"{f.message} (checkpoint save at step {step})")
            log.warning("chaos: delaying checkpoint save %.1fs", f.duration)
            time.sleep(f.duration)
        saved = self._inner.save(step, leaves, meta=meta, force=force)
        if saved:
            for f in self._faults:
                if f.fired or step < f.step or f.kind not in ("ckpt_truncate", "ckpt_bitflip"):
                    continue
                # after the commit: storage rot on a checkpoint that "succeeded"
                self._inner.wait()
                self._monkey.record(f)
                touched = corrupt_step_dir(self._inner.step_path(step), f.kind)
                log.warning("chaos: %s corrupted step %d (%d file(s))", f.kind, step, len(touched))
        return saved


class ChaosMonkey:
    """The fault plan and its wiring into a trainer's seams. Reuse one
    monkey across supervisor restarts: fired faults stay fired."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self.fired_log: List[str] = []

    def record(self, fault: Fault) -> None:
        fault.fired = True
        entry = f"{fault.kind}@{fault.step}"
        self.fired_log.append(entry)
        log.warning("chaos: fired %s", entry)

    def _of_kind(self, *kinds: str) -> List[Fault]:
        return [f for f in self.faults if f.kind in kinds]

    # -- trainer seams ------------------------------------------------------

    def step_poison(self) -> Optional[Callable]:
        """The train step's ``poison`` for the ``nan_step`` windows, or None
        without any: ``poison(state)`` returns a 0-d float32 tensor, NaN
        where its step counter (``state.step`` at the first call, then one
        more each call, on the device) lies in ``[step, step + duration)``
        of a window, else 0."""
        windows = self._of_kind("nan_step")
        if not windows:
            return None
        counter: List[torch.Tensor] = []

        def poison(state) -> torch.Tensor:
            if not counter:
                counter.append(torch.full((), state.step, dtype=torch.int64, device=state.shards.device))
            s = counter[0]
            inside = torch.zeros((), dtype=torch.bool, device=s.device)
            for f in windows:
                inside = inside | ((s >= f.step) & (s < f.step + int(f.duration)))
            s.add_(1)
            return torch.where(inside, float("nan"), 0.0)

        return poison

    def wrap_loader(self, loader):
        faults = self._of_kind("loader_error")
        if not faults:
            return loader
        if len(faults) > 1:
            raise ValueError("one loader_error fault at a time")
        return _ChaosLoader(loader, faults[0], self)

    def wrap_checkpoint(self, ckpt):
        faults = self._of_kind("ckpt_fail", "ckpt_slow", "ckpt_truncate", "ckpt_bitflip")
        if not faults:
            return ckpt
        return _ChaosCheckpoint(ckpt, faults, self)

    def perturb_state(self, step: int, state) -> None:
        """``replica_perturb``: after a completed step at or past the
        fault's, desync one data rank's copy of the replicated params."""
        for f in self._of_kind("replica_perturb"):
            if f.fired or step < f.step:
                continue
            self.record(f)
            perturb_one_replica(state)

    def on_step(self, step: int) -> None:
        """Host faults, after each completed step."""
        for f in self._of_kind("sigterm", "hang"):
            if f.fired or step < f.step:
                continue
            self.record(f)
            if f.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                # an interruptible hang: short sleeps keep bytecode
                # boundaries frequent so interrupt_main lands; the cap keeps
                # a broken watchdog from stalling the run for good
                deadline = time.monotonic() + float(f.duration)
                while time.monotonic() < deadline:
                    time.sleep(0.01)
                log.error("chaos: hang cap %.0fs elapsed without a watchdog abort", float(f.duration))


def perturb_one_replica(state) -> None:
    """Add 1 to element 0 of the last data rank's whole-param buffer, in
    place; every other rank's copy stays as it was. At stage 0 every rank
    holds that buffer whole (and updates it with the same reduced grads,
    so the desync persists); at stages 1-2 element 0 belongs to rank 0's
    shard, and the next step's all-gather overwrites the last rank's copy.
    Raises ValueError where no replicated copy exists: one data rank, or
    stage 3."""
    zs = state.shards
    if zs.group.size < 2 or zs.full is None:
        raise ValueError("replica_perturb: no replicated param copy to desync (one data rank, or ZeRO stage 3)")
    if zs.group.rank == zs.group.size - 1:
        with torch.no_grad():
            zs.full[0] += 1.0
