"""The per-step anomaly guard and the host snapshot a rollback restores.

Counterpart of ``zero_transformer_tpu/resilience/anomaly.py``. The
trainer reads the loss only at log points, so a non-finite or runaway
update at any other step would land in the params and then in the next
checkpoint. The guard closes that blind spot without a host sync:

- ``flag`` is 0-d tensor arithmetic on the device (JAX ``_flag`` :115-128):
  a non-finite loss or grad norm, or, once ``spike_warmup_steps`` clean
  steps have seeded the EMAs, a loss or grad norm past its spike factor
  times its EMA;
- the train step (``parallel/zero.py``) computes it between the global
  grad norm and the update and hands the optimizer ``keep = ~flag``: every
  write of the update selects the old value on a flagged step
  (``training/optimizer.py``), so the update never lands. JAX selects the
  old state after a functional step (``wrap`` :147-168); the port's step is
  in place, so the select moves inside the optimizer's passes;
- ``advance`` moves the carry (``count``, ``streak``, ``loss_ema``,
  ``grad_ema``, ``seen``, ``audit_failures``) on the device (JAX
  ``_advance_carry`` :130-145); ``read`` is its one sync, made at log
  points, where the trainer decides skip, rollback or halt.

``HostSnapshot`` keeps a copy of the state a rollback restores: this
rank's flat param shard, the optimizer's tensors and its count, in pinned
host memory on a card (a copy, never a view). ``restore`` copies them back
in place and refreshes the whole-param buffer of ZeRO stages 1-2 from the
restored shards; the step counter, and with it the loader, moves on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from zero_transformer_tpu_torch.config import ResilienceConfig

if TYPE_CHECKING:
    from zero_transformer_tpu_torch.parallel.zero import TrainState

Carry = Dict[str, torch.Tensor]
CARRY_KEYS = ("count", "streak", "loss_ema", "grad_ema", "seen", "audit_failures")
_INT_KEYS = ("count", "streak", "seen", "audit_failures")


@dataclasses.dataclass(frozen=True)
class AnomalyStats:
    """The carry on the host (one read a log point)."""

    count: int  # flagged (dropped) steps since the carry started
    streak: int  # consecutive flagged steps ending at the current step
    loss_ema: float
    grad_ema: float
    audit_failures: int = 0  # replica audits that found a divergence


def init_carry(device) -> Carry:
    return {k: torch.zeros((), dtype=torch.int32 if k in _INT_KEYS else torch.float32, device=device)
            for k in CARRY_KEYS}


def flag(cfg: ResilienceConfig, loss: torch.Tensor, grad_norm: torch.Tensor, carry: Carry) -> torch.Tensor:
    """Whether this step is anomalous: a 0-d bool tensor (JAX ``_flag``)."""
    loss, grad_norm = loss.float(), grad_norm.float()
    bad = ~(torch.isfinite(loss) & torch.isfinite(grad_norm))
    warm = carry["seen"] >= cfg.spike_warmup_steps
    if cfg.loss_spike_factor > 0:
        bad = bad | (warm & (loss > cfg.loss_spike_factor * carry["loss_ema"]))
    if cfg.grad_spike_factor > 0:
        bad = bad | (warm & (grad_norm > cfg.grad_spike_factor * carry["grad_ema"]))
    return bad


def advance_carry(cfg: ResilienceConfig, bad: torch.Tensor, loss: torch.Tensor, grad_norm: torch.Tensor,
                  carry: Carry) -> Carry:
    """The carry after this step (JAX ``_advance_carry``): the first clean
    sample seeds each EMA, a flagged sample never enters it."""
    d = cfg.ema_decay
    first = carry["seen"] == 0

    def ema(prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        seeded = torch.where(first, x, d * prev + (1.0 - d) * x)
        return torch.where(bad, prev, seeded)

    return {
        "count": carry["count"] + bad.to(torch.int32),
        "streak": torch.where(bad, carry["streak"] + 1, torch.zeros_like(carry["streak"])),
        "loss_ema": ema(carry["loss_ema"], loss.float()),
        "grad_ema": ema(carry["grad_ema"], grad_norm.float()),
        "seen": carry["seen"] + (~bad).to(torch.int32),
        "audit_failures": carry["audit_failures"],
    }


class AnomalyGuard:
    """The guard of one trainer: its config and its carry, on ``device``.
    The train step calls ``flag`` and ``advance``; the trainer calls
    ``read`` at log points, ``record_audit`` after a replica audit and
    ``reset`` after a rollback (a fresh carry, as JAX's)."""

    def __init__(self, cfg: ResilienceConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.carry = init_carry(self.device)

    def flag(self, loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
        return flag(self.cfg, loss, grad_norm, self.carry)

    def advance(self, bad: torch.Tensor, loss: torch.Tensor, grad_norm: torch.Tensor) -> None:
        self.carry = advance_carry(self.cfg, bad, loss, grad_norm, self.carry)

    def record_audit(self, diverged: bool) -> None:
        if diverged:
            self.carry["audit_failures"] = self.carry["audit_failures"] + 1

    def reset(self) -> None:
        self.carry = init_carry(self.device)

    def read(self) -> AnomalyStats:
        """The carry on the host: one device-to-host copy (the sync that
        the steps between log points never make)."""
        values = torch.stack([self.carry[k].double() for k in CARRY_KEYS]).tolist()
        host = dict(zip(CARRY_KEYS, values))
        return AnomalyStats(count=int(host["count"]), streak=int(host["streak"]), loss_ema=host["loss_ema"],
                            grad_ema=host["grad_ema"], audit_failures=int(host["audit_failures"]))


class HostSnapshot:
    """A host copy of a known-good train state for rollback. The buffers
    are allocated at the first capture (pinned when the state is on a card)
    and reused. ``bytes`` and ``capture_ms`` describe the latest capture."""

    def __init__(self):
        self.step: Optional[int] = None
        self.bytes = 0
        self.capture_ms = 0.0
        self._host: Optional[List[torch.Tensor]] = None

    @property
    def captured(self) -> bool:
        return self.step is not None

    @staticmethod
    def device_tensors(state: "TrainState") -> List[torch.Tensor]:
        """What a snapshot holds: this rank's param shard, the optimizer's
        tensors and its count (the shard is the whole buffer at stage 0)."""
        opt = state.shards.optimizer
        return [state.shards.shard, *opt.tensors(), opt.count]

    def host_tensors(self) -> List[torch.Tensor]:
        if self._host is None:
            raise RuntimeError("no snapshot captured")
        return list(self._host)

    def capture(self, state: "TrainState") -> None:
        t0 = time.perf_counter()
        tensors = self.device_tensors(state)
        if self._host is None:
            pin = tensors[0].device.type == "cuda"
            self._host = [torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin) for t in tensors]
            self.bytes = sum(t.numel() * t.element_size() for t in tensors)
        with torch.no_grad():
            for host, t in zip(self._host, tensors):
                host.copy_(t, non_blocking=True)
        if tensors[0].device.type == "cuda":
            torch.cuda.synchronize(tensors[0].device)  # the copies land before anyone reads them
        self.step = state.step
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def restore(self, state: "TrainState") -> None:
        """Copy the snapshot back in place; ``state.step`` is kept."""
        if self._host is None:
            raise RuntimeError("no snapshot captured")
        with torch.no_grad():
            for host, t in zip(self._host, self.device_tensors(state)):
                t.copy_(host, non_blocking=True)
        state.shards.all_gather_params()
