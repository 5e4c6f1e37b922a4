"""Fault tolerance for long training runs.

Counterpart of ``zero_transformer_tpu/resilience/`` (its ``__init__``
:1-87), in the same layers:

- ``anomaly``: the per-step guard on the device (a flagged update never
  lands) and the host snapshot a rollback restores; skip -> rollback ->
  halt is decided by the trainer at log points;
- ``watchdog``: a heartbeat deadline on the train loop (dump stacks,
  force-save, abort retryably);
- ``supervisor``: bounded in-process restarts with backoff and the
  retryable-versus-fatal classification (``train --supervise``);
- ``chaos``: fault injection that proves the above in the tests;
- ``detect``: the content digest of checkpoints and the replica audit.

The exception hierarchy is JAX's, which the supervisor's classifier reads.
"""
from __future__ import annotations


class RetryableError(RuntimeError):
    """An error worth a restart from the last good checkpoint: transient
    storage or loader failures, hangs, preemptions (``supervisor.classify``
    also matches foreign exceptions by type and message)."""


class HangError(RetryableError):
    """The watchdog found the train loop stalled past its deadline."""


class AnomalyHalt(RuntimeError):
    """The anomaly policy escalated to halt (a flagged step under "halt", a
    skip streak at its limit, the rollback budget spent, or a replica
    divergence that cannot heal). Fatal to the supervisor: a run that
    diverges the same way from its last checkpoint would restart forever."""


# lazy re-exports (PEP 562): importing the package stays light
_LAZY = {
    "AnomalyGuard": "anomaly",
    "HostSnapshot": "anomaly",
    "leaf_checksum": "detect",
    "ChaosMonkey": "chaos",
    "Fault": "chaos",
    "perturb_one_replica": "chaos",
    "Supervisor": "supervisor",
    "classify": "supervisor",
    "backoff_delay": "supervisor",
    "Watchdog": "watchdog",
}

__all__ = ["RetryableError", "HangError", "AnomalyHalt", *_LAZY]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
