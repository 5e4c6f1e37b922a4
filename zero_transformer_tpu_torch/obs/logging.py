"""The metrics sink, model-FLOPs accounting and device memory stats.

Counterpart of ``zero_transformer_tpu/obs/logging.py``: ``MetricsLogger``
(stdout plus ``<directory>/metrics.jsonl``; ``event`` writes a one-off run
event into the same timeline, tagged ``event``), ``model_flops_per_token``
and the peak a model-FLOPs share divides by, and ``hbm_device_stats`` /
``hbm_used_gb``, which read ``torch.cuda.memory_stats`` where JAX reads
``Device.memory_stats``: the bytes the caching allocator has handed out
(``allocated_bytes.all.current``), None on the CPU.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch

# dense bf16 tensor-core peak by card (NVIDIA's data sheets, SXM parts)
BF16_PEAK_FLOPS = {"H100": 989e12, "H200": 989e12}


def model_flops_per_token(n_params: int, n_layers: int, d_model: int, seq_len: int) -> float:
    """FLOPs per trained token: 6N for the matrix products forward and
    backward plus 12 * L * d * T for attention (JAX ``model_flops_per_token``)."""
    return 3.0 * (2.0 * n_params + 4.0 * n_layers * d_model * seq_len)


def peak_flops(device: torch.device, compute_dtype: str) -> Optional[float]:
    if device.type != "cuda" or compute_dtype != "bfloat16":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in BF16_PEAK_FLOPS.items() if k in name), None)


def hbm_device_stats(device: torch.device) -> Optional[Dict[str, Any]]:
    """Device memory in use (GB) on this process's card, in JAX's shape
    (``per_device_gb``, ``max_gb``, ``mean_gb``), or None off a card."""
    if device.type != "cuda":
        return None
    gb = torch.cuda.memory_stats(device).get("allocated_bytes.all.current", 0) / 1e9
    return {"per_device_gb": [gb], "max_gb": gb, "mean_gb": gb}


def hbm_used_gb(device: torch.device) -> Optional[float]:
    stats = hbm_device_stats(device)
    return stats["max_gb"] if stats else None


class MetricsLogger:
    """stdout plus ``<directory>/metrics.jsonl``, one JSON object per line;
    silent with ``enabled=False`` (the ranks of a group other than 0)."""

    def __init__(self, directory: Optional[str], enabled: bool = True):
        self._file = None
        self.enabled = enabled
        if directory and enabled:
            path = Path(directory)
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / "metrics.jsonl", "a", buffering=1)

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "") -> None:
        if not self.enabled:
            return
        clean = {(f"{prefix}/{k}" if prefix else k): v for k, v in metrics.items()}
        if self._file:
            self._file.write(json.dumps({"step": step, **clean}) + "\n")
        parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in clean.items())
        print(f"[step {step}] {parts}", flush=True)

    def event(self, name: str, step: int, **fields: Any) -> None:
        """One run event (a rollback, a preemption, a watchdog abort, a
        quarantined checkpoint) in the metrics timeline, tagged ``event``."""
        if not self.enabled:
            return
        if self._file:
            self._file.write(json.dumps({"step": step, "event": name, **fields}, default=str) + "\n")
        parts = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[step {step}] EVENT {name} {parts}", flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
