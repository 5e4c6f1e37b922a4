"""The trainer: config -> model -> schedule -> optimizer -> train step ->
loaders -> metrics.

Counterpart of ``zero_transformer_tpu/training/trainer.py`` for the
single-card slice: ``build_training`` (:144-187), ``Trainer.train`` (:729)
with its log cadence, ``Trainer.evaluate`` (:645) over a pinned validation
window, and the stop on a non-finite loss (``training.halt_on_nan``).
Checkpoint save and resume, the resilience policies beyond halting, the
observability spans and profiling are not ported: the trainer prints which
settings of the config it does not act on.

Every ``log_frequency`` steps it syncs once and logs ``loss``,
``perplexity``, ``grad_norm``, ``learning_rate``, ``tokens_per_sec`` and
``step_time_ms`` (wall time over the window, which ends in that sync), plus
the model-FLOPs share on a card whose bf16 peak it knows and the tar
source's nonzero fault counts (``data_*``), to stdout and to
``<checkpoint.directory>/metrics.jsonl``. Packed-document models
(``doc_sep_token``) train and evaluate as any other: the model masks
attention and loss per document.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from zero_transformer_tpu_torch.config import Config, resolve_device
from zero_transformer_tpu_torch.data import DataLoader, make_loader, to_device
from zero_transformer_tpu_torch.models.registry import build_model
from zero_transformer_tpu_torch.parallel.zero import TrainState, make_eval_step, make_train_step
from zero_transformer_tpu_torch.training.optimizer import make_optimizer, make_schedule

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


class MetricsLogger:
    """stdout plus ``<directory>/metrics.jsonl``, one JSON object per line."""

    def __init__(self, directory: Optional[str]):
        self._file = None
        if directory:
            path = Path(directory)
            path.mkdir(parents=True, exist_ok=True)
            self._file = open(path / "metrics.jsonl", "a", buffering=1)

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "") -> None:
        clean = {(f"{prefix}/{k}" if prefix else k): v for k, v in metrics.items()}
        if self._file:
            self._file.write(json.dumps({"step": step, **clean}) + "\n")
        parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in clean.items())
        print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


@dataclasses.dataclass
class TrainingBuild:
    state: TrainState
    schedule: Callable[[int], float]
    train_step: Callable
    eval_step: Callable


def build_training(cfg: Config, device) -> TrainingBuild:
    """Model (seeded from ``training.seed``, trainable), schedule, AdamW and
    the steps. The optimizer's horizon is ``training.total_steps``, as in JAX."""
    dev = resolve_device(device)
    if cfg.model.dropout > 0:
        raise NotImplementedError(f"dropout {cfg.model.dropout} > 0 in training is not ported yet")
    opt = dataclasses.replace(cfg.optimizer, total_steps=cfg.training.total_steps)
    model = build_model(cfg.model, dev, seed=cfg.training.seed, trainable=True)
    schedule = make_schedule(opt)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(model, opt, schedule))
    train_step = make_train_step(cfg.mesh.zero_stage, schedule, cfg.training.grad_accum_dtype)
    return TrainingBuild(state=state, schedule=schedule, train_step=train_step,
                         eval_step=make_eval_step(model))


class Trainer:
    def __init__(self, cfg: Config, device="cuda", train_loader: Optional[DataLoader] = None,
                 val_loader: Optional[DataLoader] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        build = build_training(cfg, self.device)
        self.state, self.schedule = build.state, build.schedule
        self.train_step, self.eval_step = build.train_step, build.eval_step
        self.train_loader = train_loader if train_loader is not None else make_loader(cfg)
        self._val_loader = val_loader
        self._val_window: Optional[dict] = None
        self.metrics = MetricsLogger(cfg.checkpoint.directory)
        t = cfg.training
        self.tokens_per_step = t.batch_size * t.train_context * max(t.gradient_accumulation_steps, 1)
        self.flops_per_token = model_flops_per_token(
            cfg.model.num_params, cfg.model.n_layers, cfg.model.d_model, t.train_context
        )
        self.peak = peak_flops(self.device, cfg.model.compute_dtype)
        print(json.dumps({"trainer": {
            "device": str(self.device), "world_size": 1, "zero_stage": cfg.mesh.zero_stage,
            "model": cfg.model.name, "params": cfg.model.num_params,
            "tokens_per_step": self.tokens_per_step,
            "not_ported_ignored": {"checkpoint.save_frequency": cfg.checkpoint.save_frequency,
                                   **{f"resilience.{k}": v for k, v in cfg.resilience.unported().items()}},
        }}), flush=True)

    @property
    def val_loader(self) -> DataLoader:
        if self._val_loader is None:
            self._val_loader = make_loader(self.cfg, validation=True)
        return self._val_loader

    def evaluate(self) -> Dict[str, float]:
        """Mean loss over ``maximum_evaluation_steps`` validation batches,
        always the same window (the source state is pinned at the first call)."""
        if self._val_window is None:
            self._val_window = self.val_loader.source.state()
        else:
            self.val_loader.source.restore(self._val_window)
        total, n = 0.0, 0
        it = iter(self.val_loader)
        for _ in range(self.cfg.training.maximum_evaluation_steps):
            total += float(self.eval_step(to_device(next(it)[0], self.device)))
            n += 1
        loss = total / max(n, 1)
        return {"loss": loss, "perplexity": math.exp(min(loss, 20.0))}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg.training
        start = self.state.step
        end = min(cfg.total_steps, start + max_steps) if max_steps else cfg.total_steps
        it = iter(self.train_loader)
        try:
            return self._train_loop(it, start, end)
        finally:
            it.close()  # stops the loader's read-ahead thread; unseen batches are kept

    def _train_loop(self, it, start: int, end: int) -> TrainState:
        cfg = self.cfg.training
        self._sync()
        t0, step0 = time.perf_counter(), start
        step = start
        while step < end:
            metrics = self.train_step(self.state, to_device(next(it), self.device))
            step = self.state.step
            if step % cfg.log_frequency == 0 or step == end:
                loss = float(metrics["loss"])  # the log point's one sync
                if cfg.halt_on_nan and not math.isfinite(loss):
                    raise RuntimeError(f"non-finite loss {loss} at step {step}; training halted")
                self._sync()
                now = time.perf_counter()
                per_step = (now - t0) / (step - step0)
                payload = {
                    "loss": loss,
                    "perplexity": math.exp(min(loss, 20.0)),
                    "grad_norm": float(metrics["grad_norm"]),
                    "learning_rate": float(metrics["learning_rate"]),
                    "tokens_seen": float(step * self.tokens_per_step),
                    "tokens_per_sec": self.tokens_per_step / per_step,
                    "step_time_ms": per_step * 1e3,
                }
                if self.peak:
                    payload["model_flops_share"] = (
                        payload["tokens_per_sec"] * self.flops_per_token / self.peak
                    )
                payload.update({f"data_{k}": float(v)
                                for k, v in self.train_loader.fault_counters().items() if v})
                self.metrics.log(payload, step)
                t0, step0 = time.perf_counter(), step
            if cfg.evaluation_frequency and step % cfg.evaluation_frequency == 0:
                self.metrics.log(self.evaluate(), step, prefix="validation")
                self._sync()
                t0, step0 = time.perf_counter(), step  # eval time leaves the window
        return self.state

    def close(self) -> None:
        self.metrics.close()
