"""The trainer: config -> mesh -> model -> schedule -> ZeRO state -> train
step -> loaders -> metrics and checkpoints.

Counterpart of ``zero_transformer_tpu/training/trainer.py``:
``build_training`` (:144-187), ``remap_loader_state`` (:80), ``init_state``
(:490-574: verified resume, warm init), ``Trainer.train`` (:729) with its
log cadence and its saves (on ``save_frequency``, :1058, and at the end,
:1108-1111), ``Trainer.evaluate`` (:645) over a pinned validation window,
and the stop on a non-finite loss (``training.halt_on_nan``). The
resilience policies beyond halting (and the replica audit's halt), the
observability spans and profiling are not ported: the trainer prints which
settings of the config it does not act on.

Every ``log_frequency`` steps it syncs once and logs ``loss``,
``perplexity``, ``grad_norm``, ``learning_rate``, ``tokens_per_sec`` and
``step_time_ms`` (wall time over the window, which ends in that sync), plus
the model-FLOPs share on a card whose bf16 peak it knows, ``ckpt_verify_ms``
(the digest time of the latest save), the quarantined steps of a resume and
the tar source's nonzero fault counts (``data_*``), to stdout and to
``<checkpoint.directory>/metrics.jsonl``. Packed-document models
(``doc_sep_token``) train and evaluate as any other: the model masks
attention and loss per document.

Several processes (one per rank under ``torch.distributed.run``) form a
``data x sequence`` mesh (``parallel/mesh.py``). The ranks of a sequence
group read the same rows and run their shard of each through the ring; the
data groups read different rows (the loader's process index and count are
the data rank and size) and train under ZeRO ``mesh.zero_stage``
(``parallel/zero.py``). Rank 0 builds the CUDA kernels while the others
wait at a barrier; only rank 0 writes ``metrics.jsonl``, stdout and the
checkpoints. tokens/s counts the global tokens of a step, and the
model-FLOPs share divides by the peak of the distinct cards the ranks use.
A resume at another world size re-slices the saved whole tensors, after
``check_elastic_compat`` accepted the topology, and continues the loader
by ``remap_loader_state``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from zero_transformer_tpu_torch.checkpoint import (CheckpointManager, RestoreReport, import_params_msgpack,
                                                   save_config_json)
from zero_transformer_tpu_torch.config import Config, resolve_device
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.data import DataLoader, make_loader, to_device
from zero_transformer_tpu_torch.models.registry import build_model
from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.parallel.mesh import Mesh, init_distributed, single_process
from zero_transformer_tpu_torch.parallel.sharding import check_elastic_compat, topology_summary
from zero_transformer_tpu_torch.parallel.zero import (TrainState, init_train_state, make_eval_step,
                                                      make_replica_audit, make_train_step)
from zero_transformer_tpu_torch.training.optimizer import make_schedule

log = logging.getLogger("zero_transformer_tpu_torch")

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

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


def remap_loader_state(meta: Optional[dict], batch_size: int, train_context: int,
                       accum_steps: int = 1) -> Optional[dict]:
    """A saved loader position mapped onto this run's batch geometry (JAX
    ``remap_loader_state``, ``trainer.py:80``). The position counts global
    optimizer steps, so a new world size alone needs no remap; a new
    ``batch_size``, ``train_context`` or accumulation depth remaps by token
    count, rounding down to a whole step: up to one step's tokens are
    replayed, never skipped."""
    loader_state = (meta or {}).get("loader")
    if not loader_state:
        return None
    sched = (meta or {}).get("schedule") or {}
    old_bs = int(sched.get("batch_size", batch_size))
    old_ctx = int(sched.get("train_context", train_context))
    old_accum = int(sched.get("accum_steps", accum_steps))
    if (old_bs, old_ctx, old_accum) == (batch_size, train_context, accum_steps):
        return loader_state
    tokens = int(loader_state.get("steps_consumed", 0)) * old_bs * old_accum * old_ctx
    new_steps, replayed = divmod(tokens, batch_size * accum_steps * train_context)
    if replayed:
        log.warning("loader remap: batch geometry changed (%d seq x %d accum x %d tok -> %d x %d x %d); "
                    "resuming at optimizer step %d replays %d tokens", old_bs, old_accum, old_ctx, batch_size,
                    accum_steps, train_context, new_steps, replayed)
    return {"steps_consumed": int(new_steps)}


def flat_config(cfg: Config) -> Dict[str, Any]:
    """``{"section.field": value}`` of every field (JAX ``save_config_json``'s input)."""
    return {f"{section}.{k}": v for section, fields in dataclasses.asdict(cfg).items() for k, v in fields.items()}


@dataclasses.dataclass
class TrainingBuild:
    state: TrainState
    schedule: Callable[[int], float]
    train_step: Callable
    eval_step: Callable
    audit: Optional[Callable[[], bool]]


def build_training(cfg: Config, device, mesh: Optional[Mesh] = None) -> TrainingBuild:
    """Model (seeded from ``training.seed``, trainable: the same weights on
    every rank), schedule, the ZeRO state over ``mesh``'s data group and the
    steps. The optimizer's horizon is ``training.total_steps``, as in JAX.
    ``mesh`` None is one process; ``mesh.sequence`` > 1 or ``mesh.data`` > 1
    need a mesh of that many ranks."""
    if cfg.model.param_quant != "none":
        raise ValueError(
            "param_quant is an inference-only configuration (serve "
            "--quantize); training runs on full-precision params"
        )
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else single_process(dev)
    if cfg.mesh.sequence != mesh.sequence.size:
        raise ValueError(f"mesh.sequence {cfg.mesh.sequence} needs a sequence group of that many ranks, "
                         f"got {mesh.sequence.size}")
    if cfg.mesh.data not in (-1, mesh.data.size):
        raise ValueError(f"mesh.data {cfg.mesh.data} needs a data group of that many ranks, got {mesh.data.size}")
    opt = dataclasses.replace(cfg.optimizer, total_steps=cfg.training.total_steps)
    model = build_model(cfg.model, dev, seed=cfg.training.seed, trainable=True)
    model.set_sequence_group(mesh.sequence)
    schedule = make_schedule(opt)
    state = init_train_state(model, opt, schedule, mesh.data, cfg.mesh.zero_stage)
    train_step = make_train_step(cfg.mesh.zero_stage, schedule, cfg.training.grad_accum_dtype, mesh.sequence,
                                 seed=cfg.training.seed)
    return TrainingBuild(state=state, schedule=schedule, train_step=train_step,
                         eval_step=make_eval_step(model, mesh.data), audit=make_replica_audit(state.shards))


def needs_process_group(cfg: Config) -> bool:
    """Whether ``cfg`` runs on several ranks: ``mesh.data`` or
    ``mesh.sequence`` > 1, or a launch by ``torch.distributed.run`` with a
    world of several processes (``mesh.data`` -1 takes them all)."""
    return cfg.mesh.sequence > 1 or cfg.mesh.data > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1


class Trainer:
    def __init__(self, cfg: Config, device="cuda", train_loader: Optional[DataLoader] = None,
                 val_loader: Optional[DataLoader] = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is None:
            if needs_process_group(cfg):
                mesh = init_distributed(cfg.mesh.sequence, None, self.device, data=cfg.mesh.data)
            else:
                mesh = single_process(self.device)
        self.mesh = mesh
        self.device = mesh.device
        if mesh.world_size > 1 and self.device.type == "cuda":  # one nvcc per source, on rank 0 only
            if mesh.rank == 0:
                _build.build_all()
            mesh.barrier()
        rank0 = mesh.rank == 0
        build = build_training(cfg, self.device, mesh)
        self.state, self.schedule = build.state, build.schedule
        self.train_step, self.eval_step, self.audit = build.train_step, build.eval_step, build.audit
        self.train_loader = train_loader if train_loader is not None else make_loader(
            cfg, process_index=mesh.data.rank, process_count=mesh.data.size)
        self._val_loader = val_loader
        self._val_window: Optional[dict] = None
        self.metrics = MetricsLogger(cfg.checkpoint.directory, enabled=rank0)
        if rank0:
            save_config_json(cfg.checkpoint.directory, flat_config(cfg))
        ck = cfg.checkpoint
        self.ckpt = CheckpointManager(ck.directory, keep=ck.keep, save_frequency=ck.save_frequency,
                                      async_save=ck.async_save, integrity=ck.integrity)
        self._restore_report: Optional[RestoreReport] = None
        self._last_saved: Optional[int] = None
        self.last_save_ms = 0.0  # the latest save's time on this rank: gather, digests, host copy (and write)
        t = cfg.training
        self.tokens_per_step = t.batch_size * t.train_context * max(t.gradient_accumulation_steps, 1)
        self.flops_per_token = model_flops_per_token(
            cfg.model.num_params, cfg.model.n_layers, cfg.model.d_model, t.train_context
        )
        topology = mesh.describe()
        peak = peak_flops(self.device, cfg.model.compute_dtype)
        self.peak = peak * topology["cards"] if peak else None
        self.init_state()
        if not rank0:
            return
        print(json.dumps({"trainer": {
            **topology,
            "zero_stage": cfg.mesh.zero_stage, "model": cfg.model.name, "params": cfg.model.num_params,
            "tokens_per_step": self.tokens_per_step, "start_step": self.state.step,
            "persistent_state_bytes": self.state.shards.persistent_bytes(),
            "not_ported_ignored": {f"resilience.{k}": v for k, v in cfg.resilience.unported().items()},
        }}), flush=True)

    # -- checkpoints ----------------------------------------------------------

    def _save_meta(self) -> dict:
        t = self.cfg.training
        return {
            "opt_count": self.state.optimizer.count,
            "loader": self.train_loader.state(),
            "topology": topology_summary(self.mesh.data.size, self.mesh.sequence.size, self.cfg.mesh.zero_stage),
            "schedule": {"batch_size": t.batch_size, "train_context": t.train_context,
                         "accum_steps": max(t.gradient_accumulation_steps, 1)},
            "config": flat_config(self.cfg),
        }

    def save(self, force: bool = False) -> bool:
        """Save at the current step if it is due (or ``force``): every rank
        gathers the whole tensors, rank 0 writes, the others wait at a
        barrier. Every rank takes the same branch."""
        step = self.state.step
        if not force and not self.ckpt.due(step):
            return False
        t0 = time.perf_counter()
        leaves = self.state.shards.state_leaves()
        if self.mesh.rank == 0:
            self.ckpt.save(step, leaves, meta=self._save_meta(), force=True)
        del leaves
        self.mesh.barrier()
        self.last_save_ms = (time.perf_counter() - t0) * 1e3
        self._last_saved = step
        return True

    def _check_restore_meta(self, meta: dict) -> None:
        for note in check_elastic_compat((meta or {}).get("topology"), self.mesh.data.size,
                                         self.mesh.sequence.size, self.cfg.mesh.zero_stage,
                                         self.cfg.training.batch_size):
            log.warning("elastic resume: %s", note)
            print(json.dumps({"elastic_resume": note}), flush=True)

    def _restore_event(self, name: str, step: int, **fields) -> None:
        self.metrics.log({"event": name, **fields}, step)

    def _restore(self) -> Tuple[Dict[str, torch.Tensor], dict]:
        """Rank 0 restores the newest verified step (quarantining what fails);
        the other ranks read the step it chose."""
        if self.mesh.rank == 0:
            try:
                leaves, meta, report = self.ckpt.restore_verified(
                    self.state.shards.target(), check_meta=self._check_restore_meta,
                    on_event=self._restore_event, device=self.device)
            except BaseException as e:
                self.mesh.broadcast_object(("error", f"{type(e).__name__}: {e}"))
                raise
            self._restore_report = report
            self.mesh.broadcast_object(("ok", report.step))
            return leaves, meta
        status, value = self.mesh.broadcast_object(None)
        if status != "ok":
            raise RuntimeError(f"rank 0 could not restore a checkpoint: {value}")
        return self.ckpt.restore(value, device=self.device)

    def init_state(self) -> TrainState:
        """Resume from the newest verified step, warm-start the params, or
        keep the fresh init, as ``checkpoint`` says (JAX ``init_state``)."""
        ck, t = self.cfg.checkpoint, self.cfg.training
        shards = self.state.shards
        if ck.resume and self.ckpt.latest_step() is not None:
            leaves, meta = self._restore()
            shards.load_leaves(leaves, int(meta["opt_count"]))
            del leaves
            self.state.step = self._last_saved = int(meta["step"])
            loader_state = remap_loader_state(meta, t.batch_size, t.train_context,
                                              max(t.gradient_accumulation_steps, 1))
            if loader_state:
                self.train_loader.restore(loader_state)
            else:
                self.train_loader.skip(self.state.step)
            if self.mesh.rank == 0:
                report = self._restore_report
                print(json.dumps({"resumed": {"step": self.state.step, "verify_ms": report.verify_ms,
                                              "quarantined": report.quarantined,
                                              "fallback_steps": report.fallback_steps}}), flush=True)
            return self.state
        if ck.resume and self.ckpt.incomplete_steps() and self.mesh.rank == 0:
            log.error("resume: step dir(s) %s under %s are incomplete; starting fresh from step 0",
                      self.ckpt.incomplete_steps(), ck.directory)
        if ck.warm_init and (ck.warm_init_msgpack or ck.warm_init_dir):
            if ck.warm_init_msgpack:
                params = params_from_jax(import_params_msgpack(ck.warm_init_msgpack))
            else:
                params = CheckpointManager(ck.warm_init_dir).restore_params(device=self.device)
            donor_layers = 1 + max(int(k.split(".")[1]) for k in params if k.startswith("blocks."))
            if donor_layers != self.cfg.model.n_layers:
                raise NotImplementedError(
                    f"warm init from a {donor_layers}-layer donor into {self.cfg.model.n_layers} layers needs "
                    "depth surgery (utils/surgery.py), not ported yet (ROADMAP Queue 1 item 17)")
            shards.load_params(params)
            if self.mesh.rank == 0:
                print(json.dumps({"warm_init": ck.warm_init_msgpack or ck.warm_init_dir}), flush=True)
        return self.state

    # -- loop -----------------------------------------------------------------

    @property
    def val_loader(self) -> DataLoader:
        if self._val_loader is None:
            self._val_loader = make_loader(self.cfg, validation=True, process_index=self.mesh.data.rank,
                                           process_count=self.mesh.data.size)
        return self._val_loader

    def evaluate(self) -> Dict[str, float]:
        """Mean loss over ``maximum_evaluation_steps`` validation batches,
        always the same window (the source state is pinned at the first
        call), averaged over the data ranks."""
        if self._val_window is None:
            self._val_window = self.val_loader.source.state()
        else:
            self.val_loader.source.restore(self._val_window)
        total, n = 0.0, 0
        it = iter(self.val_loader)
        with self.state.shards.gathered():
            for _ in range(self.cfg.training.maximum_evaluation_steps):
                total += float(self.eval_step(to_device(next(it)[0], self.device)))
                n += 1
        loss = total / max(n, 1)
        return {"loss": loss, "perplexity": math.exp(min(loss, 20.0))}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``training.total_steps`` (or ``max_steps`` more), saving on
        the cadence and at the end (JAX ``train``, :1058 and :1108-1111)."""
        cfg = self.cfg.training
        start = self.state.step
        end = min(cfg.total_steps, start + max_steps) if max_steps else cfg.total_steps
        it = iter(self.train_loader)
        try:
            self._train_loop(it, start, end)
        finally:
            it.close()  # stops the loader's read-ahead thread; unseen batches are kept
        if self._last_saved != self.state.step:
            self.save(force=True)
        if self.mesh.rank == 0:
            self.ckpt.wait()
        return self.state

    def _train_loop(self, it, start: int, end: int) -> None:
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
                if self.audit is not None and self.audit():
                    raise RuntimeError(f"the data ranks' replicated params disagree bit for bit at step {step} "
                                       "(replica audit); training halted")
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
                if self.ckpt.last_digest_ms:
                    payload["ckpt_verify_ms"] = self.ckpt.last_digest_ms
                    payload["ckpt_save_ms"] = self.last_save_ms
                report = self._restore_report
                if report is not None and report.quarantined:
                    payload["ckpt_quarantined"] = len(report.quarantined)
                    payload["restore_fallback_steps"] = report.fallback_steps
                payload.update({f"data_{k}": float(v)
                                for k, v in self.train_loader.fault_counters().items() if v})
                self.metrics.log(payload, step)
                t0, step0 = time.perf_counter(), step
            paused = False
            if cfg.evaluation_frequency and step % cfg.evaluation_frequency == 0:
                self.metrics.log(self.evaluate(), step, prefix="validation")
                paused = True
            if self.save():
                paused = True
            if paused:  # eval and checkpoint time leave the window
                self._sync()
                t0, step0 = time.perf_counter(), step

    def close(self) -> None:
        try:
            self.ckpt.close()
        finally:
            self.metrics.close()
