"""The trainer: config -> mesh -> model -> schedule -> ZeRO state -> train
step -> loaders -> metrics, checkpoints, resilience and observability.

Counterpart of ``zero_transformer_tpu/training/trainer.py``:
``build_training`` (:144-187), ``remap_loader_state`` (:80), ``init_state``
(:490-574: verified resume, warm init), ``Trainer.train`` (:729-1110) with
its log cadence and its saves (on ``save_frequency`` and at the end),
``Trainer.evaluate`` (:645) over a pinned validation window, and the
resilience policy of ``resilience``:

- the anomaly guard (on by default) flags each step on the device and
  drops a flagged update inside the step (``resilience/anomaly.py``); at
  log points one read of its carry decides (``_handle_anomalies``, JAX
  :1187-1262): ``halt`` raises ``AnomalyHalt``, ``rollback`` restores the
  host snapshot after ``rollback_after`` flagged steps in a row (within
  ``max_rollbacks``), ``skip_batch`` halts once the streak reaches
  ``max_consecutive_anomalies``. A non-finite loss read at a log point
  still raises "non-finite loss" under ``halt_on_nan`` when there is no
  guard or the response is ``halt`` (JAX :863-887);
- the host snapshot, under ``rollback``, at the start and every
  ``snapshot_frequency`` steps at a log point with a clean streak (and a
  clean replica audit since the last capture, when the audit runs);
- the replica audit every ``audit_frequency`` steps (0: off, JAX's
  default), which on a divergence heals by rollback under ``rollback``
  and halts otherwise (``_handle_replica_divergence``);
- the watchdog (``watchdog_timeout_s``), armed after the first step, whose
  hook force-saves between steps, and whose abort becomes ``HangError``;
- SIGTERM: finish the step, save, stop, ``preempted`` (one process only:
  the ranks of a larger world would have to agree on the stop step).

Observability (``obs/``): the spans ``data_fetch``, ``dispatch``,
``device_sync``, ``checkpoint_save``, ``replica_audit`` and ``evaluate`` in
a ``Tracer``, written incrementally to ``spans.jsonl`` at log points and as
a Perfetto ``trace_train.json`` at ``close``; a ``FlightRecorder`` that
ticks at log points and dumps on ``anomaly_halt``, ``watchdog_abort`` and
``quarantine``; a ``Registry`` with JAX's trainer gauge; a profile window
(``training.profile_steps`` / ``profile_start``). All of it lands beside
``metrics.jsonl`` on rank 0.

Every ``log_frequency`` steps it syncs once and logs ``loss``,
``perplexity``, ``grad_norm``, ``learning_rate``, ``tokens_per_sec`` and
``step_time_ms`` (wall time over the window, which ends in that sync), plus
the model-FLOPs share on a card whose bf16 peak it knows, ``hbm_gb``,
``ckpt_verify_ms`` (the digest time of the latest save), the anomaly and
audit counts once nonzero, the quarantined steps of a resume and the tar
source's nonzero fault counts (``data_*``), to stdout and to
``<checkpoint.directory>/metrics.jsonl``. Packed-document models
(``doc_sep_token``) train and evaluate as any other.

Several processes (one per rank under ``torch.distributed.run``) form a
``data x tensor x sequence`` mesh (``parallel/mesh.py``). The ranks of a
sequence group read the same rows and run their shard of each through the
ring (or Ulysses); the ranks of a tensor group read the same rows too and
hold their slices of every layer (the model is built over the mesh's
tensor group, each rank drawing the one-card weights and keeping its
slices; a warm start slices the whole tensors); the data groups read
different rows (the loader's process index and count are the data rank
and size) and train under ZeRO ``mesh.zero_stage``
(``parallel/zero.py``). Every rank flags the same steps (the loss and the
norm are reduced over the groups), so their rollbacks agree. Rank 0 builds
the CUDA kernels while the others wait at a barrier; only rank 0 writes
``metrics.jsonl``, stdout, the observability files and the checkpoints.
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
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from zero_transformer_tpu_torch.checkpoint import (CheckpointManager, RestoreReport, import_params_msgpack,
                                                   save_config_json)
from zero_transformer_tpu_torch.config import Config, resolve_device
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.data import DataLoader, make_loader, to_device
from zero_transformer_tpu_torch.models.registry import build_model
from zero_transformer_tpu_torch.obs import (FlightRecorder, MetricsLogger, ProfileWindow, Registry, Tracer,
                                            hbm_device_stats, model_flops_per_token, peak_flops)
from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.parallel.mesh import Mesh, init_distributed, single_process
from zero_transformer_tpu_torch.parallel.sharding import check_elastic_compat, topology_summary
from zero_transformer_tpu_torch.parallel.zero import (TrainState, init_train_state, make_eval_step,
                                                      make_replica_audit, make_train_step)
from zero_transformer_tpu_torch.resilience import AnomalyHalt, HangError
from zero_transformer_tpu_torch.resilience.anomaly import AnomalyGuard, AnomalyStats, HostSnapshot
from zero_transformer_tpu_torch.resilience.watchdog import Watchdog
from zero_transformer_tpu_torch.training.optimizer import make_schedule

log = logging.getLogger("zero_transformer_tpu_torch")


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


def build_training(cfg: Config, device, mesh: Optional[Mesh] = None, guard: Optional[AnomalyGuard] = None,
                   poison: Optional[Callable] = None) -> TrainingBuild:
    """Model (seeded from ``training.seed``, trainable: the same weights on
    every rank), schedule, the ZeRO state over ``mesh``'s data group and the
    steps, the train step guarded by ``guard`` and poisoned by ``poison``
    where given (``parallel/zero.make_train_step``). The optimizer's
    horizon is ``training.total_steps``, as in JAX. ``mesh`` None is one
    process; ``mesh.sequence``, ``mesh.tensor`` or ``mesh.data`` > 1 need a
    mesh of that many ranks."""
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
    if cfg.mesh.tensor != mesh.tensor.size:
        raise ValueError(f"mesh.tensor {cfg.mesh.tensor} needs a tensor group of that many ranks, "
                         f"got {mesh.tensor.size}")
    if cfg.mesh.data not in (-1, mesh.data.size):
        raise ValueError(f"mesh.data {cfg.mesh.data} needs a data group of that many ranks, got {mesh.data.size}")
    opt = dataclasses.replace(cfg.optimizer, total_steps=cfg.training.total_steps)
    model = build_model(cfg.model, dev, seed=cfg.training.seed, trainable=True,
                        tensor_group=mesh.tensor if mesh.tensor.size > 1 else None)
    model.set_sequence_group(mesh.sequence)
    schedule = make_schedule(opt)
    state = init_train_state(model, opt, schedule, mesh.data, cfg.mesh.zero_stage)
    train_step = make_train_step(cfg.mesh.zero_stage, schedule, cfg.training.grad_accum_dtype, mesh.sequence,
                                 seed=cfg.training.seed, guard=guard, poison=poison)
    return TrainingBuild(state=state, schedule=schedule, train_step=train_step,
                         eval_step=make_eval_step(model, mesh.data), audit=make_replica_audit(state.shards))


def needs_process_group(cfg: Config) -> bool:
    """Whether ``cfg`` runs on several ranks: ``mesh.data``, ``mesh.tensor``
    or ``mesh.sequence`` > 1, or a launch by ``torch.distributed.run`` with
    a world of several processes (``mesh.data`` -1 takes them all)."""
    return (cfg.mesh.sequence > 1 or cfg.mesh.tensor > 1 or cfg.mesh.data > 1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


class Trainer:
    """``chaos`` (``resilience/chaos.py``) wires a ``ChaosMonkey`` into the
    step, the loader and the checkpoint manager (tests and the chip check);
    None in a real run."""

    def __init__(self, cfg: Config, device="cuda", train_loader: Optional[DataLoader] = None,
                 val_loader: Optional[DataLoader] = None, mesh: Optional[Mesh] = None, chaos=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is None:
            if needs_process_group(cfg):
                mesh = init_distributed(cfg.mesh.sequence, None, self.device, data=cfg.mesh.data,
                                        tensor=cfg.mesh.tensor)
            else:
                mesh = single_process(self.device)
        self.mesh = mesh
        self.device = mesh.device
        if mesh.world_size > 1 and self.device.type == "cuda":  # one nvcc per source, on rank 0 only
            if mesh.rank == 0:
                _build.build_all()
            mesh.barrier()
        rank0 = mesh.rank == 0
        res = cfg.resilience
        self.guard = AnomalyGuard(res, self.device) if res.anomaly_detection else None
        self._chaos = chaos
        build = build_training(cfg, self.device, mesh, guard=self.guard,
                               poison=chaos.step_poison() if chaos is not None else None)
        self.state, self.schedule = build.state, build.schedule
        self.train_step, self.eval_step = build.train_step, build.eval_step
        self.audit = build.audit if res.audit_frequency > 0 else None
        if res.audit_frequency > 0 and build.audit is None:
            log.warning("audit_frequency=%d requested but the data group has one rank: there is no replicated "
                        "copy to cross-check, so the replica audit is inactive", res.audit_frequency)
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
        if chaos is not None:
            self.train_loader = chaos.wrap_loader(self.train_loader)
            self.ckpt = chaos.wrap_checkpoint(self.ckpt)
        # what the supervisor reads
        self.preempted = False
        self.last_step: Optional[int] = None
        self.resilience_report: Dict[str, Any] = {}
        self.snapshot: Optional[HostSnapshot] = None
        self.watchdog: Optional[Watchdog] = None
        # held by the main thread through each step: the watchdog's
        # force-save runs only between steps, never on a half-updated state
        self._step_lock = threading.Lock()
        # observability, beside metrics.jsonl on rank 0
        self.obs_dir = ck.directory if rank0 else None
        self.tracer = Tracer(capacity=16384)
        self.flight = FlightRecorder(directory=self.obs_dir, tracer=self.tracer)
        self.registry = Registry()
        # JAX's analytic pipeline-bubble gauge: no pipeline is ported, so one
        # stage and no bubble
        self.registry.gauge_func("train_bubble_frac", "analytic pipeline-bubble fraction of the configured "
                                 "schedule", lambda: 0.0)
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
            "resilience": dataclasses.asdict(res),
        }}), flush=True)

    # -- checkpoints ----------------------------------------------------------

    def _save_meta(self) -> dict:
        t = self.cfg.training
        return {
            "opt_count": int(self.state.optimizer.count),
            "loader": self.train_loader.state(),
            "topology": topology_summary(self.mesh.data.size, self.mesh.sequence.size, self.cfg.mesh.zero_stage,
                                         self.mesh.tensor.size),
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
                                         self.cfg.training.batch_size, self.mesh.tensor.size):
            log.warning("elastic resume: %s", note)
            print(json.dumps({"elastic_resume": note}), flush=True)

    def _restore_event(self, name: str, step: int, **fields) -> None:
        """Restore events go to the metrics timeline and the flight
        recorder; a quarantined step also dumps the recorder."""
        self.metrics.event(name, step, **fields)
        self.flight.event(name, step=step, **fields)
        if name == "ckpt_quarantined":
            self.flight.dump("quarantine", extra={"step": step, **fields})

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

    def _install_preemption_handler(self):
        """SIGTERM -> finish the current step, save, leave the loop
        (``preempted``). Returns (flag, restore). A world of several ranks
        gets no handler: a rank that stopped a step before the others would
        leave them waiting in a collective (ROADMAP Queue 1 item 15)."""
        flag = threading.Event()
        if threading.current_thread() is not threading.main_thread():
            return flag, lambda: None
        if self.mesh.world_size > 1:
            log.warning("SIGTERM preemption save runs in a one-process world only; this world has %d ranks",
                        self.mesh.world_size)
            return flag, lambda: None
        previous = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            log.warning("SIGTERM: will checkpoint and stop after this step")
            flag.set()

        signal.signal(signal.SIGTERM, handler)
        return flag, lambda: signal.signal(signal.SIGTERM, previous)

    def _hang_force_save(self) -> None:
        """The watchdog's ``on_hang``: save the last completed step, from the
        watchdog thread, so the restart resumes where the loop hung. Only
        between steps (the step lock is free) and in a one-process world
        (a save gathers over the ranks); otherwise the restart takes the
        newest periodic checkpoint."""
        if self.mesh.world_size > 1:
            log.warning("watchdog: no force-save in a world of %d ranks", self.mesh.world_size)
            return
        if not self._step_lock.acquire(blocking=False):
            log.warning("watchdog: the loop hung inside a step; force-save skipped (the restart resumes from "
                        "the newest checkpoint)")
            return
        try:
            if self._last_saved == self.state.step:
                return
            self.save(force=True)
            self.ckpt.wait()
            log.warning("watchdog: force-saved checkpoint at step %d", self.state.step)
        except Exception:
            log.exception("watchdog: force-save failed (the restart uses the last periodic checkpoint)")
        finally:
            self._step_lock.release()

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``training.total_steps`` (or ``max_steps`` more), saving on
        the cadence and at the end (JAX ``train``, :1058 and :1108-1111).
        Raises ``AnomalyHalt`` when the policy halts, ``HangError`` when the
        watchdog aborted the loop; a SIGTERM saves, stops early and sets
        ``preempted``."""
        cfg, res = self.cfg.training, self.cfg.resilience
        start = self.state.step
        end = min(cfg.total_steps, start + max_steps) if max_steps else cfg.total_steps
        self.preempted = False
        self.last_step = start
        self.resilience_report = {"anomalies": 0, "rollbacks": 0, "watchdog_fired": False,
                                  "replica_audit_failures": 0}
        report = self._restore_report
        if report is not None:
            self.resilience_report["ckpt_quarantined"] = len(report.quarantined)
            self.resilience_report["restore_fallback_steps"] = report.fallback_steps
        if self.guard is not None:
            self.guard.reset()
        snapshot = None
        if self.guard is not None and res.anomaly_response == "rollback":
            snapshot = self.snapshot = self.snapshot or HostSnapshot()
            snapshot.capture(self.state)  # a rollback target from the first step
        watchdog = self.watchdog = (Watchdog(res.watchdog_timeout_s, on_hang=self._hang_force_save)
                                    if res.watchdog_timeout_s > 0 else None)
        preempted, restore_handler = self._install_preemption_handler()
        window = None
        if cfg.profile_steps and self.obs_dir:
            window = ProfileWindow(cfg.profile_dir or os.path.join(self.cfg.checkpoint.directory, "profile"))
        it = iter(self.train_loader)
        try:
            self._train_loop(it, start, end, preempted, watchdog, snapshot, window)
        except KeyboardInterrupt:
            if watchdog is not None and watchdog.fired:
                step = self.state.step
                self.resilience_report["watchdog_fired"] = True
                self.metrics.event("watchdog_abort", step, timeout_s=res.watchdog_timeout_s,
                                   silent_s=watchdog.fired_after_s)
                self.flight.dump("watchdog_abort", extra={"step": step, "timeout_s": res.watchdog_timeout_s})
                raise HangError(f"train loop produced no step for more than {res.watchdog_timeout_s}s (hung "
                                f"around step {step}); stacks dumped, checkpoint force-saved: restartable") from None
            raise
        finally:
            it.close()  # stops the loader's read-ahead thread; unseen batches are kept
            if window is not None:
                window.abort()
            if watchdog is not None:
                watchdog.stop()
            restore_handler()
        if self._last_saved != self.state.step:
            self.save(force=True)
        if self.mesh.rank == 0:
            self.ckpt.wait()
        return self.state

    def _profile_bounds(self, start: int) -> Tuple[int, Optional[int]]:
        """JAX's window arithmetic (:743-763): the capture opens before the
        step that completes ``trigger + 1`` and closes after the one that
        completes ``stop``: steps [START, START + LEN) under
        ``profile_start``, else the ``profile_steps`` after the first."""
        cfg = self.cfg.training
        trigger = cfg.profile_start - 1 if cfg.profile_start else start + 1
        stop = trigger + cfg.profile_steps if cfg.profile_steps else None
        if stop and trigger < start:
            log.warning("profiler: window [%d, %d) is already behind resume step %d; no capture this run",
                        cfg.profile_start, cfg.profile_start + cfg.profile_steps, start)
        return trigger, stop

    def _train_loop(self, it, start: int, end: int, preempted: threading.Event, watchdog: Optional[Watchdog],
                    snapshot: Optional[HostSnapshot], window: Optional[ProfileWindow]) -> None:
        cfg, res = self.cfg.training, self.cfg.resilience
        tr, guard = self.tracer, self.guard
        trigger, stop = self._profile_bounds(start)
        anom_seen = audit_seen = rollbacks = 0
        last_snap_step = start
        self._sync()
        t0, step0 = time.perf_counter(), start
        step = start
        while step < end:
            if window is not None:
                if stop and step == trigger:
                    window.request(cfg.profile_steps, name=f"steps_{trigger + 1}-{stop}")
                window.poll(step)
            t_fetch = tr.clock()
            batch = to_device(next(it), self.device)
            t_disp = tr.clock()
            tr.add("data_fetch", "train", t_fetch, t_disp, {"step": step + 1})
            # the step lock: the watchdog's force-save waits for the step, its
            # log point, evaluation and save to finish (a loader or chaos
            # hang outside it leaves the state whole)
            with self._step_lock:
                if window is not None and window.active:
                    with record_function(f"train_step {step + 1}"):
                        metrics = self.train_step(self.state, batch)
                else:
                    metrics = self.train_step(self.state, batch)
                step = self.last_step = self.state.step
                tr.add("dispatch", "train", t_disp, tr.clock(), {"step": step})
                if watchdog is not None:
                    if step == start + 1:  # armed after the first step: it builds and warms up
                        watchdog.start()
                    watchdog.beat()
                if self.audit is not None and step % res.audit_frequency == 0:
                    guard.record_audit(self.audit())

                paused = False
                if step % cfg.log_frequency == 0 or step == end:
                    t_sync = tr.clock()
                    loss = float(metrics["loss"])  # the log point's sync
                    tr.add("device_sync", "train", t_sync, tr.clock(), {"step": step})
                    if cfg.halt_on_nan and not math.isfinite(loss) and (guard is None or
                                                                         res.anomaly_response == "halt"):
                        poisoned = ("the update was dropped in the step (params still clean)" if guard is not None
                                    else "NOT checkpointed (the state is already poisoned)")
                        self.flight.dump("anomaly_halt", extra={"step": step, "loss": repr(loss),
                                                                "cause": "halt_on_nan"})
                        raise RuntimeError(f"non-finite loss {loss} at step {step}; training halted, {poisoned}; "
                                           f"resume from step {self.ckpt.latest_step()} and rerun with --debug-nans "
                                           "to find the source op")
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
                    hbm = hbm_device_stats(self.device)
                    if hbm is not None:
                        payload["hbm_gb"] = hbm["max_gb"]
                    if self.ckpt.last_digest_ms:
                        payload["ckpt_verify_ms"] = self.ckpt.last_digest_ms
                        payload["ckpt_save_ms"] = self.last_save_ms
                    report = self._restore_report
                    if report is not None and report.quarantined:
                        payload["ckpt_quarantined"] = len(report.quarantined)
                        payload["restore_fallback_steps"] = report.fallback_steps
                    payload.update({f"data_{k}": float(v)
                                    for k, v in self.train_loader.fault_counters().items() if v})
                    stats: Optional[AnomalyStats] = None
                    new_anoms = new_audit = 0
                    if guard is not None:
                        stats = guard.read()  # the carry's one sync, at log points only
                        new_anoms = stats.count - anom_seen
                        if new_anoms > 0:  # the run's total survives carry resets (rollback)
                            self.resilience_report["anomalies"] += new_anoms
                        if self.resilience_report["anomalies"]:
                            payload["anomalies_total"] = self.resilience_report["anomalies"]
                            payload["anomaly_streak"] = stats.streak
                        new_audit = stats.audit_failures - audit_seen
                        if new_audit > 0:
                            self.resilience_report["replica_audit_failures"] += new_audit
                        if self.resilience_report["replica_audit_failures"]:
                            payload["replica_audit_failures"] = self.resilience_report["replica_audit_failures"]
                    self.metrics.log(payload, step)
                    self.flight.tick({"step": step, "loss": loss, "grad_norm": payload["grad_norm"],
                                      "anomalies": self.resilience_report["anomalies"], "rollbacks": rollbacks,
                                      "audit_failures": self.resilience_report["replica_audit_failures"]})
                    if self.obs_dir:
                        tr.write_jsonl(os.path.join(self.obs_dir, "spans.jsonl"))
                    if stats is not None:
                        t_audit = tr.clock()
                        rolled = self._handle_replica_divergence(new_audit, snapshot, rollbacks, step)
                        if rolled:  # the carry was reset: both counters restart from zero
                            anom_seen = audit_seen = 0
                        else:
                            audit_seen = stats.audit_failures
                            rolled = self._handle_anomalies(stats, new_anoms, snapshot, rollbacks, step)
                            anom_seen = 0 if rolled else stats.count
                            if rolled:
                                audit_seen = 0
                        if rolled:
                            rollbacks += 1
                            self.resilience_report["rollbacks"] = rollbacks
                            paused = True
                        # a known-good state to the host on the cadence; with the
                        # audit on, only after a clean audit since the last capture
                        # (else a heal could re-replicate a desync)
                        audit_vouched = self.audit is None or (
                            new_audit == 0 and step // res.audit_frequency > last_snap_step // res.audit_frequency)
                        if (snapshot is not None and stats.streak == 0 and not rolled and audit_vouched
                                and step - last_snap_step >= res.snapshot_frequency):
                            snapshot.capture(self.state)
                            last_snap_step = step
                        tr.add("replica_audit", "train", t_audit, tr.clock(), {"step": step, "rolled": rolled})
                    t0, step0 = time.perf_counter(), step
                if cfg.evaluation_frequency and step % cfg.evaluation_frequency == 0:
                    with tr.span("evaluate", "train", step=step):
                        self.metrics.log(self.evaluate(), step, prefix="validation")
                    paused = True
                t_save = tr.clock()
                if self.save():
                    tr.add("checkpoint_save", "train", t_save, tr.clock(), {"step": step})
                    paused = True
                if paused:  # eval, checkpoint and rollback time leave the window
                    self._sync()
                    t0, step0 = time.perf_counter(), step
            if self._chaos is not None:
                self._chaos.on_step(step)
                self._chaos.perturb_state(step, self.state)
            if preempted.is_set():
                log.warning("preemption: saving at step %d and stopping", step)
                self.metrics.event("preemption", step)
                self.preempted = True
                break

    # -- escalation -------------------------------------------------------

    def _rollback(self, snapshot: HostSnapshot) -> None:
        """The snapshot's params and optimizer state back in place, the step
        counter kept (the loader and the schedule move on: the offending
        window is never replayed), and a fresh guard carry (JAX
        ``_rollback_to_snapshot``)."""
        snapshot.restore(self.state)
        self.guard.reset()

    def _handle_replica_divergence(self, new: int, snapshot: Optional[HostSnapshot], rollbacks: int,
                                   step: int) -> bool:
        """The replica audit tripped since the last log point: heal by
        rollback under ``rollback`` (every rank restores its own snapshot,
        and stages 1-2 re-gather the whole params from the shards), else
        halt. Returns whether it rolled back."""
        if new <= 0:
            return False
        res = self.cfg.resilience
        log.error("replica audit: %d failed agreement check(s) by step %d: one data rank's replicated state no "
                  "longer matches its peers (silent data corruption)", new, step)
        self.metrics.event("replica_divergence", step, new_failures=new,
                           total=self.resilience_report["replica_audit_failures"])
        if (res.anomaly_response == "rollback" and snapshot is not None and snapshot.captured
                and rollbacks < res.max_rollbacks):
            self._rollback(snapshot)
            log.warning("replica divergence healed by rollback %d/%d: the snapshot of step %d restored at step %d",
                        rollbacks + 1, res.max_rollbacks, snapshot.step, step)
            self.metrics.event("replica_heal_rollback", step, to_step=snapshot.step, rollback=rollbacks + 1)
            return True
        self.flight.dump("anomaly_halt", extra={"step": step, "cause": "replica_divergence", "new_failures": new})
        raise AnomalyHalt(
            f"cross-replica divergence at step {step} (audited every {res.audit_frequency} steps): a data rank's "
            f"replicated state differs bit for bit from its peers. Resume from step {self.ckpt.latest_step()} "
            "(a restore re-replicates identical copies); if it recurs, retire the suspect card")

    def _handle_anomalies(self, stats: AnomalyStats, new: int, snapshot: Optional[HostSnapshot], rollbacks: int,
                          step: int) -> bool:
        """Escalation from the guard's carry at a log point (JAX :1187-1262).
        The step already dropped every flagged update; what remains is to go
        on, roll back or stop. Returns whether it rolled back."""
        res = self.cfg.resilience
        if new <= 0:
            return False
        good = self.ckpt.latest_step()
        log.warning("anomaly guard: %d flagged step(s) since the last check (streak %d, total %d); updates "
                    "dropped in the step", new, stats.streak, stats.count)
        if res.anomaly_response == "halt":
            self.flight.dump("anomaly_halt", extra={"step": step, "cause": "policy_halt", "new": new,
                                                    "streak": stats.streak})
            raise AnomalyHalt(
                f"anomaly policy 'halt': {new} flagged step(s) by step {step} (non-finite loss/grad or spike; "
                f"streak {stats.streak}). The updates were dropped; resume from step {good} after inspecting "
                "the data window or lowering the learning rate")
        if (res.anomaly_response == "rollback" and stats.streak >= res.rollback_after and snapshot is not None
                and snapshot.captured):
            if rollbacks >= res.max_rollbacks:
                self.flight.dump("anomaly_halt", extra={"step": step, "cause": "rollback_budget",
                                                        "streak": stats.streak})
                raise AnomalyHalt(
                    f"rollback budget exhausted ({res.max_rollbacks}) with the anomaly streak still at "
                    f"{stats.streak} at step {step}: this divergence persists; resume from step {good} with a "
                    "changed config")
            self._rollback(snapshot)
            log.warning("anomaly rollback %d/%d: the snapshot of step %d restored at step %d (the loader goes on)",
                        rollbacks + 1, res.max_rollbacks, snapshot.step, step)
            self.metrics.event("anomaly_rollback", step, to_step=snapshot.step, streak=stats.streak,
                               rollback=rollbacks + 1)
            return True
        if stats.streak >= res.max_consecutive_anomalies:
            self.flight.dump("anomaly_halt", extra={"step": step, "cause": "consecutive_anomalies",
                                                    "streak": stats.streak})
            raise AnomalyHalt(
                f"{stats.streak} consecutive anomalous steps at step {step}: every update is being dropped, no "
                f"training progress is possible; resume from step {good} with a changed config")
        return False

    def close(self) -> None:
        try:
            if self.obs_dir:
                try:
                    self.tracer.write_chrome_trace(os.path.join(self.obs_dir, "trace_train.json"))
                    self.tracer.write_jsonl(os.path.join(self.obs_dir, "spans.jsonl"))
                except OSError:
                    log.exception("obs: trace export failed (run results intact)")
            self.ckpt.close()
        finally:
            self.metrics.close()
