"""Training CLI for the PyTorch/CUDA port.

Counterpart of the root ``train.py`` (``--cfg``, ``--set``, ``--max-steps``,
:106-139) for one card::

    python -m zero_transformer_tpu_torch.train --cfg configs/train_125m.yaml \\
        --set data.source=synthetic training.batch_size=8 \\
        training.gradient_accumulation_steps=4 --max-steps 20

1.3B on one card with its recipe (Adafactor, remat, ``loss_chunk`` 256,
B 4 x accum 16, a bfloat16 accumulator)::

    python -m zero_transformer_tpu_torch.train --cfg configs/train_1_3b_1chip.yaml \\
        --set data.source=synthetic checkpoint.directory=runs/1_3b

``--set`` overrides any dotted config field (values read as Python
literals, else strings): ``optimizer.optimizer`` is adamw, adafactor or
lion, ``model.loss_chunk`` chunks the loss, ``model.dropout`` trains with
dropout. The CLI runs on the CUDA card unless ``--device cpu`` is given;
without a card it refuses to start.

Data parallelism (``mesh.data``, ZeRO ``mesh.zero_stage`` 0-3), tensor
parallelism (``mesh.tensor``: the Megatron split of every layer and the
vocab-parallel loss) and sequence parallelism (``mesh.sequence``) run one
process per rank under ``torch.distributed.run``; the world is ``data x
tensor x sequence``::

    python -m torch.distributed.run --nproc-per-node 4 -m zero_transformer_tpu_torch.train \
        --cfg configs/train_125m.yaml --set mesh.data=4 mesh.zero_stage=2 data.source=synthetic
    python -m torch.distributed.run --nproc-per-node 4 -m zero_transformer_tpu_torch.train \
        --cfg configs/train_125m.yaml --set mesh.data=2 --set mesh.tensor=2 data.source=synthetic
    python -m torch.distributed.run --nproc-per-node 4 -m zero_transformer_tpu_torch.train \
        --cfg configs/train_580m_8k.yaml --set mesh.sequence=4

``mesh.data`` -1 (the default) takes every rank the launch has.
``--dist-backend`` picks nccl (a card per rank) or gloo (the CPU, or ranks
sharing a card); without it, nccl when every rank has a card of its own,
else gloo. Rank 0 prints the topology it runs on. Checkpoints go to
``checkpoint.directory`` every ``checkpoint.save_frequency`` steps and at
the end; ``--resume`` (or ``--set checkpoint.resume=True``) continues from
the newest one that verifies, on this world size or another.

Resilience (JAX ``train.py`` :107-182): the config's ``resilience`` block
is acted on whole (the anomaly guard, skip/rollback/halt, snapshots, the
watchdog). ``--supervise`` restarts the run from its newest verified
checkpoint after a retryable failure (a hang, a SIGTERM, a loader or
storage error), within ``resilience.max_restarts``, one process only::

    python -m zero_transformer_tpu_torch.train --cfg configs/train_125m.yaml --supervise \
        --set data.source=synthetic checkpoint.directory=runs/125m

``--audit-frequency N`` audits the data ranks' replicated state every N
steps. ``--metrics-port PORT`` serves the trainer's Prometheus registry at
``/metrics`` (not with ``--supervise``: each restart builds a new
registry). ``--profile N`` captures N steps after the first with
``torch.profiler``, ``--profile-window START:LEN`` the steps [START,
START+LEN), as a Chrome trace under ``training.profile_dir``.
``--debug-nans`` turns on ``torch.autograd.set_detect_anomaly`` (slow).
``spans.jsonl``, ``trace_train.json`` and flight-recorder dumps
(``flightrec/``) land beside ``metrics.jsonl``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import sys

import torch

from zero_transformer_tpu_torch.config import Config, apply_dotted_overrides, load_config, resolve_device


def parse_overrides(pairs) -> dict:
    out = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="configs/train_test.yaml")
    p.add_argument("--set", nargs="*", action="extend", default=None, metavar="KEY=VALUE")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend for a mesh of several ranks (default: nccl with a card "
                        "per rank, else gloo)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest verified checkpoint (checkpoint.resume)")
    p.add_argument("--audit-frequency", type=int, default=None, metavar="N",
                   help="replica audit every N steps (resilience.audit_frequency)")
    p.add_argument("--supervise", action="store_true",
                   help="restart from the newest verified checkpoint on a retryable failure, within "
                        "resilience.max_restarts (one process)")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve the trainer's Prometheus registry at http://0.0.0.0:PORT/metrics (0: off)")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="capture a torch.profiler trace of N steps after the first")
    p.add_argument("--profile-window", default=None, metavar="START:LEN",
                   help="capture a torch.profiler trace of the steps [START, START+LEN)")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): fail at the op that made a NaN (slow)")
    return p


def resolve_config(args) -> Config:
    """The config file, ``--set``, then the flags that set config fields."""
    from zero_transformer_tpu_torch.obs import parse_profile_window

    cfg = apply_dotted_overrides(load_config(args.cfg), parse_overrides(args.set))
    if args.resume:
        cfg = dataclasses.replace(cfg, checkpoint=dataclasses.replace(cfg.checkpoint, resume=True))
    if args.profile:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, profile_steps=args.profile))
    if args.profile_window:
        start, length = parse_profile_window(args.profile_window)
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, profile_start=start,
                                                                    profile_steps=length))
    if args.audit_frequency is not None:
        cfg = dataclasses.replace(cfg, resilience=dataclasses.replace(cfg.resilience,
                                                                      audit_frequency=args.audit_frequency))
    return cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed
    from zero_transformer_tpu_torch.training.trainer import Trainer, needs_process_group

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    ranks = needs_process_group(cfg)
    if args.dist_backend is not None and not ranks:
        raise ValueError("--dist-backend applies to a mesh of several ranks (mesh.data, mesh.tensor or "
                         "mesh.sequence > 1)")
    if args.supervise:
        from zero_transformer_tpu_torch.resilience.supervisor import Supervisor

        if args.metrics_port:
            # as JAX: each restart builds a new trainer and registry, so one
            # exporter would serve a dead registry after the first recovery
            logging.getLogger("zero_transformer_tpu_torch").warning(
                "--metrics-port is not supported with --supervise (the trainer's registry is rebuilt across "
                "restarts); no /metrics endpoint will be served")
        Supervisor(cfg, device=device).run(max_steps=args.max_steps)
        return
    mesh = (init_distributed(cfg.mesh.sequence, args.dist_backend, device, data=cfg.mesh.data,
                             tensor=cfg.mesh.tensor) if ranks else None)
    try:
        trainer = Trainer(cfg, device=device, mesh=mesh)
        exporter = None
        try:
            if args.metrics_port and trainer.mesh.rank == 0:
                from zero_transformer_tpu_torch.obs import MetricsExporter

                exporter = MetricsExporter(trainer.registry, port=args.metrics_port)
            trainer.train(max_steps=args.max_steps)
        finally:
            if exporter is not None:
                exporter.close()
            trainer.close()
    finally:
        destroy(mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
