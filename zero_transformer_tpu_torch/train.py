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

Data parallelism (``mesh.data``, ZeRO ``mesh.zero_stage`` 0-3) and sequence
parallelism (``mesh.sequence``) run one process per rank under
``torch.distributed.run``; the world is ``data x sequence``::

    python -m torch.distributed.run --nproc-per-node 4 -m zero_transformer_tpu_torch.train \
        --cfg configs/train_125m.yaml --set mesh.data=4 mesh.zero_stage=2 data.source=synthetic
    python -m torch.distributed.run --nproc-per-node 4 -m zero_transformer_tpu_torch.train \
        --cfg configs/train_580m_8k.yaml --set mesh.sequence=4

``mesh.data`` -1 (the default) takes every rank the launch has.
``--dist-backend`` picks nccl (a card per rank) or gloo (the CPU, or ranks
sharing a card); without it, nccl when every rank has a card of its own,
else gloo. Rank 0 prints the topology it runs on. Checkpoints go to
``checkpoint.directory`` every ``checkpoint.save_frequency`` steps and at
the end; ``--set checkpoint.resume=true`` continues from the newest one
that verifies, on this world size or another.
"""
from __future__ import annotations

import argparse
import ast
import sys

from zero_transformer_tpu_torch.config import apply_dotted_overrides, load_config, resolve_device


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
                   help="torch.distributed backend for mesh.sequence > 1 (default: nccl with a card "
                        "per rank, else gloo)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_dotted_overrides(load_config(args.cfg), parse_overrides(args.set))
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed
    from zero_transformer_tpu_torch.training.trainer import Trainer, needs_process_group

    ranks = needs_process_group(cfg)
    if args.dist_backend is not None and not ranks:
        raise ValueError("--dist-backend applies to a mesh of several ranks (mesh.data or mesh.sequence > 1)")
    mesh = init_distributed(cfg.mesh.sequence, args.dist_backend, device, data=cfg.mesh.data) if ranks else None
    try:
        trainer = Trainer(cfg, device=device, mesh=mesh)
        try:
            trainer.train(max_steps=args.max_steps)
        finally:
            trainer.close()
    finally:
        destroy(mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
