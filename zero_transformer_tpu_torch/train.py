"""Training CLI for the PyTorch/CUDA port.

Counterpart of the root ``train.py`` (``--cfg``, ``--set``, ``--max-steps``,
:106-139) for one card::

    python -m zero_transformer_tpu_torch.train --cfg configs/train_125m.yaml \\
        --set data.source=synthetic training.batch_size=8 \\
        training.gradient_accumulation_steps=4 --max-steps 20

``--set`` overrides any dotted config field (values read as Python
literals, else strings). The CLI runs on the CUDA card unless ``--device
cpu`` is given; without a card it refuses to start.
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
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_dotted_overrides(load_config(args.cfg), parse_overrides(args.set))
    from zero_transformer_tpu_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    try:
        trainer.train(max_steps=args.max_steps)
    finally:
        trainer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
