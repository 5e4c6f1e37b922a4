"""Eval CLI (counterpart of ``zero_transformer_tpu/evalharness/cli.py``)::

  python -m zero_transformer_tpu_torch.evalharness --model byte_25m \\
      --params p.npz --task bpb --data heldout_ppl.jsonl --seq-len 512

``--params`` is the ``.npz`` of the flat flax param tree that ``convert.py``
and the serve CLI read. Data is pre-tokenized JSONL:

- ``lambada``: ``{"context": [ids], "target": [ids]}`` per line;
- ``choice``: ``{"context": [ids], "choices": [[ids], ...], "gold": i,
  "choice_bytes": [n, ...]?}`` per line;
- ``ppl``/``bpb``: one object ``{"tokens": [ids], "num_bytes": n?}``, or a
  raw ``.bin``/``.u16`` uint16 token file (pass ``--num-bytes`` for bpb).

It runs on the CUDA card unless ``--device cpu`` is given. ``--tokenizer``
(text fields through a HuggingFace tokenizer) and ``--quantize int8`` are
not ported and raise. The result is one JSON line on stdout.
"""
from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

import numpy as np
import torch

from zero_transformer_tpu_torch.config import resolve_device


def _read_jsonl(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.evalharness", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="model zoo name")
    p.add_argument("--params", required=True, help=".npz of the flat flax param tree")
    p.add_argument("--task", required=True, choices=["lambada", "choice", "ppl", "bpb"])
    p.add_argument("--data", required=True, help="JSONL / token file (see above)")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--num-bytes", type=int, default=None, help="UTF-8 bytes for bpb")
    p.add_argument("--limit", type=int, default=None, help="cap example count")
    p.add_argument("--tokenizer", default=None, help="not ported: data must be token ids")
    p.add_argument("--quantize", default="none", choices=("none", "int8"), help="int8 is not ported")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.tokenizer:
        raise NotImplementedError("--tokenizer (HuggingFace text fields) is not ported: pass token ids")
    if args.quantize != "none":
        raise NotImplementedError("--quantize int8 (weight-only int8 scoring) is not ported yet")
    device = resolve_device(args.device)
    from zero_transformer_tpu_torch.convert import load_npz
    from zero_transformer_tpu_torch.evalharness import choice_accuracy, lambada, perplexity
    from zero_transformer_tpu_torch.models import model_getter

    model = model_getter(args.model, dtype=getattr(torch, args.dtype), device=device, dropout=0.0)
    model.load_state_dict(load_npz(args.params))
    model.cast_for_inference()

    def rows():
        return itertools.islice(_read_jsonl(args.data), args.limit)

    if args.task in ("ppl", "bpb"):
        if args.data.endswith((".bin", ".u16")):
            tokens = np.fromfile(args.data, dtype=np.uint16).astype(np.int32)
            num_bytes = args.num_bytes
        else:
            obj = json.loads(Path(args.data).read_text())
            tokens = np.asarray(obj["tokens"], np.int32)
            num_bytes = obj.get("num_bytes", args.num_bytes)
        if args.task == "bpb":
            if not num_bytes:
                raise SystemExit("--task bpb needs the source byte count: pass --num-bytes "
                                 "or a num_bytes field in the data file")
            if args.limit and args.limit < len(tokens):
                raise SystemExit("--limit with --task bpb would divide a truncated nll by the "
                                 "full document's bytes; truncate the data file instead")
        if args.limit:
            tokens = tokens[: args.limit]
        out = perplexity(model, tokens, args.seq_len, args.batch_size, num_bytes)
    elif args.task == "lambada":
        examples = [(list(r["context"]), list(r["target"])) for r in rows()]
        out = lambada(model, examples, args.seq_len, args.batch_size)
    else:  # choice
        examples = [(list(r["context"]), [list(c) for c in r["choices"]], int(r["gold"]),
                     r.get("choice_bytes")) for r in rows()]
        out = choice_accuracy(model, examples, args.seq_len, args.batch_size)
    print(json.dumps({"task": args.task, "model": args.model, "device": str(device), **out}))


if __name__ == "__main__":
    main()
