"""Eval CLI (counterpart of ``zero_transformer_tpu/evalharness/cli.py``)::

  python -m zero_transformer_tpu_torch.evalharness --model byte_25m \\
      --params p.npz --task bpb --data heldout_ppl.jsonl --seq-len 512

``--params`` is the ``.npz`` of the flat flax param tree that ``convert.py``
and the serve CLI read, a flax ``.msgpack``, or a trainer checkpoint's step
directory (``<checkpoint.directory>/<step>``): the handoff from training to
evaluation. Data is pre-tokenized JSONL:

- ``lambada``: ``{"context": [ids], "target": [ids]}`` per line;
- ``choice``: ``{"context": [ids], "choices": [[ids], ...], "gold": i,
  "choice_bytes": [n, ...]?}`` per line;
- ``ppl``/``bpb``: one object ``{"tokens": [ids], "num_bytes": n?}``, or a
  raw ``.bin``/``.u16`` uint16 token file (pass ``--num-bytes`` for bpb).

It runs on the CUDA card unless ``--device cpu`` is given. ``--quantize
int8`` scores the weight-only int8 model: the tree is quantized on the host
(the conversion ``serve --quantize int8`` runs), then loaded. ``--tokenizer
<dir>`` (JAX :92-96) takes text fields instead of ids: a HuggingFace
tokenizer saved in a local directory (``serve.load_tokenizer``: the
``transformers`` package, no hub name) encodes each context as is and each
target or choice with a leading space, without special tokens (JAX
``_tok`` :40), and a string choice's byte length is that of the scored text.
The result is one JSON line on stdout.
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


def _tok(tokenizer, x, prefix_space: bool = False):
    """Token ids of a data field: ids pass through; a string (with a
    tokenizer) is encoded without BOS/EOS, a continuation with a leading
    space (JAX ``_tok``)."""
    if tokenizer is None:
        return list(x)
    if isinstance(x, str):
        return tokenizer.encode((" " + x) if prefix_space else x, add_special_tokens=False)
    return list(x)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.evalharness", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="model zoo name")
    p.add_argument("--params", required=True,
                   help=".npz of the flat flax param tree, a flax .msgpack, or a checkpoint step directory")
    p.add_argument("--task", required=True, choices=["lambada", "choice", "ppl", "bpb"])
    p.add_argument("--data", required=True, help="JSONL / token file (see above)")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--num-bytes", type=int, default=None, help="UTF-8 bytes for bpb")
    p.add_argument("--limit", type=int, default=None, help="cap example count")
    p.add_argument("--tokenizer", default=None,
                   help="a local directory holding a HuggingFace tokenizer (needs transformers): text fields")
    p.add_argument("--quantize", default="none", choices=("none", "int8"),
                   help="score the weight-only int8 serving path (the same "
                        "conversion serve --quantize runs) — measures what "
                        "the quantization costs in eval quality")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    tokenizer = None
    if args.tokenizer:
        from zero_transformer_tpu_torch.serve import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer)
    device = resolve_device(args.device)
    from zero_transformer_tpu_torch.convert import params_from_jax, read_params_tree
    from zero_transformer_tpu_torch.evalharness import choice_accuracy, lambada, perplexity
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_params

    tree = read_params_tree(args.params)
    if args.quantize == "int8":
        tree = quantize_params(tree)  # on the host, before the weights reach the device
    model = model_getter(args.model, dtype=getattr(torch, args.dtype), device=device, dropout=0.0,
                         param_quant=args.quantize)
    model.load_state_dict(params_from_jax(tree))
    model.cast_for_inference()

    def rows():
        return itertools.islice(_read_jsonl(args.data), args.limit)

    if args.task in ("ppl", "bpb"):
        if args.data.endswith((".bin", ".u16")):
            tokens = np.fromfile(args.data, dtype=np.uint16).astype(np.int32)
            num_bytes = args.num_bytes
        else:
            obj = json.loads(Path(args.data).read_text())
            tokens = np.asarray(_tok(tokenizer, obj["tokens"]), np.int32)
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
        examples = [(_tok(tokenizer, r["context"]), _tok(tokenizer, r["target"], True)) for r in rows()]
        out = lambada(model, examples, args.seq_len, args.batch_size)
    else:  # choice
        examples = []
        for r in rows():
            byte_lens = r.get("choice_bytes")
            if byte_lens is None and all(isinstance(c, str) for c in r["choices"]):
                # lm-eval's convention: the UTF-8 length of the scored continuation, its space included
                byte_lens = [len((" " + c).encode()) for c in r["choices"]]
            examples.append((_tok(tokenizer, r["context"]), [_tok(tokenizer, c, True) for c in r["choices"]],
                             int(r["gold"]), byte_lens))
        out = choice_accuracy(model, examples, args.seq_len, args.batch_size)
    print(json.dumps({"task": args.task, "model": args.model, "device": str(device), **out}))


if __name__ == "__main__":
    main()
