"""Serving CLI for the PyTorch/CUDA port.

Counterpart of ``zero_transformer_tpu/serve.py`` (``ByteTokenizer`` :31,
the ``--server`` path :358-436, ``main`` :496-). Runs as::

    python -m zero_transformer_tpu_torch.serve --model 125m --params p.npz --server \
        [--kv-cache-dtype int8] [--quantize int8]

``--params`` is an ``.npz`` of the flat flax param tree (``convert.py`` says
how to write one from the JAX package), a flax ``.msgpack`` (JAX
``export_params_msgpack``) or a trainer checkpoint's step directory
(``<checkpoint.directory>/<step>``). ``--quantize int8`` quantizes that
tree on the host before any weight reaches the card (JAX ``serve.py``
:314-322); an ``.npz`` that is already quantized needs the flag. The
continuous-batching HTTP server (``--server``) is the only mode of this
slice. The CLI runs on the CUDA card unless ``--device cpu`` is given;
without a card it refuses to start.
"""
from __future__ import annotations

import argparse
import sys

import torch

from zero_transformer_tpu_torch.config import ServingConfig, resolve_device

_DEFAULTS = ServingConfig()


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: token id = byte value. ``--tokenizer
    bytes``: needs no download. No EOS - generation runs to max_new_tokens;
    ids past 255 decode to nothing."""

    eos_token_id = None

    def encode(self, text: str):
        return list(text.encode("utf-8"))

    def decode(self, toks, **kwargs) -> str:
        return bytes(t for t in toks if 0 <= t < 256).decode("utf-8", errors="replace")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="model zoo name (config.MODEL_ZOO)")
    p.add_argument("--params", required=True,
                   help=".npz of the flat flax param tree, a flax .msgpack, or a checkpoint step directory")
    p.add_argument("--server", action="store_true", help="run the continuous-batching HTTP server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=_DEFAULTS.slots)
    p.add_argument("--max-queue", type=int, default=_DEFAULTS.max_queue)
    p.add_argument("--cache-len", type=int, default=None, help="KV positions per slot (default: max_seq_len)")
    p.add_argument("--prefill-chunk", type=int, default=_DEFAULTS.prefill_chunk)
    p.add_argument("--page-size", type=int, default=_DEFAULTS.page_size)
    p.add_argument("--page-pool-tokens", type=int, default=_DEFAULTS.page_pool_tokens,
                   help="KV pool size in positions (0 = slots x cache_len)")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--quantize", default="none", choices=("none", "int8"),
                   help="weight-only int8 serving: Dense kernels + token table "
                        "stored int8 with per-channel scales, about half the "
                        "weight memory at rest; each call dequantizes them to "
                        "the compute dtype, so decode is not faster")
    p.add_argument("--kv-cache-dtype", default="auto", choices=("auto", "int8"),
                   help="int8 K/V with one float32 scale per token and kv head: "
                        "about half the KV pool's bytes, at slight quantization cost")
    p.add_argument("--attention-impl", default="auto", choices=("auto", "xla", "flash"),
                   help="'auto' runs the CUDA kernels wherever their gates accept, "
                        "'xla' the plain PyTorch reference, 'flash' kernel-or-raise")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--tokenizer", default="bytes", choices=("bytes",),
                   help="the byte-level tokenizer is the one this slice ships")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_params(path: str, quantize: str):
    """The port's state dict from an ``.npz``, a flax msgpack file or a
    checkpoint step directory (``convert.read_params_tree``): quantized on
    the host first with ``quantize="int8"``; an already-quantized file
    without it exits."""
    from zero_transformer_tpu_torch.convert import params_from_jax, read_params_tree
    from zero_transformer_tpu_torch.models.quant import has_quantized_leaves, quantize_params

    tree = read_params_tree(path)
    if quantize != "int8" and has_quantized_leaves(tree):
        raise SystemExit(
            f"{path} is already int8-quantized (kernel_q/embedding_q "
            "leaves found); pass --quantize int8 to serve it"
        )
    if quantize == "int8":
        tree = quantize_params(tree)
    return params_from_jax(tree)


def build_engine(args):
    """Model + weights + engine from parsed CLI arguments."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.serving.engine import ServingEngine

    device = resolve_device(args.device)
    state = load_params(args.params, args.quantize)
    model = model_getter(
        args.model, dtype=getattr(torch, args.dtype), device=device,
        attention_impl=args.attention_impl, dropout=0.0,
        kv_cache_dtype=args.kv_cache_dtype, param_quant=args.quantize,
    )
    model.load_state_dict(state)
    sampling = SamplingConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty, greedy=args.greedy,
    )
    tokenizer = ByteTokenizer()
    engine = ServingEngine(
        model, n_slots=args.slots, cache_len=args.cache_len, sampling=sampling,
        eos_token_id=tokenizer.eos_token_id, max_queue=args.max_queue,
        prefill_chunk=args.prefill_chunk, page_size=args.page_size,
        page_pool_tokens=args.page_pool_tokens, device=device,
    )
    return engine, tokenizer


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # refuse to start without the requested device
    if not args.server:
        sys.exit("this slice serves over HTTP only: pass --server")
    from zero_transformer_tpu_torch.serving.server import run_server

    engine, tokenizer = build_engine(args)
    run_server(engine, tokenizer, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
