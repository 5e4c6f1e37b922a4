"""Text-generation CLI and serving server for the PyTorch/CUDA port.

Counterpart of ``zero_transformer_tpu/serve.py`` (``ByteTokenizer`` :31,
``TextGenerator`` :59-219, the ``--server`` path :358-436, ``_repl`` :439,
``_ui`` :462, ``main`` :496-). Runs as::

    python -m zero_transformer_tpu_torch.serve --model 125m --params p.npz \\
        [--prompt "..."] [--ui] [--server] [--speculative K] [--draft-k K]

- with ``--server``: the continuous-batching HTTP server (``--draft-k K``
  verifies K prompt-lookup drafts per slot and tick; it needs
  ``--repetition-penalty 1.0`` and is switched off otherwise, as in JAX),
  with JAX's serving defaults: a 256-chunk prefix cache (``--prefix-cache``,
  off with ``--prefill-chunk 0``, the one-shot bucketed prefill, which runs
  on ``--kv-layout slab``: the paged default falls back to it with JAX's
  message; ``--max-prefill-buckets`` caps its distinct buckets), SIGTERM
  drains within ``--drain-deadline`` seconds and exits 0, SIGHUP and
  ``POST /admin/reload`` hot-swap the weights (``--params`` again, or the
  request's path) between ticks, ``--obs-dir`` receives flight-recorder dumps,
  profiles and span traces, ``--metrics-dir`` the metrics timeline;
  ``--role prefill`` or ``decode`` makes it one side of a disaggregated
  fleet (a prefill replica ships each finished prompt's KV pages to the
  decode replica its request names in ``prefill_to``), ``POST
  /admin/migrate`` moves a live stream to another replica, and
  ``--no-fused-tail`` runs the fused-tail A/B control (it switches
  ``--draft-k`` off, as in JAX);
- else with ``--ui``: a Gradio UI when gradio is importable (it exits with
  a message when it is not);
- else with ``--prompt``: one-shot generation to stdout;
- else an interactive REPL on stdin that streams each reply.

One-shot and REPL generation run ``inference.generate`` over a slab KV cache
of ``--cache-len`` positions (default ``max_seq_len``); ``--speculative K``
sends greedy one-shot generation through ``generate_speculative`` with K
shrunk to what the cache leaves. The sampling flags default to JAX's
(temperature 0.8, top-k 0, top-p 0.9, repetition penalty 1.1) on every
path; ``--approx-top-k`` (the TPU's approximate top-k) parses and is
refused before any weight loads. ``--params`` is an ``.npz`` of the flat flax param tree
(``convert.py`` says how to write one from the JAX package), a flax
``.msgpack`` (JAX ``export_params_msgpack``) or a trainer checkpoint's step
directory (``<checkpoint.directory>/<step>``). ``--quantize int8``
quantizes that tree on the host before any weight reaches the card (JAX
``serve.py`` :314-322); an ``.npz`` that is already quantized needs the
flag. ``--tokenizer`` is ``bytes`` (the byte-level tokenizer, the default)
or a local directory holding a HuggingFace tokenizer (``load_tokenizer``,
JAX ``_load_tokenizer`` :47: it needs the ``transformers`` package and
never resolves a hub name). The CLI runs on the CUDA card unless
``--device cpu`` is given; without a card it refuses to start.

``--tensor N`` (JAX :526) serves tensor-parallel over N ranks in every mode
(one-shot, REPL, ``--server``): the CLI is rank 0 and starts the other N - 1
itself (``torch.multiprocessing`` spawn, a ``file://`` rendezvous in a
fresh temporary directory), so JAX's command line works unchanged. Rank
0 alone reads the weights on the host and sends them one tensor at a time;
each rank keeps its shard (``inference.scatter_for_inference``), and rank 0
prints every rank's host memory peak. NCCL with a card per rank where N
cards are visible, else gloo with the ranks sharing card 0; ``--device
cpu`` runs gloo on the CPU. Rank 0 prints the backend and topology. One-shot
and REPL generation announce each job to the other ranks, which run the
same ``generate`` loop; the server's engine leads the others' worker loops
(``serving/engine.py``). An idle rank 0 (a server without traffic, a REPL
waiting on its user) sends a no-op every quarter of ``--tensor-timeout``,
the longest a rank waits inside one collective, so an idle world never
times out. ``--speculative`` is switched off under ``--tensor > 1`` with
JAX's message; the disaggregated roles and the slab layout's prefix cache
raise before any weight loads. A rank that dies ends every rank and the
CLI exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

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


def load_tokenizer(name_or_path: str):
    """``bytes``: the byte-level tokenizer. Else a local directory holding a
    HuggingFace tokenizer (``AutoTokenizer.from_pretrained(dir,
    local_files_only=True)``); ``transformers`` is imported here, and a name
    that is not a directory (a hub name) is refused: nothing is fetched."""
    if name_or_path == "bytes":
        return ByteTokenizer()
    if not Path(name_or_path).is_dir():
        raise NotImplementedError(
            f"tokenizer {name_or_path!r} is not a local directory: the port loads a HuggingFace tokenizer from a "
            "local directory only and never resolves a hub name; pass a directory written by "
            "save_pretrained, or 'bytes' for the byte tokenizer")
    try:
        from transformers import AutoTokenizer
    except ImportError as exc:
        raise ImportError(f"tokenizer directory {name_or_path!r} needs the 'transformers' package, which is not "
                          "installed here; the byte tokenizer ('bytes') needs nothing") from exc
    return AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)


class TextGenerator:
    """Tokenizer + model + slab-cache decode behind one ``__call__`` (and
    ``stream``). ``model`` lies on its device with its weights cast for
    inference; ``speculative`` K > 0 sends greedy ``__call__`` through
    prompt-lookup speculative decoding. Under a tensor group (the model's
    ``tp``) rank 0 announces each job and the other ranks run it in
    ``serve_worker``; between jobs rank 0's heartbeat thread announces a
    no-op every ``heartbeat_s``."""

    def __init__(self, model, tokenizer, cache_len: Optional[int] = None, speculative: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.cache_len = cache_len or model.cfg.max_seq_len
        self.group = getattr(model, "tp", None)
        if self.group is not None and speculative:
            if self.group.rank == 0:
                print("serve: --speculative is single-chip only and is DISABLED under --tensor>1 (requests take "
                      "the plain decode path)", flush=True)
            speculative = 0
        self.speculative = speculative
        self.device = next(model.parameters()).device
        # rank 0: announcements (jobs, heartbeats) go out one at a time; no heartbeat inside a job
        self._jobs = threading.Lock()
        self._busy = False
        self._stopped = threading.Event()
        if self.group is not None and self.group.rank == 0:
            threading.Thread(target=self._heartbeat, name="tensor-heartbeat", daemon=True).start()

    def _announce(self, job: Optional[dict]) -> None:
        """Rank 0 of a tensor group: the next job (None: stop) to the others;
        the job holds the group until ``_job_done``."""
        if self.group is None:
            return
        with self._jobs:
            if job is None:
                self._stopped.set()
            self._busy = job is not None
            self.group.broadcast_object(job)

    def _job_done(self) -> None:
        with self._jobs:
            self._busy = False

    def _heartbeat(self) -> None:
        """Rank 0: a no-op job every ``heartbeat_s`` while no job runs, so
        the other ranks' wait for the next job outlasts any idle spell."""
        while not self._stopped.wait(self.group.heartbeat_s):
            with self._jobs:
                if not self._busy and not self._stopped.is_set():
                    self.group.broadcast_object(dict(kind="noop"))

    def serve_worker(self) -> None:
        """A tensor group's rank > 0: run rank 0's jobs until it says stop."""
        while True:
            job = self.group.broadcast_object(None)
            if job is None:
                return
            kind = job.pop("kind")
            if kind == "noop":
                continue
            if kind == "call":
                self(**job)
            else:
                for _ in self.stream(**job):
                    pass

    def _decode(self, toks) -> str:
        from zero_transformer_tpu_torch.serving.detok import decode_tokens

        return decode_tokens(self.tokenizer, toks)

    def _prepare(self, prompt, max_new_tokens, temperature, top_k, top_p, repetition_penalty, greedy):
        """Encode and truncate the prompt, build the sampling config: one
        preamble for ``__call__`` and ``stream``."""
        from zero_transformer_tpu_torch.inference.sampling import SamplingConfig

        ids = self.tokenizer.encode(prompt.strip())
        budget = self.cache_len - max_new_tokens
        if budget < 1:
            raise ValueError("max_new_tokens leaves no room for the prompt")
        ids = ids[-budget:]  # keep the tail
        sampling = SamplingConfig(temperature=temperature, top_k=top_k, top_p=top_p,
                                  repetition_penalty=repetition_penalty, greedy=greedy)
        return ids, sampling, self.tokenizer.eos_token_id

    def __call__(self, prompt: str, max_new_tokens: int = 128, temperature: float = 0.8, top_k: int = 0,
                 top_p: float = 0.9, repetition_penalty: float = 1.1, greedy: bool = False,
                 seed: int = 0) -> str:
        lead = self.group is not None and self.group.rank == 0
        if lead:
            self._announce(dict(kind="call", prompt=prompt, max_new_tokens=max_new_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, greedy=greedy,
                                seed=seed))
        try:
            return self._call(prompt, max_new_tokens, temperature, top_k, top_p, repetition_penalty, greedy, seed)
        finally:
            if lead:
                self._job_done()

    def _call(self, prompt, max_new_tokens, temperature, top_k, top_p, repetition_penalty, greedy, seed) -> str:
        from zero_transformer_tpu_torch.inference import generate, generate_speculative

        ids, sampling, eos = self._prepare(prompt, max_new_tokens, temperature, top_k, top_p,
                                           repetition_penalty, greedy)
        prompt_t = torch.tensor([ids], dtype=torch.long)
        pad = eos if eos is not None else 0
        # the draft window must fit the cache (prompt + new + K): shrink K to what fits
        spec_k = min(self.speculative, self.cache_len - len(ids) - max_new_tokens)
        if spec_k > 0 and greedy:
            out = generate_speculative(
                self.model, prompt_t, max_new_tokens, draft_len=spec_k, eos_token_id=eos, pad_token_id=pad,
                repetition_penalty=repetition_penalty, temperature=temperature, cache_len=self.cache_len,
            )
        else:
            out = generate(
                self.model, prompt_t, max_new_tokens, torch.Generator(device=self.device).manual_seed(seed),
                sampling, eos_token_id=eos, pad_token_id=pad, cache_len=self.cache_len,
            )
        return self._decode([t for t in out[0].tolist() if t != eos])

    def stream(self, prompt: str, max_new_tokens: int = 128, temperature: float = 0.8, top_k: int = 0,
               top_p: float = 0.9, repetition_penalty: float = 1.1, greedy: bool = False, seed: int = 0):
        """Yield decoded text increments as the tokens come."""
        lead = self.group is not None and self.group.rank == 0
        if lead:
            self._announce(dict(kind="stream", prompt=prompt, max_new_tokens=max_new_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, greedy=greedy,
                                seed=seed))
        try:
            yield from self._stream(prompt, max_new_tokens, temperature, top_k, top_p, repetition_penalty, greedy,
                                    seed)
        finally:
            if lead:
                self._job_done()

    def _stream(self, prompt, max_new_tokens, temperature, top_k, top_p, repetition_penalty, greedy, seed):
        from zero_transformer_tpu_torch.inference import stream_tokens
        from zero_transformer_tpu_torch.serving.detok import StreamDecoder

        ids, sampling, eos = self._prepare(prompt, max_new_tokens, temperature, top_k, top_p,
                                           repetition_penalty, greedy)
        decoder = StreamDecoder(self.tokenizer)
        for token in stream_tokens(
            self.model, torch.tensor([ids], dtype=torch.long), max_new_tokens,
            torch.Generator(device=self.device).manual_seed(seed), sampling, eos_token_id=eos,
            cache_len=self.cache_len,
        ):
            t = int(token[0])
            if eos is not None and t == eos:
                break
            piece = decoder.push(t)
            if piece is not None:
                yield piece
        tail = decoder.flush()
        if tail is not None:
            yield tail


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zero_transformer_tpu_torch.serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="model zoo name (config.MODEL_ZOO)")
    p.add_argument("--params", required=True,
                   help=".npz of the flat flax param tree, a flax .msgpack, or a checkpoint step directory")
    p.add_argument("--prompt", default=None, help="one-shot generation")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding with K-token drafts (greedy one-shot "
                        "generation; the same output in fewer model forwards)")
    p.add_argument("--ui", action="store_true", help="launch the Gradio UI (needs gradio)")
    p.add_argument("--server", action="store_true", help="run the continuous-batching HTTP server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=_DEFAULTS.slots)
    p.add_argument("--max-queue", type=int, default=_DEFAULTS.max_queue)
    p.add_argument("--cache-len", type=int, default=None,
                   help="KV positions per sequence (default: max_seq_len)")
    p.add_argument("--prefill-chunk", type=int, default=_DEFAULTS.prefill_chunk)
    p.add_argument("--prefix-cache", type=int, default=_DEFAULTS.prefix_cache_chunks, metavar="CHUNKS",
                   help="capacity of the chunk-aligned token-prefix cache, in chunks (0 disables)")
    p.add_argument("--drain-deadline", type=float, default=_DEFAULTS.drain_deadline_s,
                   help="graceful-drain budget on SIGTERM: admission closes at once, in-flight generations "
                        "get this many seconds, then are force-finished (retryable)")
    p.add_argument("--metrics-dir", default=None, help="JSONL sink (metrics.jsonl) for serving metrics and events")
    p.add_argument("--metrics-interval", type=int, default=200, help="log serving metrics every N scheduler ticks")
    p.add_argument("--obs-dir", default=None,
                   help="observability directory: flight-recorder dumps, POST /admin/profile captures and span "
                        "traces (defaults to --metrics-dir)")
    p.add_argument("--no-trace", action="store_true", help="disable span tracing (/metrics histograms stay on)")
    p.add_argument("--admin-token", default=None,
                   help="bearer token for /admin/* from non-loopback peers (loopback is always allowed)")
    # the four flags of the slab slice carry JAX's help word for word
    p.add_argument("--kv-layout", default=None, choices=("slab", "paged"),
                   help="KV cache layout: 'paged' (default) = block-table page pool (PagedAttention) \u2014 HBM "
                        "scales with ACTUAL sequence lengths, not slots x cache_len, and prefix hits are "
                        "page-refcount bumps; 'slab' = the classic fixed [slots, cache_len] rows")
    p.add_argument("--max-prefill-buckets", type=int, default=_DEFAULTS.max_prefill_buckets,
                   help="cap on distinct compiled one-shot prefill buckets (legacy --prefill-chunk 0 path): past "
                        "it, new prompt lengths round up to an existing bucket instead of compiling another "
                        "program")
    p.add_argument("--no-fused-tail", action="store_true", default=None,
                   help="A/B CONTROL: run sampling as its own dispatch after the forward instead of inside the "
                        "single jitted decode program (byte-identical output; exists so the bench can price the "
                        "fused tail \u2014 disables --draft-k)")
    p.add_argument("--page-size", type=int, default=_DEFAULTS.page_size)
    p.add_argument("--page-pool-tokens", type=int, default=_DEFAULTS.page_pool_tokens,
                   help="KV pool size in positions (0 = slots x cache_len)")
    p.add_argument("--draft-k", type=int, default=_DEFAULTS.draft_k,
                   help="speculative serving: verify K prompt-lookup drafts per slot per tick in one "
                        "batched forward (greedy: the same output; sampling: the rejection rule); needs "
                        f"--repetition-penalty 1.0; 0 = off; default {_DEFAULTS.draft_k}")
    p.add_argument("--role", default=_DEFAULTS.role, choices=("mixed", "prefill", "decode"),
                   help="disaggregated fleet role: 'prefill' runs only chunked prefill and ships finished KV "
                        "pages to the decode replica each request names (prefill_to); 'decode' serves imported "
                        "streams plus the recompute fallback; 'mixed' (default) is the classic standalone "
                        "replica")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--quantize", default="none", choices=("none", "int8"),
                   help="weight-only int8 serving: Dense kernels + token table "
                        "stored int8 with per-channel scales, about half the "
                        "weight memory at rest; each call dequantizes them to "
                        "the compute dtype, so decode is not faster")
    p.add_argument("--kv-cache-dtype", default="auto", choices=("auto", "int8"),
                   help="int8 K/V with one float32 scale per token and kv head: "
                        "about half the KV cache's bytes, at slight quantization cost")
    p.add_argument("--attention-impl", default="auto", choices=("auto", "xla", "flash"),
                   help="'auto' runs the CUDA kernels wherever their gates accept, "
                        "'xla' the plain PyTorch reference, 'flash' kernel-or-raise")
    # the sampling defaults are JAX serve.py's, for every mode
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--approx-top-k", action="store_true",
                   help="use the TPU partial-reduce (lax.approx_max_k) for the top-k cutoff instead of the exact "
                        "vocab sort; the kept set can be slightly wider than k")
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--repetition-penalty", type=float, default=1.1)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--tokenizer", default="bytes",
                   help="'bytes' (the byte-level tokenizer) or a local directory holding a HuggingFace tokenizer "
                        "(needs the transformers package; a hub name is refused)")
    p.add_argument("--tensor", type=int, default=1, metavar="N",
                   help="tensor-parallel serving over N ranks (params + KV cache shard over heads/features; "
                        "serves models larger than one card's memory): NCCL with a card per rank where N cards "
                        "are visible, else gloo with the ranks sharing card 0")
    p.add_argument("--tensor-timeout", type=float, default=None, metavar="SECONDS",
                   help="under --tensor: the longest a rank waits inside one collective before it fails (default "
                        "1800); an idle rank 0 sends a no-op every quarter of it")
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


def host_peak_gib() -> float:
    """This process's peak resident memory in GiB: ``VmHWM`` where
    ``/proc/self/status`` has it (this process image's own), else
    ``ru_maxrss``, which also holds the peak of the process this one was
    forked from before its exec."""
    import resource

    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux


def build_model(args, group=None):
    """The model with the CLI's weights on its device, cast for inference.
    Over a tensor ``group`` only rank 0 reads the weights and each rank
    keeps its shard (``scatter_for_inference``); rank 0 prints every rank's
    host memory peak."""
    from zero_transformer_tpu_torch.inference import scatter_for_inference
    from zero_transformer_tpu_torch.models import model_getter

    device = group.device if group is not None else resolve_device(args.device)
    model = model_getter(
        args.model, dtype=getattr(torch, args.dtype), device=device,
        attention_impl=args.attention_impl, dropout=0.0,
        kv_cache_dtype=args.kv_cache_dtype, param_quant=args.quantize, tensor_group=group,
    )
    if model.tp is None:
        model.load_state_dict(load_params(args.params, args.quantize))
        return model.cast_for_inference()
    scatter_for_inference(model, load_params(args.params, args.quantize) if model.tp.rank == 0 else None, model.tp)
    # every rank's host peak, printed by rank 0 alone
    peak = torch.tensor([host_peak_gib()], dtype=torch.float64, device=device)
    peaks = model.tp.all_gather_(peak, 0).tolist()
    if model.tp.rank == 0:
        print(json.dumps({"tensor_host_peak_gib": peaks}), flush=True)
    return model.cast_for_inference()


def build_generator(args, group=None) -> TextGenerator:
    return TextGenerator(build_model(args, group), load_tokenizer(args.tokenizer), cache_len=args.cache_len,
                         speculative=args.speculative)


def sampling_config(args):
    """The CLI's sampling flags as a ``SamplingConfig``; ``--approx-top-k``
    raises its ``NotImplementedError``."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig

    return SamplingConfig(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repetition_penalty=args.repetition_penalty, greedy=args.greedy,
        top_k_impl="approx" if args.approx_top_k else "exact",
    )


def _engine_layout(args, say: bool = True) -> tuple:
    """(kv_layout, draft_k) after JAX's adjustments, with its messages:
    ``--prefill-chunk 0`` on the paged layout falls back to ``--kv-layout
    slab``; ``--draft-k`` with a repetition penalty other than 1.0, or with
    ``--no-fused-tail``, is switched off."""
    kv_layout = args.kv_layout or _DEFAULTS.kv_layout
    if kv_layout == "paged" and args.prefill_chunk == 0:
        if say:
            print("serve: --prefill-chunk 0 (legacy one-shot prefill) has no block-table path; falling back to "
                  "--kv-layout slab", flush=True)
        kv_layout = "slab"
    draft_k = args.draft_k
    if draft_k and args.repetition_penalty != 1.0:
        if say:
            print("serve: --draft-k requires --repetition-penalty 1.0 (the batched verify step cannot emulate "
                  "the in-block penalty); speculation DISABLED for this run", flush=True)
        draft_k = 0
    if draft_k and args.no_fused_tail:
        if say:
            print("serve: --no-fused-tail (the fused-tail A/B control) covers the plain decode path only; "
                  "speculation DISABLED for this run", flush=True)
        draft_k = 0
    return kv_layout, draft_k


def build_engine(args, group=None):
    """Model + weights + engine from parsed CLI arguments (JAX ``_server``
    :358-437), with JAX's adjustments (``_engine_layout``). Over a tensor
    ``group`` every rank builds it; only rank 0 prints, logs metrics and
    keeps the observability outputs."""
    from zero_transformer_tpu_torch.obs import MetricsLogger
    from zero_transformer_tpu_torch.serving.engine import ServingEngine

    lead = group is None or group.rank == 0
    sampling = sampling_config(args)
    kv_layout, draft_k = _engine_layout(args, say=lead)
    model = build_model(args, group)
    tokenizer = load_tokenizer(args.tokenizer)
    engine = ServingEngine(
        model, n_slots=args.slots, cache_len=args.cache_len, sampling=sampling,
        eos_token_id=tokenizer.eos_token_id, max_queue=args.max_queue,
        prefill_chunk=args.prefill_chunk, page_size=args.page_size,
        page_pool_tokens=args.page_pool_tokens, draft_k=draft_k, device=next(model.parameters()).device,
        prefix_cache_chunks=args.prefix_cache if args.prefill_chunk else 0,
        metrics=MetricsLogger(directory=args.metrics_dir) if lead else None, metrics_interval=args.metrics_interval,
        obs_dir=(args.obs_dir or args.metrics_dir) if lead else None, trace=lead and not args.no_trace,
        role=args.role, kv_layout=kv_layout, max_prefill_buckets=args.max_prefill_buckets,
        fused_tail=not args.no_fused_tail,
    )
    return engine, tokenizer


def _reload_loader(args):
    """The loader of a hot reload (SIGHUP / ``POST /admin/reload``): the
    startup path again (``load_params``: read, ``--quantize int8`` on the
    host), on the request's path or ``--params``. It runs on the reload's
    thread; the engine validates the state dict, casts it to the serving
    dtypes and swaps it in between ticks."""

    def load(path: Optional[str] = None):
        try:
            return load_params(path or args.params, args.quantize)
        except SystemExit as exc:  # the startup refusal, as a rejected reload
            raise ValueError(str(exc)) from None

    return load


def _sampling_kwargs(args) -> dict:
    return dict(max_new_tokens=args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, repetition_penalty=args.repetition_penalty, greedy=args.greedy)


def _repl(gen: TextGenerator, args) -> None:
    print("zero_transformer_tpu_torch generation REPL - empty line to exit")
    while True:
        try:
            prompt = input(">>> ")
        except EOFError:
            return
        if not prompt.strip():
            return
        for piece in gen.stream(prompt, **_sampling_kwargs(args)):
            print(piece, end="", flush=True)
        print()


def _ui(gen: TextGenerator) -> None:
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed in this environment; use the CLI/REPL surface instead")
    demo = gr.Interface(
        fn=lambda prompt, steps, temp, tk, tp, rp, greedy: gen(
            prompt, max_new_tokens=int(steps), temperature=temp, top_k=int(tk), top_p=tp,
            repetition_penalty=rp, greedy=greedy,
        ),
        inputs=[
            gr.Textbox(label="Prompt"),
            gr.Slider(1, 512, value=128, label="Max new tokens"),
            gr.Slider(0.1, 2.0, value=0.8, label="Temperature"),
            gr.Slider(0, 100, value=0, label="Top-k (0 = off)"),
            gr.Slider(0.0, 0.99, value=0.9, label="Top-p (0 = off)"),
            gr.Slider(1.0, 2.0, value=1.1, label="Repetition penalty"),
            gr.Checkbox(label="Greedy"),
        ],
        outputs=gr.Textbox(label="Completion"),
    )
    demo.launch()


def check_tensor_args(args) -> None:
    """Refuse a ``--tensor N`` run the port cannot serve, before any weight
    loads: N must divide the model's query and kv heads (and its MLP
    features and vocabulary); the disaggregated roles and the slab layout's
    prefix cache are not ported under N > 1; the UI runs on one rank."""
    from zero_transformer_tpu_torch.config import model_config
    from zero_transformer_tpu_torch.models.gpt import check_tensor_split
    from zero_transformer_tpu_torch.serving.engine import check_tensor_serving

    if args.tensor < 1:
        raise SystemExit(f"--tensor must be >= 1, got {args.tensor}")
    if args.tensor_timeout is not None and args.tensor_timeout <= 0:
        raise SystemExit(f"--tensor-timeout must be > 0 seconds, got {args.tensor_timeout}")
    if args.tensor == 1:
        return
    check_tensor_split(model_config(args.model), args.tensor)
    if args.ui:
        raise SystemExit("--ui serves from one rank: drop --tensor or use --prompt / --server")
    if args.server:
        kv_layout, _ = _engine_layout(args, say=False)
        check_tensor_serving(args.role, kv_layout, args.prefix_cache if args.prefill_chunk else 0)


class TensorRanks:
    """Rank 0's side of a ``--tensor N`` run: it starts ranks 1 .. N - 1
    (``_tensor_rank``, spawned), joins the group with them, and watches
    them: a rank that exits before ``close`` (or a ``fault()`` that turns
    true) ends every rank and this process with exit code 1, so a dead rank
    never leaves the others waiting in a collective."""

    def __init__(self, argv, args):
        import torch.multiprocessing as mp

        from zero_transformer_tpu_torch import serve as module  # importable by the spawned ranks, also under -m
        from zero_transformer_tpu_torch.inference import serve_mesh

        self.tensor = args.tensor
        self._dir = tempfile.mkdtemp(prefix="serve_tensor_")
        init = f"file://{os.path.join(self._dir, 'rendezvous')}"
        self._closing = False
        self.fault = lambda: None
        # daemonic: an exception in this process must not leave it joining ranks that wait on it
        self._ctx = mp.start_processes(module._tensor_rank, args=(list(argv), self.tensor, init, os.getpid()),
                                       nprocs=self.tensor - 1, join=False, daemon=True, start_method="spawn")
        self._watch = threading.Thread(target=self._watch_ranks, name="tensor-ranks", daemon=True)
        self._watch.start()
        self.group = serve_mesh(self.tensor, args.device, rank=0, init_method=init, timeout_s=args.tensor_timeout)

    def _watch_ranks(self) -> None:
        while not self._closing:
            for i, proc in enumerate(self._ctx.processes):
                if proc.exitcode is not None and (proc.exitcode != 0 or not self._closing):
                    self.fail(f"tensor rank {i + 1} exited with code {proc.exitcode}")
            fault = self.fault()
            if fault is not None:
                self.fail(f"rank 0 failed: {fault!r}")
            time.sleep(0.2)

    def fail(self, why: str) -> None:
        print(f"serve: {why}; stopping all {self.tensor} tensor ranks", file=sys.stderr, flush=True)
        for proc in self._ctx.processes:
            if proc.is_alive():
                proc.kill()
        os._exit(1)

    def close(self, timeout: float = 60.0) -> None:
        """After rank 0 told the others to stop: wait for them to exit 0."""
        self._closing = True
        end = time.monotonic() + timeout
        for i, proc in enumerate(self._ctx.processes):
            proc.join(max(end - time.monotonic(), 0.0))
            if proc.exitcode != 0:
                self.fail(f"tensor rank {i + 1} ended with code {proc.exitcode}")
        import shutil

        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)


def _tensor_rank(i: int, argv, tensor: int, init: str, parent: int) -> None:
    """Rank ``i + 1`` of a ``--tensor`` run (a spawned process): join the
    group, build this rank's shard, then follow rank 0's jobs (one-shot,
    REPL) or its engine's plans (``--server``). It exits if rank 0's
    process goes away."""
    from zero_transformer_tpu_torch.inference import serve_mesh

    args = build_parser().parse_args(argv)

    def orphaned() -> None:
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    group = serve_mesh(tensor, args.device, rank=i + 1, init_method=init, timeout_s=args.tensor_timeout)
    if args.server:
        engine, _ = build_engine(args, group)
        engine.serve_worker()
    else:
        build_generator(args, group).serve_worker()
    import torch.distributed as dist

    dist.destroy_process_group()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # refuse to start without the requested device
    sampling_config(args)  # refuse bad sampling flags (--approx-top-k too) before any weight loads
    check_tensor_args(args)
    ranks = TensorRanks(argv, args) if args.tensor > 1 else None
    group = None if ranks is None else ranks.group
    if ranks is not None:
        print(json.dumps({"tensor_ranks": args.tensor, "backend": group.backend, "device": str(group.device),
                          "cards": torch.cuda.device_count() if group.device.type == "cuda" else 0}), flush=True)
    if args.server:
        from zero_transformer_tpu_torch.serving.server import run_server

        engine, tokenizer = build_engine(args, group)
        if ranks is not None:
            ranks.fault = lambda: engine.tp_fault
        run_server(engine, tokenizer, host=args.host, port=args.port, reload_source=_reload_loader(args),
                   drain_deadline_s=args.drain_deadline, admin_token=args.admin_token)
        if ranks is not None:
            engine.shutdown_workers()
            ranks.close()
        return
    gen = build_generator(args, group)
    if args.ui:
        _ui(gen)
    elif args.prompt is not None:
        sys.stdout.write(gen(args.prompt, **_sampling_kwargs(args)) + "\n")
    else:
        _repl(gen, args)
    if ranks is not None:
        gen._announce(None)
        ranks.close()


if __name__ == "__main__":
    main()
