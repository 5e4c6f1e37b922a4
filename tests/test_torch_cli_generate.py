"""PyTorch port vs JAX reference: the generation modes of the serve CLI, on
the CPU in float32, with the same flax msgpack params and the byte
tokenizer on both sides:

- both parsers resolve the same sampling and generation defaults
  (temperature 0.8, top-k 0, top-p 0.9, repetition penalty 1.1, 128 new
  tokens, no speculation, ``--draft-k`` 0): the port used to default to
  1.0 / 0.0 / 1.0, so ``serve --server`` sampled another distribution;
- ``--prompt ... --greedy`` prints the text JAX ``serve.main`` prints, and
  so does ``--speculative 4`` (with the default penalty 1.1 and
  temperature 0.8 applied inside acceptance);
- the REPL on piped stdin prints what JAX's prints, and
  ``TextGenerator.stream`` yields JAX's pieces;
- ``--ui`` without gradio exits as JAX's does;
- ``--server --draft-k 4`` keeps the defaults' penalty 1.1 and switches
  speculation off with JAX's message.
"""
import io
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_generate import make_pair
from zero_transformer_tpu import serve as jax_serve
from zero_transformer_tpu.checkpoint import export_params_msgpack
from zero_transformer_tpu_torch import serve

PROMPTS = ["the quick brown", "hello again"]
MAX_NEW = 12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    _, params, _ = make_pair("test")
    path = tmp_path_factory.mktemp("cli") / "params.msgpack"
    export_params_msgpack(jax.tree.map(np.asarray, params), path)
    return str(path)


def _jax_defaults(monkeypatch) -> dict:
    """The namespace JAX ``serve.main`` builds from its own defaults (its
    parser lives inside ``main``): captured where it builds the generator."""
    seen = {}

    def capture(args):
        seen.update(vars(args))
        raise SystemExit(0)

    monkeypatch.setattr(jax_serve, "_build_generator", capture)
    with pytest.raises(SystemExit):
        jax_serve.main(["--model", "test", "--params", "p.msgpack"])
    return seen


def test_cli_sampling_defaults_match_jax(monkeypatch):
    ref = _jax_defaults(monkeypatch)
    port = vars(serve.build_parser().parse_args(["--model", "test", "--params", "p.msgpack"]))
    for name in ("temperature", "top_k", "top_p", "repetition_penalty", "greedy", "max_new_tokens", "speculative",
                 "draft_k", "prompt", "ui", "server", "cache_len", "slots", "max_queue", "prefill_chunk",
                 "page_size", "page_pool_tokens", "kv_cache_dtype", "quantize", "attention_impl", "dtype"):
        assert port[name] == ref[name], (name, port[name], ref[name])
    assert (port["temperature"], port["top_p"], port["repetition_penalty"]) == (0.8, 0.9, 1.1)


def _run(main, argv, capsys, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main(argv)
    return capsys.readouterr().out


def _argv(params_file, *more):
    return ["--model", "test", "--params", params_file, "--dtype", "float32", "--tokenizer", "bytes",
            "--max-new-tokens", str(MAX_NEW), *more]


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative4"])
def test_one_shot_prints_jax_text(params_file, capsys, speculative):
    for prompt in PROMPTS:
        more = ["--prompt", prompt, "--greedy"]
        ref = _run(jax_serve.main, _argv(params_file, *more), capsys)
        spec = ["--speculative", "4"] if speculative else []
        got = _run(serve.main, _argv(params_file, *more, *spec, "--device", "cpu"), capsys)
        assert got == ref and len(got) > 1, (got, ref)


def test_repl_streams_jax_pieces(params_file, capsys, monkeypatch):
    lines = "\n".join(PROMPTS) + "\n\n"
    ref = _run(jax_serve.main, _argv(params_file, "--greedy"), capsys, lines, monkeypatch)
    got = _run(serve.main, _argv(params_file, "--greedy", "--device", "cpu"), capsys, lines, monkeypatch)
    # after the banner: ">>> " and the streamed reply for each prompt, then the closing ">>> "
    assert got.split("\n", 1)[1] == ref.split("\n", 1)[1]
    assert got.count(">>> ") == len(PROMPTS) + 1
    args = serve.build_parser().parse_args(_argv(params_file, "--device", "cpu"))
    gen = serve.build_generator(args)
    jgen = jax_serve._build_generator(_jax_args(params_file, monkeypatch))
    for prompt in PROMPTS:
        kw = dict(max_new_tokens=MAX_NEW, greedy=True)
        assert list(gen.stream(prompt, **kw)) == list(jgen.stream(prompt, **kw))


def _jax_args(params_file, monkeypatch):
    """JAX ``serve.main``'s parsed arguments for the same command line."""
    seen = {}

    def capture(args):
        seen["args"] = args
        raise SystemExit(0)

    monkeypatch.setattr(jax_serve, "_build_generator", capture)
    with pytest.raises(SystemExit):
        jax_serve.main(_argv(params_file))
    monkeypatch.undo()
    return seen["args"]


def test_ui_exits_without_gradio(params_file, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio raises ImportError
    with pytest.raises(SystemExit, match="gradio is not installed"):
        jax_serve.main(_argv(params_file, "--ui"))
    with pytest.raises(SystemExit, match="gradio is not installed"):
        serve.main(_argv(params_file, "--ui", "--device", "cpu"))


def test_server_draft_k_needs_penalty_one(params_file, capsys):
    args = serve.build_parser().parse_args(_argv(params_file, "--server", "--draft-k", "4", "--device", "cpu",
                                                 "--cache-len", "32", "--prefill-chunk", "16", "--page-size", "8"))
    engine, _ = serve.build_engine(args)
    assert engine.draft_k == 0 and "speculation DISABLED" in capsys.readouterr().out
    args.repetition_penalty = 1.0
    engine, _ = serve.build_engine(args)
    assert engine.draft_k == 4 and engine.sampling.temperature == 0.8 and engine.sampling.top_p == 0.9
