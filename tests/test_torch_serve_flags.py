"""The serve CLI's four flags of the slab slice against JAX's parser, and
what they select.

- ``--kv-layout``, ``--max-prefill-buckets``, ``--no-fused-tail`` and
  ``--approx-top-k``: the same defaults, choices, types and help as JAX
  ``serve.py``'s parser (captured where it parses).
- ``--approx-top-k`` parses and raises ``NotImplementedError`` (the port
  has exact top-k only), before any weight loads.
- ``build_engine``: ``--kv-layout slab`` with a chunk, ``--max-prefill-buckets``
  and ``--no-fused-tail`` reach the engine; ``--no-fused-tail --draft-k``
  switches speculation off with JAX's message.
- ``serve --server --prefill-chunk 0 --device cpu`` in a process of its own
  prints JAX's fallback message, answers a request on the slab layout
  (one-shot prefill) equal to an in-process engine, and drains on SIGTERM
  with exit code 0.
"""
import argparse
import json
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_serving import http_call, make_pair, sse_events, wait_for
from zero_transformer_tpu_torch.convert import params_to_jax
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.serve import build_engine, build_parser, main
from zero_transformer_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ("--kv-layout", "--max-prefill-buckets", "--no-fused-tail", "--approx-top-k")


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """JAX ``serve.main``'s parser (built inside ``main``), captured as it
    parses."""
    from zero_transformer_tpu import serve as jax_serve

    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jax_serve.main(["--model", "test", "--params", "p.msgpack"])
    monkeypatch.undo()
    return seen["parser"]


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


@pytest.mark.parametrize("flag", FLAGS)
def test_flag_matches_jax_parser(monkeypatch, flag):
    ref, got = _action(_jax_parser(monkeypatch), flag), _action(build_parser(), flag)
    for attr in ("dest", "default", "choices", "type", "help", "nargs", "const", "required"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert type(got) is type(ref)


@pytest.mark.parametrize("argv,want", [
    ([], dict(kv_layout=None, max_prefill_buckets=8, no_fused_tail=None, approx_top_k=False)),
    (["--kv-layout", "slab", "--max-prefill-buckets", "3", "--no-fused-tail", "--approx-top-k"],
     dict(kv_layout="slab", max_prefill_buckets=3, no_fused_tail=True, approx_top_k=True)),
])
def test_flags_parse_as_jax(monkeypatch, argv, want):
    ref = _jax_parser(monkeypatch).parse_args(["--model", "test", "--params", "p", *argv])
    got = build_parser().parse_args(["--model", "test", "--params", "p", *argv])
    assert {k: getattr(got, k) for k in want} == {k: getattr(ref, k) for k in want} == want
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--model", "test", "--params", "p", "--kv-layout", "ring"])


def test_approx_top_k_raises_before_any_weight_loads():
    for mode in (["--server"], ["--prompt", "hi"]):
        with pytest.raises(NotImplementedError, match="approx"):
            main(["--model", "test", "--params", "absent.npz", "--device", "cpu", "--approx-top-k", *mode])


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    _, _, model = make_pair()
    path = tmp_path_factory.mktemp("flags") / "p.npz"
    np.savez(path, **params_to_jax(model.state_dict()))
    return path, model


def _args(npz_path, *more):
    return build_parser().parse_args(["--model", "test", "--params", str(npz_path), "--device", "cpu", "--server",
                                      "--dtype", "float32", "--cache-len", "64", "--greedy", *more])


def test_build_engine_takes_the_flags(npz, capsys):
    path, _ = npz
    engine, _ = build_engine(_args(path, "--kv-layout", "slab", "--prefill-chunk", "16", "--max-prefill-buckets",
                                   "3", "--no-fused-tail"))
    assert (engine.kv_layout, engine.prefill_chunk, engine.max_prefill_buckets, engine.fused_tail) == \
        ("slab", 16, 3, False)
    assert engine._prefix_cache is not None and engine.metrics_snapshot()["fused_tail"] == 0
    capsys.readouterr()
    engine, _ = build_engine(_args(path, "--prefill-chunk", "16", "--page-size", "8", "--draft-k", "2",
                                   "--repetition-penalty", "1.0", "--no-fused-tail"))
    assert engine.draft_k == 0 and not engine.fused_tail
    assert ("serve: --no-fused-tail (the fused-tail A/B control) covers the plain decode path only; speculation "
            "DISABLED for this run") in capsys.readouterr().out


def test_server_prefill_chunk_0_falls_back_to_slab(npz):
    path, model = npz
    proc = subprocess.Popen(
        [sys.executable, "-m", "zero_transformer_tpu_torch.serve", "--model", "test", "--params", str(path),
         "--device", "cpu", "--dtype", "float32", "--server", "--port", "0", "--greedy", "--cache-len", "64",
         "--prefill-chunk", "0", "--repetition-penalty", "1.0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line:
                break
        out = "".join(lines)
        assert ("serve: --prefill-chunk 0 (legacy one-shot prefill) has no block-table path; falling back to "
                "--kv-layout slab") in out
        port = int(re.search(r"serving on http://[0-9.]+:(\d+)", out).group(1))
        wait_for(lambda: http_call(port, "GET", "/healthz")[0] == 200, 60, "READY")
        assert json.loads(http_call(port, "GET", "/healthz")[2])["kv_layout"] == "slab"
        prompt = [(3 * j) % 200 + 1 for j in range(11)]
        status, _, raw = http_call(port, "POST", "/generate", {"tokens": prompt, "max_new_tokens": 6})
        events = sse_events(raw)
        assert status == 200 and events[-1]["status"] == "done"
        eng = ServingEngine(model, n_slots=4, cache_len=64, sampling=SamplingConfig(greedy=True), prefill_chunk=0,
                            kv_layout="slab", device="cpu")
        h = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle()
        assert [e["token"] for e in events if "token" in e] == h.tokens
        snap = json.loads(http_call(port, "GET", "/metrics")[2])
        assert (snap["kv_layout"], snap["prefill_buckets"], snap["prefill_ticks"]) == ("slab", 1, 0)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out + rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
