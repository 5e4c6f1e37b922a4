"""PyTorch port vs JAX reference: the serving engine and the serve CLI at
tensor parallelism 2, on the CPU in float32.

One world of 2 gloo processes (``tests/_torch_dist.py``, its 120 s
deadline) runs the port's engine SPMD: rank 0 schedules and announces each
device program, rank 1 follows in ``serve_worker``. Its greedy streams
equal the one-rank port engine's and those of JAX's engine built with
``mesh=serve_mesh(2)`` on the 8-device CPU mesh, on:

- the paged engine with its prefix cache (a second wave hits the first
  wave's pages), the ``test`` model (ALiBi);
- the slab layout with the one-shot bucketed prefill;
- ``draft_k`` 4 (the verify window through K4 at T 5);
- ``llama3_test`` (RoPE, GQA) with int8 weights and the int8 KV cache.

The same world runs what only rank 0 decides but every rank must do, held
to the one-rank engine: a hot reload between two waves (the whole tensors
broadcast one at a time, each rank keeping its slices), an injected tick
fault (the breaker's device-state rebuild on every rank), and a
copy-on-write page copy (every rank's pools).

Each rank's KV pool takes half the one-rank engine's bytes, and its
weights about half (every split tensor halves; the norm scales, and an
int8 row split's scales, stay whole).

The CLI in processes: ``--tensor 2 --device cpu`` one-shot and REPL print
JAX ``serve.main --tensor 2``'s text; ``--server --tensor 2`` answers over
HTTP with the one-rank engine's stream and drains on SIGTERM with exit 0;
a rank killed with SIGKILL ends the server with a non-zero exit within the
deadline. With the collective timeout cut to ``IDLE_TIMEOUT_S``, a server
and a REPL left idle for three times that still answer: rank 0's
heartbeat keeps the waiting rank inside its timeout.
"""
import io
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dist
from _torch_serving import http_call, make_pair
from zero_transformer_tpu import serve as jax_serve
from zero_transformer_tpu.checkpoint import export_params_msgpack
from zero_transformer_tpu.inference import decode_model as j_decode_model
from zero_transformer_tpu.inference import serve_mesh as j_serve_mesh
from zero_transformer_tpu.inference import shard_for_inference as j_shard
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.serving import ServingEngine

WORLD, NEW, CACHE = 2, 10, 64
REPO = Path(__file__).resolve().parents[1]


def _prompt(n, salt):
    return [int(x) for x in np.random.default_rng(salt).integers(1, 250, n)]


SYSTEM = _prompt(32, 90)  # two chunks a later request shares
CASES = {  # name: (model pair overrides, engine kwargs, waves of prompts)
    "paged_prefix_cache": (dict(), dict(prefill_chunk=16, page_size=8, prefix_cache_chunks=8),
                           [[SYSTEM + _prompt(5, 1), _prompt(21, 2)], [SYSTEM + _prompt(9, 3), _prompt(7, 4)]]),
    "slab_one_shot": (dict(), dict(kv_layout="slab", prefill_chunk=0),
                      [[_prompt(5, 5), _prompt(19, 6), _prompt(11, 7)]]),
    "draft_k4": (dict(), dict(prefill_chunk=16, page_size=8, draft_k=4),
                 [[_prompt(14, 8) * 2, _prompt(6, 9)]]),
    "llama_int8_weights_kv": (dict(name="llama3_test", kv_cache_dtype="int8", param_quant="int8"),
                              dict(prefill_chunk=16, page_size=8), [[_prompt(23, 10), _prompt(9, 11)]]),
}


# port-only cases: (engine kwargs, waves, extras), held to the one-rank engine
EXTRA = {
    "hot_reload": (dict(prefill_chunk=16, page_size=8), [[_prompt(11, 12), _prompt(20, 13)], [_prompt(9, 14)]],
                   dict(reload=0.5)),
    "tick_fault_rebuild": (dict(prefill_chunk=16, page_size=8), [[_prompt(11, 15), _prompt(6, 16)],
                                                                  [_prompt(8, 17)]],
                           dict(fault=dict(kind="tick_fault", step=4, duration=1))),
    "copy_on_write": (dict(prefill_chunk=16, page_size=8), [[_prompt(5, 18)]], dict(cow=True)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(name):
    over = dict(CASES[name][0])
    quant = over.pop("param_quant", "none")
    if quant == "int8":
        from test_torch_generate import make_pair as gen_pair

        zoo = over.pop("name")
        return gen_pair(zoo, kv=over.pop("kv_cache_dtype", "auto"), weights="int8", **over)
    return make_pair(**over)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    payload = {}
    for name, (over, engine, waves) in CASES.items():
        _, _, model = _pair(name)
        zoo = over.get("name", "test")
        payload[name] = dict(zoo=zoo, over=dict(dropout=0.0, compute_dtype="float32",
                                                **{k: v for k, v in over.items() if k != "name"}),
                             state={n: t.numpy() for n, t in model.state_dict().items()},
                             engine=dict(n_slots=2, cache_len=CACHE, **engine), waves=waves, new=NEW)
    model = make_pair()[2]
    for name, (engine, waves, extra) in EXTRA.items():
        extra = dict(extra)
        if "reload" in extra:  # the reloaded weights: every matrix times the factor
            extra["reload"] = {n: (t * extra["reload"] if t.ndim >= 2 else t).numpy()
                               for n, t in model.state_dict().items()}
        payload[name] = dict(zoo="test", over=dict(dropout=0.0, compute_dtype="float32"), new=NEW,
                             state={n: t.numpy() for n, t in model.state_dict().items()},
                             engine=dict(n_slots=2, cache_len=CACHE, **engine), waves=waves, **extra)
    return _torch_dist.run_world("tp_engine_cases", payload, tmp_path_factory.mktemp("tp_engine"), world=WORLD)


def _one_rank(name):
    _, engine_kw, waves = CASES[name]
    engine = ServingEngine(_pair(name)[2], device="cpu", n_slots=2, cache_len=CACHE,
                           sampling=SamplingConfig(greedy=True), **engine_kw)
    streams = []
    for wave in waves:
        handles = [engine.submit(list(p), max_new_tokens=NEW) for p in wave]
        engine.run_until_idle()
        streams += [h.tokens for h in handles]
    return engine, streams


def _one_rank_extra(name):
    """The one-rank engine through an EXTRA case: the same waves, reload and
    fault; returns (streams, outcomes)."""
    from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey

    engine_kw, waves, extra = EXTRA[name]
    model = make_pair()[2]
    reload = None
    if "reload" in extra:
        reload = {n: (t * extra["reload"] if t.ndim >= 2 else t).clone() for n, t in model.state_dict().items()}
    chaos = ServingChaosMonkey([ServeFault(**extra["fault"])]) if "fault" in extra else None
    engine = ServingEngine(model, device="cpu", n_slots=2, cache_len=CACHE, sampling=SamplingConfig(greedy=True),
                           chaos=chaos, **engine_kw)
    streams, outcomes = [], []
    for i, wave in enumerate(waves):
        if i and reload is not None:
            engine.reload_params(reload)
        handles = [engine.submit(list(p), max_new_tokens=NEW) for p in wave]
        engine.run_until_idle()
        streams += [h.tokens for h in handles]
        outcomes += [(h.status, h.retryable) for h in handles]
    return engine, streams, outcomes


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_tp2_reload_fault_and_page_copy_follow_rank0(ranks, name):
    got = ranks[0][name]
    engine, streams, outcomes = _one_rank_extra(name)
    assert got["streams"] == streams and [tuple(o) for o in got["outcomes"]] == outcomes
    snap = got["snapshot"]
    if name == "hot_reload":
        assert snap["reloads"] == 1
    if name == "tick_fault_rebuild":
        assert snap["tick_faults"] == 1 == engine.stats["tick_faults"]
        assert any(r for _, r in outcomes) and any(not r for _, r in outcomes)  # some failed retryably, some served
    if name == "copy_on_write":
        assert all(r[name]["copied"] for r in ranks)


def _jax_mesh_streams(name):
    jcfg, params, _ = _pair(name)
    _, engine_kw, waves = CASES[name]
    mesh = j_serve_mesh(WORLD)
    sharded = j_shard(j_decode_model(jcfg, CACHE), params, mesh)
    kw = dict(engine_kw)
    kw.setdefault("kv_layout", "paged")
    engine = JaxEngine(jcfg, sharded, mesh=mesh, n_slots=2, cache_len=CACHE, sampling=JaxSampling(greedy=True),
                       **kw)
    streams = []
    for wave in waves:
        handles = [engine.submit(list(p), max_new_tokens=NEW) for p in wave]
        engine.run_until_idle()
        streams += [list(h.tokens) for h in handles]
    return engine, streams


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_engine_streams_equal_one_rank_and_jax_mesh(ranks, name, devices):
    got = ranks[0][name]
    _, one = _one_rank(name)
    jengine, jstreams = _jax_mesh_streams(name)
    assert got["streams"] == one == jstreams
    assert all(len(s) == NEW for s in got["streams"])
    assert any(len(set(s)) > 1 for s in got["streams"])
    snap = got["snapshot"]
    if name == "paged_prefix_cache":
        assert snap["prefix_hits"] >= 1 and snap["prefix_hits"] == jengine.metrics_snapshot()["prefix_hits"]
    if name == "draft_k4":
        assert snap["spec_ticks"] > 0 and snap["draft_tokens"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_ranks_hold_half_the_bytes(ranks, name):
    one, _ = _one_rank(name)
    for r in ranks:
        assert r[name]["kv_pool_bytes"] * WORLD == one.kv_pool_bytes
        # the norm scales (and the int8 row splits' scales) stay whole on every rank
        assert one.weight_bytes / WORLD < r[name]["weight_bytes"] < one.weight_bytes * 0.52


def test_tp2_engine_refuses_what_it_does_not_split():
    from zero_transformer_tpu_torch.serving.engine import check_tensor_serving

    with pytest.raises(NotImplementedError, match="role='prefill'"):
        check_tensor_serving("prefill", "paged", 0)
    with pytest.raises(NotImplementedError, match="prefix cache"):
        check_tensor_serving("mixed", "slab", 4)
    check_tensor_serving("mixed", "paged", 256)


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def params_files(tmp_path_factory):
    _, params, model = make_pair()
    d = tmp_path_factory.mktemp("cli")
    export_params_msgpack(jax.tree.map(np.asarray, params), d / "params.msgpack")
    return str(d / "params.msgpack"), model


def _cli(params, *more, **popen):
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.serve", "--model", "test", "--params", params,
           "--device", "cpu", "--dtype", "float32", "--tokenizer", "bytes", "--tensor", "2", *more]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            **popen)


def _jax_text(params, capsys, monkeypatch, *more, stdin=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    jax_serve.main(["--model", "test", "--params", params, "--dtype", "float32", "--tokenizer", "bytes",
                    "--tensor", "2", "--max-new-tokens", str(NEW), "--greedy", *more])
    return capsys.readouterr().out


def _port_text(out: str) -> str:
    """The CLI's stdout without its topology lines."""
    return "".join(line for line in out.splitlines(keepends=True) if not line.startswith('{"tensor_'))


def test_cli_one_shot_and_repl_tensor2_print_jax_text(params_files, capsys, monkeypatch, devices):
    params, _ = params_files
    proc = _cli(params, "--prompt", "the quick brown", "--max-new-tokens", str(NEW), "--greedy")
    out, err = proc.communicate(timeout=_torch_dist.DEADLINE_S)
    assert proc.returncode == 0, err
    assert '"backend": "gloo"' in out
    assert _port_text(out) == _jax_text(params, capsys, monkeypatch, "--prompt", "the quick brown")
    lines = "hello there\nthe quick brown\n\n"
    proc = _cli(params, "--max-new-tokens", str(NEW), "--greedy", stdin=subprocess.PIPE)
    out, err = proc.communicate(lines, timeout=_torch_dist.DEADLINE_S)
    assert proc.returncode == 0, err
    ref = _jax_text(params, capsys, monkeypatch, stdin=lines)
    assert _port_text(out).split("\n", 1)[1] == ref.split("\n", 1)[1]


IDLE_TIMEOUT_S = 5.0  # the idle tests' collective timeout: they sit idle for three times it


def _start_server(params, *more):
    proc = _cli(params, "--server", "--port", "0", "--greedy", "--repetition-penalty", "1.0", "--cache-len",
                str(CACHE), "--prefill-chunk", "16", "--page-size", "8", "--slots", "2", *more)
    end = time.monotonic() + _torch_dist.DEADLINE_S
    while time.monotonic() < end:
        line = proc.stdout.readline()
        match = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
        if match:
            return proc, int(match.group(1))
        if not line and proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError(f"the server did not start: {proc.stderr.read()}")


def _children(pid: int) -> list:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(x) for x in path.read_text().split()] if path.exists() else []


def _one_rank_stream(model, prompt: str) -> list:
    engine = ServingEngine(model, device="cpu", n_slots=2, cache_len=CACHE, sampling=SamplingConfig(greedy=True),
                           prefill_chunk=16, page_size=8)
    handle = engine.submit(list(prompt.encode()), max_new_tokens=NEW)
    engine.run_until_idle()
    return handle.tokens


def _generate_over_http(port: int, prompt: str) -> list:
    import json

    status, _, body = http_call(port, "POST", "/generate", {"prompt": prompt, "max_new_tokens": NEW,
                                                            "stream": False}, timeout=_torch_dist.DEADLINE_S)
    assert status == 200
    return json.loads(body)["tokens"]


def test_cli_server_tensor2_outlives_its_collective_timeout_idle(params_files):
    params, model = params_files
    proc, port = _start_server(params, "--tensor-timeout", str(IDLE_TIMEOUT_S))
    try:
        time.sleep(3 * IDLE_TIMEOUT_S)  # no traffic: no device program, only heartbeats
        assert proc.poll() is None, proc.stderr.read()
        prompt = "tensor parallel"
        tokens = _generate_over_http(port, prompt)
        assert tokens == _one_rank_stream(model, prompt) and len(tokens) == NEW
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=_torch_dist.DEADLINE_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_repl_tensor2_outlives_its_collective_timeout_idle(params_files):
    params, _ = params_files
    proc = _cli(params, "--max-new-tokens", str(NEW), "--greedy", "--tensor-timeout", str(IDLE_TIMEOUT_S),
                stdin=subprocess.PIPE)
    try:
        proc.stdin.write("hello there\n")
        proc.stdin.flush()
        time.sleep(3 * IDLE_TIMEOUT_S)  # the first reply done, the REPL waits on its user
        assert proc.poll() is None, proc.stderr.read()
        out, err = proc.communicate("hello there\n\n", timeout=_torch_dist.DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    replies = _port_text(out).split(">>> ")[1:]
    assert len(replies) == 3 and replies[0] == replies[1] and replies[0].strip(), replies


def test_cli_server_tensor2_answers_and_drains(params_files):
    params, model = params_files
    proc, port = _start_server(params)
    try:
        prompt = "tensor parallel"
        status, _, body = http_call(port, "POST", "/generate", {"prompt": prompt, "max_new_tokens": NEW,
                                                                "stream": False}, timeout=_torch_dist.DEADLINE_S)
        assert status == 200
        import json

        tokens = json.loads(body)["tokens"]
        engine = ServingEngine(model, device="cpu", n_slots=2, cache_len=CACHE, sampling=SamplingConfig(greedy=True),
                               prefill_chunk=16, page_size=8)
        handle = engine.submit(list(prompt.encode()), max_new_tokens=NEW)
        engine.run_until_idle()
        assert tokens == handle.tokens and len(tokens) == NEW
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=_torch_dist.DEADLINE_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_server_ends_when_a_rank_dies(params_files):
    params, _ = params_files
    proc, port = _start_server(params)
    try:
        ranks = [c for c in _children(proc.pid) if b"spawn" in Path(f"/proc/{c}/cmdline").read_bytes()
                 and b"resource_tracker" not in Path(f"/proc/{c}/cmdline").read_bytes()]
        assert len(ranks) == 1, ranks
        t0 = time.monotonic()
        os.kill(ranks[0], signal.SIGKILL)
        code = proc.wait(timeout=_torch_dist.DEADLINE_S)
        assert code != 0 and time.monotonic() - t0 < _torch_dist.DEADLINE_S
        assert "tensor rank 1 exited" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
