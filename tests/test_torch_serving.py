"""PyTorch port vs JAX reference: the continuous-batching engine, then an
HTTP smoke of the port's server. CPU, float32, greedy.

Four requests whose prompt lengths straddle the chunk (16) and page (8)
edges go through the JAX ``ServingEngine`` (paged KV, chunked prefill) and
the port's ``ServingEngine`` built from the same converted params; the
emitted token streams must be identical: with the full-precision model, and
with the int8 KV cache, int8 weights (``quantize_params`` on both sides),
and both. A tie between the top two logits
would make greedy decoding ill-posed rather than wrong, so every compared
step first asserts a top-1/top-2 gap of at least 1e-4 and fails with its
own message when there is none.
"""
import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.quant import quantize_params as j_quantize_params
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.models.quant import quantize_params
from zero_transformer_tpu_torch.serve import ByteTokenizer
from zero_transformer_tpu_torch.serving import ServingEngine, ServingServer

CACHE_LEN, CHUNK, PAGE, MAX_NEW = 64, 16, 8, 6
PROMPT_LENS = (7, 16, 17, 33)
MIN_GAP = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_model_config("test", dropout=0.0, compute_dtype="float32")
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, unbox(params))
    model = Transformer(model_config("test", dropout=0.0, compute_dtype="float32"), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    prompts = [[(5 + 7 * n + 3 * i) % 250 + 1 for i in range(n)] for n in PROMPT_LENS]
    return jcfg, params, model, prompts


def _port_engine(model, **kw):
    return ServingEngine(
        model, n_slots=4, cache_len=CACHE_LEN, sampling=SamplingConfig(greedy=True),
        prefill_chunk=CHUNK, page_size=PAGE, device="cpu", **kw,
    )


def _both_streams(jcfg, params, model, prompts):
    """Greedy streams of the JAX engine and the port's on the same prompts;
    every compared step must have a top-1/top-2 gap (see the module doc)."""
    jeng = JaxEngine(
        jcfg, params, n_slots=4, cache_len=CACHE_LEN, sampling=JaxSampling(greedy=True),
        prefill_chunk=CHUNK, kv_layout="paged", page_size=PAGE,
    )
    jh = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    jeng.run_until_idle()
    teng = _port_engine(model)
    th = [teng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    teng.run_until_idle()
    for p, a, b in zip(prompts, jh, th):
        assert a.status == b.status == "done"
        seq = list(p) + list(b.tokens)
        with torch.no_grad():
            logits = model(torch.tensor([seq]))[0].float()
        for i in range(len(b.tokens)):
            top2 = torch.topk(logits[len(p) - 1 + i], 2).values
            gap = float(top2[0] - top2[1])
            assert gap >= MIN_GAP, (
                f"prompt of {len(p)}: top-2 logit gap {gap:.2e} < {MIN_GAP} at step {i}; "
                "greedy decoding is a tie here, pick other inputs"
            )
        assert list(a.tokens) == list(b.tokens), f"prompt of {len(p)}: JAX {a.tokens} != port {b.tokens}"
    return teng


def test_engine_streams_match_jax(setup):
    jcfg, params, model, prompts = setup
    teng = _both_streams(jcfg, params, model, prompts)
    snap = teng.metrics_snapshot()
    assert snap["completed"] == len(prompts) and snap["tokens_out"] == MAX_NEW * len(prompts)
    assert snap["prefill_chunks"] == sum(-(-n // CHUNK) for n in PROMPT_LENS)
    # on the CPU every kernel wrapper takes its plain version: no launches
    assert snap["kernel_launches"] == {"flash_serving_fwd": 0, "paged_attention": 0,
                                       "paged_attention_int8": 0,
                                       "flash_train_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                                       "flash_train_fwd_docs": 0, "flash_dq_docs": 0,
                                       "flash_dkv_docs": 0, "flash_partial_fwd": 0,
                                       "flash_partial_dq": 0, "flash_partial_dkv": 0,
                                       "flash_partial_fwd_docs": 0, "flash_partial_dq_docs": 0,
                                       "flash_partial_dkv_docs": 0}


@pytest.mark.parametrize("kv,weights", [("int8", "none"), ("auto", "int8"), ("int8", "int8")],
                         ids=["int8_kv", "int8_weights", "int8_both"])
def test_int8_engine_streams_match_jax(setup, kv, weights):
    jcfg, params, _, prompts = setup
    over = dict(kv_cache_dtype=kv, param_quant=weights)
    tree = jax.tree.map(np.asarray, unbox(params))
    if weights == "int8":
        params = jax.tree.map(jnp.asarray, j_quantize_params(tree))
        tree = quantize_params(tree)
    model = Transformer(model_config("test", dropout=0.0, compute_dtype="float32", **over), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    teng = _both_streams(dataclasses.replace(jcfg, **over), params, model, prompts)
    snap = teng.metrics_snapshot()
    assert snap["kv_cache_dtype"] == kv and snap["param_quant"] == weights
    # int8 pools: 1 byte per element plus a float32 scale per (position, kv head)
    n_pos = (4 * CACHE_LEN + PAGE) * model.cfg.n_layers * model.cfg.kv_heads
    per_pos = model.cfg.head_width + 4 if kv == "int8" else 4 * model.cfg.head_width
    assert snap["kv_pool_bytes"] == 2 * n_pos * per_pos


def test_engine_rejects_and_bounds(setup):
    _, _, model, prompts = setup
    eng = _port_engine(model, max_queue=1)
    assert eng.submit([], max_new_tokens=2).status == "rejected"
    assert eng.submit([1] * 60, max_new_tokens=10).status == "rejected"  # past cache_len
    ok = eng.submit(prompts[0], max_new_tokens=2)
    full = eng.submit(prompts[0], max_new_tokens=2)
    assert full.status == "rejected" and full.retryable
    eng.run_until_idle()
    assert ok.status == "done" and len(ok.tokens) == 2
    assert eng.slots.pool.in_use == 0 and eng.slots.pool.reserved == 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_http_server_smoke(setup):
    _, _, model, _ = setup
    eng = _port_engine(model)
    server = ServingServer(eng, ByteTokenizer(), port=0)
    server.start(start_scheduler=False)
    base = f"http://127.0.0.1:{server.port}"
    try:
        code, body = _get(base + "/healthz")
        assert code == 503 and body["state"] == "starting"
        server.start_scheduler()
        for _ in range(200):
            if _get(base + "/healthz")[0] == 200:
                break
            time.sleep(0.01)
        assert _get(base + "/healthz")[0] == 200
        code, ctype, text = _post(base + "/generate", {"prompt": "hello paged world", "max_new_tokens": 5,
                                                       "stream": False})
        doc = json.loads(text)
        assert code == 200 and ctype == "application/json"
        assert doc["status"] == "done" and len(doc["tokens"]) == 5
        code, ctype, text = _post(base + "/generate", {"prompt": "hello paged world", "max_new_tokens": 5})
        assert code == 200 and ctype == "text/event-stream"
        events = [json.loads(line[len("data: "):]) for line in text.splitlines() if line.startswith("data: ")]
        assert [e["token"] for e in events if "token" in e] == doc["tokens"]
        assert events[-1]["done"] and events[-1]["status"] == "done"
        code, metrics = _get(base + "/metrics")
        assert code == 200 and metrics["completed"] == 2 and "ttft_ms_p50" in metrics
    finally:
        server.stop()
