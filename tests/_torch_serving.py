"""Shared helpers of the port's serving-policy tests (``test_torch_prefix_cache``,
``test_torch_serving_resilience``, ``test_torch_qos``, ``test_torch_serving_obs``):
the ``test`` model in float32 with the same weights on both sides, engine
builders at cache 64 / chunk 16 / page 8, greedy, an injected clock, the
byte tokenizer and HTTP helpers."""
import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.serving import ServeFault as JaxFault
from zero_transformer_tpu.serving import ServingChaosMonkey as JaxChaos
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey, ServingEngine

CACHE_LEN, CHUNK, PAGE = 64, 16, 8
MIN_GAP = 1e-4
# JAX's init (std 0.02) makes the tiny GPT repeat one token per row; four
# times the weights make every row's greedy tokens vary
WEIGHT_SCALE = 4.0


def make_pair(seed: int = 0, scale: float = WEIGHT_SCALE, name: str = "test", **overrides):
    """(JAX cfg, JAX params, port model) with the same float32 weights:
    JAX's init of the zoo model ``name`` (``test`` by default; config
    ``overrides`` on both sides), every matrix times ``scale``."""
    jcfg = jax_model_config(name, dropout=0.0, compute_dtype="float32", **overrides)
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1), unbox(params))
    model = Transformer(model_config(name, dropout=0.0, compute_dtype="float32", **overrides), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def port_engine(model, **kw) -> ServingEngine:
    kw.setdefault("n_slots", 4)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("sampling", SamplingConfig(greedy=True))
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("page_size", PAGE)
    return ServingEngine(model, device="cpu", **kw)


def jax_engine(jcfg, params, **kw) -> JaxEngine:
    kw.setdefault("n_slots", 4)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("sampling", JaxSampling(greedy=True))
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("page_size", PAGE)
    return JaxEngine(jcfg, params, kv_layout="paged", **kw)


def outcome(h):
    return h.status, h.retryable, len(h.tokens)


def mirror(pair, scenario, keys):
    """Run ``scenario(build, ServeFault, ServingChaosMonkey)`` with JAX's
    engine and then the port's (``build(**engine_kwargs)`` makes one;
    the fault classes are each side's own) and assert equal request
    outcomes (status, retryable, tokens emitted), equal ``stats`` under
    ``keys`` and equal lifecycle states. Returns the port's engine and
    handles."""
    jcfg, params, model = pair
    out = []
    for build, fault, chaos in ((lambda **a: jax_engine(jcfg, params, **a), JaxFault, JaxChaos),
                                (lambda **a: port_engine(model, **a), ServeFault, ServingChaosMonkey)):
        out.append(scenario(build, fault, chaos))
    (jeng, jh), (teng, th) = out
    assert [outcome(h) for h in th] == [outcome(h) for h in jh]
    assert {k: teng.stats[k] for k in keys} == {k: jeng.stats[k] for k in keys}
    assert teng.lifecycle.state == jeng.lifecycle.state
    return teng, th


def reference(model, prompt, max_new=8):
    """An undisturbed port engine's greedy stream for ``prompt``."""
    eng = port_engine(model, n_slots=1)
    h = eng.submit(prompt, max_new_tokens=max_new)
    eng.run_until_idle()
    return h.tokens


def assert_gaps(model, prompt, tokens, what: str = "") -> None:
    """Every greedy step of ``tokens`` after ``prompt`` has a top-1/top-2
    logit gap of at least ``MIN_GAP`` under the full forward: a tie would
    make greedy decoding ill-posed rather than wrong."""
    seq = list(prompt) + list(tokens)
    with torch.no_grad():
        logits = model(torch.tensor([seq]))[0].float()
    for i in range(len(tokens)):
        top2 = torch.topk(logits[len(prompt) - 1 + i], 2).values
        gap = float(top2[0] - top2[1])
        assert gap >= MIN_GAP, (f"{what}: top-2 logit gap {gap:.2e} < {MIN_GAP} at step {i}; greedy decoding is a "
                                "tie here, pick other inputs")


class FakeClock:
    """An injected engine clock: time moves only when a test moves it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class ByteTokenizer:
    eos_token_id = None

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids, **kw):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def wait_for(pred, timeout: float = 60.0, msg: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def http_call(port: int, method: str, path: str, body=None, headers=None, timeout: float = 60.0):
    """(status, headers dict, body bytes) of one request to 127.0.0.1:port."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
        conn.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def sse_events(raw: bytes):
    return [json.loads(line[len(b"data: "):]) for line in raw.splitlines() if line.startswith(b"data: ")]
