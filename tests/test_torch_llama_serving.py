"""PyTorch port vs JAX reference: the Llama block and learned positions on
the paged decode path and in the serving engine, on the CPU.

- a paged prefill chunk and four decode steps through ``forward_paged``
  against the JAX paged decode model driven with the same block tables and
  per-row cursors: ``llama3_test`` in float32 (atol 1e-4) with the
  compute-dtype cache and with the int8 cache (RoPE before the write: the
  cache holds rotated keys, quantized), in bfloat16 (atol/rtol 2e-2), and
  a learned-position model (each row's own positions, JAX's per-slot
  ``decode_pos``);
- greedy engine streams token-identical to the JAX ``ServingEngine``
  (paged KV, chunked prefill) for ``llama3_test`` with the compute-dtype
  and the int8 cache, with int8 weights (the untied head and the gate
  quantized) and an int8 cache, and for the learned-position model (both
  engines refuse a request that would run past its position table); every
  compared step first asserts a top-1/top-2 logit gap of at least 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _set_cache
from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference.generate import decode_model, init_cache
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.quant import quantize_params as j_quantize_params
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu.serving.slots import vectorize_index
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.inference.generate import allocate_pools
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.models.quant import quantize_params
from zero_transformer_tpu_torch.serving import ServingEngine

CASES = {  # name: (zoo, overrides, logits bar)
    "llama3_test": ("llama3_test", dict(compute_dtype="float32"), dict(atol=1e-4, rtol=0)),
    "llama3_test_int8_kv": ("llama3_test", dict(compute_dtype="float32", kv_cache_dtype="int8"),
                            dict(atol=1e-4, rtol=0)),
    "llama3_test_bf16": ("llama3_test", dict(compute_dtype="bfloat16"), dict(atol=2e-2, rtol=2e-2)),
    "learned": ("test", dict(compute_dtype="float32", position="learned"), dict(atol=1e-4, rtol=0)),
}
CACHE_LEN, CHUNK, PAGE, MAX_NEW = 64, 16, 8, 6
PROMPT_LENS = (7, 16, 17, 33)
LEARNED_LENS = (7, 16, 17, 26)  # prompt + MAX_NEW within the position table (32)
MIN_GAP = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(name, seed=2):
    zoo, over, bar = CASES[name]
    jcfg = jax_model_config(zoo, dropout=0.0, **over)
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, unbox(params))
    model = Transformer(model_config(zoo, dropout=0.0, **over), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, tree, model, bar


@pytest.mark.parametrize("name", list(CASES))
def test_paged_prefill_and_decode_match_jax(name):
    jcfg, tree, model, bar = _setup(name)
    page, cache_len, chunk = 8, 32, 16
    n_blocks = cache_len // page
    n_pages = 2 * n_blocks + 1
    table = np.zeros((2, n_blocks), np.int32)
    table[0, :3] = [5, 1, 7]
    table[1, :2] = [2, 8]
    prompt_lens = [16, 11]  # row 1's window is padded past its prompt
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, size=(2, chunk)).astype(np.int32)
    tokens[1, prompt_lens[1]:] = 0
    jmodel = decode_model(dataclasses.replace(jcfg, scan_layers=True), cache_len, kv_pages=(n_pages, page))
    jcache = _set_cache(vectorize_index(init_cache(jmodel, 2), 2), table, np.zeros(2, np.int32))
    pools = allocate_pools(model.cfg, n_pages, page, "cpu")
    t_table = torch.from_numpy(table)

    def jax_step(cache, toks, index):
        cache = _set_cache(cache, table, np.asarray(index, np.int32))
        logits, out = jmodel.apply({"params": tree, "cache": cache}, jnp.asarray(toks), mutable=["cache"])
        return np.asarray(logits.astype(jnp.float32)), out["cache"]

    def port_step(toks, index):
        with torch.no_grad():
            h = model.forward_paged(torch.from_numpy(toks).long(), pools, t_table,
                                    torch.tensor(index, dtype=torch.int32))
            return model.logits(h).float().numpy()

    want, jcache = jax_step(jcache, tokens, [0, 0])
    np.testing.assert_allclose(port_step(tokens, [0, 0]), want, **bar)
    cursors = list(prompt_lens)
    last = [want[0, prompt_lens[0] - 1], want[1, prompt_lens[1] - 1]]
    for _ in range(4):
        nxt = np.array([[int(np.argmax(r))] for r in last], np.int32)
        want, jcache = jax_step(jcache, nxt, cursors)
        np.testing.assert_allclose(port_step(nxt, cursors), want, **bar)
        last = [want[0, 0], want[1, 0]]
        cursors = [c + 1 for c in cursors]


STREAMS = {  # name: (case, int8 weights)
    "llama3_test": ("llama3_test", False),
    "llama3_test_int8_kv": ("llama3_test_int8_kv", False),
    "llama3_test_int8_weights_and_kv": ("llama3_test_int8_kv", True),
    "learned": ("learned", False),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_engine_streams_match_jax(name):
    case, int8_weights = STREAMS[name]
    jcfg, tree, model, _ = _setup(case, seed=0)
    params = jax.tree.map(jnp.asarray, tree)
    if int8_weights:
        params = jax.tree.map(jnp.asarray, j_quantize_params(tree))
        jcfg = dataclasses.replace(jcfg, param_quant="int8")
        model = Transformer(dataclasses.replace(model.cfg, param_quant="int8"), device="cpu")
        model.load_state_dict(params_from_jax(quantize_params(tree)))
        assert model.lm_head.weight_q.dtype == torch.int8 and model.blocks[0].mlp.gate.weight_q.dtype == torch.int8
    lens = LEARNED_LENS if model.cfg.position == "learned" else PROMPT_LENS
    prompts = [[(5 + 7 * n + 3 * i) % 250 + 1 for i in range(n)] for n in lens]
    jeng = JaxEngine(jcfg, params, n_slots=4, cache_len=CACHE_LEN, sampling=JaxSampling(greedy=True),
                     prefill_chunk=CHUNK, kv_layout="paged", page_size=PAGE)
    jh = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    jeng.run_until_idle()
    teng = ServingEngine(model, n_slots=4, cache_len=CACHE_LEN, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, device="cpu")
    th = [teng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    teng.run_until_idle()
    for p, a, b in zip(prompts, jh, th):
        assert a.status == b.status == "done"
        with torch.no_grad():
            logits = model(torch.tensor([list(p) + list(b.tokens)]))[0].float()
        for i in range(len(b.tokens)):
            top2 = torch.topk(logits[len(p) - 1 + i], 2).values
            gap = float(top2[0] - top2[1])
            assert gap >= MIN_GAP, f"prompt of {len(p)}: top-2 gap {gap:.2e} at step {i}: a tie, pick other inputs"
        assert list(a.tokens) == list(b.tokens), f"prompt of {len(p)}: JAX {a.tokens} != port {b.tokens}"
    snap = teng.metrics_snapshot()
    assert snap["completed"] == len(prompts) and snap["tokens_out"] == MAX_NEW * len(prompts)
    if model.cfg.position == "learned":
        too_long = [1] * (model.cfg.max_seq_len - MAX_NEW + 1)
        assert jeng.submit(too_long, max_new_tokens=MAX_NEW).status == "rejected"
        assert teng.submit(too_long, max_new_tokens=MAX_NEW).status == "rejected"
