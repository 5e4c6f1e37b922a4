"""PyTorch port vs JAX reference: ``inference.generate`` over the slab cache,
on the CPU in float32. Same params (``convert.params_from_jax``), same
prompts, each bar stated where it is checked:

- ``prefill``'s last-position logits against JAX ``prefill`` within 1e-5
  (1e-4 over an int8 cache, where an element float32 rounding moves
  across an int8 rounding edge moves a whole step), and the slab the port's page view wrote equal to JAX's ``cached_key`` /
  ``cached_value`` within 1e-5 (int8: values within one step, at most 1 %
  of them off by one, scales within 1e-5 relative: K/V that agree to
  float32 rounding can round to neighbouring int8 steps);
- greedy ``generate`` tokens equal to JAX ``generate``'s, with EOS, pad and
  the early exit, for the GPT/ALiBi ``test`` model, ``llama3_test`` (RoPE,
  GQA, RMSNorm, SwiGLU, untied head) and a learned-position model, each
  with ``kv_cache_dtype`` auto and int8 and ``param_quant`` none and int8,
  at a ``cache_len`` (45) that whole pages do not fill;
- sampled ``generate`` (temperature, top-k, top-p, repetition penalty) fed
  numpy uniforms: tokens equal to a step loop over JAX's own prefill and
  decode-model logits that samples with the same uniforms (JAX's threefry
  draws have no torch counterpart);
- ``stream_tokens`` token for token equal to ``generate``, greedy and
  sampled with one seed; ``generate_tokens`` equal to JAX's;
- a write past the requested ``cache_len`` poisons the row (NaN logits),
  one that ends at it does not, though the slab is rounded up to pages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference import generate_tokens as jax_generate_tokens
from zero_transformer_tpu.inference.generate import decode_model as jax_decode
from zero_transformer_tpu.inference.generate import generate as jax_generate
from zero_transformer_tpu.inference.generate import init_cache as jax_init_cache
from zero_transformer_tpu.inference.generate import prefill as jax_prefill
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.inference.sampling import process_logits as jax_process_logits
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.quant import quantize_params as j_quantize_params
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.inference import (SamplingConfig, generate, generate_tokens, init_cache, prefill,
                                                  stream_tokens)
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.models.quant import quantize_params

MODELS = {"gpt": ("test", {}), "llama": ("llama3_test", {}), "learned": ("test", dict(position="learned"))}
QUANT = {"auto-none": ("auto", "none"), "int8kv-none": ("int8", "none"), "auto-int8w": ("auto", "int8"),
         "int8kv-int8w": ("int8", "int8")}
CASES = [(m, q) for m in MODELS for q in QUANT]
CACHE_LEN = 45  # not a multiple of the slab's 16-position pages
B, T, MAX_NEW = 2, 9, 20
PREFILL_ATOL = 1e-5
# an int8 cache written by each package: a K/V element that float32
# rounding moves across an int8 rounding edge moves a whole step (1/127 of
# its row's max), which reaches the logits at ~2e-5 (measured)
PREFILL_ATOL_INT8_KV = 1e-4
# JAX's init (std 0.02) makes the tiny GPT repeat one token per row; four
# times the weights make every row's greedy tokens vary
WEIGHT_SCALE = 4.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_pair(zoo: str, kv: str = "auto", weights: str = "none", seed: int = 0, scale: float = None, **over):
    """(JAX cfg, JAX params, port model) with the same weights, float32:
    JAX's init with every matrix scaled by ``scale`` (``WEIGHT_SCALE``)."""
    scale = WEIGHT_SCALE if scale is None else scale
    over = dict(dropout=0.0, compute_dtype="float32", kv_cache_dtype=kv, param_quant=weights, **over)
    jcfg = jax_model_config(zoo, **over)
    float_cfg = dataclasses.replace(jcfg, param_quant="none")
    params = JaxTransformer(float_cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1), unbox(params))
    params = jax.tree.map(jnp.asarray, tree)
    if weights == "int8":
        params = jax.tree.map(jnp.asarray, j_quantize_params(tree))
        tree = quantize_params(tree)
    model = Transformer(model_config(zoo, **over), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return jcfg, params, model


def case_pair(name: str, quant: str, seed: int = 0, scale: float = None):
    zoo, over = MODELS[name]
    kv, weights = QUANT[quant]
    return make_pair(zoo, kv, weights, seed, scale, **over)


def prompts(batch: int = B, length: int = T, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 250, (batch, length))


def jax_decode_model(jcfg, cache_len=CACHE_LEN):
    return jax_decode(jcfg, cache_len)


def _cache_leaves(cache, name, n_layers):
    """Per layer, the JAX cache leaf ``name`` (a scanned stack's [L, ...]
    leaf split into its layers)."""
    leaves = [(jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(cache)
              if getattr(p[-1], "key", None) == name]
    leaves = [np.asarray(v) for _, v in sorted(leaves)]
    return list(leaves[0]) if len(leaves) == 1 and n_layers > 1 else leaves


@pytest.mark.parametrize("name,quant", CASES, ids=[f"{m}-{q}" for m, q in CASES])
def test_prefill_logits_and_slab_match_jax(name, quant):
    jcfg, params, model = case_pair(name, quant)
    x = prompts()
    jm = jax_decode_model(jcfg)
    j_last, j_cache = jax_prefill(jm, params, jnp.asarray(x, jnp.int32),
                                               jax_init_cache(jm, B))
    cache = init_cache(model, B, CACHE_LEN)
    last = prefill(model, torch.tensor(x), cache)
    assert last.dtype == torch.float32 and last.shape == (B, model.cfg.vocab_size)
    bar = PREFILL_ATOL_INT8_KV if model.cfg.kv_cache_dtype == "int8" else PREFILL_ATOL
    np.testing.assert_allclose(last.numpy(), np.asarray(j_last), atol=bar, rtol=0)
    assert cache.index == T
    names = {"k": "cached_key", "v": "cached_value"}
    if model.cfg.kv_cache_dtype == "int8":
        names.update(k_scale="key_scale", v_scale="value_scale")
    for attr, leaf in names.items():
        ref = _cache_leaves(j_cache, leaf, model.cfg.n_layers)
        assert len(ref) == model.cfg.n_layers
        for layer, want in enumerate(ref):
            got = cache.slab(layer, attr).numpy()
            assert got.shape == want.shape, (attr, got.shape, want.shape)
            if got.dtype == np.int8:
                # K/V equal within float32 rounding can land on either side of a rounding edge
                steps = np.abs(got[:, :T].astype(np.int32) - want[:, :T])
                assert steps.max() <= 1 and (steps > 0).mean() < 0.01, f"{leaf} layer {layer}"
            elif attr.endswith("scale"):
                np.testing.assert_allclose(got[:, :T], want[:, :T], rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(got[:, :T], want[:, :T], atol=PREFILL_ATOL, rtol=0)
            assert not got[:, T:].any()


def _jax_greedy(jcfg, params, x, max_new, eos=None, pad=0, sampling=None):
    jm = jax_decode_model(jcfg)
    out = jax_generate(jm, params, jnp.asarray(x, jnp.int32), max_new, jax.random.PRNGKey(0),
                                    sampling or JaxSampling(greedy=True), eos_token_id=eos, pad_token_id=pad)
    return np.asarray(out)


@pytest.mark.parametrize("name,quant", CASES, ids=[f"{m}-{q}" for m, q in CASES])
def test_greedy_generate_matches_jax(name, quant):
    """Tokens equal; then with EOS: the row that emits it pads after it,
    and once both rows are done the loop stops (the rest is pad)."""
    jcfg, params, model = case_pair(name, quant)
    x = prompts(seed=1)
    ref = _jax_greedy(jcfg, params, x, MAX_NEW)
    got = generate(model, torch.tensor(x), MAX_NEW, sampling=SamplingConfig(greedy=True), cache_len=CACHE_LEN)
    assert got.dtype == torch.long and got.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), ref)
    eos = int(ref[0, 3])
    ref_eos = _jax_greedy(jcfg, params, x, MAX_NEW, eos=eos, pad=255)
    got_eos = generate(model, torch.tensor(x), MAX_NEW, sampling=SamplingConfig(greedy=True),
                       eos_token_id=eos, pad_token_id=255, cache_len=CACHE_LEN)
    np.testing.assert_array_equal(got_eos.numpy(), ref_eos)
    assert (got_eos[0, 4:] == 255).all() or eos in ref[0, :3]


def test_greedy_generate_stops_early_once_every_row_is_done():
    """Both rows emit the EOS: the loop runs no forward after the last
    row's EOS (counted), and the output is JAX's."""
    jcfg, params, model = case_pair("gpt", "auto-none")
    x = prompts(seed=1)
    ref = _jax_greedy(jcfg, params, x, MAX_NEW)
    eos = int(ref[0, 2])
    first = [int(np.argmax(row == eos)) if eos in row else MAX_NEW for row in ref]
    assert max(first) < MAX_NEW - 1, f"pick inputs where both rows emit {eos}: {ref}"
    calls = []
    orig = model.forward_paged

    def counting(*a, **k):
        calls.append(a[0].shape[1])
        return orig(*a, **k)

    model.forward_paged = counting
    got = generate(model, torch.tensor(x), MAX_NEW, sampling=SamplingConfig(greedy=True), eos_token_id=eos,
                   pad_token_id=0, cache_len=CACHE_LEN)
    del model.forward_paged
    np.testing.assert_array_equal(got.numpy(), _jax_greedy(jcfg, params, x, MAX_NEW, eos=eos, pad=0))
    assert calls == [T] + [1] * max(first), calls


SAMPLED = [
    dict(temperature=0.7, top_k=20, top_p=0.9, repetition_penalty=1.3),
    dict(temperature=1.3, top_k=0, top_p=0.0, repetition_penalty=1.0),
    dict(temperature=0.9, top_k=5, top_p=0.0, repetition_penalty=0.8),
]


def _gumbel_token(processed: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The port's categorical rule (``sampling.draw``) on numpy: argmax of
    the processed logits minus log(-log(u))."""
    u = np.clip(u, np.finfo(np.float32).tiny, 1.0 - 2.0**-24).astype(np.float32)
    return np.argmax(processed - np.log(-np.log(u)), axis=-1)


def _jax_sampled_loop(jcfg, params, x, max_new, jsampling, uniforms, eos=None):
    """JAX's prefill, then its decode model step by step, sampling each
    step's processed logits with the given uniforms (``generate``'s
    carry: the penalty mask of generated tokens of rows not yet done, pad
    after EOS)."""
    jm = jax_decode_model(jcfg)
    logits, cache = jax_prefill(jm, params, jnp.asarray(x, jnp.int32),
                                             jax_init_cache(jm, x.shape[0]))
    V = logits.shape[-1]
    gen_mask = np.zeros((x.shape[0], V), bool)
    done = np.zeros(x.shape[0], bool)
    out = np.zeros((x.shape[0], max_new), np.int64)
    for step in range(max_new):
        proc = np.asarray(jax_process_logits(logits, jsampling, jnp.asarray(gen_mask)))
        token = _gumbel_token(proc, uniforms[step])
        out[:, step] = np.where(done, 0, token)
        gen_mask[np.arange(len(token)), token] |= ~done
        if eos is not None:
            done |= token == eos
        step_logits, vars_out = jm.apply({"params": params, "cache": cache}, jnp.asarray(token[:, None], jnp.int32),
                                         mutable=["cache"])
        logits, cache = step_logits[:, -1].astype(jnp.float32), vars_out["cache"]
    return out


@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("cfg", range(len(SAMPLED)), ids=["topk_topp_pen1.3", "temp1.3", "topk_pen0.8"])
def test_sampled_generate_matches_jax_logits_with_injected_uniforms(name, cfg):
    jcfg, params, model = case_pair(name, "auto-none")
    x = prompts(seed=2)
    V = model.cfg.vocab_size
    uniforms = np.random.default_rng(10 + cfg).random((MAX_NEW, B, V)).astype(np.float32)
    ref = _jax_sampled_loop(jcfg, params, x, MAX_NEW, JaxSampling(**SAMPLED[cfg]), uniforms)
    got = generate(model, torch.tensor(x), MAX_NEW, sampling=SamplingConfig(**SAMPLED[cfg]), cache_len=CACHE_LEN,
                   uniforms=torch.from_numpy(uniforms))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(got.flatten().tolist())) > 2  # the draws reach more than a couple of tokens


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_stream_tokens_equal_generate(sampled):
    _, _, model = case_pair("llama", "auto-none")
    x = torch.tensor(prompts(seed=3))
    sampling = SamplingConfig(**SAMPLED[0]) if sampled else SamplingConfig(greedy=True)
    out = generate(model, x, MAX_NEW, torch.Generator().manual_seed(5), sampling, cache_len=CACHE_LEN)
    streamed = list(stream_tokens(model, x, MAX_NEW, torch.Generator().manual_seed(5), sampling,
                                  cache_len=CACHE_LEN))
    assert len(streamed) == MAX_NEW and all(t.shape == (B,) for t in streamed)
    assert torch.equal(torch.stack(streamed, dim=1), out)
    if sampled:  # another seed draws another sequence
        other = generate(model, x, MAX_NEW, torch.Generator().manual_seed(6), sampling, cache_len=CACHE_LEN)
        assert not torch.equal(other, out)


def test_stream_tokens_stop_when_every_row_is_done():
    jcfg, params, model = case_pair("gpt", "auto-none")
    x = prompts(seed=1)
    ref = _jax_greedy(jcfg, params, x, MAX_NEW)
    eos = int(ref[0, 2])
    streamed = torch.stack(list(stream_tokens(model, torch.tensor(x), MAX_NEW, sampling=SamplingConfig(greedy=True),
                                              eos_token_id=eos, cache_len=CACHE_LEN)), dim=1).numpy()
    last = max(int(np.argmax(row == eos)) for row in ref)
    assert streamed.shape[1] == last + 1
    np.testing.assert_array_equal(streamed, ref[:, :last + 1])


def test_generate_tokens_matches_jax():
    """A 1-D prompt and the default cache (max(max_seq_len, prompt + new))."""
    jcfg, params, model = case_pair("llama", "auto-none")
    x = prompts(1, 20, seed=4)[0]
    ref = jax_generate_tokens(jcfg, params, jnp.asarray(x, jnp.int32), 25,
                                           sampling=JaxSampling(greedy=True))
    got = generate_tokens(model, torch.tensor(x), 25, sampling=SamplingConfig(greedy=True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_write_past_cache_len_poisons_the_row():
    """The slab holds whole pages (48 positions for 45), but a window that
    ends past position 45 poisons its row; one that ends at it does not."""
    _, _, model = case_pair("gpt", "auto-none")
    x = torch.tensor(prompts(1, 40, seed=5))
    for extra, poisoned in ((5, False), (6, True)):
        cache = init_cache(model, 1, CACHE_LEN)
        assert cache.pools[0].k.shape[0] * cache.pools[0].k.shape[1] == 48
        prefill(model, x, cache)
        with torch.no_grad():
            h = cache.forward(model, torch.ones(1, extra, dtype=torch.long))
        assert bool(torch.isnan(h).any()) == poisoned, extra
