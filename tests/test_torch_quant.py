"""PyTorch port vs JAX reference: weight-only int8 and the int8 KV cache, on
the CPU.

- ``_quantize_kv`` (values and scales) and ``quantize_params`` (scanned and
  unscanned ``test`` trees) are bit-equal to JAX's; ``quantize_model``
  gives a model whose state is ``quantize_params`` followed by the
  converter.
- The quant model's logits are within 1e-4 of JAX ``Transformer`` with
  ``param_quant="int8"`` in float32, and its perplexity keeps JAX's 2 %
  budget over full precision.
- A paged prefill chunk plus four decode steps over an int8 KV cache (and
  int8 weights) are within 1e-4 of the JAX paged decode model.
- A quant model refuses labels and training; the serve CLI refuses an
  already-quantized ``.npz`` without ``--quantize int8``; ``ModelConfig``
  validates both fields as JAX does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from zero_transformer_tpu.config import ModelConfig as JaxModelConfig
from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference.generate import decode_model, init_cache
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.gpt import _quantize_kv as j_quantize_kv
from zero_transformer_tpu.models.quant import quantize_params as j_quantize_params
from zero_transformer_tpu.ops.losses import next_token_loss as j_next_token_loss
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.serving.slots import INDEX_LEAVES, TABLE_LEAF, _leaf_name, vectorize_index
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch import serve
from zero_transformer_tpu_torch.convert import load_npz, params_from_jax, params_to_jax
from zero_transformer_tpu_torch.inference.generate import allocate_pools
from zero_transformer_tpu_torch.models.gpt import Transformer, _quantize_kv
from zero_transformer_tpu_torch.models.quant import quantize_model, quantize_params
from zero_transformer_tpu_torch.ops.losses import next_token_loss
from zero_transformer_tpu_torch.training.trainer import build_training

ATOL = 1e-4
MODEL = dict(dropout=0.0, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_tree(jcfg, seed=0):
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, unbox(params))


def _kv_rows(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return (rng.standard_normal((3, 5, 4, 16)) * rng.uniform(1e-3, 20, (3, 5, 4, 1))).astype(np.float32)
    if kind == "zeros":
        x = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
        x[0, 1] = 0.0  # every head of one position
        x[1, :, 1] = 0.0  # one head of every position
        return x
    # exact .5 ties: amax 127 gives scale 1, so x / scale lands on the halves
    row = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 0.0, 4.5, -4.5, 5.5, 6.5, 7.5],
                   np.float32)
    return np.stack([row, -row, row * 0.5])[:, None, None, :].repeat(2, axis=2)


@pytest.mark.parametrize("kind", ["random", "zeros", "ties"])
def test_quantize_kv_bit_equal(kind):
    x = _kv_rows(kind)
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = _quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    if kind == "ties":
        # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
        np.testing.assert_array_equal(tq.numpy()[0, 0, 0, :8], [127, 0, 2, 2, 0, -2, -2, 4])


def _assert_trees_equal(got, want):
    if not any("/" in k for k in got):
        got = flatten_dict(got, sep="/")
    if not any("/" in k for k in want):
        want = flatten_dict(want, sep="/")
    assert set(got) == set(want)
    for k in want:
        a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
def test_quantize_params_bit_equal(scan):
    tree = _jax_tree(jax_model_config("test", scan_layers=scan, **MODEL))
    want = j_quantize_params(tree)
    got = quantize_params(tree)
    _assert_trees_equal(got, want)
    # the /-flat form of an .npz converts to the same leaves
    flat = quantize_params(flatten_dict(tree, sep="/"))
    assert set(flat) == set(flatten_dict(want, sep="/"))
    # an already-quantized tree passes through unchanged
    _assert_trees_equal(quantize_params(got), want)


def test_quantize_model_equals_converter():
    tree = _jax_tree(jax_model_config("test", **MODEL), seed=3)
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    model = quantize_model(model)
    assert model.cfg.param_quant == "int8" and all(b.attn.cfg.param_quant == "int8" for b in model.blocks)
    want = params_from_jax(quantize_params(tree))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the same state loads into a model built quantized
    fresh = Transformer(tconfig.model_config("test", param_quant="int8", **MODEL), device="cpu")
    fresh.load_state_dict(want)


@pytest.mark.parametrize("name", ["test", "byte_2m"])
def test_quant_logits_match_jax(name):
    jcfg = jax_model_config(name, **MODEL)
    tree = _jax_tree(jcfg, seed=1)
    qtree = j_quantize_params(tree)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    want = np.asarray(JaxTransformer(dataclasses.replace(jcfg, param_quant="int8")).apply(
        {"params": qtree}, jnp.asarray(tokens)))
    model = Transformer(tconfig.model_config(name, param_quant="int8", **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(quantize_params(tree)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
        cast = model.cast_for_inference()(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(cast, got)


def test_quant_perplexity_budget():
    """The port's ``test_quant_perplexity_budget``: int8 weights cost at most
    2 % of perplexity over full precision on the same tokens, and the port's
    two perplexities sit within 1e-4 of JAX's."""
    jcfg = jax_model_config("test", **MODEL)
    tree = _jax_tree(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    full = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    full.load_state_dict(params_from_jax(tree))
    quant = Transformer(tconfig.model_config("test", param_quant="int8", **MODEL), device="cpu")
    quant.load_state_dict(params_from_jax(quantize_params(tree)))
    t_tok, t_lab = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    with torch.no_grad():
        ppl_fp = float(torch.exp(next_token_loss(full(t_tok), t_lab)))
        ppl_q = float(torch.exp(next_token_loss(quant(t_tok), t_lab)))
    assert ppl_q <= ppl_fp * 1.02, (ppl_q, ppl_fp)
    j_q = JaxTransformer(dataclasses.replace(jcfg, param_quant="int8")).apply(
        {"params": j_quantize_params(tree)}, jnp.asarray(tokens))
    j_ppl_q = float(jnp.exp(j_next_token_loss(j_q, jnp.asarray(labels))))
    np.testing.assert_allclose(ppl_q, j_ppl_q, rtol=1e-4)


def test_quant_model_refuses_labels_training_and_init():
    cfg = tconfig.model_config("test", param_quant="int8", **MODEL)
    model = Transformer(cfg, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="inference configuration"):
        model(tokens, labels=tokens)
    with pytest.raises(ValueError, match="quantize_model"):
        model.init_weights(torch.Generator().manual_seed(0))
    train_cfg = dataclasses.replace(tconfig.Config(), model=cfg)
    with pytest.raises(ValueError, match="inference-only"):
        build_training(train_cfg, "cpu")


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_params_to_jax_inverts_the_converter(quant):
    tree = _jax_tree(jax_model_config("test", **MODEL), seed=2)
    if quant == "int8":
        tree = j_quantize_params(tree)
    flat = params_to_jax(params_from_jax(tree))
    _assert_trees_equal(flat, flatten_dict(tree, sep="/"))


def _npz(path, tree):
    np.savez(path, **flatten_dict(tree, sep="/"))
    return str(path)


def test_serve_refuses_prequantized_npz_without_flag(tmp_path):
    tree = _jax_tree(jax_model_config("test", **MODEL))
    qpath = _npz(tmp_path / "q.npz", j_quantize_params(tree))
    base = ["--model", "test", "--server", "--device", "cpu", "--dtype", "float32"]
    with pytest.raises(SystemExit, match="already int8-quantized"):
        serve.main([*base, "--params", qpath])
    # int8 leaves stay int8 through the .npz; with the flag it loads
    loaded = load_npz(qpath)
    assert loaded["blocks.0.attn.query.weight_q"].dtype == torch.int8
    fpath = _npz(tmp_path / "f.npz", tree)
    args = serve.build_parser().parse_args([*base, "--params", fpath, "--quantize", "int8",
                                            "--kv-cache-dtype", "int8", "--cache-len", "32",
                                            "--prefill-chunk", "16", "--page-size", "8"])
    engine, _ = serve.build_engine(args)
    assert engine.cfg.param_quant == "int8" and engine.cfg.kv_cache_dtype == "int8"
    state = engine.model.state_dict()
    for k, v in loaded.items():  # the host-quantized float tree equals the stored int8 one
        assert torch.equal(state[k], v.to(state[k].dtype)), k
    assert all(p.k.dtype == torch.int8 and p.k_scale.dtype == torch.float32 for p in engine.pools)
    args = serve.build_parser().parse_args([*base, "--params", qpath, "--quantize", "int8"])
    serve.build_engine(args)


@pytest.mark.parametrize("field,value", [
    ("kv_cache_dtype", "auto"), ("kv_cache_dtype", "int8"), ("kv_cache_dtype", "fp8"),
    ("param_quant", "none"), ("param_quant", "int8"), ("param_quant", "int4"),
])
def test_config_validation_matches_jax(field, value):
    try:
        JaxModelConfig(**{field: value})
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        assert getattr(tconfig.ModelConfig(**{field: value}), field) == value
    else:
        with pytest.raises(ValueError, match=field):
            tconfig.ModelConfig(**{field: value})


def _set_cache(cache, table, index):
    def one(path, leaf):
        name = _leaf_name(path)
        if name == TABLE_LEAF:
            return jnp.broadcast_to(jnp.asarray(table), leaf.shape).astype(leaf.dtype)
        if name in INDEX_LEAVES:
            return jnp.broadcast_to(jnp.asarray(index), leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(one, cache)


@pytest.mark.parametrize("quant", ["kv", "kv_and_weights"])
def test_paged_int8_cache_matches_jax(quant):
    """A prefill chunk (the dequantized gather path) and four decode steps
    (the paged kernel's plain version over int8 pools)."""
    over = dict(MODEL, kv_cache_dtype="int8", param_quant="int8" if quant == "kv_and_weights" else "none")
    jcfg = jax_model_config("test", **over)
    tree = _jax_tree(jax_model_config("test", **MODEL), seed=4)
    if jcfg.param_quant == "int8":
        tree = j_quantize_params(tree)
    model = Transformer(tconfig.model_config("test", **over), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    page, cache_len, chunk = 8, 48, 16
    n_blocks = cache_len // page
    n_pages = 2 * n_blocks + 1
    table = np.zeros((2, n_blocks), np.int32)
    table[0, :3] = [5, 1, 9]
    table[1, :2] = [2, 11]
    prompt_lens = [16, 11]
    tokens = np.random.default_rng(3).integers(1, jcfg.vocab_size, size=(2, chunk)).astype(np.int32)
    tokens[1, prompt_lens[1]:] = 0
    jmodel = decode_model(jcfg, cache_len, kv_pages=(n_pages, page))
    jcache = _set_cache(vectorize_index(init_cache(jmodel, 2), 2), table, np.zeros(2, np.int32))
    pools = allocate_pools(model.cfg, n_pages, page, "cpu")
    assert pools[0].k.dtype == torch.int8 and tuple(pools[0].k_scale.shape) == (n_pages, page, 4, 1)

    def jax_step(cache, toks, index):
        cache = _set_cache(cache, table, np.asarray(index, np.int32))
        logits, out = jmodel.apply({"params": tree, "cache": cache}, jnp.asarray(toks), mutable=["cache"])
        return np.asarray(logits), out["cache"]

    def port_step(toks, index):
        with torch.no_grad():
            h = model.forward_paged(torch.from_numpy(toks).long(), pools, torch.from_numpy(table),
                                    torch.tensor(index, dtype=torch.int32))
            return model.logits(h).numpy()

    want, jcache = jax_step(jcache, tokens, [0, 0])
    np.testing.assert_allclose(port_step(tokens, [0, 0]), want, atol=ATOL, rtol=0)
    cursors = list(prompt_lens)
    last = [want[0, prompt_lens[0] - 1], want[1, prompt_lens[1] - 1]]
    for _ in range(4):
        nxt = np.array([[int(np.argmax(r))] for r in last], np.int32)
        want, jcache = jax_step(jcache, nxt, cursors)
        np.testing.assert_allclose(port_step(nxt, cursors), want, atol=ATOL, rtol=0)
        last = [want[0, 0], want[1, 0]]
        cursors = [c + 1 for c in cursors]
