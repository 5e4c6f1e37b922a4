"""PyTorch port vs JAX reference: the model, the param converter and the
paged decode path, in float32 on the CPU.

- ``params_from_jax`` + the port's ``Transformer`` logits against JAX
  ``Transformer.apply`` (atol 1e-4), for the ``test`` zoo model and a shallow
  config at ``125m``'s full width (d768, 12 heads, 2 layers, small vocab),
  with scan-stacked and unscanned JAX param layouts;
- a paged prefill chunk plus four decode steps through ``forward_paged``
  against the JAX paged decode model driven with the same block tables and
  per-row cursors (atol 1e-4);
- the ``.npz`` round trip ``serve --params`` reads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.inference.generate import decode_model, init_cache
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.serving.slots import INDEX_LEAVES, TABLE_LEAF, _leaf_name, vectorize_index
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.convert import load_npz, params_from_jax
from zero_transformer_tpu_torch.inference.generate import allocate_pools
from zero_transformer_tpu_torch.models.gpt import Transformer

ATOL = 1e-4
SHAPES = {
    "test": dict(),
    "125m_width": dict(n_layers=2, vocab_size=512),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _configs(name, **extra):
    zoo = "test" if name == "test" else "125m"
    over = dict(SHAPES[name], dropout=0.0, compute_dtype="float32", **extra)
    port_over = {k: v for k, v in over.items() if k != "scan_layers"}
    return jax_model_config(zoo, **over), model_config(zoo, **port_over)


def _jax_params(jcfg, seed=0):
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, unbox(params))


def _port_model(tcfg, tree):
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_logits_match_jax(name, scan):
    jcfg, tcfg = _configs(name, scan_layers=scan)
    tree = _jax_params(jcfg)
    assert ("blocks" in tree) == scan
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    want = np.asarray(JaxTransformer(jcfg).apply({"params": tree}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port_model(tcfg, tree)(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _set_cache(cache, table, index):
    def one(path, leaf):
        name = _leaf_name(path)
        if name == TABLE_LEAF:
            return jnp.broadcast_to(jnp.asarray(table), leaf.shape).astype(leaf.dtype)
        if name in INDEX_LEAVES:
            return jnp.broadcast_to(jnp.asarray(index), leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(one, cache)


@pytest.mark.parametrize("name", list(SHAPES))
def test_paged_prefill_and_decode_match_jax(name):
    jcfg, tcfg = _configs(name)
    tree = _jax_params(jcfg, seed=2)
    model = _port_model(tcfg, tree)
    page, cache_len, chunk = 8, 48, 16
    n_blocks = cache_len // page
    n_pages = 2 * n_blocks + 1
    # ragged tables: row 0 maps three pages, row 1 two, in scattered order;
    # the rest stays on the trash page 0
    table = np.zeros((2, n_blocks), np.int32)
    table[0, :3] = [5, 1, 9]
    table[1, :2] = [2, 11]
    prompt_lens = [16, 11]  # row 1's window is padded past its prompt
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, size=(2, chunk)).astype(np.int32)
    tokens[1, prompt_lens[1]:] = 0

    jmodel = decode_model(dataclasses.replace(jcfg, scan_layers=True), cache_len, kv_pages=(n_pages, page))
    jcache = _set_cache(vectorize_index(init_cache(jmodel, 2), 2), table, np.zeros(2, np.int32))
    pools = allocate_pools(tcfg, n_pages, page, "cpu")
    t_table = torch.from_numpy(table)

    def jax_step(cache, toks, index):
        cache = _set_cache(cache, table, np.asarray(index, np.int32))
        logits, out = jmodel.apply({"params": tree, "cache": cache}, jnp.asarray(toks), mutable=["cache"])
        return np.asarray(logits), out["cache"]

    def port_step(toks, index):
        with torch.no_grad():
            h = model.forward_paged(torch.from_numpy(toks).long(), pools, t_table,
                                    torch.tensor(index, dtype=torch.int32))
            return model.logits(h).numpy()

    want, jcache = jax_step(jcache, tokens, [0, 0])
    got = port_step(tokens, [0, 0])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    cursors = list(prompt_lens)
    last = [want[0, prompt_lens[0] - 1], want[1, prompt_lens[1] - 1]]
    for _ in range(4):
        nxt = np.array([[int(np.argmax(r))] for r in last], np.int32)
        want, jcache = jax_step(jcache, nxt, cursors)
        got = port_step(nxt, cursors)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        last = [want[0, 0], want[1, 0]]
        cursors = [c + 1 for c in cursors]


def test_npz_round_trip(tmp_path):
    jcfg, tcfg = _configs("test", scan_layers=True)
    tree = _jax_params(jcfg)
    from flax.traverse_util import flatten_dict

    path = tmp_path / "p.npz"
    np.savez(path, **flatten_dict(tree, sep="/"))
    direct, loaded = params_from_jax(tree), load_npz(str(path))
    assert set(direct) == set(loaded) == set(Transformer(tcfg).state_dict())
    assert all(torch.equal(direct[k], loaded[k]) for k in direct)
