"""PyTorch port vs JAX reference: the chunked cross entropy (``loss_chunk``).

- ``chunked_next_token_loss`` against JAX ``ops/losses.chunked_next_token_loss``
  on the same numpy inputs in float32: the loss and its grads in the hidden
  states and in the head, within 1e-6 (absolute), at chunks of 1, 4, 5, 16
  and more than T (T - 1 = 12 positions, so 5 and 16 leave a padded last
  tile), with ``ignore_index`` -1 labels and with ``z_loss``;
- its ``(sum, count)`` core against the port's unchunked
  ``cross_entropy_sum`` (1e-6), and no allocation of the forward and
  backward larger than about one ``[B, chunk, vocab]`` float32 tile (the
  unchunked loss allocates the whole ``[B, T, vocab]``);
- ``token_log_likelihood`` against JAX's (1e-6, greedy flags equal);
- the ``test`` model (float32, dropout 0) with ``loss_chunk``: its
  ``(None, loss)`` and every param's grad against JAX ``model.apply``
  with the same chunk, plain and packed (``doc_sep_token`` 0), loss within
  1e-6 and grads within 1e-6; a call without labels still returns logits;
- the sequence-parallel shard path (2 gloo ranks) with ``loss_chunk``
  against the port's unchunked shard path: each rank's loss share and
  grads within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.ops import losses as jlosses
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.ops import losses as tlosses

ATOL = 1e-6
B, T, D, V = 2, 13, 16, 40


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(ignore: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    if ignore:
        tokens[0, 3] = tokens[1, 7] = tokens[1, 12] = -1
    return h, w, tokens


@pytest.mark.parametrize("z_loss", [0.0, 1e-3], ids=["plain", "z_loss"])
@pytest.mark.parametrize("ignore", [False, True], ids=["all_labels", "ignore_minus1"])
@pytest.mark.parametrize("chunk", [1, 4, 5, 16, 40])
def test_chunked_loss_matches_jax(chunk, ignore, z_loss):
    h, w, tokens = _inputs(ignore)
    ignore_index = -1 if ignore else None

    def jax_loss(h_, w_):
        return jlosses.chunked_next_token_loss(h_, w_, jnp.asarray(tokens), chunk, ignore_index, z_loss)

    want, (want_dh, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    loss = tlosses.chunked_next_token_loss(ht, wt, torch.from_numpy(tokens), chunk, ignore_index, z_loss)
    dh, dw = torch.autograd.grad(loss, (ht, wt))
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [3, 8])
def test_chunked_sum_matches_cross_entropy_sum(chunk):
    h, w, tokens = _inputs(True, seed=1)
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    labels = torch.from_numpy(tokens)
    total, count = tlosses.chunked_cross_entropy_sum(ht, wt, labels, chunk, ignore_index=-1)
    got = torch.autograd.grad(total, (ht, wt))
    ref_total, ref_count = tlosses.cross_entropy_sum(ht @ wt, labels, ignore_index=-1)
    want = torch.autograd.grad(ref_total, (ht, wt))
    assert count.item() == ref_count.item() == B * T - 3
    np.testing.assert_allclose(total.item(), ref_total.item(), atol=ATOL * 10, rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def _largest_allocation(fn) -> int:
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn().backward()
    return max(e.cpu_memory_usage for e in prof.events())


def test_chunked_loss_never_allocates_the_full_logits():
    """The largest single allocation of the chunked loss's forward and
    backward is about one [B, chunk, vocab] float32 tile; the unchunked
    loss allocates the [B, T, vocab] logits."""
    Bm, Tm, Vm, chunk = 2, 64, 1000, 8
    h = torch.randn(Bm, Tm, D, requires_grad=True)
    w = torch.randn(D, Vm, requires_grad=True)
    tokens = torch.randint(0, Vm, (Bm, Tm))
    tile, full = Bm * chunk * Vm * 4, Bm * Tm * Vm * 4
    chunked = _largest_allocation(lambda: tlosses.chunked_next_token_loss(h, w, tokens, chunk))
    whole = _largest_allocation(lambda: tlosses.next_token_loss(h @ w, tokens))
    assert whole >= full
    assert chunked <= 1.25 * tile < full / 4


def test_token_log_likelihood_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, T, V)).astype(np.float32)
    tokens = rng.integers(0, V, (3, T)).astype(np.int32)
    tokens[:, 5] = np.argmax(logits[:, 4], axis=-1)  # some greedy hits
    ll, greedy = jlosses.token_log_likelihood(jnp.asarray(logits), jnp.asarray(tokens))
    t_ll, t_greedy = tlosses.token_log_likelihood(torch.from_numpy(logits), torch.from_numpy(tokens))
    assert t_ll.shape == (3, T - 1) and t_ll.dtype == torch.float32
    np.testing.assert_allclose(t_ll.numpy(), np.asarray(ll), atol=ATOL, rtol=0)
    assert np.array_equal(t_greedy.numpy(), np.asarray(greedy)) and t_greedy[:, 4].all()


def _jax_model_params(cfg_kw):
    jmodel = JaxTransformer(jconfig.model_config("test", **cfg_kw))
    params = unbox(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    return jmodel, params


def _tokens(packed: bool, seed: int = 4):
    tokens = np.random.default_rng(seed).integers(1, 256, (4, 16)).astype(np.int32)
    if packed:
        tokens[0, 5] = tokens[1, 0] = tokens[2, 9] = tokens[2, 11] = tokens[3, 15] = 0
    return tokens


@pytest.mark.parametrize("chunk", [4, 7])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_model_loss_chunk_matches_jax(packed, chunk):
    cfg_kw = dict(dropout=0.0, compute_dtype="float32", loss_chunk=chunk,
                  doc_sep_token=0 if packed else None)
    jmodel, params = _jax_model_params(cfg_kw)
    tokens = _tokens(packed)

    def loss_fn(p):
        out, loss = jmodel.apply({"params": p}, jnp.asarray(tokens), labels=jnp.asarray(tokens), train=True)
        assert out is None
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(params)
    model = Transformer(tconfig.model_config("test", **cfg_kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.requires_grad_(True)
    t = torch.from_numpy(tokens)
    logits, t_loss = model(t, labels=t, train=True)
    assert logits is None
    names = [n for n, _ in model.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(t_loss.item(), float(loss), atol=ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    for n, g in zip(names, t_grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)
    # a call without labels still returns the logits (the eval harness reads them)
    with torch.no_grad():
        full = model(t)
    assert full.shape == (4, 16, 256)
    np.testing.assert_allclose(np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens))), full.numpy(),
                               atol=1e-5, rtol=0)


def test_shard_path_with_loss_chunk_matches_unchunked(tmp_path):
    """Two sequence ranks: each rank's share of the global mean and its
    grads, with and without ``loss_chunk`` (chunk 3 over 8-position shards),
    plain and packed."""
    _, params = _jax_model_params(dict(dropout=0.0, compute_dtype="float32"))
    payload = {"params": {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, params)).items()},
               "tokens": {"plain": _tokens(False), "packed": _tokens(True)}, "chunk": 3}
    ranks = _torch_dist.run_world("shard_loss_cases", payload, tmp_path, world=2)
    for r in ranks:
        for case in ("plain", "packed"):
            chunked, whole = r[case]
            assert chunked["logits"] is None and whole["logits"] == (4, 8, 256)
            np.testing.assert_allclose(chunked["loss"], whole["loss"], atol=ATOL, rtol=0)
            for n, g in whole["grads"].items():
                np.testing.assert_allclose(chunked["grads"][n], g, atol=ATOL, rtol=0, err_msg=f"{case} {n}")
    for case in ("plain", "packed"):  # the shares sum to the one-process mean
        total = sum(r[case][0]["loss"] for r in ranks)
        model = Transformer(tconfig.model_config("test", dropout=0.0, compute_dtype="float32",
                                                 doc_sep_token=0 if case == "packed" else None), device="cpu")
        model.load_state_dict({n: torch.from_numpy(p) for n, p in payload["params"].items()})
        t = torch.from_numpy(payload["tokens"][case])
        with torch.no_grad():
            np.testing.assert_allclose(total, model(t, labels=t)[1].item(), atol=ATOL, rtol=0)
