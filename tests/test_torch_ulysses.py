"""PyTorch port vs JAX reference: Ulysses sequence parallelism
(``ops/ulysses.py``, ``cp_impl: ulysses``), mirroring ``tests/test_ulysses.py``.

One world of 4 gloo processes (``tests/_torch_dist.py``, its 120 s
deadline) holds every case of the file:

- op level on a sequence group of 4: each rank's shards of q, k, v go
  through the three all-to-alls, one attention call over the whole row
  at its 1 (or 2) heads with those heads' ALiBi slopes, and the all-to-all
  back; the output and the grads of q, k and v (the inverse all-to-all in
  the backward) equal JAX ``ulysses_attention(impl="xla")`` on a
  ``MeshConfig(data=2, sequence=4)`` CPU mesh within 2e-5, with ALiBi, GQA
  (8 query on 4 kv heads), no bias, and packed documents (the ids
  all-gathered);
- the ``test`` model with ``cp_impl: ulysses`` over the 4 ranks: its local
  logits equal the one-rank model's rows;
- the train step over ``data 2 x sequence 2`` at ZeRO 1 and 3, and with
  remat: losses, grad norms and every param after three steps equal the
  ring's within 1e-5.

Single-process cases: the indivisible-heads error (JAX's message) and
the indivisible sequence length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu.config import MeshConfig
from zero_transformer_tpu.ops.ulysses import ulysses_attention as j_ulysses
from zero_transformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.models import model_getter
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.ops.ulysses import ulysses_attention
from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup

WORLD, B, T, D, ATOL = 4, 2, 32, 16, 2e-5
OPS = {  # name: (H, KVH, alibi, docs)
    "mha_alibi": (4, 4, True, False),
    "gqa_alibi": (8, 4, True, False),
    "no_bias": (4, 4, False, False),
    "docs_alibi": (4, 4, True, True),
}
MODEL = dict(dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-3, warmup_steps=2, total_steps=64)
ZERO = {  # name: (cp_impl, stage, remat)
    f"{impl}_stage{stage}{'_remat' if remat else ''}": (impl, stage, remat)
    for impl in ("ulysses", "ring") for stage, remat in ((1, False), (3, False), (1, True))
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _op_inputs(name):
    H, KVH, alibi, docs = OPS[name]
    rng = np.random.default_rng(sorted(OPS).index(name) + 60)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KVH, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ids = None
    if docs:  # documents that cross the shard edges (8 positions a shard)
        ids = np.cumsum(rng.random((B, T)) < 0.15, axis=1).astype(np.int32)
    return dict(q=q, k=k, v=v, g=g, ids=ids, alibi=alibi)


def _tokens():
    return np.random.default_rng(71).integers(0, 256, (B, T)).astype(np.int64)


def _params():
    return {n: t.numpy() for n, t in model_getter("test", device="cpu", seed=0, dropout=0.0).state_dict().items()}


def _batches():
    return list(np.random.default_rng(72).integers(0, 256, (3, 1, 8, 16)).astype(np.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = _params()
    payload = {
        "ops": {name: _op_inputs(name) for name in OPS},
        "models": {"test_ulysses": dict(zoo="test", model=dict(MODEL, cp_impl="ulysses"), params=params,
                                        tokens=_tokens())},
        "zero": {name: dict(model=dict(MODEL, cp_impl=impl, remat=remat), params=params, opt=OPT,
                            batches=_batches(), data=2, sequence=2, stage=stage, accum_dtype="float32")
                 for name, (impl, stage, remat) in ZERO.items()},
    }
    return _torch_dist.run_world("ulysses_world", payload, tmp_path_factory.mktemp("ulysses"), world=WORLD)


def _whole(ranks, key, name, i):
    return np.concatenate([r[key][name][i] for r in ranks], axis=1)


@pytest.mark.parametrize("name", sorted(OPS))
def test_ulysses_matches_jax_forward_and_grads(world, name, devices):
    c = _op_inputs(name)
    mesh = j_make_mesh(MeshConfig(data=2, sequence=WORLD))  # as tests/test_ulysses.py: the rows over data
    ids = None if c["ids"] is None else jnp.asarray(c["ids"])
    g = jnp.asarray(c["g"])

    def fn(q, k, v):
        return j_ulysses(q, k, v, mesh, causal=True, alibi=c["alibi"], doc_ids=ids, impl="xla")

    qkv = [jnp.asarray(c[x]) for x in "qkv"]
    out = jax.jit(fn)(*qkv)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * g), argnums=(0, 1, 2)))(*qkv)
    for i, want in enumerate((out, *grads)):
        np.testing.assert_allclose(_whole(world, "ops", name, i), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_model_with_ulysses_equals_one_rank(world):
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.load_state_dict({n: torch.from_numpy(p) for n, p in _params().items()})
    with torch.no_grad():
        want = model(torch.from_numpy(_tokens())).numpy()
    got = np.concatenate([r["models"]["test_ulysses"] for r in world], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", [n for n in sorted(ZERO) if n.startswith("ulysses")])
def test_data_x_sequence_step_equals_the_ring(world, name):
    ring = name.replace("ulysses", "ring")
    for r in world:
        got, want = r["zero"][name], r["zero"][ring]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5, atol=1e-5)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, want["params"][n], rtol=1e-5, atol=1e-5, err_msg=n)
    assert world[0]["zero"][name]["losses"][0] > world[0]["zero"][name]["losses"][-1] - 1.0


def test_indivisible_heads_raise_as_jax(devices):
    group = SequenceGroup(rank=0, size=WORLD, backend="none", device=torch.device("cpu"))
    q = torch.zeros(1, 8, 6, D)
    kv = torch.zeros(1, 8, 6, D)
    with pytest.raises(ValueError, match=r"ulysses needs the sequence axis \(4\) to divide the tensor-local head"):
        ulysses_attention(q, kv, kv, group)
    mesh = j_make_mesh(MeshConfig(data=2, sequence=WORLD))
    jq = jnp.zeros((2, 32, 6, D))
    with pytest.raises(ValueError, match=r"ulysses needs the sequence axis \(4\) to divide the tensor-local head"):
        j_ulysses(jq, jq, jq, mesh, impl="xla")


def test_indivisible_sequence_raises(devices):
    group = SequenceGroup(rank=0, size=WORLD, backend="none", device=torch.device("cpu"))
    cfg = dataclasses.replace(tconfig.model_config("test", **MODEL), cp_impl="ulysses")
    model = Transformer(cfg, device="cpu", seq_group=group)
    with pytest.raises(ValueError, match="sequence length 30 not divisible"):
        model(torch.zeros(1, 30, dtype=torch.long))
    mesh = j_make_mesh(MeshConfig(data=2, sequence=WORLD))
    jq = jnp.zeros((2, 30, 4, D))
    with pytest.raises(ValueError, match="sequence length 30 not divisible"):
        j_ulysses(jq, jq, jq, mesh, impl="xla")
