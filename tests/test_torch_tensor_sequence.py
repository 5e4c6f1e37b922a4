"""PyTorch port vs JAX reference: the ring and Ulysses over a ``tensor x
sequence`` mesh, and training on it.

One world of 4 gloo processes (``tests/_torch_dist.py``, its 120 s
deadline) at ``tensor 2 x sequence 2``: world rank ``t * 2 + s`` holds the
heads ``t * H / 2 ..`` of the time shard ``s``. Cases:

- op level: ``ring_attention`` and ``ulysses_attention`` with the rank's
  tensor group, forward and backward on each rank's shard and head slice
  of the same seeded numpy q, k, v, equal JAX ``ring_attention`` /
  ``ulysses_attention`` on a ``MeshConfig(tensor=2, sequence=2)`` CPU mesh
  within 2e-5 (ALiBi, GQA 8 on 4 kv heads, no bias, packed documents
  across the shard edge). Each rank's ALiBi slopes are those of its global
  head range: the old table (an ``H_local``-head model's slopes, no tensor
  term in the offset) misses the bar on every rank;
- training: three steps of the ``test`` model (ALiBi) through the ring at
  ZeRO 1 and through Ulysses at ZeRO 3, the ring over packed documents
  with the chunked loss at ZeRO 2, and ``llama3_test`` (RoPE, GQA) through
  the ring, against JAX ``parallel/zero.make_train_step`` on the same
  mesh: losses and grad norms within 1e-5, params within 2e-6; the whole
  params every rank gathers agree, the replicated leaves bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.ops.ring_attention import ring_attention as jax_ring
from zero_transformer_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch.convert import params_from_jax

WORLD, TP, SEQ = 4, 2, 2
OP_ATOL = 2e-5
B, T, D = 2, 32, 16
OPS = {  # name: (engine, H, KVH, alibi, docs)
    "ring_alibi": ("ring", 4, 4, True, False),
    "ring_gqa_docs": ("ring", 8, 4, True, True),
    "ulysses_alibi": ("ulysses", 4, 4, True, False),
    "ulysses_gqa": ("ulysses", 8, 4, True, False),
    "ulysses_no_bias": ("ulysses", 4, 4, False, False),
}
TB, TT, STEPS, LOSS_ATOL, PARAM_ATOL = 4, 32, 3, 1e-5, 2e-6
F32 = dict(dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-3, warmup_steps=2, total_steps=64)
TRAIN = {  # name: (zoo, model overrides, stage)
    "ring_stage1": ("test", dict(F32, cp_impl="ring"), 1),
    "ulysses_stage3": ("test", dict(F32, cp_impl="ulysses"), 3),
    "ring_packed_chunked_stage2": ("test", dict(F32, cp_impl="ring", doc_sep_token=0, loss_chunk=8), 2),
    "llama_ring_stage1": ("llama3_test", dict(F32, cp_impl="ring"), 1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _op_inputs(name):
    _, H, KVH, alibi, docs = OPS[name]
    rng = np.random.default_rng(sorted(OPS).index(name) + 110)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KVH, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ids = None
    if docs:  # documents across the shard edge at 16
        sep = np.zeros((B, T), np.int32)
        sep[0, [5, 15, 16, 27]] = 1
        sep[1, [20]] = 1
        ids = (np.cumsum(sep, axis=1) - sep).astype(np.int32)
    return dict(q=q, k=k, v=v, g=g, ids=ids, alibi=alibi, engine=OPS[name][0])


def _jax_op(name, mesh):
    c = _op_inputs(name)
    fn = jax_ulysses if c["engine"] == "ulysses" else jax_ring
    ids = None if c["ids"] is None else jnp.asarray(c["ids"])

    def attend(q, k, v):
        return fn(q, k, v, mesh, causal=True, alibi=c["alibi"], doc_ids=ids, impl="xla")

    def loss(q, k, v):
        return jnp.sum(attend(q, k, v) * c["g"])

    q, k, v = (jnp.asarray(c[x]) for x in "qkv")
    out = jax.jit(attend)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return tuple(np.asarray(x) for x in (out, *grads))


def _batches(name):
    rng = np.random.default_rng(sorted(TRAIN).index(name) + 120)
    tokens = rng.integers(1, 256, (STEPS, 1, TB, TT)).astype(np.int32)
    if TRAIN[name][1].get("doc_sep_token") == 0:  # separators on and beside the shard edge at 16
        tokens[:, :, 0, [6, 15, 16]] = 0
        tokens[:, :, 2, [23]] = 0
    return tokens


def _jax_train(name):
    zoo, over, stage = TRAIN[name]
    jopt = jconfig.OptimizerConfig(**OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=1, tensor=TP, sequence=SEQ, zero_stage=stage),
                     devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config(zoo, **over), mesh=mesh)
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (TB, TT), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(17), mesh, (TB, TT), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    step = jax_make_train_step(jmodel, tx, mesh, plan, stage, jax_make_schedule(jopt))
    losses, norms = [], []
    for batch in _batches(name):
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mesh = make_mesh(jconfig.MeshConfig(data=1, tensor=TP, sequence=SEQ), devices=jax.devices()[:WORLD])
    jax_ops = {name: _jax_op(name, mesh) for name in OPS}
    jax_train = {name: _jax_train(name) for name in TRAIN}
    train = {name: dict(zoo=zoo, model=over, opt=OPT, params=jax_train[name][0], batches=list(_batches(name)),
                        data=1, tensor=TP, sequence=SEQ, stage=stage)
             for name, (zoo, over, stage) in TRAIN.items()}
    payload = {"attention": {name: _op_inputs(name) for name in OPS}, "train": train}
    ranks = _torch_dist.run_world("tp_sequence_world", payload, tmp_path_factory.mktemp("tp_seq"), world=WORLD,
                                  sequence=SEQ, tensor=TP)
    return jax_ops, jax_train, ranks


def _rank_slice(x, rank):
    t, s = divmod(rank, SEQ)
    return _torch_dist.shard(_torch_dist.shard(x, s, SEQ, 1), t, TP, 2)


@pytest.mark.parametrize("name", sorted(OPS))
def test_attention_over_tensor_x_sequence_matches_jax(runs, name):
    jax_ops, _, ranks = runs
    for rank, r in enumerate(ranks):
        got = r["attention"][name]
        for what, a, b in zip(("out", "dq", "dk", "dv"), got[:4], jax_ops[name]):
            np.testing.assert_allclose(a, _rank_slice(b, rank), atol=OP_ATOL, rtol=0,
                                       err_msg=f"{name} rank {rank} {what}")


@pytest.mark.parametrize("name", [n for n in sorted(OPS) if OPS[n][3]])
def test_the_old_slope_offset_misses_the_bar(runs, name):
    """Without the tensor group the engines took the slope table of an
    ``H_local``-head model from offset ``s * H_local / n`` (no tensor term,
    and ALiBi's slopes depend on the head count): every rank's output
    leaves JAX's by far more than the bar."""
    jax_ops, _, ranks = runs
    for rank, r in enumerate(ranks):
        miss = np.abs(r["attention"][name][4] - _rank_slice(jax_ops[name][0], rank)).max()
        assert miss > 100 * OP_ATOL, (name, rank, miss)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_tensor_x_sequence_step_matches_jax_make_train_step(runs, name):
    _, jax_train, ranks = runs
    _, losses, norms, after = jax_train[name]
    first = ranks[0]["train"][name]
    np.testing.assert_allclose(first["losses"], losses, rtol=LOSS_ATOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(first["norms"], norms, rtol=LOSS_ATOL, atol=LOSS_ATOL)
    assert first["tokens"] == [float(TB * TT)] * STEPS
    for n, p in first["params"].items():
        np.testing.assert_allclose(p, after[n], atol=PARAM_ATOL, rtol=0, err_msg=f"{name} {n}")
    for r in ranks:
        got = r["train"][name]
        assert got["losses"] == first["losses"] and got["norms"] == first["norms"]
        for n, p in first["params"].items():
            assert np.array_equal(got["params"][n], p), n
        for n, p in first["replicated"].items():
            assert np.array_equal(got["replicated"][n], p), n
