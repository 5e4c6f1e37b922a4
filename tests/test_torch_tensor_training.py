"""PyTorch port vs JAX reference: tensor-parallel training (``mesh.tensor``).

One world of 4 gloo processes (``tests/_torch_dist.py``, its 120 s
deadline) at ``data 2 x tensor 2`` holds every case of the file. Each
tensor rank holds the Megatron split of every layer (``models/gpt.py``),
the loss is the vocab-parallel cross entropy over the rank's vocabulary
columns (``ops/losses.py``), and ZeRO runs over each data group
(``parallel/zero.py``). From the JAX init converted by ``params_from_jax``
(the whole tensors; ``ZeroShards.load_params`` takes each rank's slices),
three optimizer steps on each data rank's half of every global batch [1,
8, 16] are held against JAX ``parallel/zero.make_train_step`` called
directly on a ``MeshConfig(data=2, tensor=2)`` CPU mesh at the same stage:

- AdamW at ZeRO stages 0, 1, 2 and 3 (the ``test`` model, ALiBi);
- Lion at stage 1 (within ``SIGN_FLIP_SHARE``: an update's sign decided by
  rounding may flip);
- the chunked loss (``loss_chunk`` 8) at stage 2;
- ``llama3_test`` (RoPE, SwiGLU, RMSNorm, an untied head, GQA 4 on 2 kv
  heads) at stage 3.

Loss and grad norm per step within 1e-5, every param after the steps
within 2e-6 (AdamW) or 1e-5; the whole params that ``state_leaves``
gathers equal the ranks' own slices; the data replicas hold bit-equal
state and the replicated leaves (norm scales) are bit-equal across the
tensor ranks; each rank's persistent bytes are a ZeRO share of its local
params. Two port-only cases: at ``tensor 4`` (one tensor group of the
whole world) with dropout 0.1 the step equals the port's one-rank step
(every tensor rank draws the one-card masks); and the vocab-parallel
losses (full and chunked, with ``ignore_index`` and ``z_loss``) and their
grads on each rank's columns equal JAX ``cross_entropy_loss`` /
``chunked_next_token_loss`` on the whole logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.ops import losses as jlosses
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer, tp_split_dim
from zero_transformer_tpu_torch.training.optimizer import make_schedule

WORLD, DATA, TP, B, T, STEPS = 4, 2, 2, 8, 16, 3
LOSS_ATOL = 1e-5
ATOL = {"adamw": 2e-6, "lion": 1e-5}
F32 = dict(dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-3, warmup_steps=2, total_steps=64)
CASES = {  # name: (zoo, model overrides, optimizer, stage)
    **{f"adamw_stage{s}": ("test", F32, "adamw", s) for s in (0, 1, 2, 3)},
    "lion_stage1": ("test", F32, "lion", 1),
    "chunked_stage2": ("test", dict(F32, loss_chunk=8), "adamw", 2),
    "llama_stage3": ("llama3_test", F32, "adamw", 3),
}
# see test_torch_zero_optimizers.py: at most this share of Lion's elements
# may take the other sign of an update decided by rounding
SIGN_FLIP_SHARE = 1e-4
LOSS_V, LOSS_B, LOSS_T, LOSS_D, CHUNK, Z_LOSS = 256, 2, 12, 16, 4, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 90)
    return rng.integers(0, 256, (STEPS, 1, B, T)).astype(np.int32)


def _jax_run(name):
    """JAX's init and three steps at data 2 x tensor 2: (whole params at
    init, losses, grad norms, params after)."""
    zoo, over, opt_name, stage = CASES[name]
    jopt = jconfig.OptimizerConfig(optimizer=opt_name, **OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=DATA, tensor=TP, zero_stage=stage), devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config(zoo, **over))
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(13), mesh, (B, T), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    factory = None
    if stage >= 2:
        def factory(norm_fn, zc=None):
            return jax_make_optimizer(jopt, None, norm_fn, zero_collectives=zc)
    step = jax_make_train_step(jmodel, tx, mesh, plan, stage, jax_make_schedule(jopt), tx_factory=factory)
    losses, norms = [], []
    for batch in _batches(name):
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, after


def _dropout_case():
    """The ``test`` model with dropout 0.1 at tensor 4 and on one rank."""
    model = Transformer(tconfig.model_config("test", compute_dtype="float32"), device="cpu")
    model.init_weights(torch.Generator().manual_seed(21))
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    batches = list(np.random.default_rng(22).integers(0, 256, (STEPS, 1, B, T)).astype(np.int32))
    base = dict(model=dict(compute_dtype="float32"), opt=OPT, params=params, batches=batches, stage=1, seed=5)
    return {"dropout_tensor4": dict(base, data=1, tensor=4, sequence=1),
            "dropout_one_rank": dict(base, data=1, tensor=1, sequence=1)}


def _loss_inputs():
    rng = np.random.default_rng(31)
    logits = (3 * rng.standard_normal((LOSS_B, LOSS_T, LOSS_V))).astype(np.float32)
    labels = rng.integers(0, LOSS_V, (LOSS_B, LOSS_T)).astype(np.int64)
    labels[0, 3] = labels[1, 7] = labels[1, 0] = -1
    hidden = rng.standard_normal((LOSS_B, LOSS_T, LOSS_D)).astype(np.float32)
    w = (0.3 * rng.standard_normal((LOSS_D, LOSS_V))).astype(np.float32)
    return dict(logits=logits, labels=labels, hidden=hidden, w=w)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {name: _jax_run(name) for name in CASES}
    cases = {name: dict(zoo=zoo, model=over, opt={**OPT, "optimizer": opt}, params=jax_runs[name][0],
                        batches=list(_batches(name)), data=DATA, tensor=TP, sequence=1, stage=stage)
             for name, (zoo, over, opt, stage) in CASES.items()}
    cases.update(_dropout_case())
    payload = {"train": cases, "losses": dict(_loss_inputs(), chunk=CHUNK, z_loss=Z_LOSS)}
    ranks = _torch_dist.run_world("tp_training_world", payload, tmp_path_factory.mktemp("tp_train"), world=WORLD,
                                  sequence=1, tensor=TP)
    return jax_runs, ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_step_matches_jax_make_train_step(runs, name):
    jax_runs, ranks = runs
    _, losses, norms, after = jax_runs[name]
    got = ranks[0]["train"][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_ATOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=LOSS_ATOL, atol=LOSS_ATOL)
    assert got["tokens"] == [float(B * T)] * STEPS  # the global batch, once
    assert set(got["params"]) == set(after)
    opt = CASES[name][2]
    if opt == "lion":
        schedule = make_schedule(tconfig.OptimizerConfig(**OPT))
        flips = 2.1 * sum(schedule(i) for i in range(STEPS)) + ATOL[opt]
        diff = np.concatenate([np.abs(p - after[n]).ravel() for n, p in got["params"].items()])
        assert (diff > ATOL[opt]).mean() <= SIGN_FLIP_SHARE and diff.max() <= flips
        return
    for n, p in got["params"].items():
        np.testing.assert_allclose(p, after[n], atol=ATOL[opt], rtol=0, err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_their_slices_and_agree(runs, name):
    """The whole params every rank gathers are equal; each rank's local
    shapes are the split of the whole ones; the replicated leaves are
    bit-equal across all ranks; the data replicas pass the audit."""
    _, ranks = runs
    first = ranks[0]["train"][name]
    for r in ranks:
        got = r["train"][name]
        assert got["losses"] == first["losses"] and got["norms"] == first["norms"]
        for n, p in first["params"].items():
            assert np.array_equal(got["params"][n], p), n
            dim = tp_split_dim(n)
            want = list(p.shape)
            if dim is not None:
                want[dim] //= TP
            assert got["shapes"][n] == tuple(want), n
        for n, p in first["replicated"].items():
            assert np.array_equal(got["replicated"][n], p), n
        assert got["diverged"] is False
    assert {r["train"][name]["tensor_rank"] for r in ranks} == {0, 1}


@pytest.mark.parametrize("name", sorted(CASES))
def test_persistent_bytes_are_a_zero_share_of_the_local_params(runs, name):
    """Each rank holds its tensor slice of the params: AdamW's state is the
    stage's share of the local params (the split leaves' 1/2, the
    replicated ones whole)."""
    _, ranks = runs
    _, _, opt, stage = CASES[name]
    for r in ranks:
        got = r["train"][name]
        local = sum(int(np.prod(s)) for s in got["shapes"].values())
        padded = -(-local // DATA) * DATA
        params = padded if stage < 3 else padded // DATA
        state = {"adamw": 2, "lion": 1}[opt] * (padded if stage == 0 else padded // DATA)
        assert got["persistent_bytes"] == 4 * (params + state)
        whole = sum(p.size for p in got["params"].values())
        split = sum(p.size for n, p in got["params"].items() if tp_split_dim(n) is not None)
        assert local == whole - split + split // TP


def test_dropout_at_tensor_4_equals_the_one_rank_step(runs):
    """Dropout 0.1: every tensor rank draws the one-card masks (the key
    holds no tensor rank), so four tensor ranks train as one rank does."""
    _, ranks = runs
    want = ranks[0]["train"]["dropout_one_rank"]
    for r in ranks:
        got = r["train"]["dropout_tensor4"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_ATOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_ATOL, atol=LOSS_ATOL)
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n], p, atol=2e-6, rtol=0, err_msg=n)


def _jax_loss_grads(c):
    """JAX's mean losses and their grads on the whole logits (full) and on
    hidden and the whole head (chunked, next-token)."""
    logits, labels = jnp.asarray(c["logits"]), jnp.asarray(c["labels"])

    def full(x):
        return jlosses.cross_entropy_loss(x, labels, ignore_index=-1, z_loss=Z_LOSS)

    def chunked(h, w):
        return jlosses.chunked_next_token_loss(h, w, labels, CHUNK, ignore_index=-1, z_loss=Z_LOSS)

    lf, gf = jax.value_and_grad(full)(logits)
    lc, (gh, gw) = jax.value_and_grad(chunked, argnums=(0, 1))(jnp.asarray(c["hidden"]), jnp.asarray(c["w"]))
    return float(lf), np.asarray(gf), float(lc), np.asarray(gh), np.asarray(gw)


def test_vocab_parallel_losses_and_grads_match_jax(runs):
    """On each rank's vocabulary columns, the vocab-parallel loss (one MAX
    and one SUM all-reduce) and the chunked loss give JAX's loss on the
    whole logits, with ``ignore_index`` -1 and ``z_loss``; the grads are
    the rank's columns of JAX's (the chunked loss's ``dh`` summed over the
    tensor ranks, as Megatron's f sums it in a model)."""
    _, ranks = runs
    c = _loss_inputs()
    lf, gf, lc, gh, gw = _jax_loss_grads(c)
    width = LOSS_V // TP
    dh = sum(r["losses"]["chunked_dh"] for r in ranks[:TP])
    for r in ranks:
        got, t = r["losses"], r["train"]["adamw_stage0"]["tensor_rank"]
        cols = slice(t * width, (t + 1) * width)
        np.testing.assert_allclose(got["full"], lf, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["full_grad"], gf[..., cols], rtol=0, atol=1e-7)
        np.testing.assert_allclose(got["chunked"], lc, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["chunked_dw"], gw[:, cols], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dh, gh, rtol=0, atol=1e-6)
