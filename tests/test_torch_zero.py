"""PyTorch port vs JAX reference: ZeRO data parallelism (stages 0-3).

The ``test`` zoo model (dropout 0, float32) trains three optimizer steps on
4 gloo processes, from the JAX init converted by ``params_from_jax``: each
data rank takes its contiguous quarter of every global batch [accum, 8, 16]
and the step runs ZeRO ``zero_stage`` over the data group
(``parallel/zero.py``). One world runs every case of the file:

- stages 0, 1, 2 and 3 at data 4, accum 1;
- stage 2 with accum 2 and a bfloat16 accumulator;
- data 2 x sequence 2 at stage 2 (the ring inside each data rank's rows).

Each case is held against JAX ``parallel/zero.make_train_step`` called
directly on a CPU mesh of the same shape and stage (stages 2-3 with the
shard-aware clip, ``tx_factory``): loss and grad norm per step and every
param after the three steps within 1e-5; the ranks hold bit-equal params
and the replica audit sees no divergence; each rank's persistent bytes
equal the stage's formula. Single-process tests pin the flat layout's
padding, slicing and decay boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.parallel.sharding import FlatLayout

WORLD, B, T, STEPS, ATOL = 4, 8, 16, 3, 1e-5
MODEL = dict(dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-3, warmup_steps=2, total_steps=64)
CASES = {  # name: (data, sequence, stage, accum, grad_accum_dtype)
    "stage0": (4, 1, 0, 1, "float32"),
    "stage1": (4, 1, 1, 1, "float32"),
    "stage2": (4, 1, 2, 1, "float32"),
    "stage3": (4, 1, 3, 1, "float32"),
    "stage2_accum2_bf16": (4, 1, 2, 2, "bfloat16"),
    "data2_seq2_stage2": (2, 2, 2, 1, "float32"),
}
# the test model: N params, divisible by 4 (no padding)
N = 2 * (4 * 64 * 64 + 2 * 64 * 256 + 2 * 64) + 256 * 64 + 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(name):
    accum = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name) + 80)
    return rng.integers(0, 256, (STEPS, accum, B, T)).astype(np.int32)


def _jax_run(name):
    """JAX's init and three steps on a CPU mesh of the case's shape: (params
    at init, losses, grad norms, params after)."""
    data, sequence, stage, _, accum_dtype = CASES[name]
    jopt = jconfig.OptimizerConfig(**OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=data, sequence=sequence, zero_stage=stage),
                     devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config("test", **MODEL), mesh=mesh if sequence > 1 else None)
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(3), mesh, (B, T), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    factory = (lambda norm_fn, zc=None: jax_make_optimizer(jopt, None, norm_fn)) if stage >= 2 else None
    step = jax_make_train_step(jmodel, tx, mesh, plan, stage, jax_make_schedule(jopt), tx_factory=factory,
                               grad_accum_dtype=accum_dtype)
    losses, norms, tokens = [], [], []
    for batch in _batches(name):
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        tokens.append(float(m["tokens"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, tokens, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, and every case on the port's 4 ranks in one world."""
    jax_runs = {name: _jax_run(name) for name in CASES}
    payload = {name: dict(model=MODEL, params=jax_runs[name][0], opt=OPT, batches=list(_batches(name)),
                          data=c[0], sequence=c[1], stage=c[2], accum_dtype=c[4])
               for name, c in CASES.items()}
    ranks = _torch_dist.run_world("zero_cases", payload, tmp_path_factory.mktemp("zero"), world=WORLD,
                                  sequence=1)
    return jax_runs, ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_zero_step_matches_jax_make_train_step(runs, name):
    jax_runs, ranks = runs
    _, losses, norms, tokens, after = jax_runs[name]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=ATOL, atol=ATOL)
    assert got["tokens"] == tokens == [float(CASES[name][3] * B * T)] * STEPS  # the global batch
    assert set(got["params"]) == set(after)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p, after[n], atol=ATOL, rtol=0, err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_bit_equal_params_and_pass_the_audit(runs, name):
    _, ranks = runs
    first = ranks[0][name]
    for r in ranks:
        assert r[name]["losses"] == first["losses"] and r[name]["norms"] == first["norms"]
        for n, p in first["params"].items():
            assert np.array_equal(r[name]["params"][n], p), n
        assert r[name]["diverged"] is False


@pytest.mark.parametrize("name", sorted(CASES))
def test_persistent_bytes_follow_the_stage_formula(runs, name):
    """f32 params whole (stages 0-2) or a 1/n shard (stage 3); AdamW's m and
    v whole (stage 0) or a 1/n shard."""
    data, _, stage, _, _ = CASES[name]
    params = N if stage < 3 else N // data
    moments = 2 * (N if stage == 0 else N // data)
    _, ranks = runs
    for r in ranks:
        assert r[name]["persistent_bytes"] == 4 * (params + moments)


def _layout(world):
    shapes = {"a": (3, 2), "ln": (5,), "b": (7,), "ln2": (2,)}
    decay = {"a": True, "ln": False, "b": True, "ln2": False}
    return FlatLayout.build(shapes, decay, world), shapes


@pytest.mark.parametrize("world", [1, 3, 4])
def test_flat_layout_pads_slices_and_puts_decayed_leaves_first(world):
    layout, shapes = _layout(world)
    assert layout.names == ("a", "b", "ln", "ln2") and layout.decay_end == 13 and layout.numel == 20
    assert layout.padded % world == 0 and layout.padded - layout.numel < world
    g = torch.Generator().manual_seed(world)
    leaves = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    flat = layout.flatten(leaves)
    assert torch.all(flat[layout.numel:] == 0)  # padding: no weight, no grad, no digest
    for n, v in layout.views(flat).items():
        assert torch.equal(v, leaves[n])
    shards = [layout.shard_of(leaves, r) for r in range(world)]
    assert torch.equal(torch.cat(shards), flat)
    decayed = sum(layout.shard_decay_end(r) for r in range(world))
    assert decayed == layout.decay_end
    for r in range(world):
        lo, hi = layout.shard_range(r)  # [lo, lo + end) decays, [lo + end, hi) does not
        assert lo + layout.shard_decay_end(r) == min(max(layout.decay_end, lo), hi)


def test_flat_layout_shard_norm_counts_every_element_once():
    """The norm from shards (squares summed over the ranks) equals the
    norm of the whole grads, padding included as zero."""
    layout, shapes = _layout(3)
    g = torch.Generator().manual_seed(9)
    grads = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    whole = torch.sqrt(sum(torch.sum(v * v) for v in grads.values()))
    from_shards = torch.sqrt(sum(torch.sum(layout.shard_of(grads, r) ** 2) for r in range(3)))
    torch.testing.assert_close(from_shards, whole, rtol=1e-6, atol=0)


def test_jax_zero_sharding_would_replicate_what_the_flat_layout_shards():
    """Why the layout is flat: at data 3 JAX's per-leaf rule
    (``_add_zero_axis``) keeps every leaf of the test model replicated (no
    dim divides by 3), so each rank would hold the whole AdamW state; the
    flat layout gives each rank a third."""
    from zero_transformer_tpu.parallel.sharding import _add_zero_axis

    mesh = make_mesh(jconfig.MeshConfig(data=3), devices=jax.devices()[:3])
    shapes = {"wte": (256, 64), "ln": (64,), "q": (64, 64), "wi": (64, 256)}
    assert all(_add_zero_axis(s, (), mesh, ("data",)) == (None,) * len(s) for s in shapes.values())
    layout = FlatLayout.build(shapes, {n: n != "ln" for n in shapes}, 3)
    assert layout.shard_numel * 3 == layout.padded and layout.shard_numel < layout.numel / 2
