"""PyTorch port vs JAX reference: Adafactor and Lion under ZeRO, on 4 ranks.

The ``test`` zoo model widened to d_model 128 with 2 heads (so Adafactor
factors every kernel and the embedding; float32, dropout 0) trains three
optimizer steps on 4 gloo processes, from the JAX init converted by
``params_from_jax``; each data rank takes its quarter of every global batch
[1, 8, 16]. At stages 1, 2 and 3 with each optimizer, the step is held
against JAX ``parallel/zero.make_train_step`` called directly on a CPU mesh
of data 4 at the same stage (stages 2-3 with the shard-aware clip and, for
Adafactor, JAX's shard-aware factored statistics through ``tx_factory``):
loss and grad norm per step and every param after the three steps within
1e-5 (for Lion, all but the rare elements whose update's sign is decided by
rounding: see ``SIGN_FLIP_SHARE``). The ranks hold bit-equal params and the replica audit sees no
divergence; each rank's persistent bytes follow the stage: the params
whole (stages 1-2) or a quarter (stage 3), Lion's momentum a quarter,
Adafactor's statistics whole plus ``v`` of its quarter of the leaves that
do not factor.

A second world runs the trainer (``configs/train_test.yaml`` with
Adafactor on the widened model, ZeRO stage 2): 4 steps with dropout 0.1,
and 2 steps, a save, and a resume at data 4 that takes steps 3-4 bit for
bit (params and losses) equal to the uninterrupted run (the dropout masks
follow the step); then, at dropout 0, a save on 4 ranks that resumes on 2
ranks at stage 3, the loss within 1e-5 of the uninterrupted run's.
"""
import threading
from pathlib import Path

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
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.sharding import FlatLayout
from zero_transformer_tpu_torch.training.optimizer import (Adafactor, factoring, make_schedule,
                                                           weight_decay_mask)

CONFIG = str(Path(__file__).resolve().parent.parent / "configs" / "train_test.yaml")

WORLD, B, T, STEPS, ATOL = 4, 8, 16, 3, 1e-5
MODEL = dict(d_model=128, n_heads=2, dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-2, warmup_steps=2, total_steps=64)
CASES = {f"{name}_stage{stage}": (name, stage) for name in ("adafactor", "lion") for stage in (1, 2, 3)}
N = tconfig.model_config("test", **MODEL).num_params  # divisible by 4: no padding


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 30)
    return rng.integers(0, 256, (STEPS, 1, B, T)).astype(np.int32)


def _jax_run(name):
    opt_name, stage = CASES[name]
    jopt = jconfig.OptimizerConfig(optimizer=opt_name, **OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=WORLD, zero_stage=stage), devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config("test", **MODEL))
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(5), mesh, (B, T), plan)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {name: _jax_run(name) for name in CASES}
    payload = {name: dict(model=MODEL, params=jax_runs[name][0], opt={**OPT, "optimizer": CASES[name][0]},
                          batches=list(_batches(name)), data=WORLD, sequence=1, stage=CASES[name][1],
                          accum_dtype="float32")
               for name in CASES}
    ranks = _torch_dist.run_world("zero_cases", payload, tmp_path_factory.mktemp("zero_opt"), world=WORLD,
                                  sequence=1)
    return jax_runs, ranks


# Lion's update is a sign: an element whose blended grad (1 - b1) g + b1 m
# lies within float32 rounding of zero can take the other sign when the
# grads are summed in another order (gloo's against JAX's reduce-scatter).
# Such an element moves by one flipped update, 2 lr (1 + wd |p|) <= 2.1 lr,
# at most once per step: at most SIGN_FLIP_SHARE of the elements may differ
# from JAX by more than ATOL, and none by more than those flips.
SIGN_FLIP_SHARE = 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_zero_step_matches_jax_make_train_step(runs, name):
    jax_runs, ranks = runs
    _, losses, norms, after = jax_runs[name]
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=ATOL, atol=ATOL)
    assert set(got["params"]) == set(after)
    if CASES[name][0] == "adafactor":
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, after[n], atol=ATOL, rtol=0, err_msg=f"{name} {n}")
        return
    schedule = make_schedule(tconfig.OptimizerConfig(**OPT))
    flips = 2.1 * sum(schedule(i) for i in range(STEPS)) + ATOL
    diff = np.concatenate([np.abs(p - after[n]).ravel() for n, p in got["params"].items()])
    assert (diff > ATOL).mean() <= SIGN_FLIP_SHARE and diff.max() <= flips, (int((diff > ATOL).sum()), diff.max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_bit_equal_params_and_pass_the_audit(runs, name):
    _, ranks = runs
    first = ranks[0][name]
    for r in ranks:
        assert r[name]["losses"] == first["losses"] and r[name]["norms"] == first["norms"]
        for n, p in first["params"].items():
            assert np.array_equal(r[name]["params"][n], p), n
        assert r[name]["diverged"] is False


def _adafactor_bytes(rank: int, stage: int) -> int:
    """Adafactor's statistics on one rank: v_row and v_col of every
    factored leaf, and v over the rank's quarter of the others."""
    model = Transformer(tconfig.model_config("test", **MODEL), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = FlatLayout.build(shapes, weight_decay_mask(model), WORLD)
    stats = 0
    for n, s in shapes.items():
        axes = factoring(n, s, 2, True)[1]
        stats += 0 if axes is None else s[0] + s[1]
    lo, hi = layout.shard_range(rank)
    own = sum(seg.numel for seg in layout.segments(lo, hi) if factoring(seg.name, seg.shape, 2, True)[1] is None)
    return 4 * (stats + own)


@pytest.mark.parametrize("name", sorted(CASES))
def test_persistent_bytes_follow_the_stage(runs, name):
    opt_name, stage = CASES[name]
    _, ranks = runs
    params = 4 * (N if stage < 3 else N // WORLD)
    for rank, r in enumerate(ranks):
        state = 4 * N // WORLD if opt_name == "lion" else _adafactor_bytes(rank, stage)
        assert r[name]["persistent_bytes"] == params + state


def test_adafactor_segments_start_and_end_mid_row():
    """At data 4 the shard boundaries cut leaves mid-row: the case the
    partial row and column sums exist for."""
    model = Transformer(tconfig.model_config("test", **MODEL), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = FlatLayout.build(shapes, weight_decay_mask(model), WORLD)
    cut = [seg for r in range(WORLD) for seg in layout.segments(*layout.shard_range(r))
           if len(seg.shape) == 2 and (seg.start % seg.shape[1] or seg.stop % seg.shape[1])]
    assert cut
    assert sum(seg.numel for r in range(WORLD) for seg in layout.segments(*layout.shard_range(r))) == N


class _ThreadSum:
    """An in-place all-reduce among ``n`` threads: each adds its buffer,
    waits for the others and takes the total."""

    def __init__(self, n: int):
        self.barrier, self.lock, self.total = threading.Barrier(n), threading.Lock(), None

    def __call__(self, t: torch.Tensor) -> None:
        with self.lock:
            self.total = t.clone() if self.total is None else self.total + t
        self.barrier.wait()
        t.copy_(self.total)
        if self.barrier.wait() == 0:
            self.total = None


def test_adafactor_on_uneven_parts_equals_the_whole_step():
    """One process, the flat layout cut in 3 uneven parts that start and
    end mid-row: three ``Adafactor`` instances over the parts, stepping in
    three threads whose partial sums meet in an all-reduce, update the
    params as one instance over the whole does, within 1e-6."""
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.init_weights(torch.Generator().manual_seed(1))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = FlatLayout.build(shapes, weight_decay_mask(model), 1)
    opt_cfg = tconfig.OptimizerConfig(optimizer="adafactor", **OPT)
    schedule = make_schedule(opt_cfg)
    flat = layout.flatten({n: p.detach() for n, p in model.named_parameters()})
    whole, parts = flat.clone(), flat.clone()
    cuts = [(0, 40_001), (40_001, 170_333), (170_333, layout.numel)]

    def optimizer(buf, lo, hi, reduce=None):
        segs = layout.segments(lo, hi)
        return Adafactor([buf[lo + s.offset:lo + s.offset + s.numel] for s in segs], segs, shapes, opt_cfg,
                         schedule, True, reduce)

    reduce = _ThreadSum(len(cuts))
    opt_whole = optimizer(whole, 0, layout.numel)
    opts = [optimizer(parts, lo, hi, reduce) for lo, hi in cuts]
    assert any(s.start % s.shape[-1] for o in opts for s in o.segments)  # mid-row starts
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = torch.from_numpy(rng.standard_normal(layout.numel).astype(np.float32)) * 1e-2
        norm = torch.linalg.vector_norm(g)

        def grads(o, lo):
            return [g[lo + s.offset:lo + s.offset + s.numel] for s in o.segments]

        opt_whole.step(grads(opt_whole, 0), norm)
        threads = [threading.Thread(target=o.step, args=(grads(o, lo), norm)) for o, (lo, _) in zip(opts, cuts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert all(o.count == 3 for o in opts)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    assert not torch.equal(whole, flat)


def _overrides(run_dir, **more):
    return {"checkpoint.directory": str(run_dir), "checkpoint.save_frequency": 2, "checkpoint.async_save": False,
            "training.total_steps": 4, "training.log_frequency": 1, "training.evaluation_frequency": 0,
            "optimizer.warmup_steps": 1, "optimizer.optimizer": "adafactor", "model.d_model": 128,
            "model.n_heads": 2, "model.compute_dtype": "float32", "mesh.zero_stage": 2, **more}


def _losses(metrics, after=0):
    """Loss by step; a resumed run's file starts with the copied run's lines."""
    return {r["step"]: r["loss"] for r in metrics if "loss" in r and r["step"] > after}


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("af_resume")
    drop = {"model.dropout": 0.1}
    world4 = [
        dict(config=CONFIG, overrides=_overrides(root / "whole", **drop)),
        dict(config=CONFIG, overrides=_overrides(root / "cut", **drop), max_steps=2),
        dict(config=CONFIG, overrides=_overrides(root / "d4", **drop, **{"checkpoint.resume": True}),
             copy=[(str(root / "cut"), str(root / "d4"))]),
        dict(config=CONFIG, overrides=_overrides(root / "whole0")),
        dict(config=CONFIG, overrides=_overrides(root / "cut0"), max_steps=2),
    ]
    four = _torch_dist.run_world("trainer_runs", world4, root / "world4", world=4, sequence=1)
    two = _torch_dist.run_world("trainer_runs", [dict(
        config=CONFIG, overrides=_overrides(root / "d2", **{"checkpoint.resume": True, "mesh.zero_stage": 3}),
        copy=[(str(root / "cut0"), str(root / "d2"))])], root / "world2", world=2, sequence=1)
    return {"whole": four[0][0], "d4": four[0][2], "whole0": four[0][3], "d2": two[0][0]}


def test_adafactor_resume_with_dropout_is_bit_equal(resumes):
    whole, resumed = resumes["whole"], resumes["d4"]
    want = _losses(whole["metrics"])
    assert sorted(want) == [1, 2, 3, 4]
    assert _losses(resumed["metrics"], after=2) == {3: want[3], 4: want[4]}
    for n, p in whole["params"].items():
        assert np.array_equal(resumed["params"][n], p), n


def test_adafactor_elastic_resume_4_to_2_continues_the_loss(resumes):
    want = _losses(resumes["whole0"]["metrics"])
    got = _losses(resumes["d2"]["metrics"], after=2)
    assert resumes["d2"]["step"] == 4 and sorted(got) == [3, 4]
    np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]], rtol=ATOL, atol=ATOL)
    for n, p in resumes["whole0"]["params"].items():
        np.testing.assert_allclose(resumes["d2"]["params"][n], p, atol=ATOL, rtol=0, err_msg=n)
    # the dropout run's losses differ from the run without it
    assert _losses(resumes["whole"]["metrics"]) != want
