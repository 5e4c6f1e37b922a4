"""PyTorch port vs JAX reference: the per-step anomaly guard, on the CPU.

- The guard's arithmetic (``resilience/anomaly.py``: ``flag`` and
  ``advance_carry``) against JAX ``AnomalyGuard._flag`` and
  ``_advance_carry`` called directly, over seeded sequences of (loss, grad
  norm) holding NaN, +-inf, spikes past each factor and the warmup edge,
  for every ``anomaly_response`` and several factor settings: the flags,
  ``count``, ``streak`` and ``seen`` equal, the EMAs within 1e-6 relative.
- The guarded train step against the JAX composition: JAX
  ``make_train_step`` (called directly on a one-device CPU mesh, as
  ``test_torch_train_step.py`` does) under JAX ``ChaosMonkey([Fault(
  "nan_step", 2, 2)]).wrap_train_step``, then ``_flag``, ``_advance_carry``
  and a ``jnp.where`` select of the old state where flagged (the
  composition of JAX ``wrap``). Six steps, NaN at the non-log steps 2 and
  3: after every step the params and the optimizer state equal JAX's at
  that file's bars (atol 2e-6 for AdamW, 1e-5 for Adafactor and Lion, as
  ``test_torch_optimizers.py``), the count equals optax's and the carry
  equals JAX's; AdamW at ZeRO 1, Adafactor and Lion at ZeRO 0.
- A dropped step leaves the params, the optimizer state and the count
  bit for bit as they were, while ``state.step`` advances.
- Guard off equals guard on bit for bit when nothing is flagged, for each
  optimizer; the optimizer count is a device tensor and the schedule on it
  equals the host schedule within float32 rounding.
- Every rank flags the same step: 4 gloo ranks at ZeRO 2 with a NaN in one
  rank's micro-batch only all drop the step and end bit-equal.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import TrainState as JaxTrainState
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.resilience.anomaly import AnomalyGuard as JaxGuard
from zero_transformer_tpu.resilience.chaos import ChaosMonkey as JaxChaos
from zero_transformer_tpu.resilience.chaos import Fault as JaxFault
from zero_transformer_tpu.training import optimizer as jopt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.zero import init_train_state as port_init_train_state
from zero_transformer_tpu_torch.parallel.zero import make_train_step
from zero_transformer_tpu_torch.resilience import anomaly
from zero_transformer_tpu_torch.resilience.anomaly import AnomalyGuard, HostSnapshot
from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault
from zero_transformer_tpu_torch.training import optimizer as topt

B, T = 4, 16
STEPS = 6
NAN_AT, NAN_LEN = 2, 2  # state.step 2 and 3: completed steps 3 and 4, no log point
BARS = {"adamw": 2e-6, "adafactor": 1e-5, "lion": 1e-5}
MODELS = {"adamw": dict(dropout=0.0, compute_dtype="float32"),
          # widened so that Adafactor factors (test_torch_optimizers.py)
          "adafactor": dict(d_model=128, n_heads=2, dropout=0.0, compute_dtype="float32"),
          "lion": dict(d_model=128, n_heads=2, dropout=0.0, compute_dtype="float32")}
STAGES = {"adamw": 1, "adafactor": 0, "lion": 0}
OPT = dict(peak_learning_rate=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1, grad_clip=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------- the guard's arithmetic

GUARD_CASES = {
    "halt_nonfinite_only": dict(anomaly_response="halt"),
    "skip_loss_spike": dict(anomaly_response="skip_batch", loss_spike_factor=3.0, spike_warmup_steps=4),
    "skip_grad_spike": dict(anomaly_response="skip_batch", grad_spike_factor=5.0, spike_warmup_steps=3,
                            ema_decay=0.9),
    "rollback_both": dict(anomaly_response="rollback", loss_spike_factor=3.0, grad_spike_factor=5.0,
                          spike_warmup_steps=5),
    "rollback_warmup_0": dict(anomaly_response="rollback", loss_spike_factor=1.5, grad_spike_factor=1.5,
                              spike_warmup_steps=0, ema_decay=0.5),
    "halt_tight_factors": dict(anomaly_response="halt", loss_spike_factor=1.01, grad_spike_factor=1.01,
                               spike_warmup_steps=1),
}


def _sequence(seed: int, n: int = 64):
    """(loss, grad norm) pairs: a noisy baseline with NaN, +-inf, spikes of
    2-20x and a clean stretch right at the start (the warmup edge)."""
    rng = np.random.default_rng(seed)
    loss = (4.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    grad = (1.0 + 0.2 * np.abs(rng.standard_normal(n))).astype(np.float32)
    for i in range(6, n):
        r = rng.random()
        if r < 0.06:
            loss[i] = np.nan
        elif r < 0.09:
            grad[i] = np.inf if rng.random() < 0.5 else -np.inf
        elif r < 0.12:
            loss[i] = -np.inf
        elif r < 0.22:
            loss[i] *= rng.uniform(2.0, 20.0)
        elif r < 0.32:
            grad[i] *= rng.uniform(2.0, 20.0)
    return loss, grad


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_flag_and_carry_match_jax(case):
    kw = GUARD_CASES[case]
    jres, tres = jconfig.ResilienceConfig(**kw), tconfig.ResilienceConfig(**kw)
    ns = SimpleNamespace(cfg=jres)
    jcarry = {k: jnp.zeros((), jnp.int32 if k in anomaly._INT_KEYS else jnp.float32) for k in anomaly.CARRY_KEYS}
    tcarry = anomaly.init_carry("cpu")
    loss, grad = _sequence(sorted(GUARD_CASES).index(case))
    flags = []
    for l, g in zip(loss, grad):
        jbad = JaxGuard._flag(ns, jnp.float32(l), jnp.float32(g), jcarry)
        tbad = anomaly.flag(tres, torch.tensor(l), torch.tensor(g), tcarry)
        assert bool(tbad) == bool(jbad)
        flags.append(bool(tbad))
        jcarry = JaxGuard._advance_carry(ns, jbad, jnp.float32(l), jnp.float32(g), jcarry)
        tcarry = anomaly.advance_carry(tres, tbad, torch.tensor(l), torch.tensor(g), tcarry)
        for k in ("count", "streak", "seen", "audit_failures"):
            assert int(tcarry[k]) == int(jcarry[k]), k
        for k in ("loss_ema", "grad_ema"):
            np.testing.assert_allclose(float(tcarry[k]), float(jcarry[k]), rtol=1e-6, err_msg=k)
    assert any(flags)
    # both branches; at warmup 0 the spike checks arm against EMAs still 0,
    # and every step flags, in JAX as here
    assert all(flags) if kw.get("spike_warmup_steps") == 0 else not all(flags)


def test_guard_read_is_the_carry():
    guard = AnomalyGuard(tconfig.ResilienceConfig(), "cpu")
    for l in (1.0, float("nan"), float("nan"), 2.0, float("inf")):
        bad = guard.flag(torch.tensor(l), torch.tensor(1.0))
        guard.advance(bad, torch.tensor(l), torch.tensor(1.0))
    guard.record_audit(True)
    stats = guard.read()
    assert (stats.count, stats.streak, stats.audit_failures) == (3, 1, 1)
    assert stats.loss_ema == pytest.approx(0.98 * 1.0 + 0.02 * 2.0)
    guard.reset()
    assert guard.read().count == 0


# ---------------------------------------------------- the guarded trajectory


def _jax_opt_views(opt_state):
    """optax's count and, by name, the moments (AdamW ``mu``/``nu``, Lion
    ``mu``) or Adafactor's statistic totals."""
    def fields(x):  # optax states are namedtuples
        return getattr(x, "_fields", ())

    leaves = jax.tree.leaves(opt_state, is_leaf=lambda x: "count" in fields(x))
    count = next(int(s.count) for s in leaves if "count" in fields(s))
    out = {"count": count}
    for s in leaves:
        if "nu" in fields(s):
            out["mu"], out["nu"] = s.mu, s.nu
        elif "mu" in fields(s):
            out["mu"] = s.mu
        elif "v_row" in fields(s):
            out["sums"] = {k: float(sum(np.sum(np.asarray(x, np.float64)) for x in jax.tree.leaves(getattr(s, k))))
                           for k in ("v_row", "v_col", "v")}
    return out


def _check_state(name, model, state, jstate, guard, jcarry, step):
    bar = BARS[name]
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=bar, rtol=0,
                                   err_msg=f"{name} step {step} {n}")
    views = _jax_opt_views(jstate.opt_state)
    assert int(state.optimizer.count) == views["count"], f"{name} step {step}"
    leaves = state.shards.state_leaves()
    if "sums" in views:
        for key, total in views["sums"].items():
            got = sum(float(v.double().sum()) for k, v in leaves.items() if k.startswith(f"opt_state/{key}/"))
            np.testing.assert_allclose(got, total, rtol=1e-5, err_msg=f"{name} step {step} {key}")
    for key in ("mu", "nu"):
        if key in views:
            ref = params_from_jax(jax.tree.map(np.asarray, views[key]))
            for n, v in ref.items():
                np.testing.assert_allclose(leaves[f"opt_state/{key}/{n}"].numpy(), v.numpy(), atol=bar, rtol=0,
                                           err_msg=f"{name} step {step} {key}/{n}")
    stats = guard.read()
    assert (stats.count, stats.streak) == (int(jcarry["count"]), int(jcarry["streak"])), f"{name} step {step}"


@pytest.mark.parametrize("name", ["adamw", "adafactor", "lion"])
def test_guarded_steps_match_the_jax_composition(name):
    stage = STAGES[name]
    jopt_cfg = jconfig.OptimizerConfig(optimizer=name, **OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=1, zero_stage=stage), devices=jax.devices()[:1])
    jmodel = JaxTransformer(jconfig.model_config("test", **MODELS[name]))
    tx = jopt.make_optimizer(jopt_cfg)
    plan = make_plan(jmodel, tx, mesh, (B, T), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(0), mesh, (B, T), plan)
    donating = jax_make_train_step(jmodel, tx, mesh, plan, stage, jopt.make_schedule(jopt_cfg))
    # the JAX step donates its input state, and the chaos wrapper reads
    # state.step after the call: hand the step a copy
    jstep = JaxChaos([JaxFault("nan_step", NAN_AT, NAN_LEN)]).wrap_train_step(
        lambda st, batch, rng: donating(jax.tree.map(jnp.copy, st), batch, rng))
    jres = jconfig.ResilienceConfig(anomaly_response="skip_batch")
    ns = SimpleNamespace(cfg=jres)
    jcarry = {k: jnp.zeros((), jnp.int32 if k in anomaly._INT_KEYS else jnp.float32) for k in anomaly.CARRY_KEYS}

    model = Transformer(tconfig.model_config("test", **MODELS[name]), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    model.requires_grad_(True)
    opt_cfg = tconfig.OptimizerConfig(optimizer=name, **OPT)
    schedule = topt.make_schedule(opt_cfg)
    state = port_init_train_state(model, opt_cfg, schedule, zero_stage=stage)
    guard = AnomalyGuard(tconfig.ResilienceConfig(anomaly_response="skip_batch"), "cpu")
    step = make_train_step(stage, schedule, guard=guard,
                           poison=ChaosMonkey([Fault("nan_step", NAN_AT, NAN_LEN)]).step_poison())
    rng = np.random.default_rng(11)
    for i in range(STEPS):
        batch = rng.integers(0, 256, (1, B, T)).astype(np.int32)
        old = jstate
        new, jm = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        bad = JaxGuard._flag(ns, jm["loss"], jm["grad_norm"], jcarry)
        keep = lambda o, n: jnp.where(bad, o, n)  # noqa: E731 (JAX wrap's select)
        jstate = JaxTrainState(step=new.step, params=jax.tree.map(keep, old.params, new.params),
                               opt_state=jax.tree.map(keep, old.opt_state, new.opt_state))
        jcarry = JaxGuard._advance_carry(ns, bad, jm["loss"], jm["grad_norm"], jcarry)
        m = step(state, torch.from_numpy(batch))
        assert bool(m["anomaly"]) == bool(bad) == (NAN_AT <= i < NAN_AT + NAN_LEN)
        if not bool(bad):
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert state.step == int(jstate.step) == i + 1
        _check_state(name, model, state, jstate, guard, jcarry, i + 1)


# --------------------------------------------------------- the port on its own


def _port_run(name, guard_cfg, steps, poison=None, seed=5):
    model = Transformer(tconfig.model_config("test", **MODELS[name]), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    opt_cfg = tconfig.OptimizerConfig(optimizer=name, **OPT)
    schedule = topt.make_schedule(opt_cfg)
    state = port_init_train_state(model, opt_cfg, schedule, zero_stage=STAGES[name])
    guard = None if guard_cfg is None else AnomalyGuard(guard_cfg, "cpu")
    step = make_train_step(STAGES[name], schedule, guard=guard, poison=poison)
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(rng.integers(0, 256, (1, B, T)).astype(np.int32)) for _ in range(steps)]
    return state, step, batches, guard


@pytest.mark.parametrize("name", ["adamw", "adafactor", "lion"])
def test_guard_off_equals_guard_on_bit_for_bit(name):
    off, step_off, batches, _ = _port_run(name, None, 4)
    on, step_on, _, guard = _port_run(name, tconfig.ResilienceConfig(), 4)
    for b in batches:
        m_off, m_on = step_off(off, b), step_on(on, b)
        assert torch.equal(m_off["loss"], m_on["loss"]) and torch.equal(m_off["grad_norm"], m_on["grad_norm"])
    a, b = off.shards.state_leaves(), on.shards.state_leaves()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(off.optimizer.count, on.optimizer.count) and int(on.optimizer.count) == 4
    assert guard.read().count == 0


@pytest.mark.parametrize("name", ["adamw", "adafactor", "lion"])
def test_dropped_step_changes_nothing_but_the_step(name):
    poison = ChaosMonkey([Fault("nan_step", 2, 1)]).step_poison()
    state, step, batches, guard = _port_run(name, tconfig.ResilienceConfig(anomaly_response="skip_batch"), 4,
                                            poison=poison)
    for b in batches[:2]:
        step(state, b)
    before = [t.clone() for t in HostSnapshot.device_tensors(state)]
    m = step(state, batches[2])
    assert bool(m["anomaly"]) and not np.isfinite(float(m["loss"])) and state.step == 3
    after = HostSnapshot.device_tensors(state)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert int(state.optimizer.count) == 2
    step(state, batches[3])
    assert int(state.optimizer.count) == 3 and state.step == 4
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
    assert guard.read().count == 1


def test_count_is_a_device_tensor_and_the_schedule_reads_it():
    for kw in (dict(schedule="warmup_cosine", warmup_steps=3, total_steps=12, end_learning_rate=1e-5),
               dict(schedule="warmup_linear", warmup_steps=2, total_steps=9),
               dict(schedule="constant")):
        sched = topt.make_schedule(tconfig.OptimizerConfig(**kw))
        for c in range(14):
            got = sched(torch.tensor(c, dtype=torch.int32))
            np.testing.assert_allclose(float(got), sched(c), rtol=1e-6, atol=1e-12)
    state, step, batches, _ = _port_run("adamw", None, 1)
    assert state.optimizer.count.dtype == torch.int32 and state.optimizer.count.dim() == 0
    step(state, batches[0])
    assert int(state.optimizer.count) == 1


# ------------------------------------------------------ every rank, one flag


def test_every_rank_flags_the_same_step_at_zero2(tmp_path):
    """4 gloo ranks at ZeRO 2: rank 1's second micro-batch of step 2 is NaN
    (its loss scaled by NaN in the forward), no other rank's. The reduced
    loss and the global norm carry it to every rank: all flag step 2 only,
    drop it, and end with bit-equal params and the same carry."""
    jmodel = JaxTransformer(jconfig.model_config("test", **MODELS["adamw"]))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    from zero_transformer_tpu.parallel.sharding import unbox

    rng = np.random.default_rng(2)
    payload = {"params": {n: p.numpy() for n, p in params_from_jax(unbox(params)).items()},
               "model": MODELS["adamw"], "opt": OPT, "stage": 2, "nan_rank": 1, "nan_step": 2, "nan_micro": 1,
               "batches": [rng.integers(0, 256, (2, 4 * 2, T)).astype(np.int32) for _ in range(4)]}
    ranks = _torch_dist.run_world("guarded_zero_steps", payload, tmp_path, world=4, sequence=1)
    for r in ranks:
        assert r["anomaly"] == [False, False, True, False]
        assert r["count"] == 3 and r["carry"] == ranks[0]["carry"]
        for n, p in ranks[0]["params"].items():
            assert np.array_equal(r["params"][n], p), n
    assert all(np.isfinite(p).all() for p in ranks[0]["params"].values())
