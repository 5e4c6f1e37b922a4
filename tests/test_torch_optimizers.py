"""PyTorch port vs JAX reference: Adafactor and Lion, one process.

The model is the ``test`` zoo entry widened to d_model 128 with 2 heads
(2 layers, vocab 256, float32, dropout 0): at the zoo's d 64 no leaf has a
second dim of 128, so Adafactor would factor nothing.

- ``make_optimizer`` against JAX ``training/optimizer.make_optimizer`` for
  5 steps on the same converted params and numpy grads (one step's grads
  large enough to clip), with ``scan_layers`` on and off (one RMS per
  stacked JAX leaf, or per layer): every param within 1e-5;
- the factoring rule on JAX's shapes: the port's statistics hold exactly
  the elements of JAX's ``FactoredState`` less its one-element markers, on
  this model and at ``1_3b`` (shapes only), where every kernel is a tie
  ``[2048, 2048]`` or not;
- ``make_train_step`` with each optimizer against JAX
  ``parallel/zero.make_train_step`` called directly on a one-device CPU
  mesh, accum 1 and 2: loss and grad norm per step (rtol 1e-5) and every
  param after 3 steps within 1e-5;
- the state as a checkpoint holds it: ``state_leaves`` names and shapes
  equal ``target()``, load back bit for bit, and another optimizer's
  checkpoint is a structural mismatch, fatal on restore;
- persistent bytes: AdamW 12N, Lion 8N, Adafactor 4N plus 4 bytes per
  element of its statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.training import optimizer as jopt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.checkpoint import CheckpointManager
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.zero import init_train_state as port_init_train_state
from zero_transformer_tpu_torch.parallel.zero import make_train_step
from zero_transformer_tpu_torch.training import optimizer as topt

MODEL = dict(d_model=128, n_heads=2, dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1, grad_clip=1.0)
ATOL = 1e-5
B, T = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(scan_layers=True, **more):
    jmodel = JaxTransformer(jconfig.model_config("test", scan_layers=scan_layers, **MODEL, **more))
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return jmodel, params


def _port_model(tree, scan_layers=True):
    model = Transformer(tconfig.model_config("test", scan_layers=scan_layers, **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model.requires_grad_(True)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "unscanned"])
@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_optimizer_matches_jax_make_optimizer(name, scan_layers):
    _, params = _jax_params(scan_layers)
    tree = jax.tree.map(np.asarray, params)
    tx = jopt.make_optimizer(jconfig.OptimizerConfig(optimizer=name, **OPT))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    model = _port_model(tree, scan_layers)
    opt = topt.make_optimizer(model, tconfig.OptimizerConfig(optimizer=name, **OPT))
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(2)
    for i in range(5):
        scale = 10.0 if i == 2 else 1e-2  # step 2 clips
        gtree = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), tree)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, gtree), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = params_from_jax(gtree)
        norm = opt.step([grads[n] for n in names])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gtree)), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    start = params_from_jax(tree)
    for n, p in model.named_parameters():
        assert not np.array_equal(want[n].numpy(), start[n].numpy()), n  # every leaf moved
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)


def _jax_state_numel(jmodel, tx) -> int:
    """Elements of JAX's adafactor second-moment state, less the (1,)
    markers optax keeps for the statistics a leaf does not use (no leaf of
    these models is one element)."""
    shapes = jax.eval_shape(lambda: unbox(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
                                          ["params"]))
    state = jax.eval_shape(tx.init, shapes)
    factored = next(s for s in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "v_row"))
                    if hasattr(s, "v_row"))
    return sum(int(np.prod(x.shape)) for part in (factored.v_row, factored.v_col, factored.v)
               for x in jax.tree.leaves(part) if x.shape != (1,))


@pytest.mark.parametrize("size", ["wide_test", "1_3b"])
def test_factored_state_follows_jax_shapes(size):
    tx = jopt.make_optimizer(jconfig.OptimizerConfig(optimizer="adafactor"))
    if size == "1_3b":
        jmodel = JaxTransformer(jconfig.model_config("1_3b"))
        model = Transformer(tconfig.model_config("1_3b"), device="meta")
    else:
        jmodel = _jax_params()[0]
        model = Transformer(tconfig.model_config("test", **MODEL), device="meta")
    want = _jax_state_numel(jmodel, tx)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert topt.factored_state_numel(shapes, scan_layers=True) == want
    n_layers = model.cfg.n_layers
    # the ties of [in, out] = [d, d] resolve as np.argsort does: v_row spans the
    # kernel's in dim (the port weight's dim 1), averaged over out (dim 0)
    assert topt.factoring("blocks.0.attn.query.weight", shapes["blocks.0.attn.query.weight"], n_layers,
                          True) == ("blocks.*.attn.query.weight", (0, 1))
    assert topt.factoring("wte.embedding", shapes["wte.embedding"], n_layers, True) == ("wte.embedding", (0, 1))
    assert topt.factoring("ln_f.scale", shapes["ln_f.scale"], n_layers, True) == ("ln_f.scale", None)
    assert topt.factoring("blocks.1.ln_mlp.scale", shapes["blocks.1.ln_mlp.scale"], n_layers, False)[0] == \
        "blocks.1.ln_mlp.scale"


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["adafactor", "lion"])
def test_train_step_matches_jax_make_train_step(name, accum):
    jopt_cfg = jconfig.OptimizerConfig(optimizer=name, **OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jmodel = JaxTransformer(jconfig.model_config("test", **MODEL))
    tx = jopt.make_optimizer(jopt_cfg)
    plan = make_plan(jmodel, tx, mesh, (B, T), 1)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(0), mesh, (B, T), plan)
    jstep = jax_make_train_step(jmodel, tx, mesh, plan, 1, jopt.make_schedule(jopt_cfg))
    model = _port_model(jax.tree.map(np.asarray, jstate.params))
    opt_cfg = tconfig.OptimizerConfig(optimizer=name, **OPT)
    schedule = topt.make_schedule(opt_cfg)
    state = port_init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)
    rng = np.random.default_rng(11)
    for _ in range(3):
        batch = rng.integers(0, 256, (accum, B, T)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        m = step(state, torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)


def _trained_state(name, steps=2):
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    opt_cfg = tconfig.OptimizerConfig(optimizer=name, **OPT)
    schedule = topt.make_schedule(opt_cfg)
    state = port_init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)
    rng = np.random.default_rng(3)
    for _ in range(steps):
        step(state, torch.from_numpy(rng.integers(0, 256, (1, B, T)).astype(np.int32)))
    return state, opt_cfg, schedule


@pytest.mark.parametrize("name", ["adafactor", "lion", "adamw"])
def test_state_leaves_round_trip_and_target(name):
    state, opt_cfg, schedule = _trained_state(name)
    leaves = state.shards.state_leaves()
    target = state.shards.target()
    assert {k: (tuple(v.shape), "float32") for k, v in leaves.items()} == target
    keys = {k.split("/")[1] for k in leaves if k.startswith("opt_state/")}
    assert keys == {"adafactor": {"v_row", "v_col", "v"}, "lion": {"mu"}, "adamw": {"mu", "nu"}}[name]
    if name == "adafactor":  # factored leaves keep rows and columns, the others v
        assert "opt_state/v_row/wte.embedding" in leaves and "opt_state/v/wte.embedding" not in leaves
        assert "opt_state/v/ln_f.scale" in leaves and "opt_state/v_row/ln_f.scale" not in leaves
        assert all(float(v.abs().sum()) > 0 for k, v in leaves.items() if k.startswith("opt_state/"))
    fresh = Transformer(tconfig.model_config("test", **MODEL), device="cpu").requires_grad_(True)
    other = port_init_train_state(fresh, opt_cfg, schedule)
    other.shards.load_leaves({k: v.clone() for k, v in leaves.items()}, state.optimizer.count)
    again = other.shards.state_leaves()
    assert set(again) == set(leaves) and other.optimizer.count == 2
    for k, v in leaves.items():
        assert torch.equal(again[k], v), k


def test_checkpoint_of_another_optimizer_is_a_structural_mismatch(tmp_path):
    state, _, _ = _trained_state("adamw", steps=1)
    ckpt = CheckpointManager(tmp_path, async_save=False)
    ckpt.save(1, state.shards.state_leaves(), meta={"opt_count": 1}, force=True)
    for name in ("adafactor", "lion"):
        other, _, _ = _trained_state(name, steps=0)
        with pytest.raises(ValueError, match="leaf sets differ"):
            ckpt.restore_verified(other.shards.target())
    assert ckpt.latest_step() == 1  # a mismatch is not corruption: nothing quarantined


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor"])
def test_persistent_bytes_by_optimizer(name):
    state, _, _ = _trained_state(name, steps=0)
    cfg = tconfig.model_config("test", **MODEL)
    n = cfg.num_params
    shapes = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    want = {"adamw": 12 * n, "lion": 8 * n,
            "adafactor": 4 * n + 4 * topt.factored_state_numel(shapes, scan_layers=True)}[name]
    assert state.shards.persistent_bytes() == want
