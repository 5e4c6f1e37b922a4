"""PyTorch port vs JAX reference: the training slice as a whole, on the CPU.

The ``test`` zoo model at dropout 0 in float32, with the port's weights
converted from the JAX init by ``params_from_jax``:

- one batch's loss and every parameter's grad against
  ``jax.value_and_grad`` of the JAX model's loss (loss rtol 1e-6, grads
  atol 1e-6 on grads up to 0.12; measured: equal loss, grads 3e-8);
- three optimizer steps of the port's ``make_train_step`` against JAX
  ``parallel/zero.make_train_step`` called directly on a one-device CPU
  mesh, at accum 1 and 2 (float32 and bfloat16 accumulators): loss and grad
  norm per step (rtol 1e-5), and the params after the three steps within
  atol 2e-6 with float32 accumulators (measured 1.3e-7) and 1e-5 with
  bfloat16 ones (measured 1.8e-6: micro-grads a float32 ulp apart can round
  to neighbouring bf16 values in the buffer, 2^-8 apart). Adam's first
  updates are sign-like (``m / sqrt(v)`` is +-1 for every element at step
  one), so an element whose grad is within float32 noise of zero could move
  by a whole learning rate (up to 5e-4 here) in one package and not the
  other; the bars sit far below that and hold because no such element
  occurs here;
- the port's trainer CLI on ``configs/train_test.yaml`` with
  ``--device cpu``: a few steps, a finite loss, ``metrics.jsonl`` written.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch import train as ttrain
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.zero import init_train_state as port_init_train_state
from zero_transformer_tpu_torch.parallel.zero import make_train_step
from zero_transformer_tpu_torch.training.optimizer import make_schedule

TRAIN_TEST = str(Path(__file__).resolve().parent.parent / "configs" / "train_test.yaml")
MODEL = dict(dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-3, warmup_steps=4, total_steps=64)
B, T = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(accum, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (accum, B, T)).astype(np.int32)


def _port_model(tree):
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model.requires_grad_(True)


def test_loss_and_grads_match_jax_value_and_grad():
    jcfg = jconfig.model_config("test", **MODEL)
    jmodel = JaxTransformer(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens = _batch(1, 4)[0]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(tokens), labels=jnp.asarray(tokens), train=True)[1]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    model = _port_model(jax.tree.map(np.asarray, params))
    t = torch.from_numpy(tokens)
    logits, t_loss = model(t, labels=t, train=True)
    assert logits.shape == (B, T, 256)
    names = [n for n, _ in model.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    assert set(want) == set(names)
    for n, g in zip(names, t_grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("accum,accum_dtype", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_three_steps_match_jax_make_train_step(accum, accum_dtype):
    jcfg = jconfig.model_config("test", **MODEL)
    jopt_cfg = jconfig.OptimizerConfig(**OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jmodel = JaxTransformer(jcfg)
    tx = jax_make_optimizer(jopt_cfg)
    plan = make_plan(jmodel, tx, mesh, (B, T), 1)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(0), mesh, (B, T), plan)
    jstep = jax_make_train_step(jmodel, tx, mesh, plan, 1, jax_make_schedule(jopt_cfg),
                                grad_accum_dtype=accum_dtype)

    model = _port_model(jax.tree.map(np.asarray, jstate.params))
    schedule = make_schedule(tconfig.OptimizerConfig(**OPT))
    state = port_init_train_state(model, tconfig.OptimizerConfig(**OPT), schedule)
    step = make_train_step(1, schedule, accum_dtype)
    for i in range(3):
        batch = _batch(accum, 10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        m = step(state, torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["learning_rate"], float(jm["learning_rate"]), rtol=1e-6)
        assert m["tokens"] == float(jm["tokens"]) == accum * B * T
    assert state.step == int(jstate.step) == 3
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    atol = 2e-6 if accum_dtype == "float32" else 1e-5
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=atol, rtol=0, err_msg=n)


def test_trainer_cli_runs_on_cpu(tmp_path, capsys):
    run_dir = tmp_path / "run"
    ttrain.main(["--cfg", TRAIN_TEST, "--device", "cpu", "--max-steps", "6", "--set",
                 f"checkpoint.directory={run_dir}", "training.log_frequency=3",
                 "training.evaluation_frequency=6", "training.maximum_evaluation_steps=2"])
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    assert [r["step"] for r in train] == [3, 6]
    assert all(np.isfinite(r["loss"]) and r["tokens_per_sec"] > 0 and r["step_time_ms"] > 0 for r in train)
    assert "model_flops_share" not in train[-1]  # no device peak on the CPU
    val = [r for r in records if "validation/loss" in r]
    assert len(val) == 1 and np.isfinite(val[0]["validation/loss"])
    out = capsys.readouterr().out
    # every resilience setting is acted on: the trainer prints the block, and nothing as ignored
    assert '"resilience"' in out and '"not_ported_ignored"' not in out and "[step 6]" in out


def test_trainer_halts_on_non_finite_loss(tmp_path):
    from zero_transformer_tpu_torch.training.trainer import Trainer

    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(TRAIN_TEST), {
        "checkpoint.directory": str(tmp_path), "training.log_frequency": 1,
        "optimizer.schedule": "constant", "optimizer.peak_learning_rate": float("nan"),
    })
    trainer = Trainer(cfg, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="non-finite loss"):
            trainer.train(max_steps=3)
    finally:
        trainer.close()
