"""Dropout in the PyTorch port: exact where it must be, by distribution
where the masks cannot be JAX's.

The port's masks come from torch generators seeded by ``fold_seed`` of
(training seed, step, data rank, micro-step, sequence rank, layer, site);
JAX draws threefry bits, so no mask can equal JAX's. The checks:

- at dropout 0 the port's training loss and grads equal JAX ``model.apply``
  with ``train=True`` (loss rtol 1e-6, grads atol 1e-6), and a dropout-0.1
  model in eval (``train=False``) equals JAX's eval logits (1e-5);
- ``dropout``: every output is 0 or x / (1 - p); the kept share of 10^6
  elements lies within 5 sigma of 1 - p (sigma = sqrt(p (1 - p) / n)), and
  the mean of the output within 5 sigma of the input's; the same seed gives
  the same bits, p 0 returns the input itself;
- the ``test`` model at dropout 0.1: every site (embedding, and attention
  and MLP output in each layer) draws a mask once per forward, each with a
  kept share within 5 sigma of 0.9; remat on and off give bit-equal loss
  and grads (the recompute redraws the same masks); masks differ across
  sites, layers, steps, micro-steps and data ranks; no site draws in eval;
- the train step draws micro-step i of step s on data rank r from ``(seed,
  s, r, i)``; a run resumed from a checkpoint takes the same losses, bit for
  bit, as the uninterrupted run;
- the trainer CLI on ``--device cpu`` with Adafactor, ``loss_chunk`` and
  dropout 0.1 on a widened ``test`` model trains, and its checkpoint holds
  Adafactor's statistics.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch import train as ttrain
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models import gpt
from zero_transformer_tpu_torch.models.gpt import Transformer, dropout, fold_seed
from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
from zero_transformer_tpu_torch.training.optimizer import make_schedule
from zero_transformer_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
TRAIN_TEST = str(ROOT / "configs" / "train_test.yaml")
P, SIGMAS = 0.1, 5.0
B, T = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _within_sigmas(share: float, n: int, p: float = P) -> bool:
    return abs(share - (1 - p)) <= SIGMAS * math.sqrt(p * (1 - p) / n)


def _tokens(seed=4):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (B, T)).astype(np.int32))


def _model(remat=False, p=P, **more):
    model = Transformer(tconfig.model_config("test", dropout=p, compute_dtype="float32", remat=remat, **more),
                        device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model.requires_grad_(True)


def _loss_and_grads(model, tokens, key):
    _, loss = model(tokens, labels=tokens, train=True, dropout_key=key)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def test_dropout_zero_matches_jax_in_training_and_dropout_is_off_in_eval():
    jmodel = JaxTransformer(jconfig.model_config("test", dropout=0.0, compute_dtype="float32"))
    params = unbox(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    tokens = _tokens()
    jt = jnp.asarray(tokens.numpy())

    def loss_fn(p):
        return jmodel.apply({"params": p}, jt, labels=jt, train=True, rngs={"dropout": jax.random.PRNGKey(1)})[1]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    model = Transformer(tconfig.model_config("test", dropout=0.0, compute_dtype="float32"), device="cpu")
    model.load_state_dict(state)
    model.requires_grad_(True)
    t_loss, t_grads = _loss_and_grads(model, tokens, (0, 5, 1, 0))
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    for (n, _), g in zip(model.named_parameters(), t_grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)
    # eval: the zoo's dropout 0.1 changes nothing
    jdrop = JaxTransformer(jconfig.model_config("test", compute_dtype="float32"))
    drop = Transformer(tconfig.model_config("test", compute_dtype="float32"), device="cpu")
    drop.load_state_dict(state)
    assert drop.cfg.dropout == 0.1
    with torch.no_grad():
        got = drop(tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdrop.apply({"params": params}, jt)), atol=1e-5, rtol=0)


def test_dropout_keeps_one_minus_p_and_scales_kept_values():
    x = torch.rand(1000, 1000) + 0.5
    out = dropout(x, P, seed=fold_seed(7, 1))
    kept = out != 0
    assert torch.equal(out[kept], x[kept] / (1 - P))
    n = x.numel()
    assert _within_sigmas(kept.float().mean().item(), n)
    # E[out] = E[x]: the kept values' scale makes up for the dropped ones
    sigma = math.sqrt(P / (1 - P)) * x.pow(2).mean().sqrt().item() / math.sqrt(n)
    assert abs(out.mean().item() - x.mean().item()) <= SIGMAS * sigma
    assert torch.equal(dropout(x, P, seed=fold_seed(7, 1)), out)  # the same seed, the same bits
    assert not torch.equal(dropout(x, P, seed=fold_seed(7, 2)), out)
    assert dropout(x, 0.0, seed=3) is x and dropout(x, P, seed=None) is x
    assert torch.equal(dropout(x, 1.0, seed=3), torch.zeros_like(x))


@pytest.fixture
def recorded(monkeypatch):
    """Every mask the model draws, in order: (seed, kept mask)."""
    masks = []

    def record(x, rate, seed):
        out = dropout(x, rate, seed)
        if seed is not None:
            masks.append((seed, out != 0))
        return out

    monkeypatch.setattr(gpt, "dropout", record)
    return masks


def test_every_site_draws_once_with_kept_share_near_one_minus_p(recorded):
    model = _model()
    model(_tokens(), labels=_tokens(), train=True, dropout_key=(0, 0, 0, 0))
    L = model.cfg.n_layers
    assert len(recorded) == 1 + 2 * L  # the embedding, then attention and MLP per layer
    assert len({seed for seed, _ in recorded}) == len(recorded)
    for _, mask in recorded:
        assert _within_sigmas(mask.float().mean().item(), mask.numel())


def test_no_site_draws_in_eval(recorded):
    model = _model()
    with torch.no_grad():
        model(_tokens())
        model(_tokens(), labels=_tokens())
    assert recorded == []


def test_remat_on_and_off_give_bit_equal_grads(recorded):
    tokens, key = _tokens(), (3, 7, 1, 2)
    loss, grads = _loss_and_grads(_model(remat=False), tokens, key)
    plain = list(recorded)
    recorded.clear()
    r_loss, r_grads = _loss_and_grads(_model(remat=True), tokens, key)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    # the recompute redrew block masks (up to the last tensor the backward
    # needs: the checkpoint stops there), each the same bits as in the forward
    assert len(recorded) >= len(plain) + _model().cfg.n_layers
    for seed, mask in recorded[len(plain):]:
        assert any(s == seed and torch.equal(m, mask) for s, m in plain)
    # and dropout changed the loss
    model = _model()
    _, no_drop = model(tokens, labels=tokens)
    assert loss.item() != no_drop.item()


@pytest.mark.parametrize("field", ["seed", "step", "rank", "micro"])
def test_masks_differ_across_seed_step_rank_and_micro_step(recorded, field):
    key = {"seed": 0, "step": 4, "rank": 1, "micro": 2}
    model = _model()
    model(_tokens(), labels=_tokens(), train=True, dropout_key=tuple(key.values()))
    first = list(recorded)
    recorded.clear()
    key[field] += 1
    model(_tokens(), labels=_tokens(), train=True, dropout_key=tuple(key.values()))
    for (s0, m0), (s1, m1) in zip(first, recorded):
        assert s0 != s1 and not torch.equal(m0, m1)


def test_train_step_draws_from_seed_step_rank_and_micro_step(recorded):
    model = _model()
    opt_cfg = tconfig.OptimizerConfig(peak_learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(model, opt_cfg, make_schedule(opt_cfg))
    step = make_train_step(1, make_schedule(opt_cfg), seed=9)
    batch = torch.stack([_tokens(1), _tokens(2)])
    step(state, batch)
    step(state, batch)
    L, sites = 2, 5
    want = [fold_seed(9, s, 0, i, 0, -1, gpt.EMBED_SITE) for s in range(2) for i in range(2)]
    assert [seed for seed, _ in recorded[::sites]] == want
    assert len(recorded) == 4 * (1 + 2 * L)


def _trainer_overrides(run_dir, **more):
    return {"checkpoint.directory": str(run_dir), "checkpoint.save_frequency": 2, "checkpoint.async_save": False,
            "training.total_steps": 4, "training.log_frequency": 1, "training.evaluation_frequency": 0,
            "optimizer.warmup_steps": 1, "model.dropout": P, "model.compute_dtype": "float32", **more}


def _run_trainer(overrides, max_steps=None):
    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(TRAIN_TEST), overrides)
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train(max_steps=max_steps)
    finally:
        trainer.close()
    lines = (Path(cfg.checkpoint.directory) / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, lines) if "loss" in r}, trainer


def test_resumed_run_takes_the_uninterrupted_losses(tmp_path):
    whole, w = _run_trainer(_trainer_overrides(tmp_path / "whole"))
    _run_trainer(_trainer_overrides(tmp_path / "cut"), max_steps=2)
    resumed, r = _run_trainer(_trainer_overrides(tmp_path / "cut", **{"checkpoint.resume": True}))
    assert sorted(whole) == [1, 2, 3, 4] and resumed == whole
    for (n, p), (_, q) in zip(w.state.model.named_parameters(), r.state.model.named_parameters()):
        assert torch.equal(p, q), n
    no_drop, _ = _run_trainer(_trainer_overrides(tmp_path / "no_drop", **{"model.dropout": 0.0}))
    assert no_drop[2] != whole[2]


def test_trainer_cli_trains_with_adafactor_loss_chunk_and_dropout(tmp_path, capsys):
    run_dir = tmp_path / "run"
    ttrain.main(["--cfg", TRAIN_TEST, "--device", "cpu", "--max-steps", "4", "--set",
                 f"checkpoint.directory={run_dir}", "training.log_frequency=2", "training.evaluation_frequency=4",
                 "training.maximum_evaluation_steps=2", "optimizer.optimizer=adafactor", "model.loss_chunk=8",
                 "model.dropout=0.1", "model.d_model=128", "model.n_heads=2"])
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    assert [r["step"] for r in train] == [2, 4] and all(np.isfinite(r["loss"]) for r in train)
    val = [r for r in records if "validation/loss" in r]
    assert len(val) == 1 and np.isfinite(val[0]["validation/loss"])
    out = capsys.readouterr().out
    n = tconfig.model_config("test", d_model=128, n_heads=2).num_params
    persistent = json.loads(next(line for line in out.splitlines() if line.startswith('{"trainer"')))["trainer"]
    assert 4 * n < persistent["persistent_state_bytes"] < 5 * n  # the params and the small statistics
    from safetensors import safe_open

    with safe_open(str(run_dir / "4" / "opt_state.safetensors"), "pt") as f:
        keys = set(f.keys())
    assert "v_row/wte.embedding" in keys and "v/ln_f.scale" in keys and not any(k.startswith("mu/") for k in keys)
