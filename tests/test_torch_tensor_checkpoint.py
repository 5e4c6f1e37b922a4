"""PyTorch port vs JAX reference: checkpoints and Adafactor under tensor
parallelism.

One world of 4 gloo processes (``tests/_torch_dist.py``, its 120 s
deadline) at ``data 2 x tensor 2``, on the ``test`` model widened to
d_model 128 with 2 heads (so Adafactor factors every kernel and the
embedding, and the tensor split cuts factored leaves along each axis:
``query``/``wi``/``wte`` along dim 0, ``out``/``wo`` along dim 1):

- Adafactor at ZeRO 2, three steps from JAX's init, against JAX
  ``parallel/zero.make_train_step`` on a ``MeshConfig(data=2, tensor=2)``
  CPU mesh: losses and grad norms within 1e-5, params within 1e-5; every
  whole ``v_row``/``v_col`` that ``state_leaves`` concatenates over the
  tensor ranks, and every ``v``, equals JAX's statistic of the same leaf
  element for element (within 1e-5 relative for the embedding's, 2e-5 for
  the others, squares of grads that agree within 1e-5), and the totals
  within 1e-5;
- the trainer (``configs/train_test.yaml``, Adafactor, float32, dropout 0) at data
  2 x tensor 2 takes 4 steps and saves at steps 2 and 4: the step directory holds whole tensors
  of the one-card shapes (``ZeroShards.target`` of a one-rank model), the
  digests of the params and of Adafactor's ``v_row``, ``v_col`` and ``v``
  equal JAX ``checkpoint.tree_digests`` of the same tree in JAX's layout,
  leaf for leaf, and the manifest's digests those of the whole leaves;
- the trainer at data 4 x tensor 1 resumes the step-2 save: right after
  the restore it holds the saved state bit for bit, and its steps 3-4
  follow the tensor-parallel run's within 1e-5 (losses and params);
- the anomaly guard under a tensor group: a ``nan_step`` fault at steps 4-7
  with ``anomaly_response`` rollback flags the same steps on every rank
  (the loss and the norm are reduced alike), each rank rolls its own
  shard's snapshot back, and the run completes with finite params that
  the four ranks hold alike;
- the trainer CLI under ``torch.distributed.run`` over data 2 x tensor 2
  on the CPU: the topology printed with its tensor axis, rank 0 alone
  logging, a save of whole tensors.
"""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import _torch_dist
from zero_transformer_tpu import checkpoint as jckpt
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch import checkpoint as ckpt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax, params_to_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.zero import init_train_state as port_init_train_state
from zero_transformer_tpu_torch.training.optimizer import make_schedule

CONFIG = str(Path(__file__).resolve().parent.parent / "configs" / "train_test.yaml")
WORLD, DATA, TP, B, T, STEPS, ATOL = 4, 2, 2, 8, 16, 3, 1e-5
STAT_RTOL = 2 * ATOL  # a statistic averages squared grads: twice the grads' relative error
MODEL = dict(d_model=128, n_heads=2, dropout=0.0, compute_dtype="float32")
OPT = dict(optimizer="adafactor", peak_learning_rate=1e-2, warmup_steps=2, total_steps=64)
STAGE = 2
ROLLBACK_STEPS = 12
TRAINER = {"optimizer.optimizer": "adafactor", "model.d_model": 128, "model.n_heads": 2, "model.dropout": 0.0,
           "model.compute_dtype": "float32",
           "training.train_context": 16, "training.log_frequency": 1, "training.evaluation_frequency": 0,
           "checkpoint.save_frequency": 2, "mesh.zero_stage": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches():
    return np.random.default_rng(140).integers(0, 256, (STEPS, 1, B, T)).astype(np.int32)


def _jax_run():
    jopt = jconfig.OptimizerConfig(**OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=DATA, tensor=TP, zero_stage=STAGE), devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config("test", **MODEL))
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), STAGE)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(23), mesh, (B, T), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    def factory(norm_fn, zc=None):
        return jax_make_optimizer(jopt, None, norm_fn, zero_collectives=zc)

    step = jax_make_train_step(jmodel, tx, mesh, plan, STAGE, jax_make_schedule(jopt), tx_factory=factory)
    losses, norms = [], []
    for batch in _batches():
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, after, _jax_statistics(jstate.opt_state)


def _jax_statistics(opt_state):
    """JAX's factored state: ``{"v_row" | "v_col" | "v": {flat key: array}}``,
    the keys ``/``-joined as in ``params_to_jax``."""
    def fields(x):
        return getattr(x, "_fields", ())

    s = next(x for x in jax.tree.leaves(opt_state, is_leaf=lambda x: "v_row" in fields(x)) if "v_row" in fields(x))
    return {k: {n: np.asarray(v) for n, v in flatten_dict(getattr(s, k), sep="/").items()}
            for k in ("v_row", "v_col", "v")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_run = _jax_run()
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    cases = {"adafactor_stage2": dict(model=MODEL, opt=OPT, params=jax_run[0], batches=list(_batches()),
                                      data=DATA, tensor=TP, sequence=1, stage=STAGE)}
    payload = {"cases": cases, "config": CONFIG, "overrides": TRAINER,
               "dirs": (str(tmp / "tensor"), str(tmp / "resumed"), str(tmp / "rollback")),
               "rollback": {"resilience.anomaly_response": "rollback", "resilience.rollback_after": 2,
                            "resilience.max_rollbacks": 5, "resilience.snapshot_frequency": 2,
                            "training.log_frequency": 2, "checkpoint.save_frequency": 100},
               "rollback_steps": ROLLBACK_STEPS, "nan_steps": (4, 4)}
    ranks = _torch_dist.run_world("tp_checkpoint_world", payload, tmp / "world", world=WORLD, sequence=1, tensor=TP)
    return jax_run, ranks, tmp


def test_adafactor_under_tensor_parallelism_matches_jax(runs):
    (_, losses, norms, after, _), ranks, _ = runs
    got = ranks[0]["cases"]["adafactor_stage2"]
    np.testing.assert_allclose(got["losses"], losses, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=ATOL, atol=ATOL)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p, after[n], atol=ATOL, rtol=0, err_msg=n)
    for r in ranks:
        assert all(np.array_equal(r["cases"]["adafactor_stage2"]["params"][n], p) for n, p in got["params"].items())


def _port_stat(state, kind, jax_key, n_layers=2):
    """The port's ``opt_state/<kind>`` statistic of JAX leaf ``jax_key`` in
    JAX's layout (block leaves stacked over the layers, the ``v`` of a
    weight transposed), or None where the port keeps none (optax's
    one-element placeholders)."""
    names = [f"opt_state/{kind}/{n}" for n in _layer_names(jax_key, n_layers)]
    if not all(n in state for n in names):
        return None
    arrs = [np.asarray(state[n]) for n in names]
    arrs = [a.T if n.endswith(".weight") else a for n, a in zip(names, arrs)]  # .T of a vector is itself
    return np.stack(arrs) if jax_key.startswith("blocks/") else arrs[0]


def test_whole_factored_statistics_match_jax(runs):
    """The statistics along a split axis are each tensor rank's own part;
    ``state_leaves`` concatenates them into JAX's whole vectors, which must
    equal JAX's element for element (a wrong order of the parts fails)."""
    (*_, stats), ranks, _ = runs
    state = ranks[0]["cases"]["adafactor_stage2"]["state"]
    compared = set()
    for kind, leaves in stats.items():
        for key, want in leaves.items():
            got = _port_stat(state, kind, key)
            if got is None:
                assert want.shape == (1,), f"{kind}/{key}: the port keeps no statistic JAX holds"
                continue
            compared.update(f"opt_state/{kind}/{n}" for n in _layer_names(key, 2))
            assert got.shape == want.shape, (kind, key, got.shape, want.shape)
            rtol = ATOL if key == "wte/embedding" else STAT_RTOL
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=f"{kind}/{key}")
    assert compared == {n for n in state if n.startswith("opt_state/")}
    for kind, leaves in stats.items():  # and the totals
        total = sum(float(np.sum(v, dtype=np.float64)) for v in leaves.values())
        port = sum(float(np.sum(v, dtype=np.float64)) for n, v in state.items() if n.startswith(f"opt_state/{kind}/"))
        np.testing.assert_allclose(port, total, rtol=ATOL, err_msg=kind)
    # both kinds of split: a statistic along the split axis (local on each rank) and one across it
    shapes = ranks[0]["cases"]["adafactor_stage2"]["shapes"]
    assert shapes["blocks.0.attn.query.weight"] == (64, 128) and shapes["blocks.0.attn.out.weight"] == (128, 64)
    assert state["opt_state/v_row/blocks.0.attn.out.weight"].shape == (128,)
    assert state["opt_state/v_col/blocks.0.attn.query.weight"].shape == (128,)


def _one_card_target():
    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(CONFIG), TRAINER)
    model = Transformer(cfg.model, device="cpu").requires_grad_(True)
    opt = tconfig.OptimizerConfig(**{**OPT, "total_steps": cfg.training.total_steps})
    return port_init_train_state(model, opt, make_schedule(opt)).shards.target()


def _layer_names(jax_key: str, n_layers: int):
    parts = jax_key.split("/")
    leaf = "weight" if parts[-1] == "kernel" else parts[-1]
    if parts[0] != "blocks":
        return [".".join(parts[:-1] + [leaf])]
    return [".".join(["blocks", str(i), *parts[1:-1], leaf]) for i in range(n_layers)]


def test_tensor_parallel_save_holds_the_one_card_tree(runs):
    _, ranks, tmp = runs
    leaves, meta = ckpt.CheckpointManager(tmp / "tensor").restore(2)
    assert meta["topology"]["mesh"]["tensor"] == TP and meta["topology"]["mesh"]["data"] == DATA
    target = _one_card_target()
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in leaves.items()} == target
    # the manifest's digests are the whole leaves'
    digests = ckpt.tree_digests(leaves)
    assert all(meta["manifest"]["leaves"][k]["sum"] == d for k, d in digests.items())
    # the params' and the optimizer state's digests equal JAX tree_digests
    # of the same tree in JAX's layout, leaf for leaf
    port = ckpt.tree_digests(leaves)
    params = {k.removeprefix("params/"): v for k, v in leaves.items() if k.startswith("params/")}
    jax_params = params_to_jax(params)
    trees = {"params": jax_params}
    for kind in ("v_row", "v_col", "v"):
        state = {k: v.numpy() for k, v in leaves.items() if k.startswith(f"opt_state/{kind}/")}
        trees[f"opt_state/{kind}"] = {k: a for k in jax_params if (a := _port_stat(state, kind, k)) is not None}
    assert trees["opt_state/v_row"] and trees["opt_state/v_col"] and trees["opt_state/v"]
    checked = set()
    for prefix, tree in trees.items():
        for key, digest in jckpt.tree_digests(tree).items():
            flat = key.replace("['", "/").replace("']", "").strip("/")
            names = [f"{prefix}/{n}" for n in _layer_names(flat, 2)]
            checked.update(names)
            assert sum(port[n] for n in names) % 2**32 == digest, (prefix, key)
    assert checked == set(leaves)


def test_resume_at_data_4_tensor_1_continues_the_tensor_parallel_run(runs):
    _, ranks, tmp = runs
    saved, _ = ckpt.CheckpointManager(tmp / "tensor").restore(2)
    for r in ranks:  # every rank restores the saved whole state, bit for bit
        for k, v in saved.items():
            assert np.array_equal(r["resumed"]["restored"][k], v.numpy()), k
    want, got = ranks[0]["tensor"], ranks[0]["resumed"]
    assert got["step"] == want["step"] == 4
    for step in (3, 4):
        np.testing.assert_allclose(got["losses"][step], want["losses"][step], rtol=ATOL, atol=ATOL)
    for k, v in want["state"].items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got["state"][k], v, atol=ATOL, rtol=0, err_msg=k)


def test_anomaly_rollback_under_a_tensor_group(runs):
    _, ranks, _ = runs
    first = ranks[0]["rollback"]
    assert first["step"] == ROLLBACK_STEPS
    assert first["report"]["rollbacks"] >= 1 and first["report"]["anomalies"] >= 2
    for r in ranks:
        got = r["rollback"]
        assert got["report"] == first["report"]
        for k, v in first["state"].items():
            if k.startswith("params/"):
                assert np.isfinite(v).all() and np.array_equal(got["state"][k], v), k


def test_trainer_cli_over_data_2_tensor_2_under_torchrun(tmp_path):
    """``--set mesh.data=2 --set mesh.tensor=2`` under
    ``torch.distributed.run`` on the CPU (gloo, 4 processes): rank 0 prints
    the topology with the tensor axis, logs 2 steps alone and saves the
    one-card tree at the end."""
    import json
    import os
    import subprocess
    import sys

    run_dir = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
           "-m", "zero_transformer_tpu_torch.train", "--cfg", CONFIG, "--device", "cpu", "--max-steps", "2",
           "--set", "mesh.data=2", "--set", "mesh.tensor=2", f"checkpoint.directory={run_dir}",
           "training.log_frequency=1", "training.evaluation_frequency=0"]
    proc = subprocess.run(cmd, cwd=Path(CONFIG).parent.parent, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    topo = next(json.loads(x)["distributed"] for x in proc.stdout.splitlines() if x.startswith('{"distributed"'))
    assert (topo["data"], topo["tensor"], topo["ranks"], topo["backend"]) == (2, 2, 4, "gloo")
    assert proc.stdout.count("[step 2] loss=") == 1  # rank 0 alone logs
    steps = [json.loads(x)["step"] for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2]
    leaves, meta = ckpt.CheckpointManager(run_dir).restore(2)
    assert meta["topology"]["mesh"]["tensor"] == 2
    assert leaves["params/wte.embedding"].shape == (256, 64)  # whole, as one card holds it
