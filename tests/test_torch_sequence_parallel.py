"""PyTorch port vs JAX reference: the sequence-parallel train step.

The ``test`` zoo model (dropout 0, float32) trains three optimizer steps on
a ring of 4 gloo processes (``mesh.sequence`` 4: every rank reads the same
rows [2, 32], runs its 8-token shard through ``ring_attention``, and the
step sums the grads over the ranks), from the JAX init converted by
``params_from_jax``. One world runs every case of the file: remat off,
remat on (``torch.utils.checkpoint`` per block, whose recompute runs the
ring forward again), and a packed case (``doc_sep_token=0``, separators
inside and at the edges of the shards, remat on). Each case is held:

- against JAX ``parallel/zero.make_train_step`` called directly on a
  ``MeshConfig(data=1, sequence=4)`` mesh of the conftest's CPU devices (the
  JAX trainer loop hits the ``set_mesh`` fault): loss and grad norm per step
  within 1e-5, params after the three steps within atol 1e-5;
- against the port's one-process step on the same rows: the same bars;
- across the ranks: the params after the update are bit-equal on all 4.

Then the trainer CLI under ``torch.distributed.run --nproc-per-node 2``
with ``--device cpu`` (gloo): a finite loss in rank 0's ``metrics.jsonl``.
"""
import json
import os
import subprocess
import sys
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
from zero_transformer_tpu_torch.parallel.zero import init_train_state as port_init_train_state
from zero_transformer_tpu_torch.parallel.zero import make_train_step
from zero_transformer_tpu_torch.training.optimizer import make_schedule

ROOT = Path(__file__).resolve().parent.parent
WORLD, B, T, STEPS, ATOL = 4, 2, 32, 3, 1e-5
OPT = dict(peak_learning_rate=1e-3, warmup_steps=4, total_steps=64)
CASES = {  # name: model overrides
    "plain": dict(dropout=0.0, compute_dtype="float32"),
    "remat": dict(dropout=0.0, compute_dtype="float32", remat=True),
    "packed_remat": dict(dropout=0.0, compute_dtype="float32", remat=True, doc_sep_token=0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 60)
    batches = rng.integers(1, 256, (STEPS, 1, B, T)).astype(np.int32)
    if "doc_sep_token" in CASES[name]:
        batches[..., 0, [3, 7, 8, 20, 31]] = 0  # inside, at and after a shard edge (8), the last position
        batches[..., 1, [15, 16]] = 0
    return batches


def _jax_run(name):
    """JAX's init and three steps on the sequence-4 mesh: (params at init,
    losses, grad norms, params after)."""
    jcfg = jconfig.model_config("test", **CASES[name])
    mesh = make_mesh(jconfig.MeshConfig(data=1, sequence=WORLD), devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jcfg, mesh=mesh)
    jopt = jconfig.OptimizerConfig(**OPT)
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), 1)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(5), mesh, (B, T), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    step = jax_make_train_step(jmodel, tx, mesh, plan, 1, jax_make_schedule(jopt))
    losses, norms = [], []
    for batch in _batches(name):
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, and every case on the port's 4-rank ring in one world."""
    jax_runs = {name: _jax_run(name) for name in CASES}
    payload = {name: dict(model=CASES[name], params=jax_runs[name][0], opt=OPT, batches=list(_batches(name)))
               for name in CASES}
    ranks = _torch_dist.run_world("train_cases", payload, tmp_path_factory.mktemp("sp"), world=WORLD)
    return jax_runs, ranks


def _one_process(name, init):
    model = Transformer(tconfig.model_config("test", **CASES[name]), device="cpu")
    model.load_state_dict({n: torch.from_numpy(p) for n, p in init.items()})
    model.requires_grad_(True)
    opt_cfg = tconfig.OptimizerConfig(**OPT)
    schedule = make_schedule(opt_cfg)
    state = port_init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)
    losses, norms = [], []
    for batch in _batches(name):
        m = step(state, torch.from_numpy(batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("reference", ["jax_make_train_step", "port_one_process"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_train_step_matches(runs, name, reference):
    jax_runs, ranks = runs
    init, *jax_result = jax_runs[name]
    want = jax_result if reference == "jax_make_train_step" else _one_process(name, init)
    losses, norms, params = ranks[0][name]
    np.testing.assert_allclose(losses, want[0], rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(norms, want[1], rtol=ATOL, atol=ATOL)
    assert set(params) == set(want[2])
    for n, p in params.items():
        np.testing.assert_allclose(p, want[2][n], atol=ATOL, rtol=0, err_msg=f"{name} {n} vs {reference}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_hold_bit_equal_params(runs, name):
    _, ranks = runs
    first = ranks[0][name]
    for r in ranks[1:]:
        assert r[name][0] == first[0]  # the logged loss: the same sum on every rank
        for n, p in first[2].items():
            assert np.array_equal(r[name][2][n], p), n


def test_trainer_cli_under_torchrun_on_cpu(tmp_path):
    run_dir = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "zero_transformer_tpu_torch.train", "--cfg", str(ROOT / "configs" / "train_test.yaml"),
           "--device", "cpu", "--dist-backend", "gloo", "--max-steps", "4", "--set", "mesh.sequence=2",
           f"checkpoint.directory={run_dir}", "training.log_frequency=2", "training.evaluation_frequency=4",
           "training.maximum_evaluation_steps=1", "training.batch_size=2"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    assert [r["step"] for r in train] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["tokens_per_sec"] > 0 for r in train)
    assert any("validation/loss" in r for r in records)
    assert '"backend": "gloo"' in proc.stdout and '"ranks": 2' in proc.stdout
    # rank 0 alone logs: one line per log point
    assert proc.stdout.count("[step 4] loss=") == 1


def test_sequence_parallel_setup_refuses_what_it_cannot_run(monkeypatch):
    from zero_transformer_tpu_torch.parallel.mesh import init_distributed
    from zero_transformer_tpu_torch.training.trainer import Trainer, build_training

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(ROOT / "configs" / "train_test.yaml"),
                                         {"mesh.sequence": 2})
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 2"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="sequence group of that many ranks"):
        build_training(cfg, "cpu")
    with pytest.raises(ValueError, match="must equal mesh.sequence"):
        init_distributed(4, "gloo", "cpu", rank=0, world_size=2)
    with pytest.raises(ValueError, match="the CPU takes gloo"):
        init_distributed(2, "nccl", "cpu", rank=0, world_size=2)
    with pytest.raises(ValueError, match="backend"):
        init_distributed(2, "mpi", "cpu", rank=0, world_size=2)
