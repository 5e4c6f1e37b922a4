"""PyTorch port vs JAX reference: elastic resume.

- ``remap_loader_state`` equals JAX's on the cases of
  ``tests/test_elastic.py`` (same geometry, token-count remap, accumulation,
  legacy metadata);
- ``topology_summary`` writes JAX's format, and ``check_elastic_compat``
  refuses the topologies JAX refuses with JAX's message and notes what
  changed for the others;
- the trainer (``configs/train_test.yaml``, the ``test`` model in float32)
  saves at step 2 on 4 gloo ranks at ZeRO stage 2, and resumes from that
  step at data 4 (the params and the losses of steps 3-4 bit-equal to the
  uninterrupted run), at data 2 x sequence 2, at data 2 on a world of 2
  ranks at stage 3, and on one process: the loss continues within 1e-5 of
  the uninterrupted run's.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.parallel import sharding as jshd
from zero_transformer_tpu.parallel.mesh import make_mesh
from zero_transformer_tpu.training.trainer import remap_loader_state as jax_remap
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.parallel import sharding as shd
from zero_transformer_tpu_torch.training.trainer import Trainer, remap_loader_state

ROOT = Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "configs" / "train_test.yaml")
STEPS, ATOL = 4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


REMAP_CASES = [  # (meta, batch_size, train_context, accum)
    ({"loader": {"steps_consumed": 7}, "schedule": {"batch_size": 8, "train_context": 16}}, 8, 16, 1),
    ({"loader": {"steps_consumed": 7}, "schedule": {"batch_size": 8, "train_context": 16}}, 16, 16, 1),
    ({"loader": {"steps_consumed": 8}, "schedule": {"batch_size": 8, "train_context": 16}}, 16, 16, 1),
    ({"loader": {"steps_consumed": 6}, "schedule": {"batch_size": 8, "train_context": 16, "accum_steps": 1}},
     4, 16, 2),
    ({"loader": {"steps_consumed": 6}, "schedule": {"batch_size": 8, "train_context": 16, "accum_steps": 1}},
     8, 16, 2),
    ({"loader": {"steps_consumed": 5}}, 8, 16, 1),
    ({}, 8, 16, 1),
    ({"loader": {"steps_consumed": 9}, "schedule": {"batch_size": 4, "train_context": 32, "accum_steps": 2}},
     8, 16, 1),
]


@pytest.mark.parametrize("case", range(len(REMAP_CASES)))
def test_remap_loader_state_matches_jax(case):
    meta, bs, ctx, accum = REMAP_CASES[case]
    assert remap_loader_state(meta, bs, ctx, accum) == jax_remap(meta, bs, ctx, accum)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_topology_summary_is_jax_format(devices, n):
    """The same keys and values, but the process count: the port runs one
    process per rank, these JAX meshes one process for all devices."""
    mesh = make_mesh(jconfig.MeshConfig(zero_stage=2), devices=devices[:n])
    assert shd.topology_summary(n, 1, 2) == {**jshd.topology_summary(mesh, 2), "processes": n}


def test_incompatible_batch_refused_with_jax_message(devices):
    saved = jshd.topology_summary(make_mesh(jconfig.MeshConfig(), devices=devices), 1)
    mesh3 = make_mesh(jconfig.MeshConfig(), devices=devices[:3])
    with pytest.raises(ValueError) as want:
        jshd.check_elastic_compat(saved, mesh3, 1, global_batch=8)
    with pytest.raises(ValueError, match="not\\s+divisible by the new data-parallel") as got:
        shd.check_elastic_compat(saved, 3, 1, 1, global_batch=8)
    assert str(got.value) == str(want.value)


def test_compat_notes_describe_topology_change():
    saved = shd.topology_summary(8, 1, 1)
    joined = "\n".join(shd.check_elastic_compat(saved, 4, 1, 2, global_batch=8))
    assert "8 -> 4" in joined and "zero_stage 1 -> 2" in joined and "process count 8 -> 4" in joined
    assert "'sequence': 2" in "\n".join(shd.check_elastic_compat(saved, 4, 2, 1, global_batch=8))
    assert shd.check_elastic_compat(saved, 8, 1, 1, global_batch=8) == []
    assert shd.check_elastic_compat(None, 4, 1, 1, global_batch=8) == []


def _overrides(run_dir, **more):
    return {"checkpoint.directory": str(run_dir), "checkpoint.save_frequency": 2, "checkpoint.async_save": False,
            "training.total_steps": STEPS, "training.log_frequency": 1, "training.evaluation_frequency": 0,
            "optimizer.warmup_steps": 1, "model.compute_dtype": "float32", "mesh.zero_stage": 2, **more}


def _losses(metrics, after=0):
    """Loss by step; a resumed run's file starts with the copied run's lines."""
    return {r["step"]: r["loss"] for r in metrics if "loss" in r and r["step"] > after}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    cut = root / "cut"
    world4 = [
        dict(config=CONFIG, overrides=_overrides(root / "whole")),
        dict(config=CONFIG, overrides=_overrides(cut), max_steps=2),
        dict(config=CONFIG, overrides=_overrides(root / "d4", **{"checkpoint.resume": True}),
             copy=[(str(cut), str(root / d)) for d in ("d4", "d2s2", "d2", "d1")]),
        dict(config=CONFIG, mesh=(2, 2), overrides=_overrides(root / "d2s2", **{
            "checkpoint.resume": True, "mesh.data": 2, "mesh.sequence": 2})),
    ]
    four = _torch_dist.run_world("trainer_runs", world4, root / "world4", world=4, sequence=1)
    two = _torch_dist.run_world("trainer_runs", [dict(config=CONFIG, overrides=_overrides(root / "d2", **{
        "checkpoint.resume": True, "mesh.zero_stage": 3}))], root / "world2", world=2, sequence=1)
    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(CONFIG),
                                         _overrides(root / "d1", **{"checkpoint.resume": True}))
    one = Trainer(cfg, device="cpu")
    assert one.state.step == 2
    one.train()
    one.close()
    metrics = [json.loads(x) for x in (root / "d1" / "metrics.jsonl").read_text().splitlines()]
    params = {n: p.detach().numpy().copy() for n, p in one.state.model.named_parameters()}
    return {"whole": four[0][0], "cut": four[0][1], "d4": four[0][2], "d2s2": four[0][3], "d2": two[0][0],
            "d1": {"metrics": metrics, "params": params, "step": one.state.step}, "ranks4": four, "ranks2": two}


def test_uninterrupted_run_and_the_save(runs):
    assert runs["whole"]["step"] == STEPS and runs["cut"]["step"] == 2
    assert sorted(_losses(runs["whole"]["metrics"])) == [1, 2, 3, 4]


def test_resume_at_data4_is_bit_equal(runs):
    whole, resumed = runs["whole"], runs["d4"]
    want = _losses(whole["metrics"])
    assert _losses(resumed["metrics"], after=2) == {3: want[3], 4: want[4]}
    for n, p in whole["params"].items():
        assert np.array_equal(resumed["params"][n], p), n


@pytest.mark.parametrize("name", ["d2s2", "d2", "d1"])
def test_elastic_resume_continues_the_loss(runs, name):
    """Resumed at another topology from the data-4 save at step 2: the
    losses of steps 3 and 4 within 1e-5 of the uninterrupted run's."""
    want = _losses(runs["whole"]["metrics"])
    got = _losses(runs[name]["metrics"], after=2)
    assert runs[name]["step"] == STEPS and sorted(got) == [3, 4]
    np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]], rtol=ATOL, atol=ATOL)
    for n, p in runs["whole"]["params"].items():
        np.testing.assert_allclose(runs[name]["params"][n], p, atol=ATOL, rtol=0, err_msg=n)


def test_ranks_end_bit_equal(runs):
    for ranks in (runs["ranks4"], runs["ranks2"]):
        for r in ranks[1:]:
            for run_first, run_r in zip(ranks[0], r):
                for n, p in run_first["params"].items():
                    assert np.array_equal(run_r["params"][n], p), n


def test_trainer_cli_data_parallel_under_torchrun_saves_and_resumes(tmp_path):
    """``--set mesh.data=2`` under ``torch.distributed.run`` on the CPU
    (gloo): 2 steps and a save, then a second launch with
    ``checkpoint.resume=True`` takes steps 3-4 from it."""
    import os
    import subprocess
    import sys

    run_dir = tmp_path / "run"

    def launch(max_steps, *sets):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
               "-m", "zero_transformer_tpu_torch.train", "--cfg", CONFIG, "--device", "cpu",
               "--max-steps", str(max_steps), "--set", "mesh.data=2", "mesh.zero_stage=2",
               f"checkpoint.directory={run_dir}", "training.log_frequency=1", "training.evaluation_frequency=0",
               "optimizer.warmup_steps=1", *sets]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        return proc.stdout

    out = launch(2)
    assert '"data": 2' in out and '"backend": "gloo"' in out
    assert sorted(p.name for p in run_dir.iterdir() if p.is_dir()) == ["2"]
    out = launch(2, "checkpoint.resume=True")
    assert '"resumed": {"step": 2' in out and out.count("[step 4] loss=") == 1  # rank 0 alone logs
    steps = [json.loads(x)["step"] for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4]
    assert sorted(p.name for p in run_dir.iterdir() if p.is_dir()) == ["2", "4"]
