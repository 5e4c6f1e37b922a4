"""PyTorch port vs JAX reference: checkpoints.

Mirrors ``tests/test_checkpoint.py`` for the port's format (one step
directory of safetensors files and ``meta.json``, ``checkpoint.py``):

- a bit-exact round trip of the params and AdamW moments, the meta kept;
- keep-N and the save-frequency gate;
- a partial step directory is never the restore target;
- a truncated, bit-flipped or unreadable step is quarantined and restore
  falls back to the newest verified step; a tombstone where the rename
  fails; every step corrupt raises; a checkpoint of another model is a
  fatal config error, not quarantined; a transient error is re-raised;
- the port's digests equal JAX ``tree_digests`` on converted params (per
  JAX leaf, the wrap-sum of the port tensors made from it);
- flax msgpack both ways: JAX ``export_params_msgpack`` -> port, and port
  -> JAX ``import_params_msgpack``;
- a CPU trainer run saved and resumed at step 3 equals the uninterrupted
  run bit for bit; warm init from a step directory and from msgpack; the
  eval CLI scores a step directory as it scores the same weights' ``.npz``.
"""
import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from zero_transformer_tpu import checkpoint as jckpt
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import checkpoint as ckpt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax, params_to_jax, read_params_tree
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.mesh import single_process
from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
from zero_transformer_tpu_torch.resilience.detect import leaf_checksum
from zero_transformer_tpu_torch.training.optimizer import make_schedule

ROOT = Path(__file__).resolve().parent.parent
TRAIN_TEST = ROOT / "configs" / "train_test.yaml"
MODEL = dict(dropout=0.0, compute_dtype="float32")
OPT = tconfig.OptimizerConfig(peak_learning_rate=1e-3, warmup_steps=1, total_steps=64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(seed=3):
    jmodel = JaxTransformer(jconfig.model_config("test", **MODEL))
    return unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


def _state(steps=2, seed=3):
    """A one-process ZeRO state of the test model after ``steps`` steps
    (moments nonzero)."""
    model = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, _jax_params(seed))))
    model.requires_grad_(True)
    schedule = make_schedule(OPT)
    state = init_train_state(model, OPT, schedule, single_process("cpu").data, 1)
    step = make_train_step(1, schedule)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, torch.from_numpy(rng.integers(0, 256, (1, 2, 16)).astype(np.int32)))
    return state


def _leaves(state):
    return {k: v.clone() for k, v in state.shards.state_leaves().items()}


def _mgr(root, **kw):
    return ckpt.CheckpointManager(root, **{"keep": 5, "save_frequency": 1, "async_save": False, **kw})


def test_roundtrip_is_bit_exact(tmp_path):
    state = _state()
    leaves = _leaves(state)
    mgr = _mgr(tmp_path / "ck", async_save=True)
    assert mgr.save(2, leaves, meta={"loader": {"steps_consumed": 7}, "opt_count": 2}, force=True)
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "ck" / "2").iterdir()) == ["meta.json", "opt_state.safetensors",
                                                                        "params.safetensors"]
    restored, meta = mgr.restore()
    assert set(restored) == set(leaves) and meta["loader"] == {"steps_consumed": 7} and meta["step"] == 2
    for k, v in leaves.items():
        assert torch.equal(restored[k], v), k
    assert any(torch.count_nonzero(v) for k, v in restored.items() if k.startswith("opt_state/mu/"))
    # into a fresh state: the same bits, the optimizer count carried
    fresh = _state(steps=0, seed=4)
    fresh.shards.load_leaves(restored, meta["opt_count"])
    assert fresh.optimizer.count == 2
    for k, v in _leaves(fresh).items():
        assert torch.equal(v, leaves[k]), k
    mgr.close()


def test_latest_step_and_keep(tmp_path):
    leaves = _leaves(_state(steps=0))
    mgr = _mgr(tmp_path / "ck", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, leaves, force=True)
    assert mgr.latest_step() == 4 and mgr.all_steps() == [3, 4]


def test_save_frequency_gate(tmp_path):
    leaves = _leaves(_state(steps=0))
    mgr = _mgr(tmp_path / "ck", save_frequency=5)
    assert not mgr.save(0, leaves)  # never step 0 on the cadence
    assert not mgr.save(3, leaves)
    assert mgr.save(5, leaves) and mgr.save(10, leaves)
    assert mgr.save(7, leaves, force=True)
    assert mgr.all_steps() == [5, 7, 10]


def test_latest_step_skips_partial_dir(tmp_path):
    leaves = _leaves(_state(steps=0))
    mgr = _mgr(tmp_path / "ck")
    mgr.save(1, leaves, force=True)
    mgr.save(2, leaves, force=True)
    (tmp_path / "ck" / "4").mkdir()  # empty: a copy cut short
    (tmp_path / "ck" / "8").mkdir()
    shutil.copy(tmp_path / "ck" / "2" / "meta.json", tmp_path / "ck" / "8")  # meta without tensors
    (tmp_path / "ck" / ".tmp-9-123").mkdir()  # a write in progress
    mgr2 = _mgr(tmp_path / "ck")
    assert mgr2.latest_step() == 2 and mgr2.all_steps() == [1, 2] and mgr2.incomplete_steps() == [4, 8]
    restored, _, report = mgr2.restore_verified(_state(steps=0).shards.target())
    assert report.step == 2 and report.quarantined == []
    # a new save of step 8 moves the partial aside first
    assert mgr2.save(8, leaves)
    assert mgr2.latest_step() == 8 and (tmp_path / "ck" / "8.quarantined").exists()


def _corrupt(step_dir: Path, mode: str) -> None:
    if mode == "truncate":
        path = step_dir / "params.safetensors"
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    elif mode == "bitflip":  # one bit of one weight, past the header
        path = step_dir / "params.safetensors"
        data = bytearray(path.read_bytes())
        header = 8 + int.from_bytes(data[:8], "little")
        data[header + (len(data) - header) // 2] ^= 0x10
        path.write_bytes(bytes(data))
    else:  # unreadable metadata
        (step_dir / "meta.json").write_text("{not json")


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "meta"])
def test_corrupt_step_quarantined_with_fallback(tmp_path, mode):
    good, newer = _state(steps=1), _state(steps=2)
    root = tmp_path / f"ck_{mode}"
    mgr = _mgr(root)
    mgr.save(1, _leaves(good), force=True)
    mgr.save(2, _leaves(newer), force=True)
    _corrupt(root / "2", mode)
    events = []
    restored, meta, report = mgr.restore_verified(good.shards.target(),
                                                  on_event=lambda name, step, **f: events.append((name, step)))
    assert report.step == 1 and report.quarantined == [2] and report.fallback_steps == 1
    assert meta["step"] == 1
    for k, v in _leaves(good).items():
        assert torch.equal(restored[k], v), k
    assert ("ckpt_quarantined", 2) in events and ("restore_fallback", 1) in events
    assert (root / "2.quarantined").exists() and mgr.latest_step() == 1


def test_quarantine_tombstones_in_place_when_rename_unsupported(tmp_path, monkeypatch):
    good = _state(steps=1)
    root = tmp_path / "ck_tomb"
    mgr = _mgr(root)
    mgr.save(1, _leaves(good), force=True)
    mgr.save(2, _leaves(good), force=True)
    _corrupt(root / "2", "truncate")
    real_rename = Path.rename

    def deny(self, target):
        if str(self) == str(root / "2"):
            raise OSError("rename of directories is not supported")
        return real_rename(self, target)

    monkeypatch.setattr(Path, "rename", deny)
    _, _, report = mgr.restore_verified(good.shards.target())
    assert report.step == 1 and report.quarantined == [2]
    assert (root / "2" / "_QUARANTINED").exists() and mgr.latest_step() == 1


def test_all_steps_corrupt_raises_actionable_error(tmp_path):
    state = _state(steps=0)
    mgr = _mgr(tmp_path / "ck_dead")
    mgr.save(1, _leaves(state), force=True)
    _corrupt(tmp_path / "ck_dead" / "1", "truncate")
    with pytest.raises(FileNotFoundError, match="no verified checkpoint"):
        mgr.restore_verified(state.shards.target())
    assert (tmp_path / "ck_dead" / "1.quarantined").exists()


def test_manifest_structural_mismatch_is_fatal_not_quarantine(tmp_path):
    mgr = _mgr(tmp_path / "ck")
    mgr.save(1, _leaves(_state(steps=0)), force=True)
    other = Transformer(tconfig.model_config("test", **MODEL, d_model=128, n_heads=8), device="cpu")
    other_state = init_train_state(other.requires_grad_(True), OPT, make_schedule(OPT),
                                   single_process("cpu").data, 1)
    with pytest.raises(ValueError, match="different model/optimizer"):
        mgr.restore_verified(other_state.shards.target())
    assert mgr.latest_step() == 1  # not quarantined


def test_transient_error_is_reraised_with_the_step_intact(tmp_path, monkeypatch):
    state = _state(steps=0)
    mgr = _mgr(tmp_path / "ck")
    mgr.save(1, _leaves(state), force=True)

    def flaky(path, device):
        raise TimeoutError("connection timed out")

    monkeypatch.setattr(ckpt, "_load_safetensors", flaky)
    with pytest.raises(TimeoutError):
        mgr.restore_verified(state.shards.target())
    assert mgr.latest_step() == 1 and not (tmp_path / "ck" / "1.quarantined").exists()


def _port_names(jax_key: str, n_layers: int):
    """The port tensors ``params_from_jax`` makes from one JAX leaf."""
    parts = jax_key.split("/")
    if parts[0] != "blocks":
        return [".".join(parts[:-1] + ["weight" if parts[-1] == "kernel" else parts[-1]])]
    leaf = "weight" if parts[-1] == "kernel" else parts[-1]
    return [".".join(["blocks", str(i), *parts[1:-1], leaf]) for i in range(n_layers)]


def test_port_digests_equal_jax_tree_digests():
    params = jax.tree.map(np.asarray, _jax_params())
    jax_digests = jckpt.tree_digests(params)
    port = params_from_jax(params)
    port_digests = ckpt.tree_digests(port)
    flat = flatten_dict(params, sep="/")
    for (key, _), (keypath, digest) in zip(sorted(flat.items()), sorted(jax_digests.items())):
        assert keypath == "".join(f"['{p}']" for p in key.split("/"))
        names = _port_names(key, 2)
        assert sum(port_digests[n] for n in names) % 2**32 == digest, key
    # the manifest carries the same digests
    manifest = ckpt.build_manifest({f"params/{n}": t for n, t in port.items()})
    assert all(manifest["leaves"][f"params/{n}"]["sum"] == d for n, d in port_digests.items())
    # one flipped bit changes the digest
    t = port["wte.embedding"].clone()
    t.view(torch.int32)[5] ^= 1 << 20
    assert leaf_checksum(t) != port_digests["wte.embedding"]


def test_msgpack_from_jax_export_and_back_to_jax_import(tmp_path):
    params = jax.tree.map(np.asarray, _jax_params())
    path = jckpt.export_params_msgpack(params, tmp_path / "jax.msgpack")
    port = params_from_jax(ckpt.import_params_msgpack(path))
    want = params_from_jax(params)
    assert set(port) == set(want)
    for n, t in port.items():
        assert torch.equal(t, want[n]), n
    out = ckpt.export_params_msgpack(params_to_jax(port), tmp_path / "port.msgpack")
    back = flatten_dict(jckpt.import_params_msgpack(out), sep="/")
    ref = flatten_dict(params, sep="/")
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # and the same bytes read through the eval/serve reader
    tree = read_params_tree(str(out))
    assert all(np.array_equal(tree[k], v) for k, v in ref.items())


def _trainer_cfg(run_dir, **over):
    base = {"checkpoint.directory": str(run_dir), "checkpoint.save_frequency": 3, "checkpoint.async_save": True,
            "training.total_steps": 6, "training.log_frequency": 1, "training.evaluation_frequency": 0,
            "training.batch_size": 4, "data.num_workers": 2, "optimizer.warmup_steps": 1}
    return tconfig.apply_dotted_overrides(tconfig.load_config(TRAIN_TEST), {**base, **over})


def _params_of(run_dir, step):
    return ckpt.CheckpointManager(run_dir).restore_params(step)


def test_trainer_resume_equals_uninterrupted_run_bit_for_bit(tmp_path, capsys):
    from zero_transformer_tpu_torch.training.trainer import Trainer

    whole = Trainer(_trainer_cfg(tmp_path / "whole"), device="cpu")
    whole.train()
    whole.close()
    first = Trainer(_trainer_cfg(tmp_path / "cut"), device="cpu")
    first.train(max_steps=3)
    first.close()
    assert ckpt.CheckpointManager(tmp_path / "cut").all_steps() == [3]
    resumed = Trainer(_trainer_cfg(tmp_path / "cut", **{"checkpoint.resume": True}), device="cpu")
    assert resumed.state.step == 3 and resumed.train_loader.steps_consumed == 3
    resumed.train()
    resumed.close()
    assert '"resumed": {"step": 3' in capsys.readouterr().out
    for run in ("whole", "cut"):
        assert ckpt.CheckpointManager(tmp_path / run).all_steps() == [3, 6]
    a, b = _params_of(tmp_path / "whole", 6), _params_of(tmp_path / "cut", 6)
    for n, t in a.items():
        assert torch.equal(t, b[n]), n
    losses = {}
    for run in ("whole", "cut"):
        records = [json.loads(x) for x in (tmp_path / run / "metrics.jsonl").read_text().splitlines()]
        losses[run] = {r["step"]: r["loss"] for r in records if "loss" in r}
    assert losses["whole"] == losses["cut"]
    records = [json.loads(x) for x in (tmp_path / "whole" / "metrics.jsonl").read_text().splitlines()]
    # the digest time of the save at step 3, logged from then on
    assert [r["step"] for r in records if "ckpt_verify_ms" in r] == [4, 5, 6]


def test_warm_init_from_a_step_dir_and_from_msgpack(tmp_path):
    from zero_transformer_tpu_torch.training.trainer import Trainer

    donor = Trainer(_trainer_cfg(tmp_path / "donor", **{"training.total_steps": 2}), device="cpu")
    donor.train()
    donor.close()
    want = _params_of(tmp_path / "donor", 2)
    path = ckpt.export_params_msgpack(params_to_jax(want), tmp_path / "donor.msgpack")
    for over in ({"checkpoint.warm_init_dir": str(tmp_path / "donor")},
                 {"checkpoint.warm_init_msgpack": str(path)}):
        t = Trainer(_trainer_cfg(tmp_path / "warm", **{"checkpoint.warm_init": True, **over}), device="cpu")
        assert t.state.step == 0 and t.state.optimizer.count == 0
        for n, p in t.state.model.named_parameters():
            assert torch.equal(p.detach(), want[n]), n
        t.close()
    deeper = {"checkpoint.warm_init": True, "checkpoint.warm_init_dir": str(tmp_path / "donor")}
    cfg = _trainer_cfg(tmp_path / "deep", **deeper)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, n_layers=3))
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        Trainer(cfg, device="cpu")


def test_eval_cli_scores_a_step_dir_as_its_npz(tmp_path, capsys):
    from zero_transformer_tpu_torch.evalharness import cli as eval_cli
    from zero_transformer_tpu_torch.training.trainer import Trainer

    t = Trainer(_trainer_cfg(tmp_path / "run", **{"training.total_steps": 2}), device="cpu")
    t.train()
    t.close()
    step_dir = tmp_path / "run" / "2"
    np.savez(tmp_path / "p.npz", **params_to_jax(_params_of(tmp_path / "run", 2)))
    tokens = np.random.default_rng(0).integers(0, 256, 200).tolist()
    (tmp_path / "ppl.json").write_text(json.dumps({"tokens": tokens, "num_bytes": 200}))
    scores = []
    for params in (str(step_dir), str(tmp_path / "p.npz")):
        eval_cli.main(["--model", "test", "--params", params, "--task", "bpb", "--data",
                       str(tmp_path / "ppl.json"), "--seq-len", "32", "--device", "cpu", "--dtype", "float32"])
        scores.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert scores[0] == scores[1] and np.isfinite(scores[0]["bits_per_byte"])
    with pytest.raises(FileNotFoundError, match="step directory"):
        read_params_tree(str(tmp_path / "run"))
