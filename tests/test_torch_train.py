"""PyTorch port vs JAX reference: the pieces of the training path.

Same seeded numpy inputs through the JAX function and the port's
counterpart on the CPU:

- ``cross_entropy_loss`` / ``next_token_loss`` with ``ignore_index`` and
  ``z_loss`` (float32 sums in another order: rtol 1e-6);
- ``make_schedule`` against optax at steps 0..N for all three schedules
  (rtol 1e-6: optax computes in float32, the port in Python floats);
- the weight-decay mask against JAX ``weight_decay_mask`` under the
  converter's names;
- clip + AdamW on identical grads against ``optax.chain(clip_by_global_norm,
  adamw)`` over 5 steps (params within two float32 ulps, rtol 2.4e-7, or
  5e-8 absolute: 1e-6 of the ~0.05 a param moves over the 5 steps);
- ``SyntheticSource`` / ``MemmapSource`` rows and ``DataLoader`` batches
  equal to JAX's for the same seed, split, striping and resume state;
- ``load_config`` against ``yaml.safe_load`` plus JAX ``load_config`` for
  every ``configs/train_*.yaml`` (the test may import yaml; the port may not).
"""
import dataclasses
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.data.loader import DataLoader as JaxLoader
from zero_transformer_tpu.data.sources import MemmapSource as JaxMemmap
from zero_transformer_tpu.data.sources import SyntheticSource as JaxSynthetic
from zero_transformer_tpu.data.sources import write_memmap
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.ops import losses as jlosses
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.training import optimizer as jopt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.data import DataLoader, MemmapSource, SyntheticSource, make_source
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.ops import losses as tlosses
from zero_transformer_tpu_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
TRAIN_CONFIGS = sorted(glob.glob(str(ROOT / "configs" / "train_*.yaml")))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------------- losses


@pytest.mark.parametrize("ignore_index,z_loss", [(None, 0.0), (-1, 0.0), (None, 1e-4), (3, 1e-3)])
def test_losses_match_jax(ignore_index, z_loss):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((2, 16, 40))).astype(np.float32)
    tokens = rng.integers(0, 40, (2, 16)).astype(np.int32)
    if ignore_index is not None:
        tokens[0, 3:7] = ignore_index
        tokens[1, -2:] = ignore_index
    for jf, tf in ((jlosses.cross_entropy_loss, tlosses.cross_entropy_loss),
                   (jlosses.next_token_loss, tlosses.next_token_loss)):
        want = float(jf(jnp.asarray(logits), jnp.asarray(tokens), ignore_index=ignore_index, z_loss=z_loss))
        got = float(tf(torch.from_numpy(logits), torch.from_numpy(tokens), ignore_index=ignore_index,
                       z_loss=z_loss))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # bf16 logits: the loss is computed in float32 from the rounded logits
    lb = torch.from_numpy(logits).bfloat16()
    want = float(jlosses.next_token_loss(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                         jnp.asarray(tokens), ignore_index=ignore_index, z_loss=z_loss))
    got = float(tlosses.next_token_loss(lb, torch.from_numpy(tokens), ignore_index=ignore_index, z_loss=z_loss))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------ schedule

SCHEDULES = {
    "warmup_cosine": dict(schedule="warmup_cosine", warmup_steps=10, total_steps=60),
    "warmup_cosine_decay_steps": dict(schedule="warmup_cosine", warmup_steps=5, decay_steps=20),
    "warmup_linear": dict(schedule="warmup_linear", warmup_steps=10, total_steps=40),
    "constant": dict(schedule="constant"),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    kw = dict(peak_learning_rate=6e-4, end_learning_rate=6e-5, **SCHEDULES[name])
    want_fn = jopt.make_schedule(jconfig.OptimizerConfig(**kw))
    got_fn = topt.make_schedule(tconfig.OptimizerConfig(**kw))
    steps = range(0, 80)
    want = np.array([float(want_fn(jnp.int32(s))) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if name.startswith("warmup"):
        assert got[0] == 0.0  # the first step changes no weights


# ----------------------------------------------------------------- optimizer


def _test_model_params(seed=0):
    jcfg = jconfig.model_config("test", dropout=0.0, compute_dtype="float32")
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, jax.tree.map(np.asarray, unbox(params))


def _port_model(tree):
    model = Transformer(tconfig.model_config("test", dropout=0.0, compute_dtype="float32"), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model.requires_grad_(True)


def test_weight_decay_mask_matches_jax():
    _, tree = _test_model_params()
    jmask = jopt.weight_decay_mask(tree)
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, tree)
    want = {n: bool(t.flatten()[0]) for n, t in params_from_jax(as_arrays).items()}
    got = topt.weight_decay_mask(_port_model(tree))
    assert got == want
    assert got["wte.embedding"] and got["blocks.0.mlp.wi.weight"] and not got["ln_f.scale"]


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_matches_optax_chain(grad_scale):
    cfg_kw = dict(peak_learning_rate=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1, grad_clip=1.0)
    jcfg = jconfig.OptimizerConfig(**cfg_kw)
    _, tree = _test_model_params(1)
    tx = jopt.make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    model = _port_model(tree)
    opt = topt.make_optimizer(model, tconfig.OptimizerConfig(**cfg_kw))
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(2)
    for _ in range(5):
        gtree = jax.tree.map(lambda p: (grad_scale * rng.standard_normal(p.shape)).astype(np.float32), tree)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, gtree), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = params_from_jax(gtree)
        norm = opt.step([grads[n] for n in names])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(gtree)), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=2.4e-7, atol=5e-8, err_msg=n)


def test_other_optimizers_raise():
    """Adafactor and Lion are ported (their parity with JAX is in
    test_torch_optimizers.py); a name outside the three raises, as in JAX."""
    model = _port_model(_test_model_params()[1])
    for name, cls in (("adafactor", topt.Adafactor), ("lion", topt.Lion)):
        assert isinstance(topt.make_optimizer(model, tconfig.OptimizerConfig(optimizer=name)), cls)
    with pytest.raises(ValueError, match="invalid optimizer"):
        tconfig.OptimizerConfig(optimizer="sgd")


# ---------------------------------------------------------------------- data


def test_synthetic_rows_match_jax():
    j, t = JaxSynthetic(vocab_size=50304, max_context=64, seed=24), SyntheticSource(50304, 64, seed=24)
    j.seek(5)
    t.seek(5)
    for a, b, _ in zip(iter(j), iter(t), range(8)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert j.state() == t.state()


def test_memmap_rows_match_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    write_memmap(np.random.default_rng(0).integers(0, 50304, 10 * 32 + 7), path)
    j, t = JaxMemmap(path, max_context=32, seed=3), MemmapSource(path, max_context=32, seed=3)
    for a, b, _ in zip(iter(j), iter(t), range(25)):  # crosses two epoch boundaries
        assert np.array_equal(a, b)
    assert j.state() == t.state()
    t.seek(13)
    j.seek(13)
    assert t.state() == j.state() and np.array_equal(next(iter(t)), next(iter(j)))


def test_memmap_path_missing_raises():
    cfg = tconfig.Config(data=tconfig.DataConfig(source="memmap", train_path="/nonexistent/train.bin"))
    with pytest.raises(FileNotFoundError):
        make_source(cfg)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("striping", [(0, 1), (1, 2)], ids=["one_process", "process_1_of_2"])
def test_loader_batches_and_resume_match_jax(striping, prefetch):
    p_idx, p_cnt = striping

    def pair():
        kw = dict(batch_size=4, train_context=16, accum_steps=2, process_index=p_idx,
                  process_count=p_cnt, prefetch=prefetch)
        return (JaxLoader(JaxSynthetic(256, 32, seed=1), **kw), DataLoader(SyntheticSource(256, 32, seed=1), **kw))

    j, t = pair()
    jit, tit = iter(j), iter(t)
    for _ in range(3):
        a, b = next(jit), next(tit)
        assert a.shape == b.shape == (2, 4 // p_cnt, 16) and np.array_equal(a, b)
    assert j.state() == t.state() == {"steps_consumed": 3}
    del jit, tit  # tear the read-ahead down: unseen batches are parked, not lost
    a, b = next(iter(j)), next(iter(t))
    assert np.array_equal(a, b)
    j2, t2 = pair()
    j2.restore(j.state())
    t2.restore(t.state())
    assert np.array_equal(next(iter(j2)), next(iter(t2)))


# -------------------------------------------------------------------- config


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=[Path(p).name for p in TRAIN_CONFIGS])
def test_load_config_matches_jax(path):
    text = Path(path).read_text()
    assert tconfig.read_yaml_subset(text, path) == yaml.safe_load(text)
    ref = jconfig.load_config(path)
    port = tconfig.load_config(path)  # every training config loads, loss_chunk and adafactor included
    for section in dataclasses.fields(port):
        p_sec, r_sec = getattr(port, section.name), getattr(ref, section.name)
        for f in dataclasses.fields(p_sec):
            assert getattr(p_sec, f.name) == getattr(r_sec, f.name), f"{section.name}.{f.name}"


def test_dotted_overrides_match_jax():
    path = str(ROOT / "configs" / "train_125m.yaml")
    over = {"data.source": "synthetic", "training.batch_size": 8, "training.gradient_accumulation_steps": 4,
            "model.attention_impl": "xla", "optimizer.warmup_steps": 5}
    ref = jconfig.apply_dotted_overrides(jconfig.load_config(path), over)
    port = tconfig.apply_dotted_overrides(tconfig.load_config(path), over)
    for section in ("model", "optimizer", "training", "data", "mesh"):
        p_sec, r_sec = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p_sec):
            assert getattr(p_sec, f.name) == getattr(r_sec, f.name), f"{section}.{f.name}"
    with pytest.raises(ValueError, match="unknown config field"):
        tconfig.apply_dotted_overrides(port, {"training.step_bench_artifact": "BENCH_step.json"})


def test_sequence_parallel_overrides_match_jax():
    """The ring's command line: configs/train_580m_8k.yaml with
    ``mesh.sequence=4 model.dropout=0.0`` loads field-equal in both."""
    path = str(ROOT / "configs" / "train_580m_8k.yaml")
    over = {"mesh.sequence": 4, "model.dropout": 0.0}
    ref = jconfig.apply_dotted_overrides(jconfig.load_config(path), over)
    port = tconfig.apply_dotted_overrides(tconfig.load_config(path), over)
    assert port.mesh.sequence == 4 and port.model.remat and port.model.cp_impl == "ring"
    for section in ("model", "mesh", "training", "data", "optimizer"):
        p_sec, r_sec = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p_sec):
            assert getattr(p_sec, f.name) == getattr(r_sec, f.name), f"{section}.{f.name}"


@pytest.mark.parametrize("text", [
    "model:\n  size: [1, 2]\n", "a:\n  b:\n    c: 1\n", "- item\n", "model:\n\tsize: test\n",
    "x: &anchor 3\n", "x: 010\n", "x: 0x1f\n", "a: 'it''s'\n",
], ids=["flow_list", "deep_nesting", "top_list", "tab", "anchor", "octal", "hex", "quote_escape"])
def test_yaml_subset_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tconfig.read_yaml_subset(text)


def test_yaml_subset_scalars_match_pyyaml():
    text = ("s:\n  a: 1\n  b: -2\n  c: 6.0e-4\n  d: 1.0e3\n  e: .5\n  f: true\n  g: Off\n  h: null\n"
            "  i: ~\n  j: runs/x  # trailing comment\n  k: 'quoted # not a comment'\n  l: \"dq\"\n"
            "  m: 1_000\n  n: -.inf\ntop: 3\nempty:\n")
    assert tconfig.read_yaml_subset(text) == yaml.safe_load(text)


def test_unported_training_features_raise():
    from zero_transformer_tpu_torch.training.trainer import build_training

    # the remat policies are ported: dots and qkv_mlp build and train; so is ulysses
    for policy in ("dots", "qkv_mlp"):
        cfg = tconfig.model_config("test", remat=True, remat_policy=policy)
        assert build_training(tconfig.Config(model=cfg), "cpu").state.model.cfg.remat_policy == policy
    assert tconfig.model_config("test", cp_impl="ulysses").cp_impl == "ulysses"
    # tensor parallelism is ported: the axis is validated, not refused
    assert tconfig.MeshConfig(tensor=2).tensor == 2
    with pytest.raises(ValueError, match="mesh.tensor"):
        tconfig.MeshConfig(tensor=0)
    # the chunked loss is ported: its chunk is validated as JAX does
    assert tconfig.model_config("test", loss_chunk=256).loss_chunk == 256
    for field in (dict(remat_policy="all"), dict(cp_impl="tree"), dict(loss_chunk=0)):
        with pytest.raises(ValueError):
            tconfig.model_config("test", **field)
    # remat (policy "none") and the ring engine are ported
    assert tconfig.model_config("test", remat=True).remat
    with pytest.raises(ValueError, match="sequence"):
        tconfig.MeshConfig(sequence=0)
    # packed documents are ported: the separator is validated, not refused
    assert tconfig.model_config("test", doc_sep_token=0).doc_sep_token == 0
    # dropout is ported: the zoo's 0.1 trains, and a training call names its masks' seed
    assert build_training(tconfig.Config(model=tconfig.model_config("test")), "cpu").state.model.cfg.dropout == 0.1
    model = Transformer(tconfig.model_config("test"), device="cpu")
    with pytest.raises(ValueError, match="dropout_key"):
        model(torch.zeros(1, 4, dtype=torch.long), train=True)
    # data parallelism and checkpoints are ported; the other mesh axes are not
    assert tconfig.MeshConfig(data=2).data == 2 and tconfig.CheckpointConfig(resume=True).resume
    with pytest.raises(ValueError, match="mesh.data"):
        tconfig.MeshConfig(data=0)
    assert tconfig.MeshConfig(data=2, tensor=2, sequence=2).tensor == 2
    for field in ("fsdp", "pipe", "dcn_data"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            tconfig.MeshConfig(**{field: 2})
    with pytest.raises(NotImplementedError, match="overlap"):
        tconfig.MeshConfig(overlap_comm=True)
    with pytest.raises(NotImplementedError):
        make_source(tconfig.Config(data=tconfig.DataConfig(source="hf")))
    # the tar source is ported: a missing index is a missing file, not a refusal
    with pytest.raises(FileNotFoundError):
        make_source(tconfig.Config(data=tconfig.DataConfig(source="tar", train_path="absent.index")))
