"""PyTorch port vs JAX reference: the eval harness, and the slice's CLIs on
tiny tar shards, on the CPU.

- The packed ``test`` model (``doc_sep_token=0``, float32), the port's
  weights converted from the JAX init: ``loglikelihoods`` per example
  within 1e-4 of JAX's log-probabilities with equal token counts and greedy
  matches; ``lambada``, ``choice_accuracy`` and ``perplexity`` within the
  same bar (the stream's total nll within 1e-4 per scored token) with equal
  accuracies. The padding is JAX's: token 0, which is also this model's
  separator.
- ``python -m zero_transformer_tpu_torch.evalharness --device cpu`` on the
  ``.npz`` of JAX-initialised ``byte_2m`` params gives the port's in-process
  numbers for every task; ``--tokenizer`` and ``--quantize int8`` raise.
- The trainer CLI trains and evaluates a packed byte model from tar shards
  that the port's ``prepare`` wrote, on ``--device cpu``.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.evalharness import choice_accuracy as j_choice
from zero_transformer_tpu.evalharness import lambada as j_lambada
from zero_transformer_tpu.evalharness import loglikelihoods as j_loglik
from zero_transformer_tpu.evalharness import perplexity as j_perplexity
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch import train as ttrain
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.data import prepare
from zero_transformer_tpu_torch.evalharness import choice_accuracy, cli, lambada, loglikelihoods, perplexity
from zero_transformer_tpu_torch.models.gpt import Transformer

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(dropout=0.0, compute_dtype="float32", doc_sep_token=0)
SEQ, BATCH = 48, 4
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxTransformer(jax_model_config("test", **MODEL))
    params = unbox(jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"])
    tree = jax.tree.map(np.asarray, params)
    port = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    port.load_state_dict(params_from_jax(tree))
    return jmodel, params, tree, port


def _examples(seed=0, n=7):
    """(context, continuation) pairs; one context longer than the window
    (cut from the left), one continuation holding a separator."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ctx = rng.integers(1, 256, 5 + 9 * i).tolist()
        cont = rng.integers(1, 256, 1 + i % 4).tolist()
        out.append((ctx, cont))
    out[2] = (out[2][0], [7, 0, 9])
    return out


def test_loglikelihoods_and_lambada_match_jax(models):
    jmodel, params, _, port = models
    ex = _examples()
    want = j_loglik(jmodel, params, ex, SEQ, BATCH)
    got = loglikelihoods(port, ex, SEQ, BATCH)
    assert len(got) == len(want) == len(ex)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["logprob"], w["logprob"], atol=ATOL, rtol=0)
        assert g["tokens"] == w["tokens"] and g["greedy_match"] == w["greedy_match"]
    j, t = j_lambada(jmodel, params, ex, SEQ, BATCH), lambada(port, ex, SEQ, BATCH)
    assert t["acc"] == j["acc"] and t["examples"] == j["examples"]
    np.testing.assert_allclose(t["ppl"], j["ppl"], rtol=1e-5)
    # a context the model predicts token by token: greedy matches happen
    prompt = list(range(1, 20))
    with torch.no_grad():
        nxt = port(torch.tensor([prompt])).argmax(-1)[0].tolist()
    hit = loglikelihoods(port, [(prompt[:-1] + [prompt[-1]], [nxt[-1]])], SEQ, BATCH)[0]
    assert hit["greedy_match"]


def _choices(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, 12).tolist(), [rng.integers(1, 256, 2 + c).tolist() for c in range(3)],
             i % 3, [2 + c for c in range(3)]) for i in range(n)]


@pytest.mark.parametrize("with_bytes", [True, False], ids=["bytes", "tokens"])
def test_choice_accuracy_matches_jax(models, with_bytes):
    jmodel, params, _, port = models
    ex = [e if with_bytes else e[:3] for e in _choices()]
    j, t = j_choice(jmodel, params, ex, SEQ, BATCH), choice_accuracy(port, ex, SEQ, BATCH)
    assert t == j


def test_perplexity_matches_jax(models):
    jmodel, params, _, port = models
    tokens = np.random.default_rng(2).integers(0, 256, 300).astype(np.int32)  # separators included
    j = j_perplexity(jmodel, params, tokens, SEQ, BATCH, num_bytes=300)
    t = perplexity(port, tokens, SEQ, BATCH, num_bytes=300)
    assert t["tokens"] == j["tokens"] == 299
    np.testing.assert_allclose(t["nll"], j["nll"], atol=ATOL * t["tokens"], rtol=0)
    np.testing.assert_allclose(t["bits_per_byte"], j["bits_per_byte"], rtol=1e-5)


def test_eval_cli_on_cpu(tmp_path, capsys):
    # a packed zoo model, as the CLI builds models by zoo name
    jcfg = jax_model_config("byte_2m", compute_dtype="float32")
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(np.asarray, unbox(params))
    port = Transformer(tconfig.model_config("byte_2m", compute_dtype="float32"), device="cpu")
    port.load_state_dict(params_from_jax(tree))
    npz = tmp_path / "p.npz"
    np.savez(npz, **{k: np.asarray(v, np.float32) for k, v in flatten_dict(tree, sep="/").items()})
    ex = _examples()
    lam = tmp_path / "lastword.jsonl"
    lam.write_text("".join(json.dumps({"context": c, "target": t}) + "\n" for c, t in ex))
    cho = tmp_path / "choice.jsonl"
    cho.write_text("".join(json.dumps({"context": c, "choices": ch, "gold": g, "choice_bytes": b}) + "\n"
                           for c, ch, g, b in _choices()))
    tokens = np.random.default_rng(2).integers(0, 256, 300).tolist()
    ppl = tmp_path / "ppl.jsonl"
    ppl.write_text(json.dumps({"tokens": tokens, "num_bytes": 300}))
    want = {"lambada": lambada(port, ex, SEQ, BATCH), "choice": choice_accuracy(port, _choices(), SEQ, BATCH),
            "bpb": perplexity(port, tokens, SEQ, BATCH, num_bytes=300)}
    base = ["--model", "byte_2m", "--params", str(npz), "--seq-len", str(SEQ), "--batch-size", str(BATCH),
            "--dtype", "float32", "--device", "cpu"]
    for task, data in (("lambada", lam), ("choice", cho), ("bpb", ppl)):
        cli.main([*base, "--task", task, "--data", str(data)])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["task"] == task and out["device"] == "cpu"
        for key, value in want[task].items():
            if isinstance(value, float):
                np.testing.assert_allclose(out[key], value, rtol=1e-6)
            else:
                assert out[key] == value, key
    with pytest.raises(NotImplementedError, match="tokenizer"):
        cli.main([*base, "--task", "lambada", "--data", str(lam), "--tokenizer", "gpt2"])
    with pytest.raises(NotImplementedError, match="int8"):
        cli.main([*base, "--task", "lambada", "--data", str(lam), "--quantize", "int8"])


def test_trainer_cli_trains_a_packed_model_from_tar_shards(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(12):
        (src / f"d{i}.txt").write_text(" ".join(["the", "port", "trains", "on", "bytes"][j % 5]
                                                for j in rng.integers(0, 5, 20 + 15 * i)))
    for split in ("train", "val"):
        prepare.main(["--input", str(src / "*.txt"), "--max-context", "64", "--format", "tar",
                      "--rows-per-shard", "8", "--doc-sep", "0", "--out", str(tmp_path / "data" / split)])
    run = tmp_path / "run"
    ttrain.main(["--cfg", str(ROOT / "configs" / "train_e2e_bytes.yaml"), "--device", "cpu", "--max-steps", "4",
                 "--set", "model.size=byte_2m", "model.n_layers=1", f"data.train_path={tmp_path}/data/train.index",
                 f"data.validation_path={tmp_path}/data/val.index", "data.max_context=64",
                 "training.train_context=64", "training.batch_size=2", "training.log_frequency=2",
                 "training.evaluation_frequency=4", "training.maximum_evaluation_steps=2",
                 "optimizer.warmup_steps=2", f"checkpoint.directory={run}"])
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    val = [r for r in records if "validation/loss" in r]
    assert [r["step"] for r in train] == [2, 4] and len(val) == 1
    assert all(np.isfinite(r["loss"]) for r in train) and np.isfinite(val[0]["validation/loss"])
    assert not any(k.startswith("data_") for r in train for k in r)  # no skipped shards or members
