"""PyTorch port vs JAX reference: HuggingFace tokenizers from a local
directory (``serve.load_tokenizer``) in the serve CLI, ``data/prepare.py``
and the eval CLI, on the CPU.

The tokenizer is built here, in-process, with no download: a ``tokenizers``
BPE of 160 tokens (an ``<eos>`` special token included) trained on a small
corpus, wrapped in ``transformers.PreTrainedTokenizerFast`` and written
with ``save_pretrained`` to the test's temporary directory. Both packages
load that directory:

- ``serve --tokenizer <dir> --prompt ... --greedy`` prints JAX
  ``serve.main``'s text (the tokenizer's EOS ends generation on both);
- ``prepare --tokenizer <dir>`` writes JAX ``prepare``'s rows, documents
  encoded without special tokens and the tokenizer's EOS as separator;
- ``evalharness --tokenizer <dir>`` scores text fields (lambada targets and
  choices with a leading space, the choices' byte lengths, a text ``bpb``
  document) as JAX's eval CLI does;
- a name that is not a directory (a hub name) raises before anything is
  fetched, in all three; without ``transformers`` the error names the
  package.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu import serve as jax_serve
from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.data import prepare as jprepare
from zero_transformer_tpu.evalharness import cli as j_cli
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import serve
from zero_transformer_tpu_torch.data import prepare
from zero_transformer_tpu_torch.evalharness import cli

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta", "kappa", "lambda", "omega"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sentences(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, 6 + i % 5)) for i in range(n)]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(_sentences(200, 0), trainers.BpeTrainer(vocab_size=160,
                                                                     special_tokens=["<unk>", "<eos>"]))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token="<eos>")
    path = tmp_path_factory.mktemp("tok") / "tokenizer"
    fast.save_pretrained(str(path))
    assert fast.vocab_size <= 256
    return str(path)


def _params(tmp_path, zoo):
    """A zoo model's JAX init (times 4, so greedy rows vary) as a flax
    msgpack and as the port's ``.npz``."""
    from flax.serialization import msgpack_serialize
    from flax.traverse_util import flatten_dict

    params = JaxTransformer(jax_model_config(zoo, compute_dtype="float32")).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a) * (4.0 if a.ndim >= 2 else 1.0), unbox(params))
    msgpack = tmp_path / "p.msgpack"
    msgpack.write_bytes(msgpack_serialize(tree))
    npz = tmp_path / "p.npz"
    np.savez(npz, **{k: np.asarray(v, np.float32) for k, v in flatten_dict(tree, sep="/").items()})
    return str(msgpack), str(npz)


def test_serve_tokenizer_dir_prints_jax_text(tmp_path, tok_dir, capsys):
    msgpack, _ = _params(tmp_path, "test")
    for prompt in ("alpha beta gamma", "omega kappa"):
        argv = ["--model", "test", "--params", msgpack, "--dtype", "float32", "--tokenizer", tok_dir,
                "--prompt", prompt, "--greedy", "--max-new-tokens", "16"]
        jax_serve.main(argv)
        want = capsys.readouterr().out
        serve.main([*argv, "--device", "cpu"])
        got = capsys.readouterr().out
        assert got == want and len(got.strip()) > 0


def test_prepare_tokenizer_dir_rows_equal_jax(tmp_path, tok_dir):
    src = tmp_path / "src"
    src.mkdir()
    for i, text in enumerate(_sentences(12, 1)):
        (src / f"d{i}.txt").write_text(text * 3, encoding="utf-8")
    outs = {}
    for name, main in (("jax", jprepare.main), ("port", prepare.main)):
        out = tmp_path / name / "train.bin"
        main(["--input", str(src / "*.txt"), "--tokenizer", tok_dir, "--max-context", "16", "--format", "memmap",
              "--out", str(out)])
        outs[name] = out.read_bytes()
    assert outs["jax"] == outs["port"] and len(outs["port"]) > 0
    rows = np.frombuffer(outs["port"], np.uint16)
    from transformers import AutoTokenizer

    eos = AutoTokenizer.from_pretrained(tok_dir, local_files_only=True).eos_token_id
    assert (rows == eos).sum() > 0  # the EOS separates documents


def _eval_data(tmp_path):
    rng = np.random.default_rng(3)
    sents = _sentences(8, 2)
    lam = tmp_path / "lastword.jsonl"
    lam.write_text("".join(json.dumps({"context": s, "target": str(rng.choice(WORDS))}) + "\n" for s in sents))
    cho = tmp_path / "choice.jsonl"
    cho.write_text("".join(json.dumps({"context": s, "choices": list(rng.choice(WORDS, 3)), "gold": i % 3}) + "\n"
                           for i, s in enumerate(sents)))
    text = " ".join(sents)
    ppl = tmp_path / "ppl.json"
    ppl.write_text(json.dumps({"tokens": text, "num_bytes": len(text.encode())}))
    return {"lambada": lam, "choice": cho, "bpb": ppl}


@pytest.mark.parametrize("task", ["lambada", "choice", "bpb"])
def test_eval_cli_tokenizer_dir_scores_equal_jax(tmp_path, tok_dir, capsys, task):
    msgpack, npz = _params(tmp_path, "byte_2m")
    data = _eval_data(tmp_path)
    args = ["--model", "byte_2m", "--seq-len", "32", "--batch-size", "4", "--dtype", "float32", "--task", task,
            "--data", str(data[task]), "--tokenizer", tok_dir]
    j_cli.main(["--params", msgpack, *args])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(["--params", npz, "--device", "cpu", *args])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) | {"device"}
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
        else:
            assert got[key] == value, key


def test_hub_name_raises_before_any_fetch(tmp_path):
    with pytest.raises(NotImplementedError, match="not a local directory"):
        serve.load_tokenizer("EleutherAI/gpt-neox-20b")
    with pytest.raises(NotImplementedError, match="never resolves a hub name"):
        prepare.main(["--input", str(tmp_path / "*.txt"), "--tokenizer", "gpt2", "--out", str(tmp_path / "x")])
    with pytest.raises(NotImplementedError, match="not a local directory"):
        cli.main(["--model", "byte_2m", "--params", "p.npz", "--task", "bpb", "--data", "d.json", "--tokenizer",
                  "gpt2", "--device", "cpu"])


def test_missing_transformers_names_the_package(tok_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import transformers raises ImportError
    with pytest.raises(ImportError, match="'transformers' package"):
        serve.load_tokenizer(tok_dir)
    assert serve.load_tokenizer("bytes").encode("ab") == [97, 98]
