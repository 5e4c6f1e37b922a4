"""PyTorch port vs JAX reference: text preparation and tar shards.

- The port's ``prepare`` CLI writes the same rows (``.npy`` members, in
  order) and the same ``.index`` as JAX ``data/prepare.py`` on the same
  input, in the tar and the memmap formats, with and without ``--doc-sep``;
  an HF tokenizer name raises.
- ``TarShardSource`` yields the same rows, and ``DataLoader`` the same
  batches, as JAX's for the same seed, shard shuffle, process striping and
  resume state; ``make_source`` builds it from a ``source: tar`` config and
  ``hf`` still raises.
"""
import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from zero_transformer_tpu.data import prepare as jprepare
from zero_transformer_tpu.data.loader import DataLoader as JaxLoader
from zero_transformer_tpu.data.tarshards import TarShardSource as JaxTarSource
from zero_transformer_tpu.data.tarshards import expand_braces as jax_expand
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.data import DataLoader, make_loader, make_source, prepare
from zero_transformer_tpu_torch.data.tarshards import TarShardSource, expand_braces, read_index

CTX = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _corpus(tmp_path: Path) -> str:
    """Three .txt documents and a .jsonl of four, ~3 KB in all, non-ASCII too."""
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "délta", "epsilon", "zeta", "ēta", "theta"]
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        (src / f"doc{i}.txt").write_text(" ".join(rng.choice(words, 40 + 30 * i)), encoding="utf-8")
    with open(src / "more.jsonl", "w", encoding="utf-8") as f:
        for i in range(4):
            f.write(json.dumps({"text": " ".join(rng.choice(words, 50 + 10 * i))}) + "\n")
    return str(src / "*")


def _tar_rows(index: Path):
    rows, names = [], []
    for shard in index.read_text().split():
        with tarfile.open(index.parent / shard) as tar:
            for m in tar.getmembers():
                names.append(m.name)
                rows.append(np.load(io.BytesIO(tar.extractfile(m).read())))
    return names, rows


@pytest.mark.parametrize("sep", [None, 0], ids=["no_sep", "sep0"])
def test_prepare_writes_the_same_shards_as_jax(tmp_path, sep):
    inputs = _corpus(tmp_path)
    extra = [] if sep is None else ["--doc-sep", str(sep)]
    outs = {}
    for name, main in (("jax", jprepare.main), ("port", prepare.main)):
        out = tmp_path / name / "train"
        main(["--input", inputs, "--tokenizer", "bytes", "--max-context", str(CTX), "--format", "tar",
              "--rows-per-shard", "7", "--out", str(out), *extra])
        main(["--input", inputs, "--max-context", str(CTX), "--format", "memmap",
              "--out", str(tmp_path / name / "train.bin"), *extra])
        outs[name] = out
    j_index, t_index = (Path(f"{outs[n]}.index") for n in ("jax", "port"))
    assert j_index.read_text() == t_index.read_text() and len(j_index.read_text().split()) > 2
    j_names, j_rows = _tar_rows(j_index)
    t_names, t_rows = _tar_rows(t_index)
    assert j_names == t_names and len(t_rows) > 14
    for a, b in zip(j_rows, t_rows):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert (sum(int((r == 0).sum()) for r in t_rows) > 0) == (sep == 0)
    assert (tmp_path / "jax" / "train.bin").read_bytes() == (tmp_path / "port" / "train.bin").read_bytes()
    with pytest.raises(NotImplementedError, match="byte tokenizer"):
        prepare.main(["--input", inputs, "--tokenizer", "gpt2", "--out", str(tmp_path / "x")])


def _shards(tmp_path: Path, n_shards=5, rows_per=6, ctx=CTX) -> Path:
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (n_shards * rows_per, ctx)).astype(np.int32)
    out = tmp_path / "shards" / "part"
    out.parent.mkdir()
    prepare.write_tar_shards(iter(rows), out, rows_per)
    return Path(f"{out}.index")


def test_expand_braces_and_index_match_jax(tmp_path):
    assert expand_braces("a-{008..011}-{1..2}.tar") == jax_expand("a-{008..011}-{1..2}.tar")
    index = _shards(tmp_path)
    assert read_index(index) == [str(index.parent / f"part-{i:05d}.tar.gz") for i in range(5)]
    with pytest.raises(NotImplementedError, match="local"):
        TarShardSource("gs://bucket/x-{0..3}.tar", max_context=CTX)


@pytest.mark.parametrize("p_idx,p_cnt", [(0, 1), (1, 2)], ids=["one_process", "striped"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "index_order"])
def test_tar_source_and_loader_match_jax(tmp_path, shuffle, p_idx, p_cnt):
    index = str(_shards(tmp_path))

    def pair(**kw):
        j = JaxTarSource(index, max_context=CTX, seed=5, shuffle_shards=shuffle, strict=True,
                         process_index=p_idx, process_count=p_cnt, **kw)
        t = TarShardSource(index, max_context=CTX, seed=5, shuffle_shards=shuffle, strict=True,
                           process_index=p_idx, process_count=p_cnt, **kw)
        return j, t

    j, t = pair()
    assert t.pre_striped == j.pre_striped == (p_cnt > 1)
    j_it, t_it = iter(j), iter(t)
    for _ in range(40):  # past one epoch: the shard order reshuffles
        assert np.array_equal(next(j_it), next(t_it))
    assert t.state() == j.state()

    def loaders():
        js, ts = pair()
        kw = dict(batch_size=4, train_context=CTX // 2, accum_steps=2, process_index=p_idx,
                  process_count=p_cnt)
        return JaxLoader(js, **kw), DataLoader(ts, **kw)

    jl, tl = loaders()
    jb, tb = iter(jl), iter(tl)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert a.shape == b.shape == (2, 4 // p_cnt, CTX // 2) and np.array_equal(a, b)
    j2, t2 = loaders()
    j2.restore(jl.state())
    t2.restore(tl.state())
    assert np.array_equal(next(iter(j2)), next(iter(t2)))


def test_make_source_builds_tar_and_refuses_hf(tmp_path):
    index = str(_shards(tmp_path))
    data = tconfig.DataConfig(source="tar", train_path=index, validation_path=index, max_context=CTX,
                              strict=True, num_workers=0)
    cfg = tconfig.Config(data=data, training=tconfig.TrainingConfig(batch_size=2, train_context=CTX))
    train, val = make_source(cfg), make_source(cfg, validation=True)
    assert isinstance(train, TarShardSource) and train.shuffle_shards and not val.shuffle_shards
    assert train.strict and train.process_count == 1
    batch = next(iter(make_loader(cfg)))
    assert batch.shape == (1, 2, CTX) and batch.dtype == np.int32
    with pytest.raises(NotImplementedError, match="hf"):
        make_source(tconfig.Config(data=tconfig.DataConfig(source="hf")))
