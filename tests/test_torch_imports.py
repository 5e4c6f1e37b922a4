"""Boundaries of the PyTorch/CUDA port.

- An AST scan of every module of ``zero_transformer_tpu_torch`` and of
  ``chip_smoke.py`` finds no import of jax, flax, yaml or the JAX package
  (a ``sys.modules`` check cannot work here: this interpreter imports jax
  at startup).
- Entry points default to CUDA and raise without it unless the caller
  passes ``device="cpu"``; ``chip_smoke.py`` exits non-zero and prints no
  result without a card, also when it is alone in a directory.
- The port's copy of the model zoo equals the JAX ``model_config``.
"""
import ast
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "zero_transformer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "yaml", "zero_transformer_tpu")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {p.relative_to(PACKAGE).as_posix() for p in SOURCES if PACKAGE in p.parents}
    assert {"ops/flash.py", "ops/paged_attention.py", "serving/engine.py", "serve.py"} <= names
    assert (PACKAGE / "csrc" / "flash_fwd.cu").exists()
    assert (PACKAGE / "csrc" / "paged_attention.cu").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from zero_transformer_tpu_torch import serve
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.serving import ServingEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        tconfig.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        model_getter("test")
    model = model_getter("test", device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, cache_len=32, prefill_chunk=16, page_size=8)
    ServingEngine(model, cache_len=32, prefill_chunk=16, page_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--model", "test", "--params", "absent.npz", "--server"])


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", sorted(tconfig.MODEL_ZOO))
def test_zoo_copy_matches_jax(name):
    port = tconfig.model_config(name)
    ref = jax_model_config(name)
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert (port.kv_heads, port.head_width, port.ff_dim) == (ref.kv_heads, ref.head_width, ref.ff_dim)


def test_serving_defaults_match_jax():
    from zero_transformer_tpu.config import ServingConfig as JaxServing

    port, ref = tconfig.ServingConfig(), JaxServing()
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert ref.kv_layout == "paged" and ref.draft_k == 0
