"""Build and load the port's CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

and is loaded with ``ctypes``: every pointer and the stream cross as
``c_void_p``, ints as ``c_int``, and each C entry returns
``cudaGetLastError()``, which ``check`` turns into an exception. No source
includes PyTorch's headers, so a build takes seconds, not minutes.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them. Libraries are cached in ``build/kernels/`` (listed in ``.gitignore``)
under a hash of their source and flags, so an edited kernel rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of every kernel entry: name -> argtypes (restype is c_int)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_fwd": {
        # q, k, v, slopes, q_offset, segment_ids, o, lse,
        # dtype, B, T, S, H, KVH, D, scale, causal, alibi, stream
        "flash_fwd": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P],
    },
    "paged_attention": {
        # q, k_pool, v_pool, block_table, q_offset, slopes, o, part_o, part_ml,
        # dtype, B, T, H, KVH, D, page, n_blocks, scale, causal, alibi, stream
        "paged_attention": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_seconds: Dict[str, float] = {}
ptxas_report: Dict[str, str] = {}

# Launch counts, one per kernel wrapper: a wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels (the plain CPU versions never count).
LAUNCHES: Dict[str, int] = {"flash_serving_fwd": 0, "paged_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started, t0: float) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    ptxas_report[name] = log


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every (or the named) kernel source in parallel, one ``nvcc``
    per source, and load the libraries. Returns seconds per fresh build."""
    names = list(names or SIGNATURES)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        t0 = time.perf_counter()
        started = {n: _start(n) for n in todo}
        try:
            for n in todo:
                _finish(n, started[n], t0)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        for n in todo:
            _LIBS[n] = _load(n)
    return {n: build_seconds[n] for n in names if n in build_seconds}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
