"""Checkpoints: step directories of whole tensors, integrity manifests,
verified restore with quarantine and fallback, and JAX's msgpack params.

Counterpart of ``zero_transformer_tpu/checkpoint.py`` (:44-723). The port
cannot use orbax (it imports JAX), so the format is its own::

    <directory>/<step>/params.safetensors    the params by name (float32)
    <directory>/<step>/opt_state.safetensors the optimizer's state by name:
                                             ``mu/<name>`` and ``nu/<name>``
                                             (AdamW), ``mu/<name>`` (Lion),
                                             ``v_row/<name>``, ``v_col/<name>``
                                             and ``v/<name>`` (Adafactor)
    <directory>/<step>/meta.json             step, optimizer count, loader
                                             state, batch geometry, flat
                                             config, topology, manifest

Tensors are saved whole and by name, whatever the world size: the caller
gathers the ZeRO shards and one process writes (``parallel/zero.py``,
``training/trainer.py``), as JAX's manifest describes logical arrays, so a
restore onto another world is a re-slice. A step is written into a
temporary directory (``.tmp-<step>-<pid>``) and renamed when complete, so a
numeric directory missing a file (a copy cut short, a hand-made partial) is
never a restore candidate (JAX ``_step_complete`` :642).

The manifest holds, per tensor, its shape, dtype and digest
(``resilience/detect.py::leaf_checksum``, the uint32 wrap-sum of its bits,
equal to JAX's for the same logical array). ``restore_verified`` rejects a
step saved for another model (fatal, not quarantined), re-digests what it
read, and quarantines a step that fails (renamed to ``<step>.quarantined``,
or a ``_QUARANTINED`` tombstone where the rename fails), falling back to the
newest older step that verifies; an error that looks transient is re-raised
with the directory intact.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from zero_transformer_tpu_torch.resilience.detect import leaf_checksum

log = logging.getLogger("zero_transformer_tpu_torch")

PARAMS_FILE, OPT_FILE, META_FILE = "params.safetensors", "opt_state.safetensors", "meta.json"
TOMBSTONE = "_QUARANTINED"


class CheckpointCorruptError(RuntimeError):
    """A step directory failed integrity verification (truncated files,
    digest mismatch, unreadable metadata) and could not be taken out of the
    candidates. ``CheckpointManager.restore_verified`` quarantines such a
    step and falls back; this escapes only when the quarantine fails."""


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def tree_digests(leaves: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Per-tensor digests by name: ``leaf_checksum`` of each, on its device."""
    return {k: leaf_checksum(v) for k, v in leaves.items()}


def build_manifest(leaves: Mapping[str, torch.Tensor]) -> dict:
    """The integrity manifest of one step: per tensor its digest, shape and
    dtype. Shape and dtype tell a checkpoint of another model (a config
    error) from corruption."""
    digests = tree_digests(leaves)
    return {"version": 1, "algo": "u32sum",
            "leaves": {k: {"sum": digests[k], "shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in leaves.items()}}


def manifest_mismatch(manifest: dict, target: Mapping[str, Tuple[Tuple[int, ...], str]]) -> Optional[str]:
    """How a saved manifest differs in structure from ``target`` (name ->
    (shape, dtype name)); None when they describe the same model and
    optimizer."""
    saved = manifest.get("leaves", {})
    missing = sorted(set(saved) - set(target))
    unexpected = sorted(set(target) - set(saved))
    if missing or unexpected:
        return f"leaf sets differ (checkpoint-only: {missing[:3]}, target-only: {unexpected[:3]})"
    for k, info in saved.items():
        shape, dtype = target[k]
        if tuple(info["shape"]) != tuple(shape):
            return f"{k} shaped {tuple(info['shape'])} in the checkpoint but {tuple(shape)} in the model"
        if str(info["dtype"]) != str(dtype):
            return f"{k} is {info['dtype']} in the checkpoint but {dtype} in the model"
    return None


# transient storage or network fingerprints (JAX :169-188): a restore failure
# that matches is re-raised with the step directory intact, not quarantined
_TRANSIENT_PATTERNS = (
    "unavailable", "deadline_exceeded", "timed out", "timeout", "connection", "socket", "broken pipe",
    "reset by peer", "aborted", "eof occurred", "temporarily", "transient", "too many requests",
    "service unavailable", "resource_exhausted", "memoryerror", "unable to allocate", "out of memory",
)


def _looks_transient(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(pat in msg for pat in _TRANSIENT_PATTERNS)


@dataclasses.dataclass
class RestoreReport:
    """What ``restore_verified`` had to do to produce a trustworthy state."""

    step: Optional[int] = None  # the step that verified
    requested_step: Optional[int] = None  # newest candidate at entry
    quarantined: List[int] = dataclasses.field(default_factory=list)
    verify_ms: float = 0.0  # digest time at restore

    @property
    def fallback_steps(self) -> int:
        if self.step is None or self.requested_step is None:
            return 0
        return int(self.requested_step - self.step)


def _load_safetensors(path: Path, device) -> Dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return load_file(str(path), device=str(device))


def _save_safetensors(tensors: Dict[str, torch.Tensor], path: Path) -> None:
    from safetensors.torch import save_file

    save_file(tensors, str(path))


def split_leaves(leaves: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``params/<name>`` and ``opt_state/<key>`` leaves -> the two files'
    tensors, keyed ``<name>`` and ``<key>``."""
    params = {k.removeprefix("params/"): v for k, v in leaves.items() if k.startswith("params/")}
    opt = {k.removeprefix("opt_state/"): v for k, v in leaves.items() if k.startswith("opt_state/")}
    if len(params) + len(opt) != len(leaves):
        raise ValueError("every leaf is params/<name> or opt_state/<key>")
    return params, opt


class CheckpointManager:
    """Step directories under ``directory``: ``save`` on the cadence (or
    ``force``), keep the newest ``keep``, restore with or without
    verification. ``async_save`` hands the writing to a thread once the
    tensors are on the host; ``wait`` joins it. One process writes; any
    process may read."""

    def __init__(self, directory, keep: int = 5, save_frequency: int = 1000, async_save: bool = True,
                 integrity: bool = True):
        self.directory = Path(directory).absolute()
        self.keep, self.save_frequency = keep, save_frequency
        self.async_save, self.integrity = async_save, integrity
        self.last_digest_ms: float = 0.0  # digest time of the latest save (train/ckpt_verify_ms)
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None

    # -- layout ------------------------------------------------------------

    def step_path(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _listed_steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir() if p.is_dir() and p.name.isdigit())

    def _step_complete(self, step: int) -> bool:
        d = self.step_path(step)
        return (not (d / TOMBSTONE).exists()
                and all((d / f).is_file() for f in (PARAMS_FILE, OPT_FILE, META_FILE)))

    def latest_step(self) -> Optional[int]:
        """Newest complete step (partial and tombstoned directories are skipped)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return [s for s in self._listed_steps() if self._step_complete(s)]

    def incomplete_steps(self) -> List[int]:
        """Step directories that fail the completeness check."""
        return [s for s in self._listed_steps() if not self._step_complete(s)]

    # -- save --------------------------------------------------------------

    def due(self, step: int) -> bool:
        """Whether ``step`` falls on the save cadence (JAX: step % frequency
        == 0, never step 0)."""
        return step != 0 and step % self.save_frequency == 0

    def check_for_errors(self) -> None:
        """Raise the error of a failed background write now."""
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise RuntimeError(f"checkpoint: a background save under {self.directory} failed") from err

    def save(self, step: int, leaves: Mapping[str, torch.Tensor], meta: Optional[dict] = None,
             force: bool = False) -> bool:
        """Save ``leaves`` (``params/<name>`` and ``opt_state/<key>``, whole
        tensors on any device) as step ``step`` if it is due or ``force``.
        The digests are taken on the tensors' device, then every tensor is
        copied to the host; the files are written here or, with
        ``async_save``, by a thread. Returns whether it saved."""
        self.check_for_errors()
        if not force and not self.due(step):
            return False
        self.wait()
        if self.step_path(step).exists() and not self._step_complete(step):
            self.quarantine(step, "incomplete step dir in the way of a new save")
        meta = dict(meta or {})
        meta["step"] = int(step)
        if self.integrity:
            t0 = time.perf_counter()
            meta["manifest"] = build_manifest(leaves)
            self.last_digest_ms = (time.perf_counter() - t0) * 1e3
        # separate host tensors: views of one flat buffer share storage, which
        # safetensors refuses
        host = {k: v.detach().to("cpu", copy=True).contiguous() for k, v in leaves.items()}
        params, opt = split_leaves(host)
        if self.async_save:
            self._writer = threading.Thread(target=self._write_guarded, args=(step, params, opt, meta),
                                            name="zt-ckpt-writer", daemon=True)
            self._writer.start()
        else:
            self._write(step, params, opt, meta)
        return True

    def _write_guarded(self, step, params, opt, meta) -> None:
        try:
            self._write(step, params, opt, meta)
        except BaseException as e:  # surfaced by wait()/check_for_errors()
            self._writer_error = e

    def _write(self, step: int, params, opt, meta: dict) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        _save_safetensors(params, tmp / PARAMS_FILE)
        _save_safetensors(opt, tmp / OPT_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta, default=str))
        dest = self.step_path(step)
        if dest.exists():  # a complete step saved again: the new one replaces it
            shutil.rmtree(dest)
        tmp.rename(dest)
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.step_path(old), ignore_errors=True)

    def wait(self) -> None:
        """Join the background write, if any, and raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self.check_for_errors()

    def close(self) -> None:
        self.wait()

    # -- restore -----------------------------------------------------------

    def read_meta(self, step: int) -> dict:
        return json.loads((self.step_path(step) / META_FILE).read_text())

    def _read_leaves(self, step: int, device) -> Dict[str, torch.Tensor]:
        d = self.step_path(step)
        leaves = {f"params/{k}": v for k, v in _load_safetensors(d / PARAMS_FILE, device).items()}
        leaves.update({f"opt_state/{k}": v for k, v in _load_safetensors(d / OPT_FILE, device).items()})
        return leaves

    def restore(self, step: Optional[int] = None, device="cpu") -> Tuple[Dict[str, torch.Tensor], dict]:
        """Step ``step`` (the newest complete one by default), unverified:
        ``(leaves, meta)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return self._read_leaves(step, device), self.read_meta(step)

    def restore_params(self, step: Optional[int] = None, device="cpu") -> Dict[str, torch.Tensor]:
        """The params alone, by name (the ``warm_init`` path): no optimizer
        state is read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        return _load_safetensors(self.step_path(step) / PARAMS_FILE, device)

    def quarantine(self, step: int, reason: str) -> Optional[str]:
        """Take ``step`` out of the candidates, kept for a post-mortem:
        rename it to ``<step>.quarantined`` (``.quarantined.<n>`` if taken),
        else write a ``_QUARANTINED`` tombstone inside it. Returns the path,
        or None when the directory vanished or neither worked."""
        path = self.step_path(step)
        dest = path.parent / f"{path.name}.quarantined"
        n = 0
        while dest.exists():
            n += 1
            dest = path.parent / f"{path.name}.quarantined.{n}"
        try:
            path.rename(dest)
        except FileNotFoundError as e:
            log.warning("checkpoint: step %d already gone (%s)", step, e)
            return None
        except OSError as rename_err:
            try:
                (path / TOMBSTONE).write_text(str(reason)[:500])
            except OSError as e:
                log.error("checkpoint: could not quarantine step %d (rename: %s; tombstone: %s)",
                          step, rename_err, e)
                return None
            log.error("checkpoint: step %d QUARANTINED in place via tombstone (%s)", step, reason)
            return str(path)
        log.error("checkpoint: step %d QUARANTINED -> %s (%s)", step, dest, reason)
        return str(dest)

    def restore_verified(self, target: Mapping[str, Tuple[Tuple[int, ...], str]],
                         check_meta: Optional[Callable[[dict], None]] = None,
                         on_event: Optional[Callable] = None,
                         device="cpu") -> Tuple[Dict[str, torch.Tensor], dict, RestoreReport]:
        """The newest step that verifies, as ``(leaves, meta, report)``.

        Per candidate, newest first: read ``meta.json``; a manifest that
        describes another model than ``target`` (name -> (shape, dtype))
        raises ``ValueError`` (a config error: the directory stays);
        ``check_meta(meta)`` may raise too (the elastic check); read the
        tensors onto ``device`` and re-digest them against the manifest.
        An unreadable step or a digest mismatch is quarantined and the next
        older step tried; a transient-looking error is re-raised. Raises
        ``FileNotFoundError`` when no verified step remains.
        ``on_event(name, step, **fields)`` hears ``ckpt_quarantined`` and
        ``restore_fallback``."""
        report = RestoreReport(requested_step=self.latest_step())
        seen: set = set()
        while True:
            step = self.latest_step()
            if step is not None and step in seen:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} under {self.directory} failed verification but could not be "
                    "quarantined (rename failed: read-only storage or missing permissions?); move the step "
                    "dir aside manually and rerun")
            if step is None:
                raise FileNotFoundError(
                    f"no verified checkpoint under {self.directory} ({len(report.quarantined)} step(s) "
                    f"quarantined this restore: {report.quarantined}; inspect the *.quarantined dirs or "
                    "point checkpoint.directory elsewhere)")
            seen.add(step)

            def bad(reason: str) -> None:
                dest = self.quarantine(step, reason)
                report.quarantined.append(step)
                if on_event is not None:
                    on_event("ckpt_quarantined", step, reason=str(reason)[:200], path=dest or "")

            try:
                meta = self.read_meta(step)
            except Exception as e:  # noqa: BLE001 - any unreadable metadata is corruption
                if _looks_transient(e):
                    raise
                bad(f"unreadable step metadata: {type(e).__name__}: {e}")
                continue
            manifest = meta.get("manifest")
            if manifest is not None:
                mismatch = manifest_mismatch(manifest, target)
                if mismatch is not None:
                    raise ValueError(
                        f"checkpoint step {step} under {self.directory} was saved for a different "
                        f"model/optimizer: {mismatch}. This is a config mismatch, not corruption — fix the "
                        "config (or warm-init instead of resuming)")
            if check_meta is not None:
                check_meta(meta)  # a ValueError here is fatal by design
            try:
                leaves = self._read_leaves(step, device)
            except Exception as e:  # noqa: BLE001 - a file that does not parse is corruption
                if _looks_transient(e):
                    raise
                if manifest is None:
                    raise
                bad(f"state restore failed: {type(e).__name__}: {e}")
                continue
            if manifest is not None and self.integrity:
                t0 = time.perf_counter()
                fresh = tree_digests(leaves)
                report.verify_ms += (time.perf_counter() - t0) * 1e3
                bad_leaves = [k for k, info in manifest["leaves"].items() if int(info["sum"]) != fresh.get(k)]
                if bad_leaves:
                    bad(f"digest mismatch on {len(bad_leaves)} leaf/leaves (e.g. {bad_leaves[:3]}) — "
                        "silent data corruption")
                    continue
            elif manifest is None:
                log.warning("checkpoint: step %d has no integrity manifest — restored UNVERIFIED", step)
            report.step = step
            if report.fallback_steps:
                log.warning("checkpoint: restore fell back %d step(s) (step %s -> %s) past %d quarantined dir(s)",
                            report.fallback_steps, report.requested_step, step, len(report.quarantined))
                if on_event is not None:
                    on_event("restore_fallback", step, from_step=report.requested_step,
                             fallback_steps=report.fallback_steps, quarantined=len(report.quarantined))
            return leaves, meta, report


# ------------------------------------------------- flax msgpack (no flax)

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK = 1 << 30  # flax.serialization.MAX_CHUNK_SIZE


def _array_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":  # numpy has no bfloat16: widen to float32, exactly
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        payload = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _chunked(tree):
    if isinstance(tree, Mapping):
        return {k: _chunked(v) for k, v in tree.items()}
    a = np.ascontiguousarray(tree)
    if a.size * a.dtype.itemsize <= _MAX_CHUNK:
        return a
    size = max(1, _MAX_CHUNK // a.dtype.itemsize)
    flat = a.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {"__msgpack_chunked_array__": True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def export_params_msgpack(params: Mapping[str, Any], path) -> Path:
    """Write a nested dict of numpy arrays in flax's msgpack format (what
    JAX ``export_params_msgpack`` writes and ``import_params_msgpack``
    reads): ``convert.params_to_jax`` gives that tree from the port's
    params."""
    import msgpack

    from zero_transformer_tpu_torch.convert import unflatten

    tree = unflatten(params) if any("/" in k for k in params) else params
    path = Path(path)
    path.write_bytes(msgpack.packb(_chunked(tree), default=_ext_pack, strict_types=True))
    return path


def import_params_msgpack(path) -> Dict[str, Any]:
    """Read a flax msgpack params tree (JAX ``export.py extract``, JAX
    ``export_params_msgpack``) as nested dicts of numpy arrays."""
    import msgpack

    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_unpack, raw=False)
    return _unchunk(tree)


def save_config_json(directory, flat_config: dict) -> None:
    path = Path(directory).absolute()
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(flat_config, indent=2, default=str))
