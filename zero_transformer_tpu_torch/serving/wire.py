"""The page-span wire format of stream migration.

Counterpart of JAX ``page_span_to_wire`` / ``page_span_from_wire``
(``zero_transformer_tpu/serving/slots.py:430-476``, with ``_dtype_token``
:344 and ``_dtype_from_token`` :352), byte for byte: the magic ``ZTPG1``,
a little-endian ``uint32`` header length, a JSON header (the payload's
fields in their order, then ``leaves``: key, dtype token, shape, nbytes per
leaf in sorted key order) and the leaves' raw buffers in that order. A
dtype token is numpy's ``dtype.str`` (``<f4``, ``|i1``, ``|b1``, ...); an
extension dtype ships by name (``bfloat16``). So a blob from either
package decodes in the other.

The port's leaves are torch tensors on the host. numpy has no bfloat16 and
the port does not import ``ml_dtypes``: bfloat16 crosses as its 16-bit
pattern (a tensor viewed as ``int16``, a buffer read as ``uint16`` and
viewed back as ``torch.bfloat16``). Leaves given as numpy arrays are
accepted too, an ``ml_dtypes`` bfloat16 array among them (by its dtype's
name, through a ``uint16`` view).
"""
from __future__ import annotations

import json
import struct
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["page_span_to_wire", "page_span_from_wire", "as_host_tensor"]

_WIRE_MAGIC = b"ZTPG1"

# torch dtype -> wire token (numpy's dtype.str on a little-endian host;
# bfloat16 by name, as JAX ships numpy kind 'V' dtypes)
_TOKENS = {
    torch.float64: "<f8", torch.float32: "<f4", torch.float16: "<f2", torch.bfloat16: "bfloat16",
    torch.int64: "<i8", torch.int32: "<i4", torch.int16: "<i2", torch.int8: "|i1",
    torch.uint8: "|u1", torch.bool: "|b1",
}
if hasattr(torch, "uint32"):  # JAX's PRNG key carry
    _TOKENS[torch.uint32] = "<u4"
_DTYPES = {token: dtype for dtype, token in _TOKENS.items()}


def _dtype_from_token(token: str) -> torch.dtype:
    """The torch dtype of a wire token; ValueError on one it cannot hold (a
    torn or foreign blob is a clean rejection, never a traceback)."""
    try:
        return _DTYPES[str(token)]
    except KeyError:
        raise ValueError(f"unknown dtype token {token!r}") from None


def as_host_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous tensor on the host: a torch tensor (moved off
    the device if it lies there) or a numpy array (an ``ml_dtypes``
    bfloat16 one through its 16-bit pattern)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype.kind == "V":
        if arr.dtype.name != "bfloat16":
            raise ValueError(f"unsupported extension dtype {arr.dtype.name!r}")
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def page_span_to_wire(payload: Dict[str, Any]) -> bytes:
    """Serialize a page-span payload (and any JSON-safe fields riding in it)
    to one self-describing byte string, JAX's format exactly."""
    leaves = payload.get("leaves", {})
    header = {k: v for k, v in payload.items() if k != "leaves"}
    header["leaves"] = []
    buffers: List[np.ndarray] = []
    for key in sorted(leaves):
        t = as_host_tensor(leaves[key])
        if t.dtype not in _TOKENS:
            raise ValueError(f"leaf {key} has dtype {t.dtype}, which the wire format does not carry")
        shape = list(t.shape) or [1]  # numpy's ascontiguousarray makes a 0-d leaf [1]
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header["leaves"].append({"key": key, "dtype": _TOKENS[t.dtype], "shape": shape, "nbytes": int(raw.nbytes)})
        buffers.append(raw)
    head = json.dumps(header).encode()
    return b"".join([_WIRE_MAGIC, struct.pack("<I", len(head)), head, *buffers])


def page_span_from_wire(blob: bytes) -> Dict[str, Any]:
    """Parse ``page_span_to_wire`` output (of either package) back into the
    payload dict, its leaves torch tensors over the blob's bytes. Raises
    ValueError on a torn or foreign blob."""
    if len(blob) < len(_WIRE_MAGIC) + 4 or not bytes(blob[:len(_WIRE_MAGIC)]) == _WIRE_MAGIC:
        raise ValueError("not a page-span wire blob")
    off = len(_WIRE_MAGIC)
    (head_len,) = struct.unpack_from("<I", blob, off)
    off += 4
    try:
        header = json.loads(bytes(blob[off:off + head_len]))
    except ValueError as exc:
        raise ValueError(f"torn page-span header: {exc}") from exc
    if not isinstance(header, dict):
        raise ValueError("torn page-span header: not a JSON object")
    off += head_len
    leaves: Dict[str, torch.Tensor] = {}
    try:
        metas = list(header.pop("leaves", []))
        for meta in metas:
            n = int(meta["nbytes"])
            dtype = _dtype_from_token(meta["dtype"])
            shape = [int(d) for d in meta["shape"]]
            if n < 0 or off + n > len(blob):
                raise ValueError("page-span blob truncated mid-buffer")
            raw = np.frombuffer(blob, dtype=np.uint8, count=n, offset=off)
            with warnings.catch_warnings():  # read-only bytes: the tensor is only ever read
                warnings.simplefilter("ignore", UserWarning)
                flat = torch.from_numpy(raw)
            leaves[str(meta["key"])] = flat.view(dtype).reshape(shape)
            off += n
    except (KeyError, TypeError, RuntimeError) as exc:
        raise ValueError(f"torn page-span leaf table: {exc!r}") from exc
    header["leaves"] = leaves
    return header
