"""Convert the JAX package's flax param tree into the port's ``state_dict``.

The counterpart is the param layout of ``zero_transformer_tpu/models/gpt.py``:
``wte/embedding`` ``[V, d]``; per block ``ln_attn/scale``,
``attn/{query,key,value,out}/kernel`` and ``mlp/{wi,wo}/kernel`` (``[in,
out]`` kernels; SwiGLU adds ``mlp/gate/kernel``), ``ln_mlp/scale`` (the
LayerNorm's or the RMSNorm's); ``ln_f/scale``; learned positions add
``wpe/embedding`` ``[max_seq_len, d]``, an untied head ``lm_head/kernel``
``[d, V]`` (the port's ``lm_head.weight`` ``[V, d]``). Blocks are either
scan-stacked under ``blocks/...`` with a leading ``[n_layers]`` axis
(``gpt.py:621-630``) or unscanned under ``block_<i>/...``.

The input is the tree as NUMPY arrays (nested dicts; ``nn.Partitioned``
boxes already unwrapped on the JAX side, or as ``checkpoint.py``'s
``import_params_msgpack`` reads a flax msgpack file), or its flat form with
``/``-joined keys as written to an ``.npz``. ``read_params_tree`` reads any
of these files, or a port checkpoint's step directory. Nothing here
imports JAX.

A weight-only int8 tree (``models/quant.py::quantize_params``, JAX's
layout) converts too: a Dense's ``kernel_q`` ``[in, out]`` int8 and
``scale`` ``[out]`` become ``weight_q`` ``[out, in]`` (still int8) and
``scale`` (``lm_head`` and ``gate`` alike); ``wte/embedding_q`` and
``wte/scale`` become ``wte.embedding_q`` and ``wte.scale``. Float leaves
come out float32, int8 leaves stay int8.

``tensor_shard`` cuts a whole state dict (converted, or gathered from a
checkpoint) into a tensor rank's slices by ``models/gpt.py::tp_split_dim``:
the one rule that tensor-parallel serving (``shard_for_inference``) and
training (the float32 masters and optimizer state of
``parallel/zero.py``) both use.

To write the ``.npz`` that ``serve --params`` reads, on a machine with JAX::

    import numpy as np
    from flax.traverse_util import flatten_dict
    from zero_transformer_tpu.parallel.sharding import unbox
    flat = flatten_dict(unbox(params), sep="/")
    np.savez("p.npz", **{k: np.asarray(v, np.int8 if v.dtype == np.int8 else np.float32)
                         for k, v in flat.items()})
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = (("attn", "query"), ("attn", "key"), ("attn", "value"), ("attn", "out"),
          ("mlp", "wi"), ("mlp", "gate"), ("mlp", "wo"))  # gate: SwiGLU blocks only
_NORMS = ("ln_attn", "ln_mlp")


def tensor_shard(state: Mapping[str, torch.Tensor], rank: int, size: int) -> Dict[str, torch.Tensor]:
    """Tensor rank ``rank``'s part of the whole tensors ``state`` (the
    port's state-dict names): every tensor that ``tp_split_dim`` names cut
    into ``size`` equal slices along that dim and slice ``rank`` kept (a
    copy, never a view, so the whole tensor can be freed), the others as
    they are. Raises when a split dim does not divide."""
    from zero_transformer_tpu_torch.models.gpt import tp_split_dim

    if size == 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = tp_split_dim(name)
        if dim is None:
            out[name] = t
            continue
        if t.shape[dim] % size:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not split over {size} ranks")
        width = t.shape[dim] // size
        out[name] = t.narrow(dim, rank * width, width).clone()
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": {"c": x}}}`` -> ``{"a/b/c": x}``."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def _layer(stacked: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a scan-stacked subtree (every leaf has a leading
    ``[n_layers]`` axis)."""
    return {
        k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
        for k, v in stacked.items()
    }


def _dense_state(leaves: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A flax Dense's leaves -> the port's: kernel ``[in, out]`` -> weight
    ``[out, in]``, or int8 ``kernel_q`` + ``scale`` -> ``weight_q`` + ``scale``."""
    if "kernel_q" in leaves:
        return {f"{prefix}.weight_q": np.asarray(leaves["kernel_q"]).T, f"{prefix}.scale": np.asarray(leaves["scale"])}
    return {f"{prefix}.weight": np.asarray(leaves["kernel"]).T}


def _block_state(block: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for norm in _NORMS:
        out[f"{prefix}.{norm}.scale"] = np.asarray(block[norm]["scale"])
    for mod, name in _DENSE:
        if name in block[mod]:
            out.update(_dense_state(block[mod][name], f"{prefix}.{mod}.{name}"))
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.tensor(a) if a.dtype == np.int8 else torch.tensor(a, dtype=torch.float32)


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested or ``/``-flat, numpy leaves) -> the port's
    ``Transformer.state_dict()`` (CPU tensors: float32, int8 for the
    quantized leaves)."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    if set(tree) == {"params"}:
        tree = tree["params"]
    wte = tree["wte"]
    if "embedding_q" in wte:
        state: Dict[str, np.ndarray] = {"wte.embedding_q": np.asarray(wte["embedding_q"]),
                                        "wte.scale": np.asarray(wte["scale"])}
    else:
        state = {"wte.embedding": np.asarray(wte["embedding"])}
    state["ln_f.scale"] = np.asarray(tree["ln_f"]["scale"])
    if "wpe" in tree:
        state["wpe.embedding"] = np.asarray(tree["wpe"]["embedding"])
    if "lm_head" in tree:
        state.update(_dense_state(tree["lm_head"], "lm_head"))
    if "blocks" in tree:
        stacked = tree["blocks"]
        n_layers = np.asarray(stacked["ln_attn"]["scale"]).shape[0]
        for i in range(n_layers):
            state.update(_block_state(_layer(stacked, i), f"blocks.{i}"))
    else:
        i = 0
        while f"block_{i}" in tree:
            state.update(_block_state(tree[f"block_{i}"], f"blocks.{i}"))
            i += 1
        if i == 0:
            raise ValueError("no 'blocks' or 'block_0' subtree in the param tree")
    return {k: _tensor(v) for k, v in state.items()}


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> the ``/``-flat flax tree in JAX's
    scan-stacked layout (``blocks/...`` with a leading ``[n_layers]`` axis),
    the inverse of ``params_from_jax``: what an ``.npz`` for ``serve
    --params`` holds. Float leaves come out float32, int8 leaves int8."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return t.numpy() if t.dtype == torch.int8 else t.float().numpy()

    flat: Dict[str, np.ndarray] = {"ln_f/scale": arr(state["ln_f.scale"])}
    if "wte.embedding_q" in state:
        flat["wte/embedding_q"], flat["wte/scale"] = arr(state["wte.embedding_q"]), arr(state["wte.scale"])
    else:
        flat["wte/embedding"] = arr(state["wte.embedding"])
    if "wpe.embedding" in state:
        flat["wpe/embedding"] = arr(state["wpe.embedding"])
    if "lm_head.weight_q" in state:
        flat["lm_head/kernel_q"], flat["lm_head/scale"] = arr(state["lm_head.weight_q"]).T, arr(state["lm_head.scale"])
    elif "lm_head.weight" in state:
        flat["lm_head/kernel"] = arr(state["lm_head.weight"]).T
    n_layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))

    def stack(suffix: str, transpose: bool = False) -> np.ndarray:
        return np.stack([arr(state[f"blocks.{i}.{suffix}"]).T if transpose else arr(state[f"blocks.{i}.{suffix}"])
                         for i in range(n_layers)])

    for norm in _NORMS:
        flat[f"blocks/{norm}/scale"] = stack(f"{norm}.scale")
    for mod, name in _DENSE:
        if f"blocks.0.{mod}.{name}.weight_q" in state:
            flat[f"blocks/{mod}/{name}/kernel_q"] = stack(f"{mod}.{name}.weight_q", transpose=True)
            flat[f"blocks/{mod}/{name}/scale"] = stack(f"{mod}.{name}.scale")
        elif f"blocks.0.{mod}.{name}.weight" in state:
            flat[f"blocks/{mod}/{name}/kernel"] = stack(f"{mod}.{name}.weight", transpose=True)
    return flat


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat flax tree of an ``.npz``, leaves as stored (int8 stays int8)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read an ``.npz`` of the flat flax tree and convert it."""
    return params_from_jax(read_npz(path))


def read_params_tree(path: str) -> Dict[str, np.ndarray]:
    """The flat flax tree of the params at ``path``, whichever of the three
    forms it takes: a port checkpoint's step directory (its
    ``params.safetensors``, ``checkpoint.py``), a flax msgpack file (JAX
    ``export_params_msgpack``, ``export.py extract``) or an ``.npz`` of the
    flat tree."""
    from zero_transformer_tpu_torch import checkpoint

    p = Path(path)
    if p.is_dir():
        if not (p / checkpoint.PARAMS_FILE).is_file():
            raise FileNotFoundError(f"{path} is a directory without {checkpoint.PARAMS_FILE}: pass a checkpoint "
                                    f"step directory (<checkpoint.directory>/<step>)")
        return params_to_jax(checkpoint.CheckpointManager(p.parent).restore_params(int(p.name)))
    if p.suffix == ".msgpack":
        return flatten(checkpoint.import_params_msgpack(p))
    return read_npz(path)
