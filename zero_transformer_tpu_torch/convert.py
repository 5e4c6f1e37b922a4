"""Convert the JAX package's flax param tree into the port's ``state_dict``.

The counterpart is the param layout of ``zero_transformer_tpu/models/gpt.py``:
``wte/embedding`` ``[V, d]``; per block ``ln_attn/scale``,
``attn/{query,key,value,out}/kernel`` and ``mlp/{wi,wo}/kernel`` (``[in,
out]`` kernels), ``ln_mlp/scale``; ``ln_f/scale``. Blocks are either
scan-stacked under ``blocks/...`` with a leading ``[n_layers]`` axis
(``gpt.py:621-630``) or unscanned under ``block_<i>/...``.

The input is the tree as NUMPY arrays (nested dicts; ``nn.Partitioned``
boxes already unwrapped on the JAX side), or its flat form with
``/``-joined keys as written to an ``.npz``. Nothing here imports JAX.

To write the ``.npz`` that ``serve --params`` reads, on a machine with JAX::

    import numpy as np
    from flax.traverse_util import flatten_dict
    from zero_transformer_tpu.parallel.sharding import unbox
    flat = flatten_dict(unbox(params), sep="/")
    np.savez("p.npz", **{k: np.asarray(v, np.float32) for k, v in flat.items()})
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = (("attn", "query"), ("attn", "key"), ("attn", "value"), ("attn", "out"),
          ("mlp", "wi"), ("mlp", "wo"))
_NORMS = ("ln_attn", "ln_mlp")


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


def _layer(stacked: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a scan-stacked subtree (every leaf has a leading
    ``[n_layers]`` axis)."""
    return {
        k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
        for k, v in stacked.items()
    }


def _block_state(block: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for norm in _NORMS:
        out[f"{prefix}.{norm}.scale"] = np.asarray(block[norm]["scale"])
    for mod, name in _DENSE:
        # flax kernel [in, out] -> torch weight [out, in]
        out[f"{prefix}.{mod}.{name}.weight"] = np.asarray(block[mod][name]["kernel"]).T
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested or ``/``-flat, numpy leaves) -> the port's
    ``Transformer.state_dict()`` (float32 CPU tensors)."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, np.ndarray] = {
        "wte.embedding": np.asarray(tree["wte"]["embedding"]),
        "ln_f.scale": np.asarray(tree["ln_f"]["scale"]),
    }
    if "lm_head" in tree:
        raise NotImplementedError("untied heads are not ported yet")
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
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in state.items()}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read an ``.npz`` of the flat flax tree and convert it."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_jax(flat)
