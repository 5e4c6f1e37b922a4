"""The paged decode model and its KV page pools.

Counterpart of ``zero_transformer_tpu/inference/generate.py`` (``decode_model``
:30-50 and the cache allocation of ``init_cache``). In JAX the decode
variant is a separate flax module whose cache is a pytree returned by every
apply; in the port the one ``Transformer`` has a ``forward_paged`` method and
the cache is a list of per-layer ``KVPools`` (K/V pools, plus their scale
pools for an int8 cache) that the forward updates IN PLACE (where the JAX
engine donates its cache buffers to the step).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from zero_transformer_tpu_torch.config import ModelConfig, resolve_dtype
from zero_transformer_tpu_torch.models.gpt import KVPools, Pools, Transformer


def decode_model(model: Transformer, cache_len: int, kv_pages: Tuple[int, int]) -> Transformer:
    """The paged decode variant: ``model`` itself, whose ``forward_paged``
    reads and writes ``kv_pages = (n_pages, page_size)`` pools. Checks the
    paged geometry as JAX ``decode_model`` does and returns the model."""
    n_pages, page = kv_pages
    if page < 1 or n_pages < 2:
        raise ValueError(
            f"kv_pages needs page_size >= 1 and n_pages >= 2 (one trash page + one real page), got {kv_pages}"
        )
    if cache_len % page:
        raise ValueError(f"page_size ({page}) must divide cache_len ({cache_len})")
    return model


def allocate_pools(cfg: ModelConfig, n_pages: int, page_size: int, device,
                   dtype: Optional[torch.dtype] = None) -> Pools:
    """One zeroed ``[n_pages, page, KVH, D]`` K/V pool pair per layer: in
    the compute dtype (``kv_cache_dtype: auto``), or int8 with zeroed
    float32 scale pools ``[n_pages, page, KVH, 1]`` (``int8``, JAX
    ``gpt.py:233-237``). Page 0 is the trash page, scales included."""
    shape = (n_pages, page_size, cfg.kv_heads, cfg.head_width)
    if cfg.kv_cache_dtype == "int8":
        sc_shape = shape[:-1] + (1,)
        return [
            KVPools(*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2)),
                    *(torch.zeros(sc_shape, dtype=torch.float32, device=device) for _ in range(2)))
            for _ in range(cfg.n_layers)
        ]
    dtype = dtype or resolve_dtype(cfg.compute_dtype)
    return [
        KVPools(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layers)
    ]
