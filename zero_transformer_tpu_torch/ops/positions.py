"""ALiBi slopes and additive attention biases.

Counterpart of ``zero_transformer_tpu/ops/positions.py`` (ALiBi part). The
slope table, including the non-power-of-two interpolation, and the mask
constant are the JAX package's exactly.
"""
from __future__ import annotations

import functools
import math

import torch

NEG_INF = -1e10  # additive mask value; large but finite so f32 softmax is exact


@functools.lru_cache(maxsize=None)
def alibi_slopes_list(n_heads: int) -> tuple:
    """ALiBi head slopes: geometric sequence starting at 2^(-8/n) for
    power-of-two n, with the published interpolation otherwise."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return tuple(pow2_slopes(n_heads))
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return tuple(pow2_slopes(closest) + extra)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    return torch.tensor(alibi_slopes_list(n_heads), dtype=torch.float32, device=device)


def alibi_bias(n_heads: int, q_len: int, kv_len: int, offset: int = 0, device=None) -> torch.Tensor:
    """[n_heads, q_len, kv_len] f32 additive bias: -slope * max(q_pos - k_pos, 0)."""
    q_pos = torch.arange(q_len, dtype=torch.int32, device=device) + offset
    kv_pos = torch.arange(kv_len, dtype=torch.int32, device=device)
    dist = torch.clamp(q_pos[:, None] - kv_pos[None, :], min=0).to(torch.float32)
    slopes = alibi_slopes(n_heads, device)
    return -slopes[:, None, None] * dist[None, :, :]


def causal_mask_bias(q_len: int, kv_len: int, offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] f32 additive causal mask (0 where visible, NEG_INF where not)."""
    q_pos = torch.arange(q_len, dtype=torch.int32, device=device) + offset
    kv_pos = torch.arange(kv_len, dtype=torch.int32, device=device)
    visible = kv_pos[None, :] <= q_pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(visible, zero, torch.full_like(zero, NEG_INF))
