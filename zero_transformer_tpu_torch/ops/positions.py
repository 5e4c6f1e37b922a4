"""Position encodings: ALiBi slopes and additive attention biases, and RoPE.

Counterpart of ``zero_transformer_tpu/ops/positions.py``. The slope table,
including the non-power-of-two interpolation, and the mask constant are the
JAX package's exactly. RoPE (:70-90) is the half-split rotation (the first
and second halves of the head dim pair up, not neighbouring elements), its
angles ``pos * inv_freq`` in float32. The inverse frequencies are computed
once on the host in float32 in JAX's order and copied to the device, so the
angles round the same on every device: at position 8191 one ulp of an
inverse frequency moves an angle by ~1e-3.
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


def head_slopes(n_heads: int, device=None, slopes=None) -> torch.Tensor:
    """[n_heads] f32: the caller's slope table (a tensor-parallel or
    Ulysses shard's heads, JAX's ``slopes=`` override) or the model's."""
    if slopes is None:
        return alibi_slopes(n_heads, device)
    slopes = slopes.to(device=device, dtype=torch.float32).reshape(-1)
    if slopes.numel() != n_heads:
        raise ValueError(f"slopes must hold one value per query head ({n_heads}), got {slopes.numel()}")
    return slopes


def alibi_bias(n_heads: int, q_len: int, kv_len: int, offset: int = 0, device=None, slopes=None) -> torch.Tensor:
    """[n_heads, q_len, kv_len] f32 additive bias: -slope * max(q_pos - k_pos, 0)."""
    q_pos = torch.arange(q_len, dtype=torch.int32, device=device) + offset
    kv_pos = torch.arange(kv_len, dtype=torch.int32, device=device)
    dist = torch.clamp(q_pos[:, None] - kv_pos[None, :], min=0).to(torch.float32)
    return -head_slopes(n_heads, device, slopes)[:, None, None] * dist[None, :, :]


@functools.lru_cache(maxsize=None)
def _rope_frequencies(head_dim: int, theta: float, device: str) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / (theta**exponent)).to(device)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` float32, computed on the host
    and copied to ``device`` once (a copy per call would wait for the card)."""
    return _rope_frequencies(head_dim, float(theta), str(device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` ``[..., T, heads, head_dim]`` by ``positions`` (``[T]``
    or ``[B, T]``): the halves ``x1, x2`` become ``x1 cos - x2 sin`` and
    ``x2 cos + x1 sin``, in float32, cast back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = (positions.to(torch.float32)[..., None] * freqs)[..., None, :]  # [..., T, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def causal_mask_bias(q_len: int, kv_len: int, offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] f32 additive causal mask (0 where visible, NEG_INF where not)."""
    q_pos = torch.arange(q_len, dtype=torch.int32, device=device) + offset
    kv_pos = torch.arange(kv_len, dtype=torch.int32, device=device)
    visible = kv_pos[None, :] <= q_pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(visible, zero, torch.full_like(zero, NEG_INF))
