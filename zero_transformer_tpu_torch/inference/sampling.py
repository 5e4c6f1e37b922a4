"""Logit processors and token sampling.

Counterpart of ``zero_transformer_tpu/inference/sampling.py``: temperature ->
repetition penalty -> exact top-k -> top-p, then argmax (greedy) or a
categorical draw. The draw is Gumbel-max over ``uniforms``, which come from
a ``torch.Generator`` or are passed in, so a test can feed both packages the
same noise (JAX's threefry streams have no torch counterpart). ``approx``
top-k is a TPU primitive and is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e10


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling hyperparameters (engine-level, like the JAX engine's)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 0.0  # 0 or 1 = disabled
    repetition_penalty: float = 1.0  # 1 = disabled
    greedy: bool = False
    top_k_impl: str = "exact"

    def __post_init__(self):
        if self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.top_k_impl == "approx":
            raise NotImplementedError(
                "top_k_impl='approx' is the TPU's approx_max_k; the port has exact top-k only"
            )
        if self.top_k_impl != "exact":
            raise ValueError(f"invalid top_k_impl {self.top_k_impl!r}")


def apply_repetition_penalty(logits: torch.Tensor, generated_mask: torch.Tensor, penalty: float) -> torch.Tensor:
    """Penalize tokens already generated. logits [B, V]; mask [B, V] bool."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(generated_mask, penalized, logits)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row; mask the rest to NEG_INF."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix with cumulative prob > p."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    exceeded = cum > p
    # a token drops when the mass BEFORE it already exceeds p
    drop_sorted = torch.cat([torch.zeros_like(exceeded[..., :1]), exceeded[..., :-1]], dim=-1)
    threshold = torch.where(drop_sorted, torch.full_like(sorted_logits, float("inf")), sorted_logits)
    threshold = threshold.min(dim=-1, keepdim=True).values
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF), logits)


def process_logits(
    logits: torch.Tensor, cfg: SamplingConfig, generated_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Temperature -> repetition penalty -> top-k -> top-p, in float32."""
    logits = logits.float() / cfg.temperature
    if generated_mask is not None:
        logits = apply_repetition_penalty(logits, generated_mask, cfg.repetition_penalty)
    logits = top_k_filter(logits, cfg.top_k)
    return top_p_filter(logits, cfg.top_p)


def sample_token(
    logits: torch.Tensor,
    cfg: SamplingConfig,
    generated_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample (or argmax) next tokens. logits [B, V] -> [B] int64.

    A categorical draw is ``argmax(logits + gumbel)`` with gumbel =
    ``-log(-log(u))``; ``u`` is ``uniforms`` [B, V] in (0, 1) when given,
    else drawn from ``generator``."""
    logits = process_logits(logits, cfg, generated_mask)
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    if uniforms is None:
        uniforms = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = uniforms.to(logits.device, torch.float32).clamp(min=torch.finfo(torch.float32).tiny, max=1.0 - 2**-24)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
