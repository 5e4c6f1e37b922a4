"""Loss functions. Counterpart of ``zero_transformer_tpu/ops/losses.py``
(:17-60): integer labels gathered from the logits, log-softmax in float32
whatever the logits' dtype."""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Mean token-level cross entropy in float32. ``logits`` ``[..., vocab]``,
    ``labels`` ``[...]`` int ids; ``ignore_index`` labels leave the mean;
    ``z_loss`` adds the PaLM log-Z regulariser ``z_loss * lse^2``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # an ignored label may lie outside the vocab (e.g. -1): gather at 0
    safe = labels if ignore_index is None else torch.where(labels == ignore_index, 0, labels)
    label_logits = torch.gather(logits, -1, safe.long()[..., None])[..., 0]
    nll = lse - label_logits
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def next_token_loss(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Shifted LM loss: predict ``tokens[..., t + 1]`` from ``logits[..., t, :]``."""
    return cross_entropy_loss(
        logits[..., :-1, :], tokens[..., 1:], ignore_index=ignore_index, z_loss=z_loss
    )
