"""Loss functions. Counterpart of ``zero_transformer_tpu/ops/losses.py``:
integer labels gathered from the logits, log-softmax in float32 whatever
the logits' dtype (:17-60); the chunked cross entropy from pre-head hidden
states, whose ``[B, T, vocab]`` logits never exist (:63-136); and
``token_log_likelihood`` (:139-153)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the token losses, count of labels)`` in float32 over the
    labels that are not ``ignore_index``: the pieces of a mean that spans
    several shards (sequence parallelism sums both over the ranks)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_index, 0, labels)
    nll = lse - torch.gather(logits, -1, safe.long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return torch.sum(nll * mask), torch.sum(mask)


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


class _ChunkedCrossEntropySum(torch.autograd.Function):
    """``(sum of the token losses, count)`` from hidden states ``h`` ``[B,
    n, d]`` and the head ``w`` ``[d, vocab]``, ``chunk`` positions at a
    time. Each tile's logits ``(h_c @ w).float()`` live only inside one
    loop iteration, forward and backward: the backward recomputes the tile
    and accumulates ``dh`` and ``dw`` from ``(1 + 2 z lse) softmax -
    one_hot``, scaled by the mask and the incoming grad of the sum."""

    @staticmethod
    def forward(ctx, h, w, targets, valid, chunk: int, z_loss: float):
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, h.shape[1], chunk):
            logits = (h[:, s:s + chunk] @ w).float()  # [B, chunk, V]: the tile
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - torch.gather(logits, -1, targets[:, s:s + chunk, None])[..., 0]
            if z_loss:
                nll = nll + z_loss * torch.square(lse)
            total = total + torch.sum(nll * valid[:, s:s + chunk])
            del logits
        ctx.save_for_backward(h, w, targets, valid)
        ctx.chunk, ctx.z_loss = chunk, z_loss
        return total, torch.sum(valid)

    @staticmethod
    def backward(ctx, d_total, _d_count):
        h, w, targets, valid = ctx.saved_tensors
        chunk, z_loss = ctx.chunk, ctx.z_loss
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) if ctx.needs_input_grad[1] else None
        for s in range(0, h.shape[1], chunk):
            h_c = h[:, s:s + chunk]
            logits = (h_c @ w).float()
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            probs = torch.exp(logits - lse)
            del logits
            if z_loss:
                probs = probs * (1.0 + 2.0 * z_loss * lse)
            probs.scatter_add_(-1, targets[:, s:s + chunk, None],
                               torch.full_like(probs[..., :1], -1.0))
            g = (probs * (valid[:, s:s + chunk, None] * d_total)).to(h.dtype)  # d sum / d tile
            del probs
            if dh is not None:
                dh[:, s:s + chunk] = g @ w.T
            if dw is not None:
                dw += (h_c.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])).float()
        return dh, None if dw is None else dw.to(w.dtype), None, None, None, None


def chunked_cross_entropy_sum(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk_size: int,
                              ignore_index: Optional[int] = None,
                              z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the token losses, count of labels)`` in float32 of the
    logits ``hidden @ w`` against ``labels`` (already aligned with
    ``hidden``: no shift here), without the ``[B, n, vocab]`` logits: the
    chunked twin of ``cross_entropy_sum``, for a mean over several shards.
    ``hidden`` ``[B, n, d]``, ``w`` ``[d, vocab]`` (cast to ``hidden``'s
    dtype), ``labels`` ``[B, n]``; ``ignore_index`` labels leave both sums.
    Positions pad explicitly (zeros, masked) to a multiple of
    ``chunk_size``, as JAX's scan does; the peak logits memory is one
    ``[B, chunk_size, vocab]`` float32 tile, forward and backward."""
    B, n, _ = hidden.shape
    valid = (torch.ones_like(labels, dtype=torch.bool) if ignore_index is None
             else labels != ignore_index)
    targets = torch.where(valid, labels, 0).long()  # keep the gather in bounds for -1 labels
    pad = (-n) % chunk_size
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets, valid = F.pad(targets, (0, pad)), F.pad(valid, (0, pad))
    return _ChunkedCrossEntropySum.apply(hidden, w.to(hidden.dtype), targets, valid.float(), chunk_size,
                                         float(z_loss))


def chunked_next_token_loss(
    hidden: torch.Tensor,
    w_dv: torch.Tensor,
    tokens: torch.Tensor,
    chunk_size: int,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """``next_token_loss`` from the pre-head hidden states ``hidden`` ``[B,
    T, d]`` (post final norm) and the head ``w_dv`` ``[d, vocab]`` (the tied
    embedding transposed), ``chunk_size`` positions at a time: the last
    position is dropped, the labels shift by one, and the mean is
    ``sum / max(count, 1)``."""
    total, count = chunked_cross_entropy_sum(hidden[:, :-1], w_dv, tokens[:, 1:], chunk_size,
                                             ignore_index=ignore_index, z_loss=z_loss)
    return total / torch.clamp(count, min=1.0)


def token_log_likelihood(logits: torch.Tensor, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position ``log p(tokens[t + 1] | tokens[<= t])`` ``[..., T - 1]``
    (float32) and whether that token is the greedy choice."""
    logits = logits[..., :-1, :].float()
    targets = tokens[..., 1:].long()
    ll = torch.gather(torch.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
    return ll, torch.argmax(logits, dim=-1) == targets
