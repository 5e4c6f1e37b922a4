"""Loss functions. Counterpart of ``zero_transformer_tpu/ops/losses.py``:
integer labels gathered from the logits, log-softmax in float32 whatever
the logits' dtype (:17-60); the chunked cross entropy from pre-head hidden
states, whose ``[B, T, vocab]`` logits never exist (:63-136); and
``token_log_likelihood`` (:139-153).

Under a tensor group (``parallel/mesh.py::TensorGroup``) the losses take
the rank's vocabulary columns ``[vocab_lo, vocab_lo + V / N)`` of the
logits (or of the head) and never gather ``[.., vocab]``: the vocab-parallel
cross entropy, in float32, takes the row max by a MAX all-reduce (no
gradient flows through it), then the sum of ``exp(logit - max)`` and the
label's logit (from the rank whose columns hold it, zero elsewhere) by one
SUM all-reduce; ``lse``, ``nll = lse - label_logit`` and the z-loss follow
on every rank alike. Its backward is ``(1 + 2 z lse) softmax - onehot`` on
the local columns, with no collective (JAX computes the same function on
the whole logits, GSPMD partitioning the reductions)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from zero_transformer_tpu_torch.parallel.mesh import TensorGroup


def _local_targets(labels: torch.Tensor, vocab_lo: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the labels as column indices into this rank's ``width`` columns,
    clamped in range, and whether each label falls in them)."""
    local = labels.long() - vocab_lo
    inside = (local >= 0) & (local < width)
    return torch.where(inside, local, torch.zeros_like(local)), inside


def _vocab_lse_label(logits: torch.Tensor, local: torch.Tensor, inside: Optional[torch.Tensor],
                     group: Optional[TensorGroup]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, label logit)`` in float32 of float32 ``logits`` ``[..., V /
    N]`` at the column indices ``local``: one card's ``logsumexp`` and
    gather, or the three reductions of the vocab-parallel loss over
    ``group`` (no autograd; ``inside`` marks the labels in this rank's
    columns)."""
    label = torch.gather(logits, -1, local[..., None])[..., 0]
    if group is None:
        return torch.logsumexp(logits, dim=-1), label
    m = group.all_reduce_max(logits.amax(dim=-1))
    parts = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                         torch.where(inside, label, torch.zeros_like(label))])
    group.all_reduce_([parts])
    return m + torch.log(parts[0]), parts[1]


class _VocabParallelNLL(torch.autograd.Function):
    """Per-position ``lse - label logit (+ z lse^2)`` in float32 from this
    rank's logit columns; the backward ``(1 + 2 z lse) softmax - onehot``
    on those columns, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, group, vocab_lo: int, z_loss: float):
        local, inside = _local_targets(labels, vocab_lo, logits.shape[-1])
        with torch.no_grad():
            lse, label = _vocab_lse_label(logits.float(), local, inside, group)
        nll = lse - label
        if z_loss:
            nll = nll + z_loss * torch.square(lse)
        ctx.save_for_backward(logits, lse, local, inside)
        ctx.z_loss = z_loss
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        probs = torch.exp(logits.float() - lse[..., None])
        if ctx.z_loss:
            probs = probs * (1.0 + 2.0 * ctx.z_loss * lse[..., None])
        probs.scatter_add_(-1, local[..., None], -inside[..., None].float())
        return (probs * g[..., None]).to(logits.dtype), None, None, None, None


def _nll(logits: torch.Tensor, labels: torch.Tensor, z_loss: float, group: Optional[TensorGroup],
         vocab_lo: int) -> torch.Tensor:
    """Per-position float32 nll (plus the z-loss) of ``labels``: on one
    card through autograd (the ids must be in range), under ``group`` the
    vocab-parallel loss on this rank's columns from ``vocab_lo`` (any id)."""
    if group is not None:
        return _VocabParallelNLL.apply(logits, labels, group, int(vocab_lo), float(z_loss))
    lse, label = _vocab_lse_label(logits.float(), labels.long(), None, None)
    nll = lse - label
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
    group: Optional[TensorGroup] = None,
    vocab_lo: int = 0,
) -> torch.Tensor:
    """Mean token-level cross entropy in float32. ``logits`` ``[..., vocab]``
    (under ``group``: this rank's columns from ``vocab_lo``), ``labels``
    ``[...]`` int ids; ``ignore_index`` labels leave the mean; ``z_loss``
    adds the PaLM log-Z regulariser ``z_loss * lse^2``."""
    # an ignored label may lie outside the vocab (e.g. -1): gather at 0
    safe = labels if ignore_index is None else torch.where(labels == ignore_index, 0, labels)
    nll = _nll(logits, safe, z_loss, group, vocab_lo)
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int,
                      group: Optional[TensorGroup] = None, vocab_lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the token losses, count of labels)`` in float32 over the
    labels that are not ``ignore_index``: the pieces of a mean that spans
    several shards (sequence parallelism sums both over the ranks)."""
    nll = _nll(logits, torch.where(labels == ignore_index, 0, labels), 0.0, group, vocab_lo)
    mask = (labels != ignore_index).float()
    return torch.sum(nll * mask), torch.sum(mask)


def next_token_loss(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
    group: Optional[TensorGroup] = None,
    vocab_lo: int = 0,
) -> torch.Tensor:
    """Shifted LM loss: predict ``tokens[..., t + 1]`` from ``logits[..., t, :]``."""
    return cross_entropy_loss(
        logits[..., :-1, :], tokens[..., 1:], ignore_index=ignore_index, z_loss=z_loss, group=group,
        vocab_lo=vocab_lo,
    )


class _ChunkedCrossEntropySum(torch.autograd.Function):
    """``(sum of the token losses, count)`` from hidden states ``h`` ``[B,
    n, d]`` and the head ``w`` ``[d, vocab]`` (under a tensor group: this
    rank's ``V / N`` columns from ``vocab_lo``), ``chunk`` positions at a
    time. Each tile's logits ``(h_c @ w).float()`` live only inside one
    loop iteration, forward and backward: the forward keeps each
    position's lse (``[B, n]`` float32; under a tensor group the tile's
    three reductions), the backward recomputes the tile and accumulates
    ``dh`` (this rank's part, under a tensor group) and ``dw`` from ``(1 +
    2 z lse) softmax - one_hot``, scaled by the mask and the incoming grad
    of the sum."""

    @staticmethod
    def forward(ctx, h, w, targets, valid, chunk: int, z_loss: float, group, vocab_lo: int):
        local, inside = _local_targets(targets, vocab_lo, w.shape[1])
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lse_all = torch.empty(targets.shape, dtype=torch.float32, device=h.device)
        for s in range(0, h.shape[1], chunk):
            logits = (h[:, s:s + chunk] @ w).float()  # [B, chunk, V]: the tile
            lse, label = _vocab_lse_label(logits, local[:, s:s + chunk], inside[:, s:s + chunk], group)
            del logits
            lse_all[:, s:s + chunk] = lse
            nll = lse - label
            if z_loss:
                nll = nll + z_loss * torch.square(lse)
            total = total + torch.sum(nll * valid[:, s:s + chunk])
        ctx.save_for_backward(h, w, local, inside, valid, lse_all)
        ctx.chunk, ctx.z_loss = chunk, z_loss
        return total, torch.sum(valid)

    @staticmethod
    def backward(ctx, d_total, _d_count):
        h, w, local, inside, valid, lse_all = ctx.saved_tensors
        chunk, z_loss = ctx.chunk, ctx.z_loss
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) if ctx.needs_input_grad[1] else None
        for s in range(0, h.shape[1], chunk):
            h_c = h[:, s:s + chunk]
            lse = lse_all[:, s:s + chunk, None]
            probs = torch.exp((h_c @ w).float() - lse)
            if z_loss:
                probs = probs * (1.0 + 2.0 * z_loss * lse)
            probs.scatter_add_(-1, local[:, s:s + chunk, None], -inside[:, s:s + chunk, None].float())
            g = (probs * (valid[:, s:s + chunk, None] * d_total)).to(h.dtype)  # d sum / d tile
            del probs
            if dh is not None:
                dh[:, s:s + chunk] = g @ w.T
            if dw is not None:
                dw += (h_c.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])).float()
        return dh, None if dw is None else dw.to(w.dtype), None, None, None, None, None, None


def chunked_cross_entropy_sum(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk_size: int,
                              ignore_index: Optional[int] = None, z_loss: float = 0.0,
                              group: Optional[TensorGroup] = None,
                              vocab_lo: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the token losses, count of labels)`` in float32 of the
    logits ``hidden @ w`` against ``labels`` (already aligned with
    ``hidden``: no shift here), without the ``[B, n, vocab]`` logits: the
    chunked twin of ``cross_entropy_sum``, for a mean over several shards.
    ``hidden`` ``[B, n, d]``, ``w`` ``[d, vocab]`` (cast to ``hidden``'s
    dtype; under ``group`` this rank's columns from ``vocab_lo``),
    ``labels`` ``[B, n]``; ``ignore_index`` labels leave both sums.
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
                                         float(z_loss), group, int(vocab_lo))


def chunked_next_token_loss(
    hidden: torch.Tensor,
    w_dv: torch.Tensor,
    tokens: torch.Tensor,
    chunk_size: int,
    ignore_index: Optional[int] = None,
    z_loss: float = 0.0,
    group: Optional[TensorGroup] = None,
    vocab_lo: int = 0,
) -> torch.Tensor:
    """``next_token_loss`` from the pre-head hidden states ``hidden`` ``[B,
    T, d]`` (post final norm) and the head ``w_dv`` ``[d, vocab]`` (the tied
    embedding transposed), ``chunk_size`` positions at a time: the last
    position is dropped, the labels shift by one, and the mean is
    ``sum / max(count, 1)``."""
    total, count = chunked_cross_entropy_sum(hidden[:, :-1], w_dv, tokens[:, 1:], chunk_size,
                                             ignore_index=ignore_index, z_loss=z_loss, group=group,
                                             vocab_lo=vocab_lo)
    return total / torch.clamp(count, min=1.0)


def token_log_likelihood(logits: torch.Tensor, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position ``log p(tokens[t + 1] | tokens[<= t])`` ``[..., T - 1]``
    (float32) and whether that token is the greedy choice."""
    logits = logits[..., :-1, :].float()
    targets = tokens[..., 1:].long()
    ll = torch.gather(torch.log_softmax(logits, dim=-1), -1, targets[..., None])[..., 0]
    return ll, torch.argmax(logits, dim=-1) == targets
