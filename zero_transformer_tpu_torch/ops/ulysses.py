"""Ulysses sequence parallelism: all-to-all context-parallel attention.

Counterpart of ``zero_transformer_tpu/ops/ulysses.py`` (``_ulysses_body``
:56, ``ulysses_attention`` :114): the second context-parallel
engine beside ``ops/ring_attention.py``. Each rank of a ``SequenceGroup`` of
n holds a shard ``[B, T/n, H, D]`` of q, k and v. Three all-to-alls
(``SequenceGroup.all_to_all_``) re-shard them to ``[B, T, H/n, D]``: head
chunk j goes to rank j, the time chunks concatenate in rank order, so rank
s owns the global heads ``s·H/n .. (s+1)·H/n - 1`` over the whole row (under
a tensor group of N, whose rank t holds the heads ``t·H ..`` of ``H·N``, the
heads ``t·H + s·H/n ..``: JAX's offset :78-81). The rank then makes ONE
attention call over the full T with the ALiBi slopes of that head range (on CUDA tensors the differentiable flash entry: K1
forward, K2/K3 backward), with the packed-document ids all-gathered (they
are ``[B, T]`` ints, tiny). One all-to-all takes the output back to the
rank's time shard over every head.

The all-to-all is an autograd Function whose backward is the inverse
all-to-all (split and concat dims swapped), so autograd composes it with
the flash entry's own backward: the backward runs K2/K3 over the full T,
between two all-to-alls of the grads. Every rank runs the same collectives
in the same order, the recompute under remat included.

The head dimension is the parallel resource: n must divide the query AND
the kv heads (GQA groups stay aligned because H/KVH is preserved); the
ring takes few-headed models.
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops.attention import dot_product_attention
from zero_transformer_tpu_torch.ops.flash import slopes_on
from zero_transformer_tpu_torch.ops.ring_attention import _validate_cp_shapes
from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup, TensorGroup


class _AllToAll(torch.autograd.Function):
    """``group.all_to_all_(x, split_dim, concat_dim)``; its backward is the
    inverse all-to-all of the grad."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return group.all_to_all_(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all_(g.contiguous(), ctx.concat_dim, ctx.split_dim), None, None, None


def all_to_all(x: torch.Tensor, group: SequenceGroup, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Differentiable ``lax.all_to_all(..., tiled=True)`` over ``group``."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def validate_ulysses_shapes(t_q: int, t_kv: int, H: int, KVH: int, n: int) -> None:
    """JAX's entry guards (``ulysses_attention`` :140-147 and
    ``_validate_cp_shapes``), on this rank's shards."""
    _validate_cp_shapes("ulysses", t_q, t_kv, H, KVH)
    if H % n or KVH % n:
        raise ValueError(
            f"ulysses needs the sequence axis ({n}) to divide the tensor-local head counts ({H} query / {KVH} kv); "
            f"use cp_impl='ring' for few-headed models")


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: SequenceGroup, *,
    causal: bool = True, alibi: bool = False, doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None, impl: str = "auto", tensor_group: Optional[TensorGroup] = None,
) -> torch.Tensor:
    """Differentiable Ulysses attention on this rank's shards: q ``[B, t, H,
    D]`` and k, v ``[B, t, KVH, D]`` at global positions ``[rank * t, (rank
    + 1) * t)`` of a row of ``group.size * t`` tokens; ``doc_ids`` ``[B, t]``
    the shard's packed-document ids; under ``tensor_group`` the ``H`` heads
    are the rank's slice of ``H x N``. Returns this rank's output ``[B, t, H,
    D]`` of attention over the whole row. ``impl`` is the model's
    ``attention_impl`` for the local full-row call."""
    n = group.size
    B, t, H, D = q.shape
    KVH = k.shape[2]
    validate_ulysses_shapes(t, k.shape[1], H, KVH, n)
    if doc_ids is not None and tuple(doc_ids.shape) != (B, t):
        raise ValueError(f"doc_ids must be this shard's [B, t] = {(B, t)}, got {tuple(doc_ids.shape)}")
    if softmax_scale is not None:
        raise NotImplementedError("the Ulysses engine attends at the model's 1/sqrt(D) scale")
    # [B, t, h, D] -> [B, T, h/n, D]: head chunk j to rank j, time chunks in rank order
    qf, kf, vf = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    ids = None if doc_ids is None else group.all_gather_dim(doc_ids.detach().to(torch.int32), 1)
    h_loc = H // n
    slopes = None
    if alibi:
        tp = 1 if tensor_group is None else tensor_group.size
        lo = group.rank * h_loc + (0 if tp == 1 else tensor_group.rank * H)
        slopes = slopes_on(H * tp, str(q.device), True)[lo:lo + h_loc]
    out = dot_product_attention(qf, kf, vf, causal=causal, alibi=alibi, doc_ids=ids, impl=impl, slopes=slopes)
    # head-sharded back to seq-sharded: time chunk j to rank j, heads in rank order
    return all_to_all(out, group, 1, 2)
