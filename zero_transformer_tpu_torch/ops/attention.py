"""Attention ops: the plain PyTorch reference and the dispatching entry point.

Counterpart of ``zero_transformer_tpu/ops/attention.py``. ``xla_attention``
keeps its JAX name: it is the always-correct reference path, written as
plain tensor code (the JAX package leaves it to XLA), with scores and
softmax in float32 and the biases added in the JAX order: ALiBi plus the
causal mask as one bias, then the validity (segment) mask, then the
packed-document mask.

``dot_product_attention`` dispatches between it and the hand-written CUDA
flash kernel (``ops.flash_attention``): ``impl="xla"`` always takes the
reference, ``"auto"`` takes it for CPU tensors only, and otherwise (and
always for ``"flash"``) the call takes the kernel or raises with the
condition the gate declined.
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops.positions import (
    NEG_INF,
    alibi_bias,
    alibi_slopes,
    causal_mask_bias,
)


def _mask(cond: torch.Tensor) -> torch.Tensor:
    """0 where ``cond`` holds, NEG_INF elsewhere, in float32."""
    zero = torch.zeros((), dtype=torch.float32, device=cond.device)
    return torch.where(cond, zero, torch.full_like(zero, NEG_INF))


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    alibi: bool = False,
    q_offset=0,
    segment_ids: Optional[torch.Tensor] = None,
    doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention via explicit einsums, scores and softmax in float32.

    q ``[B, Tq, H, D]``; k, v ``[B, Tkv, KVH, D]`` with KVH dividing H (GQA).
    ``q_offset`` is the position of q[:, 0]: an int, a 0-d tensor, or a
    ``[B]`` tensor when every row sits at its own position.
    ``segment_ids`` ``[B, Tkv]``: 0 = not valid (masked out).
    ``doc_ids`` ``[B, T]`` (Tq == Tkv): different ids cannot attend.
    """
    B, Tq, H, D = q.shape
    _, Tkv, KVH, _ = k.shape
    G = H // KVH
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)

    qg = q.reshape(B, Tq, KVH, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    scores = scores * scale

    per_row = torch.is_tensor(q_offset) and q_offset.ndim == 1
    if per_row:
        q_pos = q_offset.to(dev, torch.int32)[:, None] + torch.arange(Tq, dtype=torch.int32, device=dev)
        kv_pos = torch.arange(Tkv, dtype=torch.int32, device=dev)
        if alibi:
            s = alibi_slopes(H, dev)
            dist = torch.clamp(q_pos[:, :, None] - kv_pos[None, None, :], min=0).float()
            bias = -s[None, :, None, None] * dist[:, None]  # [B, H, Tq, Tkv]
            if causal:
                bias = bias + _mask(kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
            scores = scores + bias.reshape(B, KVH, G, Tq, Tkv)
        elif causal:
            visible = kv_pos[None, None, :] <= q_pos[:, :, None]
            scores = scores + _mask(visible)[:, None, None]
    else:
        off = int(q_offset)
        if alibi:
            bias = alibi_bias(H, Tq, Tkv, offset=off, device=dev)
            if causal:
                bias = bias + causal_mask_bias(Tq, Tkv, offset=off, device=dev)[None]
            scores = scores + bias.reshape(1, KVH, G, Tq, Tkv)
        elif causal:
            scores = scores + causal_mask_bias(Tq, Tkv, offset=off, device=dev)[None, None, None]
    if segment_ids is not None:
        scores = scores + _mask(segment_ids != 0)[:, None, None, None, :]
    if doc_ids is not None:
        if Tq != Tkv:
            raise ValueError("doc_ids requires full-sequence shapes (Tq == Tkv)")
        same = doc_ids[:, :, None] == doc_ids[:, None, :]
        scores = scores + _mask(same)[:, None, None]

    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v.to(q.dtype))
    return out.reshape(B, Tq, H, D)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    alibi: bool = False,
    q_offset=0,
    segment_ids: Optional[torch.Tensor] = None,
    doc_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention entry point used by the model."""
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"invalid attention impl {impl!r}")
    if impl == "xla" or (impl == "auto" and q.device.type == "cpu"):
        return xla_attention(
            q, k, v, causal=causal, alibi=alibi, q_offset=q_offset,
            segment_ids=segment_ids, doc_ids=doc_ids,
        )
    from zero_transformer_tpu_torch.ops import flash_attention as fa

    # kernel-or-raise: off the CPU nothing silently takes the reference
    reason = fa.decline_reason(
        q, k, v, causal=causal, alibi=alibi, q_offset=q_offset,
        segment_ids=segment_ids, doc_ids=doc_ids,
    )
    if reason is not None:
        raise NotImplementedError(
            f"flash attention (impl={impl!r}) declines q={tuple(q.shape)} {q.dtype} "
            f"on {q.device}, k={tuple(k.shape)}: {reason}"
        )
    return fa.flash_attention(
        q, k, v, causal=causal, alibi=alibi, q_offset=q_offset,
        segment_ids=segment_ids, doc_ids=doc_ids,
    )
