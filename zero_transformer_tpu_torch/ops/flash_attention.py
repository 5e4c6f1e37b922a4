"""Flash attention dispatch gate for ``ops.attention.dot_product_attention``.

Counterpart of ``zero_transformer_tpu/ops/flash_attention.py``. ``supported``
decides whether the CUDA flash kernel (``ops.flash``) handles a call and
``decline_reason`` says why not (the dispatcher raises with it);
``flash_attention`` runs the kernel. The gate's rules are the card's:

- CUDA tensors only (on the CPU the reference path runs);
- q, k, v of one dtype, bfloat16 or float32;
- head width 64 or 128 (the kernel's template instances);
- H divisible by KVH; a validity mask, when given, of shape ``[B, S]``;
- an int, 0-d or ``[B]`` query offset (any window length is a legal tile:
  the kernel masks its ragged last query tile and key tile itself);
- no packed-document mask and no gradient: the kernel is the serving
  forward; the differentiable training kernels come with the training slice.

The gate and the wrapper share ONE keyword surface (pinned by test): the
gate may never inspect a keyword the wrapper then drops.
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops.flash import HEAD_DIMS, flash_serving


def decline_reason(
    q, k, v, *, causal: bool, alibi: bool = False, q_offset=0,
    segment_ids=None, doc_ids=None,
) -> Optional[str]:
    """Why the kernel cannot take this call, or None when it can."""
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        return f"tensors not all on one CUDA device ({q.device}, {k.device}, {v.device})"
    if H % KVH or T == 0 or S == 0:
        return f"H={H}, KVH={KVH}, T={T}, S={S}"
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        return f"dtypes {q.dtype}/{k.dtype}/{v.dtype} (one of bf16, f32)"
    if D not in HEAD_DIMS:
        return f"head width {D} not in {HEAD_DIMS}"
    if doc_ids is not None:
        return "packed-document mask (doc_ids)"
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return "an input requires grad (the kernel is forward only)"
    if torch.is_tensor(q_offset) and q_offset.ndim not in (0, 1):
        return f"q_offset of rank {q_offset.ndim}"
    if torch.is_tensor(q_offset) and q_offset.ndim == 1 and q_offset.shape[0] != B:
        return f"q_offset of {q_offset.shape[0]} rows for B={B}"
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        return f"segment_ids {tuple(segment_ids.shape)} not [B, S] = {(B, S)}"
    # causal and alibi impose no shape constraint; both are threaded to the
    # kernel below (the signature-parity test pins that)
    return None


def supported(
    q, k, v, *, causal: bool, alibi: bool = False, q_offset=0,
    segment_ids=None, doc_ids=None,
) -> bool:
    return decline_reason(
        q, k, v, causal=causal, alibi=alibi, q_offset=q_offset,
        segment_ids=segment_ids, doc_ids=doc_ids,
    ) is None


def flash_attention(
    q, k, v, *, causal: bool = True, alibi: bool = False, q_offset=0,
    segment_ids=None, doc_ids=None,
) -> torch.Tensor:
    """Kernel wrapper with EXACTLY the gate's keyword surface."""
    if doc_ids is not None:
        raise NotImplementedError("the packed-document mask is not ported to the CUDA kernel yet")
    return flash_serving(
        q, k, v, causal=causal, alibi=alibi, q_offset=q_offset, segment_ids=segment_ids,
    )
