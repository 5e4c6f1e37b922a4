"""Flash attention forward for the serving cache shapes: CUDA kernel wrapper,
plain version and launch count.

Counterpart of ``zero_transformer_tpu/ops/pallas/flash.py::flash_serving``
(:504) and its kernel ``_fwd``/``_fwd_kernel`` (:292, :127). The kernel is
``csrc/flash_fwd.cu``. ``flash_serving`` takes the kernel for CUDA tensors
and the plain version ``flash_reference`` only for CPU tensors; a tensor on
any other device raises, and nothing falls back.

The serving caller passes a per-row ``[B]`` query offset (every slot's
prefill window starts at its own position) and a ``[B, S]`` kv-validity
mask. Forward only: the training slice adds the differentiable entry.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes_list

KERNEL = "flash_serving_fwd"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def slopes_on(n_heads: int, device: str, alibi: bool) -> torch.Tensor:
    """[H] f32 ALiBi slopes (zeros without ALiBi), kept on ``device`` so a
    launch never copies them from the host."""
    values = alibi_slopes_list(n_heads) if alibi else (0.0,) * n_heads
    return torch.tensor(values, dtype=torch.float32, device=device)


def row_offsets(q_offset, B: int, device) -> torch.Tensor:
    """[B] int32 query offsets: an int or 0-d tensor broadcasts, a [B]
    tensor passes through."""
    if torch.is_tensor(q_offset):
        return q_offset.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(q_offset), dtype=torch.int32, device=device)


def _check(q, k, v, segment_ids):
    B, T, H, D = q.shape
    Bk, S, KVH, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} disagree")
    if H % KVH:
        raise ValueError(f"query heads {H} not divisible by kv heads {KVH}")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        raise ValueError(f"segment_ids must be [B, S] = {(B, S)}, got {tuple(segment_ids.shape)}")


def flash_reference(
    q, k, v, *, causal: bool = True, alibi: bool = False, q_offset=0,
    segment_ids: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: the same scores, biases and masks in
    float32, a full softmax, probabilities kept in float32 through the
    output product. Returns ``(out [B, T, H, D] in q's dtype, lse [B, H, T])``."""
    _check(q, k, v, segment_ids)
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    G = H // KVH
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * scale
    offs = row_offsets(q_offset, B, dev)
    q_pos = offs[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
    dist = q_pos[:, :, None] - torch.arange(S, dtype=torch.int32, device=dev)  # [B, T, S]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full_like(zero, NEG_INF)
    bias = torch.zeros(B, 1, T, S, dtype=torch.float32, device=dev)
    if alibi:
        slopes = slopes_on(H, str(dev), True)
        bias = bias - slopes[None, :, None, None] * torch.clamp(dist, min=0).float()[:, None]
    if causal:
        bias = bias + torch.where(dist >= 0, zero, neg)[:, None]
    s = s + bias
    if segment_ids is not None:
        s = s + torch.where(segment_ids != 0, zero, neg)[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, vf).to(q.dtype)
    return out, lse


def flash_serving(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    alibi: bool = False,
    q_offset=0,
    segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Forward-only flash attention. q ``[B, T, H, D]``; k, v ``[B, S, KVH, D]``;
    ``q_offset`` int or ``[B]``; ``segment_ids`` ``[B, S]`` (0 = invalid).
    Returns the output, or ``(output, lse [B, H, T] f32)`` with ``return_lse``."""
    _check(q, k, v, segment_ids)
    if q.device.type == "cpu":
        out, lse = flash_reference(
            q, k, v, causal=causal, alibi=alibi, q_offset=q_offset,
            segment_ids=segment_ids, softmax_scale=softmax_scale,
        )
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_serving runs on CUDA or CPU tensors, got {q.device}")
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head width in {HEAD_DIMS}, got {D}")
    if B == 0 or T == 0 or S == 0:
        raise ValueError("flash kernel needs non-empty q and k")
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    offs = row_offsets(q_offset, B, dev)
    seg = None if segment_ids is None else segment_ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev) if return_lse else None
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    lib = _build.library("flash_fwd")
    status = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        slopes_on(H, str(dev), alibi).data_ptr(), offs.data_ptr(),
        None if seg is None else seg.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        _DTYPE_CODES[q.dtype], B, T, S, H, KVH, D, float(scale), int(causal), int(alibi),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.LAUNCHES[KERNEL] += 1
    _build.check(status, "flash_fwd launch")
    return (out, lse) if return_lse else out
