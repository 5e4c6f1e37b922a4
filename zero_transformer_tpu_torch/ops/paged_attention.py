"""Paged decode attention: CUDA kernel wrapper, plain version and launch
count.

Counterpart of ``zero_transformer_tpu/ops/pallas/paged_attention.py``
(``paged_attention`` :178, kernel ``_kernel`` :100). The JAX gate
``supported`` has no counterpart: the model routes every decode window of
at most ``MAX_DECODE_T`` tokens here, and a CUDA call the kernel cannot take
raises. The
kernel is ``csrc/paged_attention.cu``; it walks each row's block table
itself and never builds the ``[B, cache_len, KVH, D]`` slab. The plain
version ``paged_reference`` is that slab: gather the row's pages, then the
reference attention with the validity mask ``pos < q_offset + T``. The
wrapper takes it only for CPU tensors; a CUDA tensor launches the kernel or
raises.

The TPU kernel is bitwise equal to the gather path (it stages the whole row
and runs one full softmax); the CUDA kernel splits each row's keys into
256-key parts across CTAs and merges their softmax statistics in a second
pass (one call = both launches), so it matches the gather path to a
tolerance instead. int8 pools are not
ported yet: the wrapper raises on them.
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.ops.attention import xla_attention
from zero_transformer_tpu_torch.ops.flash import HEAD_DIMS, row_offsets, slopes_on

KERNEL = "paged_attention"
# decode window ceiling: 1 (plain decode) .. 1 + draft_k (a verify window);
# longer windows belong to the flash kernel's chunked-prefill path
MAX_DECODE_T = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT = 256  # keys per partial CTA in csrc/paged_attention.cu (SPLIT)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[n_pages, page, KVH, D] through [B, n_blocks] -> the row-major
    [B, n_blocks * page, KVH, D] slab view."""
    B, n_blocks = block_table.shape
    g = pool[block_table.long()]  # [B, n_blocks, page, KVH, D]
    return g.reshape((B, n_blocks * pool.shape[1]) + tuple(pool.shape[2:]))


def gather_window(k_pool, v_pool, block_table, q_offset: torch.Tensor, T: int):
    """The slab a window of ``T`` queries at ``q_offset`` [B] attends over:
    the gathered K and V ``[B, S, KVH, D]`` and the validity mask ``[B, S]``
    (position < q_offset + T)."""
    k = gather_pages(k_pool, block_table)
    v = gather_pages(v_pool, block_table)
    valid = torch.arange(k.shape[1], device=k.device)[None, :] < (q_offset[:, None] + T)
    return k, v, valid


def paged_reference(
    q, k_pool, v_pool, block_table, q_offset, *, causal: bool, alibi: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """The gather-to-slab path the kernel replaces."""
    B, T, _, _ = q.shape
    offs = row_offsets(q_offset, B, q.device)
    k, v, valid = gather_window(k_pool, v_pool, block_table, offs, T)
    return xla_attention(
        q, k, v, causal=causal, alibi=alibi, q_offset=offs, segment_ids=valid,
        softmax_scale=softmax_scale,
    )


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    q_offset,
    *,
    causal: bool,
    alibi: bool = False,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention straight off the page pool. q ``[B, T, H, D]``
    (overflow rows already NaN-poisoned by the caller); pools
    ``[n_pages, page, KVH, D]``; ``block_table`` ``[B, n_blocks]`` int32
    whose entries must be valid page ids (zeros = the trash page);
    ``q_offset`` ``[B]`` or int. Positions ``>= q_offset + T`` are invalid."""
    B, T, H, D = q.shape
    n_pages, page, KVH, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if H % KVH:
        raise ValueError(f"query heads {H} not divisible by kv heads {KVH}")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, n_blocks], got {tuple(block_table.shape)}")
    if k_pool.dtype == torch.int8:
        raise NotImplementedError("int8 KV pools are not ported yet")
    if q.device.type == "cpu":
        return paged_reference(
            q, k_pool, v_pool, block_table, q_offset, causal=causal, alibi=alibi,
            softmax_scale=softmax_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged kernel takes bf16 or f32 q/pools of one dtype, got {q.dtype}/{k_pool.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head width in {HEAD_DIMS}, got {D}")
    if not 1 <= T <= MAX_DECODE_T:
        raise ValueError(f"paged kernel takes decode windows of 1..{MAX_DECODE_T} tokens, got {T}")
    dev = q.device
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    table = block_table.to(device=dev, dtype=torch.int32).contiguous()
    offs = row_offsets(q_offset, B, dev)
    out = torch.empty_like(q)
    # split-KV scratch: each 256-key split's unnormalised output and (m, l)
    n_splits = -(-table.shape[1] * page // _SPLIT)
    part_o = torch.empty((B, n_splits, T, H, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, n_splits, T, H, 2), dtype=torch.float32, device=dev)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    lib = _build.library("paged_attention")
    status = lib.paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(), offs.data_ptr(),
        slopes_on(H, str(dev), alibi).data_ptr(), out.data_ptr(), part_o.data_ptr(),
        part_ml.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, KVH, D, page, table.shape[1], float(scale),
        int(causal), int(alibi), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.LAUNCHES[KERNEL] += 1
    _build.check(status, "paged_attention launch")
    return out
