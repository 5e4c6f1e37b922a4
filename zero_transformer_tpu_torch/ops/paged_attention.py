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
and runs one full softmax); the CUDA kernel splits each row's keys over the
CTAs of one thread-block cluster (``split_plan``) and merges their softmax
statistics inside the cluster, in one launch, so it matches the gather path
to a tolerance instead.

int8 pools (``kv_cache_dtype="int8"``) come with float32 scale pools
``[n_pages, page, KVH, 1]``, one scale per (position, kv head). Every read
dequantizes as the TPU kernel does (``paged_attention.py:134-135``):
``(int8 -> f32) * scale``, then rounded to the compute dtype. Their launches
count apart, as ``paged_attention_int8``.
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.ops.attention import xla_attention
from zero_transformer_tpu_torch.ops.flash import HEAD_DIMS, _slopes_arg, check_aligned, row_offsets, slopes_on

KERNEL = "paged_attention"
KERNEL_INT8 = "paged_attention_int8"
# decode window ceiling: 1 (plain decode) .. 1 + draft_k (a verify window);
# longer windows belong to the flash kernel's chunked-prefill path
MAX_DECODE_T = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPLITS = 8  # CTAs of one cluster: csrc/paged_attention.cu MAX_SPLITS


def split_plan(n_blocks: int, page: int) -> tuple:
    """How the kernel splits a row's ``n_blocks * page`` keys over the CTAs
    of one cluster: ``(keys per CTA, number of CTAs)``. Keys per CTA is the
    least multiple of ``page`` that is at least ``ceil(S / MAX_SPLITS)``, so
    a split never straddles a page and at most ``MAX_SPLITS`` cover the row
    (S 1024 at page 16: 8 CTAs of 128 keys)."""
    S = n_blocks * page
    per = _cdiv(_cdiv(S, MAX_SPLITS), page) * page
    return per, _cdiv(S, per)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[n_pages, page, KVH, D] through [B, n_blocks] -> the row-major
    [B, n_blocks * page, KVH, D] slab view."""
    B, n_blocks = block_table.shape
    g = pool[block_table.long()]  # [B, n_blocks, page, KVH, D]
    return g.reshape((B, n_blocks * pool.shape[1]) + tuple(pool.shape[2:]))


def dequantize(pool: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values with their float32 scales -> ``dtype``: ``(int8 -> f32) *
    scale``, rounded once (JAX ``gpt.py:374-375``)."""
    return (pool.float() * scale).to(dtype)


def gather_window(k_pool, v_pool, block_table, q_offset: torch.Tensor, T: int, *,
                  k_scale=None, v_scale=None, dtype: Optional[torch.dtype] = None):
    """The slab a window of ``T`` queries at ``q_offset`` [B] attends over:
    the gathered K and V ``[B, S, KVH, D]`` and the validity mask ``[B, S]``
    (position < q_offset + T). int8 pools are gathered with their scales and
    dequantized to ``dtype``."""
    k = gather_pages(k_pool, block_table)
    v = gather_pages(v_pool, block_table)
    if k_pool.dtype == torch.int8:
        _check_scales(k_pool, v_pool, k_scale, v_scale)
        k = dequantize(k, gather_pages(k_scale, block_table), dtype)
        v = dequantize(v, gather_pages(v_scale, block_table), dtype)
    valid = torch.arange(k.shape[1], device=k.device)[None, :] < (q_offset[:, None] + T)
    return k, v, valid


def _check_scales(k_pool, v_pool, k_scale, v_scale) -> None:
    if k_scale is None or v_scale is None:
        raise ValueError("int8 pools need k_scale/v_scale pools")
    want = tuple(k_pool.shape[:-1]) + (1,)
    if v_pool.dtype != torch.int8 or tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"int8 pools {tuple(k_pool.shape)} need int8 v and float32 scale pools {want}, got "
                         f"{v_pool.dtype}, {tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"scale pools must be float32, got {k_scale.dtype}/{v_scale.dtype}")


def paged_reference(
    q, k_pool, v_pool, block_table, q_offset, *, causal: bool, alibi: bool = False,
    softmax_scale: Optional[float] = None, k_scale=None, v_scale=None, slopes=None,
) -> torch.Tensor:
    """The gather-to-slab path the kernel replaces (dequantized for int8
    pools); ``slopes`` [H] as in ``paged_attention``."""
    B, T, _, _ = q.shape
    offs = row_offsets(q_offset, B, q.device)
    k, v, valid = gather_window(k_pool, v_pool, block_table, offs, T, k_scale=k_scale, v_scale=v_scale,
                                dtype=q.dtype)
    return xla_attention(
        q, k, v, causal=causal, alibi=alibi, q_offset=offs, segment_ids=valid,
        softmax_scale=softmax_scale, slopes=slopes,
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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention straight off the page pool. q ``[B, T, H, D]``
    (overflow rows already NaN-poisoned by the caller); pools
    ``[n_pages, page, KVH, D]`` in q's dtype, or int8 with float32
    ``k_scale``/``v_scale`` ``[n_pages, page, KVH, 1]``; ``block_table``
    ``[B, n_blocks]`` int32 whose entries must be valid page ids (zeros =
    the trash page); ``q_offset`` ``[B]`` or int. Positions ``>= q_offset +
    T`` are invalid. ``slopes`` ``[H]`` overrides the ALiBi table (JAX
    ``slopes=`` :190): a tensor-parallel shard's query heads are heads
    ``r * H .. (r + 1) * H - 1`` of the model, and attend with their slopes."""
    B, T, H, D = q.shape
    n_pages, page, KVH, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if H % KVH:
        raise ValueError(f"query heads {H} not divisible by kv heads {KVH}")
    if block_table.ndim != 2 or block_table.shape[0] != B or block_table.shape[1] == 0:
        raise ValueError(f"block_table must be [B={B}, n_blocks >= 1], got {tuple(block_table.shape)}")
    int8 = k_pool.dtype == torch.int8
    if int8:
        _check_scales(k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_reference(
            q, k_pool, v_pool, block_table, q_offset, causal=causal, alibi=alibi,
            softmax_scale=softmax_scale, k_scale=k_scale, v_scale=v_scale, slopes=slopes,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES or (not int8 and (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype)):
        raise ValueError(f"paged kernel takes bf16 or f32 q with pools of q's dtype or int8, "
                         f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head width in {HEAD_DIMS}, got {D}")
    if not 1 <= T <= MAX_DECODE_T:
        raise ValueError(f"paged kernel takes decode windows of 1..{MAX_DECODE_T} tokens, got {T}")
    if n_pages * page * KVH >= 2**31:
        raise ValueError(f"paged kernel indexes pool rows in 32 bits: {n_pages} pages of {page} x {KVH} is too many")
    return _launch(q, k_pool, v_pool, block_table, q_offset, causal=causal, alibi=alibi, scale=softmax_scale,
                   k_scale=k_scale, v_scale=v_scale, slopes=slopes)


def _launch(q, k_pool, v_pool, block_table, q_offset, *, causal, alibi, scale, k_scale, v_scale, slopes=None):
    """Launch K4 on checked CUDA tensors, counting the launch. The kernel
    copies the pools 16 bytes at a time (``cp.async``), so they must start
    on a 16-byte boundary (``check_aligned``); q, the table and the scales
    are read by element."""
    B, T, H, D = q.shape
    page, KVH = k_pool.shape[1], k_pool.shape[2]
    int8 = k_pool.dtype == torch.int8
    dev = q.device
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    check_aligned(k_pool, v_pool)
    table = block_table.to(device=dev, dtype=torch.int32).contiguous()
    per_split, n_splits = split_plan(table.shape[1], page)
    offs = row_offsets(q_offset, B, dev)
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / (D**0.5)
    lib = _build.library("paged_attention")
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    table_slopes = _slopes_arg(slopes, H, dev, alibi) if alibi else slopes_on(H, str(dev), False)
    tail = (table.data_ptr(), offs.data_ptr(), table_slopes.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, T, H, KVH, D, page, table.shape[1], per_split, n_splits, float(scale),
            int(causal), int(alibi), torch.cuda.current_stream(dev).cuda_stream)
    if int8:
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        status = lib.paged_attention_int8(*head, k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        _build.LAUNCHES[KERNEL_INT8] += 1
    else:
        status = lib.paged_attention(*head, *tail)
        _build.LAUNCHES[KERNEL] += 1
    _build.check(status, f"{KERNEL_INT8 if int8 else KERNEL} launch")
    return out
