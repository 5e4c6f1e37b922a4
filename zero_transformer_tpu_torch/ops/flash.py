"""Flash attention: CUDA kernel wrappers, plain versions and launch counts.

Counterpart of ``zero_transformer_tpu/ops/pallas/flash.py``:

- ``flash_serving`` (:504), forward only, for the serving cache shapes: a
  per-row ``[B]`` query offset (every slot's prefill window starts at its
  own position) and a ``[B, S]`` kv-validity mask. Kernel K1
  (``_fwd``/``_fwd_kernel``, :292/:127) in ``csrc/flash_fwd.cu``.
- ``flash_attention`` (:462), the differentiable training entry: a
  ``torch.autograd.Function`` in place of the custom VJP ``_flash``
  (:421-448). Its forward is K1 with the lse; its backward computes
  ``delta = rowsum(do * o)`` in f32, then K2 (``_dq_kernel`` :176) and K3
  (``_dkv_kernel`` :214), both in ``csrc/flash_bwd.cu``; K3 sums the GQA
  group to the kv heads itself. With ``doc_ids`` [B, T] (packed documents,
  T == S) all three kernels add the document mask of ``_scores`` (:108-110)
  after the ALiBi + causal bias; the ids cross to the kernels as int32 (JAX
  encodes them as f32: the same equality test).
- ``flash_partial`` (:551) and ``flash_grads`` (:577), the building blocks
  of ring attention (``ops/ring_attention.py``): the same three kernels at
  global query and key offsets (``_offsets_arg`` :264, ``[2, B]``), with
  separate query and key document ids (``_ids_args`` :277), the caller's
  slope table, f32 outputs from bf16 inputs, and (backward) the caller's
  GLOBAL lse and delta. A row that sees no key of the shard (causal,
  ``q_pos < kv_off``) gets ``o = 0`` and ``lse = -1e30`` (``_INIT_M``), as
  the TPU kernel's ``_write`` leaves a row whose every tile it skipped.

Every wrapper takes its kernel for CUDA tensors and its plain version
(``flash_reference``, ``flash_bwd_reference`` and their ``flash_partial_``
/ ``flash_grads_`` forms) only for CPU tensors; a tensor on any other
device raises, and nothing falls back. Launch counts:
``flash_serving_fwd`` and ``flash_train_fwd`` (K1 by entry), ``flash_dq``,
``flash_dkv``, ``flash_partial_fwd``, ``flash_partial_dq``,
``flash_partial_dkv``, and the document-masked launches of each training
and partial kernel apart under ``_docs``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes_list

KERNEL = "flash_serving_fwd"
TRAIN_KERNEL = "flash_train_fwd"
PARTIAL_KERNEL = "flash_partial_fwd"
DOCS = "_docs"  # suffix of the document-masked launch counts
HEAD_DIMS = (64, 128)
INIT_M = -1e30  # flash.py _INIT_M: the lse of a row that sees no key
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def slopes_on(n_heads: int, device: str, alibi: bool) -> torch.Tensor:
    """[H] f32 ALiBi slopes (zeros without ALiBi), kept on ``device`` so a
    launch never copies them from the host."""
    values = alibi_slopes_list(n_heads) if alibi else (0.0,) * n_heads
    return torch.tensor(values, dtype=torch.float32, device=device)


def _slopes_arg(slopes: Optional[torch.Tensor], n_heads: int, dev, alibi: bool) -> torch.Tensor:
    """The [H] f32 slope table a call uses: the caller's (``flash.py``'s
    ``slopes=`` override, e.g. a tensor-parallel shard's heads) or the model's."""
    if slopes is None:
        return slopes_on(n_heads, str(dev), alibi)
    slopes = slopes.detach().to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    if slopes.numel() != n_heads:
        raise ValueError(f"slopes must hold one value per query head ({n_heads}), got {slopes.numel()}")
    return slopes


def row_offsets(q_offset, B: int, device) -> torch.Tensor:
    """[B] int32 query offsets: an int or 0-d tensor broadcasts, a [B]
    tensor passes through."""
    if torch.is_tensor(q_offset):
        return q_offset.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(q_offset), dtype=torch.int32, device=device)


def offsets_arg(q_offset, kv_offset, B: int, device) -> torch.Tensor:
    """[2, B] int32 (row 0 the query offsets, row 1 the key offsets), the
    kernels' offsets operand (``flash.py::_offsets_arg`` :264). Int offsets
    (training, the ring) come from a cache, so a launch adds no kernels."""
    if isinstance(q_offset, int) and isinstance(kv_offset, int):
        return _int_offsets(q_offset, kv_offset, B, str(device))
    return torch.stack([row_offsets(q_offset, B, device), row_offsets(kv_offset, B, device)])


@functools.lru_cache(maxsize=256)
def _int_offsets(q_offset: int, kv_offset: int, B: int, device: str) -> torch.Tensor:
    return torch.tensor([[q_offset] * B, [kv_offset] * B], dtype=torch.int32, device=device)


def _check(q, k, v, segment_ids, doc_ids=None, q_ids=None, k_ids=None):
    B, T, H, D = q.shape
    Bk, S, KVH, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} disagree")
    if H % KVH:
        raise ValueError(f"query heads {H} not divisible by kv heads {KVH}")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        raise ValueError(f"segment_ids must be [B, S] = {(B, S)}, got {tuple(segment_ids.shape)}")
    if doc_ids is not None and (T != S or tuple(doc_ids.shape) != (B, T)):
        raise ValueError(f"doc_ids need full-sequence shapes (T == S) and [B, T] ids; "
                         f"got T={T}, S={S}, doc_ids {tuple(doc_ids.shape)}")
    if (q_ids is None) != (k_ids is None):
        raise ValueError("q_ids and k_ids go together: both or neither")
    if q_ids is not None and (tuple(q_ids.shape) != (B, T) or tuple(k_ids.shape) != (B, S)):
        raise ValueError(f"q_ids must be [B, T] = {(B, T)} and k_ids [B, S] = {(B, S)}; "
                         f"got {tuple(q_ids.shape)} and {tuple(k_ids.shape)}")


def _positions(B, T, S, q_offset, kv_offset, dev) -> torch.Tensor:
    """[B, T, S] int32 global distances q_pos - k_pos."""
    q_pos = row_offsets(q_offset, B, dev)[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
    k_pos = row_offsets(kv_offset, B, dev)[:, None] + torch.arange(S, dtype=torch.int32, device=dev)
    return q_pos[:, :, None] - k_pos[:, None, :]


def _score_bias(dist, H, causal, alibi, slopes=None) -> torch.Tensor:
    """[B, H or 1, T, S] f32: ALiBi plus the causal mask as one bias over
    the global distances ``dist`` [B, T, S], the kernels' order
    (``csrc/flash_common.cuh``)."""
    dev = dist.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.zeros(dist.shape[0], 1, *dist.shape[1:], dtype=torch.float32, device=dev)
    if alibi:
        table = _slopes_arg(slopes, H, dev, True)
        bias = bias - table[None, :, None, None] * torch.clamp(dist, min=0).float()[:, None]
    if causal:
        bias = bias + torch.where(dist >= 0, zero, torch.full_like(zero, NEG_INF))[:, None]
    return bias


def _doc_bias(q_ids: torch.Tensor, k_ids: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, S] f32: NEG_INF between a query and a key of different
    documents (``_scores``' doc term, added after the ALiBi + causal bias)."""
    zero = torch.zeros((), dtype=torch.float32, device=q_ids.device)
    same = q_ids[:, :, None] == k_ids[:, None, :]
    return torch.where(same, zero, torch.full_like(zero, NEG_INF))[:, None]


def _scores(q, k, *, causal, alibi, scale, q_offset, kv_offset, slopes, q_ids, k_ids, segment_ids=None):
    """[B, H, T, S] f32 scores of the plain versions, in ``_scores``' order:
    s * scale + (ALiBi + causal), + documents, + validity. Also returns the
    global distances [B, T, S]."""
    B, T, H, _ = q.shape
    _, S, KVH, _ = k.shape
    kf = k.float().repeat_interleave(H // KVH, dim=2)
    dist = _positions(B, T, S, q_offset, kv_offset, q.device)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * scale
    s = s + _score_bias(dist, H, causal, alibi, slopes)
    if q_ids is not None:
        s = s + _doc_bias(q_ids, k_ids)
    if segment_ids is not None:
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        s = s + torch.where(segment_ids != 0, zero, torch.full_like(zero, NEG_INF))[:, None, None, :]
    return s, dist


def _dead_rows(dist: torch.Tensor, causal: bool) -> Optional[torch.Tensor]:
    """[B, 1, T] bool: rows that see no key at all under the causal limit
    (every global distance negative: a future shard), or None."""
    if not causal or dist.shape[2] == 0:
        return None
    dead = (dist.amax(dim=2) < 0)[:, None, :]
    return dead if bool(dead.any()) else None


def flash_reference(
    q, k, v, *, causal: bool = True, alibi: bool = False, q_offset=0,
    segment_ids: Optional[torch.Tensor] = None, doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None, kv_offset=0, slopes: Optional[torch.Tensor] = None,
    q_ids: Optional[torch.Tensor] = None, k_ids: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1: the same scores, biases and masks in
    float32 and in the kernels' order (ALiBi + causal, then documents, then
    validity), a full softmax, probabilities kept in float32 through the
    output product. ``doc_ids`` [B, T] masks one sequence against itself;
    ``q_ids`` [B, T] / ``k_ids`` [B, S] mask a query shard against a key
    shard at global offsets ``q_offset`` / ``kv_offset``. A row that sees no
    key (causal, every key after it) gets ``o = 0`` and ``lse = INIT_M``.
    Returns ``(out [B, T, H, D] in out_dtype or q's dtype, lse [B, H, T])``."""
    _check(q, k, v, segment_ids, doc_ids, q_ids, k_ids)
    if doc_ids is not None:
        q_ids = k_ids = doc_ids
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    s, dist = _scores(q, k, causal=causal, alibi=alibi, scale=scale, q_offset=q_offset,
                      kv_offset=kv_offset, slopes=slopes, q_ids=q_ids, k_ids=k_ids,
                      segment_ids=segment_ids)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(H // KVH, dim=2)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    dead = _dead_rows(dist, causal)
    if dead is not None:
        lse = torch.where(dead, torch.full_like(lse, INIT_M), lse)
        out = torch.where(dead.transpose(1, 2)[..., None], torch.zeros_like(out), out)
    return out.to(out_dtype or q.dtype), lse


def flash_partial_reference(q, k, v, *, causal: bool, alibi: bool, softmax_scale=None, q_offset=0,
                            kv_offset=0, slopes=None, q_ids=None, k_ids=None):
    """The plain version of ``flash_partial``: ``flash_reference`` at global
    offsets with separate ids, the output in float32."""
    return flash_reference(q, k, v, causal=causal, alibi=alibi, softmax_scale=softmax_scale,
                           q_offset=q_offset, kv_offset=kv_offset, slopes=slopes, q_ids=q_ids,
                           k_ids=k_ids, out_dtype=torch.float32)


def flash_bwd_reference(
    q, k, v, o, lse, do, *, causal: bool = True, alibi: bool = False,
    doc_ids: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None,
    q_offset=0, kv_offset=0, slopes: Optional[torch.Tensor] = None,
    q_ids: Optional[torch.Tensor] = None, k_ids: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None, grad_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2 and K3, the flash backward written out in
    float32 from the forward's ``o`` and ``lse`` [B, H, T]:
    ``p = exp(s - lse)``, ``dp = do . v^T``, ``delta = rowsum(do * o)``
    (or the caller's [B, H, T]), ``ds = p * (dp - delta)``,
    ``dq = scale * ds . k``, ``dk = scale * ds^T . q``, ``dv = p^T . do``,
    dk/dv summed over each kv head's query group; the scores carry the
    forward's biases at its offsets, the document mask included. Returns
    ``(dq, dk, dv)`` in ``grad_dtype`` or q's, k's, v's dtypes."""
    _check(q, k, v, None, doc_ids, q_ids, k_ids)
    if doc_ids is not None:
        q_ids = k_ids = doc_ids
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    G = H // KVH
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s, _ = _scores(q, k, causal=causal, alibi=alibi, scale=scale, q_offset=q_offset,
                   kv_offset=kv_offset, slopes=slopes, q_ids=q_ids, k_ids=k_ids)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    if delta is None:
        delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - delta.float()[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    if G > 1:
        dk = dk.reshape(B, S, KVH, G, D).sum(3)
        dv = dv.reshape(B, S, KVH, G, D).sum(3)
    return dq.to(grad_dtype or q.dtype), dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)


def flash_grads_reference(q, k, v, o, lse, do, *, causal: bool, alibi: bool, softmax_scale=None,
                          q_offset=0, kv_offset=0, slopes=None, delta=None, q_ids=None, k_ids=None):
    """The plain version of ``flash_grads``: ``flash_bwd_reference`` at
    global offsets with separate ids and the caller's delta, grads in
    float32."""
    return flash_bwd_reference(q, k, v, o, lse, do, causal=causal, alibi=alibi,
                               softmax_scale=softmax_scale, q_offset=q_offset, kv_offset=kv_offset,
                               slopes=slopes, q_ids=q_ids, k_ids=k_ids, delta=delta,
                               grad_dtype=torch.float32)


def _check_kernel_inputs(q, k, v, what: str) -> None:
    """Raise on what the CUDA kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head width in {HEAD_DIMS}, got {q.shape[-1]}")
    if q.shape[0] == 0 or q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash kernel needs non-empty q and k")


def check_aligned(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the bf16
    backward kernels copy q, k, v and do into shared memory 16 bytes at a
    time (``cp.async``). Their rows, H * D * 2 bytes apart, are then aligned
    too."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the bf16 flash backward needs 16-byte aligned q/k/v/do; got a {tuple(t.shape)} "
                             f"tensor at an address 16n + {t.data_ptr() % 16}")


def _ids_arg(ids: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    """An optional id or mask tensor as the contiguous int32 the kernels read."""
    return None if ids is None else ids.to(device=dev, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _out_code(q: torch.Tensor, out_dtype: Optional[torch.dtype]) -> int:
    """The kernels' output dtype code: q's dtype, or float32 (only that
    for float32 inputs; bf16 inputs may write either)."""
    out_dtype = out_dtype or q.dtype
    if out_dtype not in _DTYPE_CODES or (q.dtype == torch.float32 and out_dtype != torch.float32):
        raise ValueError(f"flash kernels write bf16 or f32 from bf16 inputs and f32 from f32 inputs, "
                         f"not {out_dtype} from {q.dtype}")
    return _DTYPE_CODES[out_dtype]


def _launch_fwd(q, k, v, *, causal, alibi, q_offset, segment_ids, scale, want_lse, counter,
                doc_ids=None, kv_offset=0, q_ids=None, k_ids=None, slopes=None, out_dtype=None):
    """Launch K1 on CUDA tensors, counting the launch under ``counter``
    (with document ids, under ``counter + "_docs"``). ``doc_ids`` serves as
    both ``q_ids`` and ``k_ids``."""
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if doc_ids is not None:
        q_ids = k_ids = doc_ids
    offs = offsets_arg(q_offset, kv_offset, B, dev)
    seg, qid, kid = _ids_arg(segment_ids, dev), _ids_arg(q_ids, dev), _ids_arg(k_ids, dev)
    code = _out_code(q, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev) if want_lse else None
    lib = _build.library("flash_fwd")
    status = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _slopes_arg(slopes, H, dev, alibi).data_ptr(),
        offs.data_ptr(), _ptr(seg), _ptr(qid), _ptr(kid), out.data_ptr(), _ptr(lse),
        _DTYPE_CODES[q.dtype], code, B, T, S, H, KVH, D, float(scale), int(causal), int(alibi),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.LAUNCHES[counter + (DOCS if qid is not None else "")] += 1
    _build.check(status, "flash_fwd launch")
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
    _check_kernel_inputs(q, k, v, "flash_serving")
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    out, lse = _launch_fwd(
        q, k, v, causal=causal, alibi=alibi, q_offset=q_offset, segment_ids=segment_ids,
        scale=scale, want_lse=return_lse, counter=KERNEL,
    )
    return (out, lse) if return_lse else out


def _bwd_args(q, k, v, do, lse, delta, causal, alibi, scale, q_offset, kv_offset, q_ids, k_ids,
              slopes, out_dtype):
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    dev = q.device
    if q.dtype == torch.bfloat16:
        check_aligned(q, k, v, do)
    offs = offsets_arg(q_offset, kv_offset, B, dev)
    qid, kid = _ids_arg(q_ids, dev), _ids_arg(k_ids, dev)
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
    ptrs += [_slopes_arg(slopes, H, dev, alibi).data_ptr(), offs.data_ptr(), _ptr(qid), _ptr(kid)]
    ints = [_DTYPE_CODES[q.dtype], _out_code(q, out_dtype), B, T, S, H, KVH, D]
    tail = [float(scale), int(causal), int(alibi), torch.cuda.current_stream(dev).cuda_stream]
    # the offsets and ids must outlive the launch call: returned with it
    return ptrs, ints, tail, (offs, qid, kid), qid is not None


def launch_dq(q, k, v, do, lse, delta, *, causal, alibi, scale, doc_ids=None, q_offset=0, kv_offset=0,
              q_ids=None, k_ids=None, slopes=None, out_dtype=None, counter="flash_dq") -> torch.Tensor:
    """K2 on contiguous CUDA tensors: dq [B, T, H, D] in ``out_dtype`` or q's
    dtype. ``doc_ids`` serves as both ``q_ids`` and ``k_ids``. bf16 inputs
    take the wgmma kernel (16-byte aligned, ``check_aligned``), f32 inputs
    the FMA one."""
    if doc_ids is not None:
        q_ids = k_ids = doc_ids
    dq = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    ptrs, ints, tail, _keep, docs = _bwd_args(q, k, v, do, lse, delta, causal, alibi, scale, q_offset,
                                              kv_offset, q_ids, k_ids, slopes, out_dtype)
    status = _build.library("flash_bwd").flash_dq(*ptrs, dq.data_ptr(), *ints, *tail)
    _build.LAUNCHES[counter + (DOCS if docs else "")] += 1
    _build.check(status, "flash_dq launch")
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal, alibi, scale, doc_ids=None, q_offset=0, kv_offset=0,
               q_ids=None, k_ids=None, slopes=None, out_dtype=None,
               counter="flash_dkv") -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on contiguous CUDA tensors: (dk, dv) [B, S, KVH, D] in
    ``out_dtype`` or k's dtype."""
    if doc_ids is not None:
        q_ids = k_ids = doc_ids
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=v.device)
    ptrs, ints, tail, _keep, docs = _bwd_args(q, k, v, do, lse, delta, causal, alibi, scale, q_offset,
                                              kv_offset, q_ids, k_ids, slopes, out_dtype)
    status = _build.library("flash_bwd").flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints, *tail)
    _build.LAUNCHES[counter + (DOCS if docs else "")] += 1
    _build.check(status, "flash_dkv launch")
    return dk, dv


def _bwd_inputs(q, o, lse, do, delta):
    """Check the backward's inputs; returns (lse, delta) contiguous, delta
    = rowsum(do * o) in f32 (outside the kernels, as in flash.py:354-355)
    unless the caller gave it."""
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} / o {tuple(o.shape)} must match q {tuple(q.shape)} {q.dtype}")
    B, T, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (tuple(x.shape) != (B, H, T) or x.dtype != torch.float32):
            raise ValueError(f"{name} must be f32 [B, H, T] = {(B, H, T)}, got {tuple(x.shape)} {x.dtype}")
    if delta is None:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    return lse.contiguous(), delta.contiguous()


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, alibi: bool,
              doc_ids: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None):
    """The flash backward: ``(dq, dk, dv)`` from the forward's ``o`` and
    ``lse`` [B, H, T] and the output grad ``do``. K2 then K3 on CUDA tensors,
    ``flash_bwd_reference`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal=causal, alibi=alibi,
                                   doc_ids=doc_ids, softmax_scale=softmax_scale)
    _check(q, k, v, None, doc_ids)
    _check_kernel_inputs(q, k, v, "flash_bwd")
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    lse, delta = _bwd_inputs(q, o, lse, do, None)
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    dq = launch_dq(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale, doc_ids=doc_ids)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale,
                        doc_ids=doc_ids)
    return dq, dk, dv


def flash_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, alibi: bool,
    softmax_scale: Optional[float] = None, q_offset=0, kv_offset=0,
    slopes: Optional[torch.Tensor] = None, q_ids: Optional[torch.Tensor] = None,
    k_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only, at global offsets: ``(out [B, T, H, D] f32, lse [B, H, T]
    f32)`` of a query shard at ``q_offset`` against a key shard at
    ``kv_offset`` (ints or [B]). ``out`` is normalised by this shard's own
    softmax sum; the ring merges shards by their lse. ``slopes`` [H]
    overrides the ALiBi table; ``q_ids`` [B, T] / ``k_ids`` [B, S] are the
    shards' document ids. Not differentiable: ``flash_grads`` is its
    backward. K1 on CUDA tensors (counted as ``flash_partial_fwd``),
    ``flash_partial_reference`` on CPU tensors."""
    _check(q, k, v, None, None, q_ids, k_ids)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_partial_reference(q, k, v, causal=causal, alibi=alibi, softmax_scale=scale,
                                       q_offset=q_offset, kv_offset=kv_offset, slopes=slopes,
                                       q_ids=q_ids, k_ids=k_ids)
    _check_kernel_inputs(q, k, v, "flash_partial")
    return _launch_fwd(q, k, v, causal=causal, alibi=alibi, q_offset=q_offset, segment_ids=None,
                       scale=scale, want_lse=True, counter=PARTIAL_KERNEL, kv_offset=kv_offset,
                       q_ids=q_ids, k_ids=k_ids, slopes=slopes, out_dtype=torch.float32)


def flash_grads(
    q, k, v, o, lse, do, *, causal: bool, alibi: bool, softmax_scale: Optional[float] = None,
    q_offset=0, kv_offset=0, slopes: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None, q_ids: Optional[torch.Tensor] = None,
    k_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in f32 of one query shard against one key shard at
    global offsets, given the GLOBAL ``o`` and ``lse`` [B, H, T] of the
    merged softmax (p = exp(s - lse) makes each shard's backward
    independent; the ring sums them) and optionally the caller's ``delta``
    [B, H, T]. K2 then K3 on CUDA tensors (``flash_partial_dq``,
    ``flash_partial_dkv``), ``flash_grads_reference`` on CPU tensors."""
    _check(q, k, v, None, None, q_ids, k_ids)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_grads_reference(q, k, v, o, lse, do, causal=causal, alibi=alibi, softmax_scale=scale,
                                     q_offset=q_offset, kv_offset=kv_offset, slopes=slopes, delta=delta,
                                     q_ids=q_ids, k_ids=k_ids)
    _check_kernel_inputs(q, k, v, "flash_grads")
    lse, delta = _bwd_inputs(q, o, lse, do, delta)
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    args = dict(causal=causal, alibi=alibi, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
                q_ids=q_ids, k_ids=k_ids, slopes=slopes, out_dtype=torch.float32)
    dq = launch_dq(q, k, v, do, lse, delta, counter="flash_partial_dq", **args)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, counter="flash_partial_dkv", **args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP ``_flash`` (flash.py:421-448): the forward saves q, k,
    v, the document ids, o and the lse [B, H, T], never a [T, S] tensor; the
    backward recomputes the probabilities from the lse. The ids get no grad."""

    @staticmethod
    def forward(ctx, q, k, v, doc_ids, causal, alibi, scale):
        if q.device.type == "cpu":
            o, lse = flash_reference(q, k, v, causal=causal, alibi=alibi, doc_ids=doc_ids,
                                     softmax_scale=scale)
        else:
            _check_kernel_inputs(q, k, v, "flash_attention")
            o, lse = _launch_fwd(
                q, k, v, causal=causal, alibi=alibi, q_offset=0, segment_ids=None,
                scale=scale, want_lse=True, counter=TRAIN_KERNEL, doc_ids=doc_ids,
            )
        ctx.save_for_backward(q, k, v, doc_ids, o, lse)
        ctx.causal, ctx.alibi, ctx.scale = causal, alibi, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, doc_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.to(q.dtype), causal=ctx.causal,
                               alibi=ctx.alibi, doc_ids=doc_ids, softmax_scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    alibi: bool = False, doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention over full sequences (query and key
    offsets 0). q ``[B, T, H, D]``; k, v ``[B, S, KVH, D]``; ``doc_ids``
    ``[B, T]`` int (needs T == S): positions of different documents cannot
    attend. Returns the output ``[B, T, H, D]``; autograd reaches q, k and v
    through K2 and K3."""
    _check(q, k, v, None, doc_ids)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if doc_ids is not None:
        doc_ids = doc_ids.detach()
    return _FlashAttention.apply(q, k, v, doc_ids, causal, alibi, float(scale))
