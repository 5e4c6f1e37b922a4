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

Every wrapper takes its kernel for CUDA tensors and its plain version
(``flash_reference``, ``flash_bwd_reference``) only for CPU tensors; a
tensor on any other device raises, and nothing falls back. Launch counts:
``flash_serving_fwd`` and ``flash_train_fwd`` (K1 by entry), ``flash_dq``,
``flash_dkv``, and the document-masked launches of the training kernels
apart: ``flash_train_fwd_docs``, ``flash_dq_docs``, ``flash_dkv_docs``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes_list

KERNEL = "flash_serving_fwd"
TRAIN_KERNEL = "flash_train_fwd"
DOCS = "_docs"  # suffix of the document-masked launch counts
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


def _check(q, k, v, segment_ids, doc_ids=None):
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


def _score_bias(B, T, S, H, q_offset, causal, alibi, dev) -> torch.Tensor:
    """[B, H or 1, T, S] f32: ALiBi plus the causal mask as one bias, the
    kernels' order (``csrc/flash_common.cuh``)."""
    offs = row_offsets(q_offset, B, dev)
    q_pos = offs[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
    dist = q_pos[:, :, None] - torch.arange(S, dtype=torch.int32, device=dev)  # [B, T, S]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.zeros(B, 1, T, S, dtype=torch.float32, device=dev)
    if alibi:
        slopes = slopes_on(H, str(dev), True)
        bias = bias - slopes[None, :, None, None] * torch.clamp(dist, min=0).float()[:, None]
    if causal:
        bias = bias + torch.where(dist >= 0, zero, torch.full_like(zero, NEG_INF))[:, None]
    return bias


def _doc_bias(doc_ids: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, T] f32: NEG_INF between positions of different documents
    (``_scores``' doc term, added after the ALiBi + causal bias)."""
    zero = torch.zeros((), dtype=torch.float32, device=doc_ids.device)
    same = doc_ids[:, :, None] == doc_ids[:, None, :]
    return torch.where(same, zero, torch.full_like(zero, NEG_INF))[:, None]


def flash_reference(
    q, k, v, *, causal: bool = True, alibi: bool = False, q_offset=0,
    segment_ids: Optional[torch.Tensor] = None, doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1: the same scores, biases and masks in
    float32 and in the kernels' order (ALiBi + causal, then documents, then
    validity), a full softmax, probabilities kept in float32 through the
    output product. Returns ``(out [B, T, H, D] in q's dtype, lse [B, H, T])``."""
    _check(q, k, v, segment_ids, doc_ids)
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    G = H // KVH
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * scale
    s = s + _score_bias(B, T, S, H, q_offset, causal, alibi, dev)
    if doc_ids is not None:
        s = s + _doc_bias(doc_ids)
    if segment_ids is not None:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        s = s + torch.where(segment_ids != 0, zero, torch.full_like(zero, NEG_INF))[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, vf).to(q.dtype)
    return out, lse


def flash_bwd_reference(
    q, k, v, o, lse, do, *, causal: bool = True, alibi: bool = False,
    doc_ids: Optional[torch.Tensor] = None, softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2 and K3, the flash backward written out in
    float32 from the forward's ``o`` and ``lse`` [B, H, T]:
    ``p = exp(s - lse)``, ``dp = do . v^T``, ``delta = rowsum(do * o)``,
    ``ds = p * (dp - delta)``, ``dq = scale * ds . k``,
    ``dk = scale * ds^T . q``, ``dv = p^T . do``, dk/dv summed over each
    kv head's query group; the scores carry the forward's biases, the
    document mask included. Returns ``(dq, dk, dv)`` in q's, k's, v's dtypes."""
    _check(q, k, v, None, doc_ids)
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    G = H // KVH
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    s = s + _score_bias(B, T, S, H, 0, causal, alibi, q.device)
    if doc_ids is not None:
        s = s + _doc_bias(doc_ids)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    if G > 1:
        dk = dk.reshape(B, S, KVH, G, D).sum(3)
        dv = dv.reshape(B, S, KVH, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _ids_arg(ids: Optional[torch.Tensor], dev) -> Optional[torch.Tensor]:
    """An optional id or mask tensor as the contiguous int32 the kernels read."""
    return None if ids is None else ids.to(device=dev, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, *, causal, alibi, q_offset, segment_ids, scale, want_lse, counter,
                doc_ids=None):
    """Launch K1 on CUDA tensors, counting the launch under ``counter``
    (with ``doc_ids``, under ``counter + "_docs"``)."""
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    offs = row_offsets(q_offset, B, dev)
    seg, docs = _ids_arg(segment_ids, dev), _ids_arg(doc_ids, dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev) if want_lse else None
    lib = _build.library("flash_fwd")
    status = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        slopes_on(H, str(dev), alibi).data_ptr(), offs.data_ptr(), _ptr(seg), _ptr(docs),
        out.data_ptr(), _ptr(lse),
        _DTYPE_CODES[q.dtype], B, T, S, H, KVH, D, float(scale), int(causal), int(alibi),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.LAUNCHES[counter + (DOCS if docs is not None else "")] += 1
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


def _bwd_args(q, k, v, do, lse, delta, docs, causal, alibi, scale):
    B, T, H, D = q.shape
    _, S, KVH, _ = k.shape
    dev = q.device
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
    ptrs += [slopes_on(H, str(dev), alibi).data_ptr(), _ptr(docs)]
    ints = [_DTYPE_CODES[q.dtype], B, T, S, H, KVH, D]
    tail = [float(scale), int(causal), int(alibi), torch.cuda.current_stream(dev).cuda_stream]
    return ptrs, ints, tail


def launch_dq(q, k, v, do, lse, delta, *, causal, alibi, scale, doc_ids=None) -> torch.Tensor:
    """K2 on contiguous CUDA tensors: dq [B, T, H, D] in q's dtype."""
    dq = torch.empty_like(q)
    docs = _ids_arg(doc_ids, q.device)
    ptrs, ints, tail = _bwd_args(q, k, v, do, lse, delta, docs, causal, alibi, scale)
    status = _build.library("flash_bwd").flash_dq(*ptrs, dq.data_ptr(), *ints, *tail)
    _build.LAUNCHES["flash_dq" + (DOCS if docs is not None else "")] += 1
    _build.check(status, "flash_dq launch")
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal, alibi, scale,
               doc_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on contiguous CUDA tensors: (dk, dv) [B, S, KVH, D] in k's dtype."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    docs = _ids_arg(doc_ids, q.device)
    ptrs, ints, tail = _bwd_args(q, k, v, do, lse, delta, docs, causal, alibi, scale)
    status = _build.library("flash_bwd").flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints, *tail)
    _build.LAUNCHES["flash_dkv" + (DOCS if docs is not None else "")] += 1
    _build.check(status, "flash_dkv launch")
    return dk, dv


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
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} / o {tuple(o.shape)} must match q {tuple(q.shape)} {q.dtype}")
    B, T, H, _ = q.shape
    if tuple(lse.shape) != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [B, H, T] = {(B, H, T)}, got {tuple(lse.shape)} {lse.dtype}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    q, k, v, do, lse = (x.contiguous() for x in (q, k, v, do, lse))
    # delta = rowsum(do * o) in f32, outside the kernels as in flash.py:354-355
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # [B, H, T]
    dq = launch_dq(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale, doc_ids=doc_ids)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale,
                        doc_ids=doc_ids)
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
