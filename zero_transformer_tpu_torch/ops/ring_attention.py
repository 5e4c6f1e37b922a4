"""Ring attention: exact causal attention over a sequence split across ranks.

Counterpart of the flash ring of ``zero_transformer_tpu/ops/ring_attention.py``
(:201-417): each rank holds a shard ``[B, T/n, H, D]`` of q, k and v; the k/v
shards (with their document ids) rotate around the ring (``_rotate`` :202, a
send to ``(r + 1) % n``), and each rank folds one key shard per step into an
online-softmax merge of ``flash_partial`` calls at the shards' global
offsets. The backward is a ring of ``flash_grads`` calls against the GLOBAL
lse (p = exp(s - lse) makes each shard's backward independent), with the
dk/dv accumulators riding the ring with their shard and a final rotation
bringing them home. No [t, t] score matrix ever exists.

On CUDA tensors the folds are the CUDA kernels (``flash_partial_fwd``,
``flash_partial_dq``, ``flash_partial_dkv``); on CPU tensors the same engine
calls their plain versions. The next rotation is started before each fold
and awaited after it, so the transfer may overlap the kernel. JAX's einsum
engine (``_ring_xla_body``) is a second implementation of the same function
and has no port of its own; the tests hold this engine against both.
Under a tensor group (a ``tensor x sequence`` mesh) each rank holds ``H /
N`` of the heads, and every fold takes the ALiBi slopes of the rank's global
head range ``t * H / N ..`` (``_local_slopes`` :201-212).
"""
from __future__ import annotations

from typing import Optional

import torch

from zero_transformer_tpu_torch.ops import flash
from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup, TensorGroup


def _local_slopes(H_local: int, alibi: bool, device, tensor: Optional[TensorGroup] = None) -> Optional[torch.Tensor]:
    """[H_local] ALiBi slopes of this rank's heads: the model's ``H_local x
    tp`` heads' table sliced at ``tensor.rank * H_local`` (JAX
    ``_local_slopes``), or None without ALiBi."""
    if not alibi:
        return None
    tp = 1 if tensor is None else tensor.size
    table = flash.slopes_on(H_local * tp, str(device), True)
    return table if tp == 1 else table[tensor.rank * H_local:(tensor.rank + 1) * H_local]


def _validate_cp_shapes(kind: str, t_q: int, t_kv: int, H: int, KVH: int) -> None:
    """The entry guards of the context-parallel engines, on local shards."""
    if t_q != t_kv:
        raise ValueError(f"{kind} attention requires q and kv shards of one length, got {t_q} and {t_kv}")
    if H % KVH:
        raise ValueError(f"query heads {H} not divisible by kv heads {KVH}")


def _ring_fwd(q, k, v, ids, group: SequenceGroup, causal, alibi, scale, slopes):
    """``_ring_flash_fwd_body`` (:234): n folds of ``flash_partial`` merged
    by their lse (m, norm and acc in f32, m from -1e30), rotating k, v and
    the key ids between folds and not after the last. Returns (out in q's
    dtype, lse [B, H, t] f32)."""
    n, my = group.size, group.rank
    B, t, H, D = q.shape
    t_kv = k.shape[1]
    m = torch.full((B, H, t), flash.INIT_M, dtype=torch.float32, device=q.device)
    norm = torch.zeros((B, H, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, t, H, D), dtype=torch.float32, device=q.device)
    cur = [k, v] + ([ids] if ids is not None else [])
    src = my
    for step in range(n):
        pending = group.rotate_start(cur, "kv") if step < n - 1 else None
        o_i, lse_i = flash.flash_partial(
            q, cur[0], cur[1], causal=causal, alibi=alibi, softmax_scale=scale, q_offset=my * t,
            kv_offset=src * t_kv, slopes=slopes, q_ids=ids, k_ids=cur[2] if ids is not None else None)
        m_new = torch.maximum(m, lse_i)
        w_prev, w_i = torch.exp(m - m_new), torch.exp(lse_i - m_new)
        norm = norm * w_prev + w_i
        acc = acc * w_prev.transpose(1, 2)[..., None] + o_i * w_i.transpose(1, 2)[..., None]
        m = m_new
        if pending is not None:
            cur = pending.wait()
        src = (src - 1) % n
    norm_safe = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    out = acc / norm_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(norm_safe)


def _ring_bwd(q, k, v, ids, o, lse, do, group: SequenceGroup, causal, alibi, scale, slopes):
    """``_ring_flash_bwd_body`` (:295): delta once, then n ``flash_grads``
    calls against the global lse; dk/dv accumulate in f32 and ride the ring
    with their shard, and a final rotation brings them home."""
    n, my = group.size, group.rank
    t, t_kv = q.shape[1], k.shape[1]
    # rowsum(do * o) is the same for every ring step: once, in [B, H, t]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    cur = [k, v] + ([ids] if ids is not None else [])
    src = my
    for step in range(n):
        pending = group.rotate_start(cur, "kv") if step < n - 1 else None
        dq_i, dk_i, dv_i = flash.flash_grads(
            q, cur[0], cur[1], o, lse, do, causal=causal, alibi=alibi, softmax_scale=scale,
            q_offset=my * t, kv_offset=src * t_kv, slopes=slopes, delta=delta, q_ids=ids,
            k_ids=cur[2] if ids is not None else None)
        dq += dq_i
        dk, dv = group.rotate_start([dk + dk_i, dv + dv_i], "grads").wait()
        if pending is not None:
            cur = pending.wait()
        src = (src - 1) % n
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The custom VJP ``_ring_flash`` (:361-412): the forward saves q, k, v,
    the ids, the output and the merged lse; the backward runs the ring of
    ``flash_grads``. Every rank runs both in the same order, so their
    rotations pair up, the recompute under remat included."""

    @staticmethod
    def forward(ctx, q, k, v, ids, group, causal, alibi, scale, slopes):
        out, lse = _ring_fwd(q, k, v, ids, group, causal, alibi, scale, slopes)
        ctx.save_for_backward(q, k, v, ids, out, lse)
        ctx.group, ctx.causal, ctx.alibi, ctx.scale, ctx.slopes = group, causal, alibi, scale, slopes
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, ids, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, ids, out, lse, do.to(q.dtype).contiguous(), ctx.group, ctx.causal,
                               ctx.alibi, ctx.scale, ctx.slopes)
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: SequenceGroup, *,
    causal: bool = True, alibi: bool = False, doc_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None, tensor_group: Optional[TensorGroup] = None,
) -> torch.Tensor:
    """Differentiable ring attention on this rank's shards: q ``[B, t, H, D]``
    and k, v ``[B, t, KVH, D]`` at global positions ``[rank * t, (rank + 1)
    * t)`` of a row of ``group.size * t`` tokens; ``doc_ids`` ``[B, t]`` the
    shard's packed-document ids (the key ids ride the ring with their
    shard, so attention across shards stays inside each document). Under
    ``tensor_group`` the ``H`` heads are the rank's slice of ``H x N``,
    with their ALiBi slopes. Returns this rank's output ``[B, t, H, D]`` of
    attention over the whole row."""
    B, t, H, D = q.shape
    _validate_cp_shapes("ring", t, k.shape[1], H, k.shape[2])
    if doc_ids is not None and tuple(doc_ids.shape) != (B, t):
        raise ValueError(f"doc_ids must be this shard's [B, t] = {(B, t)}, got {tuple(doc_ids.shape)}")
    scale = float(softmax_scale if softmax_scale is not None else 1.0 / (D**0.5))
    ids = None if doc_ids is None else doc_ids.detach().to(torch.int32).contiguous()
    slopes = _local_slopes(H, alibi, q.device, tensor_group)
    return _RingFlash.apply(q, k.contiguous(), v.contiguous(), ids, group, causal, alibi, scale, slopes)
