"""Decoder-only transformer LM (the GPT-2/ALiBi and Llama blocks), in PyTorch.

Counterpart of ``zero_transformer_tpu/models/gpt.py``: ``Attention`` (:157),
``MLP`` (:416), ``Block`` (:448), ``Transformer`` (:497), the norms
(``_norm`` :120), the untied ``LMHead`` (:132) and the remat policies
(``resolve_remat_policy`` :95). Ported: the full-sequence forward, with the
next-token loss for training (``forward(tokens, labels, train=True)``, JAX
``Transformer.__call__`` :512-684), the chunked loss for ``loss_chunk``
models (``(None, loss)``, :651-668: the ``[B, T, vocab]`` logits never
exist), dropout in training (:413, :445, :605), packed documents for
``doc_sep_token`` models (``doc_ids_from_tokens`` and
``mask_boundary_labels``, :63-81: the ids ride through every block into the
attention, and the loss skips each document's first label), and the PAGED
decode variant the serving engine runs, which never packs. Params are built
with ``requires_grad=False`` (serving runs under ``no_grad``); the trainer
turns them on with ``requires_grad_(True)``. The config picks the block:

- ``position``: "alibi" (the bias inside the attention kernels), "rope"
  (q and k rotated at their positions, ``ops/positions.py::apply_rope``;
  the paged cache stores rotated keys) or "learned" (a ``wpe`` table
  ``[max_seq_len, d]`` added to the token embedding);
- ``norm``: "layernorm" or "rmsnorm"; ``activation``: "gelu" or "swiglu"
  (``silu(gate(x)) * wi(x)``, then ``wo``);
- ``n_kv_heads`` < ``n_heads``: grouped-query attention (the kernels take
  the groups themselves);
- ``tie_embeddings`` False: an untied head ``lm_head`` (a bias-free Dense,
  ``[vocab, d]`` here, JAX's ``[d, vocab]`` kernel transposed).

Numerics follow flax where it matters:

- bias-free LayerNorm with eps 1e-6 (flax's default, not torch's 1e-5),
  statistics in float32 as E[x^2] - E[x]^2 clipped at 0, scale in float32,
  result in the compute dtype; RMSNorm the same without the mean:
  ``x * (rsqrt(E[x^2] + 1e-6) * scale)``;
- ``nn.gelu`` is the tanh approximation;
- ``nn.Dense`` computes in the compute dtype from float32 params. Flax casts
  the params on every call; ``cast_for_inference`` casts the Dense and
  embedding weights once instead, which gives the same values;
- the tied head is ``h @ wte.T`` in the compute dtype (``embed.attend``),
  so the tied table gets gradient from both the lookup and the head;
- training keeps the float32 master params: every Dense and the embedding
  cast per call, and autograd carries the grads back to float32;
- ``param_quant="int8"`` swaps every Dense (the untied head and the gate
  included) and the token table for their weight-only int8 counterparts
  (``models/quant.py``, JAX ``_dense`` :43-60 and ``Transformer``
  :524-541), an inference-only configuration; ``wpe`` stays float, as in
  JAX;
- ``kv_cache_dtype="int8"`` stores the paged K/V as int8 with one float32
  scale per (token, kv head) (``_quantize_kv``, JAX :84-92), dequantized
  (int8 -> f32) * scale -> compute dtype wherever it is read;
- dropout follows flax's rule (keep with probability 1 - p, kept values
  divided by 1 - p) at JAX's three sites: the embedding output, the
  attention output after ``out`` and the MLP output after ``wo``, only with
  ``train=True``. Its masks cannot be JAX's threefry bits. Each mask is
  drawn from a generator seeded inside the block with ``fold_seed`` of the
  caller's ``dropout_key`` (the train step's seed, step, data rank and
  micro-step), the sequence rank, the layer and the site: a pure function
  of them, so a remat recompute redraws the same mask (checkpoint restores
  only the global RNG states, never an explicit generator), two data ranks
  draw different masks and a resumed run draws the masks the uninterrupted
  run drew.

``remat`` runs every block under ``torch.utils.checkpoint``; what its
backward does not recompute follows ``remat_policy`` (JAX
``resolve_remat_policy``): "none" saves nothing inside the block, "dots"
saves every projection's output (``aten.mm``, JAX's
``dots_with_no_batch_dims_saveable``), "qkv_mlp" only the outputs JAX names
with ``checkpoint_name``: q, k and v before RoPE and the MLP's ``wi`` and
``gate`` (torch's selective checkpointing, keyed on the name the projection
runs under). The attention kernel's forward (K1) is recomputed under every
policy, as the Pallas call is in JAX: two K1 launches a layer and a
micro-step, one K2 and one K3.

Layouts at the public surface are the JAX ones: q/k/v ``[B, T, H, D]``,
page pools ``[n_pages, page, KVH, D]`` with page 0 the serving layer's trash
page, block tables ``[B, n_blocks]`` int32.

Sequence parallelism (JAX ``Attention`` :392-401 under a mesh whose
``sequence`` axis is > 1): a ``Transformer`` given a ``SequenceGroup`` of
size n routes attention to ``ops/ring_attention.py``. Its ``forward`` takes
the full row ``[B, T]``, which every rank of the group reads, computes the
document ids, the boundary labels and the next-token shift on the whole
row, and runs the rank's shard ``[r * T / n, (r + 1) * T / n)`` at those
global positions (RoPE angles, learned positions): the local logits and
the GLOBAL mean loss's share, (local CE sum) / (global count of labels),
whose grads summed over the ranks are the grads of the mean. Under
``remat`` the recompute runs the ring forward again, as JAX's does.
``cp_impl: ulysses`` routes the same shards through ``ops/ulysses.py``
instead (all-to-alls to whole rows over ``H / n`` heads, JAX
``ops/ulysses.py``).

Tensor parallelism (JAX's ``vocab``, ``qheads``, ``kvheads`` and ``mlp``
logical axes over ``tensor``, ``parallel/sharding.py:44-47``), for serving
and training: a ``Transformer`` given a ``TensorGroup`` of N ranks holds
the Megatron split of every layer. ``query``/``key``/``value``/``wi``/``gate``
are column-parallel (the rank's ``H / N`` query heads, ``KVH / N`` kv
heads, ``ff / N`` features); ``out``/``wo`` are row-parallel, their float32
partial sums all-reduced and rounded once (``_row_parallel``); ``wte``
(and an untied ``lm_head``) hold the rank's ``V / N`` vocabulary rows: the
lookup is a masked local lookup plus an all-reduce; without labels the
logits ``[.., V / N]`` are gathered over the vocabulary, with labels the
loss is the vocab-parallel cross entropy of ``ops/losses.py`` on the
rank's columns (the full and the chunked loss alike; ``[.., V]`` never
exists, and the call returns ``(None, loss)``). Norm scales and ``wpe``
are whole on every rank, and so are the activations between the layers:
the three dropout sites lie on them, so every tensor rank draws the same
masks (the key holds no tensor rank). The collectives are autograd
Functions (identity / all-reduce pairs), so the grads of the replicated
leaves come out equal on every tensor rank and are never reduced over
it. ALiBi attends with the slopes of the rank's global head range (JAX
``ring_attention.py::_local_slopes`` :201), under a sequence group too:
the ring and Ulysses take the tensor group for it. int8 weights: a column
split carries its rows' per-output-channel scales, a row split keeps the
scale whole (exact: the scale applies after the product).
``tp_split_dim`` names each weight's split dimension;
``convert.tensor_shard`` cuts a whole state dict with it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from zero_transformer_tpu_torch.config import ModelConfig, resolve_dtype
from zero_transformer_tpu_torch.models.quant import QuantDense, QuantEmbed
from zero_transformer_tpu_torch.ops import paged_attention as pa
from zero_transformer_tpu_torch.ops.attention import dot_product_attention
from zero_transformer_tpu_torch.ops.losses import (chunked_cross_entropy_sum, chunked_next_token_loss,
                                                   cross_entropy_sum, next_token_loss)
from zero_transformer_tpu_torch.ops.positions import alibi_slopes_list, apply_rope
from zero_transformer_tpu_torch.ops.ring_attention import ring_attention
from zero_transformer_tpu_torch.ops.ulysses import ulysses_attention
from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup, TensorGroup

LN_EPS = 1e-6  # flax LayerNorm and RMSNorm default
_M64 = (1 << 64) - 1
EMBED_SITE, ATTN_SITE, MLP_SITE = 0, 1, 2  # dropout sites; the embedding's layer is -1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints that spreads every
    input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_seed(*parts: int) -> int:
    """A generator seed (63 bits) that is a pure function of ``parts``, in
    order (JAX's ``fold_in`` chain, with another hash)."""
    h = 0
    for p in parts:
        h = _mix64(h ^ (int(p) & _M64))
    return h >> 1


def dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and divide the kept ones by ``1 - rate``; the mask comes from a
    generator on ``x``'s device seeded with ``seed``. ``seed`` None (eval,
    serving, scoring) or ``rate`` 0 returns ``x``."""
    if seed is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


# the JAX checkpoint_name of the projection running now (selective remat)
_NAME = threading.local()
# the names remat_policy "qkv_mlp" saves (JAX resolve_remat_policy)
QKV_MLP_NAMES = frozenset({"attn_q", "attn_k", "attn_v", "mlp_wi", "mlp_gate"})


def _named(name: str, dense: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``dense(x)`` with its product tagged ``name`` for the remat policy
    (JAX ``checkpoint_name``); outside a selective checkpoint it is ``dense(x)``."""
    _NAME.current = name
    try:
        return dense(x)
    finally:
        _NAME.current = None


def _save_policy(names: Optional[frozenset]):
    """The selective checkpoint's policy: keep the output of every matrix
    product (``names`` None, "dots") or of those run under one of ``names``
    ("qkv_mlp"); recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.mm.default and (names is None or getattr(_NAME, "current", None) in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@dataclasses.dataclass
class KVPools:
    """One layer's paged KV cache: ``k``/``v`` ``[n_pages, page, KVH, D]``
    in the compute dtype, or int8 with float32 ``k_scale``/``v_scale``
    ``[n_pages, page, KVH, 1]`` (``kv_cache_dtype="int8"``)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


Pools = List[KVPools]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: ``[..., D]`` -> (int8 values,
    float32 scale ``[..., 1]``). The scale is floored so an all-zero row
    stays exactly zero after dequant; ``torch.round`` rounds half to even,
    as ``jnp.round`` does. Both divisions are tensor by tensor: on CUDA,
    PyTorch divides by a Python scalar as a multiply by its reciprocal,
    which can miss the correctly rounded quotient by one bit."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def doc_ids_from_tokens(tokens: torch.Tensor, sep_token: int) -> torch.Tensor:
    """[B, T] tokens -> [B, T] int32 document ids for packed-sequence
    masking. The separator closes its own document (exclusive cumsum): it
    attends within the document it ends, and the token after it starts the
    next one."""
    is_sep = (tokens == sep_token).to(torch.int32)
    return (torch.cumsum(is_sep, dim=1, dtype=torch.int32) - is_sep).to(torch.int32)


def mask_boundary_labels(labels: torch.Tensor, doc_ids: torch.Tensor) -> torch.Tensor:
    """Labels set to -1 (the loss's ignore_index) where the document changes:
    the first token of a document is never predicted from the previous one."""
    boundary = doc_ids[:, 1:] != doc_ids[:, :-1]
    return torch.cat([labels[:, :1], torch.where(boundary, -1, labels[:, 1:])], dim=1)


# ------------------------------------------------------ tensor parallelism

# the split dimension of each tensor-parallel weight, by the name's last
# two parts: column splits (the rank's output rows, their int8 scales too),
# row splits (the rank's input columns; the int8 scale stays whole) and the
# vocabulary's rows
_COLUMN = ("attn.query", "attn.key", "attn.value", "mlp.wi", "mlp.gate", "lm_head")
_ROW = ("attn.out", "mlp.wo")


def tp_split_dim(name: str) -> Optional[int]:
    """The dimension a state-dict tensor ``name`` is split along over a
    tensor group (0 or 1), or None for a tensor every rank holds whole."""
    module, _, leaf = name.rpartition(".")
    if module.endswith(_COLUMN) or module == "wte":
        return 0
    if module.endswith(_ROW) and leaf in ("weight", "weight_q"):
        return 1
    return None


def check_tensor_split(cfg: ModelConfig, n: int) -> None:
    """Raise unless ``n`` ranks divide the query heads, the kv heads, the
    MLP features and the vocabulary (JAX warns and replicates an
    indivisible cache instead; the port requires the split)."""
    if n < 1:
        raise ValueError(f"a tensor group needs >= 1 ranks, got {n}")
    bad = [f"{what} {count}" for what, count in (("query heads", cfg.n_heads), ("kv heads", cfg.kv_heads),
                                                  ("MLP features", cfg.ff_dim), ("vocab rows", cfg.vocab_size))
           if count % n]
    if bad:
        raise ValueError(f"tensor parallelism over {n} ranks needs {n} to divide the {cfg.name} model's "
                         f"{', '.join(bad)} (n_heads={cfg.n_heads}, n_kv_heads={cfg.kv_heads})")


class _CopyToTensor(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward (the input of a
    column-parallel layer, whose grads each rank holds in part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.group.all_reduce_([g])
        return g, None


class _ReduceFromTensor(torch.autograd.Function):
    """Megatron's g: all-reduce forward (the partial sums of a row-parallel
    layer), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        group.all_reduce_([out])
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    """All-gather along ``dim`` forward (the vocabulary-split logits), the
    rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return group.all_gather_(x, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.group.rank * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


class _MmF32(torch.autograd.Function):
    """``x @ w.T`` of compute-dtype operands accumulated and written in
    float32 (``torch.mm``'s ``out_dtype``, which has no derivative of its
    own). The backward is one card's: the incoming float32 grad rounded to
    the operands' dtype (it is a compute-dtype grad upcast), then ``dx = g
    @ w`` and ``dw = g.T @ x`` in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.T, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).reshape(-1, w.shape[0])
        dx = (g @ w).reshape(x.shape) if ctx.needs_input_grad[0] else None
        dw = g.T @ x.reshape(-1, x.shape[-1]) if ctx.needs_input_grad[1] else None
        return dx, dw


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (``w`` ``[out, in]``) with a float32 result: on CUDA the
    product of the compute-dtype operands accumulated and written in
    float32 (``_MmF32``), on the CPU in float32."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return _MmF32.apply(x, w)
    return F.linear(x.float(), w.float())


def _row_parallel(dense: nn.Module, x: torch.Tensor, group: Optional[TensorGroup]) -> torch.Tensor:
    """A row-parallel layer (``out``, ``wo``, built with ``float32_out``):
    this rank's partial product kept in float32, summed over the group,
    rounded once to the compute dtype, as one card rounds the whole
    product once (a partial rounded to bf16 before the sum would round
    twice)."""
    if group is None:
        return dense(x)
    return _reduce_from(dense(x), group).to(dense.compute_dtype)


def _copy_to(x: torch.Tensor, group: Optional[TensorGroup]) -> torch.Tensor:
    return x if group is None else _CopyToTensor.apply(x, group)


def _reduce_from(x: torch.Tensor, group: Optional[TensorGroup]) -> torch.Tensor:
    return x if group is None else _ReduceFromTensor.apply(x, group)


@functools.lru_cache(maxsize=None)
def _shard_slopes(n_heads: int, lo: int, hi: int, device: str) -> torch.Tensor:
    """[hi - lo] f32 ALiBi slopes of the model's heads ``lo .. hi - 1``,
    kept on ``device``."""
    return torch.tensor(alibi_slopes_list(n_heads)[lo:hi], dtype=torch.float32, device=device)


class Dense(nn.Module):
    """Bias-free linear layer. ``weight`` is ``[out, in]`` (the flax kernel
    transposed) and the product runs in the compute dtype; with
    ``float32_out`` (a row-parallel shard) its result stays float32."""

    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, device, float32_out: bool = False):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.float32_out = float32_out
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=resolve_dtype(cfg.param_dtype), device=device),
            requires_grad=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if self.float32_out:
            return _mm_f32(x.to(cdt), self.weight.to(cdt))
        return F.linear(x.to(cdt), self.weight.to(cdt))


def _dense(d_in: int, d_out: int, cfg: ModelConfig, device, float32_out: bool = False) -> nn.Module:
    if cfg.param_quant == "int8":
        return QuantDense(d_in, d_out, cfg, device, float32_out)
    return Dense(d_in, d_out, cfg, device, float32_out)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(use_bias=False)``."""

    def __init__(self, d: int, cfg: ModelConfig, device):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.scale = nn.Parameter(
            torch.ones(d, dtype=resolve_dtype(cfg.param_dtype), device=device), requires_grad=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.scale.float())
        return y.to(self.compute_dtype)


class RMSNorm(LayerNorm):
    """flax ``RMSNorm``: LayerNorm's statistics without the mean."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + LN_EPS) * self.scale.float())).to(self.compute_dtype)


def _norm(cfg: ModelConfig, device) -> LayerNorm:
    return (RMSNorm if cfg.norm == "rmsnorm" else LayerNorm)(cfg.d_model, cfg, device)


class Attention(nn.Module):
    """Self-attention over this rank's heads: all of them, or ``H / N``
    query and ``KVH / N`` kv heads of a tensor group of N ranks (the heads
    ``rank * H / N ..``, with their ALiBi slopes)."""

    def __init__(self, cfg: ModelConfig, device, tensor_group: Optional[TensorGroup] = None):
        super().__init__()
        self.cfg = cfg
        n = 1 if tensor_group is None else tensor_group.size
        self.tp = tensor_group
        self.n_heads, self.kv_heads = cfg.n_heads // n, cfg.kv_heads // n
        H, KVH, D, d = self.n_heads, self.kv_heads, cfg.head_width, cfg.d_model
        self.query = _dense(d, H * D, cfg, device)
        self.key = _dense(d, KVH * D, cfg, device)
        self.value = _dense(d, KVH * D, cfg, device)
        self.out = _dense(H * D, d, cfg, device, float32_out=tensor_group is not None)
        self.seq_group: Optional[SequenceGroup] = None  # Transformer.set_sequence_group

    def slopes(self, device) -> Optional[torch.Tensor]:
        """The ALiBi slopes of this rank's global head range, or None (the
        model's own table: one rank, or no ALiBi)."""
        if self.tp is None or self.cfg.position != "alibi":
            return None
        lo = self.tp.rank * self.n_heads
        return _shard_slopes(self.cfg.n_heads, lo, lo + self.n_heads, str(device))

    def _qkv(self, x, pos: torch.Tensor):
        """q, k, v of ``x``; with RoPE, q and k rotated at ``pos`` (``[T]``
        or ``[B, T]``)."""
        cfg = self.cfg
        B, T, _ = x.shape
        x = _copy_to(x, self.tp)
        q = _named("attn_q", self.query, x).reshape(B, T, self.n_heads, cfg.head_width)
        k = _named("attn_k", self.key, x).reshape(B, T, self.kv_heads, cfg.head_width)
        v = _named("attn_v", self.value, x).reshape(B, T, self.kv_heads, cfg.head_width)
        if cfg.position == "rope":
            q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, doc_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        # a sequence rank's shard starts at global position rank * T
        first = 0 if self.seq_group is None else self.seq_group.rank * T
        q, k, v = self._qkv(x, first + torch.arange(T, device=x.device))
        alibi = self.cfg.position == "alibi"
        if self.seq_group is not None and self.cfg.cp_impl == "ulysses":
            out = ulysses_attention(q, k, v, self.seq_group, causal=True, alibi=alibi, doc_ids=doc_ids,
                                    impl=self.cfg.attention_impl, tensor_group=self.tp)
        elif self.seq_group is not None:
            out = ring_attention(q, k, v, self.seq_group, causal=True, alibi=alibi, doc_ids=doc_ids,
                                 tensor_group=self.tp)
        else:
            # a shard's slope table only where there is one: the one-rank call is unchanged
            shard = {} if self.tp is None else {"slopes": self.slopes(x.device)}
            out = dot_product_attention(q, k, v, causal=True, alibi=alibi, doc_ids=doc_ids,
                                        impl=self.cfg.attention_impl, **shard)
        return _row_parallel(self.out, out.reshape(B, T, -1), self.tp)

    def forward_paged(
        self, x: torch.Tensor, pools: KVPools, block_table: torch.Tensor, offsets: torch.Tensor,
        cache_len: Optional[int] = None, flash: bool = False,
    ) -> torch.Tensor:
        """Write this window's K/V through the block table (quantized for an
        int8 cache; with RoPE, the rotated keys), then attend over the row's
        cache. ``offsets`` [B] is each row's first position. ``cache_len``
        (default: the table's ``n_blocks * page``) is the capacity past
        which a write poisons the row: a slab cache rounded up to whole
        pages keeps its requested length. A window longer than
        ``MAX_DECODE_T``, or any window with ``flash`` (a prompt's one-shot
        prefill), reads through the flash kernel; a shorter one through the
        paged decode kernel."""
        cfg = self.cfg
        B, T, _ = x.shape
        pos = offsets.long()[:, None] + torch.arange(T, device=x.device)  # [B, T]
        q, k, v = self._qkv(x, pos)
        page = pools.k.shape[1]
        n_blocks = block_table.shape[1]
        cache_len = n_blocks * page if cache_len is None else cache_len
        # out-of-range blocks clip to the last table entry: overflow is made
        # loud by the NaN poison below, and a parked row's zeroed table
        # routes its write to the trash page
        page_ids = torch.gather(block_table.long(), 1, torch.clamp(pos // page, 0, n_blocks - 1))
        in_page = pos % page
        # the pools are updated IN PLACE (the JAX engine donates its cache)
        if cfg.kv_cache_dtype == "int8":
            for pool, scale_pool, x_new in ((pools.k, pools.k_scale, k), (pools.v, pools.v_scale, v)):
                xq, xs = _quantize_kv(x_new)
                pool[page_ids, in_page] = xq
                scale_pool[page_ids, in_page] = xs
        else:
            pools.k[page_ids, in_page] = k.to(pools.k.dtype)
            pools.v[page_ids, in_page] = v.to(pools.v.dtype)
        scales = dict(k_scale=pools.k_scale, v_scale=pools.v_scale, slopes=self.slopes(x.device))
        alibi = cfg.position == "alibi"
        # writing past capacity poisons only the overflowing row's output
        overflow = (offsets + T > cache_len)[:, None, None, None]
        q = torch.where(overflow, torch.full((), math.nan, dtype=q.dtype, device=q.device),
                        torch.ones((), dtype=q.dtype, device=q.device)) * q
        if T > pa.MAX_DECODE_T or flash:
            # a prefill window: gather the row's pages once, then the flash kernel
            k_all, v_all, kv_valid = pa.gather_window(pools.k, pools.v, block_table, offsets, T, dtype=q.dtype,
                                                      k_scale=pools.k_scale, v_scale=pools.v_scale)
            out = dot_product_attention(
                q, k_all, v_all, causal=True, alibi=alibi, q_offset=offsets,
                segment_ids=kv_valid, impl=cfg.attention_impl, slopes=scales["slopes"],
            )
        elif cfg.attention_impl == "xla":
            out = pa.paged_reference(q, pools.k, pools.v, block_table, offsets, causal=T > 1, alibi=alibi,
                                     **scales)
        else:
            out = pa.paged_attention(q, pools.k, pools.v, block_table, offsets, causal=T > 1, alibi=alibi,
                                     **scales)
        return _row_parallel(self.out, out.reshape(B, T, -1), self.tp)


class MLP(nn.Module):
    """``wo(gelu(wi(x)))``, or SwiGLU's ``wo(silu(gate(x)) * wi(x))``; over
    a tensor group, this rank's ``ff / N`` features and one all-reduce."""

    def __init__(self, cfg: ModelConfig, device, tensor_group: Optional[TensorGroup] = None):
        super().__init__()
        ff = cfg.ff_dim // (1 if tensor_group is None else tensor_group.size)
        self.tp = tensor_group
        self.wi = _dense(cfg.d_model, ff, cfg, device)
        self.gate = _dense(cfg.d_model, ff, cfg, device) if cfg.activation == "swiglu" else None
        self.wo = _dense(ff, cfg.d_model, cfg, device, float32_out=tensor_group is not None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _copy_to(x, self.tp)
        h = _named("mlp_wi", self.wi, x)
        if self.gate is not None:
            return _row_parallel(self.wo, F.silu(_named("mlp_gate", self.gate, x)) * h, self.tp)
        return _row_parallel(self.wo, F.gelu(h, approximate="tanh"), self.tp)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, cfg: ModelConfig, device, tensor_group: Optional[TensorGroup] = None):
        super().__init__()
        self.ln_attn = _norm(cfg, device)
        self.attn = Attention(cfg, device, tensor_group)
        self.ln_mlp = _norm(cfg, device)
        self.mlp = MLP(cfg, device, tensor_group)

    def forward(self, x: torch.Tensor, doc_ids: Optional[torch.Tensor] = None,
                drop: Optional[Tuple[float, int, int]] = None) -> torch.Tensor:
        """``drop``: (rate, attention site's seed, MLP site's seed), or None
        for no dropout."""
        rate, attn_seed, mlp_seed = drop if drop is not None else (0.0, None, None)
        x = x + dropout(self.attn(self.ln_attn(x), doc_ids), rate, attn_seed)
        return x + dropout(self.mlp(self.ln_mlp(x)), rate, mlp_seed)

    def forward_paged(self, x, pools, block_table, offsets, cache_len: Optional[int] = None,
                      flash: bool = False) -> torch.Tensor:
        x = x + self.attn.forward_paged(self.ln_attn(x), pools, block_table, offsets, cache_len, flash=flash)
        return x + self.mlp(self.ln_mlp(x))


class Embed(nn.Module):
    """flax ``nn.Embed``: the token table ``[vocab, d]`` (``wte``), or the
    learned position table ``[max_seq_len, d]`` (``wpe``, ``num``)."""

    def __init__(self, cfg: ModelConfig, device, num: Optional[int] = None):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.embedding = nn.Parameter(
            torch.empty(num or cfg.vocab_size, cfg.d_model, dtype=resolve_dtype(cfg.param_dtype), device=device),
            requires_grad=False,
        )

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding.to(self.compute_dtype))

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return h.to(cdt) @ self.embedding.to(cdt).T


class Transformer(nn.Module):
    """Full decoder LM: ``forward`` over whole sequences, ``forward_paged``
    over a window per row against the paged KV cache."""

    def __init__(self, cfg: ModelConfig, device="cpu", seq_group: Optional[SequenceGroup] = None,
                 tensor_group: Optional[TensorGroup] = None):
        super().__init__()
        self.cfg = cfg
        tp = tensor_group if tensor_group is not None and tensor_group.size > 1 else None
        if tp is not None:
            check_tensor_split(cfg, tp.size)
        self.tp = tp
        n = 1 if tp is None else tp.size
        # this rank's vocabulary rows [vocab_lo, vocab_lo + vocab_rows)
        self.vocab_rows = cfg.vocab_size // n
        self.vocab_lo = 0 if tp is None else tp.rank * self.vocab_rows
        self.wte = (QuantEmbed(cfg, device, num=self.vocab_rows) if cfg.param_quant == "int8"
                    else Embed(cfg, device, num=self.vocab_rows))
        # learned positions stay float under int8 weights, as in JAX
        self.wpe = Embed(cfg, device, num=cfg.max_seq_len) if cfg.position == "learned" else None
        self.blocks = nn.ModuleList(Block(cfg, device, tp) for _ in range(cfg.n_layers))
        self.ln_f = _norm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else _dense(cfg.d_model, self.vocab_rows, cfg, device)
        self.set_sequence_group(seq_group)

    def set_sequence_group(self, group: Optional[SequenceGroup]) -> "Transformer":
        """Route attention through the ring (or Ulysses, ``cp_impl``) over
        ``group`` (None or size 1: the one-card path)."""
        self.seq_group = group if group is not None and group.size > 1 else None
        for blk in self.blocks:
            blk.attn.seq_group = self.seq_group
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """The JAX init: normal(0.02) kernels (the gate and the untied head
        too) and embeddings, residual projections (attention out, MLP wo)
        at 0.02 / sqrt(2 * n_layers), norm scales at one. Draws from
        ``generator``, whose device must be the model's, in a fixed order
        (a model without ``gate``, ``wpe`` or ``lm_head`` draws what it drew
        before they existed). A weight-only int8 model has no float weights
        to draw: initialise the float model, then ``quant.quantize_model``."""
        if self.cfg.param_quant != "none":
            raise ValueError("init_weights draws float weights: initialise a param_quant='none' model, "
                             "then quantize it with models.quant.quantize_model")
        resid_std = 0.02 / math.sqrt(2 * self.cfg.n_layers)
        self._draw(self.wte.embedding, 0, 0.02, generator)
        for blk in self.blocks:
            for dense in (blk.attn.query, blk.attn.key, blk.attn.value, blk.mlp.wi, blk.mlp.gate):
                if dense is not None:
                    self._draw(dense.weight, 0, 0.02, generator)
            for dense in (blk.attn.out, blk.mlp.wo):
                self._draw(dense.weight, 1, resid_std, generator)
        if self.wpe is not None:
            self.wpe.embedding.normal_(0.0, 0.02, generator=generator)
        if self.lm_head is not None:
            self._draw(self.lm_head.weight, 0, 0.02, generator)
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
        return self

    def _draw(self, param: torch.Tensor, dim: int, std: float, generator: torch.Generator) -> None:
        """``param`` from normal(0, ``std``). Over a tensor group the whole
        tensor is drawn (one at a time, on the param's device) and the
        rank's slice along ``dim`` kept: every rank draws the one-card
        model's values."""
        if self.tp is None:
            param.normal_(0.0, std, generator=generator)
            return
        shape = list(param.shape)
        shape[dim] *= self.tp.size
        whole = torch.empty(shape, dtype=param.dtype, device=param.device).normal_(0.0, std, generator=generator)
        param.copy_(whole.narrow(dim, self.tp.rank * param.shape[dim], param.shape[dim]))

    @torch.no_grad()
    def cast_for_inference(self) -> "Transformer":
        """Store the Dense and embedding weights in the compute dtype once,
        rather than casting them on every call as flax does (same values);
        LayerNorm scales stay in float32, as flax computes them. Weight-only
        int8 modules keep their int8 weights and store their scales in the
        compute dtype, the values flax's per-call cast gives."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.data = mod.weight.data.to(mod.compute_dtype)
            elif isinstance(mod, Embed):
                mod.embedding.data = mod.embedding.data.to(mod.compute_dtype)
            elif isinstance(mod, (QuantDense, QuantEmbed)):
                mod.scale.data = mod.scale.data.to(mod.compute_dtype)
        return self

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head in the compute dtype: ``h @ wte.T`` tied, ``lm_head(h)``
        untied; over a tensor group each rank's ``V / N`` columns gathered
        into the whole ``[.., V]`` on every rank."""
        local = self._local_logits(h)
        return local if self.tp is None else _GatherFromTensor.apply(local, self.tp, local.ndim - 1)

    def _local_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head on this rank's vocabulary rows: ``[.., V / N]`` over a
        tensor group (its input through Megatron's f), ``[.., V]`` alone."""
        h = _copy_to(h, self.tp)
        return self.wte.attend(h) if self.lm_head is None else self.lm_head(h)

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding; over a tensor group the rank's rows looked
        up where the token falls in its range, zeros elsewhere, summed over
        the group (exact: one rank holds each row)."""
        if self.tp is None:
            return self.wte(tokens)
        local = tokens - self.vocab_lo
        inside = (local >= 0) & (local < self.vocab_rows)
        h = self.wte(torch.where(inside, local, torch.zeros_like(local)))
        h = torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
        return _reduce_from(h, self.tp)

    def _vocab_split(self) -> dict:
        """The losses' arguments for this rank's vocabulary columns (none
        on one rank)."""
        return {} if self.tp is None else {"group": self.tp, "vocab_lo": self.vocab_lo}

    def head_weight(self) -> torch.Tensor:
        """The head as ``[d, vocab]`` in the compute dtype (JAX's ``w_dv``:
        the embedding transposed, or the untied head's kernel); over a
        tensor group the rank's ``[d, V / N]`` columns."""
        if self.lm_head is None:
            return self.wte.embedding.to(self.wte.compute_dtype).T
        return self.lm_head.weight.to(self.lm_head.compute_dtype).T

    def forward(self, tokens: torch.Tensor, labels: Optional[torch.Tensor] = None,
                train: bool = False, dropout_key: Optional[Tuple[int, ...]] = None):
        """[B, T] token ids -> [B, T, vocab] logits (compute dtype), or
        ``(logits, loss)`` with ``labels``: the float32 next-token loss
        (predict ``labels[:, t + 1]`` from position t); with ``loss_chunk``
        set, ``(None, loss)`` from the chunked loss, and over a tensor group
        ``(None, loss)`` from the vocab-parallel loss (calls without labels
        still return the logits). With ``doc_sep_token`` set, attention
        stays inside each document of the row and the loss skips the labels
        that start a document. ``train`` with ``dropout > 0`` applies
        dropout, and then needs ``dropout_key`` (ints, e.g. the train step's
        ``(seed, step, data rank, micro-step)``): every mask is a pure
        function of it. A weight-only int8 model computes logits only."""
        if labels is not None and self.cfg.param_quant != "none":
            raise NotImplementedError(
                "param_quant='int8' is an inference configuration; the loss paths run on "
                "full-precision params"
            )
        key = None
        if train and self.cfg.dropout > 0:
            if dropout_key is None:
                raise ValueError("training with dropout > 0 needs a dropout_key (the masks' seed)")
            key = (*dropout_key, self.seq_group.rank if self.seq_group is not None else 0)
        T = tokens.shape[1]
        if self.wpe is not None and T > self.cfg.max_seq_len:
            raise ValueError(f"sequence length {T} > max_seq_len {self.cfg.max_seq_len}: learned positions "
                             "cannot extrapolate (use position='alibi' for that)")
        packed = self.cfg.doc_sep_token is not None
        doc_ids = doc_ids_from_tokens(tokens, self.cfg.doc_sep_token) if packed else None
        if self.seq_group is not None:
            return self._forward_shard(tokens, labels, doc_ids, key)
        h = self._embed(tokens, key, torch.arange(T, device=tokens.device))
        h = self.ln_f(self._blocks(h, doc_ids, key))
        if labels is None:
            return self.logits(h)
        ignore = None
        if packed:
            labels, ignore = mask_boundary_labels(labels, doc_ids), -1
        vocab = self._vocab_split()
        if self.cfg.loss_chunk:
            return None, chunked_next_token_loss(_copy_to(h, self.tp), self.head_weight(), labels,
                                                 self.cfg.loss_chunk, ignore_index=ignore, **vocab)
        if self.tp is not None:
            return None, next_token_loss(self._local_logits(h), labels, ignore_index=ignore, **vocab)
        logits = self.logits(h)
        return logits, next_token_loss(logits, labels, ignore_index=ignore)

    def _positions(self, pos: torch.Tensor) -> torch.Tensor:
        """The learned position rows at ``pos``, clamped to the table: the
        forwards refuse rows past ``max_seq_len`` and the engine requests
        that would reach past it (as JAX's does), so only a prefill
        window's padded tail reads a clamped row, whose K/V land on the
        trash page and are never read."""
        return self.wpe(torch.clamp(pos, 0, self.wpe.embedding.shape[0] - 1))

    def _embed(self, tokens: torch.Tensor, key: Optional[Tuple[int, ...]], pos: torch.Tensor) -> torch.Tensor:
        """Token embedding (plus the learned positions at ``pos``), then the
        embedding's dropout."""
        h = self._lookup(tokens)
        if self.wpe is not None:
            h = h + self._positions(pos)
        return dropout(h, self.cfg.dropout, None if key is None else fold_seed(*key, -1, EMBED_SITE))

    def _blocks(self, h: torch.Tensor, doc_ids: Optional[torch.Tensor],
                key: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        context = noop_context_fn
        if cfg.remat_policy != "none":
            names = None if cfg.remat_policy == "dots" else QKV_MLP_NAMES
            context = functools.partial(create_selective_checkpoint_contexts, _save_policy(names))
        for i, blk in enumerate(self.blocks):
            drop = None if key is None else (cfg.dropout, fold_seed(*key, i, ATTN_SITE),
                                             fold_seed(*key, i, MLP_SITE))
            h = (checkpoint(blk, h, doc_ids, drop, use_reentrant=False, context_fn=context) if remat
                 else blk(h, doc_ids, drop))
        return h

    def _forward_shard(self, tokens, labels, doc_ids, key):
        """This rank's shard of the full row ``tokens`` [B, T]: the local
        logits ``[B, T / n, vocab]`` and, with labels, (local CE sum) /
        (the global count of labels, summed over the group without grad);
        with ``loss_chunk`` or a tensor group the sum comes from the chunked
        or the vocab-parallel loss and the logits are None. The shift and the boundary mask run on the full
        row, so the label of a shard's last position is the next shard's
        first token; the row's last position has none."""
        group = self.seq_group
        B, T = tokens.shape
        if T % group.size:
            raise ValueError(f"sequence length {T} not divisible by the sequence group's {group.size} ranks")
        t = T // group.size
        lo, hi = group.rank * t, (group.rank + 1) * t
        h = self._embed(tokens[:, lo:hi], key, torch.arange(lo, hi, device=tokens.device))
        h = self.ln_f(self._blocks(h, None if doc_ids is None else doc_ids[:, lo:hi], key))
        if labels is None:
            return self.logits(h)
        if doc_ids is not None:
            labels = mask_boundary_labels(labels, doc_ids)
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)[:, lo:hi]
        vocab = self._vocab_split()
        logits = None
        if self.cfg.loss_chunk:
            total, count = chunked_cross_entropy_sum(_copy_to(h, self.tp), self.head_weight(), shifted,
                                                     self.cfg.loss_chunk, ignore_index=-1, **vocab)
        elif self.tp is not None:
            total, count = cross_entropy_sum(self._local_logits(h), shifted, -1, **vocab)
        else:
            logits = self.logits(h)
            total, count = cross_entropy_sum(logits, shifted, ignore_index=-1)
        return logits, total / torch.clamp(group.all_reduce_sum(count), min=1.0)

    def forward_paged(
        self, tokens: torch.Tensor, pools: Pools, block_table: torch.Tensor,
        offsets: torch.Tensor, cache_len: Optional[int] = None, flash: bool = False,
    ) -> torch.Tensor:
        """[B, T] tokens at positions ``offsets[b] + t`` -> final hidden states
        ``[B, T, d_model]`` (apply ``logits`` to the rows needed). Writes the
        window's K/V into ``pools`` in place; ``cache_len`` and ``flash`` as
        in ``Attention.forward_paged``. Decoding never packs (JAX
        ``packed = ... and not self.decode``): a separator is a token.
        Learned positions are each row's own (JAX's per-slot ``decode_pos``)."""
        h = self._lookup(tokens)
        if self.wpe is not None:
            h = h + self._positions(offsets.long()[:, None] + torch.arange(tokens.shape[1], device=tokens.device))
        for blk, layer_pools in zip(self.blocks, pools):
            h = blk.forward_paged(h, layer_pools, block_table, offsets, cache_len, flash=flash)
        return self.ln_f(h)

