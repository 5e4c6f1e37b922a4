"""Decoder-only transformer LM (GPT-2 block with ALiBi), in PyTorch.

Counterpart of ``zero_transformer_tpu/models/gpt.py``: ``Attention`` (:157),
``MLP`` (:416), ``Block`` (:448), ``Transformer`` (:497) with the tied head.
Ported: the full-sequence forward, with the next-token loss for training
(``forward(tokens, labels, train=True)``, JAX ``Transformer.__call__``
:512-684), packed documents for ``doc_sep_token`` models
(``doc_ids_from_tokens`` and ``mask_boundary_labels``, :63-81: the ids ride
through every block into the attention, and the loss skips each document's
first label), and the PAGED decode variant the serving engine runs, which
never packs. Params are built with ``requires_grad=False`` (serving runs
under ``no_grad``); the trainer turns them on with ``requires_grad_(True)``.
Numerics follow flax where it matters:

- bias-free LayerNorm with eps 1e-6 (flax's default, not torch's 1e-5),
  statistics in float32 as E[x^2] - E[x]^2 clipped at 0, scale in float32,
  result in the compute dtype;
- ``nn.gelu`` is the tanh approximation;
- ``nn.Dense`` computes in the compute dtype from float32 params. Flax casts
  the params on every call; ``cast_for_inference`` casts the Dense and
  embedding weights once instead, which gives the same values;
- the tied head is ``h @ wte.T`` in the compute dtype (``embed.attend``),
  so the tied table gets gradient from both the lookup and the head;
- training keeps the float32 master params: every Dense and the embedding
  cast per call, and autograd carries the grads back to float32.

Layouts at the public surface are the JAX ones: q/k/v ``[B, T, H, D]``,
page pools ``[n_pages, page, KVH, D]`` with page 0 the serving layer's trash
page, block tables ``[B, n_blocks]`` int32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zero_transformer_tpu_torch.config import ModelConfig, resolve_dtype
from zero_transformer_tpu_torch.ops import paged_attention as pa
from zero_transformer_tpu_torch.ops.attention import dot_product_attention
from zero_transformer_tpu_torch.ops.losses import next_token_loss

LN_EPS = 1e-6  # flax LayerNorm default

# (k_pool, v_pool) per layer, each [n_pages, page, KVH, D]
Pools = List[Tuple[torch.Tensor, torch.Tensor]]


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


class Dense(nn.Module):
    """Bias-free linear layer. ``weight`` is ``[out, in]`` (the flax kernel
    transposed) and the product runs in the compute dtype."""

    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, device):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=resolve_dtype(cfg.param_dtype), device=device),
            requires_grad=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return F.linear(x.to(cdt), self.weight.to(cdt))


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


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        H, KVH, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_width, cfg.d_model
        self.query = Dense(d, H * D, cfg, device)
        self.key = Dense(d, KVH * D, cfg, device)
        self.value = Dense(d, KVH * D, cfg, device)
        self.out = Dense(H * D, d, cfg, device)

    def _qkv(self, x):
        cfg = self.cfg
        B, T, _ = x.shape
        q = self.query(x).reshape(B, T, cfg.n_heads, cfg.head_width)
        k = self.key(x).reshape(B, T, cfg.kv_heads, cfg.head_width)
        v = self.value(x).reshape(B, T, cfg.kv_heads, cfg.head_width)
        return q, k, v

    def forward(self, x: torch.Tensor, doc_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = self._qkv(x)
        out = dot_product_attention(q, k, v, causal=True, alibi=True, doc_ids=doc_ids,
                                    impl=self.cfg.attention_impl)
        return self.out(out.reshape(B, T, -1))

    def forward_paged(
        self, x: torch.Tensor, pools: Tuple[torch.Tensor, torch.Tensor],
        block_table: torch.Tensor, offsets: torch.Tensor,
    ) -> torch.Tensor:
        """Write this window's K/V through the block table, then attend over
        the row's cache. ``offsets`` [B] is each row's first position."""
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = self._qkv(x)
        k_pool, v_pool = pools
        page = k_pool.shape[1]
        n_blocks = block_table.shape[1]
        cache_len = n_blocks * page
        pos = offsets.long()[:, None] + torch.arange(T, device=x.device)  # [B, T]
        # out-of-range blocks clip to the last table entry: overflow is made
        # loud by the NaN poison below, and a parked row's zeroed table
        # routes its write to the trash page
        page_ids = torch.gather(block_table.long(), 1, torch.clamp(pos // page, 0, n_blocks - 1))
        in_page = pos % page
        # the pools are updated IN PLACE (the JAX engine donates its cache)
        k_pool[page_ids, in_page] = k.to(k_pool.dtype)
        v_pool[page_ids, in_page] = v.to(v_pool.dtype)
        # writing past capacity poisons only the overflowing row's output
        overflow = (offsets + T > cache_len)[:, None, None, None]
        q = torch.where(overflow, torch.full((), math.nan, dtype=q.dtype, device=q.device),
                        torch.ones((), dtype=q.dtype, device=q.device)) * q
        if T > pa.MAX_DECODE_T:
            # a prefill chunk: gather the row's pages once, then the flash kernel
            k_all, v_all, kv_valid = pa.gather_window(k_pool, v_pool, block_table, offsets, T)
            out = dot_product_attention(
                q, k_all, v_all, causal=True, alibi=True, q_offset=offsets,
                segment_ids=kv_valid, impl=cfg.attention_impl,
            )
        elif cfg.attention_impl == "xla":
            out = pa.paged_reference(q, k_pool, v_pool, block_table, offsets, causal=T > 1, alibi=True)
        else:
            out = pa.paged_attention(q, k_pool, v_pool, block_table, offsets, causal=T > 1, alibi=True)
        return self.out(out.reshape(B, T, -1))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.ff_dim, cfg, device)
        self.wo = Dense(cfg.ff_dim, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg, device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, doc_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), doc_ids)
        return x + self.mlp(self.ln_mlp(x))

    def forward_paged(self, x, pools, block_table, offsets) -> torch.Tensor:
        x = x + self.attn.forward_paged(self.ln_attn(x), pools, block_table, offsets)
        return x + self.mlp(self.ln_mlp(x))


class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=resolve_dtype(cfg.param_dtype), device=device),
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

    def __init__(self, cfg: ModelConfig, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """The JAX init: normal(0.02) kernels and embedding, residual
        projections (attention out, MLP wo) at 0.02 / sqrt(2 * n_layers),
        LayerNorm scales at one. Draws from ``generator``, whose device must
        be the model's."""
        resid_std = 0.02 / math.sqrt(2 * self.cfg.n_layers)
        self.wte.embedding.normal_(0.0, 0.02, generator=generator)
        for blk in self.blocks:
            for dense in (blk.attn.query, blk.attn.key, blk.attn.value, blk.mlp.wi):
                dense.weight.normal_(0.0, 0.02, generator=generator)
            for dense in (blk.attn.out, blk.mlp.wo):
                dense.weight.normal_(0.0, resid_std, generator=generator)
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
        return self

    @torch.no_grad()
    def cast_for_inference(self) -> "Transformer":
        """Store the Dense and embedding weights in the compute dtype once,
        rather than casting them on every call as flax does (same values);
        LayerNorm scales stay in float32, as flax computes them."""
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.data = mod.weight.data.to(mod.compute_dtype)
            elif isinstance(mod, Embed):
                mod.embedding.data = mod.embedding.data.to(mod.compute_dtype)
        return self

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Tied head: ``h @ wte.T`` in the compute dtype."""
        return self.wte.attend(h)

    def forward(self, tokens: torch.Tensor, labels: Optional[torch.Tensor] = None,
                train: bool = False):
        """[B, T] token ids -> [B, T, vocab] logits (compute dtype), or
        ``(logits, loss)`` with ``labels``: the float32 next-token loss
        (predict ``labels[:, t + 1]`` from position t). With
        ``doc_sep_token`` set, attention stays inside each document of the
        row and the loss skips the labels that start a document. ``train``
        would turn dropout on, which is not ported: it raises for
        ``dropout > 0``."""
        if train and self.cfg.dropout > 0:
            raise NotImplementedError("dropout > 0 in training is not ported yet")
        packed = self.cfg.doc_sep_token is not None
        doc_ids = doc_ids_from_tokens(tokens, self.cfg.doc_sep_token) if packed else None
        h = self.wte(tokens)
        for blk in self.blocks:
            h = blk(h, doc_ids)
        logits = self.logits(self.ln_f(h))
        if labels is None:
            return logits
        if packed:
            return logits, next_token_loss(logits, mask_boundary_labels(labels, doc_ids), ignore_index=-1)
        return logits, next_token_loss(logits, labels)

    def forward_paged(
        self, tokens: torch.Tensor, pools: Pools, block_table: torch.Tensor,
        offsets: torch.Tensor,
    ) -> torch.Tensor:
        """[B, T] tokens at positions ``offsets[b] + t`` -> final hidden states
        ``[B, T, d_model]`` (apply ``logits`` to the rows needed). Writes the
        window's K/V into ``pools`` in place. Decoding never packs (JAX
        ``packed = ... and not self.decode``): a separator is a token."""
        h = self.wte(tokens)
        for blk, layer_pools in zip(self.blocks, pools):
            h = blk.forward_paged(h, layer_pools, block_table, offsets)
        return self.ln_f(h)

