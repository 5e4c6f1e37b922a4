"""Typed configuration for the PyTorch/CUDA port.

Counterpart of ``zero_transformer_tpu/config.py`` (``ModelConfig`` at
:32-160, ``ServingConfig`` at :489-620, ``model_config`` at :674). Only the
fields the serving slice reads are ported. The zoo entries the port serves
are kept here as Python data, because the port must not need pyyaml; a test
pins each of them equal to the JAX package's ``model_config(name)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Invalid dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    silently replaced: asking for it without a card raises. Tests pass
    ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' (or --device cpu) to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card; tensors report it as cuda:<index>
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the GPT-2/ALiBi family the slice serves."""

    name: str = "test"
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    max_seq_len: int = 32
    dropout: float = 0.0
    position: str = "alibi"
    n_kv_heads: Optional[int] = None  # GQA; None -> MHA
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    d_ff: Optional[int] = None  # None -> 4 * d_model
    activation: str = "gelu"
    norm: str = "layernorm"
    tie_embeddings: bool = True
    attention_impl: str = "auto"  # "auto" | "xla" (plain torch) | "flash"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "auto"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_width(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    def __post_init__(self):
        if self.d_model % self.n_heads and self.head_dim is None:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        # the slice ports the GPT-2/ALiBi block only; the Llama variants
        # (rope, rmsnorm, swiglu) and learned positions come with a later slice
        if self.position != "alibi":
            raise NotImplementedError(f"position {self.position!r} is not ported yet")
        if self.activation != "gelu" or self.norm != "layernorm":
            raise NotImplementedError("only gelu + layernorm blocks are ported yet")
        if not self.tie_embeddings:
            raise NotImplementedError("only tied embeddings are ported yet")
        if self.attention_impl not in ("auto", "xla", "flash"):
            raise ValueError(f"invalid attention_impl {self.attention_impl!r}")
        if self.kv_cache_dtype != "auto":
            raise NotImplementedError("the int8 KV cache is not ported yet")
        resolve_dtype(self.param_dtype)
        resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching serving defaults (JAX ``ServingConfig``): a paged
    KV cache with 16-token pages, 64-token prefill chunks, 4 slots."""

    slots: int = 4
    max_queue: int = 64
    prefill_chunk: int = 64
    page_size: int = 16
    page_pool_tokens: int = 0  # 0 = slots x cache_len

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("serving.slots must be >= 1")
        if self.max_queue < 1:
            raise ValueError("serving.max_queue must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("serving.prefill_chunk must be >= 1 (paged KV needs chunked prefill)")
        if self.page_size < 1 or self.prefill_chunk % self.page_size:
            raise ValueError("serving.page_size must be >= 1 and divide prefill_chunk")
        if self.page_pool_tokens < 0 or self.page_pool_tokens % self.page_size:
            raise ValueError("serving.page_pool_tokens must be >= 0 and a multiple of page_size")


# The GPT-2/ALiBi entries of configs/models.yaml, as Python data.
MODEL_ZOO = {
    "test": dict(d_model=64, vocab_size=256, n_heads=4, max_seq_len=32, dropout=0.1, n_layers=2),
    "125m": dict(d_model=768, vocab_size=50304, n_heads=12, max_seq_len=1024, dropout=0.0, n_layers=12),
    "417m": dict(d_model=1536, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.1, n_layers=12),
    "580m": dict(d_model=1536, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.1, n_layers=18),
    "760m": dict(d_model=1536, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=24),
    "1_1b": dict(d_model=1536, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=36),
    "1_3b": dict(d_model=2048, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=24),
    "distill": dict(d_model=768, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.0, n_layers=6),
}


def model_config(name: str, **overrides) -> ModelConfig:
    """Look up a model by zoo name."""
    if name not in MODEL_ZOO:
        raise ValueError(f"Invalid model name {name!r}; expected one of {sorted(MODEL_ZOO)}")
    return ModelConfig(name=name, **{**MODEL_ZOO[name], **overrides})
