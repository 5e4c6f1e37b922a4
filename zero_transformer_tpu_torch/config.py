"""Typed configuration for the PyTorch/CUDA port.

Counterpart of ``zero_transformer_tpu/config.py``: ``ModelConfig`` (:32-160),
the training sections ``MeshConfig``, ``OptimizerConfig``, ``TrainingConfig``,
``DataConfig``, ``ResilienceConfig`` and ``CheckpointConfig`` (:194-642,
with JAX's defaults), ``Config``, ``ServingConfig`` (:489-620), ``model_config``
(:674), ``load_config`` (:683) and ``apply_dotted_overrides`` (:720). Only
the fields the ported slices read, or that ``configs/train_*.yaml`` set, are
here; a field that asks for something not ported raises. The zoo entries are
kept as Python data and ``load_config`` reads the YAML subset those files use
with its own small reader, because the port must not need pyyaml; tests pin
both equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Optional

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
    """Architecture hyperparameters: the GPT-2/ALiBi family and the Llama
    family (RoPE, RMSNorm, SwiGLU, GQA, an untied head), and learned
    absolute positions, as JAX's ``ModelConfig`` has them."""

    name: str = "test"
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    max_seq_len: int = 32
    dropout: float = 0.0
    position: str = "alibi"  # "alibi" | "rope" | "learned"
    rope_theta: float = 10000.0
    n_kv_heads: Optional[int] = None  # GQA; None -> MHA
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    d_ff: Optional[int] = None  # None -> 4 * d_model (gelu) or 8/3 * d_model (swiglu)
    activation: str = "gelu"  # "gelu" | "swiglu"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    tie_embeddings: bool = True
    # the JAX param layout only: the converter reads both, the port's
    # modules are the same either way
    scan_layers: bool = True
    # checkpoint each block (torch.utils.checkpoint, JAX's jax.checkpoint per
    # block): its forward runs again in the backward, except what the
    # policy saves: "none" nothing, "dots" every projection's output,
    # "qkv_mlp" q, k, v and the MLP's wi/gate outputs (models/gpt.py)
    remat: bool = False
    remat_policy: str = "none"
    attention_impl: str = "auto"  # "auto" | "xla" (plain torch) | "flash"
    # the context-parallel engine when mesh.sequence > 1: "ring" (K/V shards
    # rotate around the ranks, ops/ring_attention.py) or "ulysses"
    # (all-to-alls to whole rows over H / n heads, ops/ulysses.py)
    cp_impl: str = "ring"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # decode KV pools: "auto" stores the compute dtype; "int8" stores
    # per-(token, kv head) symmetric int8 values with f32 scales
    kv_cache_dtype: str = "auto"
    # weight-only int8 for inference (serve/evalharness --quantize int8):
    # Dense kernels and the token table as int8 with f32 per-output-channel
    # and per-vocab-row scales (models/quant.py); training rejects it
    param_quant: str = "none"
    doc_sep_token: Optional[int] = None
    loss_chunk: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_width(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation == "swiglu":
            # about the params of the 4x gelu MLP: 2/3 * 4 * d, rounded up to 128
            return ((8 * self.d_model // 3) + 127) // 128 * 128
        return 4 * self.d_model

    @property
    def num_params(self) -> int:
        """Parameter count, JAX's formula: three MLP matrices under SwiGLU,
        the token table once when tied and twice (with the head) when not.
        Like JAX's, it leaves out the learned position table."""
        d, f, L, v = self.d_model, self.ff_dim, self.n_layers, self.vocab_size
        h, kv, hd = self.n_heads, self.kv_heads, self.head_width
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = (3 if self.activation == "swiglu" else 2) * d * f
        per_layer = attn + mlp + 2 * d
        return L * per_layer + v * d * (1 if self.tie_embeddings else 2) + d

    def __post_init__(self):
        if self.d_model % self.n_heads and self.head_dim is None:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.position not in ("alibi", "rope", "learned"):
            raise ValueError(f"invalid position {self.position!r}")
        if self.activation not in ("gelu", "swiglu"):
            raise ValueError(f"invalid activation {self.activation!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"invalid norm {self.norm!r}")
        # JAX config.py:159-170: packing needs a relative position scheme,
        # and a separator outside the vocab could never appear
        if self.doc_sep_token is not None and self.position == "learned":
            raise ValueError(
                "doc_sep_token packing requires a relative position scheme (alibi/rope): "
                "learned absolute positions break the packed==standalone logits contract"
            )
        if self.doc_sep_token is not None and not 0 <= self.doc_sep_token < self.vocab_size:
            raise ValueError(
                f"doc_sep_token {self.doc_sep_token} outside vocab [0, {self.vocab_size}): "
                "the separator could never appear, silently disabling document masking"
            )
        if self.attention_impl not in ("auto", "xla", "flash"):
            raise ValueError(f"invalid attention_impl {self.attention_impl!r}")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"invalid kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.param_quant not in ("none", "int8"):
            raise ValueError(f"invalid param_quant {self.param_quant!r}")
        if self.remat_policy not in ("none", "dots", "qkv_mlp"):
            raise ValueError(f"invalid remat_policy {self.remat_policy!r}")
        if self.cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"invalid cp_impl {self.cp_impl!r}")
        if self.loss_chunk is not None and self.loss_chunk <= 0:
            raise ValueError("loss_chunk must be a positive chunk size or None")
        resolve_dtype(self.param_dtype)
        resolve_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching serving defaults and their validation (JAX
    ``ServingConfig``, with JAX's messages): a paged KV cache with 16-token
    pages, 64-token prefill chunks, 4 slots, a 256-chunk prefix cache and a
    30 s drain deadline. ``kv_layout="slab"`` is the fixed ``[slots,
    cache_len]`` layout, the only one that takes ``prefill_chunk=0`` (the
    one-shot bucketed prefill, at most ``max_prefill_buckets`` distinct
    buckets); ``fused_tail=False`` is the A/B control that brings each
    tick's sampled tokens to the host before the forward; ``role`` is
    ``mixed``, ``prefill`` or ``decode`` (non-mixed roles need paged)."""

    slots: int = 4
    max_queue: int = 64
    prefill_chunk: int = 64
    prefix_cache_chunks: int = 256  # chunk entries of the prefix cache (0 = off)
    max_prefill_buckets: int = 8
    drain_deadline_s: float = 30.0
    kv_layout: str = "paged"
    page_size: int = 16
    page_pool_tokens: int = 0  # 0 = slots x cache_len
    draft_k: int = 0  # speculative drafts verified per slot and tick (0 = off)
    fused_tail: bool = True
    role: str = "mixed"

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("serving.slots must be >= 1")
        if self.max_queue < 1:
            raise ValueError("serving.max_queue must be >= 1")
        if self.prefill_chunk < 0:
            raise ValueError("serving.prefill_chunk must be >= 0 (0 disables)")
        if self.prefix_cache_chunks < 0:
            raise ValueError("serving.prefix_cache_chunks must be >= 0 (0 disables)")
        if self.prefix_cache_chunks > 0 and self.prefill_chunk == 0:
            raise ValueError("serving.prefix_cache_chunks requires prefill_chunk > 0: the prefix cache is keyed on "
                             "chunk-aligned token spans")
        if self.max_prefill_buckets < 1:
            raise ValueError("serving.max_prefill_buckets must be >= 1")
        if self.drain_deadline_s < 0:
            raise ValueError("serving.drain_deadline_s must be >= 0")
        if self.kv_layout not in ("slab", "paged"):
            raise ValueError(f"serving.kv_layout must be 'slab' or 'paged', got {self.kv_layout!r}")
        if self.kv_layout == "paged" and self.prefill_chunk == 0:
            raise ValueError("serving.kv_layout='paged' requires prefill_chunk > 0 (the legacy one-shot prefill has "
                             "no block-table path); set kv_layout='slab' to keep prefill_chunk=0 (serve --server "
                             "falls back to slab automatically for this combination)")
        if self.page_size < 1:
            raise ValueError("serving.page_size must be >= 1")
        if self.kv_layout == "paged" and self.prefill_chunk and self.prefill_chunk % self.page_size:
            raise ValueError("serving.page_size must divide prefill_chunk (page-aligned chunk sharing)")
        if self.page_pool_tokens < 0:
            raise ValueError("serving.page_pool_tokens must be >= 0 (0 = slots x cache_len)")
        if self.draft_k < 0:
            raise ValueError("serving.draft_k must be >= 0 (0 disables)")
        if not self.fused_tail and self.draft_k:
            raise ValueError("serving.fused_tail=False (the A/B control) covers the plain decode path only; "
                             "speculative verify (draft_k > 0) is inseparable from its in-program sampling")
        if self.role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"serving.role must be mixed|prefill|decode, got {self.role!r}")
        if self.role != "mixed" and self.kv_layout != "paged":
            raise ValueError(f"serving.role={self.role!r} requires kv_layout='paged': KV pages are the unit that "
                             "ships between replicas")
        if self.role == "prefill" and self.draft_k:
            raise ValueError("serving.role='prefill' replicas never decode; draft_k must be 0")


# The dense entries of configs/models.yaml, as Python data (the MoE
# entries moe_1b, moe_test and byte_2m_moe are not ported).
MODEL_ZOO = {
    "test": dict(d_model=64, vocab_size=256, n_heads=4, max_seq_len=32, dropout=0.1, n_layers=2),
    "125m": dict(d_model=768, vocab_size=50304, n_heads=12, max_seq_len=1024, dropout=0.0, n_layers=12),
    "417m": dict(d_model=1536, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.1, n_layers=12),
    "580m": dict(d_model=1536, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.1, n_layers=18),
    "760m": dict(d_model=1536, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=24),
    "1_1b": dict(d_model=1536, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=36),
    "1_3b": dict(d_model=2048, vocab_size=50304, n_heads=16, max_seq_len=1024, dropout=0.1, n_layers=24),
    "distill": dict(d_model=768, vocab_size=50304, n_heads=12, max_seq_len=2048, dropout=0.0, n_layers=6),
    # the byte-level packed-document models of the end-to-end quality loop
    # (NUL separates documents)
    "byte_25m": dict(d_model=512, vocab_size=256, n_heads=8, max_seq_len=512, dropout=0.0, n_layers=8,
                     doc_sep_token=0),
    "byte_2m": dict(d_model=192, vocab_size=256, n_heads=6, max_seq_len=512, dropout=0.0, n_layers=3,
                    doc_sep_token=0),
    # the Llama family: RoPE, RMSNorm, SwiGLU, GQA, an untied head
    "llama3_8b": dict(d_model=4096, vocab_size=128256, n_heads=32, n_kv_heads=8, max_seq_len=8192, dropout=0.0,
                      n_layers=32, d_ff=14336, position="rope", rope_theta=500000.0, activation="swiglu",
                      norm="rmsnorm", tie_embeddings=False),
    "llama3_test": dict(d_model=64, vocab_size=256, n_heads=4, n_kv_heads=2, max_seq_len=32, dropout=0.0,
                        n_layers=2, position="rope", activation="swiglu", norm="rmsnorm", tie_embeddings=False),
    "byte_2m_llama": dict(d_model=192, vocab_size=256, n_heads=6, n_kv_heads=2, max_seq_len=512, dropout=0.0,
                          n_layers=3, position="rope", activation="swiglu", norm="rmsnorm", tie_embeddings=False,
                          doc_sep_token=0),
}


def model_config(name: str, **overrides) -> ModelConfig:
    """Look up a model by zoo name."""
    if name not in MODEL_ZOO:
        raise ValueError(f"Invalid model name {name!r}; expected one of {sorted(MODEL_ZOO)}")
    return ModelConfig(name=name, **{**MODEL_ZOO[name], **overrides})


# ------------------------------------------------------------------ training


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """``data`` ranks train data-parallel under ZeRO ``zero_stage`` (0-3,
    ``parallel/zero.py``); -1 takes every rank the launch has (world /
    (``tensor`` x ``sequence``)). ``tensor`` > 1 splits every layer's heads,
    MLP features and vocabulary over that many ranks (the Megatron layers of
    ``models/gpt.py``, the vocab-parallel loss); ``sequence`` > 1 splits
    every row over that many ranks and runs attention as a ring
    (``ops/ring_attention.py``) or through Ulysses' all-to-alls. One process
    per rank under ``torch.distributed.run``; ``world == data x tensor x
    sequence`` is checked where the groups are made (``parallel/mesh.py``).
    The other axes of the JAX mesh keep JAX's defaults and raise when asked
    for."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    sequence: int = 1
    dcn_data: int = 1
    zero_stage: int = 1
    overlap_comm: bool = False

    def __post_init__(self):
        if self.data != -1 and self.data < 1:
            raise ValueError(f"mesh.data must be -1 (every rank) or >= 1, got {self.data}")
        if self.tensor < 1:
            raise ValueError(f"mesh.tensor must be >= 1, got {self.tensor}")
        if self.sequence < 1:
            raise ValueError(f"mesh.sequence must be >= 1, got {self.sequence}")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {self.zero_stage}")
        unported = {"fsdp": ("the fsdp axis", 7), "pipe": ("pipeline parallelism", 14),
                    "dcn_data": ("multi-slice placement", 7)}
        for name, (what, item) in unported.items():
            if getattr(self, name) != 1:
                raise NotImplementedError(f"mesh.{name}={getattr(self, name)}: {what} is not ported yet "
                                          f"(ROADMAP Queue 1 item {item})")
        if self.overlap_comm:
            raise NotImplementedError("mesh.overlap_comm: the overlapped ZeRO schedule (parallel/overlap.py) "
                                      "is not ported yet (ROADMAP Queue 1 item 7)")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_learning_rate: float = 3e-4
    end_learning_rate: float = 3e-5
    warmup_steps: int = 2000
    decay_steps: Optional[int] = None  # None -> total_steps - warmup_steps
    total_steps: int = 163000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "warmup_cosine"  # "warmup_cosine" | "warmup_linear" | "constant"
    optimizer: str = "adamw"  # "adamw" | "adafactor" | "lion"

    def __post_init__(self):
        if self.optimizer not in ("adamw", "adafactor", "lion"):
            raise ValueError(f"invalid optimizer {self.optimizer!r}")


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 256  # sequences per micro-step (global on one card)
    gradient_accumulation_steps: int = 1
    train_context: int = 1024
    evaluation_frequency: int = 1000
    maximum_evaluation_steps: int = 250
    total_steps: int = 163000
    seed: int = 0
    log_frequency: int = 10
    # a torch.profiler capture of this many steps (0: off), from the step
    # after the first of the run, or over [profile_start, profile_start +
    # profile_steps) when profile_start > 0 (train --profile-window START:LEN)
    profile_steps: int = 0
    profile_start: int = 0
    profile_dir: str = ""  # default: <checkpoint.directory>/profile
    halt_on_nan: bool = True
    grad_accum_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.grad_accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"training.grad_accum_dtype must be 'float32' or 'bfloat16', got {self.grad_accum_dtype!r}"
            )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"  # "synthetic" | "memmap" | "tar" ("hf" is not ported)
    train_path: str = ""
    validation_path: str = ""
    max_context: int = 2048
    shuffle_seed: int = 23
    num_workers: int = 2  # batches read ahead by the loader's thread (0 = none)
    # tar source: True raises on any undecodable member or unreadable shard;
    # False warns, retries an open, and skips
    strict: bool = False


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """JAX's fault-tolerance policy (``zero_transformer_tpu/config.py``
    :382-486), with its fields, defaults and validation. The trainer acts on
    every field (``resilience/``, ``training/trainer.py``): the anomaly
    guard inside the step, skip -> rollback -> halt at log points, the host
    snapshot, the replica audit, the watchdog and the supervisor's restart
    budget and backoff."""

    # the per-step guard (a non-finite loss or grad norm always flags)
    anomaly_detection: bool = True
    # "skip_batch" drops flagged updates; "rollback" also restores the host
    # snapshot after `rollback_after` consecutive anomalies; "halt" raises
    # at the first detection
    anomaly_response: str = "halt"
    loss_spike_factor: float = 0.0  # > 0: flag loss > factor * EMA(loss)
    grad_spike_factor: float = 0.0  # > 0: flag grad_norm > factor * EMA(grad_norm)
    ema_decay: float = 0.98
    spike_warmup_steps: int = 50  # clean steps absorbed before spike checks arm
    max_consecutive_anomalies: int = 25  # skip_batch's streak limit: then halt
    rollback_after: int = 3  # streak length that triggers a rollback
    snapshot_frequency: int = 200  # steps between host snapshots
    max_rollbacks: int = 3  # per train() call; exceeding it halts
    audit_frequency: int = 0  # steps between replica audits (0: off)
    watchdog_timeout_s: float = 0.0  # no completed step for this long: abort (0: off)
    max_restarts: int = 3  # the supervisor's restart budget
    backoff_base_s: float = 2.0
    backoff_max_s: float = 300.0
    backoff_jitter: float = 0.1  # each delay spread uniformly over [1-j, 1+j]

    def __post_init__(self):
        if self.anomaly_response not in ("skip_batch", "rollback", "halt"):
            raise ValueError(
                f"invalid anomaly_response {self.anomaly_response!r}; expected "
                "'skip_batch', 'rollback', or 'halt'"
            )
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in (0, 1)")
        for name in ("loss_spike_factor", "grad_spike_factor"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 disables)")
        for name in ("rollback_after", "max_consecutive_anomalies"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.snapshot_frequency < 0 or self.max_rollbacks < 0:
            raise ValueError("snapshot_frequency/max_rollbacks must be >= 0")
        if self.audit_frequency < 0:
            raise ValueError("audit_frequency must be >= 0 (0 disables)")
        if self.audit_frequency > 0 and not self.anomaly_detection:
            raise ValueError(
                "audit_frequency requires anomaly_detection: the replica "
                "audit rides the in-graph anomaly-guard carry (it would be "
                "silently inert with the guard disabled)"
            )
        if self.watchdog_timeout_s < 0 or self.max_restarts < 0:
            raise ValueError("watchdog_timeout_s/max_restarts must be >= 0")
        if self.backoff_base_s <= 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError(
                "backoff_base_s must be > 0 and backoff_max_s >= backoff_base_s"
            )
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError(
                "backoff_jitter must be in [0, 1): at 1.0 the jitter window "
                "touches a zero delay, which defeats the backoff entirely"
            )


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """JAX's checkpoint fields and defaults (``checkpoint.py``): the run's
    ``metrics.jsonl`` and one step directory per save under ``directory``,
    the newest ``keep`` kept; a save every ``save_frequency`` steps and at
    the end, written by a thread with ``async_save``; ``resume`` continues
    from the newest step that verifies against its integrity manifest
    (``integrity``); ``warm_init`` starts from the params of
    ``warm_init_dir`` (a run directory) or ``warm_init_msgpack`` (JAX's
    exported params)."""

    directory: str = "checkpoints"
    keep: int = 5
    save_frequency: int = 1000
    async_save: bool = True
    resume: bool = False
    integrity: bool = True
    warm_init: bool = False
    warm_init_dir: str = ""
    warm_init_msgpack: str = ""

    def __post_init__(self):
        if self.keep < 1:
            raise ValueError(f"checkpoint.keep must be >= 1, got {self.keep}")
        if self.save_frequency < 1:
            raise ValueError(f"checkpoint.save_frequency must be >= 1, got {self.save_frequency}")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)


_SECTIONS = {
    "mesh": MeshConfig, "optimizer": OptimizerConfig, "training": TrainingConfig,
    "data": DataConfig, "checkpoint": CheckpointConfig, "resilience": ResilienceConfig,
    "serving": ServingConfig,
}


def _build(cls, raw: dict) -> Any:
    unknown = set(raw) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"Unknown keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**raw)


# YAML 1.1 plain scalars as PyYAML's resolver reads them (decimal ints and
# floats with a dot; the other int forms are refused rather than misread)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|^\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan")}
_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")


def _scalar(text: str, where: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if "\\" in body or text[0] in body:
            raise ValueError(f"{where}: escapes in quoted scalars are not supported")
        return body
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text.lower()]
    if text[0] in "[]{}&*!|>%@`-?:,#" or re.match(r"^[-+]?0[0-9xob]", text) or ": " in text:
        raise ValueError(f"{where}: {text!r} is outside the YAML subset the port reads")
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml_subset(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """Parse the two-level ``section: {key: scalar}`` YAML that
    ``configs/train_*.yaml`` use: comments, blank lines, top-level keys that
    hold a scalar or an indented block of ``key: scalar`` lines. Anything
    else (lists, flow collections, anchors, deeper nesting, tabs) raises."""
    out: Dict[str, Any] = {}
    section: Optional[Dict[str, Any]] = None
    indent = None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if "\t" in raw:
            raise ValueError(f"{where}: tabs are outside the YAML subset the port reads")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        lead = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or not key or (value and not value.startswith(" ")) or key[0] in "-?[{'\"":
            raise ValueError(f"{where}: {raw.strip()!r} is not a 'key: value' line")
        value = value.strip()
        if lead == 0:
            if key in out:
                raise ValueError(f"{where}: duplicate key {key!r}")
            if value:
                out[key], section = _scalar(value, where), None
            else:
                out[key] = section = {}
                indent = None
            continue
        if section is None or (indent is not None and lead != indent):
            raise ValueError(f"{where}: nesting deeper than one level is outside the YAML subset")
        indent = lead
        if not value:
            raise ValueError(f"{where}: nesting deeper than one level is outside the YAML subset")
        if key in section:
            raise ValueError(f"{where}: duplicate key {key!r}")
        section[key] = _scalar(value, where)
    # an empty section reads as null, as in YAML
    return {k: (None if v == {} else v) for k, v in out.items()}


def load_config(path, **overrides) -> Config:
    """Load a training ``Config`` from a YAML file of the subset above. The
    ``model`` section is a zoo lookup ``{"size": name, ...overrides}`` or an
    inline ``ModelConfig``."""
    raw = read_yaml_subset(Path(path).read_text(), str(path))
    raw.update(overrides)
    sections = {}
    model_raw = dict(raw.pop("model", {}) or {})
    if "size" in model_raw:
        size = model_raw.pop("size")
        unknown = set(model_raw) - {f.name for f in dataclasses.fields(ModelConfig)}
        if unknown:
            raise ValueError(f"Unknown keys for ModelConfig: {sorted(unknown)}")
        sections["model"] = model_config(size, **model_raw)
    elif model_raw:
        sections["model"] = _build(ModelConfig, model_raw)
    for key, cls in _SECTIONS.items():
        if key in raw:
            sections[key] = _build(cls, raw.pop(key) or {})
    if raw:
        raise ValueError(f"Unknown top-level config keys: {sorted(raw)}")
    return Config(**sections)


def apply_dotted_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply ``{"section.field": value}`` overrides (``--set``), one
    ``dataclasses.replace`` per section so only the final combination is
    validated; ``model.size`` applies first (a zoo lookup replaces the whole
    model section), as in JAX."""
    overrides = dict(overrides)
    if "model.size" in overrides:
        cfg = dataclasses.replace(cfg, model=model_config(str(overrides.pop("model.size"))))
    by_section: Dict[str, Dict[str, Any]] = {}
    for dotted, value in overrides.items():
        section_name, _, field = dotted.partition(".")
        section = getattr(cfg, section_name, None)
        if section is None or not field or field not in {f.name for f in dataclasses.fields(section)}:
            raise ValueError(f"unknown config field {dotted!r}")
        by_section.setdefault(section_name, {})[field] = value
    for section_name, fields in by_section.items():
        cfg = dataclasses.replace(
            cfg, **{section_name: dataclasses.replace(getattr(cfg, section_name), **fields)}
        )
    return cfg
