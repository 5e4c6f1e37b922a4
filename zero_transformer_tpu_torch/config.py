"""Typed configuration for the PyTorch/CUDA port.

Counterpart of ``zero_transformer_tpu/config.py``: ``ModelConfig`` (:32-160),
the training sections ``MeshConfig`` (its ``data`` and ``zero_stage``
fields), ``OptimizerConfig``, ``TrainingConfig``, ``DataConfig``,
``ResilienceConfig`` and ``CheckpointConfig`` (:290-480, with JAX's
defaults), ``Config``, ``ServingConfig`` (:489-620), ``model_config``
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
    # the JAX param layout only: the converter reads both, the port's
    # modules are the same either way
    scan_layers: bool = True
    remat: bool = False
    attention_impl: str = "auto"  # "auto" | "xla" (plain torch) | "flash"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "auto"
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
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def num_params(self) -> int:
        """Parameter count (the tied embedding once), JAX's formula."""
        d, f, L, v = self.d_model, self.ff_dim, self.n_layers, self.vocab_size
        h, kv, hd = self.n_heads, self.kv_heads, self.head_width
        per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d * f + 2 * d
        return L * per_layer + v * d + d

    def __post_init__(self):
        if self.d_model % self.n_heads and self.head_dim is None:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_kv_heads is not None and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
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
        if self.remat:
            raise NotImplementedError("remat is not ported yet")
        if self.loss_chunk is not None:
            raise NotImplementedError("the chunked cross entropy (loss_chunk) is not ported yet")
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


# The GPT-2/ALiBi entries of configs/models.yaml, as Python data (the MoE
# and Llama variants byte_2m_moe / byte_2m_llama are not ported).
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
}


def model_config(name: str, **overrides) -> ModelConfig:
    """Look up a model by zoo name."""
    if name not in MODEL_ZOO:
        raise ValueError(f"Invalid model name {name!r}; expected one of {sorted(MODEL_ZOO)}")
    return ModelConfig(name=name, **{**MODEL_ZOO[name], **overrides})


# ------------------------------------------------------------------ training


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """One card: ``data`` is -1 (all devices) or 1. Every ZeRO stage is the
    same step on one device; ``zero_stage`` is kept and recorded."""

    data: int = -1
    zero_stage: int = 1

    def __post_init__(self):
        if self.data not in (-1, 1):
            raise NotImplementedError("data parallelism over several cards is not ported yet")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {self.zero_stage}")


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
    optimizer: str = "adamw"  # adafactor and lion are not ported

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
    """JAX's fault-tolerance policy, as data. The port's trainer halts on a
    non-finite loss (``training.halt_on_nan``, JAX's default "halt"
    response); spike detection, skip/rollback, snapshots, the watchdog and
    the supervisor are not ported, and the trainer prints the settings it
    does not act on."""

    anomaly_detection: bool = True
    anomaly_response: str = "halt"  # "skip_batch" | "rollback" | "halt"
    loss_spike_factor: float = 0.0
    grad_spike_factor: float = 0.0
    snapshot_frequency: int = 200
    watchdog_timeout_s: float = 0.0
    max_restarts: int = 3

    def __post_init__(self):
        if self.anomaly_response not in ("skip_batch", "rollback", "halt"):
            raise ValueError(f"invalid anomaly_response {self.anomaly_response!r}")
        for name in ("loss_spike_factor", "grad_spike_factor", "watchdog_timeout_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 disables)")
        if self.snapshot_frequency < 0 or self.max_restarts < 0:
            raise ValueError("snapshot_frequency/max_restarts must be >= 0")

    def unported(self) -> Dict[str, Any]:
        """The settings that differ from JAX's defaults: each asks for a
        policy the port's trainer does not have yet."""
        base = ResilienceConfig()
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) != getattr(base, f.name)}


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """``directory`` holds the run's ``metrics.jsonl``. Saving and resuming
    are not ported: ``resume`` raises."""

    directory: str = "checkpoints"
    save_frequency: int = 1000
    resume: bool = False

    def __post_init__(self):
        if self.resume:
            raise NotImplementedError("checkpoint resume is not ported yet")


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
