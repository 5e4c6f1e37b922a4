"""Data pipeline: token sources and batch loading (counterpart of
``zero_transformer_tpu/data/__init__.py``). ``synthetic``, ``memmap`` and
``tar`` sources are ported; ``hf`` raises."""
from __future__ import annotations

from zero_transformer_tpu_torch.config import Config
from zero_transformer_tpu_torch.data.loader import DataLoader, to_device  # noqa: F401
from zero_transformer_tpu_torch.data.sources import MemmapSource, SyntheticSource, TokenSource
from zero_transformer_tpu_torch.data.tarshards import TarShardSource


def make_source(cfg: Config, validation: bool = False, process_index: int = 0,
                process_count: int = 1) -> TokenSource:
    """The TokenSource named by ``cfg.data.source``. A memmap path that does
    not exist raises (no fallback to synthetic data); a tar source takes
    this process's place explicitly (JAX asks ``jax.process_index()``)."""
    data = cfg.data
    path = data.validation_path if validation else data.train_path
    if data.source == "synthetic":
        return SyntheticSource(
            vocab_size=cfg.model.vocab_size,
            max_context=data.max_context,
            seed=data.shuffle_seed + (1 if validation else 0),
        )
    if data.source == "memmap":
        return MemmapSource(path, max_context=data.max_context, shuffle=not validation,
                            seed=data.shuffle_seed)
    if data.source == "tar":
        return TarShardSource(path, max_context=data.max_context, seed=data.shuffle_seed,
                              shuffle_shards=not validation, strict=data.strict,
                              process_index=process_index, process_count=process_count)
    if data.source == "hf":
        raise NotImplementedError("data source 'hf' is not ported yet")
    raise ValueError(f"unknown data source {data.source!r}")


def make_loader(cfg: Config, validation: bool = False, process_index: int = 0,
                process_count: int = 1) -> DataLoader:
    return DataLoader(
        make_source(cfg, validation, process_index, process_count),
        batch_size=cfg.training.batch_size,
        train_context=cfg.training.train_context,
        accum_steps=1 if validation else cfg.training.gradient_accumulation_steps,
        process_index=process_index,
        process_count=process_count,
        # validation stays synchronous: Trainer.evaluate pins the source to a
        # fixed window via state()/restore(), which a read-ahead thread would race
        prefetch=0 if validation else cfg.data.num_workers,
    )
