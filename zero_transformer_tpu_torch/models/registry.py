"""Model factory. Counterpart of ``zero_transformer_tpu/models/registry.py::model_getter``."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from zero_transformer_tpu_torch.config import _DTYPES, ModelConfig, model_config, resolve_device
from zero_transformer_tpu_torch.models.gpt import Transformer

_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def build_model(cfg: ModelConfig, device, seed: Optional[int] = None,
                trainable: bool = False) -> Transformer:
    """A Transformer for ``cfg`` on ``device``: weights from a
    ``torch.Generator`` seeded with ``seed`` (uninitialised without, for a
    ``load_state_dict``); params that require grad with ``trainable``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    if seed is not None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.requires_grad_(trainable)


def model_getter(
    model_size: str,
    return_cfg: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: Optional[int] = None,
    trainable: bool = False,
    **overrides,
) -> Union[Transformer, Tuple[Transformer, ModelConfig]]:
    """Build a Transformer from the zoo by name on ``device`` (CUDA unless the
    caller asks for the CPU). ``dtype`` sets the compute dtype; params stay
    in ``param_dtype``. ``seed`` and ``trainable`` as in ``build_model``: the
    trainer asks for a trainable model, the serving engine for a frozen one."""
    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"Invalid dtype provided: {dtype}")
    dev = resolve_device(device)
    cfg = model_config(model_size, compute_dtype=_DTYPE_NAMES[dtype], **overrides)
    model = build_model(cfg, dev, seed=seed, trainable=trainable)
    return (model, cfg) if return_cfg else model
