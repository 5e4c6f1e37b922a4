"""Model factory. Counterpart of ``zero_transformer_tpu/models/registry.py::model_getter``."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from zero_transformer_tpu_torch.config import _DTYPES, ModelConfig, model_config, resolve_device
from zero_transformer_tpu_torch.models.gpt import Transformer

_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def model_getter(
    model_size: str,
    return_cfg: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: Optional[int] = None,
    **overrides,
) -> Union[Transformer, Tuple[Transformer, ModelConfig]]:
    """Build a Transformer from the zoo by name on ``device`` (CUDA unless the
    caller asks for the CPU). ``dtype`` sets the compute dtype; params stay
    in ``param_dtype``. With ``seed`` the weights are initialised from a
    ``torch.Generator`` on the model's device; without, they are left
    uninitialised for a ``load_state_dict``."""
    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"Invalid dtype provided: {dtype}")
    dev = resolve_device(device)
    cfg = model_config(model_size, compute_dtype=_DTYPE_NAMES[dtype], **overrides)
    model = Transformer(cfg, device=dev)
    if seed is not None:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return (model, cfg) if return_cfg else model
