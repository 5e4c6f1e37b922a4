"""Weight-only int8 for the inference path.

Counterpart of ``zero_transformer_tpu/models/quant.py``: ``quantize_array``
(:36-49), ``quantize_params`` (:200-242, the dense and ``wte`` branches),
``QuantDense`` (:72-100) and ``QuantEmbed`` (:103-135). Symmetric
per-channel int8: a Dense weight keeps one f32 scale per output channel, the
token table one per vocabulary row, and the scale applies after the product,
which is exact for per-output-channel scales (``x @ (q * s) == (x @ q) * s``).
The port's weights are ``[out, in]`` (flax kernels transposed), so a Dense's
``weight_q`` is ``[out, in]`` int8 and its ``scale`` ``[out]``.

The CLIs quantize with ``quantize_params`` on the host's numpy tree before
any weight reaches the card (what ``serve --quantize int8`` and the eval CLI
do, as in JAX), then convert with ``convert.params_from_jax``; every
``kernel`` is quantized, the untied head's and SwiGLU's ``gate`` included,
and ``wpe`` stays float, as in JAX. ``quantize_model`` takes a float32 port
model already in memory (a seeded or a just-trained one) to the same int8
values where its weights lie, one tensor at a time with ``quantize_rows``
(bit-equal to ``quantize_array``: the same float32 divisions, rounded half
to even): an 8B model's host tree would be several 32 GB copies. MoE expert
tensors do not occur in the port's zoo: ``quantize_params`` raises on them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zero_transformer_tpu_torch.config import ModelConfig, resolve_dtype


def quantize_array(w, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 over ``axis``: (int8 ``q`` with ``w``'s
    shape, float32 ``scale`` with ``axis`` removed). numpy, on the host."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=axis)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.round(w / np.expand_dims(scale, axis)).astype(np.int8)
    return q, scale


def quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_array`` over the last axis of a float32 tensor, on its
    device: (int8 ``q``, float32 ``scale`` ``[rows]``). Both divisions are
    tensor by tensor (on CUDA, division by a Python scalar is a reciprocal
    multiply, which can miss numpy's correctly rounded quotient)."""
    w = w.float()
    amax = w.abs().amax(dim=-1)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    return torch.round(w / scale[..., None]).to(torch.int8), scale


def _convert(tree: Mapping[str, Any], path: tuple) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _convert(v, path + (k,))
        elif k == "kernel" and np.ndim(v) >= 2:
            out["kernel_q"], out["scale"] = quantize_array(v, axis=-2)
        elif k == "embedding" and path and path[-1] == "wte":
            out["embedding_q"], out["scale"] = quantize_array(v, axis=-1)
        elif k in ("wi", "wo", "gate") and np.ndim(v) >= 3:
            raise NotImplementedError("MoE expert tensors are not ported: the port's zoo has no MoE model")
        else:
            out[k] = v
    return out


def quantize_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Full-precision flax params (numpy leaves, nested or ``/``-flat) ->
    the quantized tree in the same form: every ``kernel`` (2-D, or
    scan-stacked ``[L, in, out]``) becomes ``kernel_q`` + per-output-channel
    ``scale``, ``wte/embedding`` becomes ``embedding_q`` + per-row
    ``scale``; LayerNorm scales stay float. An already-quantized tree passes
    through unchanged."""
    if any("/" in k for k in params):
        from zero_transformer_tpu_torch.convert import flatten, unflatten

        return flatten(_convert(unflatten(params), ()))
    return _convert(params, ())


def has_quantized_leaves(tree: Mapping[str, Any]) -> bool:
    """True when the tree (nested or ``/``-flat) already holds int8-serving
    leaves (``kernel_q``/``embedding_q``)."""
    return any(
        k.rsplit("/", 1)[-1] in ("kernel_q", "embedding_q")
        or (isinstance(v, Mapping) and has_quantized_leaves(v))
        for k, v in tree.items()
    )


class QuantDense(nn.Module):
    """Bias-free Dense with an int8 ``weight_q`` ``[out, in]`` and a
    per-output-channel ``scale`` ``[out]``: the product in the compute
    dtype, then the scale, both in the compute dtype (JAX's order)."""

    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, device, float32_out: bool = False):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.float32_out = float32_out
        self.weight_q = nn.Parameter(torch.zeros(d_out, d_in, dtype=torch.int8, device=device),
                                     requires_grad=False)
        self.scale = nn.Parameter(torch.ones(d_out, dtype=torch.float32, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if self.float32_out:  # a row-parallel shard: the product and the (whole) scale in float32
            from zero_transformer_tpu_torch.models.gpt import _mm_f32

            return _mm_f32(x.to(cdt), self.weight_q.to(cdt)) * self.scale.float()
        return F.linear(x.to(cdt), self.weight_q.to(cdt)) * self.scale.to(cdt)


class QuantEmbed(nn.Module):
    """Token table as int8 rows ``embedding_q`` ``[V, d]`` and per-row
    ``scale`` ``[V]``, dequantized the same way in the lookup and in the
    tied head's ``attend``."""

    def __init__(self, cfg: ModelConfig, device, num=None):
        super().__init__()
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        rows = num or cfg.vocab_size  # a tensor-parallel rank's vocabulary rows
        self.embedding_q = nn.Parameter(
            torch.zeros(rows, cfg.d_model, dtype=torch.int8, device=device), requires_grad=False
        )
        self.scale = nn.Parameter(torch.ones(rows, dtype=torch.float32, device=device), requires_grad=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return self.embedding_q[tokens].to(cdt) * self.scale[tokens].to(cdt)[..., None]

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return (h.to(cdt) @ self.embedding_q.to(cdt).T) * self.scale.to(cdt)


@torch.no_grad()
def quantize_model(model: nn.Module) -> nn.Module:
    """A float32 ``Transformer`` -> a new one with ``param_quant="int8"`` on
    the same device: every Dense ``weight`` ``[out, in]`` (per output
    channel) and the token table (per row) through ``quantize_rows`` where
    they lie, the values ``params_from_jax(quantize_params(params_to_jax(
    state)))`` gives; norm scales and ``wpe`` copied."""
    from zero_transformer_tpu_torch.models.gpt import Transformer

    if getattr(model, "tp", None) is not None:
        raise ValueError("quantize the whole model, then shard it (inference.shard_for_inference): a row split "
                         "keeps its per-channel scale whole")
    state = model.state_dict()
    if any(t.is_floating_point() and t.dtype != torch.float32 for t in state.values()):
        raise ValueError("quantize float32 weights (before cast_for_inference)")
    device = next(iter(state.values())).device
    qmodel = Transformer(dataclasses.replace(model.cfg, param_quant="int8"), device=device)
    qstate = {}
    for name, t in state.items():
        if name.endswith(".weight"):  # Dense modules only have a "weight"
            qstate[name + "_q"], qstate[name.removesuffix("weight") + "scale"] = quantize_rows(t)
        elif name == "wte.embedding":
            qstate["wte.embedding_q"], qstate["wte.scale"] = quantize_rows(t)
        else:
            qstate[name] = t
    qmodel.load_state_dict(qstate)
    return qmodel.requires_grad_(False)
