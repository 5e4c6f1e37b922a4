"""Learning-rate schedules, the weight-decay mask and AdamW with global-norm
clipping.

Counterpart of ``zero_transformer_tpu/training/optimizer.py``:
``make_schedule`` (:27-50) with optax's formulas (``linear_schedule``,
``cosine_decay_schedule``, ``join_schedules``), ``weight_decay_mask``
(:53-66) and ``make_optimizer`` (:293-366) for ``adamw``: the chain
``clip_by_global_norm(grad_clip)`` then ``optax.adamw(b1, b2, eps,
weight_decay, mask)``, written out on tensors in optax's order of
operations. Adafactor and Lion are not ported and raise.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from zero_transformer_tpu_torch.config import OptimizerConfig

Schedule = Callable[[int], float]
CHUNK = 1 << 24  # elements AdamW updates at a time


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:  # optax: a constant schedule at init_value
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps)) + alpha
        return init * decayed

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """Step count -> learning rate. ``warmup_cosine`` is 0 at count 0, so
    the first step changes no weights, as in JAX."""
    peak, end, warmup = cfg.peak_learning_rate, cfg.end_learning_rate, cfg.warmup_steps
    if cfg.schedule == "constant":
        return lambda count: peak
    decay_steps = cfg.decay_steps if cfg.decay_steps is not None else cfg.total_steps - warmup
    if cfg.schedule == "warmup_linear":
        return _join(_linear(0.0, peak, warmup), _linear(peak, end, decay_steps), warmup)
    if cfg.schedule == "warmup_cosine":
        alpha = 0.0 if peak == 0.0 else end / peak
        return _join(_linear(0.0, peak, warmup), _cosine(peak, decay_steps, alpha), warmup)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> decay? Dense kernels and the token embedding
    decay; LayerNorm scales do not."""
    from zero_transformer_tpu_torch.models.gpt import Dense, Embed

    mask = {}
    for prefix, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            mask[full] = isinstance(mod, (Dense, Embed))
    return mask


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))`` on a fixed
    list of float32 tensors, updated in place: the model's params (one
    process), or the views of this rank's ZeRO shard (``parallel/zero.py``:
    the decayed elements and the others), so m and v exist only for what
    this rank owns. Its count starts at 0 and the learning rate of an update
    is ``schedule(count)``; the bias correction uses the count after the
    increment."""

    def __init__(self, params: List[torch.Tensor], decay: List[bool], cfg: OptimizerConfig,
                 schedule: Schedule):
        if len(params) != len(decay):
            raise ValueError("one decay flag per param")
        self.params, self.decay, self.cfg, self.schedule = params, decay, cfg, schedule
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip ``grads`` by the global norm, take one AdamW step, and return
        the norm of the unclipped grads (a 0-d float32 tensor). ``norm``
        None computes it from ``grads``; a sharded step passes the norm of
        the whole grads (JAX ``ZeroCollectives.shard_norm``, ``zero.py:414``)."""
        cfg = self.cfg
        g_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)) if norm is None else norm
        trigger = g_norm < cfg.grad_clip
        count_inc = self.count + 1
        bc1, bc2 = 1 - cfg.b1**count_inc, 1 - cfg.b2**count_inc
        step_size = -self.schedule(self.count)
        for p, g, mu, nu, decay in zip(self.params, grads, self.mu, self.nu, self.decay):
            # views: the updates land in place (a non-contiguous tensor raises)
            p, mu, nu, g = p.view(-1), mu.view(-1), nu.view(-1), g.reshape(-1)
            # in chunks: the temporaries of a flat shard stay small
            for s in range(0, p.numel(), CHUNK):
                pc, mc, nc = p[s:s + CHUNK], mu[s:s + CHUNK], nu[s:s + CHUNK]
                gc = torch.where(trigger, g[s:s + CHUNK], (g[s:s + CHUNK] / g_norm) * cfg.grad_clip)
                mc.copy_((1 - cfg.b1) * gc + cfg.b1 * mc)
                nc.copy_((1 - cfg.b2) * torch.square(gc) + cfg.b2 * nc)
                update = (mc / bc1) / (torch.sqrt(nc / bc2) + cfg.eps)
                if decay:
                    update = update + cfg.weight_decay * pc
                pc.add_(step_size * update)
        self.count = count_inc
        return g_norm


def make_optimizer(model: nn.Module, cfg: OptimizerConfig, schedule: Schedule = None) -> AdamW:
    """The optimizer over ``model``'s parameters, in ``named_parameters``
    order, with the weight-decay mask by module type."""
    if cfg.optimizer != "adamw":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported yet (adamw only)")
    mask = weight_decay_mask(model)
    names = [n for n, _ in model.named_parameters()]
    return AdamW([p for _, p in model.named_parameters()], [mask[n] for n in names], cfg,
                 schedule or make_schedule(cfg))
