"""Learning-rate schedules, the weight-decay mask and the three optimizers
with global-norm clipping: AdamW, Adafactor and Lion.

Counterpart of ``zero_transformer_tpu/training/optimizer.py``:
``make_schedule`` (:27-50) with optax's formulas (``linear_schedule``,
``cosine_decay_schedule``, ``join_schedules``), ``weight_decay_mask``
(:53-66, JAX's rule by leaf path) and ``make_optimizer`` (:293-366), each chain written out on
tensors in optax's order of operations:

- ``adamw``: ``clip_by_global_norm(grad_clip)``, ``optax.adamw(b1, b2, eps,
  weight_decay, mask)``;
- ``adafactor`` (:323-348): the clip, ``optax.adafactor(schedule,
  clipping_threshold=None)`` (``scale_by_factored_rms`` with decay 0.8,
  offset 0, factoring from 128, eps 1e-30; ``scale_by_learning_rate``;
  ``scale_by_param_block_rms`` with min scale 1e-3; ``scale(-1)``), then
  ``_lr_coupled_decay`` (:69-95: ``u -= lr * wd * p`` on the decayed
  leaves);
- ``lion`` (:349-357): the clip, ``optax.lion(schedule, b1, b2,
  weight_decay, mask)``.

Every optimizer updates a fixed list of float32 tensors in place: the
model's params (one process), or the parts of this rank's ZeRO shard of the
flat layout (``parallel/zero.py``), so its state exists only for what this
rank owns. AdamW and Lion are elementwise. Adafactor factors the second
moment of each leaf whose JAX shape has two dims of at least 128
(``factoring``): each rank sums its part's squared grads into partial row
and column sums, one all-reduce of one small buffer over the data group
completes them (with the per-leaf sums of squared params that
``scale_by_param_block_rms`` needs), and every rank then holds the factored
statistics whole, as JAX replicates them. Under a tensor group a leaf may
be split (``models/gpt.py::tp_split_dim``): JAX factors the whole logical
leaf, so the port reads the factoring off the whole shape, all-reduces over
the tensor group the partial sums across the split axis (and the split
leaves' sums of squared params), averages over the whole axis, and keeps
the statistic that runs along the split axis local (a checkpoint
concatenates it; ``split_stats``); the mean of such a ``v_row`` takes one
more small all-reduce.

The count is a 0-d int32 tensor on the params' device, as optax keeps it
in the optimizer state, and no step reads it on the host: a schedule
evaluated on it and Adafactor's decay are float32 arithmetic on the
device in optax's order; AdamW's bias corrections are taken in float64,
rounded once to float32 and applied as reciprocals, the rounding the
port's host-side corrections had on the card. ``step(..., keep)`` takes
a 0-d bool tensor (the anomaly guard's verdict, ``resilience/anomaly.py``):
every write of the update (params, moments, statistics, the count) takes
the new value where it is true and keeps the old one where it is false,
inside the same passes (one more read of each state tensor, and a select
of each params delta), so a flagged step changes nothing and costs no host
sync.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zero_transformer_tpu_torch.config import OptimizerConfig
from zero_transformer_tpu_torch.parallel.sharding import Segment

# count -> learning rate: a host int gives a float, a 0-d int tensor a 0-d
# float32 tensor on its device (or a float where the schedule is constant)
Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]
CHUNK = 1 << 24  # elements AdamW updates at a time


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:  # optax: a constant schedule at init_value
        return lambda count: init

    def schedule(count):
        if isinstance(count, torch.Tensor):  # optax's order, in float32
            frac = 1 - torch.clamp(count, 0, steps) / steps
        else:
            frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        if isinstance(count, torch.Tensor):  # optax's order, in float32
            cosine = 0.5 * (1 + torch.cos(math.pi * torch.clamp(count, max=decay_steps) / decay_steps))
            return init * ((1 - alpha) * cosine + alpha)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps)) + alpha
        return init * decayed

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    def schedule(count):
        if isinstance(count, torch.Tensor):
            return torch.where(count < boundary, first(count), second(count - boundary))
        return first(count) if count < boundary else second(count - boundary)

    return schedule


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """Step count -> learning rate, on a host int or on the optimizer's
    count tensor. ``warmup_cosine`` is 0 at count 0, so the first step
    changes no weights, as in JAX."""
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
    """Parameter name -> decay? JAX's path rule on the port's names: Dense
    weights (JAX's ``kernel``) and embedding tables decay, except the
    learned positions (``wpe``); norm scales do not."""
    return {name: "wpe" not in name and name.rsplit(".", 1)[-1] in ("weight", "embedding")
            for name, _ in model.named_parameters()}


def _global_norm(grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)) if norm is None else norm


def _clip(g: torch.Tensor, trigger: torch.Tensor, g_norm: torch.Tensor, clip: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: ``g`` below the clip, else ``g / norm * clip``."""
    return torch.where(trigger, g, (g / g_norm) * clip)


def _write(dst: torch.Tensor, new: torch.Tensor, keep: Optional[torch.Tensor]) -> None:
    """``dst <- new``, or ``dst <- where(keep, new, dst)`` under the guard."""
    if keep is None:
        dst.copy_(new)
    else:
        torch.where(keep, new, dst, out=dst)


def _add(dst: torch.Tensor, delta: torch.Tensor, keep: Optional[torch.Tensor]) -> None:
    """``dst += delta``; under the guard ``dst += where(keep, delta, -0.0)``:
    x + -0.0 is x for every x, so a dropped update writes the same bits."""
    dst.add_(delta if keep is None else torch.where(keep, delta, -0.0))


class Optimizer:
    """What the three optimizers share: the params they update in place,
    the config, the schedule and the count (a 0-d int32 tensor on the
    params' device, 0 at the start; an update's learning rate is
    ``schedule(count)``; it is not part of ``tensors()``, the checkpoint
    holds it as ``opt_count``), and the state as the ZeRO layer
    saves it. ``elementwise`` maps a state key to one tensor per param (a
    tensor without elements where that param holds none of it),
    ``elementwise_leaves`` names the leaves those keys cover (None: all)
    and ``replicated`` maps ``<key>/<leaf>`` to the whole tensors every rank
    holds."""

    def __init__(self, params: List[torch.Tensor], cfg: OptimizerConfig, schedule: Schedule):
        self.params, self.cfg, self.schedule = params, cfg, schedule
        self.count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        self.elementwise: Dict[str, List[torch.Tensor]] = {}
        self.elementwise_leaves: Optional[set] = None
        self.replicated: Dict[str, torch.Tensor] = {}

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of state this rank holds."""
        return [t for parts in self.elementwise.values() for t in parts] + list(self.replicated.values())

    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip ``grads`` (one per param) by the global norm, take one step,
        and return the norm of the unclipped grads (a 0-d float32 tensor).
        ``norm`` None computes it from ``grads``; a sharded step passes the
        norm of the whole grads (JAX ``ZeroCollectives.shard_norm``,
        ``zero.py:414``). ``keep`` (a 0-d bool tensor) false leaves the
        params, the state and the count as they were."""
        raise NotImplementedError


class AdamW(Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``: ``decay``
    flags each param (a ZeRO shard passes its decayed elements and the
    others as two params). The bias correction uses the count after the
    increment."""

    def __init__(self, params: List[torch.Tensor], decay: List[bool], cfg: OptimizerConfig,
                 schedule: Schedule):
        if len(params) != len(decay):
            raise ValueError("one decay flag per param")
        super().__init__(params, cfg, schedule)
        self.decay = decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.elementwise = {"mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        g_norm = _global_norm(grads, norm)
        trigger = g_norm < cfg.grad_clip
        # the corrections in float64 from the device count, rounded once to
        # float32 and applied as a reciprocal: the rounding a host-scalar
        # correction gets on the card, so the port's trajectories stay as
        # they were (optax divides by a float32 correction, an ulp away)
        count_inc = (self.count + 1).double()
        inv_bc1 = torch.reciprocal((1 - cfg.b1**count_inc).float())
        inv_bc2 = torch.reciprocal((1 - cfg.b2**count_inc).float())
        step_size = -self.schedule(self.count)
        for p, g, mu, nu, decay in zip(self.params, grads, self.mu, self.nu, self.decay):
            # views: the updates land in place (a non-contiguous tensor raises)
            p, mu, nu, g = p.view(-1), mu.view(-1), nu.view(-1), g.reshape(-1)
            # in chunks: the temporaries of a flat shard stay small
            for s in range(0, p.numel(), CHUNK):
                pc, mc, nc = p[s:s + CHUNK], mu[s:s + CHUNK], nu[s:s + CHUNK]
                gc = _clip(g[s:s + CHUNK], trigger, g_norm, cfg.grad_clip)
                _write(mc, (1 - cfg.b1) * gc + cfg.b1 * mc, keep)
                _write(nc, (1 - cfg.b2) * torch.square(gc) + cfg.b2 * nc, keep)
                update = (mc * inv_bc1) / (torch.sqrt(nc * inv_bc2) + cfg.eps)
                if decay:
                    update = update + cfg.weight_decay * pc
                _add(pc, step_size * update, keep)
        _write(self.count, self.count + 1, keep)
        return g_norm


class Lion(Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip), lion(schedule, b1, b2,
    weight_decay, mask))``: ``u = sign((1 - b1) g + b1 mu)``, plus ``wd * p``
    where ``decay``, times ``-lr``; then ``mu = (1 - b2) g + b2 mu``. One
    momentum buffer."""

    def __init__(self, params: List[torch.Tensor], decay: List[bool], cfg: OptimizerConfig,
                 schedule: Schedule):
        if len(params) != len(decay):
            raise ValueError("one decay flag per param")
        super().__init__(params, cfg, schedule)
        self.decay = decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.elementwise = {"mu": self.mu}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        g_norm = _global_norm(grads, norm)
        trigger = g_norm < cfg.grad_clip
        step_size = -self.schedule(self.count)
        for p, g, mu, decay in zip(self.params, grads, self.mu, self.decay):
            p, mu, g = p.view(-1), mu.view(-1), g.reshape(-1)
            for s in range(0, p.numel(), CHUNK):
                pc, mc = p[s:s + CHUNK], mu[s:s + CHUNK]
                gc = _clip(g[s:s + CHUNK], trigger, g_norm, cfg.grad_clip)
                update = torch.sign((1.0 - cfg.b1) * gc + cfg.b1 * mc)
                if decay:
                    update = update + cfg.weight_decay * pc
                _add(pc, step_size * update, keep)
                _write(mc, (1.0 - cfg.b2) * gc + cfg.b2 * mc, keep)
        _write(self.count, self.count + 1, keep)
        return g_norm


# optax.adafactor's defaults, as JAX's make_optimizer builds it
AF_DECAY_RATE, AF_MIN_DIM, AF_EPS, AF_MIN_SCALE = 0.8, 128, 1e-30, 1e-3
_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = AF_MIN_DIM) -> Optional[Tuple[int, int]]:
    """The two largest axes ``(d1, d0)`` when factoring applies, else None:
    optax's rule (JAX ``_factored_dims``, ``optimizer.py:120-132``), ties
    resolved by ``np.argsort`` as there."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def factoring(name: str, shape: Sequence[int], n_layers: int, scan_layers: bool) -> Tuple[str, Optional[Tuple[int, int]]]:
    """How Adafactor treats the port's leaf ``name`` of ``shape``, by JAX's
    shapes: ``(rms group, (ar, ac) or None)``. A port ``Dense.weight`` is
    ``[out, in]``, JAX's kernel ``[in, out]``; with ``scan_layers`` a block
    leaf is one layer of JAX's stacked ``[n_layers, ...]`` leaf. ``ar`` and
    ``ac`` are the port axes JAX's ``v_row`` and ``v_col`` average over (its
    d0 and d1). ``scale_by_param_block_rms`` takes one RMS per JAX leaf:
    the group is the leaf name with the layer index starred under
    ``scan_layers``, the name itself otherwise."""
    block = _BLOCK.match(name)
    transposed = name.endswith(".weight")
    jax_shape = tuple(reversed(shape)) if transposed else tuple(shape)
    stacked = scan_layers and block is not None
    group = f"blocks.*.{block.group(2)}" if stacked else name
    dims = factored_dims((n_layers, *jax_shape) if stacked else jax_shape)
    if dims is None:
        return group, None
    if stacked:
        if 0 in dims:
            raise NotImplementedError(f"{name}: JAX factors the stacked leaf over its layer axis "
                                      f"(n_layers {n_layers}); per-layer params cannot hold that statistic")
        dims = (dims[0] - 1, dims[1] - 1)
    d1, d0 = dims
    to_port = (lambda k: len(shape) - 1 - k) if transposed else (lambda k: k)
    return group, (to_port(d0), to_port(d1))


def factored_state_numel(shapes: Dict[str, Sequence[int]], scan_layers: bool) -> int:
    """Elements of Adafactor's second-moment state for leaves ``shapes``:
    ``v_row`` plus ``v_col`` of each factored leaf, ``v`` of the others."""
    n_layers = _n_layers(shapes)
    total = 0
    for n, s in shapes.items():
        axes = factoring(n, s, n_layers, scan_layers)[1]
        total += math.prod(s) if axes is None else s[0] + s[1]
    return total


def _n_layers(names) -> int:
    return 1 + max((int(m.group(1)) for m in map(_BLOCK.match, names) if m), default=-1)


def _rows(x: torch.Tensor, start: int, cols: int) -> Tuple[torch.Tensor, int, int]:
    """A run ``x`` of a row-major ``[rows, cols]`` leaf's elements from
    element ``start`` as whole rows: ``(view [n, cols], first row, head)``,
    padded with zeros (a copy) where the run starts or ends mid-row; the run
    is ``view.reshape(-1)[head:head + x.numel()]``."""
    head = start % cols
    tail = -(start + x.numel()) % cols
    if head or tail:
        x = F.pad(x, (head, tail))
    return x.view(-1, cols), start // cols, head


@dataclasses.dataclass(frozen=True)
class _Factored:
    """Where one factored leaf ``[rows, cols]`` keeps its statistics in the
    flat ``v_row``/``v_col`` buffer: ``sum0`` (length cols) receives the
    sums over axis 0, ``sum1`` (length rows) those over axis 1; ``row`` and
    ``col`` are v_row's and v_col's slices; ``ar`` the axis v_row averages
    over."""

    cols: int
    ar: int
    row: slice
    col: slice

    @property
    def sum0(self) -> slice:
        return self.row if self.ar == 0 else self.col

    @property
    def sum1(self) -> slice:
        return self.col if self.ar == 0 else self.row


class Adafactor(Optimizer):
    """JAX's ``adafactor`` chain over the parts of leaves ``segments`` (one
    param per segment, flat or leaf-shaped; a segment may start and end
    mid-row). ``leaves`` holds every leaf of the model by name and (this
    rank's) shape, in order: every rank keeps each factored leaf's
    ``v_row`` and ``v_col`` whole, and the non-factored ones keep ``v`` over
    their segments only. ``all_reduce`` (in place, a sum over the data
    group) completes the partial sums of a sharded step; None when this
    rank holds every element it updates. ``tensor`` (a ``TensorGroup``)
    and ``split`` (name -> the dim a leaf is split along over it, or None)
    describe a tensor-parallel model, whose split leaves' whole shapes
    decide the factoring."""

    def __init__(self, params: List[torch.Tensor], segments: List[Segment], leaves: Dict[str, Sequence[int]],
                 cfg: OptimizerConfig, schedule: Schedule, scan_layers: bool,
                 all_reduce: Optional[Callable[[torch.Tensor], None]] = None, tensor=None,
                 split: Optional[Dict[str, Optional[int]]] = None):
        if len(params) != len(segments):
            raise ValueError("one segment per param")
        super().__init__(params, cfg, schedule)
        self.segments, self.all_reduce = segments, all_reduce
        tp = tensor.size if tensor is not None else 1
        self.tensor = tensor if tp > 1 else None
        split = {n: d for n, d in (split or {}).items() if d is not None} if tp > 1 else {}
        n_layers = _n_layers(leaves)
        dev = params[0].device
        groups: Dict[str, int] = {}
        group_numel: List[int] = []
        group_split: List[bool] = []
        self.group: Dict[str, int] = {}
        self.factored: Dict[str, _Factored] = {}
        rows_cols = []
        for n, s in leaves.items():
            whole = list(s)
            if n in split:
                whole[split[n]] *= tp
            group, axes = factoring(n, whole, n_layers, scan_layers)
            g = self.group[n] = groups.setdefault(group, len(groups))
            if g == len(group_numel):
                group_numel.append(0)
                group_split.append(n in split)
            group_numel[g] += math.prod(whole)
            if axes is not None:
                rows_cols.append((n, s[0], s[1], axes[0], whole, split.get(n)))  # (name, rows, cols, ar, ...)
        # v_row of every factored leaf, then v_col of every one: one flat
        # buffer. v_row runs along the axis other than ar, v_col along ar
        lengths = [(c, r) if ar == 0 else (r, c) for _, r, c, ar, _, _ in rows_cols]
        # the whole axes they average over: v_row's divisor is the whole ar
        # axis, v_col's the whole other one
        divisors = [(w[ar], w[1 - ar]) for _, _, _, ar, w, _ in rows_cols]
        self.n_row = sum(lr for lr, _ in lengths)
        self.n_stats = self.n_row + sum(lc for _, lc in lengths)
        off_r, off_c = 0, self.n_row
        self.split_stats = set()  # the statistics that run along a split axis (local)
        tp_sums = []  # the acc entries summed across a split axis
        row_split = []  # the factored leaves whose v_row is split
        for i, ((n, r, c, ar, _, k), (lr, lc)) in enumerate(zip(rows_cols, lengths)):
            f = self.factored[n] = _Factored(c, ar, slice(off_r, off_r + lr), slice(off_c, off_c + lc))
            off_r, off_c = off_r + lr, off_c + lc
            if k is not None:
                across = f.sum0 if k == 0 else f.sum1
                tp_sums += range(across.start, across.stop)
                self.split_stats.add(f"v_row/{n}" if k == 1 - ar else f"v_col/{n}")
                if k == 1 - ar:
                    row_split.append(i)
        tp_sums += [self.n_stats + g for g, sp in enumerate(group_split) if sp]
        self.tp_sums = torch.tensor(tp_sums, dtype=torch.long, device=dev) if tp_sums else None
        self.tp_rows = torch.tensor(row_split, dtype=torch.long, device=dev) if row_split else None
        self.vrc = torch.zeros(self.n_stats, dtype=torch.float32, device=dev)
        # each statistic's divisor, the whole size of the axis it averages over
        self.denom = torch.tensor([dr for (lr, _), (dr, _) in zip(lengths, divisors) for _ in range(lr)] +
                                  [dc for (_, lc), (_, dc) in zip(lengths, divisors) for _ in range(lc)],
                                  dtype=torch.float32, device=dev)
        self.row_leaf = torch.tensor([i for i, (lr, _) in enumerate(lengths) for _ in range(lr)],
                                     dtype=torch.long, device=dev)
        self.row_len = torch.tensor([dc for _, dc in divisors], dtype=torch.float32, device=dev)
        self.group_numel = torch.tensor(group_numel, dtype=torch.float32, device=dev)
        self.n_groups = len(group_numel)
        self.seg_group = torch.tensor([self.group[s.name] for s in segments], dtype=torch.long, device=dev)
        self.v = [torch.empty(0, dtype=torch.float32, device=dev) if s.name in self.factored
                  else torch.zeros(s.numel, dtype=torch.float32, device=dev) for s in segments]
        self.elementwise = {"v": self.v}
        self.elementwise_leaves = {n for n in leaves if n not in self.factored}
        for n, f in self.factored.items():
            self.replicated[f"v_row/{n}"] = self.vrc[f.row]
            self.replicated[f"v_col/{n}"] = self.vrc[f.col]

    def tensors(self) -> List[torch.Tensor]:
        return [*self.v, self.vrc]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        g_norm = _global_norm(grads, norm)
        trigger = g_norm < cfg.grad_clip
        # optax's power decay in float32: 1 - (count + 1)^-0.8
        decay_t = 1.0 - (self.count + 1).float() ** -AF_DECAY_RATE
        lr = self.schedule(self.count)
        # partial sums: the factored statistics, then each rms group's sum of p^2
        acc = torch.zeros(self.n_stats + self.n_groups, dtype=torch.float32, device=self.vrc.device)
        clipped, sq = [], []
        for p, g, seg in zip(self.params, grads, self.segments):
            gc = _clip(g.reshape(-1), trigger, g_norm, cfg.grad_clip)
            clipped.append(gc)
            f = self.factored.get(seg.name)
            if f is not None:
                rows, first, _ = _rows(gc * gc + AF_EPS, seg.start, f.cols)
                acc[f.sum0] += rows.sum(0)
                acc[f.sum1.start + first:f.sum1.start + first + rows.shape[0]] += rows.sum(1)
            pf = p.reshape(-1)
            sq.append(torch.sum(pf * pf))
        if sq:
            acc[self.n_stats:].index_add_(0, self.seg_group, torch.stack(sq))
        if self.all_reduce is not None:
            self.all_reduce(acc)
        if self.tp_sums is not None:  # the sums across a split axis, over the tensor group
            across = acc[self.tp_sums]
            self.tensor.all_reduce_([across])
            acc[self.tp_sums] = across
        mean = acc[:self.n_stats] / self.denom
        _write(self.vrc, decay_t * self.vrc + (1.0 - decay_t) * mean, keep)
        v_row = self.vrc[:self.n_row]
        row_sum = torch.zeros_like(self.row_len).index_add_(0, self.row_leaf, v_row)
        if self.tp_rows is not None:  # a split v_row's sum, over the tensor group
            part = row_sum[self.tp_rows]
            self.tensor.all_reduce_([part])
            row_sum[self.tp_rows] = part
        row_mean = row_sum / self.row_len
        # aligned with vrc: the row factors, then the column factors
        factor = torch.cat([(v_row / row_mean[self.row_leaf]) ** -0.5, self.vrc[self.n_row:] ** -0.5])
        # optax safe_root_mean_squares: min_scale where the rms is at most it
        rms = torch.sqrt(acc[self.n_stats:] / self.group_numel)
        rms = torch.where(rms <= AF_MIN_SCALE, torch.full_like(rms, AF_MIN_SCALE), rms)
        for p, gc, seg, v in zip(self.params, clipped, self.segments, self.v):
            f = self.factored.get(seg.name)
            if f is not None:
                rows, first, head = _rows(gc, seg.start, f.cols)
                rf, cf, n = factor[f.row], factor[f.col], rows.shape[0]
                if f.ar == 0:  # v_row runs along the columns, v_col along the rows
                    u = rows * rf[None, :] * cf[first:first + n, None]
                else:
                    u = rows * rf[first:first + n, None] * cf[None, :]
                u = u.reshape(-1)[head:head + seg.numel]
            else:
                _write(v, decay_t * v + (1.0 - decay_t) * (gc * gc + AF_EPS), keep)
                u = gc * v ** -0.5
            u = -((u * lr) * rms[self.group[seg.name]])
            pf = p.view(-1)
            if seg.decay:  # _lr_coupled_decay
                u = u - (lr * cfg.weight_decay) * pf
            _add(pf, u, keep)
        _write(self.count, self.count + 1, keep)
        return g_norm


def make_optimizer(model: nn.Module, cfg: OptimizerConfig, schedule: Schedule = None) -> Optimizer:
    """``cfg.optimizer`` over ``model``'s parameters, in ``named_parameters``
    order, with the weight-decay mask by module type (one process: every
    param whole)."""
    mask = weight_decay_mask(model)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    schedule = schedule or make_schedule(cfg)
    if cfg.optimizer == "adamw":
        return AdamW(params, [mask[n] for n, _ in named], cfg, schedule)
    if cfg.optimizer == "lion":
        return Lion(params, [mask[n] for n, _ in named], cfg, schedule)
    if cfg.optimizer == "adafactor":
        segments = [Segment(n, tuple(p.shape), 0, p.numel(), 0, mask[n]) for n, p in named]
        return Adafactor(params, segments, {n: tuple(p.shape) for n, p in named}, cfg, schedule,
                         model.cfg.scan_layers)
    raise ValueError(f"invalid optimizer {cfg.optimizer!r}")
