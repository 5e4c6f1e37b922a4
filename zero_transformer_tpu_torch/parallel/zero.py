"""The train and eval steps: one process, or ZeRO data parallelism.

Counterpart of ``zero_transformer_tpu/parallel/zero.py``: ``TrainState``,
``make_train_step`` (:194-348) with the explicit collective core
``_make_explicit_zero_step`` (:461) and ``ZeroCollectives`` (:391),
``make_replica_audit`` (:599) and ``make_eval_step`` (:659).

The batch is ``[accum, B, T]`` int tokens: a data rank's own rows. With
``accum > 1`` each micro-step's grads are summed into a ``grad_accum_dtype``
buffer with ``_accum_add``'s rounding (add in the promoted dtype, round
once into the buffer), then the loss and the grads are divided by
``accum`` in float32. ``grad_norm`` is the norm of the unclipped grads;
``learning_rate`` is the schedule at the step count before the increment.
Updates happen in place.

``init_train_state`` gives the ``TrainState`` of a data group
(``parallel/mesh.py``; None: one process) at ``zero_stage``: its
``ZeroShards`` hold the params and the optimizer's state
(``optimizer.optimizer``: adamw, adafactor or lion) in the flat layout of
``parallel/sharding.py``:

=====  ==============================  ======================  =====================
stage  grads, each micro-step          optimizer               params between steps
=====  ==============================  ======================  =====================
0      all-reduce, mean                the whole buffer        whole
1      all-reduce, mean                this rank's shard       whole (all-gather)
2      reduce-scatter into the shard   this rank's shard       whole (all-gather)
3      reduce-scatter into the shard   this rank's shard       the shard only
=====  ==============================  ======================  =====================

AdamW's and Lion's moments are elementwise over the shard. Adafactor's
factored statistics are whole on every rank, completed at stages 1-3 by
one all-reduce of the shards' partial sums a step; its elementwise ``v``
(leaves that do not factor) covers the shard.

At stage 3 the step all-gathers the params once before the first forward
(JAX :513-514) into a full buffer whose views the model's params become,
and frees it after the last backward. The loss is averaged over the data
ranks, the grads divided by the data world after the sum (JAX :438; ranks
with equal local batches make the mean of their means the global mean), and
the clip uses the norm of the whole grads: the shards' squares summed over
the ranks (JAX ``shard_norm``; padding adds 0). ``tokens`` counts the
global batch (JAX :552). With a ``SequenceGroup`` as well, each rank runs
its shard of every row through the ring and its loss is its share of the
global mean: the grads and the loss are summed over the sequence ranks
first, then the data collectives run. A data group of one rank takes stage
0's step whatever ``zero_stage`` says (no shard is smaller than the whole),
as JAX's ZeRO axis of size 1 shards nothing.

Under a tensor group (the model's ``tp``, ``models/gpt.py``) each rank's
flat layout holds its own slices of the split leaves and the replicated
leaves whole, and the data group is the ranks of one tensor and sequence
rank (JAX's partial-manual core: ZeRO manual over ``data``, ``tensor``
left to GSPMD, :212-222). No grad is reduced over the tensor group: the
Megatron f/g operators leave every replicated leaf's grads equal on every
tensor rank. The norm sums the split leaves' squares over the tensor group
and counts the replicated ones once, so every rank clips by the same norm
and the anomaly guard flags alike. ``state_leaves`` gathers over the data
group, then along each split leaf's dim over the tensor group: a
checkpoint holds the one-card tree; ``load_params`` and ``load_leaves``
take the rank's slices (``convert.tensor_shard``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from zero_transformer_tpu_torch.config import OptimizerConfig, resolve_dtype
from zero_transformer_tpu_torch.convert import tensor_shard
from zero_transformer_tpu_torch.models.gpt import Transformer, tp_split_dim
from zero_transformer_tpu_torch.parallel.mesh import DataGroup, SequenceGroup
from zero_transformer_tpu_torch.parallel.sharding import FlatLayout
from zero_transformer_tpu_torch.resilience.anomaly import AnomalyGuard
from zero_transformer_tpu_torch.resilience.detect import leaf_checksum
from zero_transformer_tpu_torch.training.optimizer import (Adafactor, AdamW, Lion, Optimizer, Schedule,
                                                           weight_decay_mask)


class ZeroShards:
    """This rank's ZeRO state: the flat layout of the model's params over
    the data group, the full param buffer (stages 0-2, the model's params
    are its views), this rank's shard of it (a view at stages 1-2, its own
    tensor at stage 3, the whole buffer at stage 0) and the optimizer
    ``opt_cfg.optimizer`` over the shard's parts: its decayed and undecayed
    elements (AdamW, Lion), or the segment of each leaf it touches
    (Adafactor)."""

    def __init__(self, model: Transformer, opt_cfg: OptimizerConfig, schedule: Schedule, group: DataGroup,
                 zero_stage: int):
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
        named = dict(model.named_parameters())
        dtypes = {p.dtype for p in named.values()}
        if len(dtypes) != 1:
            raise ValueError(f"the flat layout holds one param dtype, got {sorted(map(str, dtypes))}")
        self.model, self.group, self.zero_stage = model, group, zero_stage
        self.stage = zero_stage if group.size > 1 else 0
        self.tp = model.tp  # None, or the tensor group of more than one rank
        # the dim each split leaf is cut along over the tensor group
        self.split_dim = {n: tp_split_dim(n) if self.tp is not None else None for n in named}
        mask = weight_decay_mask(model)
        self.layout = FlatLayout.build({n: tuple(p.shape) for n, p in named.items()}, mask, group.size,
                                       {n: d is not None for n, d in self.split_dim.items()})
        self.params = [named[n] for n in self.layout.names]  # layout order
        self.dtype, self.device = dtypes.pop(), self.params[0].device
        lo, hi = self.layout.shard_range(group.rank)
        full = self.layout.flatten({n: p.detach() for n, p in named.items()})
        if self.stage == 0:
            lo, hi, decay_end = 0, self.layout.padded, self.layout.decay_end
            self.full, self.shard = full, full
        elif self.stage < 3:
            self.full, self.shard, decay_end = full, full[lo:hi], self.layout.shard_decay_end(group.rank)
        else:
            self.full, self.shard, decay_end = None, full[lo:hi].clone(), self.layout.shard_decay_end(group.rank)
            del full
        self._bind(self.full)
        self.optimizer = self._make_optimizer(opt_cfg, schedule, model.cfg.scan_layers, lo, hi, decay_end)

    def _make_optimizer(self, opt_cfg: OptimizerConfig, schedule: Schedule, scan_layers: bool, lo: int, hi: int,
                        decay_end: int) -> Optimizer:
        """The optimizer over the shard ``[lo, hi)`` of the flat layout;
        ``bounds`` are its parts' ranges within the shard."""
        if opt_cfg.optimizer == "adafactor":
            segments = self.layout.segments(lo, hi)
            self.bounds = [(s.offset, s.offset + s.numel) for s in segments]
            reduce = (lambda t: self.group.all_reduce_([t])) if self.stage > 0 else None
            return Adafactor(self.split(self.shard), segments, dict(zip(self.layout.names, self.layout.shapes)),
                             opt_cfg, schedule, scan_layers, reduce, self.tp, self.split_dim)
        self.bounds = [(0, decay_end), (decay_end, hi - lo)]
        cls = {"adamw": AdamW, "lion": Lion}[opt_cfg.optimizer]
        return cls(self.split(self.shard), [True, False], opt_cfg, schedule)

    def split(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """``shard`` (this rank's part of a flat buffer) as views of the
        optimizer's parts."""
        return [shard[a:b] for a, b in self.bounds]

    # -- the params as the model sees them --------------------------------

    def _bind(self, full: Optional[torch.Tensor]) -> None:
        """Make the model's params views of ``full`` (None: empty, stage 3
        between steps)."""
        if full is None:
            for p in self.params:
                p.data = torch.empty(0, dtype=self.dtype, device=self.device)
            return
        views = self.layout.views(full)
        for n, p in zip(self.layout.names, self.params):
            p.data = views[n]

    @contextlib.contextmanager
    def gathered(self):
        """The whole params on every rank inside the block: stage 3
        all-gathers them into a full buffer and frees it at the exit; the
        other stages hold them already."""
        if self.stage < 3:
            yield self.full
            return
        full = torch.empty(self.layout.padded, dtype=self.dtype, device=self.device)
        self.group.all_gather_(full, self.shard)
        self._bind(full)
        try:
            yield full
        finally:
            self._bind(None)
            del full

    # -- collectives --------------------------------------------------------

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """One micro-step's summed grads (the full flat buffer) -> the mean
        over the data ranks: the whole buffer at stages 0-1 (all-reduce),
        this rank's shard at stages 2-3 (reduce-scatter)."""
        n = self.group.size
        if self.stage < 2:
            self.group.all_reduce_([flat])
            return flat.div_(n) if n > 1 else flat
        out = torch.empty(self.layout.shard_numel, dtype=flat.dtype, device=flat.device)
        self.group.reduce_scatter_(out, flat)
        return out.div_(n)

    def grad_shard(self, grads: torch.Tensor) -> torch.Tensor:
        """The part of the reduced grads this rank's optimizer updates."""
        if self.stage == 1:
            lo, hi = self.layout.shard_range(self.group.rank)
            return grads[lo:hi]
        return grads

    def global_norm(self, shard: torch.Tensor) -> torch.Tensor:
        """The norm of the whole grads from this rank's part of them: the
        split leaves' squares summed over the tensor group, the replicated
        leaves' counted once."""
        lo = 0 if self.stage == 0 else self.layout.shard_range(self.group.rank)[0]
        sums = [torch.zeros((), dtype=torch.float32, device=shard.device) for _ in range(2)]  # split, replicated
        for a, b, split in self.layout.parts(lo, lo + shard.numel()):
            sums[0 if split else 1] = sums[0 if split else 1] + torch.sum(torch.square(shard[a:b].float()))
        sq = torch.stack(sums)
        if self.stage >= 1:
            self.group.all_reduce_([sq])
        if self.tp is not None:
            self.tp.all_reduce_([sq[:1]])
        return torch.sqrt(sq[0] + sq[1])

    def all_gather_params(self) -> None:
        """Stages 1-2: every rank's updated shard into the full buffer."""
        if self.stage in (1, 2):
            self.group.all_gather_(self.full, self.shard.clone())

    # -- state as whole tensors (checkpoints) ------------------------------

    def _gather_flat(self, shard: torch.Tensor) -> torch.Tensor:
        full = torch.empty(self.layout.padded, dtype=shard.dtype, device=shard.device)
        self.group.all_gather_(full, shard)
        return full

    def _elementwise_names(self) -> List[str]:
        names = self.optimizer.elementwise_leaves
        return [n for n in self.layout.names if names is None or n in names]

    def state_leaves(self) -> Dict[str, torch.Tensor]:
        """The whole params and optimizer state by name, gathered on every
        rank (a collective, every rank calls it): ``params/<name>``; AdamW's
        ``opt_state/mu/<name>`` and ``opt_state/nu/<name>``; Lion's
        ``opt_state/mu/<name>``; Adafactor's ``opt_state/v_row/<name>`` and
        ``opt_state/v_col/<name>`` for the leaves that factor and
        ``opt_state/v/<name>`` for the others. The count is the
        checkpoint's ``opt_count``. Under a tensor group the split leaves
        (and the statistics along a split axis) are gathered whole."""
        opt = self.optimizer
        params = self.full if self.stage < 3 else self._gather_flat(self.shard)
        leaves = {f"params/{n}": v for n, v in self.layout.views(params).items()}
        for key, parts in opt.elementwise.items():
            shard = torch.zeros(self.shard.numel(), dtype=self.dtype, device=self.device)
            for (a, b), t in zip(self.bounds, parts):
                if t.numel():
                    shard[a:b] = t.reshape(-1)
            views = self.layout.views(shard if self.stage == 0 else self._gather_flat(shard))
            leaves.update({f"opt_state/{key}/{n}": views[n] for n in self._elementwise_names()})
        leaves.update({f"opt_state/{k}": t for k, t in opt.replicated.items()})
        return {k: self._whole(k, t) for k, t in leaves.items()}

    def _leaf_split(self, key: str) -> Optional[int]:
        """The dim a ``state_leaves`` entry is split along over the tensor
        group, or None."""
        stat = key.removeprefix("opt_state/")
        if stat in self.optimizer.replicated:  # a 1-D statistic: split where it runs along a split axis
            return 0 if stat in getattr(self.optimizer, "split_stats", ()) else None
        return self.split_dim.get(key.rsplit("/", 1)[-1])

    def _whole(self, key: str, t: torch.Tensor) -> torch.Tensor:
        dim = self._leaf_split(key)
        return t if dim is None else self.tp.all_gather_(t.contiguous(), dim)

    def _slice(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This tensor rank's slices of whole leaves by name."""
        return named if self.tp is None else tensor_shard(named, self.tp.rank, self.tp.size)

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Set the params from whole tensors by name (any device): this rank
        takes its slice (of the data shards, and of a split leaf), so a
        checkpoint of any world size loads."""
        missing = set(self.layout.names) - set(params)
        if missing:
            raise ValueError(f"params missing from the checkpoint: {sorted(missing)[:3]}")
        params = self._slice({n: params[n] for n in self.layout.names})
        with torch.no_grad():
            if self.stage < 3:
                self.layout.fill(self.full, params)
            else:
                self.shard.copy_(self.layout.shard_of(params, self.group.rank, self.dtype, self.device))

    def load_leaves(self, leaves: Dict[str, torch.Tensor], count: int) -> None:
        """Set the params and the optimizer state from ``state_leaves``'s names."""
        self.load_params({n: leaves[f"params/{n}"] for n in self.layout.names})
        opt = self.optimizer
        with torch.no_grad():
            for key, parts in opt.elementwise.items():
                named = self._slice({n: leaves[f"opt_state/{key}/{n}"] for n in self._elementwise_names()})
                flat = (self.layout.flatten(named, self.dtype, self.device) if self.stage == 0
                        else self.layout.shard_of(named, self.group.rank, self.dtype, self.device))
                for (a, b), t in zip(self.bounds, parts):
                    if t.numel():
                        t.copy_(flat[a:b].view_as(t))
            for k, t in opt.replicated.items():
                whole = leaves[f"opt_state/{k}"]
                if self._leaf_split(f"opt_state/{k}") is not None:
                    whole = whole.chunk(self.tp.size)[self.tp.rank]
                t.copy_(whole)
            opt.count.fill_(int(count))

    def target(self) -> Dict[str, tuple]:
        """Name -> (shape, dtype name) of every leaf ``state_leaves`` gives:
        what a checkpoint of this model and optimizer holds. Another
        optimizer's checkpoint differs in its leaf set: a structural
        mismatch, fatal on restore."""
        dt = str(self.dtype).removeprefix("torch.")
        shapes = dict(zip(self.layout.names, self.layout.shapes))
        out = {f"params/{n}": (s, dt) for n, s in shapes.items()}
        for key in self.optimizer.elementwise:
            out.update({f"opt_state/{key}/{n}": (shapes[n], dt) for n in self._elementwise_names()})
        out.update({f"opt_state/{k}": (tuple(t.shape), dt) for k, t in self.optimizer.replicated.items()})
        whole = {}
        for k, (shape, d) in out.items():
            dim = self._leaf_split(k)
            if dim is not None:
                shape = shape[:dim] + (shape[dim] * self.tp.size,) + shape[dim + 1:]
            whole[k] = (shape, d)
        return whole

    # -- accounting ----------------------------------------------------------

    def persistent_bytes(self) -> int:
        """Bytes of the tensors this rank holds between steps (params, shard,
        optimizer state), each storage counted once. The optimizer's 0-d
        count and the anomaly guard's carry are not counted (JAX's carry is
        not optimizer state either)."""
        seen, total = set(), 0
        tensors = [self.shard, *self.optimizer.tensors()]
        if self.full is not None:
            tensors.append(self.full)
        for t in tensors:
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        return total


@dataclasses.dataclass
class TrainState:
    step: int
    model: Transformer
    shards: ZeroShards

    @property
    def optimizer(self) -> Optimizer:
        return self.shards.optimizer


def init_train_state(model: Transformer, opt_cfg: OptimizerConfig, schedule: Schedule,
                     group: Optional[DataGroup] = None, zero_stage: int = 1) -> TrainState:
    """The train state of ``model`` (whose params are the same on every
    rank) over ``group`` (None: one process); the model's params become
    views of its buffers."""
    if group is None:
        group = DataGroup(rank=0, size=1, backend="none", device=next(model.parameters()).device)
    return TrainState(step=0, model=model, shards=ZeroShards(model, opt_cfg, schedule, group, zero_stage))


def accum_add_(acc: torch.Tensor, g: torch.Tensor) -> None:
    """``acc <- round_into(acc.dtype, acc + g)``, the sum taken in the
    promoted dtype (JAX ``_accum_add``)."""
    ct = torch.promote_types(acc.dtype, g.dtype)
    acc.copy_(acc.to(ct) + g.to(ct))


def make_train_step(
    zero_stage: int = 1,
    schedule: Optional[Callable[[int], float]] = None,
    grad_accum_dtype: str = "float32",
    seq_group: Optional[SequenceGroup] = None,
    seed: int = 0,
    guard: Optional[AnomalyGuard] = None,
    poison: Optional[Callable[[TrainState], torch.Tensor]] = None,
) -> Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]:
    """``step(state, batch [accum, B, T]) -> metrics``: one optimizer step,
    in place on ``state``. Metrics are 0-d tensors (``loss``, ``grad_norm``)
    and floats (``tokens``, ``learning_rate``): reading the tensors syncs.
    A model with dropout draws micro-step ``i``'s masks from ``(seed, step,
    data rank, i)`` (JAX folds the step, the data index and the micro-step
    into its rng, :505-511).

    ``guard`` (``resilience/anomaly.py``) flags the step from the reduced
    loss and the global grad norm, both the same on every rank, between the
    norm and the update, and hands the optimizer ``keep = ~flag``: a flagged
    step writes nothing (JAX selects the old state after the step, ``wrap``
    :147-168; here the step is in place, so the select is inside the
    optimizer's passes). ``state.step`` advances either way (the batch is
    consumed); ``metrics["anomaly"]`` is the flag, a 0-d bool tensor. The
    guard's carry advances on the device: nothing is read on the host.
    ``poison(state)`` (chaos, ``resilience/chaos.py``) returns a 0-d float32
    tensor added to the loss and to the reduced grads before the norm: NaN
    inside a fault window, 0 outside, decided on the device."""
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
    acc_dt = resolve_dtype(grad_accum_dtype)
    if acc_dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grad_accum_dtype must be float32 or bfloat16, got {grad_accum_dtype!r}")
    seq = seq_group if seq_group is not None and seq_group.size > 1 else None

    def micro_grads(model: Transformer, params: List[torch.Tensor], tokens: torch.Tensor, key):
        _, loss = model(tokens, labels=tokens, train=True, dropout_key=key)
        return loss.detach(), torch.autograd.grad(loss, params)

    def train_step(state: TrainState, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        zs = state.shards
        if zs.zero_stage != zero_stage:
            raise ValueError(f"the state is sharded for zero_stage {zs.zero_stage}, the step for {zero_stage}")
        group, accum = zs.group, batch.shape[0]
        loss = torch.zeros((), dtype=torch.float32, device=batch.device)
        grads: Optional[torch.Tensor] = None
        with zs.gathered():
            for i in range(accum):
                micro_loss, micro = micro_grads(state.model, zs.params, batch[i],
                                                (seed, state.step, group.rank, i))
                flat = zs.layout.flatten(dict(zip(zs.layout.names, micro)))
                del micro
                if seq is not None:
                    seq.all_reduce_([flat])
                    micro_loss = seq.all_reduce_sum(micro_loss)
                reduced = zs.reduce(flat)
                del flat
                loss = loss + group.all_reduce_sum(micro_loss) / group.size
                if accum == 1:
                    grads = reduced
                else:
                    if grads is None:
                        grads = torch.zeros(reduced.shape, dtype=acc_dt, device=reduced.device)
                    accum_add_(grads, reduced)
                del reduced
        if accum > 1:
            loss, grads = loss / accum, grads.float() / accum
        shard = zs.grad_shard(grads)
        if poison is not None:
            nan = poison(state)
            loss = loss + nan
            shard.add_(nan)
        norm = zs.global_norm(shard)
        bad = guard.flag(loss, norm) if guard is not None else None
        zs.optimizer.step(zs.split(shard), norm, None if bad is None else ~bad)
        zs.all_gather_params()
        metrics = {"loss": loss, "grad_norm": norm, "tokens": float(batch.numel() * group.size)}
        if guard is not None:
            guard.advance(bad, loss, norm)
            metrics["anomaly"] = bad
        if schedule is not None:
            metrics["learning_rate"] = schedule(state.step)
        state.step += 1
        return metrics

    return train_step


def make_replica_audit(shards: ZeroShards) -> Optional[Callable[[], bool]]:
    """``audit() -> bool``: True when the data ranks' copies of the
    replicated state disagree bit for bit (JAX ``make_replica_audit``: each
    rank digests its own copy with ``leaf_checksum``, the digests are
    gathered and compared). Replicated: the params at stages 0-2, the whole
    optimizer state at stage 0, and Adafactor's factored statistics at every
    stage; a sharded tensor has no copy to compare, so at stage 3 AdamW and
    Lion leave nothing to audit. None for a data group of one rank."""
    if shards.group.size <= 1:
        return None

    def audit() -> bool:
        total = 0
        if shards.stage < 3:
            total += leaf_checksum(shards.full)
        opt = shards.optimizer
        replicated = opt.tensors() if shards.stage == 0 else list(opt.replicated.values())
        total += sum(leaf_checksum(t) for t in replicated if t.numel())
        digests = shards.group.all_gather_object(total % (1 << 32))
        return any(d != digests[0] for d in digests)

    return audit


def make_eval_step(model: Transformer,
                   data_group: Optional[DataGroup] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_step(batch [B, T]) -> mean next-token loss`` (0-d tensor): under
    a sequence group the ranks' shares summed, under a data group the
    ranks' means averaged. At ZeRO stage 3 call it inside
    ``ZeroShards.gathered()``."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> torch.Tensor:
        loss = model(batch, labels=batch)[1]
        if model.seq_group is not None:
            loss = model.seq_group.all_reduce_sum(loss)
        if data_group is not None and data_group.size > 1:
            loss = data_group.all_reduce_sum(loss) / data_group.size
        return loss

    return eval_step
