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
``ZeroShards`` hold the params and AdamW state in the flat layout of
``parallel/sharding.py``:

=====  ==============================  ======================  =====================
stage  grads, each micro-step          AdamW                   params between steps
=====  ==============================  ======================  =====================
0      all-reduce, mean                the whole buffer        whole
1      all-reduce, mean                this rank's shard       whole (all-gather)
2      reduce-scatter into the shard   this rank's shard       whole (all-gather)
3      reduce-scatter into the shard   this rank's shard       the shard only
=====  ==============================  ======================  =====================

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
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from zero_transformer_tpu_torch.config import OptimizerConfig, resolve_dtype
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.mesh import DataGroup, SequenceGroup
from zero_transformer_tpu_torch.parallel.sharding import FlatLayout
from zero_transformer_tpu_torch.resilience.detect import leaf_checksum
from zero_transformer_tpu_torch.training.optimizer import AdamW, Schedule, weight_decay_mask


class ZeroShards:
    """This rank's ZeRO state: the flat layout of the model's params over
    the data group, the full param buffer (stages 0-2, the model's params
    are its views), this rank's shard of it (a view at stages 1-2, its own
    tensor at stage 3, the whole buffer at stage 0) and the AdamW over the
    shard's decayed and undecayed elements."""

    def __init__(self, model: Transformer, opt_cfg: OptimizerConfig, schedule: Schedule, group: DataGroup,
                 zero_stage: int):
        if zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
        if opt_cfg.optimizer != "adamw":
            raise NotImplementedError(f"optimizer {opt_cfg.optimizer!r} is not ported yet (adamw only)")
        named = dict(model.named_parameters())
        dtypes = {p.dtype for p in named.values()}
        if len(dtypes) != 1:
            raise ValueError(f"the flat layout holds one param dtype, got {sorted(map(str, dtypes))}")
        self.model, self.group, self.zero_stage = model, group, zero_stage
        self.stage = zero_stage if group.size > 1 else 0
        mask = weight_decay_mask(model)
        self.layout = FlatLayout.build({n: tuple(p.shape) for n, p in named.items()}, mask, group.size)
        self.params = [named[n] for n in self.layout.names]  # layout order
        self.dtype, self.device = dtypes.pop(), self.params[0].device
        lo, hi = self.layout.shard_range(group.rank)
        full = self.layout.flatten({n: p.detach() for n, p in named.items()})
        if self.stage == 0:
            self.full, self.shard, decay_end = full, full, self.layout.decay_end
        elif self.stage < 3:
            self.full, self.shard, decay_end = full, full[lo:hi], self.layout.shard_decay_end(group.rank)
        else:
            self.full, self.shard, decay_end = None, full[lo:hi].clone(), self.layout.shard_decay_end(group.rank)
            del full
        self._bind(self.full)
        self.optimizer = AdamW([self.shard[:decay_end], self.shard[decay_end:]], [True, False], opt_cfg, schedule)

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
        """The part of the reduced grads this rank's AdamW updates."""
        if self.stage == 1:
            lo, hi = self.layout.shard_range(self.group.rank)
            return grads[lo:hi]
        return grads

    def global_norm(self, shard: torch.Tensor) -> torch.Tensor:
        """The norm of the whole grads from this rank's part of them."""
        sq = torch.sum(torch.square(shard.float()))
        if self.stage >= 1:
            sq = self.group.all_reduce_sum(sq)
        return torch.sqrt(sq)

    def all_gather_params(self) -> None:
        """Stages 1-2: every rank's updated shard into the full buffer."""
        if self.stage in (1, 2):
            self.group.all_gather_(self.full, self.shard.clone())

    # -- state as whole tensors (checkpoints) ------------------------------

    def _gather_flat(self, shard: torch.Tensor) -> torch.Tensor:
        full = torch.empty(self.layout.padded, dtype=shard.dtype, device=shard.device)
        self.group.all_gather_(full, shard)
        return full

    def state_leaves(self) -> Dict[str, torch.Tensor]:
        """The whole params and AdamW moments by name (``params/<name>``,
        ``opt_state/mu/<name>``, ``opt_state/nu/<name>``), gathered on every
        rank: a collective, every rank calls it."""
        opt = self.optimizer
        moments = {}
        for key, parts in (("mu", opt.mu), ("nu", opt.nu)):
            shard = torch.cat([t.reshape(-1) for t in parts])
            moments[key] = shard if self.stage == 0 else self._gather_flat(shard)
        params = self.full if self.stage < 3 else self._gather_flat(self.shard)
        leaves = {f"params/{n}": v for n, v in self.layout.views(params).items()}
        for key, flat in moments.items():
            leaves.update({f"opt_state/{key}/{n}": v for n, v in self.layout.views(flat).items()})
        return leaves

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Set the params from whole tensors by name (any device): this rank
        takes its slice, so a checkpoint of any world size loads."""
        missing = set(self.layout.names) - set(params)
        if missing:
            raise ValueError(f"params missing from the checkpoint: {sorted(missing)[:3]}")
        with torch.no_grad():
            if self.stage < 3:
                self.layout.fill(self.full, params)
            else:
                self.shard.copy_(self.layout.shard_of(params, self.group.rank, self.dtype, self.device))

    def load_leaves(self, leaves: Dict[str, torch.Tensor], count: int) -> None:
        """Set the params and the AdamW state from ``state_leaves``'s names."""
        self.load_params({n: leaves[f"params/{n}"] for n in self.layout.names})
        opt = self.optimizer
        with torch.no_grad():
            for key, parts in (("mu", opt.mu), ("nu", opt.nu)):
                named = {n: leaves[f"opt_state/{key}/{n}"] for n in self.layout.names}
                flat = (self.layout.flatten(named, self.dtype, self.device) if self.stage == 0
                        else self.layout.shard_of(named, self.group.rank, self.dtype, self.device))
                offset = 0
                for t in parts:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()
        opt.count = int(count)

    def target(self) -> Dict[str, tuple]:
        """Name -> (shape, dtype name) of every leaf ``state_leaves`` gives:
        what a checkpoint of this model and optimizer holds."""
        dt = str(self.dtype).removeprefix("torch.")
        out = {}
        for prefix in ("params/", "opt_state/mu/", "opt_state/nu/"):
            out.update({prefix + n: (s, dt) for n, s in zip(self.layout.names, self.layout.shapes)})
        return out

    # -- accounting ----------------------------------------------------------

    def persistent_bytes(self) -> int:
        """Bytes of the tensors this rank holds between steps (params, shard,
        AdamW moments), each storage counted once."""
        seen, total = set(), 0
        tensors = [self.shard, *self.optimizer.mu, *self.optimizer.nu]
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
    def optimizer(self) -> AdamW:
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
) -> Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]:
    """``step(state, batch [accum, B, T]) -> metrics``: one optimizer step,
    in place on ``state``. Metrics are 0-d tensors (``loss``, ``grad_norm``)
    and floats (``tokens``, ``learning_rate``): reading the tensors syncs."""
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
    acc_dt = resolve_dtype(grad_accum_dtype)
    if acc_dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grad_accum_dtype must be float32 or bfloat16, got {grad_accum_dtype!r}")
    seq = seq_group if seq_group is not None and seq_group.size > 1 else None

    def micro_grads(model: Transformer, params: List[torch.Tensor], tokens: torch.Tensor):
        _, loss = model(tokens, labels=tokens, train=True)
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
                micro_loss, micro = micro_grads(state.model, zs.params, batch[i])
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
        norm = zs.global_norm(shard)
        d = zs.optimizer.params[0].numel()
        zs.optimizer.step([shard[:d], shard[d:]], norm)
        zs.all_gather_params()
        metrics = {"loss": loss, "grad_norm": norm, "tokens": float(batch.numel() * group.size)}
        if schedule is not None:
            metrics["learning_rate"] = schedule(state.step)
        state.step += 1
        return metrics

    return train_step


def make_replica_audit(shards: ZeroShards) -> Optional[Callable[[], bool]]:
    """``audit() -> bool``: True when the data ranks' copies of the
    replicated state disagree bit for bit (JAX ``make_replica_audit``: each
    rank digests its own copy with ``leaf_checksum``, the digests are
    gathered and compared). Replicated: the params at stages 0-2 and AdamW's
    moments at stage 0; a sharded tensor has no copy to compare, so at stage
    3 nothing is audited. None for a data group of one rank."""
    if shards.group.size <= 1:
        return None

    def audit() -> bool:
        total = 0
        if shards.stage < 3:
            total += leaf_checksum(shards.full)
        if shards.stage == 0:
            total += sum(leaf_checksum(t) for t in (*shards.optimizer.mu, *shards.optimizer.nu))
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
