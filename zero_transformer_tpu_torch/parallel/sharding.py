"""The ZeRO shard layout of the params, the topology a checkpoint records,
and the check that decides whether a run may resume on another topology.

Counterpart of ``zero_transformer_tpu/parallel/sharding.py``:
``_add_zero_axis`` (:131) and ``zero_sharding``, ``topology_summary``
(:226) and ``check_elastic_compat`` (:248).

The layout differs from JAX's on purpose. JAX shards each leaf on its
largest dim that the ZeRO world divides and keeps the other leaves
replicated, which suits GSPMD's per-array shardings. Here the params live
in one flat float32 buffer, padded with zeros to a multiple of the data
world ``n``, and rank ``r`` owns the contiguous slice ``[r * s, (r + 1) *
s)`` with ``s = padded / n``: one reduce-scatter and one all-gather a step
whatever the leaves' shapes, every rank holding exactly ``1/n`` of the
state at any world size (no leaf stays replicated), and the model's params
are views of the full buffer, so a gather updates them in place. The
leaves that decay (``weight_decay_mask``) come first, so the mask is one
boundary in the flat order, carried per element without a buffer of its
own. Padding is zero in the params and in the grads, so it adds nothing to
the norm or the digests, and the optimizers leave it zero. Checkpoints hold
whole leaves by name, so a restore onto another world is a re-slice.
``FlatLayout.segments`` maps a contiguous range of the buffer back onto the
leaves it touches, for the optimizers whose statistics are per leaf
(Adafactor's factored rows and columns).

Under a tensor group the layout is built over the rank's LOCAL shapes (a
split leaf's shard, ``models/gpt.py::tp_split_dim``): every tensor rank has
the same layout of its own values, and the data group (the ranks of one
tensor and sequence rank) shards it as above. Within each decay class the
split leaves come first, so the split elements of any range are at most
two runs (``parts``): the global norm sums their squares over the tensor
group and counts the replicated leaves once. Each ``Segment`` says whether
its leaf is split, for the optimizers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Segment:
    """The part of leaf ``name`` (of ``shape``) that a range of the flat
    buffer holds: the leaf's elements ``[start, stop)`` in row-major order,
    at ``offset`` within the range. A segment may start and end mid-row."""

    name: str
    shape: Tuple[int, ...]
    start: int
    stop: int
    offset: int
    decay: bool
    split: bool = False  # the leaf is split over a tensor group

    @property
    def numel(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each named leaf lives in the flat buffer of ``world`` shards."""

    names: Tuple[str, ...]  # flat order: the decayed leaves first, split before replicated in each class
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    numel: int  # elements of all leaves
    decay_end: int  # elements [0, decay_end) decay
    world: int
    split: Tuple[bool, ...]  # per leaf: split over a tensor group
    split_runs: Tuple[Tuple[int, int], ...]  # the split leaves' element ranges, at most two

    @classmethod
    def build(cls, shapes: Dict[str, Sequence[int]], decay: Dict[str, bool], world: int,
              split: Optional[Dict[str, bool]] = None) -> "FlatLayout":
        """``shapes`` in the model's parameter order; the decayed leaves keep
        their order and go first, then the others; within each, the leaves
        ``split`` marks go first."""
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        split = split or {}
        order = [n for d in (True, False) for sp in (True, False) for n in shapes
                 if decay[n] == d and bool(split.get(n)) == sp]
        offsets, off, runs = [], 0, []
        for n in order:
            offsets.append(off)
            size = math.prod(shapes[n])
            if split.get(n):
                if runs and runs[-1][1] == off:
                    runs[-1] = (runs[-1][0], off + size)
                else:
                    runs.append((off, off + size))
            off += size
        decay_end = sum(math.prod(shapes[n]) for n in order if decay[n])
        return cls(tuple(order), tuple(tuple(shapes[n]) for n in order), tuple(offsets), off, decay_end, world,
                   tuple(bool(split.get(n)) for n in order), tuple(runs))

    def parts(self, lo: int, hi: int) -> List[Tuple[int, int, bool]]:
        """The range ``[lo, hi)`` cut into runs ``(start, stop, split)``
        relative to ``lo``: the split leaves' elements and the others (the
        padding with them)."""
        out, at = [], lo
        for a, b in self.split_runs:
            a, b = max(a, lo), min(b, hi)
            if a >= b:
                continue
            if at < a:
                out.append((at - lo, a - lo, False))
            out.append((a - lo, b - lo, True))
            at = b
        if at < hi:
            out.append((at - lo, hi - lo, False))
        return out

    @property
    def padded(self) -> int:
        return -(-self.numel // self.world) * self.world

    @property
    def shard_numel(self) -> int:
        return self.padded // self.world

    def shard_range(self, rank: int) -> Tuple[int, int]:
        return rank * self.shard_numel, (rank + 1) * self.shard_numel

    def shard_decay_end(self, rank: int) -> int:
        """Elements ``[0, this)`` of rank ``rank``'s shard decay."""
        lo, hi = self.shard_range(rank)
        return min(max(self.decay_end - lo, 0), hi - lo)

    def segments(self, lo: int, hi: int) -> List[Segment]:
        """Every leaf that the range ``[lo, hi)`` of the flat buffer touches,
        in flat order, with the element range of the leaf it holds (the
        padding belongs to no leaf)."""
        out = []
        for n, s, o, sp in zip(self.names, self.shapes, self.offsets, self.split):
            a, b = max(o, lo), min(o + math.prod(s), hi)
            if a < b:
                out.append(Segment(n, s, a - o, b - o, a - lo, o < self.decay_end, sp))
        return out

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each leaf as a view of the full flat buffer ``flat``."""
        return {n: flat[o:o + math.prod(s)].view(s) for n, s, o in zip(self.names, self.shapes, self.offsets)}

    def flatten(self, leaves: Dict[str, torch.Tensor], dtype=None, device=None) -> torch.Tensor:
        """A new flat buffer (padded with zeros) holding ``leaves`` by name;
        a leaf not in ``leaves`` stays zero."""
        first = next(iter(leaves.values()))
        flat = torch.zeros(self.padded, dtype=dtype or first.dtype, device=device or first.device)
        self.fill(flat, leaves)
        return flat

    def fill(self, flat: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> None:
        for n, view in self.views(flat).items():
            if n in leaves:
                view.copy_(leaves[n])

    def shard_of(self, leaves: Dict[str, torch.Tensor], rank: int, dtype=None, device=None) -> torch.Tensor:
        """Rank ``rank``'s slice of the flat buffer of ``leaves``, built from
        the leaves that overlap it (no full buffer is made); a leaf not in
        ``leaves`` stays zero."""
        lo, hi = self.shard_range(rank)
        first = next(iter(leaves.values()))
        out = torch.zeros(hi - lo, dtype=dtype or first.dtype, device=device or first.device)
        for n, s, o in zip(self.names, self.shapes, self.offsets):
            a, b = max(o, lo), min(o + math.prod(s), hi)
            if a < b and n in leaves:
                out[a - lo:b - lo].copy_(leaves[n].reshape(-1)[a - o:b - o])
        return out


def topology_summary(data: int, sequence: int, zero_stage: int, tensor: int = 1) -> dict:
    """The topology a checkpoint was saved under, in JAX's format (one
    process and one device per rank; the axes the port has not ported are
    1), written into every step's ``meta.json``."""
    world = data * tensor * sequence
    return {
        "mesh": {"pipe": 1, "data": int(data), "fsdp": 1, "expert": 1, "tensor": int(tensor),
                 "sequence": int(sequence)},
        "devices": int(world),
        "processes": int(world),
        "zero_stage": int(zero_stage),
        "pp_schedule": "gpipe",
    }


def check_elastic_compat(saved: Optional[dict], data: int, sequence: int, zero_stage: int,
                         global_batch: int, tensor: int = 1) -> List[str]:
    """Validate resuming onto a ``data x tensor x sequence`` mesh from a
    checkpoint saved under ``saved`` (a ``topology_summary``; None for a
    checkpoint without one). Raises ``ValueError`` with JAX's message, word
    for word, for a global batch the new data world cannot divide, before
    any step; returns notes describing what changed for a compatible
    topology (a new tensor size is a re-slice of the whole leaves too)."""
    new = topology_summary(data, sequence, zero_stage, tensor)
    if global_batch % data:
        raise ValueError(
            f"elastic resume: global batch_size {global_batch} is not "
            f"divisible by the new data-parallel world of {data} "
            f"(mesh {new['mesh']}). Resuming onto this topology would "
            f"fail inside pjit at the first step — pick a mesh whose "
            f"data*fsdp divides the batch, or adjust training.batch_size"
        )
    notes: List[str] = []
    if not saved:
        return notes
    if saved.get("devices") != new["devices"]:
        notes.append(
            f"device count {saved.get('devices')} -> {new['devices']} "
            f"(ZeRO shard layout rebuilt for the new mesh; the restore "
            f"re-slices the saved whole leaves)"
        )
    if saved.get("mesh") != new["mesh"]:
        notes.append(f"mesh axes {saved.get('mesh')} -> {new['mesh']}")
    if saved.get("zero_stage") != new["zero_stage"]:
        notes.append(
            f"zero_stage {saved.get('zero_stage')} -> {new['zero_stage']} "
            f"(same state tree, different layout — restore reshards)"
        )
    if saved.get("processes") != new["processes"]:
        notes.append(f"process count {saved.get('processes')} -> {new['processes']}")
    return notes
