"""Process groups for sequence parallelism.

Counterpart of ``zero_transformer_tpu/parallel/mesh.py``'s ``sequence`` axis
and of ``parallel/bootstrap.py::maybe_initialize`` (:29): JAX's mesh axis
becomes a ``torch.distributed`` group of one process per rank, started by
``torch.distributed.run`` (or by a caller that passes rank, world size and an
``init_method`` itself, as the tests do with ``file://``).

The backend is always explicit and printed, never switched silently:

- ``nccl`` when every rank has a card of its own (``cuda:LOCAL_RANK``);
- ``gloo`` for CPU tensors;
- ``gloo`` when several ranks share a card (NCCL refuses two ranks on one
  GPU). gloo's send and receive take CPU tensors only, so under gloo
  ``SequenceGroup`` stages CUDA tensors through pinned host buffers: that
  is the gloo backend's transport. The kernels still run on the card.

``SequenceGroup.rotate_start`` is the ring's ``lax.ppermute`` to ``(r + 1) %
n`` (``ops/ring_attention.py::_rotate``); ``all_reduce_`` sums tensors over
the ranks in flat buckets (the grads of a sequence-parallel train step).
Both run inside ``torch.profiler`` spans (``sequence_group.rotate``,
``sequence_group.all_reduce``: host time, the staging copies included), so a
profile of a step can say what share of it the transfers take.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from zero_transformer_tpu_torch.config import resolve_device

BACKENDS = ("nccl", "gloo")
BUCKET_BYTES = 256 << 20  # grads all-reduced per flat bucket


def _torchrun_hint(sequence: int) -> str:
    return (f"python -m torch.distributed.run --nproc-per-node {sequence} -m zero_transformer_tpu_torch.train "
            f"--cfg <config> --set mesh.sequence={sequence}")


class _Pending:
    """A rotation in flight: ``wait()`` returns the received tensors. It
    holds the tensors being sent until then."""

    def __init__(self, works, finish, sends):
        self._works, self._finish, self._sends = works, finish, sends

    def wait(self) -> List[torch.Tensor]:
        with record_function("sequence_group.rotate"):
            for work in self._works:
                work.wait()
            return self._finish()


@dataclasses.dataclass
class SequenceGroup:
    """One sequence-parallel group: this process's ``rank`` of ``size``, the
    ``torch.distributed`` group, its backend and the device this rank
    computes on."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    _host: Dict[Tuple, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors cross through host buffers (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _buffer(self, key: Tuple, like: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def rotate_start(self, tensors: Sequence[torch.Tensor], channel: str) -> _Pending:
        """Send each tensor to rank ``(r + 1) % n`` and receive its
        counterpart from ``(r - 1) % n``; every rank must call this with the
        same list in the same order. The tensors sent stay untouched, so the
        caller may compute on them while the rotation runs. ``channel``
        names the host buffers of a rotation that may be in flight beside
        another one."""
        with record_function("sequence_group.rotate"):
            return self._rotate_start(tensors, channel)

    def _rotate_start(self, tensors: Sequence[torch.Tensor], channel: str) -> _Pending:
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        if self.staged:
            sends = []
            for i, t in enumerate(tensors):
                buf = self._buffer((channel, "send", i), t)
                buf.copy_(t)  # waits for the kernels that wrote t
                sends.append(buf)
            recvs = [self._buffer((channel, "recv", i), t) for i, t in enumerate(tensors)]
        else:
            sends = [t.contiguous() for t in tensors]
            recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recvs]
        works = dist.batch_isend_irecv(ops)

        def finish() -> List[torch.Tensor]:
            if not self.staged:
                return recvs
            # a blocking copy: the host buffer is reused by the next rotation
            return [r.to(self.device) for r in recvs]

        return _Pending(works, finish, sends)

    def all_reduce_(self, tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> None:
        """Sum each tensor over the group, in place, through flat buckets of
        one dtype of at most ``bucket_bytes`` (a larger tensor goes alone).
        Every rank ends with the same bits: the collective sums each element
        once and hands the result to all."""
        with record_function("sequence_group.all_reduce"):
            self._all_reduce(tensors, bucket_bytes)

    def _all_reduce(self, tensors: Sequence[torch.Tensor], bucket_bytes: int) -> None:
        buckets: List[List[torch.Tensor]] = []
        size = 0
        for t in tensors:
            if not buckets or buckets[-1][0].dtype != t.dtype or size + t.numel() * t.element_size() > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel() * t.element_size()
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            if self.staged:
                key = ("all_reduce", flat.dtype)
                if key not in self._host or self._host[key].numel() < flat.numel():
                    self._host[key] = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
                host = self._host[key][:flat.numel()]
                host.copy_(flat)
                dist.all_reduce(host, group=self.group)
                flat.copy_(host)
            else:
                dist.all_reduce(flat, group=self.group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def all_reduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``value`` summed over the group (no autograd)."""
        out = value.detach().clone()
        self.all_reduce_([out])
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def describe(self) -> dict:
        cards = min(self.size, torch.cuda.device_count()) if self.device.type == "cuda" else 0
        return {"ranks": self.size, "rank": self.rank, "backend": self.backend, "device": str(self.device),
                "cards": cards, "staged_through_host": self.staged}


def init_distributed(sequence: int, backend: Optional[str] = None, device="cuda", *,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: Optional[str] = None, local_rank: Optional[int] = None) -> SequenceGroup:
    """Join (or start) the process group of a ``mesh.sequence``-way ring.

    Rank, world size and local rank come from the arguments or from
    ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    without either it raises with the launch command. The world is the
    sequence group (data parallelism across processes is not ported).
    ``backend`` None takes nccl when every rank of the host has a card of
    its own, else gloo (ranks share card ``LOCAL_RANK % cards``); asking for
    nccl without a card per rank raises."""
    env = os.environ
    if rank is None or world_size is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(f"mesh.sequence={sequence} needs one process per rank, started by "
                               f"torch.distributed.run: {_torchrun_hint(sequence)}")
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if world_size != sequence:
        raise ValueError(f"world size {world_size} must equal mesh.sequence {sequence}: data parallelism "
                         "across processes is not ported yet")
    dev = torch.device(device)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dev.type == "cuda":
        resolve_device("cuda")  # raises without a card
        cards = torch.cuda.device_count()
        if backend is None:
            backend = "nccl" if cards >= local_world else "gloo"
        if backend == "nccl" and cards < local_world:
            raise ValueError(f"nccl needs a card per rank: {local_world} ranks on this host, {cards} cards; "
                             "use --dist-backend gloo to share cards")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA tensors; the CPU takes gloo")
        backend = "gloo"
    if not dist.is_initialized():
        kwargs = dict(backend=backend, rank=rank, world_size=world_size, init_method=init_method or "env://")
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
    group = SequenceGroup(rank=rank, size=world_size, backend=backend, device=dev, group=None)
    if rank == 0:
        print(json.dumps({"distributed": group.describe()}), flush=True)
    return group


def destroy(group: Optional[SequenceGroup]) -> None:
    """Leave the process group (no-op without one)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
