"""Process groups for data, tensor and sequence parallelism.

Counterpart of ``zero_transformer_tpu/parallel/mesh.py``'s ``data``,
``tensor`` and ``sequence`` axes (``make_mesh`` :35-119, JAX's axis order
:55: ``data`` outer, ``tensor``, then ``sequence`` fastest) and of
``parallel/bootstrap.py::maybe_initialize`` (:29): JAX's mesh becomes
``torch.distributed`` groups of one process per rank, started by
``torch.distributed.run`` (or by a caller that passes rank, world size and
an ``init_method`` itself, as the tests do with ``file://``). World rank
``r = (d * tensor + t) * sequence + s``: a sequence group is ``sequence``
consecutive ranks (they share rows and heads), a tensor group the ranks of
one ``(d, s)`` (they share rows and split every layer), a data group the
ranks of one ``(t, s)`` (they hold the same shard of every layer and train
on different rows).

The backend is always explicit and printed, never switched silently:

- ``nccl`` when every rank has a card of its own (``cuda:LOCAL_RANK``);
- ``gloo`` for CPU tensors;
- ``gloo`` when several ranks share a card (NCCL refuses two ranks on one
  GPU). gloo's collectives take CPU tensors only here, so under gloo every
  group stages CUDA tensors through pinned host buffers: that is the gloo
  backend's transport. The kernels still run on the card.

``SequenceGroup.rotate_start`` is the ring's ``lax.ppermute`` to ``(r + 1) %
n`` (``ops/ring_attention.py::_rotate``); ``SequenceGroup.all_to_all_`` is
Ulysses' ``lax.all_to_all`` (``ops/ulysses.py``). ``DataGroup`` holds the ZeRO
collectives of ``parallel/zero.py``: ``reduce_scatter_`` (JAX
``psum_scatter``), ``all_gather_`` (``all_gather``) and ``all_reduce_``
(``psum``). Every collective runs inside a ``torch.profiler`` span named
after its group and operation (``sequence_group.rotate``,
``data_group.reduce_scatter``, ``tensor_group.all_reduce``, ...: host time,
the staging copies included), so a profile of a step can say what share of
it the transfers take. A group of one rank runs no collective at all.

``TensorGroup`` is the ``tensor`` axis (``models/gpt.py``'s Megatron
layers; in serving also ``serving/engine.py``'s SPMD plans):
``all_reduce_`` (JAX ``psum``; ``all_reduce_max`` for the vocab-parallel
loss's row max), ``all_gather_`` along a dim (the vocab-split logits, and
a checkpoint's whole tensors) and ``broadcast_`` / ``broadcast_object``
from rank 0 (the engine's plans), each inside a ``tensor_group.*`` span.
``init_tensor_group`` joins or starts the world of a pure tensor-parallel
serving mesh (JAX ``serve_mesh``); a training mesh's tensor group comes
from ``make_mesh`` and waits the world's collective timeout, with no
heartbeat.
"""
from __future__ import annotations

import dataclasses
import json
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from zero_transformer_tpu_torch.config import resolve_device

BACKENDS = ("nccl", "gloo")
BUCKET_BYTES = 256 << 20  # grads all-reduced per flat bucket
TENSOR_TIMEOUT_S = 1800.0  # a tensor rank's longest wait inside one collective (gloo's own default)
JOIN_TIMEOUT_S = 1800.0  # every rank of a tensor world joins its rendezvous within it


def _torchrun_hint(data: int, sequence: int, tensor: int = 1) -> str:
    sets = " ".join(f"mesh.{k}={v}" for k, v in (("data", data), ("tensor", tensor), ("sequence", sequence))
                    if v > 1)
    return (f"python -m torch.distributed.run --nproc-per-node {max(data, 1) * tensor * sequence} -m "
            f"zero_transformer_tpu_torch.train --cfg <config> --set {sets}")


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
class _Group:
    """One axis of the mesh: this process's ``rank`` of ``size``, the
    ``torch.distributed`` group (None: the default group, or no collective
    at all for a group of one), its backend and the device this rank
    computes on."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    _host: Dict[Tuple, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)
    SPAN = "group"

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

    def _flat_buffer(self, key: Tuple, numel: int, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host buffer of at least ``numel`` elements, its first
        ``numel`` returned."""
        buf = self._host.get(key)
        if buf is None or buf.dtype != dtype or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf[:numel]

    def all_reduce_(self, tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES,
                    op=dist.ReduceOp.SUM) -> None:
        """Sum (or ``op``) each tensor over the group, in place, through flat
        buckets of one dtype of at most ``bucket_bytes`` (a larger tensor
        goes alone). Every rank ends with the same bits: the collective
        reduces each element once and hands the result to all."""
        if self.size == 1:
            return
        with record_function(f"{self.SPAN}.all_reduce"):
            self._all_reduce(tensors, bucket_bytes, op)

    def _all_reduce(self, tensors: Sequence[torch.Tensor], bucket_bytes: int, op) -> None:
        buckets: List[List[torch.Tensor]] = []
        size = 0
        for t in tensors:
            if not buckets or buckets[-1][0].dtype != t.dtype or size + t.numel() * t.element_size() > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel() * t.element_size()
        for bucket in buckets:
            flat = bucket[0].view(-1) if len(bucket) == 1 and bucket[0].is_contiguous() else \
                torch.cat([t.reshape(-1) for t in bucket])
            if self.staged:
                host = self._flat_buffer(("all_reduce", flat.dtype), flat.numel(), flat.dtype)
                host.copy_(flat)
                dist.all_reduce(host, op=op, group=self.group)
                flat.copy_(host)
            else:
                dist.all_reduce(flat, op=op, group=self.group)
            offset = 0
            for t in bucket:
                if t.data_ptr() != flat.data_ptr() or t.numel() != flat.numel():
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def all_reduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``value`` summed over the group (no autograd)."""
        out = value.detach().clone()
        self.all_reduce_([out])
        return out

    def all_reduce_max(self, value: torch.Tensor) -> torch.Tensor:
        """A new tensor: the elementwise max of ``value`` over the group (no
        autograd)."""
        out = value.detach().clone()
        self.all_reduce_([out], op=dist.ReduceOp.MAX)
        return out

    def barrier(self) -> None:
        if self.size == 1:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def describe(self) -> dict:
        cards = min(self.size, torch.cuda.device_count()) if self.device.type == "cuda" else 0
        return {"ranks": self.size, "rank": self.rank, "backend": self.backend, "device": str(self.device),
                "cards": cards, "staged_through_host": self.staged}


@dataclasses.dataclass
class SequenceGroup(_Group):
    """The ranks that split every row between them (``mesh.sequence``)."""

    SPAN = "sequence_group"

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
        if self.group is not None:  # group ranks -> world ranks
            nxt, prv = (dist.get_global_rank(self.group, r) for r in (nxt, prv))
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


    def all_to_all_(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """JAX ``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``:
        ``x`` split into ``size`` chunks along ``split_dim``, chunk ``j`` sent
        to rank ``j``, the chunks received concatenated in rank order along
        ``concat_dim``. A new tensor (no autograd: ``ops/ulysses.py`` wraps it)."""
        n = self.size
        if n == 1:
            return x.clone()
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all splits dim {split_dim} of {tuple(x.shape)} over {n} ranks")
        with record_function("sequence_group.all_to_all"):
            # [n, chunk...]: chunk j leaves for rank j
            send = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
            if self.staged:
                src = self._flat_buffer(("a2a_in", send.dtype), send.numel(), send.dtype)
                dst = self._flat_buffer(("a2a_out", send.dtype), send.numel(), send.dtype)
                src.copy_(send.reshape(-1))
                dist.all_to_all_single(dst, src, group=self.group)
                recv = dst.view(send.shape).to(self.device)
            else:
                recv = torch.empty_like(send)
                dist.all_to_all_single(recv, send, group=self.group)
            return torch.cat(recv.unbind(0), dim=concat_dim)

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated in rank order along ``dim`` (JAX
        ``all_gather(..., tiled=True)``; no autograd)."""
        if self.size == 1:
            return x
        with record_function("sequence_group.all_gather"):
            return _gather_dim(self, x, dim)


# the flat all-gather (its newer name where torch has it)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_dim(group: "_Group", x: torch.Tensor, dim: int) -> torch.Tensor:
    """``group``'s every ``x`` concatenated in rank order along ``dim``."""
    x = x.contiguous()
    n = group.size
    if group.staged:
        src = group._flat_buffer(("ag_dim_in", x.dtype), x.numel(), x.dtype)
        dst = group._flat_buffer(("ag_dim_out", x.dtype), n * x.numel(), x.dtype)
        src.copy_(x.reshape(-1))
        _all_gather_flat(dst, src, group=group.group)
        full = dst.view(n, *x.shape).to(group.device)
    else:
        full = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_flat(full, x.reshape(-1), group=group.group)
        full = full.view(n, *x.shape)
    return torch.cat(full.unbind(0), dim=dim)


@dataclasses.dataclass
class TensorGroup(_Group):
    """The ranks that split every layer's heads and features between them
    (``mesh.tensor``): each holds ``1/size`` of the attention heads, the MLP
    features and the vocabulary; the activations are whole on every rank."""

    SPAN = "tensor_group"
    timeout_s: float = TENSOR_TIMEOUT_S

    @property
    def heartbeat_s(self) -> float:
        """The longest rank 0 leaves the other ranks waiting for its next
        plan or job: a quarter of the collective timeout. An idle server or
        REPL sends a no-op at this interval, so an idle world never times
        out."""
        return self.timeout_s / 4

    def all_gather_(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A new tensor: every rank's ``x`` concatenated in rank order along
        ``dim`` (no autograd; ``models/gpt.py`` wraps it)."""
        if self.size == 1:
            return x
        with record_function("tensor_group.all_gather"):
            return _gather_dim(self, x, dim)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Each tensor overwritten, in place, by rank ``src``'s (every rank
        passes tensors of the same shapes and dtypes, in the same order)."""
        if self.size == 1:
            return
        with record_function("tensor_group.broadcast"):
            root = src if self.group is None else dist.get_global_rank(self.group, src)
            for t in tensors:
                if self.staged:
                    host = self._flat_buffer(("bcast", t.dtype), t.numel(), t.dtype)
                    if self.rank == src:
                        host.copy_(t.reshape(-1))
                    dist.broadcast(host, src=root, group=self.group)
                    if self.rank != src:
                        t.copy_(host.view_as(t))
                else:
                    flat = t if t.is_contiguous() else t.contiguous()
                    dist.broadcast(flat, src=root, group=self.group)
                    if flat is not t:
                        t.copy_(flat)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.size == 1:
            return obj
        with record_function("tensor_group.broadcast"):
            box = [obj if self.rank == src else None]
            root = src if self.group is None else dist.get_global_rank(self.group, src)
            dist.broadcast_object_list(box, src=root, group=self.group,
                                       device=self.device if self.backend == "nccl" else None)
            return box[0]


@dataclasses.dataclass
class DataGroup(_Group):
    """The ranks that train on different rows (``mesh.data``): the ZeRO
    collectives over one flat buffer (``parallel/zero.py``)."""

    SPAN = "data_group"

    def reduce_scatter_(self, out: torch.Tensor, flat: torch.Tensor) -> None:
        """``out`` <- this rank's ``1/size`` slice of ``flat`` summed over the
        group (``flat.numel() == size * out.numel()``)."""
        if self.size == 1:
            out.copy_(flat)
            return
        with record_function("data_group.reduce_scatter"):
            if self.staged:
                src = self._flat_buffer(("rs_in", flat.dtype), flat.numel(), flat.dtype)
                dst = self._flat_buffer(("rs_out", out.dtype), out.numel(), out.dtype)
                src.copy_(flat.reshape(-1))
                dist.reduce_scatter_tensor(dst, src, group=self.group)
                out.copy_(dst.view_as(out))
            else:
                dist.reduce_scatter_tensor(out, flat, group=self.group)

    def all_gather_(self, full: torch.Tensor, shard: torch.Tensor) -> None:
        """``full`` <- every rank's ``shard`` in rank order (``full.numel()
        == size * shard.numel()``; ``shard`` must not alias ``full``)."""
        if self.size == 1:
            full.copy_(shard.reshape(full.shape))
            return
        with record_function("data_group.all_gather"):
            if self.staged:
                src = self._flat_buffer(("ag_in", shard.dtype), shard.numel(), shard.dtype)
                dst = self._flat_buffer(("ag_out", full.dtype), full.numel(), full.dtype)
                src.copy_(shard.reshape(-1))
                dist.all_gather_into_tensor(dst, src, group=self.group)
                full.copy_(dst.view_as(full))
            else:
                dist.all_gather_into_tensor(full, shard, group=self.group)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


@dataclasses.dataclass
class Mesh:
    """This process's place in the ``data x tensor x sequence`` mesh: its
    world rank, the world's size, and its data, sequence and tensor groups
    (a tensor group of one rank when ``tensor`` is not given)."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    data: DataGroup
    sequence: SequenceGroup
    tensor: Optional[TensorGroup] = None

    def __post_init__(self):
        if self.tensor is None:
            self.tensor = TensorGroup(rank=0, size=1, backend="none", device=self.device)

    def barrier(self) -> None:
        if self.world_size == 1:
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.world_size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def describe(self) -> dict:
        cards = min(self.world_size, torch.cuda.device_count()) if self.device.type == "cuda" else 0
        return {"ranks": self.world_size, "rank": self.rank, "data": self.data.size, "tensor": self.tensor.size,
                "sequence": self.sequence.size, "backend": self.backend, "device": str(self.device),
                "cards": cards, "staged_through_host": self.backend == "gloo" and self.device.type == "cuda"}


def single_process(device) -> Mesh:
    """The mesh of one process: groups of one rank, no process group."""
    dev = resolve_device(device)
    return Mesh(rank=0, world_size=1, backend="none", device=dev,
                data=DataGroup(rank=0, size=1, backend="none", device=dev),
                sequence=SequenceGroup(rank=0, size=1, backend="none", device=dev),
                tensor=TensorGroup(rank=0, size=1, backend="none", device=dev))


def mesh_data_size(world_size: int, data: int, tensor: int, sequence: int) -> int:
    """The data axis of a ``data x tensor x sequence`` world (``data`` -1:
    what the others leave), with JAX ``make_mesh``'s checks (:42-53): the
    message names the product that fails."""
    if tensor < 1 or sequence < 1:
        raise ValueError(f"mesh.tensor and mesh.sequence must be >= 1, got {tensor} and {sequence}")
    fixed = tensor * sequence
    want = (f"world size {world_size} must equal mesh.sequence {sequence} x mesh.tensor {tensor} x mesh.data "
            f"{'(all ranks)' if data == -1 else data}")
    if world_size % fixed:
        raise ValueError(f"{want}: {world_size} ranks not divisible by tensor*sequence={fixed}; "
                         f"{_torchrun_hint(max(data, 1), sequence, tensor)}")
    n_data = world_size // fixed if data == -1 else data
    if n_data < 1 or n_data * fixed != world_size:
        raise ValueError(f"{want}: mesh {n_data}x{tensor}x{sequence} (data x tensor x sequence) != "
                         f"{world_size} ranks; {_torchrun_hint(max(n_data, 1), sequence, tensor)}")
    return n_data


def init_distributed(sequence: int, backend: Optional[str] = None, device="cuda", *, data: int = -1,
                     tensor: int = 1, rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: Optional[str] = None, local_rank: Optional[int] = None) -> Mesh:
    """Join (or start) the process group of a ``data x tensor x sequence``
    mesh and make its data, tensor and sequence groups.

    Rank, world size and local rank come from the arguments or from
    ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    without either it raises with the launch command. ``data`` -1 takes
    world / (``tensor`` x ``sequence``); the world must equal ``data x
    tensor x sequence``. ``backend`` None takes nccl when every rank of the
    host has a card of its own, else gloo (ranks share card ``LOCAL_RANK %
    cards``); asking for nccl without a card per rank raises."""
    env = os.environ
    if rank is None or world_size is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(f"mesh.data={data} x mesh.tensor={tensor} x mesh.sequence={sequence} needs one "
                               f"process per rank, started by torch.distributed.run: "
                               f"{_torchrun_hint(data, sequence, tensor)}")
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    n_data = mesh_data_size(world_size, data, tensor, sequence)
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
    mesh = make_mesh(n_data, tensor, sequence, backend, dev)
    if rank == 0:
        print(json.dumps({"distributed": mesh.describe()}), flush=True)
    return mesh


def make_mesh(data: int, tensor: int, sequence: int, backend: str, device: torch.device) -> Mesh:
    """This process's ``data x tensor x sequence`` mesh over the initialised
    default group (the product must be its world), in JAX's axis order:
    world rank ``(d * tensor + t) * sequence + s``. Every rank makes every
    subgroup, in the same order; a group that spans the world is the
    default group (None)."""
    rank, world_size = dist.get_rank(), dist.get_world_size()
    mesh_data_size(world_size, data, tensor, sequence)
    s, t, d = rank % sequence, (rank // sequence) % tensor, rank // (sequence * tensor)

    def at(dd: int, tt: int, ss: int) -> int:
        return (dd * tensor + tt) * sequence + ss

    def groups(size: int, members: List[List[int]]) -> Optional[dist.ProcessGroup]:
        """Every group of an axis made in order; this rank's returned."""
        if not 1 < size < world_size:
            return None
        made = [dist.new_group(ranks) for ranks in members]
        return next(pg for pg, ranks in zip(made, members) if rank in ranks)

    seq_pg = groups(sequence, [[at(dd, tt, j) for j in range(sequence)] for dd in range(data) for tt in range(tensor)])
    tp_pg = groups(tensor, [[at(dd, j, ss) for j in range(tensor)] for dd in range(data) for ss in range(sequence)])
    data_pg = groups(data, [[at(j, tt, ss) for j in range(data)] for tt in range(tensor) for ss in range(sequence)])
    return Mesh(rank=rank, world_size=world_size, backend=backend, device=device,
                data=DataGroup(rank=d, size=data, backend=backend, device=device, group=data_pg),
                sequence=SequenceGroup(rank=s, size=sequence, backend=backend, device=device, group=seq_pg),
                tensor=TensorGroup(rank=t, size=tensor, backend=backend, device=device, group=tp_pg))


def tensor_group_of_world(backend: str, device: torch.device,
                          timeout_s: float = TENSOR_TIMEOUT_S) -> TensorGroup:
    """A ``TensorGroup`` over the whole initialised world (a pure
    tensor-parallel mesh: rank r holds the r-th slice of every layer);
    ``timeout_s`` is the world's collective timeout, at most."""
    return TensorGroup(rank=dist.get_rank(), size=dist.get_world_size(), backend=backend, device=device,
                       timeout_s=timeout_s)


def init_tensor_group(tensor: int, rank: int, init_method: str, device="cuda",
                      backend: Optional[str] = None, timeout_s: float = TENSOR_TIMEOUT_S) -> TensorGroup:
    """Join (or start) the world of ``tensor`` ranks of a pure
    tensor-parallel serving mesh (JAX ``serve_mesh``). ``backend`` None
    takes nccl with a card per rank when ``tensor`` cards are visible, else
    gloo with the ranks sharing card 0 (its collectives staged through
    pinned host buffers); the CPU takes gloo. Rank 0 prints the backend and
    the topology it chose: there is no silent switch. Every rank joins the
    rendezvous first (within ``JOIN_TIMEOUT_S``: ranks start at their own
    pace); the group then waits ``timeout_s`` at most inside a collective,
    and rank 0 keeps an idle world alive at ``heartbeat_s``."""
    if tensor < 1:
        raise ValueError(f"tensor must be >= 1, got {tensor}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend is None:
            backend = "nccl" if cards >= tensor else "gloo"
        if backend == "nccl" and cards < tensor:
            raise ValueError(f"nccl needs a card per rank: {tensor} ranks, {cards} cards")
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA tensors; the CPU takes gloo")
        backend = "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if tensor == 1:
        return TensorGroup(rank=0, size=1, backend="none", device=dev)
    if not dist.is_initialized():
        store, _, _ = next(dist.rendezvous(init_method, rank, tensor, timeout=timedelta(seconds=JOIN_TIMEOUT_S)))
        store.set(f"tensor_joined/{rank}", "1")
        store.wait([f"tensor_joined/{r}" for r in range(tensor)])
        kwargs = dict(backend=backend, rank=rank, world_size=tensor, store=store,
                      timeout=timedelta(seconds=timeout_s))
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
    group = tensor_group_of_world(backend, dev, timeout_s)
    if rank == 0:
        print(json.dumps({"tensor_parallel": group.describe()}), flush=True)
    return group


def destroy(mesh: Optional[Mesh]) -> None:
    """Leave the process group (no-op without one)."""
    if mesh is not None and mesh.world_size > 1 and dist.is_initialized():
        dist.destroy_process_group()
