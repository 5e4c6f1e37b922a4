"""Host-side KV bookkeeping for the serving engine's two layouts.

Counterpart of ``zero_transformer_tpu/serving/slots.py``: ``SlotKVCache``
(:153), the slab layout's slots and prefix-span copies (below), and
``PagePool`` (:494) and ``PagedKVCache`` (:563) of the paged layout: refcounted pages with the trash page 0, admission
reservations, the per-slot block tables kept on the host, slot
acquire/release, and prefix sharing (``share`` maps a prefix hit's pages
by refcount, ``bank`` takes the prefix index's reference, ``cow`` gives a
slot a private copy of a shared page before it writes there), and the
transferable page spans of stream migration (``export_page_span`` /
``import_page_span``, JAX :724-826; the wire format is ``wire.py``). The
device state (the pools themselves) lives with the engine
(``inference.generate.allocate_pools``): ``cow`` copies a page through the
engine's callback, and the span methods take the pools as an argument.

A span's leaves carry JAX's cache keys (``jax.tree_util.keystr`` of the
decode model's cache): with ``scan_layers`` (every zoo model) one key per
pool kind over all layers, ``['blocks']['attn']['cached_key']`` as
``[n_blocks, L, page, KVH, D]``, and ``key_scale``/``value_scale``
``[n_blocks, L, page, KVH, 1]`` with an int8 cache; without, one key per
layer (``['block_3']['attn']['cached_key']``, ``[n_blocks, page, KVH,
D]``). So a span exported by either package imports into the other. JAX
pads the page list to a power of two to bound its compile family; the port
gathers exactly ``n_blocks`` pages. JAX's ``set_cursor`` has no
counterpart: the port's cursor is a host value (prompt + emitted, or a
prefill job's fill) and the decode tick uploads the block table every tick.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from zero_transformer_tpu_torch.serving.wire import as_host_tensor

# the pool kinds of a span by JAX's cache leaf names
_POOL_FIELDS = (("k", "cached_key"), ("v", "cached_value"), ("k_scale", "key_scale"), ("v_scale", "value_scale"))
_ALIGN = 16  # byte alignment of each leaf in a transfer buffer


def span_keys(pools, scanned: bool = True) -> Dict[str, List[torch.Tensor]]:
    """Wire key -> the per-layer pools it holds (every layer under one key
    when ``scanned``, one layer per key otherwise)."""
    out: Dict[str, List[torch.Tensor]] = {}
    for field, name in _POOL_FIELDS:
        if getattr(pools[0], field) is None:
            continue
        layers = [getattr(p, field) for p in pools]
        if scanned:
            out[f"['blocks']['attn']['{name}']"] = layers
        else:
            for i, t in enumerate(layers):
                out[f"['block_{i}']['attn']['{name}']"] = [t]
    return out


def _span_shape(layers: List[torch.Tensor], scanned: bool) -> tuple:
    """A leaf's per-page shape: ``(L, page, KVH, D)`` scanned, else ``(page,
    KVH, D)``."""
    per_page = tuple(layers[0].shape[1:])
    return (len(layers),) + per_page if scanned else per_page


def _layout(tensors: Dict[str, torch.Tensor]):
    """(key, offset, nbytes) of each tensor in one aligned byte buffer, and
    the buffer's size."""
    spans, off = [], 0
    for key, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        spans.append((key, off, nbytes))
        off += -(-nbytes // _ALIGN) * _ALIGN
    return spans, off


def _views(buf: torch.Tensor, spans, like: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Typed views into ``buf`` (uint8) at ``spans``; ``like``: key ->
    (dtype, shape)."""
    return {key: buf[off:off + n].view(like[key][0]).view(like[key][1]) for key, off, n in spans}


def _device_to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device tensors as host tensors through ONE copy: packed into one
    device byte buffer, copied into pinned memory (the copy waits: the
    designed sync of a migration send), returned as views of it."""
    spans, total = _layout(tensors)
    like = {k: (t.dtype, t.shape) for k, t in tensors.items()}
    first = next(iter(tensors.values()), None)
    if first is None:
        return {}
    flat = torch.empty(total, dtype=torch.uint8, device=first.device)
    for key, off, n in spans:
        flat[off:off + n].view(like[key][0]).view(like[key][1]).copy_(tensors[key])
    if flat.device.type != "cuda":
        return _views(flat, spans, like)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    return _views(host, spans, like)


def _host_to_device(tensors: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Host tensors on ``device`` through ONE copy: packed into one host
    byte buffer (pinned for a card) and copied without waiting. The pinned
    buffer outlives its copy: the caching host allocator records the copy's
    stream and hands the block out again only after it has finished."""
    device = torch.device(device)
    spans, total = _layout(tensors)
    like = {k: (t.dtype, t.shape) for k, t in tensors.items()}
    host = torch.empty(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    for key, off, n in spans:
        host[off:off + n].copy_(tensors[key].reshape(-1).view(torch.uint8))
    if device.type == "cpu":
        return _views(host, spans, like)
    return _views(host.to(device, non_blocking=True), spans, like)


class SlotKVCache:
    """The slab layout (JAX ``SlotKVCache``): every slot owns a fixed row of
    ``seq_capacity`` positions. The rows are the engine's page pools seen
    through a fixed identity table (as ``inference.generate.SlabCache``
    sees its slab): slot ``s`` owns pages ``1 + s * n_blocks`` to ``(s + 1) *
    n_blocks``, and page 0 is the trash page that a parked row's zeroed
    table row writes to, so K1 and K4 run over it unchanged. The cursor is a
    host value (prompt + emitted, or a prefill job's fill) as in the paged
    engine: JAX's ``_reset_index`` on release and the index ``insert`` sets
    have no device counterpart, and a one-shot prefill writes straight into
    the slot's rows, so there is no ``insert`` either.

    Prefix-cache entries are copies of K/V spans (JAX :195-236):
    ``extract_spans`` gathers exactly ``count`` spans (JAX pads the count to
    a power of two to bound its compile family; eager PyTorch has none) and
    ``write_spans`` copies a hit's spans into a slot."""

    def __init__(self, n_slots: int, seq_capacity: int, page_size: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.seq_capacity = seq_capacity
        self.page_size = page_size
        self.n_blocks = -(-seq_capacity // page_size)
        self.n_pages = 1 + n_slots * self.n_blocks  # + the trash page
        self.table = (1 + np.arange(n_slots * self.n_blocks, dtype=np.int32)).reshape(n_slots, self.n_blocks)
        self._free: List[int] = list(range(n_slots))

    def row(self, pool: torch.Tensor, slot: int) -> torch.Tensor:
        """Slot ``slot``'s row of one pool ``[n_pages, page, ...]``: a view
        ``[n_blocks * page, ...]`` over its pages (contiguous by the
        identity table)."""
        first = 1 + slot * self.n_blocks
        return pool[first:first + self.n_blocks].flatten(0, 1)

    def extract_spans(self, slot: int, length: int, count: int, pools) -> List[Dict[str, torch.Tensor]]:
        """The first ``count`` consecutive ``length``-position spans of
        ``slot`` (a prefix-cache store), in one gather per pool kind: each
        span maps a pool kind (``k``, ``v`` and, for an int8 cache, the
        scales) to ``[L, length, KVH, D or 1]``. The spans are views of one
        copy; it is freed with the last of them."""
        out = [dict() for _ in range(count)]
        with torch.no_grad():
            for field, _ in _POOL_FIELDS:
                if getattr(pools[0], field) is None:
                    continue
                whole = torch.stack([self.row(getattr(p, field), slot)[:count * length] for p in pools])
                for j, part in enumerate(whole.split(length, dim=1)):
                    out[j][field] = part
        return out

    def write_spans(self, spans: Sequence[Dict[str, torch.Tensor]], slot: int, pools) -> None:
        """Copy a prefix hit's spans into ``slot`` at their chunk-aligned
        positions ``[0, len(spans) * length)``; the fill cursor stays with
        the caller."""
        if not spans:
            return
        with torch.no_grad():
            for field in spans[0]:
                whole = torch.cat([span[field] for span in spans], dim=1)
                for i, p in enumerate(pools):
                    self.row(getattr(p, field), slot)[:whole.shape[1]].copy_(whole[i])

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def page_pool_util(self) -> float:
        return 0.0

    def acquire(self) -> Optional[int]:
        """Claim a free slot index, or None when fully occupied."""
        return self._free.pop(0) if self._free else None

    def release(self, slots: List[int]) -> None:
        for s in slots:
            if s in self._free:
                raise ValueError(f"slot {s} double-released")
            self._free.append(s)


class PagePool:
    """Free list + per-page refcounts. Page 0 is the TRASH page: never
    allocated, always mapped by zeroed block-table rows. ``reserved`` counts
    pages promised to admitted slots but not yet drawn, so an admitted
    stream can never run out of pages mid-decode."""

    TRASH = 0

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (trash + at least one real)")
        self.n_pages = n_pages
        self.refs = [0] * n_pages
        self._free: List[int] = list(range(1, n_pages))
        self.reserved = 0
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def available(self) -> int:
        """Pages neither allocated nor promised to an admitted slot."""
        return len(self._free) - self.reserved

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        page = self._free.pop()
        self.refs[page] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return page

    def incref(self, pages) -> None:
        for p in pages:
            if p == self.TRASH or self.refs[p] < 1:
                raise ValueError(f"incref of unallocated page {p}")
            self.refs[p] += 1

    def decref(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to the
        free list. Returns how many were freed."""
        freed = 0
        for p in pages:
            if p == self.TRASH:
                continue
            if self.refs[p] < 1:
                raise ValueError(f"decref of free page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed


class PagedKVCache:
    """Slot bookkeeping over a ``PagePool``: each slot's rows are a block
    table (``table``, host int32, zeros = trash page) covering
    ``seq_capacity`` positions in ``n_blocks`` pages."""

    def __init__(self, n_slots: int, n_pages: int, page_size: int, seq_capacity: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if seq_capacity % page_size:
            raise ValueError(f"page_size ({page_size}) must divide the capacity ({seq_capacity})")
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.seq_capacity = seq_capacity
        self.n_blocks = seq_capacity // page_size
        self.pool = PagePool(n_pages)
        self.table = np.zeros((n_slots, self.n_blocks), np.int32)
        self.alloc_blocks = [0] * n_slots  # leading blocks mapped, per slot
        self.reserved_blocks = [0] * n_slots  # admission promise, per slot
        self._free: List[int] = list(range(n_slots))
        self.cow_copies = 0

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)  # ceil

    def can_admit(self, new_blocks: int) -> bool:
        return self.pool.available >= new_blocks

    def reserve(self, slot: int, total_tokens: int) -> None:
        """Promise pages covering ``total_tokens`` positions beyond what the
        slot already maps; replaces the slot's previous promise."""
        self._unreserve(slot)
        need = max(0, self.blocks_for(total_tokens) - self.alloc_blocks[slot])
        self.reserved_blocks[slot] = need
        self.pool.reserved += need

    def _unreserve(self, slot: int) -> None:
        self.pool.reserved -= self.reserved_blocks[slot]
        self.reserved_blocks[slot] = 0

    def ensure(self, slot: int, tokens: int) -> bool:
        """Map fresh pages so the slot's table covers ``[0, tokens)``,
        drawing down its reservation. False when the pool is exhausted."""
        need = self.blocks_for(tokens)
        while self.alloc_blocks[slot] < need:
            page = self.pool.alloc()
            if page is None:
                return False
            b = self.alloc_blocks[slot]
            self.table[slot, b] = page
            self.alloc_blocks[slot] = b + 1
            if self.reserved_blocks[slot] > 0:
                self.reserved_blocks[slot] -= 1
                self.pool.reserved -= 1
        return True

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Prefix hit: map ``pages`` as the slot's leading blocks and bump
        their refcounts; no K/V moves."""
        if not pages:
            return
        if self.alloc_blocks[slot] != 0:
            raise ValueError("share() must precede any allocation for the slot")
        self.pool.incref(pages)
        for b, p in enumerate(pages):
            self.table[slot, b] = p
        self.alloc_blocks[slot] = len(pages)

    def bank(self, slot: int, n_blocks: int) -> List[int]:
        """Page ids of the slot's first ``n_blocks`` blocks, refcounts bumped
        for the prefix index's hold (the caller stores them)."""
        pages = [int(p) for p in self.table[slot, :n_blocks]]
        self.pool.incref(pages)
        return pages

    def cow(self, slot: int, block: int, copy_page: Callable[[int, int], None]) -> bool:
        """Copy-on-write guard: before the slot WRITES into block ``block``,
        a page other holders share is replaced by a private copy
        (``copy_page(src, dst)`` copies the pools' rows). Chunk-aligned
        sharing makes this unreachable; the guard keeps "a shared page is
        never written" a local check. False when no page is free."""
        if block >= self.alloc_blocks[slot]:
            return True
        page = int(self.table[slot, block])
        if page == PagePool.TRASH or self.pool.refs[page] <= 1:
            return True
        fresh = self.pool.alloc()
        if fresh is None:
            return False
        copy_page(page, fresh)
        self.table[slot, block] = fresh
        self.pool.decref([page])
        self.cow_copies += 1
        return True

    # ---- transferable page spans (export / import) -----------------------

    def export_page_span(self, slot: int, n_tokens: int, pools, scanned: bool = True,
                         carry: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """The host image of the slot's leading pages covering positions
        ``[0, n_tokens)``: every pool's rows of exactly those pages (scale
        pools too) under JAX's keys, and the span's geometry. ``carry``
        (device tensors, the decode carry) rides the same single copy to the
        host, under its own keys. Read-only: the slot keeps its pages and
        refcounts, so a failed ship leaves the source stream intact."""
        n_blocks = self.blocks_for(n_tokens)
        if n_blocks > self.alloc_blocks[slot]:
            raise ValueError(f"slot {slot} maps {self.alloc_blocks[slot]} blocks; export of {n_blocks} requested")
        device = pools[0].k.device
        ids = torch.as_tensor([int(p) for p in self.table[slot, :n_blocks]], dtype=torch.long)
        if device.type == "cuda":
            ids = ids.pin_memory().to(device, non_blocking=True)
        gathered: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for key, layers in span_keys(pools, scanned).items():
                rows = [t.index_select(0, ids) for t in layers]
                gathered[key] = torch.stack(rows, dim=1) if scanned else rows[0]
        gathered.update(carry or {})
        return {"page_size": self.page_size, "n_blocks": n_blocks, "n_tokens": int(n_tokens),
                "leaves": _device_to_host(gathered)}

    def import_page_span(self, slot: int, payload: Dict, pools, scanned: bool = True,
                         carry: Optional[Dict[str, torch.Tensor]] = None) -> bool:
        """Materialize an exported span as ``slot``'s leading blocks:
        allocate fresh pages, copy the bytes in (one host-to-device copy,
        then one ``index_copy_`` per pool) and map them in the host table.
        Bit-exact: raw bytes, the same dtypes. Returns False when the pool
        cannot cover the span (the partial allocation is rolled back);
        raises ValueError on a page size, leaf set, shape or dtype that does
        not fit. Imported pages are ordinary refcounted pages (ref 1, owned
        by the slot), so copy-on-write guards any later write to one that is
        shared. ``carry`` (host tensors) rides the same copy; on success
        each of its entries is replaced by its device copy."""
        if self.alloc_blocks[slot] != 0:
            raise ValueError("import_page_span needs an empty slot")
        page_size, n_blocks = int(payload["page_size"]), int(payload["n_blocks"])
        if page_size != self.page_size:
            raise ValueError(f"page-span page_size {page_size} != pool page_size {self.page_size}")
        if n_blocks > self.n_blocks:
            raise ValueError(f"span of {n_blocks} blocks exceeds per-slot capacity {self.n_blocks}")
        targets = span_keys(pools, scanned)
        leaves = {k: as_host_tensor(v) for k, v in payload["leaves"].items()}
        if set(leaves) != set(targets):
            raise ValueError(f"page-span leaves {sorted(leaves)} != pool leaves {sorted(targets)}")
        for key, arr in leaves.items():
            layers = targets[key]
            shape = (n_blocks,) + _span_shape(layers, scanned)
            if tuple(arr.shape) != shape or arr.dtype != layers[0].dtype:
                raise ValueError(f"page-span leaf {key} is {arr.dtype}{list(arr.shape)}; pool expects "
                                 f"{layers[0].dtype}{list(shape)}")
        fresh: List[int] = []
        for _ in range(n_blocks):
            page = self.pool.alloc()
            if page is None:
                self.pool.decref(fresh)  # roll the partial allocation back
                return False
            fresh.append(page)
        device = pools[0].k.device
        host = dict(leaves)
        host["__ids__"] = torch.as_tensor(fresh, dtype=torch.long)
        host.update(carry or {})
        moved = _host_to_device(host, device)
        ids = moved.pop("__ids__")
        with torch.no_grad():
            for key, layers in targets.items():
                src = moved.pop(key)
                for i, t in enumerate(layers):
                    t.index_copy_(0, ids, src[:, i] if scanned else src)
        if carry is not None:
            carry.update(moved)
        for b, p in enumerate(fresh):
            self.table[slot, b] = p
        self.alloc_blocks[slot] = n_blocks
        return True

    def reset_slot_pages(self, slot: int) -> None:
        """Drop every page the slot maps without freeing the slot (a hot
        reload restarts a mid-prefill slot: pages shared before the reload
        must not be rewritten under the new weights). The caller re-reserves."""
        n = self.alloc_blocks[slot]
        if not n:
            return
        self.pool.decref(int(p) for p in self.table[slot, :n])
        self.table[slot, :n] = 0
        self.alloc_blocks[slot] = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def page_pool_util(self) -> float:
        real = self.n_pages - 1
        return self.pool.in_use / real if real else 0.0

    def acquire(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def release(self, slots: List[int]) -> None:
        """Retire slots: drop their page references and reservations and
        zero their table rows."""
        for s in slots:
            if s in self._free:
                raise ValueError(f"slot {s} double-released")
            n = self.alloc_blocks[s]
            if n:
                self.pool.decref(int(p) for p in self.table[s, :n])
                self.table[s, :n] = 0
                self.alloc_blocks[s] = 0
            self._unreserve(s)
            self._free.append(s)
