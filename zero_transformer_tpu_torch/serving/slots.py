"""Host-side KV page allocation for the paged serving cache.

Counterpart of ``zero_transformer_tpu/serving/slots.py`` (``PagePool`` :494,
``PagedKVCache`` :563): refcounted pages with the trash page 0, admission
reservations, the per-slot block tables kept on the host, slot
acquire/release, and prefix sharing (``share`` maps a prefix hit's pages
by refcount, ``bank`` takes the prefix index's reference, ``cow`` gives a
slot a private copy of a shared page before it writes there). The page-span
wire format of stream migration comes with a later slice. The device state
(the pools themselves) lives with the engine
(``inference.generate.allocate_pools``); ``cow`` copies a page through the
engine's callback.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


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
