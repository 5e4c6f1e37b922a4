"""Host-side KV page allocation for the paged serving cache.

Counterpart of ``zero_transformer_tpu/serving/slots.py`` (``PagePool`` :494,
``PagedKVCache`` :563), the subset the slice needs: refcounted pages with
the trash page 0, admission reservations, the per-slot block tables kept on
the host, and slot acquire/release. Prefix sharing, copy-on-write and the
page-span wire format come with a later slice. The device state (the pools
themselves) lives with the engine: ``inference.generate.allocate_pools``.
"""
from __future__ import annotations

from typing import List, Optional

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

    @property
    def free_count(self) -> int:
        return len(self._free)

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
