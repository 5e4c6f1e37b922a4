"""Chunk-aligned token-prefix cache over the paged KV pool.

A copy of ``zero_transformer_tpu/serving/prefix_cache.py`` (host-side,
stdlib only; the port keeps its own copy and imports nothing of the JAX
package). ``PrefixCache`` is the key scheme, the hit walk and the
children-aware LRU; ``PagedPrefixIndex`` holds page ids refcounted in the
engine's ``PagePool``:

- **Key scheme**: an entry covers ONE chunk of ``chunk_tokens`` tokens and
  is keyed by the ENTIRE token prefix up to and including that chunk
  (``tuple(prompt[:j * chunk])``): K/V at a position depends on every
  earlier token, so two prompts share a chunk's K/V only when the whole
  prefix matches. Exact tuple keys, so a hash collision can never serve
  wrong K/V.
- **Hit walk**: ``lookup`` extends the match one chunk at a time and stops
  strictly BEFORE the prompt's final token (``j * chunk < len(prompt)``):
  the last chunk is always recomputed, because admission needs the logits
  at ``true_len - 1``.
- **Invalidation**: ``flush()`` on hot weight reload (cached K/V is valid
  only for the weights that made it); a device-state rebuild after a tick
  fault builds a fresh index against the fresh pool. The engine owns both.

Not thread-safe by itself: only the scheduler tick thread touches it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Sequence, Tuple


class PrefixCache:
    """LRU of chunk-aligned prefix K/V spans.

    ``capacity`` counts CHUNK ENTRIES (each worth ``chunk_tokens`` cache
    positions of K/V per layer), so the device memory the cache pins is
    bounded at ``capacity * chunk_tokens`` positions regardless of how many
    distinct prompts pass through.
    """

    def __init__(self, chunk_tokens: int, capacity: int):
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1 (0 disables at the engine)")
        self.chunk_tokens = chunk_tokens
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        # cached DEEPER chunks per entry: an entry with live children is
        # never evicted (its children would become unreachable dead weight —
        # the hit walk stops at the first absent chunk), so eviction takes
        # the least-recent LEAF instead
        self._children: Dict[Tuple[int, ...], int] = {}
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _key(self, prompt: Sequence[int], j: int) -> Tuple[int, ...]:
        return tuple(prompt[: j * self.chunk_tokens])

    def _parent(self, key: Tuple[int, ...]) -> Tuple[int, ...]:
        return key[: len(key) - self.chunk_tokens]

    def _link(self, key: Tuple[int, ...]) -> None:
        # counted whether or not the parent is RESIDENT: the map answers
        # "how many cached entries extend this key by one chunk", so a
        # parent stored out of order (re-cached after its deeper chunk)
        # arrives already pinned by its resident children — no scan needed
        parent = self._parent(key)
        if parent:
            self._children[parent] = self._children.get(parent, 0) + 1

    def _unlink(self, key: Tuple[int, ...]) -> None:
        parent = self._parent(key)
        if parent:
            n = self._children.get(parent, 1) - 1
            if n:
                self._children[parent] = n
            else:
                self._children.pop(parent, None)

    def _evict_one(self):
        """Pop the least-recently-used LEAF entry (no cached deeper chunk
        depends on it). Evicting a mid-chain entry would orphan its
        descendants: still resident, never again reachable by the hit walk —
        the whole-prefix-eviction bug this ordering exists to fix."""
        victim = next(
            (k for k in self._entries if not self._children.get(k)),
            next(iter(self._entries)),  # cycle-free tree: always has a leaf
        )
        return self._pop_entry(victim)

    def _pop_entry(self, victim: Tuple[int, ...]):
        value = self._entries.pop(victim)
        self._unlink(victim)
        self.evictions += 1
        return victim, value

    def lookup(self, prompt: Sequence[int]) -> Tuple[int, List[Any]]:
        """Longest chunk-aligned cached prefix of ``prompt``.

        Returns ``(tokens_covered, spans)`` where ``spans[i]`` is chunk
        ``i+1``'s K/V span; every covered chunk counts a hit and every
        remaining chunk-aligned chunk (still ending before the final token)
        counts a miss. The walk stops at the first absent chunk — a cached
        DEEPER chunk is unusable without its predecessors' K/V in the row.
        """
        C = self.chunk_tokens
        fill, spans = self.walk(prompt)
        for j in range(1, len(spans) + 1):
            self._entries.move_to_end(self._key(prompt, j))
        self.hits += len(spans)
        j = len(spans) + 1
        while j * C < len(prompt):
            self.misses += 1
            j += 1
        return fill, spans

    def walk(self, prompt: Sequence[int]) -> Tuple[int, List[Any]]:
        """The hit walk WITHOUT stats or recency side effects — capacity
        planning (the paged admission sizes its page reservation before
        committing to the hit, and must not count the same hit twice)."""
        C = self.chunk_tokens
        vals: List[Any] = []
        j = 1
        while j * C < len(prompt):
            v = self._entries.get(self._key(prompt, j))
            if v is None:
                break
            vals.append(v)
            j += 1
        return len(vals) * C, vals

    def contains(self, prompt: Sequence[int], j: int) -> bool:
        return self._key(prompt, j) in self._entries

    def store(self, prompt: Sequence[int], j: int, span: Any) -> None:
        """Insert chunk ``j`` (1-based) of ``prompt``'s prefix; evicts LRU
        entries past capacity. Re-storing an existing key just refreshes
        its recency (the spans are bit-identical by construction)."""
        key = self._key(prompt, j)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = span
        self._link(key)
        self.stores += 1
        while len(self._entries) > self.capacity:
            self._evict_one()

    def flush(self) -> int:
        """Drop every entry (hot reload / device rebuild); returns how many."""
        n = len(self._entries)
        self._entries.clear()
        self._children.clear()
        return n

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_stores": self.stores,
            "prefix_evictions": self.evictions,
            "prefix_entries": len(self._entries),
            "prefix_hit_rate": (self.hits / total) if total else 0.0,
        }


class PagedPrefixIndex(PrefixCache):
    """Prefix cache over PAGE IDS (the paged-KV unification): an entry's
    value is the tuple of pool pages holding that chunk's K/V, not a copy
    of the bytes.

    - **store** records the pages (already refcount-bumped by
      ``PagedKVCache.bank``) — no extraction dispatch, no device copy;
    - **a hit** hands the pages to ``PagedKVCache.share``, which maps them
      into the new slot's block table and bumps refcounts — reuse without
      moving a byte;
    - **eviction / flush** drop the index's reference through the pool:
      a page still mapped by a live slot (or, impossible by key-scheme but
      guarded anyway, another entry) survives until its last reference —
      the refcount-aware eviction the slab-era LRU lacked;
    - **reclaim(n)** frees at least ``n`` pages for an allocation that
      found the pool exhausted, evicting least-recent leaf entries first —
      the page-fault path the engine counts.

    Same key scheme, hit walk, children-aware LRU order, and stats surface
    as ``PrefixCache``.
    """

    def __init__(self, chunk_tokens: int, capacity: int, pool):
        super().__init__(chunk_tokens, capacity)
        self._pool = pool

    def _evict_one(self):
        key, pages = super()._evict_one()
        self._pool.decref(pages)
        return key, pages

    def store_pages(self, prompt: Sequence[int], j: int, pages) -> None:
        """Insert chunk ``j``'s pages; a duplicate store returns the extra
        references immediately (one index hold per page, ever)."""
        key = self._key(prompt, j)
        if key in self._entries:
            self._entries.move_to_end(key)
            self._pool.decref(pages)  # bank() bumped; the entry already holds
            return
        self.store(prompt, j, tuple(pages))

    def reclaim(self, n_pages: int) -> int:
        """Evict entries until >= ``n_pages`` pages came FREE (refcount
        zero); returns pages freed. Only entries whose eviction actually
        frees something are touched — least-recent FREEABLE leaf first —
        and the walk stops when no leaf would free a page: evicting an
        entry whose pages a live slot still maps gains zero capacity, and
        wiping the hot shared-prefix set on a failed admission would turn
        one capacity miss into a hit-rate collapse."""
        freed = 0
        while freed < n_pages:
            victim = next(
                (
                    k
                    for k, pages in self._entries.items()
                    if not self._children.get(k)
                    and any(self._pool.refs[p] == 1 for p in pages)
                ),
                None,
            )
            if victim is None:
                break
            _, pages = self._pop_entry(victim)
            freed += self._pool.decref(pages)
        return freed

    def flush(self) -> int:
        for pages in self._entries.values():
            self._pool.decref(pages)
        return super().flush()
