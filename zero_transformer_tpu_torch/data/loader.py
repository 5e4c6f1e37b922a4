"""Batch loader: token rows -> ``[accum, batch, seq]`` int32 training batches.

Counterpart of ``zero_transformer_tpu/data/loader.py`` with the same
semantics: process striping (process ``p`` takes source rows ``p, p+P,
...``, unless the source stripes its shards itself and says so with
``pre_striped``; ``process_index``/``process_count`` are explicit, default
0 and 1, in place of ``jax.process_index()``), the sequence curriculum (a
``max_context`` row splits into ``max_context // train_context`` rows),
resume by ``skip``/``state``/``restore``, and a bounded read-ahead thread
whose unseen batches survive the iterator's teardown. ``to_device`` takes
the place of ``device_put_batch``: a batch goes to the card from pinned
host memory.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from zero_transformer_tpu_torch.data.sources import TokenSource


class DataLoader:
    """Yields ``[accum_steps, local_batch, train_context]`` int32 batches.

    ``batch_size`` is the GLOBAL batch in sequences of ``train_context``;
    ``prefetch`` batches are read ahead by a background thread (0 = fully
    synchronous). ``steps_consumed`` counts batches yielded, never batches
    merely read ahead, so the resume state stays exact.
    """

    def __init__(
        self,
        source: TokenSource,
        batch_size: int,
        train_context: Optional[int] = None,
        accum_steps: int = 1,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 0,
    ):
        self.source = source
        self.batch_size = batch_size
        self.train_context = train_context or source.max_context
        self.accum_steps = accum_steps
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # a source that already yields only this process's rows
        self.pre_striped = bool(getattr(source, "pre_striped", False))
        self.steps_consumed = 0
        # batches a torn-down prefetching iterator read ahead but never
        # yielded; the next iterator serves them first
        self._leftover: collections.deque = collections.deque()
        if source.max_context % self.train_context:
            raise ValueError(
                f"max_context {source.max_context} not divisible by train_context {self.train_context}"
            )
        self.split = source.max_context // self.train_context
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} not divisible by {process_count} processes")
        seqs_per_step = batch_size * accum_steps
        if seqs_per_step % (self.split * process_count):
            raise ValueError(
                f"batch_size*accum ({seqs_per_step}) must divide by split*processes "
                f"({self.split * process_count})"
            )
        self.rows_per_step = seqs_per_step // self.split // process_count
        self.local_batch = batch_size // process_count

    def _striped_rows(self) -> Iterator[np.ndarray]:
        if self.pre_striped:
            yield from iter(self.source)
            return
        for i, row in enumerate(iter(self.source)):
            if i % self.process_count == self.process_index:
                yield row

    def _batches(self) -> Iterator[np.ndarray]:
        rows = self._striped_rows()
        n = self.rows_per_step
        while True:
            block = np.stack([next(rows) for _ in range(n)])  # [n, max_context]
            yield block.reshape(self.accum_steps, self.local_batch, self.train_context)

    def _prefetched(self) -> Iterator[np.ndarray]:
        """A bounded-queue producer thread runs ``_batches`` ahead; its errors
        re-raise at the consuming ``next``. Abandoning the iterator parks the
        read-ahead the consumer never saw in ``_leftover``."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        held: list = []  # produced but never queued before teardown
        DONE, ERROR = object(), object()

        def put_polling(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put_polling(batch):
                        held.append(batch)
                        return
                put_polling(DONE)
            except BaseException as e:  # forwarded to the consumer
                put_polling((ERROR, e))

        thread = threading.Thread(target=producer, daemon=True, name="zt-data-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    return
                if isinstance(item, tuple) and item and item[0] is ERROR:
                    raise item[1]
                yield item
        finally:
            stop.set()
            thread.join()
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is DONE or (isinstance(item, tuple) and item and item[0] is ERROR):
                    continue
                self._leftover.append(item)
            self._leftover.extend(held)

    def __iter__(self) -> Iterator[np.ndarray]:
        while self._leftover:
            self.steps_consumed += 1
            yield self._leftover.popleft()
        batches = self._prefetched() if self.prefetch > 0 else self._batches()
        for batch in batches:
            self.steps_consumed += 1
            yield batch

    def skip(self, n_steps: int) -> None:
        """Fast-forward past ``n_steps`` batches, seeking the source in
        global rows so striping stays aligned across processes (in local
        rows for a pre-striped source)."""
        take = min(n_steps, len(self._leftover))
        for _ in range(take):
            self._leftover.popleft()
        n = (n_steps - take) * self.rows_per_step
        self.source.seek(n if self.pre_striped else n * self.process_count)
        self.steps_consumed += n_steps

    def fault_counters(self) -> dict:
        """The source's data-path fault counts (``TarShardSource``: shard
        retries, skipped shards and members); empty for other sources."""
        counters = getattr(self.source, "fault_counters", None)
        return dict(counters) if isinstance(counters, dict) else {}

    def state(self) -> dict:
        """Resume token: the step count, the only state identical across processes."""
        return {"steps_consumed": self.steps_consumed}

    def restore(self, state: dict) -> None:
        if self.steps_consumed:
            raise RuntimeError(
                f"DataLoader.restore requires a fresh loader (already consumed {self.steps_consumed} steps)"
            )
        self.skip(int(state["steps_consumed"]))


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch as an int32 tensor on ``device``: for a card, copied
    from pinned memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
