"""Token-row sources. Counterpart of ``zero_transformer_tpu/data/sources.py``
(numpy code, copied): a source iterates over 1-D int32 rows of
``max_context`` tokens, with ``seek(n)`` and ``state()``/``restore()`` for
exact resume.

- ``SyntheticSource``: row ``i`` is a pure function of ``(seed, i)``, drawn
  from ``np.random.default_rng(SeedSequence([seed, i]))``, bit-identical to
  the JAX package's rows;
- ``MemmapSource``: a flat binary token file viewed as
  ``[n_rows, max_context]``, rows permuted per epoch with a seed derived
  from ``(seed, epoch)``;
- ``ReplayStreamSource``: the position bookkeeping of a stream that resumes
  only by replaying from its head (``tarshards.TarShardSource``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np


class TokenSource:
    """Iterable of 1-D int32 arrays of length ``max_context``."""

    max_context: int

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def seek(self, n_rows: int) -> None:
        """Fast-forward so iteration resumes ``n_rows`` in."""
        raise NotImplementedError

    def state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def restore(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError


class ReplayStreamSource(TokenSource):
    """Position tracking for sources that can only resume by replaying their
    stream from the head and discarding (tar shards).

    Subclasses implement ``_samples()``, an infinite iterator over decoded
    rows from position 0. ``seek`` is O(n) (discard) but exact; repeated
    ``iter()`` calls CONTINUE the stream (replaying past skipped and yielded
    rows) rather than restarting it, as the indexable sources do.
    """

    def __init__(self):
        self._skip_rows = 0
        self._yielded = 0

    def _samples(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[np.ndarray]:
        start = self._skip_rows + self._yielded
        skipped = 0
        for row in self._samples():
            if skipped < start:
                skipped += 1
                continue
            self._yielded += 1
            yield row

    def seek(self, n_rows: int) -> None:
        self._skip_rows += n_rows

    def state(self) -> Dict[str, Any]:
        return {"rows": self._yielded + self._skip_rows}

    def restore(self, state: Dict[str, Any]) -> None:
        self._skip_rows = int(state["rows"])
        self._yielded = 0


@dataclasses.dataclass
class SyntheticSource(TokenSource):
    """Deterministic random tokens; row ``i`` is a pure function of (seed, i)."""

    vocab_size: int
    max_context: int
    seed: int = 0
    _position: int = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            i = self._position
            self._position += 1  # before yield: the generator may never resume
            yield self._row(i)

    def _row(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        return rng.integers(0, self.vocab_size, self.max_context, dtype=np.int32)

    def seek(self, n_rows: int) -> None:
        self._position += n_rows

    def state(self) -> Dict[str, Any]:
        return {"position": self._position}

    def restore(self, state: Dict[str, Any]) -> None:
        self._position = int(state["position"])


class MemmapSource(TokenSource):
    """Rows from a flat binary token file (uint16 for vocabularies under
    65536, or uint32), shuffled per epoch. A missing file raises."""

    def __init__(self, path: str, max_context: int, dtype: str = "uint16", shuffle: bool = True,
                 seed: int = 23):
        self.path = path
        self.max_context = max_context
        self.dtype = np.dtype(dtype)
        self.shuffle = shuffle
        self.seed = seed
        tokens = np.memmap(path, dtype=self.dtype, mode="r")
        self.n_rows = len(tokens) // max_context
        if self.n_rows == 0:
            raise ValueError(f"{path}: {len(tokens)} tokens < one row of {max_context}")
        self._tokens = tokens[: self.n_rows * max_context].reshape(self.n_rows, max_context)
        self._epoch = 0
        self._row_in_epoch = 0
        self._perm: Optional[np.ndarray] = None
        self._perm_epoch = -1

    def _permutation(self) -> np.ndarray:
        if self._perm_epoch != self._epoch:
            if self.shuffle:
                rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
                self._perm = rng.permutation(self.n_rows)
            else:
                self._perm = np.arange(self.n_rows)
            self._perm_epoch = self._epoch
        return self._perm

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            idx = self._permutation()[self._row_in_epoch]
            row = np.asarray(self._tokens[idx], dtype=np.int32)
            self._row_in_epoch += 1
            if self._row_in_epoch >= self.n_rows:
                self._row_in_epoch = 0
                self._epoch += 1
            yield row

    def seek(self, n_rows: int) -> None:
        total = self._epoch * self.n_rows + self._row_in_epoch + n_rows
        self._epoch, self._row_in_epoch = divmod(total, self.n_rows)

    def state(self) -> Dict[str, Any]:
        return {"epoch": self._epoch, "row_in_epoch": self._row_in_epoch}

    def restore(self, state: Dict[str, Any]) -> None:
        self._epoch = int(state["epoch"])
        self._row_in_epoch = int(state["row_in_epoch"])
