"""Tar-shard streaming source, webdataset-style, from local files.

Counterpart of ``zero_transformer_tpu/data/tarshards.py`` (numpy and the
standard library, copied):

- ``expand_braces``: ``{000..012}`` numeric range expansion;
- ``read_index``: an ``.index`` file -> its shard paths (``#`` comments
  skipped); relative entries resolve against the index file's own
  directory, and an entry missing there but present relative to the working
  directory raises (JAX's default; its opt-in cwd fallback is not ported);
- ``TarShardSource``: token rows out of (optionally gzipped) tar shards. The
  shard order reshuffles each epoch from ``(seed, epoch)``, so every
  process derives the same order with no communication; with at least two
  shards per process it stripes whole shards per process and says so with
  ``pre_striped`` (the loader then skips its row striping).

Each tar member is one sample: ``.npy``, ``.json`` (a list of ints),
``.bin``/``.u16`` (raw uint16) or ``.pth``/``.pt`` (``torch.load`` with
``weights_only=True``). Rows shorter than ``max_context`` are skipped,
longer ones truncated. Paths are local: a remote URL (``gs://...``) raises,
since the port does not carry ``fsspec``.
"""
from __future__ import annotations

import gzip
import io
import json
import logging
import re
import tarfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np
import torch

from zero_transformer_tpu_torch.data.sources import ReplayStreamSource

log = logging.getLogger("zero_transformer_tpu_torch")

RETRY_BACKOFF_S = 1.0  # first wait before re-opening a shard; doubles per attempt

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_braces(pattern: str) -> List[str]:
    """``a-{000..002}.tar`` -> [a-000.tar, a-001.tar, a-002.tar] (recursive)."""
    m = _BRACE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    out: List[str] = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(expand_braces(pattern[: m.start()] + str(i).zfill(len(lo)) + pattern[m.end():]))
    return out


def _local(path: str) -> str:
    if "://" in path:
        raise NotImplementedError(f"remote shard {path!r}: the port reads local tar shards only")
    return path


def read_index(path: Union[str, Path]) -> List[str]:
    """Index file -> expanded shard list. Relative local entries resolve
    against the index file's directory, so a dataset directory keeps working
    after it is moved; an entry that exists only relative to the working
    directory raises rather than guess which dataset was meant."""
    base = Path(path).parent
    shards: List[str] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        for s in expand_braces(line):
            s = _local(s)
            if not Path(s).is_absolute():
                resolved = base / s
                if not resolved.exists() and Path(s).exists():
                    raise ValueError(
                        f"index entry {s!r} missing at {resolved} but present cwd-relative at "
                        f"{Path(s).resolve()}: move or complete the dataset next to the index"
                    )
                s = str(resolved)
            shards.append(s)
    if not shards:
        raise ValueError(f"index {path} lists no shards")
    return shards


def _open_shard(path: str):
    raw = open(_local(path), "rb")
    if path.endswith((".gz", ".tgz")):
        return gzip.open(raw)
    return raw


def _decode_member(name: str, data: bytes):
    if name.endswith(".npy"):
        return np.load(io.BytesIO(data), allow_pickle=False)
    if name.endswith(".json"):
        return np.asarray(json.loads(data.decode()))
    if name.endswith((".bin", ".u16")):
        return np.frombuffer(data, dtype=np.uint16)
    if name.endswith((".pth", ".pt")):
        return np.asarray(torch.load(io.BytesIO(data), weights_only=True))
    return None  # unknown payload (e.g. __key__ metadata): skip


class TarShardSource(ReplayStreamSource):
    """Stream token rows out of tar shards.

    Args:
      shards: shard paths or brace patterns, or a single ``*.index`` file.
      max_context: row length (shorter samples skipped, longer truncated).
      seed: shard-order shuffle seed; the order reshuffles each epoch.
      shuffle_shards: False keeps index order (validation).
      process_index/process_count: this process's place. Whole shards are
        striped per process when every process owns at least two (JAX's
        ``stripe_shards="auto"``); otherwise the loader stripes rows.
      strict: False logs and skips undecodable members and unreadable
        shards (a shard open is retried twice with backoff first); True
        raises at once.

    Resume: ``seek``/``restore`` replay the stream and discard
    (``ReplayStreamSource``), exact for any shard contents. Positions count
    the rows THIS process yields, striped or not.
    """

    def __init__(
        self,
        shards: Union[str, Sequence[str]],
        max_context: int,
        seed: int = 23,
        shuffle_shards: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        strict: bool = False,
    ):
        if isinstance(shards, (str, Path)):
            shards = [str(shards)]
        expanded: List[str] = []
        for s in shards:
            s = str(s)
            expanded.extend(read_index(s) if s.endswith(".index") else expand_braces(_local(s)))
        if not expanded:
            raise ValueError("no shards")
        self.shards = expanded
        self.max_context = max_context
        self.seed = seed
        self.shuffle_shards = shuffle_shards
        self.process_index = process_index
        self.process_count = process_count
        # tells the DataLoader this source yields only this process's rows
        self.pre_striped = process_count > 1 and len(expanded) >= 2 * process_count
        self.strict = strict
        self.fault_counters: Dict[str, int] = {
            "shard_retries": 0, "skipped_shards": 0,
            "skipped_shard_remainders": 0, "skipped_members": 0,
        }
        super().__init__()

    def _shard_order(self, epoch: int) -> List[str]:
        if self.shuffle_shards:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            order = [self.shards[i] for i in rng.permutation(len(self.shards))]
        else:
            order = list(self.shards)
        if self.pre_striped:
            # every process computes the same global order, then takes its
            # disjoint slice, reshuffled each epoch so ownership rotates
            order = order[self.process_index::self.process_count]
        return order

    def _shard_rows(self, shard: str) -> Iterator[np.ndarray]:
        with _open_shard(shard) as raw, tarfile.open(fileobj=raw, mode="r|") as tar:
            for member in tar:
                if not member.isfile():
                    continue
                try:
                    ids = _decode_member(member.name, tar.extractfile(member).read())
                except Exception:
                    if self.strict:
                        raise
                    self.fault_counters["skipped_members"] += 1
                    log.warning("skipping undecodable member %s in %s", member.name, shard,
                                exc_info=True)
                    continue
                if ids is None:
                    continue
                ids = np.asarray(ids).reshape(-1)
                if len(ids) < self.max_context:
                    continue
                yield ids[: self.max_context].astype(np.int32)

    def _samples(self) -> Iterator[np.ndarray]:
        epoch = 0
        while True:
            yielded = 0
            for shard in self._shard_order(epoch):
                # a shard that fails before yielding is retried; one that
                # fails after yielding rows cannot be (the yielded prefix
                # would repeat), so its remainder is skipped
                for attempt in range(3):
                    from_this_shard = 0
                    try:
                        for row in self._shard_rows(shard):
                            from_this_shard += 1
                            yielded += 1
                            yield row
                        break
                    except Exception:
                        if self.strict:
                            raise
                        if attempt < 2 and from_this_shard == 0:
                            self.fault_counters["shard_retries"] += 1
                            delay = RETRY_BACKOFF_S * (2.0**attempt)
                            log.warning("retrying shard %s in %.1fs (attempt %d)", shard, delay,
                                        attempt + 2)
                            time.sleep(delay)
                            continue
                        key = "skipped_shard_remainders" if from_this_shard else "skipped_shards"
                        self.fault_counters[key] += 1
                        log.warning("skipping %s of shard %s", "remainder" if from_this_shard else "all",
                                    shard, exc_info=True)
                        break
            if yielded == 0:
                raise RuntimeError(
                    f"tar source produced zero rows in one full epoch over {len(self.shards)} "
                    f"shard(s): bad paths, corrupt data, or all rows shorter than "
                    f"max_context={self.max_context}"
                )
            epoch += 1
