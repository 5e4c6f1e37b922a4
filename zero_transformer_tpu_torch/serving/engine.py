"""Continuous-batching scheduler over the paged KV cache.

Counterpart of the core of ``zero_transformer_tpu/serving/engine.py``:
``Request``/``RequestHandle``, ``submit`` behind a bounded queue,
chunked admission (``_admit_chunked`` :1730), the chunked-prefill tick
(``_prefill_tick`` :1901 with ``_paged_chunk_prefill_impl`` :627 semantics),
decode page growth (``_grow_decode_pages`` :3144), the decode tick (``step``
:2291: the sampling tail, then the forward of ``_fused_step_impl`` :485,
with the per-row non-finite guard), retirement on ``max_new_tokens``/EOS,
``run``/``run_until_idle`` and a ``metrics_snapshot`` subset.

PyTorch runs eagerly, so the prefill chunk runs over the prefilling rows
only (the JAX program is fixed-shape over every slot and routes the other
rows to the trash page). The decode tick runs over every slot, as in JAX:
rows that are not decoding ride along with a zeroed block table (the trash
page) at position 0, and their outputs are discarded.

Speculation, the prefix cache, QoS, migration, hot reload and the circuit
breaker come with later slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import queue as queue_mod
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from zero_transformer_tpu_torch.config import resolve_device
from zero_transformer_tpu_torch.inference.generate import allocate_pools, decode_model
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig, sample_token
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.serving.slots import PagedKVCache

# lifecycle states (JAX serving/resilience.py): /healthz is 200 only when READY
STARTING, READY, STOPPED = "starting", "ready", "stopped"

# request states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
EXPIRED = "expired"
REJECTED = "rejected"
FAILED = "failed"


@dataclasses.dataclass
class Request:
    """One generation request, in token-id space."""

    prompt: Sequence[int]
    max_new_tokens: int
    seed: int = 0
    # absolute deadline on the engine's clock; None = no deadline
    deadline: Optional[float] = None


class RequestHandle:
    """Thread-safe view of a submitted request: token stream + final state."""

    def __init__(self, request: Request, rid: int, submitted_at: float):
        self.request = request
        self.id = rid
        self.rid = uuid.uuid4().hex
        self.submitted_at = submitted_at
        self.status = QUEUED
        self.tokens: List[int] = []
        self.first_token_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.prefill_done_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[str] = None
        # a failure the client should retry (the server answers 503)
        self.retryable = False
        self._events: queue_mod.Queue = queue_mod.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()

    def cancel(self) -> None:
        """Ask the scheduler to drop this request at the next tick."""
        self._cancel.set()

    def next_event(self, timeout: Optional[float] = None):
        """Blocking pop of the next ``("token", id)`` / ``("done", status)``
        event, or None when ``timeout`` elapses first."""
        try:
            return self._events.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal, then return every emitted token id."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.id} still {self.status}")
        return list(self.tokens)

    def _emit(self, token: int, now: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = now
        self.tokens.append(token)
        self._events.put(("token", token))

    def _finish(self, status: str, now: float, error: Optional[str] = None,
                retryable: bool = False) -> None:
        self.status = status
        self.error = error
        self.retryable = retryable
        self.finished_at = now
        self._events.put(("done", status))
        self._done.set()


@dataclasses.dataclass
class _ActiveSlot:
    handle: RequestHandle
    emitted: int = 0
    last_emit_at: Optional[float] = None


@dataclasses.dataclass
class _PrefillJob:
    """A slot mid-chunked-prefill: ``fill`` prompt tokens have K/V in the
    slot's pages."""

    handle: RequestHandle
    fill: int = 0


def _percentiles(values: Sequence[float], qs=(50, 90, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles of a host-side sample list."""
    if not values:
        return {f"p{q}": 0.0 for q in qs}
    ordered = sorted(values)
    out = {}
    for q in qs:
        rank = max(0, min(len(ordered) - 1, math.ceil(q / 100 * len(ordered)) - 1))
        out[f"p{q}"] = ordered[rank]
    return out


class ServingEngine:
    """Slot-scheduled continuous batching over the paged decode model.

    ``model`` is a ``Transformer`` already on ``device`` (CUDA unless the
    caller asks for the CPU); its Dense and embedding weights are cast to
    the compute dtype once (``cast_for_inference``). Sampling settings are
    engine-level, like the JAX engine's; requests vary prompt, token
    budget, seed and deadline."""

    def __init__(
        self,
        model: Transformer,
        n_slots: int = 4,
        cache_len: Optional[int] = None,
        sampling: SamplingConfig = SamplingConfig(),
        eos_token_id: Optional[int] = None,
        max_queue: int = 64,
        prefill_chunk: int = 64,
        page_size: int = 16,
        page_pool_tokens: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        cfg = model.cfg
        self.cfg = cfg
        self.cache_len = cache_len or cfg.max_seq_len
        if prefill_chunk < 1:
            raise ValueError("the paged KV cache needs chunked prefill (prefill_chunk >= 1)")
        # a chunk larger than the cache degenerates to cache-sized windows
        self.prefill_chunk = min(prefill_chunk, self.cache_len)
        if page_size < 1 or self.cache_len % page_size:
            raise ValueError(f"page_size ({page_size}) must divide cache_len ({self.cache_len})")
        if self.prefill_chunk % page_size:
            raise ValueError(f"page_size ({page_size}) must divide prefill_chunk ({self.prefill_chunk})")
        if page_pool_tokens == 0:
            page_pool_tokens = n_slots * self.cache_len  # the slab-equivalent budget
        if page_pool_tokens % page_size:
            raise ValueError(f"page_pool_tokens ({page_pool_tokens}) must be a multiple of page_size ({page_size})")
        if next(model.parameters()).device != self.device:
            raise ValueError(f"model lives on {next(model.parameters()).device}, engine on {self.device}")
        self.page_size = page_size
        self.page_pool_tokens = page_pool_tokens
        n_pages = page_pool_tokens // page_size + 1  # + trash page
        self.model = decode_model(model, self.cache_len, (n_pages, page_size)).cast_for_inference()
        self.pools = allocate_pools(cfg, n_pages, page_size, self.device)
        self.slots = PagedKVCache(n_slots, n_pages, page_size, self.cache_len)
        self.n_slots = n_slots
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.max_queue = max_queue
        self.now = time.monotonic

        V = cfg.vocab_size
        self._last_logits = torch.zeros(n_slots, V, dtype=torch.float32, device=self.device)
        self._gen_mask = torch.zeros(n_slots, V, dtype=torch.bool, device=self.device)
        self._gens = [torch.Generator(device=self.device) for _ in range(n_slots)]
        self._active: List[Optional[_ActiveSlot]] = [None] * n_slots
        self._prefilling: Dict[int, _PrefillJob] = {}
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._dead: Optional[str] = None
        self.state = STARTING
        self.stats: Dict[str, float] = {
            "submitted": 0, "completed": 0, "rejected_queue_full": 0,
            "rejected_invalid": 0, "cancelled": 0, "expired": 0,
            "tokens_out": 0, "prefill_ticks": 0, "prefill_chunks": 0, "decode_ticks": 0,
            "poisoned_slots": 0, "peak_occupancy": 0,
        }
        self._ttft: deque = deque(maxlen=10_000)
        self._itl: deque = deque(maxlen=10_000)
        self._decode_s = 0.0
        self._started = self.now()

    # ------------------------------------------------------------- admission

    def _total_need_tokens(self, request: Request) -> int:
        """Worst-case cache positions the request can ever write."""
        return min(len(request.prompt) + request.max_new_tokens, self.cache_len)

    def _validate(self, request: Request) -> Optional[str]:
        T = len(request.prompt)
        if T < 1:
            return "empty prompt"
        if request.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in request.prompt):
            return f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
        # the final token is never fed back: the cache holds T + max_new - 1
        if T + request.max_new_tokens - 1 > self.cache_len:
            return (f"prompt ({T}) + max_new_tokens ({request.max_new_tokens}) "
                    f"exceeds cache_len ({self.cache_len})")
        if self.slots.blocks_for(self._total_need_tokens(request)) > self.slots.n_pages - 1:
            return (f"prompt ({T}) + max_new_tokens ({request.max_new_tokens}) needs more KV "
                    f"pages than the whole pool holds ({self.page_pool_tokens} positions)")
        return None

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, seed: int = 0,
               timeout: Optional[float] = None) -> RequestHandle:
        """Enqueue a request; returns its handle at once. ``timeout`` (seconds
        from now) sets the request's deadline. A full queue or an invalid
        request returns a handle already finished as ``rejected``."""
        now = self.now()
        deadline = None if timeout is None else now + timeout
        request = Request([int(t) for t in prompt], int(max_new_tokens), int(seed), deadline)
        handle = RequestHandle(request, next(self._ids), now)
        invalid = self._validate(request)
        with self._lock:
            if self._dead is not None:
                handle._finish(FAILED, now, error=self._dead)
                return handle
            self.stats["submitted"] += 1
            if invalid is not None:
                self.stats["rejected_invalid"] += 1
                handle._finish(REJECTED, now, error=invalid)
                return handle
            if len(self._queue) >= self.max_queue:
                self.stats["rejected_queue_full"] += 1
                handle._finish(REJECTED, now, error=f"queue full ({self.max_queue} waiting); retry later",
                               retryable=True)
                return handle
            self._queue.append(handle)
        return handle

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for a in self._active if a is not None)

    def _admit_chunked(self) -> None:
        """Claim a slot per admissible queued request and start its chunked
        prefill. Admission reserves the request's worst case in the page
        pool; when the pool cannot cover it the request waits at the head."""
        while self.slots.free_count:
            with self._lock:
                if not self._queue:
                    return
                handle = self._queue.popleft()
                need = self.slots.blocks_for(self._total_need_tokens(handle.request))
                if not self.slots.can_admit(need):
                    self._queue.appendleft(handle)
                    return
            slot = self.slots.acquire()
            self.slots.reserve(slot, self._total_need_tokens(handle.request))
            handle.admitted_at = self.now()
            handle.status = RUNNING
            self._prefilling[slot] = _PrefillJob(handle)

    # ------------------------------------------------------- chunked prefill

    def _prefill_tick(self) -> bool:
        """One prefill chunk for every mid-prefill slot, as one batched
        forward over those rows; slots whose prompt completes install into
        the decode set (their decode starts this same tick)."""
        if not self._prefilling:
            return False
        C, L = self.prefill_chunk, self.cache_len
        slots, tokens, starts, lens = [], [], [], []
        for slot, job in self._prefilling.items():
            prompt = job.handle.request.prompt
            # clamp the window to capacity: a final chunk near the cap
            # re-sends a few earlier tokens, whose K/V recompute identically
            w = min(job.fill, L - C)
            # pages cover only REAL prompt positions: the padded tail of the
            # window writes to the trash page through unmapped blocks
            if not self.slots.ensure(slot, min(w + C, len(prompt))):
                raise RuntimeError("KV page pool exhausted during prefill despite the admission reservation")
            window = list(prompt[w:w + C])
            slots.append(slot)
            tokens.append(window + [0] * (C - len(window)))
            starts.append(w)
            lens.append(len(prompt))
        dev = self.device
        with torch.no_grad():
            h = self.model.forward_paged(
                torch.tensor(tokens, dtype=torch.long, device=dev), self.pools,
                torch.from_numpy(self.slots.table[slots]).to(dev),
                torch.tensor(starts, dtype=torch.int32, device=dev),
            )
            last_idx = [min(max(n - 1 - s, 0), C - 1) for n, s in zip(lens, starts)]
            last = self.model.logits(h[torch.arange(len(slots), device=dev),
                                       torch.tensor(last_idx, device=dev)]).float()
        self.stats["prefill_ticks"] += 1
        self.stats["prefill_chunks"] += len(slots)
        completed = []
        for row, slot in enumerate(slots):
            job = self._prefilling[slot]
            job.fill = min(starts[row] + C, lens[row])
            if job.fill >= lens[row]:
                completed.append((row, slot))
        if completed:
            self._install_completed(completed, last)
        return True

    def _install_completed(self, completed, last: torch.Tensor) -> None:
        """Rows whose prefill finished get their last-position logits, a
        cleared penalty mask and a fresh generator seeded from the request."""
        rows = torch.tensor([r for r, _ in completed], device=self.device)
        dest = torch.tensor([s for _, s in completed], device=self.device)
        self._last_logits[dest] = last[rows]
        self._gen_mask[dest] = False
        t_done = self.now()
        for _, slot in completed:
            job = self._prefilling.pop(slot)
            self._gens[slot].manual_seed(job.handle.request.seed)
            job.handle.prefill_done_at = t_done
            self._active[slot] = _ActiveSlot(job.handle)
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], self.active_count)

    def _grow_decode_pages(self) -> None:
        """Extend each decoding slot's block table to cover this tick's
        write (its cursor + 1)."""
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            cursor = len(act.handle.request.prompt) + act.emitted
            if not self.slots.ensure(slot, min(cursor + 1, self.cache_len)):
                raise RuntimeError("KV page pool exhausted during decode despite the admission reservation")

    # ------------------------------------------------------------ retirement

    def _retire(self, finished: List[int]) -> None:
        self.slots.release(finished)
        for slot in finished:
            self._active[slot] = None

    def _sweep(self) -> None:
        """Finish cancelled / past-deadline requests, queued or running,
        at the tick boundary."""
        now = self.now()

        def verdict(handle):
            if handle._cancel.is_set():
                self.stats["cancelled"] += 1
                return CANCELLED, None
            if handle.request.deadline is not None and now > handle.request.deadline:
                self.stats["expired"] += 1
                return EXPIRED, "deadline expired"
            return None, None

        with self._lock:
            kept = deque()
            for handle in self._queue:
                status, err = verdict(handle)
                if status is None:
                    kept.append(handle)
                else:
                    handle._finish(status, now, error=err)
            self._queue = kept
        finished = []
        for slot, act in enumerate(self._active):
            if act is not None:
                status, err = verdict(act.handle)
                if status is not None:
                    act.handle._finish(status, now, error=err)
                    finished.append(slot)
        self._retire(finished)
        dropped = []
        for slot, job in self._prefilling.items():
            status, err = verdict(job.handle)
            if status is not None:
                job.handle._finish(status, now, error=err)
                dropped.append(slot)
        for slot in dropped:
            del self._prefilling[slot]
        self.slots.release(dropped)

    # ------------------------------------------------------------ decode tick

    def _decode(self):
        """The sampling tail, then one forward of every slot's sampled token:
        returns host (tokens [S], non-finite flags [S]) in one transfer."""
        S, dev = self.n_slots, self.device
        V = self.cfg.vocab_size
        uniforms = None
        if not self.sampling.greedy:
            # each slot draws from its own generator, so its trajectory does
            # not depend on its neighbours
            uniforms = torch.stack([
                torch.rand(V, generator=self._gens[s], device=dev) if self._active[s] is not None
                else torch.full((V,), 0.5, device=dev)
                for s in range(S)
            ])
        token = sample_token(self._last_logits, self.sampling, self._gen_mask, uniforms=uniforms)
        self._gen_mask[torch.arange(S, device=dev), token] = True
        cursors = [
            len(a.handle.request.prompt) + a.emitted if a is not None else 0 for a in self._active
        ]
        decoding = np.array([a is not None for a in self._active])
        table = self.slots.table * decoding[:, None]  # parked rows: trash page
        logits = self.model.logits(self.model.forward_paged(
            token[:, None], self.pools, torch.from_numpy(table).to(dev),
            torch.tensor(cursors, dtype=torch.int32, device=dev),
        )[:, 0]).float()
        bad = ~torch.isfinite(logits).all(dim=-1)
        self._last_logits = logits
        host = torch.cat([token, bad.long()]).cpu().tolist()
        return host[:S], host[S:]

    def step(self) -> bool:
        """One scheduler tick: sweep, admit, one prefill chunk per
        mid-prefill slot, grow decode pages, decode every slot, emit,
        retire. Returns False when there was nothing to do."""
        self._sweep()
        self._admit_chunked()
        ran_prefill = self._prefill_tick()
        self._grow_decode_pages()
        if self.active_count == 0:
            return ran_prefill
        t0 = self.now()
        with torch.no_grad():
            tokens, bad_rows = self._decode()
        now = self.now()
        self._decode_s += now - t0
        self.stats["decode_ticks"] += 1
        finished: List[int] = []
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            if act.emitted == 0:
                self._ttft.append(now - act.handle.submitted_at)
            elif act.last_emit_at is not None:
                self._itl.append(now - act.last_emit_at)
            # the token was sampled from the PREVIOUS (finite) logits, so it
            # is valid even when this tick's logits went bad
            t = int(tokens[slot])
            act.handle._emit(t, now)
            act.emitted += 1
            act.last_emit_at = now
            self.stats["tokens_out"] += 1
            hit_eos = self.eos_token_id is not None and t == self.eos_token_id
            if hit_eos or act.emitted >= act.handle.request.max_new_tokens:
                act.handle._finish(DONE, now)
                self.stats["completed"] += 1
                finished.append(slot)
            elif bad_rows[slot]:
                act.handle._finish(FAILED, now, error="non-finite logits in decode (retryable)",
                                   retryable=True)
                self.stats["poisoned_slots"] += 1
                finished.append(slot)
        if any(bad_rows):
            # a parked slot must never feed NaN into the next tick's sample
            keep = torch.tensor([not b for b in bad_rows], device=self.device)
            self._last_logits = torch.where(keep[:, None], self._last_logits, 0.0)
        self._retire(finished)
        return True

    # --------------------------------------------------------------- drivers

    def run(self, stop: threading.Event, idle_sleep: float = 0.001) -> None:
        """Scheduler loop for a background thread: step until ``stop``. A
        scheduler exception fails every outstanding request loudly (so no
        client waits forever), then re-raises."""
        self.state = READY
        while not stop.is_set():
            try:
                busy = self.step()
            except Exception as exc:
                self._abort(f"scheduler died: {exc!r}")
                raise
            if not busy:
                time.sleep(idle_sleep)
        self._abort("engine stopped")

    def _abort(self, reason: str) -> None:
        now = self.now()
        self.state = STOPPED
        with self._lock:
            self._dead = reason
            queued, self._queue = list(self._queue), deque()
        for handle in queued:
            handle._finish(FAILED, now, error=reason)
        for slot, act in enumerate(self._active):
            if act is not None:
                act.handle._finish(FAILED, now, error=reason)
                self._active[slot] = None
        for slot in sorted(self._prefilling):
            self._prefilling.pop(slot).handle._finish(FAILED, now, error=reason)

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        """Drive the scheduler synchronously until queue and slots drain."""
        for _ in range(max_ticks):
            if not self.step() and self.queue_depth == 0:
                return
        raise RuntimeError(f"engine not idle after {max_ticks} ticks")

    # --------------------------------------------------------------- metrics

    def metrics_snapshot(self) -> Dict[str, object]:
        """Serving metrics: latencies in milliseconds (host clock around work
        that ends in a device sync), decode tokens per second of decode-tick
        time, and each kernel's launch count."""
        elapsed = max(self.now() - self._started, 1e-9)
        snap: Dict[str, object] = {
            "state": self.state,
            "device": str(self.device),
            "tokens_per_sec": self.stats["tokens_out"] / elapsed,
            "decode_tok_s": self.stats["tokens_out"] / self._decode_s if self._decode_s else 0.0,
            "slot_occupancy": self.active_count,
            "prefilling": len(self._prefilling),
            "queue_depth": self.queue_depth,
            "page_pool_util": self.slots.page_pool_util,
            "page_pool_peak": self.slots.pool.peak_in_use,
            "kernel_launches": dict(_build.LAUNCHES),
        }
        for name, samples in (("ttft_ms", self._ttft), ("itl_ms", self._itl)):
            for key, value in _percentiles(list(samples)).items():
                snap[f"{name}_{key}"] = value * 1e3
        snap.update(self.stats)
        return snap
