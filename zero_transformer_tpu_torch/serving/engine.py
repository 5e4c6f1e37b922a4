"""Continuous-batching scheduler over the paged KV cache, with serving's
policy layer.

Counterpart of ``zero_transformer_tpu/serving/engine.py``, on its paged
layout (``kv_layout="paged"``, chunked prefill, the default) and its slab
layout (below):

- ``Request``/``RequestHandle``, ``submit`` behind a bounded per-class
  queue (``qos.ClassQueue``: deficit-weighted round-robin over the gold /
  standard / batch classes, per-tenant token buckets, slot and page floors,
  queue-full shedding of a lower class, the brownout rungs, and the
  infeasible-deadline shed);
- chunked admission (``_admit_chunked`` :1730) with the PREFIX CACHE
  (``prefix_cache.PagedPrefixIndex``): a hit maps the cached pages into the
  slot's block table by refcount and the prefill starts at the first novel
  chunk, whose attention reads the shared pages (K1 with ``q_offset`` at
  the hit); a completed prefill banks its chunk-aligned pages before the
  first decode write (``_bank_prefix`` :2163); a pool that cannot cover an
  admission reclaims cold prefix pages once (a page fault) and otherwise
  leaves the request at the queue head;
- the chunked-prefill tick (``_prefill_tick`` :1901), decode page growth
  with the copy-on-write guard (``_grow_decode_pages`` :3144), the decode
  tick (``step`` :2291: the sampling tail, then the forward, with the
  per-row non-finite guard), the speculative tick of ``draft_k``
  (``_spec_step_impl`` :679, ``_dispatch_spec`` :2539), retirement on
  ``max_new_tokens``/EOS;
- resilience (``serving/resilience.py``): the ``Lifecycle`` that
  ``/healthz`` reflects; a supervised decode tick whose fault fails only
  that tick's slots, retryably, and rebuilds the device state (fresh pools,
  a fresh ``PagedKVCache`` and prefix index), with a circuit breaker that
  goes DEGRADED at its threshold, self-probes back to READY when idle and
  aborts after ``max_rebuilds`` consecutive rebuilds; prefill faults fail
  only the prefilling slots; ``begin_drain``/``poll_drain`` (SIGTERM);
  ``reload_params`` (SIGHUP, ``POST /admin/reload``), validated off the
  tick thread and swapped between ticks with no slot retired and the
  prefix cache flushed;
- observability (``obs/``): each request's span tree (``request`` over
  ``queue``/``prefill``/``decode``, keyed by its request id) and the
  engine's per-tick spans in a ``Tracer``; a ``FlightRecorder`` dumped on a
  breaker trip, a drain and an abort; ``request_profile`` (a
  ``torch.profiler`` window of N ticks); ``metrics_snapshot`` and the
  Prometheus text of ``prometheus_text``, with JAX's family names.

PyTorch runs eagerly, so the prefill chunk runs over the prefilling rows
only (the JAX program is fixed-shape over every slot and routes the other
rows to the trash page). The decode tick runs over every slot, as in JAX:
rows that are not decoding ride along with a zeroed block table (the trash
page) at position 0, and their outputs are discarded.

With ``draft_k`` K > 0 every decode tick is speculative: it samples one
token per row as the plain tick does (masking the row's veto after the
logit processors), then verifies K host-proposed drafts per row
(``ngram_propose(history, K)`` or the engine's ``draft_fn``) in one
``[S, K + 1]`` forward over the paged pools. Greedy keeps a draft while it
equals the processed argmax; sampling accepts draft ``d`` with probability
``p(d)`` and, at the first rejection, carries ``d`` as the row's veto into
the next tick's sample (the residual of a point-mass draft), so the emitted
process is plain sampling's. A row emits its token and its accepted drafts;
its cursor is its prompt plus what it emitted, so the rejected positions
are rewritten by the next tick. A row whose verify logits are not all
finite emits only its first token. The repetition penalty must be 1.0 (it
would make positions inside a block depend on each other).

Disaggregated roles and stream migration (JAX :2054-2112, :2624-3142): a
``prefill`` replica runs only chunked prefill and ships every finished
stream to the decode replica its request names (``prefill_to``): the
pages covering the prompt, the logits row at ``true_len - 1``, a cleared
penalty mask and the sampling generator's state; a ``decode`` replica
serves imported streams (and plain requests, the recompute fallback);
``mixed`` is the standalone replica. ``request_migration`` and
``request_migrate_all`` move live streams, mid-decode (pages over prompt
+ emitted and the decode carry) or mid-prefill (the finished chunks'
pages and the fill cursor), between ticks. A ship goes through the
``page_shipper`` seam (the server POSTs it to ``<target>/ingest``); its
handle stays running until the ship is acknowledged, then finishes
``migrated`` (``migrated_to`` names the new home), or retryably ``failed``
with a flight-recorder dump. ``import_stream`` (any thread) validates a
payload and queues it; the tick thread places imports ahead of normal
admission (waiting at the head of their queue on pool pressure), copies
the pages in and installs the carry, so the destination recomputes no
token. The generator's state (``get_state()``) rides as
``carry/torch_rng``: a sampled stream moved between port replicas draws
what it would have drawn unmoved. JAX's ``carry/rng`` (its
``PRNGKey(seed)``) rides too, so a JAX replica accepts the payload; an
import without ``carry/torch_rng`` (a JAX peer's) seeds from the request's
seed, so across packages only greedy streams continue equal.

The slab layout (``kv_layout="slab"``, JAX's ``SlotKVCache``): each slot
owns a fixed row of ``cache_len`` positions, the pools seen through a fixed
identity table (``slots.SlotKVCache``), so K1 and K4 run over it as over
pages. With ``prefill_chunk=0`` each admitted prompt prefills in one
forward (``_admit_oneshot`` :1822, ``_prefill_padded`` :1668), right-padded
to a power-of-two bucket of at least 8 (``_bucket`` :1640, at most
``max_prefill_buckets`` distinct ones) and written straight into its slot's
rows: JAX prefills into a one-row cache and inserts it, which the port has
no need for. With a chunk the slab prefills chunk by chunk, and the prefix
cache copies K/V spans out of a finished prompt's row and into a hit's row
(JAX :1774, :2190) instead of mapping pages. A slab engine has nothing to
migrate: ``request_migration`` is False, ``request_migrate_all`` 0 and an
import is rejected, as in JAX. The decode tick runs K4 over the slab (in
JAX slab decode takes XLA's attention).

Tensor-parallel serving (JAX's ``mesh=`` :856,988, a single controller over
N chips) is SPMD here: an engine whose model holds a ``TensorGroup`` of N
ranks (``models/gpt.py``) runs on every rank. Rank 0 owns the scheduler,
the host state and HTTP; the other ranks run ``serve_worker``. Before each
device program rank 0 broadcasts a small plan (``_plan``): the op, its
tokens, offsets, block-table rows and the rows whose logits it needs, or a
page copy, a device-state rebuild, a hot reload (rank 0's whole tensors
then go out one at a time, ``scatter_for_inference``), or stop (and, from an idle tick, a no-op every ``heartbeat_s``, so the others'
wait for the next plan never reaches the collective timeout); every rank
then runs the same program over its shard of the weights and
its ``KVH / N`` kv heads of the pools, so the layers' all-reduces pair up.
The logits come back whole on every rank (gathered over the vocabulary)
and only rank 0 samples, so each stream is drawn once. The roles, the
page-span export and import, migration and the slab's span copies of the
prefix cache raise under a group of N > 1, before any weight loads.

``fused_tail=False`` is JAX's A/B control (``_dispatch_defused`` :2603):
the tick's sampled tokens come to the host and go back up before the
forward, one more host sync a tick, with the same draws in the same order,
so the streams are byte-identical to the fused tick's.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import queue as queue_mod
import re
import threading
import time
import traceback
import uuid
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from zero_transformer_tpu_torch.config import resolve_device
from zero_transformer_tpu_torch.inference.generate import SLAB_PAGE, allocate_pools, decode_model, \
    scatter_for_inference, shard_for_inference
from zero_transformer_tpu_torch.inference.sampling import NEG_INF, SamplingConfig, draw, process_logits, sample_token
from zero_transformer_tpu_torch.inference.speculative import ngram_propose
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.obs import LATENCY_BUCKETS, FlightRecorder, ProfileWindow, Registry, Tracer
from zero_transformer_tpu_torch.obs.logging import hbm_device_stats
from zero_transformer_tpu_torch.ops import _build
from zero_transformer_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache
from zero_transformer_tpu_torch.serving.qos import BROWNOUT_RUNGS, ClassQueue, QosPolicy, TenantBuckets, \
    reserved_above, rung_at_least
from zero_transformer_tpu_torch.serving.resilience import DEGRADED, DRAINING, READY, STARTING, STOPPED, \
    CircuitBreaker, ItlEwma, Lifecycle, ReloadError, infeasible_deadline, validate_reload
from zero_transformer_tpu_torch.serving.slots import PagedKVCache, SlotKVCache
from zero_transformer_tpu_torch.serving.wire import as_host_tensor

__all__ = ["STARTING", "READY", "DEGRADED", "DRAINING", "STOPPED", "MIGRATED", "ROLES", "Request", "RequestHandle",
           "ServingEngine"]

# characters stripped from client-supplied request ids (the usual trace-id
# alphabets: alnum plus - _ . : / =); the id is echoed into a header
_RID_UNSAFE = re.compile(r"[^A-Za-z0-9._:/=-]")

# request states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
EXPIRED = "expired"
REJECTED = "rejected"
FAILED = "failed"
# the stream now lives on another replica (``RequestHandle.migrated_to``)
MIGRATED = "migrated"
_FINISHED = (DONE, CANCELLED, EXPIRED, REJECTED, FAILED, MIGRATED)

# engine roles of a disaggregated fleet (the module doc)
ROLES = ("mixed", "prefill", "decode")


def check_tensor_serving(role: str, kv_layout: str, prefix_cache_chunks: int) -> None:
    """Raise on what the engine does not run under a tensor group of N > 1
    (ROADMAP Queue 1 item 13): the disaggregated roles (and with them the
    page-span export and import that migration ships) and the slab's
    prefix cache, whose span copies live in rank 0's host index."""
    if role != "mixed":
        raise NotImplementedError(f"role={role!r} under tensor parallelism is not ported yet (ROADMAP Queue 1 "
                                  "item 13): page spans and migration ship one rank's pools")
    if kv_layout == "slab" and prefix_cache_chunks:
        raise NotImplementedError("the slab layout's prefix cache under tensor parallelism is not ported yet "
                                  "(ROADMAP Queue 1 item 13): pass --prefix-cache 0 or the paged layout")


@dataclasses.dataclass
class Request:
    """One generation request, in token-id space."""

    prompt: Sequence[int]
    max_new_tokens: int
    seed: int = 0
    # absolute deadline on the engine's clock; None = no deadline
    deadline: Optional[float] = None
    # the decode replica the finished prefill ships to instead of decoding
    # here (required on a prefill-role engine)
    prefill_to: Optional[str] = None
    # the billing identity and QoS class this request admits under
    tenant: str = "anon"
    qos: str = "standard"


class RequestHandle:
    """Thread-safe view of a submitted request: token stream + final state."""

    def __init__(self, request: Request, rid: int, submitted_at: float, request_id: Optional[str] = None):
        self.request = request
        self.id = rid
        # correlation id: client-supplied (X-Request-Id), sanitized to a
        # safe header charset, or generated
        if request_id:
            self.rid = _RID_UNSAFE.sub("", str(request_id))[:128] or uuid.uuid4().hex
        else:
            self.rid = uuid.uuid4().hex
        self.submitted_at = submitted_at
        self.status = QUEUED
        self.tokens: List[int] = []
        self.first_token_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.prefill_done_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[str] = None
        # a failure the client should retry (the server answers 503/429
        # with Retry-After)
        self.retryable = False
        self.retry_after: Optional[float] = None
        # status ``migrated``: the replica URL now serving the stream
        self.migrated_to: Optional[str] = None
        # the router's hop index of this dispatch (X-Trace-Hop)
        self.trace_hop: Optional[int] = None
        # prompt tokens a prefix-cache hit covered at admission
        self.prefix_hit_tokens = 0
        self._tracer: Optional[Tracer] = None
        # per-request cost ledger (the tick thread bumps the counters)
        self.ledger: Dict[str, int] = {
            "prefill_chunks": 0, "decode_ticks": 0, "tokens_out": 0,
            "draft_tokens": 0, "accepted_tokens": 0, "pages_held_ticks": 0, "migrations": 0,
        }
        # milliseconds a migrated stream spent on its earlier hops
        self._ledger_ms_base = {"queue_ms": 0.0, "prefill_ms": 0.0, "decode_ms": 0.0}
        self._events: queue_mod.Queue = queue_mod.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()
        # bounded emit buffer: once a streaming consumer attached and stops
        # draining, token events past emit_buffer_max are dropped and the
        # scheduler finishes the stream retryably (the done event always
        # delivers)
        self.emit_buffer_max: int = 1024
        self.consumer_attached = False
        self.overflowed = False

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

    def ledger_snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The cost ledger as the terminal event reports it: the counters
        plus the queue/prefill/decode milliseconds from the lifecycle
        timestamps (up to ``now`` for a live snapshot, as a migration export
        takes it), added to what earlier hops of a migrated stream spent."""
        sub, adm, pre, fin = self.submitted_at, self.admitted_at, self.prefill_done_at, self.finished_at
        end = fin if fin is not None else (now if now is not None else (pre or adm or sub))
        queue_ms = ((adm if adm is not None else end) - sub) * 1e3
        prefill_ms = ((pre if pre is not None else end) - adm) * 1e3 if adm is not None else 0.0
        decode_ms = (end - pre) * 1e3 if pre is not None else 0.0
        base = self._ledger_ms_base
        return {
            **{k: int(v) for k, v in self.ledger.items()},
            "queue_ms": round(base["queue_ms"] + max(0.0, queue_ms), 3),
            "prefill_ms": round(base["prefill_ms"] + max(0.0, prefill_ms), 3),
            "decode_ms": round(base["decode_ms"] + max(0.0, decode_ms), 3),
        }

    def _emit(self, token: int, now: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = now
        self.tokens.append(token)
        if self.consumer_attached and self._events.qsize() >= self.emit_buffer_max:
            self.overflowed = True  # the scheduler finishes the stream this tick
            return
        self._events.put(("token", token))

    def _finish(self, status: str, now: float, error: Optional[str] = None, retryable: bool = False,
                retry_after: Optional[float] = None) -> None:
        self.status = status
        self.error = error
        self.retryable = retryable
        self.retry_after = retry_after
        self.finished_at = now
        if self._tracer is not None and self._tracer.enabled:
            self._emit_spans(now)
        self._events.put(("done", status))
        self._done.set()

    def _emit_spans(self, fin: float) -> None:
        """The request's span tree from its lifecycle timestamps: root
        ``request`` [submitted, finished], partitioned by ``queue``,
        ``prefill`` and ``decode`` as far as the request got."""
        tr = self._tracer
        sub, adm, pre = self.submitted_at, self.admitted_at, self.prefill_done_at
        attrs: Dict[str, Any] = {"id": self.rid, "outcome": self.status, "tokens": len(self.tokens)}
        if self.trace_hop is not None:
            attrs["hop"] = self.trace_hop
        if self.error:
            attrs["error"] = self.error
        tr.add("request", self.rid, sub, fin, attrs)
        tr.add("queue", self.rid, sub, adm if adm is not None else fin, None)
        if adm is not None:
            tr.add("prefill", self.rid, adm, pre if pre is not None else fin, None)
        if pre is not None:
            tr.add("decode", self.rid, pre, fin, None)


@dataclasses.dataclass
class _ActiveSlot:
    handle: RequestHandle
    emitted: int = 0
    last_emit_at: Optional[float] = None


@dataclasses.dataclass
class _PrefillJob:
    """A slot mid-chunked-prefill: ``fill`` prompt tokens have K/V in the
    slot's pages (a prefix hit's shared pages included)."""

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


# the stats counters exported as serve_<key>_total, JAX's families
_COUNTER_HELP = (
    ("submitted", "Requests submitted (accepted + rejected)"),
    ("completed", "Requests finished with status done"),
    ("rejected_queue_full", "Admission rejections: queue full"),
    ("rejected_invalid", "Admission rejections: invalid request"),
    ("rejected_draining", "Admission rejections while draining"),
    ("shed_infeasible", "Deadline-infeasible sheds at admission"),
    ("expired_queued", "Deadline expiries while queued"),
    ("expired_prefilling", "Deadline expiries during prefill"),
    ("expired_decoding", "Deadline expiries mid-decode"),
    ("cancelled", "Client cancellations honored"),
    ("tokens_out", "Tokens emitted to clients"),
    ("tick_faults", "Supervised decode-tick faults"),
    ("poisoned_slots", "Slots retired by the non-finite guard"),
    ("breaker_trips", "Circuit-breaker trips (DEGRADED + rebuild)"),
    ("drain_forced", "Generations force-finished at drain deadline"),
    ("reloads", "Hot weight reloads swapped in"),
    ("reloads_rejected", "Hot weight reloads rejected"),
    ("prefill_chunks", "Chunk-prefill row dispatches"),
    ("prefill_faults", "Supervised chunk-prefill faults"),
    ("prefill_bucket_capped", "One-shot prefill bucket-cap events"),
    ("page_faults", "Page-pool exhaustions that reclaimed prefix pages"),
    ("pages_reclaimed", "Prefix-cache pages reclaimed under pressure"),
    ("preemptions", "Requests preempted for KV pages (last resort)"),
    ("spec_ticks", "Speculative decode ticks"),
    ("draft_tokens", "Draft tokens proposed"),
    ("accepted_tokens", "Draft tokens accepted by verify"),
    ("migrations_out", "Streams shipped to another replica"),
    ("migrations_in", "Migrated streams imported and continued"),
    ("migration_failures", "Ship failures (fell back to recompute)"),
    ("prefill_handoffs", "Disaggregated prefill-to-decode handoffs"),
    ("import_replayed_tokens", "Tokens recomputed by imported streams (0 by construction)"),
    ("rejected_quota", "Admission rejections: tenant quota exhausted"),
    ("rejected_brownout", "Admission rejections: brownout suspended the class"),
    ("shed_lower_class", "Queue-full sheds that evicted a lower QoS class"),
    ("preempted_for_class", "Running streams preempted for a waiting higher class"),
    ("brownout_transitions", "Brownout rung transitions"),
    ("stalled_streams", "Streams retired because the client stalled (emit overflow)"),
)


class ServingEngine:
    """Slot-scheduled continuous batching over the paged or slab KV cache.

    ``model`` is a ``Transformer`` already on ``device`` (CUDA unless the
    caller asks for the CPU); its Dense and embedding weights are cast to
    the compute dtype once (``cast_for_inference``). Sampling settings are
    engine-level, like the JAX engine's; requests vary prompt, token
    budget, seed, deadline, tenant and QoS class. ``prefix_cache_chunks``
    > 0 turns the prefix cache on (the serve CLI's default is 256, JAX's
    ``ServingConfig``; the engine's own default is 0, as JAX's engine).
    ``draft_k`` > 0 makes every decode tick speculative (the module doc);
    ``draft_fn(history, k)`` replaces the prompt-lookup proposer. ``clock``
    is the engine's clock (deadlines, latencies, drain), injectable for
    tests; ``chaos`` a ``ServingChaosMonkey``; ``qos`` a ``QosPolicy`` or
    its config dict (None: the inert defaults). ``role`` is ``mixed``,
    ``prefill`` or ``decode`` (the module doc); ``page_shipper(payload,
    target, on_done)`` ships an exported stream and calls ``on_done(None)``
    once the target accepted it, ``on_done(reason)`` otherwise (the server
    installs one that POSTs to ``<target>/ingest``). ``kv_layout`` is
    ``paged`` (the engine's default) or ``slab``; only slab takes
    ``prefill_chunk=0``, the one-shot prefill, with at most
    ``max_prefill_buckets`` distinct buckets; ``fused_tail=False`` is the
    A/B control (the module doc)."""

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
        draft_k: int = 0,
        draft_fn: Optional[Callable[[Sequence[int], int], List[int]]] = None,
        device="cuda",
        prefix_cache_chunks: int = 0,
        metrics=None,
        metrics_interval: int = 0,
        clock: Callable[[], float] = time.monotonic,
        breaker_threshold: int = 3,
        max_rebuilds: int = 3,
        shed_warmup: int = 8,
        chaos=None,
        obs_dir: Optional[str] = None,
        trace: bool = True,
        qos=None,
        emit_buffer_max: int = 1024,
        role: str = "mixed",
        page_shipper: Optional[Callable[..., None]] = None,
        kv_layout: str = "paged",
        max_prefill_buckets: int = 8,
        fused_tail: bool = True,
    ):
        self.device = resolve_device(device)
        cfg = model.cfg
        self.cfg = cfg
        self.cache_len = cache_len or cfg.max_seq_len
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = one-shot prefill)")
        if prefix_cache_chunks < 0:
            raise ValueError("prefix_cache_chunks must be >= 0 (0 disables)")
        if prefix_cache_chunks > 0 and prefill_chunk == 0:
            raise ValueError("prefix caching requires chunked prefill (prefill_chunk > 0): entries are keyed on "
                             "chunk-aligned token spans")
        if max_prefill_buckets < 1:
            raise ValueError("max_prefill_buckets must be >= 1")
        # a chunk larger than the cache degenerates to cache-sized windows
        self.prefill_chunk = min(prefill_chunk, self.cache_len)
        self.max_prefill_buckets = max_prefill_buckets
        if kv_layout not in ("slab", "paged"):
            raise ValueError(f"kv_layout must be 'slab' or 'paged', got {kv_layout!r}")
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            if self.prefill_chunk == 0:
                raise ValueError("kv_layout='paged' requires chunked prefill (prefill_chunk > 0): the one-shot "
                                 "prefill has no block-table path")
            if page_size < 1 or self.cache_len % page_size:
                raise ValueError(f"page_size ({page_size}) must divide cache_len ({self.cache_len})")
            if self.prefill_chunk % page_size:
                raise ValueError(f"page_size ({page_size}) must divide prefill_chunk ({self.prefill_chunk})")
            if page_pool_tokens == 0:
                page_pool_tokens = n_slots * self.cache_len  # the slab-equivalent budget
            if page_pool_tokens % page_size:
                raise ValueError(f"page_pool_tokens ({page_pool_tokens}) must be a multiple of page_size "
                                 f"({page_size})")
        else:
            # the slab's rows seen as pages of SLAB_PAGE positions (JAX's
            # slab has no page size, so ``page_size`` is not read)
            page_size, page_pool_tokens = SLAB_PAGE, 0
        # fused_tail=False is the A/B control: the tick brings its sampled
        # tokens to the host and uploads them before the forward
        self.fused_tail = bool(fused_tail)
        if not self.fused_tail and draft_k:
            raise ValueError("fused_tail=False (the A/B control) covers the plain decode path only; speculative "
                             "verify (draft_k > 0) is inseparable from its in-program sampling")
        if draft_k < 0:
            raise ValueError("draft_k must be >= 0 (0 disables speculation)")
        if draft_k and sampling.repetition_penalty != 1.0:
            raise ValueError(
                "speculative serving (draft_k > 0) requires repetition_penalty == 1.0: the penalty makes "
                "in-block positions interdependent (one-shot generate_speculative emulates it; the batched "
                "verify step does not)"
            )
        self.draft_k = int(draft_k)
        self.draft_fn = draft_fn or ngram_propose
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if role != "mixed" and kv_layout != "paged":
            raise ValueError(f"role={role!r} requires kv_layout='paged': KV pages are the unit that ships between "
                             "disaggregated replicas")
        if role == "prefill" and draft_k:
            raise ValueError("role='prefill' replicas never decode; draft_k must be 0")
        self.role = role
        self.page_shipper = page_shipper
        # the tensor group (None: one rank); rank 0 leads, the others follow its plans
        self._tp = getattr(model, "tp", None)
        self.leader = self._tp is None or self._tp.rank == 0
        self._workers_stopped = False
        self._last_plan = time.monotonic()
        # an exception inside a device program under a tensor group: the
        # ranks are no longer in step, so it is fatal (_check_tensor_fault)
        self.tp_fault: Optional[BaseException] = None
        if self._tp is not None:
            check_tensor_serving(role, kv_layout, prefix_cache_chunks)
        if next(model.parameters()).device != self.device:
            raise ValueError(f"model lives on {next(model.parameters()).device}, engine on {self.device}")
        self.page_size = page_size
        self.page_pool_tokens = page_pool_tokens
        if kv_layout == "paged":
            self.n_pages = page_pool_tokens // page_size + 1  # + trash page
            model = decode_model(model, self.cache_len, (self.n_pages, page_size))
        else:
            self.n_pages = 1 + n_slots * -(-self.cache_len // page_size)  # + trash page
        self.model = model.cast_for_inference()
        self.n_slots = n_slots
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.max_queue = max_queue
        self.now = clock
        self.metrics = metrics
        self.metrics_interval = metrics_interval
        self._prefix_cache_chunks = int(prefix_cache_chunks)
        self.pools = None
        self.slots = None  # a PagedKVCache, or a SlotKVCache when slab
        self._prefix_cache: Optional[PrefixCache] = None
        # the distinct one-shot prefill buckets used (bounded by
        # max_prefill_buckets + the capacity bucket)
        self._buckets_seen: set = set()
        self._active: List[Optional[_ActiveSlot]] = [None] * n_slots
        self._prefilling: Dict[int, _PrefillJob] = {}
        self._allocate_device_state()
        # device bytes of the KV pools (scales included) and of the weights
        # as served (int8 ones at one byte each)
        self.kv_pool_bytes = sum(p.nbytes for p in self.pools)
        self.weight_bytes = sum(t.numel() * t.element_size() for t in self.model.state_dict().values())

        # QoS: the declared class policy (inert defaults without a config),
        # per-(tenant, class) buckets, and the per-class DWRR queue
        self.qos = qos if isinstance(qos, QosPolicy) else QosPolicy.from_config(qos)
        self._tenant_buckets = TenantBuckets(self.qos)
        self.emit_buffer_max = max(1, int(emit_buffer_max))
        self._queue = ClassQueue(self.qos, cost=lambda h: self._total_need_tokens(h.request),
                                 class_of=lambda h: h.request.qos)
        self._brownout_rung = BROWNOUT_RUNGS[0]
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._tick = 0
        self._dead: Optional[str] = None
        self._prefill_work = False
        # migration: imports awaiting placement (handle, payload), the live
        # streams tagged to move (request id, or "*" for all -> target), the
        # exported streams awaiting their ship's answer
        self._pending_imports: deque = deque()
        self._migrate_requests: Dict[str, str] = {}
        self._migrating: Dict[int, RequestHandle] = {}
        self._migrations_in_flight = 0

        # resilience
        self.lifecycle = Lifecycle(clock)
        self._breaker = CircuitBreaker(breaker_threshold)
        self.max_rebuilds = max_rebuilds
        self._rebuilds_since_recovery = 0
        self._itl_ewma = ItlEwma(warmup=shed_warmup)
        self._chaos = chaos
        self._pending_params = None
        self._last_reload_event: Optional[threading.Event] = None
        self._drain_deadline: Optional[float] = None
        self._drain_started: Optional[float] = None
        self.drain_latency_s: Optional[float] = None

        self.stats: Dict[str, Any] = {key: 0 for key, _ in _COUNTER_HELP}
        self.stats.update({"peak_occupancy": 0, "peak_queue_depth": 0, "prefill_ticks": 0, "decode_ticks": 0})

        # observability: spans, the Prometheus registry, the flight
        # recorder, profile windows; latency samples in fixed-bucket
        # histograms (Prometheus) and in bounded deques (the JSON
        # snapshot's exact percentiles)
        self.obs_dir = str(obs_dir) if obs_dir else None
        self.tracer = Tracer(enabled=trace, clock=clock)
        self.registry = Registry()
        self.flight = FlightRecorder(directory=self.obs_dir, tracer=self.tracer, clock=clock)
        self._profiler = ProfileWindow(str(Path(self.obs_dir) / "profiles") if self.obs_dir else None)
        hist = self.registry.histogram
        self._h_ttft = hist("serve_ttft_seconds", "Submit-to-first-token latency (queue wait included)",
                            LATENCY_BUCKETS)
        self._h_itl = hist("serve_itl_seconds", "Inter-token latency, all decode ticks", LATENCY_BUCKETS)
        self._h_itl_decode = hist("serve_itl_decode_seconds",
                                  "Inter-token latency on ticks with no prefill work (decode floor)", LATENCY_BUCKETS)
        self._h_queue_wait = hist("serve_queue_wait_seconds", "Submit-to-slot-admission wait", LATENCY_BUCKETS)
        self._h_prefill = hist("serve_prefill_seconds", "Admission-to-install prefill latency (prefix hits included)",
                               LATENCY_BUCKETS)
        self._h_ttft_class = {name: hist(f"serve_ttft_seconds_{name}", f"Submit-to-first-token latency, {name} class",
                                         LATENCY_BUCKETS) for name in self.qos.names()}
        self._h_itl_class = {name: hist(f"serve_itl_seconds_{name}", f"Inter-token latency, {name} class",
                                        LATENCY_BUCKETS) for name in self.qos.names()}
        self._ttft: deque = deque(maxlen=10_000)
        self._itl: deque = deque(maxlen=10_000)
        self._itl_decode: deque = deque(maxlen=10_000)
        self._decode_s = 0.0
        self._register_exports()
        self._started = self.now()

    # ----------------------------------------------------- device-state build

    def _allocate_device_state(self) -> None:
        """Pools, slot bookkeeping, the prefix index over them, and the
        per-slot sampling carries: built at start and by every rebuild. The
        caller has dropped every reference to the old state first."""
        S, V, dev = self.n_slots, self.cfg.vocab_size, self.device
        self.pools = allocate_pools(self.cfg, self.n_pages, self.page_size, dev,
                                    kv_heads=self.model.blocks[0].attn.kv_heads)
        if self.kv_layout == "paged":
            self.slots = PagedKVCache(S, self.n_pages, self.page_size, self.cache_len)
            # page-id entries refcounted against THIS pool instance: rebuilt
            # whenever the pool is (a reload keeps the pool and only flushes)
            self._prefix_cache = (PagedPrefixIndex(self.prefill_chunk, self._prefix_cache_chunks, self.slots.pool)
                                  if self._prefix_cache_chunks else None)
        else:
            self.slots = SlotKVCache(S, self.cache_len, self.page_size)
            # span copies: they hold their own K/V, valid for the weights
            # that made them (a reload flushes)
            self._prefix_cache = (PrefixCache(self.prefill_chunk, self._prefix_cache_chunks)
                                  if self._prefix_cache_chunks else None)
        self._last_logits = torch.zeros(S, V, dtype=torch.float32, device=dev)
        self._gen_mask = torch.zeros(S, V, dtype=torch.bool, device=dev)
        self._gens = [torch.Generator(device=dev) for _ in range(S)]
        # the draft each row rejected last tick, masked out of its next sample (-1: none)
        self._veto = torch.full((S,), -1, dtype=torch.long, device=dev)

    # ------------------------------------------------------- device programs

    def _plan(self, op: str, tensors: Sequence[torch.Tensor] = (), **meta) -> None:
        """Rank 0 of a tensor group: announce a device program to the other
        ranks (the op, its scalars, then its tensors); a no-op on one rank."""
        if self._tp is None:
            return
        self._last_plan = time.monotonic()
        self._tp.broadcast_object((op, meta, [(tuple(t.shape), t.dtype) for t in tensors]))
        self._tp.broadcast_([t.to(self.device) for t in tensors])

    def forward_logits(self, tokens: torch.Tensor, table: torch.Tensor, offsets: torch.Tensor,
                       flash: bool = False, pick: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The engine's one device program over the pools: ``tokens`` [B, T]
        at ``offsets`` [B] through the block-table rows ``table``, then the
        float32 logits of the positions ``pick`` [B] (one a row), or of
        every position (None). Under a tensor group rank 0 announces it
        first and every rank runs it over its shard."""
        try:
            self._plan("forward", [t for t in (tokens, table, offsets, pick) if t is not None], flash=flash,
                       pick=pick is not None)
            return self._forward_logits(tokens, table, offsets, flash, pick)
        except Exception as exc:
            if self._tp is not None:
                self.tp_fault = exc
            raise

    def _forward_logits(self, tokens, table, offsets, flash, pick):
        h = self.model.forward_paged(tokens, self.pools, table, offsets, self.cache_len, flash=flash)
        if pick is not None:
            h = h[torch.arange(h.shape[0], device=h.device), pick]
        return self.model.logits(h).float()

    def serve_worker(self) -> None:
        """A tensor group's rank > 0: run rank 0's plans until it says stop.
        An exception ends the loop (and the worker's process): rank 0's
        launcher brings the server down with it."""
        if self.leader:
            raise RuntimeError("serve_worker runs on the ranks > 0 of a tensor group")
        while True:
            op, meta, specs = self._tp.broadcast_object(None)
            tensors = [torch.empty(shape, dtype=dtype, device=self.device) for shape, dtype in specs]
            self._tp.broadcast_(tensors)
            if op == "stop":
                return
            with torch.no_grad():
                if op == "noop":
                    pass
                elif op == "forward":
                    it = iter(tensors)
                    tokens, table, offsets = next(it), next(it), next(it)
                    self._forward_logits(tokens, table, offsets, meta["flash"], next(it) if meta["pick"] else None)
                elif op == "copy_page":
                    self._copy_page_local(meta["src"], meta["dst"])
                elif op == "rebuild":
                    self.pools = None
                    self._allocate_device_state()
                elif op == "reload":
                    scatter_for_inference(self.model, None, self._tp)
                else:
                    raise RuntimeError(f"unknown tensor-parallel plan {op!r}")

    def _check_tensor_fault(self, exc: Exception) -> None:
        """Under a tensor group a fault inside a device program cannot be
        supervised (the other ranks wait inside its collectives): abort and
        raise, and the launcher ends every rank."""
        if self.tp_fault is not None:
            reason = f"tensor-parallel device program failed on rank {self._tp.rank}: {exc!r}"
            self._abort(reason)
            raise RuntimeError(reason) from exc

    def shutdown_workers(self) -> None:
        """Rank 0: tell the other ranks to leave ``serve_worker`` (once; not
        after a fault inside a device program, whose ranks are not in step)."""
        if self._tp is not None and self.leader and not self._workers_stopped and self.tp_fault is None:
            self._workers_stopped = True
            self._plan("stop")

    def _heartbeat(self) -> None:
        """Rank 0 of a tensor group, on an idle tick: a no-op plan when none
        went out for ``heartbeat_s``, so the other ranks, waiting in
        ``serve_worker``, never reach the collective timeout."""
        if (self._tp is not None and self.leader and not self._workers_stopped and self.tp_fault is None
                and time.monotonic() - self._last_plan >= self._tp.heartbeat_s):
            self._plan("noop")

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write's device half: page ``src``'s rows of every pool
        (scale pools too) into page ``dst``, on every rank."""
        self._plan("copy_page", src=int(src), dst=int(dst))
        self._copy_page_local(src, dst)

    def _copy_page_local(self, src: int, dst: int) -> None:
        with torch.no_grad():
            for layer in self.pools:
                for pool in (layer.k, layer.v, layer.k_scale, layer.v_scale):
                    if pool is not None:
                        pool[dst] = pool[src]

    # -------------------------------------------------------- qos / brownout

    def _class_slots_in_use(self) -> Dict[str, int]:
        """Decode + mid-prefill slots held, per class."""
        counts = {name: 0 for name in self.qos.names()}
        for h in self._held_handles():
            counts[self.qos.normalize(h.request.qos)] += 1
        return counts

    def _class_pages_in_use(self) -> Dict[str, int]:
        """KV pages reserved per class (the admission-time worst case)."""
        counts = {name: 0 for name in self.qos.names()}
        for h in self._held_handles():
            counts[self.qos.normalize(h.request.qos)] += self.slots.blocks_for(self._total_need_tokens(h.request))
        return counts

    def _held_handles(self) -> List[RequestHandle]:
        return ([a.handle for a in self._active if a is not None]
                + [job.handle for job in self._prefilling.values()])

    def _slot_eligible(self, cls: str, in_use: Dict[str, int]) -> bool:
        """May class ``cls`` take a free slot now? Only if that leaves the
        unmet slot floors of every higher class free."""
        floors = {name: float(c.slot_floor) for name, c in self.qos.classes.items()}
        held = reserved_above(self.qos, cls, floors, {k: float(v) for k, v in in_use.items()})
        return self.slots.free_count > held

    def _pages_reserved_above(self, cls: str) -> int:
        """Pool pages held back from class ``cls`` by higher-class floors."""
        total = self.slots.pool.n_pages - 1
        floors = {name: float(int(c.page_floor_frac * total)) for name, c in self.qos.classes.items()}
        if not any(floors.values()):
            return 0
        in_use = {k: float(v) for k, v in self._class_pages_in_use().items()}
        return int(reserved_above(self.qos, cls, floors, in_use))

    @property
    def brownout_rung(self) -> str:
        return self._brownout_rung

    def set_brownout(self, rung: str) -> Dict[str, Any]:
        """Apply a brownout rung. Idempotent; each transition is counted and
        flight-recorded. ``no_spec`` turns speculation off,
        ``shrink_batch`` also clamps the batch class's token budget,
        ``suspend_batch`` also rejects batch admission (retryable)."""
        if rung not in BROWNOUT_RUNGS:
            raise ValueError(f"unknown brownout rung {rung!r} (rungs: {BROWNOUT_RUNGS})")
        old = self._brownout_rung
        if rung != old:
            self._brownout_rung = rung
            self.stats["brownout_transitions"] += 1
            self._event("brownout_rung", old=old, new=rung)
        return {"rung": self._brownout_rung, "previous": old}

    @property
    def _spec_enabled(self) -> bool:
        return not rung_at_least(self._brownout_rung, "no_spec")

    def _maybe_preempt_for_class(self) -> None:
        """With no free slot and a top-class request waiting, preempt ONE
        running stream of the lowest active class strictly below it (the
        least-progressed among equals), retryably; the freed slot admits the
        waiter this same tick."""
        if self.slots.free_count:
            return
        with self._lock:
            waiting = self._queue.best_waiting_rank()
        if waiting is None or waiting != 0:
            return
        victim_slot, victim_rank, victim_emitted = None, -1, -1
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            rank = self.qos.rank(act.handle.request.qos)
            if rank <= waiting:
                continue
            if rank > victim_rank or (rank == victim_rank and act.emitted < victim_emitted):
                victim_slot, victim_rank, victim_emitted = slot, rank, act.emitted
        if victim_slot is None:
            return
        victim = self._active[victim_slot]
        cls = self.qos.class_of(victim.handle.request.qos)
        victim.handle._finish(FAILED, self.now(),
                              error=f"preempted for higher QoS class (retryable): {cls.name} stream yielded its slot",
                              retryable=True, retry_after=cls.retry_after_s)
        self.stats["preempted_for_class"] += 1
        self._retire([victim_slot])
        self._event("qos_preemption", victim_class=cls.name, emitted=victim_emitted)

    # ------------------------------------------------------------- admission

    def _total_need_tokens(self, request: Request) -> int:
        """Worst-case cache positions the request can ever write: prompt +
        budget, plus the draft window when speculating."""
        return min(len(request.prompt) + request.max_new_tokens + self.draft_k, self.cache_len)

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
        if self.kv_layout == "paged" and \
                self.slots.blocks_for(self._total_need_tokens(request)) > self.slots.n_pages - 1:
            return (f"prompt ({T}) + max_new_tokens ({request.max_new_tokens}) needs more KV "
                    f"pages than the whole pool holds ({self.page_pool_tokens} token positions); raise "
                    f"--page-pool-tokens or lower the request")
        # the verify forward writes K positions past the final cursor
        if self.draft_k and T + request.max_new_tokens + self.draft_k > self.cache_len:
            return (f"prompt ({T}) + max_new_tokens ({request.max_new_tokens}) + draft_k ({self.draft_k}) "
                    f"exceeds cache_len ({self.cache_len}); lower one of them")
        if self.cfg.position == "learned" and T + request.max_new_tokens > self.cfg.max_seq_len:
            return "learned positions cannot extrapolate past max_seq_len"
        if request.prefill_to is not None and self.kv_layout != "paged":
            return "prefill_to requires kv_layout='paged' (pages ship)"
        if self.role == "prefill" and request.prefill_to is None:
            return "this is a prefill-role replica: requests must name a decode target (prefill_to)"
        return None

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32, seed: int = 0,
               deadline: Optional[float] = None, timeout: Optional[float] = None,
               request_id: Optional[str] = None, prefill_to: Optional[str] = None,
               trace_hop: Optional[int] = None, tenant: str = "anon",
               qos: Optional[str] = None) -> RequestHandle:
        """Enqueue a request; returns its handle at once. ``timeout``
        (seconds from now) is sugar for an absolute ``deadline``.
        ``request_id`` threads an inbound correlation id (X-Request-Id);
        ``prefill_to`` names the decode replica the finished prefill ships
        to; ``trace_hop`` is the router's hop index (X-Trace-Hop);
        ``tenant``/``qos`` (X-Tenant-Key / X-QoS-Class) select the token
        bucket and the class. A rejection returns a handle already finished
        as ``rejected`` (retryable for drain, quota, brownout, a full queue
        and a shed; not for an invalid request)."""
        now = self.now()
        if timeout is not None:
            deadline = now + timeout if deadline is None else min(deadline, now + timeout)
        qos_name = self.qos.normalize(qos)
        cls = self.qos.classes[qos_name]
        max_new_tokens = int(max_new_tokens)
        if (rung_at_least(self._brownout_rung, "shrink_batch") and cls.brownout_max_new_tokens is not None
                and max_new_tokens > cls.brownout_max_new_tokens):
            max_new_tokens = cls.brownout_max_new_tokens
        request = Request([int(t) for t in prompt], max_new_tokens, int(seed), deadline, prefill_to=prefill_to,
                          tenant=str(tenant or "anon")[:64], qos=qos_name)
        handle = RequestHandle(request, next(self._ids), now, request_id=request_id)
        handle._tracer = self.tracer
        handle.trace_hop = trace_hop
        handle.emit_buffer_max = self.emit_buffer_max
        invalid = self._validate(request)
        with self._lock:
            if self._dead is not None:
                handle._finish(FAILED, now, error=self._dead)
                return handle
            if self.lifecycle.state == DRAINING:
                self.stats["rejected_draining"] += 1
                left = max(1.0, self._drain_deadline - now) if self._drain_deadline is not None else 1.0
                handle._finish(REJECTED, now, error="server draining; retry elsewhere", retryable=True,
                               retry_after=left)
                return handle
            self.stats["submitted"] += 1
            if invalid is not None:
                self.stats["rejected_invalid"] += 1
                handle._finish(REJECTED, now, error=invalid)
                return handle
            if rung_at_least(self._brownout_rung, "suspend_batch") and \
                    self.qos.rank(qos_name) == len(self.qos.names()) - 1:
                self.stats["rejected_brownout"] += 1
                handle._finish(REJECTED, now,
                               error=f"brownout ({self._brownout_rung}): {qos_name} admission suspended; retry later",
                               retryable=True, retry_after=cls.retry_after_s)
                return handle
            quota_wait = self._tenant_buckets.take(request.tenant, qos_name,
                                                   len(request.prompt) + request.max_new_tokens, now)
            if quota_wait > 0:
                self.stats["rejected_quota"] += 1
                handle._finish(REJECTED, now, error=f"tenant quota exhausted ({qos_name}); retry later",
                               retryable=True, retry_after=quota_wait)
                return handle
            if len(self._queue) >= self.max_queue:
                # evict the newest STRICTLY lower-class waiter before turning
                # a higher one away
                victim = self._queue.pop_lowest_class(above_rank=self.qos.rank(qos_name))
                if victim is not None:
                    vcls = self.qos.class_of(victim.request.qos)
                    self.stats["shed_lower_class"] += 1
                    victim._finish(REJECTED, now,
                                   error=f"queue full; shed for higher QoS class ({vcls.name} yielded); retry later",
                                   retryable=True, retry_after=vcls.retry_after_s)
                else:
                    self.stats["rejected_queue_full"] += 1
                    handle._finish(REJECTED, now, error=f"queue full ({self.max_queue} waiting); retry later",
                                   retryable=True, retry_after=max(1.0, cls.retry_after_s))
                    return handle
            if request.deadline is not None and infeasible_deadline(
                    request.deadline, now, request.max_new_tokens, len(self._queue), self.n_slots, self._itl_ewma):
                self.stats["shed_infeasible"] += 1
                handle._finish(REJECTED, now, error="deadline infeasible at current load (shed)", retryable=True,
                               retry_after=1.0)
                return handle
            self._queue.append(handle)
            self.stats["peak_queue_depth"] = max(self.stats["peak_queue_depth"], len(self._queue))
        return handle

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for a in self._active if a is not None)

    @property
    def free_pages(self) -> int:
        """Spare KV capacity in the unit the layout allocates: free pool
        pages when paged, free decode slots when slab (a router reads it
        from ``/healthz``)."""
        if self.kv_layout == "paged":
            return self.slots.pool.free_count
        return max(0, self.n_slots - self.active_count - len(self._prefilling))

    def _pop_queue(self, eligible=None) -> Optional[RequestHandle]:
        """Pop the next admissible queued handle (DWRR across classes;
        ``eligible`` gates classes a higher floor holds back), finishing
        cancelled / expired ones on the way."""
        with self._lock:
            now = self.now()
            while self._queue:
                cand = self._queue.popleft(eligible=eligible)
                if cand is None:
                    return None
                if cand._cancel.is_set():
                    self.stats["cancelled"] += 1
                    cand._finish(CANCELLED, now)
                elif cand.request.deadline is not None and now > cand.request.deadline:
                    self.stats["expired_queued"] += 1
                    cand._finish(EXPIRED, now, error="deadline expired in queue")
                else:
                    return cand
        return None

    def _admit(self) -> None:
        if self.prefill_chunk:
            self._admit_chunked()
        else:
            self._admit_oneshot()

    def _admit_chunked(self) -> None:
        """Claim a slot per admissible queued request and start its chunked
        prefill. A prefix hit maps the cached pages into the slot's block
        table (refcount bumps, no K/V moves) BEFORE the reservation, and the
        job starts at the first novel chunk; on slab the hit's spans are
        copied into the slot's rows. Paged admission reserves the request's
        worst case beyond the hit; when the pool cannot cover it, even after
        reclaiming cold prefix pages once, the request waits at the queue
        head."""
        paged = self.kv_layout == "paged"
        self._maybe_preempt_for_class()
        while self.slots.free_count:
            in_use = self._class_slots_in_use()
            handle = self._pop_queue(eligible=lambda c: self._slot_eligible(c, in_use))
            if handle is None:
                return
            if paged and not self._paged_admission_fits(handle):
                with self._lock:
                    self._queue.appendleft(handle)
                return
            slot = self.slots.acquire()
            fill = 0
            try:
                if self._prefix_cache is not None:
                    fill, hits = self._prefix_cache.lookup(handle.request.prompt)
                    if hits and paged:
                        self.slots.share(slot, [p for entry in hits for p in entry])
                    elif hits:
                        self.slots.write_spans(hits, slot, self.pools)
                        self._prefill_work = True
                if paged:
                    self.slots.reserve(slot, self._total_need_tokens(handle.request))
            except Exception as exc:
                # in neither the queue nor a slot table: finish it here
                handle._finish(FAILED, self.now(), error=f"admission failed: {exc!r}")
                raise
            handle.prefix_hit_tokens = fill
            handle.admitted_at = self.now()
            self._h_queue_wait.observe(handle.admitted_at - handle.submitted_at)
            handle.status = RUNNING
            self._prefilling[slot] = _PrefillJob(handle, fill=fill)

    def _paged_admission_fits(self, handle: RequestHandle) -> bool:
        """Whether the pool covers the request's reservation after the hit
        it is about to take, pages held back for higher classes aside. A
        shortfall reclaims cold prefix pages once (a page fault), then
        gives up."""
        need_total = self.slots.blocks_for(self._total_need_tokens(handle.request))
        held_above = self._pages_reserved_above(handle.request.qos)
        for attempt in (0, 1):
            hit_blocks = 0
            if self._prefix_cache is not None:
                fill, _ = self._prefix_cache.walk(handle.request.prompt)
                hit_blocks = fill // self.page_size
            shortfall = (need_total - hit_blocks) - (self.slots.pool.available - held_above)
            if shortfall <= 0:
                return True
            if attempt or self._prefix_cache is None or not len(self._prefix_cache):
                return False
            # reclaim may evict the very entries the hit would use: the
            # re-walk above recomputes the hit
            self.stats["page_faults"] += 1
            self.stats["pages_reclaimed"] += self._prefix_cache.reclaim(shortfall)
        return False

    # ----------------------------------------------------- one-shot prefill

    def _bucket(self, length: int) -> int:
        """The smallest power of two >= ``length`` (floor 8) that the cache
        admits (and, for learned positions, ``max_seq_len``). Past
        ``max_prefill_buckets`` distinct buckets a new length rounds up to
        the smallest bucket already used that fits, else to the cap, and
        ``prefill_bucket_capped`` counts it. JAX's rule number for number:
        there each bucket is a compiled program; here it bounds the prefill
        shapes the card sees."""
        cap = self.cache_len
        if self.cfg.position == "learned":
            cap = min(cap, self.cfg.max_seq_len)
        b = 8
        while b < length:
            b *= 2
        b = min(b, cap)
        if b not in self._buckets_seen:
            if len(self._buckets_seen) >= self.max_prefill_buckets:
                self.stats["prefill_bucket_capped"] += 1
                fitting = [x for x in self._buckets_seen if x >= length]
                b = min(fitting) if fitting else cap
            self._buckets_seen.add(b)  # the cap bucket may pass the budget by one
        return b

    def _prefill_oneshot(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        """The whole prompt, right-padded to its bucket, in one forward
        written straight into ``slot``'s rows (B 1, T = bucket, over the
        row's ``cache_len`` keys, through the flash kernel whatever the
        bucket). Causality makes the K/V below the prompt's length and the
        logits at ``len - 1`` exact whatever the padding; the padding's K/V
        lands at positions >= the prompt's length, which the cursor hides
        and decode overwrites. Returns the last logits row [V] in float32."""
        T, dev = len(prompt), self.device
        bucket = self._bucket(T)
        padded = torch.tensor([list(prompt) + [0] * (bucket - T)], dtype=torch.long)
        if dev.type == "cuda":
            padded = padded.pin_memory()
        return self.forward_logits(padded.to(dev, non_blocking=True),
                                   torch.from_numpy(self.slots.table[slot:slot + 1]).to(dev),
                                   torch.zeros(1, dtype=torch.int32, device=dev), flash=True,
                                   pick=torch.full((1,), T - 1, dtype=torch.long, device=dev))[0]

    def _admit_oneshot(self) -> None:
        """The one-shot path (``prefill_chunk=0``, slab): each admitted
        request prefills in one bucketed forward into its slot and decodes
        from this tick on. The installs of one admission pass are made
        together, and those before a failed admission still install (JAX's
        ``finally``); the failed handle finishes ``failed`` and the error
        propagates, as in JAX."""
        installs: List[tuple] = []
        try:
            self._maybe_preempt_for_class()
            while self.slots.free_count:
                in_use = self._class_slots_in_use()
                handle = self._pop_queue(eligible=lambda c: self._slot_eligible(c, in_use))
                if handle is None:
                    return
                handle.admitted_at = self.now()
                self._h_queue_wait.observe(handle.admitted_at - handle.submitted_at)
                slot = self.slots.acquire()
                try:
                    with torch.no_grad():
                        row = self._prefill_oneshot(slot, handle.request.prompt)
                except Exception as exc:
                    # in neither the queue nor a slot: finish it here
                    self.slots.release([slot])
                    handle._finish(FAILED, self.now(), error=f"admission failed: {exc!r}")
                    raise
                handle.status = RUNNING
                handle.prefill_done_at = self.now()
                self._h_prefill.observe(handle.prefill_done_at - handle.admitted_at)
                self._active[slot] = _ActiveSlot(handle)
                installs.append((slot, row, handle.request.seed))
                self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], self.active_count)
        finally:
            if installs:
                self._prefill_work = True
                self._flush_installs(installs)

    def _flush_installs(self, installs: List[tuple]) -> None:
        """Install [(slot, logits row, seed), ...] in one pass: the rows'
        logits, a cleared penalty mask and veto, the generators seeded."""
        dest = torch.tensor([slot for slot, _, _ in installs], device=self.device)
        self._last_logits[dest] = torch.stack([row for _, row, _ in installs])
        self._gen_mask[dest] = False
        self._veto[dest] = -1
        for slot, _, seed in installs:
            self._gens[slot].manual_seed(seed)

    # ------------------------------------------------------- chunked prefill

    def _prefill_tick(self) -> bool:
        """One prefill chunk for every mid-prefill slot, as one batched
        forward over those rows; slots whose prompt completes install into
        the decode set (their decode starts this same tick) and bank their
        prefix. Supervised: a fault fails only the prefilling slots."""
        if not self._prefilling:
            return False
        self._prefill_work = True
        C, L = self.prefill_chunk, self.cache_len
        slots, tokens, starts, lens, faulted = [], [], [], [], []
        for slot, job in self._prefilling.items():
            prompt = job.handle.request.prompt
            # clamp the window to capacity: a final chunk near the cap
            # re-sends a few earlier tokens, whose K/V recompute identically
            w = min(job.fill, L - C)
            # pages cover only REAL prompt positions: the padded tail of the
            # window writes to the trash page through unmapped blocks
            if self.kv_layout == "paged" and not self._ensure_pages_or_reclaim(slot, min(w + C, len(prompt))):
                faulted.append(slot)
                continue
            window = list(prompt[w:w + C])
            slots.append(slot)
            tokens.append(window + [0] * (C - len(window)))
            starts.append(w)
            lens.append(len(prompt))
        if faulted:
            # reservations make this unreachable unless bookkeeping rots:
            # fail ONLY the starved jobs, loudly
            now = self.now()
            for slot in faulted:
                self.stats["preemptions"] += 1
                self._prefilling.pop(slot).handle._finish(
                    FAILED, now, error="KV page pool exhausted during prefill (retryable)", retryable=True)
            self.slots.release(faulted)
            self._event("page_preemption", slots=len(faulted), phase="prefill")
            if not slots:
                return True
        dev = self.device
        t_chunk = self.now() if self.tracer.enabled else 0.0
        try:
            if self._chaos is not None:
                self._chaos.on_prefill_chunk(self._tick)
            with torch.no_grad():
                last_idx = [min(max(n - 1 - s, 0), C - 1) for n, s in zip(lens, starts)]
                last = self.forward_logits(
                    torch.tensor(tokens, dtype=torch.long, device=dev),
                    torch.from_numpy(self.slots.table[slots]).to(dev),
                    torch.tensor(starts, dtype=torch.int32, device=dev),
                    pick=torch.tensor(last_idx, dtype=torch.long, device=dev))
        except Exception as exc:
            self._on_prefill_fault(exc)
            return True
        if self.tracer.enabled:
            self.tracer.add("prefill_chunk", "engine", t_chunk, self.now(), {"tick": self._tick, "slots": len(slots)})
        self.stats["prefill_ticks"] += 1
        self.stats["prefill_chunks"] += len(slots)
        completed = []
        for row, slot in enumerate(slots):
            job = self._prefilling[slot]
            job.handle.ledger["prefill_chunks"] += 1
            job.fill = min(starts[row] + C, lens[row])
            if job.fill >= lens[row]:
                completed.append((row, slot))
        if completed:
            self._install_completed(completed, last)
        return True

    def _ensure_pages_or_reclaim(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s block table to cover ``tokens`` positions; on pool
        exhaustion reclaim cold prefix pages (a page fault) and retry once."""
        tokens = min(tokens, self.cache_len)
        if self.slots.ensure(slot, tokens):
            return True
        self.stats["page_faults"] += 1
        if self._prefix_cache is not None and len(self._prefix_cache):
            need = self.slots.blocks_for(tokens) - self.slots.alloc_blocks[slot]
            self.stats["pages_reclaimed"] += self._prefix_cache.reclaim(need)
            if self.slots.ensure(slot, tokens):
                return True
        return False

    def _install_completed(self, completed, last: torch.Tensor) -> None:
        """Rows whose prefill finished get their last-position logits, a
        cleared penalty mask and a fresh generator seeded from the request;
        then their prefix is banked, before the first decode write.
        Completions whose request names a decode target (``prefill_to``)
        ship instead."""
        ship = [(r, s) for r, s in completed if self._prefilling[s].handle.request.prefill_to is not None]
        if ship:
            self._handoff_completed(ship, last)
            completed = [(r, s) for r, s in completed if s in self._prefilling]
            if not completed:
                return
        self._flush_installs([(s, last[r], self._prefilling[s].handle.request.seed) for r, s in completed])
        t_done = self.now()
        for _, slot in completed:
            job = self._prefilling.pop(slot)
            job.handle.prefill_done_at = t_done
            if job.handle.admitted_at is not None:
                self._h_prefill.observe(t_done - job.handle.admitted_at)
            self._active[slot] = _ActiveSlot(job.handle)
            self._bank_prefix(slot, job.handle)
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], self.active_count)

    def _handoff_completed(self, ship, last: torch.Tensor) -> None:
        """Disaggregation's send (JAX ``_handoff_completed`` :2054): each
        finished prefill whose request names a decode target ships its pages
        and the carry a local install would make (the logits row at
        ``true_len - 1``, a cleared mask and veto, the generator seeded from
        the request) there, so the handed-off stream is the one it would
        have been here, with no token recomputed. The prefix is banked
        before the slot is detached, so the prefill replica's chunk cache
        keeps the pages."""
        now = self.now()
        for row, slot in ship:
            handle = self._prefilling[slot].handle
            handle.prefill_done_at = now
            if handle.admitted_at is not None:
                self._h_prefill.observe(now - handle.admitted_at)
            self._bank_prefix(slot, handle)
            try:
                span = self.slots.export_page_span(slot, len(handle.request.prompt), self.pools,
                                                   self.cfg.scan_layers, carry={"carry/last_logits": last[row]})
                gen = self._gens[slot]
                gen.manual_seed(handle.request.seed)
                leaves = dict(span["leaves"])
                leaves.update(self._host_carry(handle.request.seed, gen))
                leaves["carry/gen_mask"] = torch.zeros(self.cfg.vocab_size, dtype=torch.bool)
            except Exception as exc:  # a bad export fails ONLY this stream, retryably
                self._detach_slot(slot, True)
                self._migration_failed(handle, f"export failed: {exc!r}")
                continue
            payload = {**self._stream_meta(handle, list(handle.request.prompt), handle.request.max_new_tokens),
                       "kind": "decode", "veto": -1, "page_size": span["page_size"], "n_blocks": span["n_blocks"],
                       "n_tokens": span["n_tokens"], "leaves": leaves}
            self._detach_slot(slot, True)
            with self._lock:
                self._migrating[handle.id] = handle
                self._migrations_in_flight += 1
            self._ship(payload, handle.request.prefill_to, handle)

    def _bank_prefix(self, slot: int, handle: RequestHandle) -> None:
        """Bank a completed prefill's chunk-aligned prefix so the next
        prompt sharing it skips those chunks: paged, the slot's pages get
        one more reference and their ids land in the index (nothing moves);
        slab, one gather per pool kind copies the spans out. Skipped when
        the index already holds the whole prefix."""
        if self._prefix_cache is None:
            return
        prompt = handle.request.prompt
        C = self.prefill_chunk
        n_chunks = len(prompt) // C
        if n_chunks and not all(self._prefix_cache.contains(prompt, j) for j in range(1, n_chunks + 1)):
            if self.kv_layout == "paged":
                bpc = C // self.page_size  # blocks per chunk
                pages = self.slots.bank(slot, n_chunks * bpc)
                for j in range(1, n_chunks + 1):
                    self._prefix_cache.store_pages(prompt, j, pages[(j - 1) * bpc:j * bpc])
            else:
                for j, span in enumerate(self.slots.extract_spans(slot, C, n_chunks, self.pools), start=1):
                    self._prefix_cache.store(prompt, j, span)

    def _on_prefill_fault(self, exc: Exception) -> None:
        """A chunk forward failed: fail ONLY the mid-prefill slots
        (retryably). Decoding slots' pages were not written by it, so
        nothing is rebuilt and the breaker is not fed."""
        self._check_tensor_fault(exc)
        self.stats["prefill_faults"] += 1
        now = self.now()
        failed = sorted(self._prefilling)
        for slot in failed:
            self._prefilling.pop(slot).handle._finish(
                FAILED, now, error=f"prefill chunk failed (retryable): {exc!r}", retryable=True)
        self.slots.release(failed)
        self._event("prefill_fault", error=repr(exc), slots_failed=len(failed))

    def _grow_decode_pages(self) -> None:
        """Extend each decoding slot's block table to cover this tick's
        writes (its cursor + 1, plus the draft window when speculating),
        with the copy-on-write guard on the first written block. A slot the
        pool cannot cover is preempted retryably."""
        victims: List[int] = []
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            cursor = len(act.handle.request.prompt) + act.emitted
            if not self._ensure_pages_or_reclaim(slot, cursor + 1 + self.draft_k):
                victims.append(slot)
            elif not self.slots.cow(slot, cursor // self.page_size, self._copy_page):
                victims.append(slot)
        if victims:
            now = self.now()
            for slot in victims:
                self.stats["preemptions"] += 1
                self._active[slot].handle._finish(
                    FAILED, now, error="KV page pool exhausted; request preempted (retryable)", retryable=True)
            self._retire(victims)
            self._event("page_preemption", slots=len(victims), phase="decode")

    # ------------------------------------------ transferable streams (migration)

    @property
    def migrations_in_flight(self) -> int:
        """Streams exported and awaiting their ship's answer."""
        return self._migrations_in_flight

    def request_migration(self, request_id: str, target: str) -> bool:
        """Ask the tick thread to move the live stream ``request_id``
        (decoding or mid-prefill) to ``target``, a replica's base URL.
        Thread-safe; False when no live stream carries that id, or on a
        slab engine (nothing there is transferable). The export happens
        between ticks: the device state stays the tick thread's."""
        if self._tp is not None:
            raise NotImplementedError("stream migration under tensor parallelism is not ported yet (ROADMAP Queue 1 "
                                      "item 13)")
        if self.kv_layout != "paged":
            return False
        active = list(self._active)
        prefilling = list(self._prefilling.values())
        found = any(a is not None and a.handle.rid == request_id for a in active) or \
            any(j.handle.rid == request_id for j in prefilling)
        if not found:
            return False
        with self._lock:
            self._migrate_requests[request_id] = target
        return True

    def request_migrate_all(self, target: str) -> int:
        """Move every live stream to ``target`` (a drain by migration);
        returns how many were tagged (0 on a slab engine)."""
        if self._tp is not None:
            raise NotImplementedError("stream migration under tensor parallelism is not ported yet (ROADMAP Queue 1 "
                                      "item 13)")
        if self.kv_layout != "paged":
            return 0
        n = sum(1 for a in list(self._active) if a is not None) + len(self._prefilling)
        if n:
            with self._lock:
                self._migrate_requests["*"] = target
        return n

    def _service_migrations(self) -> None:
        """Migration's send, on the tick thread: export each tagged slot's
        pages and carry, free the slot and hand the payload to the shipper.
        The handle stays running until the ship answers (``migrated``, or a
        retryable failure the router recomputes from)."""
        with self._lock:
            reqs, self._migrate_requests = self._migrate_requests, {}
        if not reqs:
            return
        every = reqs.pop("*", None)
        jobs = []  # (slot, handle, mid-prefill, target)
        for slot, act in enumerate(self._active):
            if act is not None and reqs.get(act.handle.rid, every):
                jobs.append((slot, act.handle, False, reqs.get(act.handle.rid, every)))
        for slot, job in list(self._prefilling.items()):
            if reqs.get(job.handle.rid, every):
                jobs.append((slot, job.handle, True, reqs.get(job.handle.rid, every)))
        for slot, handle, is_prefill, target in jobs:
            try:
                payload = self._export_prefill(slot) if is_prefill else self._export_decoding(slot)
            except Exception as exc:  # a bad export fails ONLY this stream, retryably
                self._detach_slot(slot, is_prefill)
                self._migration_failed(handle, f"export failed: {exc!r}")
                continue
            self._detach_slot(slot, is_prefill)
            with self._lock:
                self._migrating[handle.id] = handle
                self._migrations_in_flight += 1
            self._ship(payload, target, handle)

    def _detach_slot(self, slot: int, is_prefill: bool) -> None:
        """Free the slot without finishing its handle (the ship decides)."""
        if is_prefill:
            self._prefilling.pop(slot, None)
        else:
            self._active[slot] = None
        self.slots.release([slot])

    def _stream_meta(self, handle: RequestHandle, consumed: List[int], remaining: int) -> Dict[str, Any]:
        """A payload's stream fields: the tokens whose K/V ship (its prompt
        at the target), the budget left, the seed, the deadline left, the
        speculation width, the cost ledger so far and the trace hop."""
        req = handle.request
        return {
            "request_id": handle.rid,
            "prompt": [int(t) for t in consumed],
            "max_new_tokens": int(remaining),
            "seed": int(req.seed),
            "deadline_s": max(0.05, req.deadline - self.now()) if req.deadline is not None else None,
            "draft_k": self.draft_k,
            "ledger": handle.ledger_snapshot(now=self.now()),
            "hop": handle.trace_hop,
        }

    @staticmethod
    def _host_carry(seed: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """The sampling carry's host leaves: the generator's state
        (``carry/torch_rng``, what a port replica continues from) and JAX's
        ``PRNGKey(seed)`` (``carry/rng``, uint32 [0, seed mod 2^32], what a
        JAX replica reads)."""
        key = np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)
        return {"carry/torch_rng": gen.get_state(), "carry/rng": torch.from_numpy(key)}

    def _export_decoding(self, slot: int) -> Dict[str, Any]:
        """A mid-decode stream's payload: the pages over every consumed
        position (prompt + emitted) and the decode carry (its logits row,
        penalty mask, veto and generator), gathered in one copy to the
        host."""
        handle = self._active[slot].handle
        consumed = list(handle.request.prompt) + [int(t) for t in handle.tokens]
        span = self.slots.export_page_span(
            slot, len(consumed), self.pools, self.cfg.scan_layers,
            carry={"carry/last_logits": self._last_logits[slot], "carry/gen_mask": self._gen_mask[slot],
                   "carry/veto": self._veto[slot]})
        leaves = dict(span["leaves"])
        veto = int(leaves.pop("carry/veto"))
        leaves.update(self._host_carry(handle.request.seed, self._gens[slot]))
        meta = self._stream_meta(handle, consumed, handle.request.max_new_tokens - len(handle.tokens))
        return {**meta, "kind": "decode", "veto": veto, "page_size": span["page_size"],
                "n_blocks": span["n_blocks"], "n_tokens": span["n_tokens"], "leaves": leaves}

    def _export_prefill(self, slot: int) -> Dict[str, Any]:
        """A mid-prefill stream's payload: the pages over its finished
        chunks and the fill cursor; the target runs the remaining chunks."""
        job = self._prefilling[slot]
        span = self.slots.export_page_span(slot, job.fill, self.pools, self.cfg.scan_layers)
        meta = self._stream_meta(job.handle, list(job.handle.request.prompt), job.handle.request.max_new_tokens)
        return {**meta, "kind": "prefill", "fill": int(job.fill), "page_size": span["page_size"],
                "n_blocks": span["n_blocks"], "n_tokens": span["n_tokens"], "leaves": dict(span["leaves"])}

    def _ship(self, payload: Dict[str, Any], target: str, handle: RequestHandle) -> None:
        shipper = self.page_shipper
        if shipper is None:
            self._migration_failed(handle, "no page shipper configured")
            return

        def on_done(err: Optional[str]) -> None:
            if err is None:
                self._migration_done(handle, target)
            else:
                self._migration_failed(handle, err)

        try:
            shipper(payload, target, on_done)
        except Exception as exc:  # a shipper crash fails this stream retryably
            self._migration_failed(handle, f"shipper raised: {exc!r}")

    def _migration_done(self, handle: RequestHandle, target: str) -> None:
        # on the shipper's thread: the bookkeeping races the tick thread's,
        # so it sits under the engine lock
        with self._lock:
            self._migrating.pop(handle.id, None)
            self._migrations_in_flight = max(0, self._migrations_in_flight - 1)
            if handle.status in _FINISHED:
                return  # an abort beat the ship's answer
            handle.migrated_to = target
            self.stats["migrations_out"] += 1
            if handle.request.prefill_to is not None:
                self.stats["prefill_handoffs"] += 1
        handle._finish(MIGRATED, self.now())
        self._event("stream_migrated", target=target, request_id=handle.rid, tokens_done=len(handle.tokens))

    def _migration_failed(self, handle: RequestHandle, err: str) -> None:
        with self._lock:
            self._migrating.pop(handle.id, None)
            self._migrations_in_flight = max(0, self._migrations_in_flight - 1)
            finished = handle.status in _FINISHED
            if not finished:
                self.stats["migration_failures"] += 1
        if finished:
            return  # an abort beat the ship's answer
        self._event("migration_failed", error=err, request_id=handle.rid)
        self.flight.dump("migration_failed", extra={"error": err, "request_id": handle.rid})
        handle._finish(FAILED, self.now(), error=f"migration failed: {err} (retryable)", retryable=True)

    # ---- receive side

    @staticmethod
    def _validate_import_payload(payload) -> Optional[str]:
        """Structural check of a migrated stream's payload: everything the
        tick thread will read must exist and parse, so a bad peer costs one
        rejected import, not the scheduler."""
        if not isinstance(payload, dict):
            return "payload must be a dict"
        for key in ("kind", "prompt", "max_new_tokens", "page_size", "n_blocks", "leaves"):
            if key not in payload:
                return f"missing field {key!r}"
        if payload["kind"] not in ("decode", "prefill"):
            return f"unknown kind {payload['kind']!r}"
        if not isinstance(payload["leaves"], dict):
            return "leaves must be a dict"
        try:
            int(payload["max_new_tokens"])
            int(payload["page_size"])
            int(payload["n_blocks"])
            int(payload.get("veto", -1))
            [int(t) for t in payload["prompt"]]
            if payload.get("deadline_s") is not None:
                float(payload["deadline_s"])
            if payload["kind"] == "prefill":
                int(payload["fill"])
        except (TypeError, ValueError, KeyError) as exc:
            return f"unparseable field: {exc!r}"
        if payload["kind"] == "decode":
            for leaf in ("carry/last_logits", "carry/gen_mask", "carry/rng"):
                if leaf not in payload["leaves"]:
                    return f"missing decode carry leaf {leaf!r}"
        return None

    def import_stream(self, payload: Dict[str, Any]) -> RequestHandle:
        """Accept a migrated stream (any thread): validate it and queue it
        for the tick thread to place. The handle streams the continuation
        only. A handle that could not be accepted comes back finished
        (rejected or failed, retryable where the condition passes)."""
        if self._tp is not None:
            raise NotImplementedError("stream migration under tensor parallelism is not ported yet (ROADMAP Queue 1 "
                                      "item 13)")
        now = self.now()
        structural = self._validate_import_payload(payload)
        if structural is not None:
            handle = RequestHandle(Request([0], 1), next(self._ids), now,
                                   request_id=payload.get("request_id") if isinstance(payload, dict) else None)
            handle._tracer = self.tracer
            handle._finish(REJECTED, now, error=f"bad import payload: {structural}", retryable=True)
            return handle
        deadline = now + float(payload["deadline_s"]) if payload.get("deadline_s") is not None else None
        request = Request([int(t) for t in payload["prompt"]], int(payload["max_new_tokens"]),
                          int(payload.get("seed", 0)), deadline)
        handle = RequestHandle(request, next(self._ids), now, request_id=payload.get("request_id"))
        handle._tracer = self.tracer
        handle.emit_buffer_max = self.emit_buffer_max
        self._seed_imported_ledger(handle, payload)
        if self.role == "prefill":
            handle._finish(REJECTED, now, error="prefill-role replica cannot import streams")
            return handle
        if self.kv_layout != "paged":
            handle._finish(REJECTED, now, error="import requires kv_layout='paged'")
            return handle
        if int(payload.get("draft_k", 0)) != self.draft_k:
            # the veto and rewind carry are draft_k's: a mismatched fleet
            # falls back to recompute rather than continue wrong
            handle._finish(REJECTED, now, error=f"draft_k mismatch: stream {payload.get('draft_k')}, replica "
                                                f"{self.draft_k}", retryable=True)
            return handle
        invalid = self._validate(request)
        if invalid is not None:
            handle._finish(REJECTED, now, error=invalid)
            return handle
        with self._lock:
            if self._dead is not None:
                handle._finish(FAILED, now, error=self._dead)
                return handle
            if self.lifecycle.state == DRAINING:
                handle._finish(REJECTED, now, error="server draining; retry elsewhere", retryable=True,
                               retry_after=1.0)
                return handle
            if len(self._pending_imports) >= self.max_queue:
                # each queued import holds a whole span in host memory
                handle._finish(REJECTED, now, error=f"import queue full ({self.max_queue} waiting)",
                               retryable=True, retry_after=1.0)
                return handle
            self._pending_imports.append((handle, payload))
        return handle

    @staticmethod
    def _seed_imported_ledger(handle: RequestHandle, payload: Dict[str, Any]) -> None:
        """Continue the stream's cumulative cost ledger: counters carry
        over, the source's milliseconds become the base, and the crossing
        counts as one migration. A peer's malformed ledger reads as zeros."""
        led = payload.get("ledger")
        if isinstance(led, dict):
            for key in handle.ledger:
                try:
                    handle.ledger[key] = int(led.get(key, 0) or 0)
                except (TypeError, ValueError):
                    pass
            for key in handle._ledger_ms_base:
                try:
                    handle._ledger_ms_base[key] = float(led.get(key, 0.0) or 0.0)
                except (TypeError, ValueError):
                    pass
        handle.ledger["migrations"] += 1
        hop = payload.get("hop")
        if hop is not None:
            try:
                handle.trace_hop = int(hop) + 1  # the attach is the next hop
            except (TypeError, ValueError):
                pass

    def _service_imports(self) -> None:
        """Migration's receive, on the tick thread: place queued imports
        ahead of normal admission (their tokens are paid for elsewhere).
        One that cannot fit yet (no slot, or the pool even after reclaiming
        cold prefix pages once) waits at the head of the queue. Entries are
        popped under the lock, so a concurrent drain never finishes a handle
        this thread is placing."""
        while True:
            with self._lock:
                if not self._pending_imports:
                    return
                handle, payload = self._pending_imports.popleft()
            now = self.now()
            if handle.status in _FINISHED:
                continue  # an abort beat us to it
            if handle._cancel.is_set():
                self.stats["cancelled"] += 1
                handle._finish(CANCELLED, now)
                continue
            if handle.request.deadline is not None and now > handle.request.deadline:
                self.stats["expired_queued"] += 1
                handle._finish(EXPIRED, now, error="deadline expired awaiting import")
                continue
            wait = not self.slots.free_count
            if not wait:
                total_blocks = self.slots.blocks_for(self._total_need_tokens(handle.request))
                short = total_blocks - self.slots.pool.available
                if short > 0 and self._prefix_cache is not None and len(self._prefix_cache):
                    self.stats["page_faults"] += 1
                    self.stats["pages_reclaimed"] += self._prefix_cache.reclaim(short)
                wait = total_blocks > self.slots.pool.available
            if not wait and self._place_import(handle, payload):
                continue
            with self._lock:
                if self._dead is None and self.lifecycle.state != DRAINING:
                    self._pending_imports.appendleft((handle, payload))
                    return
            handle._finish(REJECTED, now, error="server draining; retry elsewhere", retryable=True, retry_after=1.0)
            return

    def _place_import(self, handle: RequestHandle, payload: Dict[str, Any]) -> bool:
        """Materialize one import into a slot: its pages and, for a decode
        import, its carry (logits row, penalty mask, veto, generator) in one
        host-to-device copy. True when the handle left the queue (placed or
        failed for good); False to retry next tick."""
        slot = self.slots.acquire()
        now = self.now()
        fill, veto = int(payload.get("fill", 0)), int(payload.get("veto", -1))
        leaves = payload["leaves"]
        decode = payload["kind"] == "decode"
        carry = None
        try:
            if decode:
                carry = {"last_logits": as_host_tensor(leaves["carry/last_logits"]).to(torch.float32),
                         "gen_mask": as_host_tensor(leaves["carry/gen_mask"]).to(torch.bool)}
            ok = self.slots.import_page_span(
                slot, {"page_size": payload["page_size"], "n_blocks": payload["n_blocks"],
                       "leaves": {k: v for k, v in leaves.items() if not k.startswith("carry/")}},
                self.pools, self.cfg.scan_layers, carry=carry)
        except Exception as exc:  # geometry or dtype skew fails ONE import, never the tick thread
            self.slots.release([slot])
            handle._finish(FAILED, now, error=f"import rejected: {exc}", retryable=True)
            return True
        if not ok:
            self.slots.release([slot])
            return False  # the pool raced away: retry next tick
        try:
            self.slots.reserve(slot, self._total_need_tokens(handle.request))
            handle.status = RUNNING
            handle.admitted_at = now
            self._h_queue_wait.observe(now - handle.submitted_at)
            if decode:
                self._last_logits[slot].copy_(carry["last_logits"])
                self._gen_mask[slot].copy_(carry["gen_mask"])
                self._veto[slot].fill_(veto)  # a scalar argument: no copy from the host
                if "carry/torch_rng" in leaves:
                    self._gens[slot].set_state(as_host_tensor(leaves["carry/torch_rng"]).to(torch.uint8))
                else:  # a JAX peer's stream: its key cannot drive this generator
                    self._gens[slot].manual_seed(handle.request.seed)
                handle.prefill_done_at = now
                self._active[slot] = _ActiveSlot(handle)
                self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], self.active_count)
            else:
                self._prefilling[slot] = _PrefillJob(handle, fill=fill)
        except Exception as exc:  # a bad carry fails ONE import, never the tick thread
            self._prefilling.pop(slot, None)
            self._active[slot] = None
            self.slots.release([slot])
            handle._finish(FAILED, now, error=f"import install failed: {exc!r}", retryable=True)
            return True
        self.stats["migrations_in"] += 1
        self._event("stream_imported", request_id=handle.rid, kind=payload["kind"], blocks=int(payload["n_blocks"]))
        return True

    # ------------------------------------------------------------ retirement

    def _retire(self, finished: List[int]) -> None:
        self.slots.release(finished)
        for slot in finished:
            self._active[slot] = None

    def _sweep_queue(self) -> None:
        """Finish cancelled / past-deadline requests still waiting, every
        tick."""
        now = self.now()
        with self._lock:
            kept: List[RequestHandle] = []
            dropped = False
            for cand in self._queue:
                if cand._cancel.is_set():
                    self.stats["cancelled"] += 1
                    cand._finish(CANCELLED, now)
                    dropped = True
                elif cand.request.deadline is not None and now > cand.request.deadline:
                    self.stats["expired_queued"] += 1
                    cand._finish(EXPIRED, now, error="deadline expired in queue")
                    dropped = True
                else:
                    kept.append(cand)
            if dropped:
                self._queue.rebuild(kept)

    def _sweep_active(self) -> None:
        """Drop cancelled / past-deadline slots, decoding or mid-prefill, at
        the tick boundary."""
        now = self.now()
        finished = []
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            if act.handle._cancel.is_set():
                self.stats["cancelled"] += 1
                act.handle._finish(CANCELLED, now)
                finished.append(slot)
            elif act.handle.request.deadline is not None and now > act.handle.request.deadline:
                self.stats["expired_decoding"] += 1
                act.handle._finish(EXPIRED, now, error="deadline expired mid-decode")
                finished.append(slot)
        self._retire(finished)
        dropped = []
        for slot, job in self._prefilling.items():
            if job.handle._cancel.is_set():
                self.stats["cancelled"] += 1
                job.handle._finish(CANCELLED, now)
            elif job.handle.request.deadline is not None and now > job.handle.request.deadline:
                self.stats["expired_prefilling"] += 1
                job.handle._finish(EXPIRED, now, error="deadline expired during prefill")
            else:
                continue
            dropped.append(slot)
        for slot in dropped:
            del self._prefilling[slot]
        self.slots.release(dropped)

    # ------------------------------------------------------------ decode tick

    def _cursors(self) -> torch.Tensor:
        """Each slot's write position: prompt + emitted (0 for rows that are
        not decoding)."""
        return torch.tensor([len(a.handle.request.prompt) + a.emitted if a is not None else 0
                             for a in self._active], dtype=torch.int32, device=self.device)

    def _decoding_table(self) -> torch.Tensor:
        """The block tables with the rows that are not decoding zeroed (the
        trash page)."""
        decoding = np.array([a is not None for a in self._active])
        return torch.from_numpy(self.slots.table * decoding[:, None]).to(self.device)

    def _decode(self):
        """The sampling tail, then one forward of every slot's sampled token:
        returns host (blocks [S][1], emitted counts [S], non-finite flags
        [S]) from one transfer."""
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
        sampled = None
        if not self.fused_tail:
            # the A/B control (JAX ``_dispatch_defused``): the sampled
            # tokens come to the host (one more sync) and go back up before
            # the forward; the same draws in the same order
            sampled = token.cpu().tolist()
            up = torch.tensor(sampled, dtype=torch.long)
            token = (up.pin_memory() if dev.type == "cuda" else up).to(dev, non_blocking=True)
        logits = self.forward_logits(token[:, None], self._decoding_table(), self._cursors())[:, 0]
        if self._chaos is not None:
            # injected NaNs meet the same non-finite criterion as organic ones
            logits = self._chaos.poison_logits(self._tick, logits)
        bad = ~torch.isfinite(logits).all(dim=-1)
        self._last_logits = logits
        if sampled is not None:
            return [[t] for t in sampled], [1] * S, bad.long().cpu().tolist()
        host = torch.cat([token, bad.long()]).cpu().tolist()
        return [[t] for t in host[:S]], [1] * S, host[S:]

    def _decode_spec(self):
        """The speculative tick (JAX ``_spec_step_impl`` :679 and
        ``_dispatch_spec`` :2539): draft K tokens per decoding slot on the
        host, sample each row's token (its veto masked after processing),
        verify ``[token, drafts]`` in one forward and accept. Returns host
        (blocks [S][K + 1], emitted counts [S], non-finite flags [S]) from
        one transfer; a row with a non-finite verify logit emits its first
        token only."""
        K, S, dev = self.draft_k, self.n_slots, self.device
        V = self.cfg.vocab_size
        active = [a is not None for a in self._active]
        drafts = [[0] * K for _ in range(S)]
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            d = [int(t) for t in self.draft_fn(list(act.handle.request.prompt) + act.handle.tokens, K)]
            # a misbehaving draft_fn (wrong length, out of vocabulary) degrades acceptance, never the tick
            drafts[slot] = [t % V for t in d[:K]] + [0] * (K - len(d))
        draft = torch.tensor(drafts, dtype=torch.long, device=dev)
        tok_u = acc_u = None
        if not self.sampling.greedy:
            # per slot from its own generator: the token's draw, then the K acceptance draws
            tok_u, acc_u = [], []
            for s in range(S):
                if active[s]:
                    tok_u.append(torch.rand(V, generator=self._gens[s], device=dev))
                    acc_u.append(torch.rand(K, generator=self._gens[s], device=dev))
                else:
                    tok_u.append(torch.full((V,), 0.5, device=dev))
                    acc_u.append(torch.ones(K, device=dev))
            tok_u, acc_u = torch.stack(tok_u), torch.stack(acc_u)
        vocab = torch.arange(V, device=dev)
        # no mask of generated tokens: the penalty is 1.0 whenever draft_k is set
        proc = process_logits(self._last_logits, self.sampling)
        proc = torch.where(vocab[None, :] == self._veto[:, None], NEG_INF, proc)
        token = draw(proc, self.sampling.greedy, uniforms=tok_u)
        x = torch.cat([token[:, None], draft], dim=1)  # [S, K + 1]
        logits32 = self.forward_logits(x, self._decoding_table(), self._cursors())  # [S, K + 1, V]
        flat = process_logits(logits32.reshape(S * (K + 1), V), self.sampling)
        if self.sampling.greedy:
            ok = draft == torch.argmax(flat, dim=-1).view(S, K + 1)[:, :K]
        else:
            p = torch.softmax(flat, dim=-1).view(S, K + 1, V)
            ok = acc_u < torch.gather(p[:, :K], 2, draft[..., None])[..., 0]
        n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # [S] in [0, K]
        rows = torch.arange(S, device=dev)
        live = torch.tensor(active, device=dev)
        # next tick samples from the distribution after the last accepted token
        self._last_logits = logits32[rows, n_acc]
        rejected = draft[rows, torch.clamp(n_acc, max=K - 1)]
        self._veto = torch.where(live, torch.where(n_acc < K, rejected, -1), self._veto)
        bad = ~torch.isfinite(logits32).flatten(1).all(dim=-1)
        if self._chaos is not None:
            self._last_logits = self._chaos.poison_logits(self._tick, self._last_logits)
            bad = bad | ~torch.isfinite(self._last_logits).all(dim=-1)
        host = torch.cat([x.flatten(), n_acc, bad.long()]).cpu().tolist()
        blocks = [host[s * (K + 1):(s + 1) * (K + 1)] for s in range(S)]
        n_accs, bad_rows = host[S * (K + 1):S * (K + 2)], host[S * (K + 2):]
        self.stats["spec_ticks"] += 1
        n_emits = [1] * S
        for slot in range(S):
            if not active[slot]:
                continue
            self.stats["draft_tokens"] += K
            self._active[slot].handle.ledger["draft_tokens"] += K
            if not bad_rows[slot]:
                self.stats["accepted_tokens"] += n_accs[slot]
                self._active[slot].handle.ledger["accepted_tokens"] += n_accs[slot]
                n_emits[slot] = 1 + n_accs[slot]
        return blocks, n_emits, bad_rows

    def step(self) -> bool:
        """One scheduler tick: profile window, reload swap, sweep, export the
        streams tagged to migrate, place imports, admit, one prefill chunk per mid-prefill slot, grow decode pages, the
        supervised decode of every slot (a speculative tick with
        ``draft_k``), emit, retire. Returns False when there was nothing to
        do."""
        self._profiler.poll(self._tick)
        tr = self.tracer
        tick_idx = self._tick
        t_tick = self.now() if tr.enabled else 0.0
        self._swap_pending_params()
        self._sweep_queue()
        self._sweep_active()
        self._service_migrations()
        self._service_imports()
        self._prefill_work = False
        self._admit()
        ran_prefill = self._prefill_tick()
        if self.kv_layout == "paged":
            self._grow_decode_pages()
        # an idle DEGRADED engine runs the decode over parked rows as a
        # self-probe: a load balancer honoring the 503 sends no traffic, and
        # without the probe the breaker could never close
        probe = self._breaker.open and self.active_count == 0
        if self.active_count == 0 and not probe:
            if ran_prefill:
                if tr.enabled:
                    tr.add("tick", "engine", t_tick, self.now(), {"tick": tick_idx, "phase": "prefill_only"})
                self.flight.tick({"tick": tick_idx, "prefilling": len(self._prefilling), "active": 0,
                                  "queued": len(self._queue), "emitted": 0})
                self._tick += 1
                return True
            self._heartbeat()
            return False

        # supervised region: a fault here fails at most this tick's slots
        t0 = self.now()
        try:
            if self._chaos is not None:
                self._chaos.on_tick(self._tick)
            with torch.no_grad():
                if self.draft_k and self._spec_enabled:
                    blocks, n_emits, bad_rows = self._decode_spec()
                else:
                    blocks, n_emits, bad_rows = self._decode()
        except Exception as exc:
            # ring entry first: a breaker trip dumps the recorder
            self.flight.tick({"tick": tick_idx, "fault": True, "error": repr(exc), "queued": len(self._queue)})
            self._on_tick_fault(exc)
            self._tick += 1
            return True
        now = self.now()
        self._decode_s += now - t0
        if tr.enabled:
            tr.add("decode_step", "engine", t0, now,
                   {"tick": tick_idx, "active": self.active_count, "spec": bool(self.draft_k)})
        if self._breaker.record_clean():
            self._rebuilds_since_recovery = 0
            if not self.draining:
                self.lifecycle.to(READY, reason="breaker closed after clean tick")
            self._event("breaker_closed")
        self.stats["decode_ticks"] += 1
        finished: List[int] = []
        poisoned: List[int] = []
        ttft_new: List[tuple] = []
        itl_new: List[tuple] = []
        tokens_before = self.stats["tokens_out"]
        for slot, act in enumerate(self._active):
            if act is None:
                continue
            qos_cls = self.qos.normalize(act.handle.request.qos)
            toks = blocks[slot][:n_emits[slot]]
            act.handle.ledger["decode_ticks"] += 1
            if self.kv_layout == "paged":  # a slab slot has no page unit: 0, as JAX's
                act.handle.ledger["pages_held_ticks"] += self.slots.alloc_blocks[slot]
            if act.emitted == 0:
                ttft_new.append((now - act.handle.submitted_at, qos_cls))
            elif act.last_emit_at is not None:
                # a speculative block arrives at once: one amortized sample per token
                gap = now - act.last_emit_at
                itl_new.extend([(gap / len(toks), qos_cls)] * len(toks))
            # the first token was sampled from the PREVIOUS (finite) logits,
            # so it is valid even when this tick's logits went bad
            done_now = False
            for t in toks:
                act.handle._emit(int(t), now)
                act.emitted += 1
                act.last_emit_at = now
                self.stats["tokens_out"] += 1
                act.handle.ledger["tokens_out"] += 1
                hit_eos = self.eos_token_id is not None and int(t) == self.eos_token_id
                if hit_eos or act.emitted >= act.handle.request.max_new_tokens:
                    act.handle._finish(DONE, now)
                    self.stats["completed"] += 1
                    finished.append(slot)
                    done_now = True
                    break
            if not done_now and bad_rows[slot]:
                act.handle._finish(FAILED, now, error="non-finite logits in decode (retryable)", retryable=True)
                self.stats["poisoned_slots"] += 1
                poisoned.append(slot)
                finished.append(slot)
            elif not done_now and act.handle.overflowed:
                # the streaming consumer stopped draining past the bound
                act.handle._finish(FAILED, now, error="client stalled mid-stream; emit buffer overflowed (retryable)",
                                   retryable=True)
                self.stats["stalled_streams"] += 1
                finished.append(slot)
                self._event("stalled_stream", request_id=act.handle.rid)
        if any(bad_rows):
            # a parked slot must never feed NaN into the next tick's sample
            keep = torch.tensor([not b for b in bad_rows], device=self.device)
            self._last_logits = torch.where(keep[:, None], self._last_logits, 0.0)
        if poisoned:
            self._event("poisoned_slots", slots=len(poisoned))
        for sample, cls in ttft_new:
            self._ttft.append(sample)
            self._h_ttft.observe(sample)
            self._h_ttft_class[cls].observe(sample)
        for sample, cls in itl_new:
            self._itl.append(sample)
            self._h_itl.observe(sample)
            self._h_itl_class[cls].observe(sample)
            if not self._prefill_work:
                # no prefill work this tick: the pure-decode ITL floor
                self._itl_decode.append(sample)
                self._h_itl_decode.observe(sample)
            self._itl_ewma.update(sample)
        self._retire(finished)
        if tr.enabled:
            tr.add("emit", "engine", now, self.now(), {"tick": tick_idx, "finished": len(finished)})
            tr.add("tick", "engine", t_tick, self.now(), {"tick": tick_idx})
        self.flight.tick({"tick": tick_idx, "active": self.active_count, "prefilling": len(self._prefilling),
                          "queued": len(self._queue), "emitted": self.stats["tokens_out"] - tokens_before,
                          "finished": len(finished), "poisoned": len(poisoned)})
        self._tick += 1
        if self.metrics is not None and self.metrics_interval and self._tick % self.metrics_interval == 0:
            self.metrics.log(self.metrics_snapshot(), step=self._tick, prefix="serve")
        return not probe

    # ------------------------------------------------------ tick supervision

    def _event(self, name: str, **fields) -> None:
        """An incident into the flight recorder's ring and, with a metrics
        logger, the metrics timeline (stdout and ``metrics.jsonl``)."""
        self.flight.event(name, tick=self._tick, **fields)
        if self.metrics is not None:
            self.metrics.event(name, step=self._tick, **fields)

    def _on_tick_fault(self, exc: Exception) -> None:
        """One decode tick failed: fail ONLY its slots, decoding and
        mid-prefill (retryable), rebuild the device state, and let the
        breaker escalate: DEGRADED at its threshold, an abort after
        ``max_rebuilds`` consecutive rebuilds."""
        self._check_tensor_fault(exc)
        self.stats["tick_faults"] += 1
        now = self.now()
        error = f"decode tick failed (retryable): {exc!r}"
        failed = [s for s, a in enumerate(self._active) if a is not None]
        for slot in failed:
            self._active[slot].handle._finish(FAILED, now, error=error, retryable=True)
            self._active[slot] = None
        for slot in sorted(self._prefilling):
            self._prefilling.pop(slot).handle._finish(FAILED, now, error=error, retryable=True)
            failed.append(slot)
        # the traceback's frames may hold device tensors (the pools passed to
        # the forward): let them go before the rebuild allocates afresh
        traceback.clear_frames(exc.__traceback__)
        self._event("tick_fault", error=repr(exc), slots_failed=len(failed))
        if self._breaker.record_fault():
            self.stats["breaker_trips"] += 1
            self._rebuilds_since_recovery += 1
            if self._rebuilds_since_recovery > self.max_rebuilds:
                reason = f"engine faulted through {self.max_rebuilds} rebuilds; last error: {exc!r}"
                self._abort(reason)
                raise RuntimeError(reason) from exc
            self.lifecycle.to(DEGRADED, reason=f"breaker open after {self._breaker.threshold} faults")
            self._event("breaker_trip", trips=self.stats["breaker_trips"])
            self.flight.dump("breaker_open", extra={"error": repr(exc), "tick": self._tick,
                                                    "trips": self.stats["breaker_trips"]})
        # the pools and carries are suspect after every fault: the forward
        # may have written some rows and not others
        self._rebuild_device_state()

    def _rebuild_device_state(self) -> None:
        """Reallocate every device buffer the tick thread owns, on the same
        device: fresh pools, a fresh ``PagedKVCache`` (allocator and
        refcounts) and a prefix index over them. Every reference to the old
        pools is dropped before the new ones are allocated, so device
        memory does not double. Host state (queue, stats, lifecycle) and the
        weights are untouched."""
        self._active = [None] * self.n_slots
        self._prefilling.clear()
        self.pools = self.slots = self._prefix_cache = None
        self._last_logits = self._gen_mask = self._veto = None
        self._plan("rebuild")
        self._allocate_device_state()
        self._event("engine_rebuilt")

    # ----------------------------------------------------------------- drain

    @property
    def draining(self) -> bool:
        return self.lifecycle.state == DRAINING

    def begin_drain(self, deadline_s: Optional[float] = 30.0) -> bool:
        """Stop admission and finish in-flight generations (SIGTERM maps
        here). Queued requests finish at once as retryable rejections;
        actives run until ``deadline_s``, after which ``poll_drain``
        force-finishes them. Thread-safe; idempotent."""
        now = self.now()
        if not self.lifecycle.to(DRAINING, reason="drain requested"):
            return False
        with self._lock:
            self._drain_started = now
            self._drain_deadline = now + deadline_s if deadline_s is not None else None
            queued = list(self._queue)
            self._queue.clear()
            pending, self._pending_imports = list(self._pending_imports), deque()
        queued = queued + [h for h, _ in pending]
        for handle in queued:
            self.stats["rejected_draining"] += 1
            handle._finish(REJECTED, now, error="server draining; retry elsewhere", retryable=True,
                           retry_after=max(1.0, deadline_s) if deadline_s else 1.0)
        self._event("drain_begin", queued_rejected=len(queued), active=self.active_count)
        return True

    def poll_drain(self) -> bool:
        """Between ticks while draining: True once the engine has drained
        (or the deadline forced it) and is STOPPED."""
        if not self.draining:
            return self.lifecycle.state == STOPPED
        now = self.now()
        if (self.active_count == 0 and not self._prefilling and self.queue_depth == 0 and not self._migrating
                and not self._pending_imports):
            self._finish_drain(forced=0)
            return True
        if self._drain_deadline is not None and now > self._drain_deadline:
            error = "drain deadline exceeded; generation force-finished"
            forced = [s for s, a in enumerate(self._active) if a is not None]
            for slot in forced:
                self._active[slot].handle._finish(FAILED, now, error=error, retryable=True)
            self._retire(forced)
            still_prefilling = sorted(self._prefilling)
            for slot in still_prefilling:
                self._prefilling.pop(slot).handle._finish(FAILED, now, error=error, retryable=True)
            self.slots.release(still_prefilling)
            self.stats["drain_forced"] += len(forced) + len(still_prefilling)
            self._finish_drain(forced=len(forced) + len(still_prefilling))
            return True
        return False

    def _finish_drain(self, forced: int) -> None:
        now = self.now()
        self.drain_latency_s = now - self._drain_started if self._drain_started is not None else 0.0
        with self._lock:
            self._dead = "engine drained (stopped)"
        self.lifecycle.to(STOPPED, reason="drained")
        self._event("drain_done", forced=forced, drain_latency_s=self.drain_latency_s)
        self._profiler.abort()
        self.flight.dump("drain", extra={"forced": forced, "drain_latency_s": self.drain_latency_s})
        self.export_trace()

    # ------------------------------------------------------------ hot reload

    def reload_params(self, source) -> Dict[str, Any]:
        """Stage a standby state dict and swap it in between ticks: no slot
        is retired, in-flight generations continue on the new weights from
        their next token.

        ``source`` is a state dict (the names of ``model.state_dict()``) or
        a zero-arg callable returning one; called OFF the tick thread (an
        HTTP handler, the SIGHUP thread), which loads, validates
        (``validate_reload``), casts each tensor to the serving dtype and
        moves it to the device here; the tick thread only copies it into the
        engine's model (the one it was built from) in place. Under a tensor
        group the whole tensors stay on the host, and at the swap every rank
        takes its slices of them, one tensor at a time. A
        corrupt or mismatched artifact raises ``ReloadError`` and the engine
        keeps serving the old weights, READY throughout."""
        try:
            state = source() if callable(source) else source
            if self._chaos is not None:
                state = self._chaos.corrupt_reload(state)
            current = self.model.state_dict()
            whole = None
            if self._tp is not None:
                # the whole tensors stay on the host, sent to every rank at
                # the swap; this rank validates its own slices
                whole = {k: v.to(dtype=current[k].dtype) if k in current else v for k, v in state.items()}
                validate_reload(current, shard_for_inference(self.model, state, self._tp))
                state = None
            else:
                validate_reload(current, state)
                state = {k: v.to(device=self.device, dtype=current[k].dtype, copy=True) for k, v in state.items()}
        except ReloadError as exc:
            self.stats["reloads_rejected"] += 1
            self._event("reload_rejected", error=str(exc))
            raise
        except Exception as exc:
            self.stats["reloads_rejected"] += 1
            self._event("reload_rejected", error=repr(exc))
            raise ReloadError(f"reload failed to load: {exc!r}") from exc
        swap_event = threading.Event()
        with self._lock:
            if self._dead is not None:
                self.stats["reloads_rejected"] += 1
                raise ReloadError(f"engine is not serving: {self._dead}")
            # a superseded staged predecessor never serves: its event stays unset
            self._pending_params = (state, swap_event, whole)
            self._last_reload_event = swap_event
        return {"staged": True, "swapped": swap_event, "reloads": self.stats["reloads"]}

    def _swap_pending_params(self) -> None:
        """Tick-thread side of reload: copy the staged weights in at a tick
        boundary, so a tick's prefill and decode always see one set. The
        prefix cache is flushed (its K/V belongs to the old weights), and
        slots mid-prefill restart from token zero on fresh pages (their
        pages hold old-weight K/V, some of it shared)."""
        with self._lock:
            pending, self._pending_params = self._pending_params, None
        if pending is None:
            return
        state, swap_event, whole = pending
        if whole is not None:  # every rank copies in its slices of rank 0's whole tensors, one at a time
            self._plan("reload")
            scatter_for_inference(self.model, whole, self._tp)
        else:
            with torch.no_grad():
                self.model.load_state_dict(state)
        del state, whole
        self.stats["reloads"] += 1
        if self._prefix_cache is not None:
            flushed = self._prefix_cache.flush()
            if flushed:
                self._event("prefix_cache_flushed", entries=flushed)
        for slot, job in self._prefilling.items():
            job.fill = 0
            job.handle.prefix_hit_tokens = 0
            if self.kv_layout == "paged":
                self.slots.reset_slot_pages(slot)
                self.slots.reserve(slot, self._total_need_tokens(job.handle.request))
        swap_event.set()
        self._event("reload_swapped", reloads=self.stats["reloads"])

    def wait_reload(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until the most recently staged reload has swapped in."""
        event = self._last_reload_event
        return event.wait(timeout=timeout) if event is not None else False

    # --------------------------------------------------------------- drivers

    def run(self, stop: threading.Event, idle_sleep: float = 0.001) -> None:
        """Scheduler loop for a background thread: step until ``stop`` or a
        completed drain. A scheduler exception fails every outstanding
        request loudly (so no client waits forever), then re-raises."""
        self.lifecycle.to(READY, reason="scheduler started")
        try:
            while not stop.is_set():
                try:
                    busy = self.step()
                except Exception as exc:
                    self._abort(f"scheduler died: {exc!r}")
                    raise
                if self.draining and self.poll_drain():
                    return
                if not busy:
                    time.sleep(idle_sleep)
            self._abort("engine stopped")
        finally:
            self.shutdown_workers()

    def _abort(self, reason: str) -> None:
        """Finish every outstanding request as ``failed`` and mark the engine
        dead, so later ``submit()`` calls fail fast too."""
        now = self.now()
        self.lifecycle.to(STOPPED, reason=reason)
        with self._lock:
            self._dead = reason
            queued = list(self._queue)
            self._queue.clear()
        for handle in queued:
            handle._finish(FAILED, now, error=reason)
        for slot, act in enumerate(self._active):
            if act is not None:
                act.handle._finish(FAILED, now, error=reason)
                self._active[slot] = None
        for slot in sorted(self._prefilling):
            self._prefilling.pop(slot).handle._finish(FAILED, now, error=reason)
        with self._lock:
            migrating = list(self._migrating.values())
            self._migrating.clear()
            pending, self._pending_imports = list(self._pending_imports), deque()
        for handle in migrating + [h for h, _ in pending]:
            handle._finish(FAILED, now, error=reason, retryable=True)
        self._profiler.abort()
        if "drained" not in reason:
            self.flight.dump("abort", extra={"reason": reason})
            self.export_trace()

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        """Drive the scheduler synchronously until queue and slots drain."""
        for _ in range(max_ticks):
            if not self.step() and self.queue_depth == 0:
                return
        raise RuntimeError(f"engine not idle after {max_ticks} ticks")

    # --------------------------------------------------------------- metrics

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Serving metrics (JAX's key set, latencies in milliseconds, exact
        nearest-rank percentiles over the last 10,000 samples) plus the
        port's device, pool and kernel-launch readings."""
        elapsed = max(self.now() - self._started, 1e-9)
        snap: Dict[str, Any] = {
            "tokens_per_sec": self.stats["tokens_out"] / elapsed,
            "slot_occupancy": self.active_count,
            "queue_depth": len(self._queue),
            "state": self.lifecycle.state,
            "uptime_s": self.lifecycle.uptime_s,
            "breaker_open": self._breaker.open,
            "itl_ewma_ms": (self._itl_ewma.value or 0.0) * 1e3,
            "prefill_chunk": self.prefill_chunk,
            "prefilling": len(self._prefilling),
            "prefill_buckets": len(self._buckets_seen),
            "kv_layout": self.kv_layout,
            "draft_k": self.draft_k,
            "page_pool_util": self.slots.page_pool_util,
            "page_pool_peak": self.slots.pool.peak_in_use if self.kv_layout == "paged" else 0,
            "cow_copies": self.cow_copies,
            "acceptance_rate": (self.stats["accepted_tokens"] / self.stats["draft_tokens"]
                                if self.stats["draft_tokens"] else 0.0),
            "kernel_paged_attention": self.kernel_paged_attention,
            "fused_tail": int(self.fused_tail),
            "role": self.role,
            "free_pages": self.free_pages,
            "migrations_in_flight": self._migrations_in_flight,
            "pending_imports": len(self._pending_imports),
            "device": str(self.device),
            "decode_tok_s": self.stats["tokens_out"] / self._decode_s if self._decode_s else 0.0,
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "kv_pool_bytes": self.kv_pool_bytes,
            "param_quant": self.cfg.param_quant,
            "weight_bytes": self.weight_bytes,
            "kernel_launches": dict(_build.LAUNCHES),
        }
        if self._prefix_cache is not None:
            snap.update(self._prefix_cache.stats())
        else:
            snap.update({"prefix_hits": 0, "prefix_misses": 0, "prefix_stores": 0, "prefix_evictions": 0,
                         "prefix_entries": 0, "prefix_hit_rate": 0.0})
        for name, samples in (("ttft_ms", self._ttft), ("itl_ms", self._itl), ("itl_decode_ms", self._itl_decode)):
            for key, value in _percentiles(list(samples)).items():
                snap[f"{name}_{key}"] = value * 1e3
        snap.update(self.stats)
        snap["brownout_rung"] = self._brownout_rung
        snap["queue_by_class"] = self._queue.counts()
        return snap

    @property
    def kernel_paged_attention(self) -> int:
        """1 when the decode tick runs the paged-attention kernel (on CUDA,
        either layout), 0 on the CPU's plain path."""
        return int(self.device.type == "cuda")

    @property
    def cow_copies(self) -> int:
        """Copy-on-write page copies (0 on a slab engine)."""
        return self.slots.cow_copies if self.kv_layout == "paged" else 0

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``text/plain; version=0.0.4``):
        histograms directly, host counters and gauges through scrape-time
        callbacks."""
        return self.registry.render()

    def _register_exports(self) -> None:
        """Wire the host counters and live gauges into the registry as
        scrape-time callbacks, under JAX's family names."""
        reg = self.registry
        for key, help_text in _COUNTER_HELP:
            reg.counter_func(f"serve_{key}", help_text, (lambda k=key: self.stats[k]))
        gauges = (
            ("serve_queue_depth", "Requests waiting for a slot", lambda: len(self._queue)),
            ("serve_brownout_rung", "Brownout rung index (0=normal .. 3=suspend_batch)",
             lambda: BROWNOUT_RUNGS.index(self._brownout_rung)),
            ("serve_slot_occupancy", "Slots actively decoding", lambda: self.active_count),
            ("serve_prefilling_slots", "Slots mid-chunked-prefill", lambda: len(self._prefilling)),
            ("serve_slots", "Configured decode slots", lambda: self.n_slots),
            ("serve_breaker_open", "1 while the circuit breaker is open", lambda: 1 if self._breaker.open else 0),
            ("serve_uptime_seconds", "Engine lifetime on its own clock", lambda: self.lifecycle.uptime_s),
            ("serve_itl_ewma_seconds", "Shedding's measured ITL EWMA", lambda: self._itl_ewma.value or 0.0),
            ("serve_prefill_buckets", "Compiled one-shot prefill buckets", lambda: len(self._buckets_seen)),
            ("serve_page_pool_util", "Paged-KV pool utilization (0 when slab)", lambda: self.slots.page_pool_util),
            ("serve_free_pages", "Spare KV capacity (free pool pages, or free slots when slab)",
             lambda: self.free_pages),
        )
        for name, help_text, fn in gauges:
            reg.gauge_func(name, help_text, fn)
        reg.counter_func("serve_cow_copies", "Copy-on-write page copies (shared page written post-import/share)",
                         lambda: self.cow_copies)
        for name, help_text, fn in (
            ("serve_migrations_in_flight", "Streams exported and awaiting their ship acknowledgement",
             lambda: self._migrations_in_flight),
            ("serve_pending_imports", "Imported streams awaiting placement into a slot",
             lambda: len(self._pending_imports)),
            ("serve_prefix_cache_entries", "Prefix-cache entries resident",
             lambda: len(self._prefix_cache) if self._prefix_cache is not None else 0),
            ("serve_trace_spans_dropped", "Spans pushed out of the bounded trace ring", lambda: self.tracer.dropped),
            ("obs_spans_dropped", "Spans dropped by ring overflow (trace truncation honesty)",
             lambda: self.tracer.dropped),
        ):
            reg.gauge_func(name, help_text, fn)
        # device memory: one read shared by the three gauges of a scrape
        hbm_cache = {"t": -1.0, "v": None}

        def _hbm() -> dict:
            t = time.monotonic()
            if t - hbm_cache["t"] > 0.25:
                hbm_cache["v"] = hbm_device_stats(self.device)
                hbm_cache["t"] = t
            return hbm_cache["v"] or {}

        reg.gauge_func("hbm_used_gigabytes", "Per-device HBM in use",
                       lambda: [({"device": str(i)}, gb) for i, gb in enumerate(_hbm().get("per_device_gb", []))])
        reg.gauge_func("hbm_used_gigabytes_max", "Max HBM in use across local devices", lambda: _hbm().get("max_gb"))
        reg.gauge_func("hbm_used_gigabytes_mean", "Mean HBM in use across local devices",
                       lambda: _hbm().get("mean_gb"))

    # ------------------------------------------------------------- profiling

    def request_profile(self, ticks: int) -> Dict[str, Any]:
        """Stage a ``torch.profiler`` capture of the next ``ticks`` busy
        ticks into ``<obs_dir>/profiles`` (``POST /admin/profile``); the
        tick thread starts and stops it. RuntimeError while draining or
        stopped, without an ``obs_dir``, or while a capture runs."""
        with self._lock:
            if self._dead is not None:
                raise RuntimeError(f"engine is not serving: {self._dead}")
            if self.lifecycle.state == DRAINING:
                raise RuntimeError("engine is draining; profile capture rejected")
            info = self._profiler.request(ticks, name=f"serve_tick{self._tick}")
        self._event("profile_requested", ticks=ticks, path=info["path"])
        return info

    @property
    def profile_active(self) -> bool:
        return self._profiler.active

    @property
    def profiles_completed(self) -> List[str]:
        return list(self._profiler.completed)

    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the span ring as a Perfetto/Chrome trace (default
        ``<obs_dir>/trace_serve.json``) and append it to
        ``<obs_dir>/spans.jsonl``."""
        if path is None:
            if self.obs_dir is None:
                return None
            path = str(Path(self.obs_dir) / "trace_serve.json")
        out = self.tracer.write_chrome_trace(path)
        if self.obs_dir is not None:
            self.tracer.write_jsonl(Path(self.obs_dir) / "spans.jsonl")
        return out
