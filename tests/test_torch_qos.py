"""The port's QoS plane against the JAX package. CPU, float32, greedy.

- The port's copies of ``ClassQueue``, ``TokenBucket``, ``TenantBuckets``,
  ``BrownoutController`` and ``reserved_above`` run the same
  hypothesis-generated operation sequences as JAX's: every return value
  (the popped request, the wait, the transition) and the internal state
  (counts, deficits, rung) must be equal.
- The engine-level cases of JAX's ``tests/test_qos.py`` (not the router's
  or the fleet's), run through the port's engine and JAX's under the same
  submissions where both apply: per-tenant quotas, queue-full shedding of a
  lower class, a gold request preempting a running batch stream, slot
  floors, the brownout rungs and their full revert, per-class histograms,
  the shed EWMA across a rebuild, and the stalled SSE client's bounded
  emit buffer.
"""
import json
import math
import threading
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_serving import ByteTokenizer, http_call, make_pair, mirror, port_engine, reference, sse_events, wait_for
from zero_transformer_tpu.serving.qos import BrownoutController as JaxBrownout
from zero_transformer_tpu.serving.qos import ClassQueue as JaxQueue
from zero_transformer_tpu.serving.qos import QosPolicy as JaxPolicy
from zero_transformer_tpu.serving.qos import TenantBuckets as JaxTenantBuckets
from zero_transformer_tpu.serving.qos import TokenBucket as JaxBucket
from zero_transformer_tpu.serving.qos import reserved_above as jax_reserved_above
from zero_transformer_tpu.serving.qos import rung_at_least as jax_rung_at_least
from zero_transformer_tpu_torch.serving import (BROWNOUT_RUNGS, BrownoutController, ClassQueue, QosPolicy, ServeFault,
                                                ServingChaosMonkey, ServingServer, TokenBucket, rung_at_least)
from zero_transformer_tpu_torch.serving.qos import TenantBuckets, reserved_above

REPO = Path(__file__).resolve().parent.parent
QOS_KEYS = ("rejected_quota", "rejected_brownout", "shed_lower_class", "preempted_for_class",
            "brownout_transitions", "stalled_streams", "rejected_queue_full", "completed", "submitted", "tokens_out")
CLASSES = ("gold", "standard", "batch", "bogus", None)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


# -------------------------------------------------- the primitives, vs JAX


class Item:
    def __init__(self, n, qos, cost):
        self.n, self.qos, self.cost = n, qos, cost


QUEUE_OPS = st.lists(st.one_of(
    st.tuples(st.just("append"), st.sampled_from(CLASSES), st.integers(1, 40)),
    st.tuples(st.just("popleft"), st.sets(st.sampled_from(("gold", "standard", "batch")))),
    st.tuples(st.just("push_back"),),
    st.tuples(st.just("refund"),),
    st.tuples(st.just("shed"), st.integers(0, 2)),
    st.tuples(st.just("sweep"), st.integers(0, 3)),
    st.tuples(st.just("clear"),),
), max_size=60)


@settings(max_examples=200, deadline=None)
@given(config=st.sampled_from([None, {"classes": {"gold": {"weight": 2.0}, "batch": {"weight": 3.0}}}]),
       ops=QUEUE_OPS)
def test_class_queue_matches_jax(config, ops):
    """append / popleft (an eligible-class set) / appendleft of the last
    pop / refund / pop_lowest_class / a sweep that drops every n-th item /
    clear, on both queues: the same items come out in the same order."""
    queues = [Q(P.from_config(config), cost=lambda h: h.cost, class_of=lambda h: h.qos)
              for Q, P in ((ClassQueue, QosPolicy), (JaxQueue, JaxPolicy))]
    n, last = 0, None
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "append":
            item = Item(n, *args)
            n += 1
            for q in queues:
                q.append(item)
            continue
        if kind == "popleft":
            allowed = args[0]
            out = [q.popleft(eligible=lambda c: c in allowed) for q in queues]
            last = out[0]
        elif kind == "push_back":
            if last is None:
                continue
            out = [q.appendleft(last) for q in queues]
            last = None
        elif kind == "refund":
            if last is None:
                continue
            out = [q.refund(last) for q in queues]
        elif kind == "shed":
            out = [q.pop_lowest_class(above_rank=args[0]) for q in queues]
        elif kind == "sweep":
            for q in queues:
                q.rebuild([h for h in list(q) if args[0] == 0 or h.n % (args[0] + 1)])
            out = [None, None]
        else:
            out = [q.clear() for q in queues]
        assert out[0] is out[1], op
        a, b = queues
        assert [h.n for h in a] == [h.n for h in b]
        assert a.counts() == b.counts() and a._deficit == b._deficit
        assert a.best_waiting_rank() == b.best_waiting_rank() and len(a) == len(b)


@settings(max_examples=200, deadline=None)
@given(rate=st.floats(0.5, 50.0), burst=st.floats(1.0, 100.0),
       takes=st.lists(st.tuples(st.floats(0.0, 80.0), st.floats(0.0, 3.0), st.floats(0.5, 3.0)), max_size=20))
def test_token_bucket_matches_jax(rate, burst, takes):
    port, ref = TokenBucket(rate, burst), JaxBucket(rate, burst)
    now = 0.0
    for cost, dt, scale in takes:
        now += dt
        assert port.take(cost, now, scale=scale) == ref.take(cost, now, scale=scale)
        assert port.level == ref.level


@settings(max_examples=100, deadline=None)
@given(takes=st.lists(st.tuples(st.sampled_from(("a", "b", "c", "d")), st.sampled_from(CLASSES),
                                st.floats(1.0, 30.0), st.floats(0.0, 2.0)), max_size=30))
def test_tenant_buckets_match_jax(takes):
    config = {"classes": {"standard": {"rate": 2.0, "burst": 20.0}, "batch": {"rate": 1.0, "burst": 8.0}}}
    port = TenantBuckets(QosPolicy.from_config(config), capacity=3)
    ref = JaxTenantBuckets(JaxPolicy.from_config(config), capacity=3)
    now = 0.0
    for tenant, qos, cost, dt in takes:
        now += dt
        assert port.take(tenant, qos, cost, now) == ref.take(tenant, qos, cost, now)
        assert len(port) == len(ref)


@settings(max_examples=200, deadline=None)
@given(calm=st.integers(1, 4), ops=st.lists(st.one_of(st.booleans(), st.sampled_from(BROWNOUT_RUNGS + ("bogus",))),
                                             max_size=30))
def test_brownout_controller_matches_jax(calm, ops):
    port, ref = BrownoutController(calm_evals=calm), JaxBrownout(calm_evals=calm)
    for op in ops:
        if isinstance(op, bool):
            assert port.observe(op) == ref.observe(op)
        elif op == "bogus":
            for c in (port, ref):
                with pytest.raises(ValueError):
                    c.force(op)
        else:
            assert port.force(op) == ref.force(op)
        assert port.snapshot() == ref.snapshot()
    for a in BROWNOUT_RUNGS + ("bogus",):
        for b in BROWNOUT_RUNGS:
            assert rung_at_least(a, b) == jax_rung_at_least(a, b)


@settings(max_examples=200, deadline=None)
@given(floors=st.fixed_dictionaries({c: st.integers(0, 4) for c in ("gold", "standard", "batch")}),
       in_use=st.fixed_dictionaries({c: st.integers(0, 6) for c in ("gold", "standard", "batch")}),
       cls=st.sampled_from(CLASSES))
def test_reserved_above_matches_jax(floors, in_use, cls):
    config = {"classes": {c: {"slot_floor": v} for c, v in floors.items()}}
    f = {c: float(v) for c, v in floors.items()}
    u = {c: float(v) for c, v in in_use.items()}
    assert reserved_above(QosPolicy.from_config(config), cls, f, u) == \
        jax_reserved_above(JaxPolicy.from_config(config), cls, f, u)


def test_qos_policy_defaults_are_inert_and_config_file_parses():
    p = QosPolicy.from_config(None)
    assert p.names() == ("gold", "standard", "batch") and p.default_class == "standard"
    for cls in p.classes.values():
        assert cls.slot_floor == 0 and cls.page_floor_frac == 0.0 and cls.rate == float("inf")
    assert p.normalize("GOLD") == "gold" and p.normalize("bogus") == "standard" and p.normalize(None) == "standard"
    assert p.rank("gold") == 0 and p.rank("batch") == 2
    doc = json.loads((REPO / "configs" / "slo_default.json").read_text())
    q, ref = QosPolicy.from_config(doc["qos"]), JaxPolicy.from_config(doc["qos"])
    assert q.snapshot() == ref.snapshot() and q.default_class == ref.default_class
    assert q.classes["gold"].slot_floor == 1 and q.classes["gold"].page_floor_frac == 0.25
    assert q.classes["batch"].brownout_max_new_tokens == 16


def test_qos_policy_rejects_bad_config():
    with pytest.raises(ValueError, match="unknown keys"):
        QosPolicy.from_config({"classes": {"gold": {"oops": 1}}})
    with pytest.raises(ValueError, match="weight"):
        QosPolicy.from_config({"classes": {"gold": {"weight": 0}}})
    with pytest.raises(ValueError, match="default_class"):
        QosPolicy.from_config({"default_class": "bogus"})


def test_token_bucket_charge_refill_and_wait():
    b = TokenBucket(rate=10.0, burst=20.0)
    assert b.take(20.0, now=0.0) == 0.0
    assert b.take(5.0, now=0.0) == pytest.approx(0.5)
    assert b.take(5.0, now=1.0) == 0.0
    assert TokenBucket(rate=10.0, burst=20.0).take(40.0, now=0.0, scale=2.0) == 0.0
    assert TokenBucket(rate=math.inf, burst=math.inf).take(1e12, now=0.0) == 0.0


# ------------------------------------------------- the engine, vs JAX's


def _quota(build, fault, chaos):
    engine = build(qos={"classes": {"standard": {"rate": 1.0, "burst": 10.0}}})
    hs = [engine.submit([1, 2, 3], max_new_tokens=5, tenant="flood"),
          engine.submit([1, 2, 3], max_new_tokens=5, tenant="flood"),
          engine.submit([1, 2, 3], max_new_tokens=5, tenant="calm")]
    engine.run_until_idle()
    return engine, hs


def test_engine_tenant_quota_is_per_tenant(pair):
    engine, (ok, broke, other) = mirror(pair, _quota, QOS_KEYS)
    assert ok.status == other.status == "done"
    assert broke.status == "rejected" and broke.retryable and "quota" in broke.error and broke.retry_after >= 1.0
    assert engine.stats["rejected_quota"] == 1


def _queue_full(build, fault, chaos):
    engine = build(n_slots=1, max_queue=2, qos={"classes": {}})
    waiters = [engine.submit([1, 2 + i], max_new_tokens=4, qos="batch") for i in range(3)]
    assert waiters[2].status == "rejected"
    gold = engine.submit([1, 9], max_new_tokens=4, qos="gold")
    assert gold.status == "queued"
    engine.run_until_idle()
    return engine, waiters + [gold]


def test_engine_queue_full_sheds_lower_class(pair):
    engine, hs = mirror(pair, _queue_full, QOS_KEYS)
    shed = [w for w in hs[:2] if w.status == "rejected"]
    assert len(shed) == 1 and shed[0].retryable and "shed" in shed[0].error
    assert engine.stats["shed_lower_class"] == 1 and engine.stats["rejected_queue_full"] == 1
    assert hs[3].status == "done"


def _preempt(build, fault, chaos):
    engine = build(n_slots=1, qos={"classes": {}})
    batch = engine.submit([2, 3], max_new_tokens=24, qos="batch")
    for _ in range(3):
        engine.step()
    assert batch.status == "running"
    gold = engine.submit([2, 4], max_new_tokens=4, qos="gold")
    engine.step()
    # the victim yields its slot and the gold request is admitted this same tick
    assert batch.status == "failed" and gold.status == "running"
    engine.run_until_idle()
    g1 = engine.submit([2, 5], max_new_tokens=24, qos="gold")
    for _ in range(3):
        engine.step()
    g2 = engine.submit([2, 6], max_new_tokens=4, qos="gold")
    engine.run_until_idle()
    return engine, [batch, gold, g1, g2]


def test_engine_preempts_running_batch_for_waiting_gold(pair):
    engine, (batch, gold, g1, g2) = mirror(pair, _preempt, QOS_KEYS)
    assert gold.status == "done" and gold.tokens == reference(pair[2], [2, 4], 4)
    assert batch.retryable and "preempted" in batch.error and batch.retry_after == 5.0
    assert g1.status == g2.status == "done"
    assert engine.stats["preempted_for_class"] == 1  # gold never preempts gold


def _slot_floor(build, fault, chaos):
    engine = build(n_slots=2, qos={"classes": {"gold": {"slot_floor": 1}}})
    waiters = [engine.submit([3, 5 + i], max_new_tokens=12, qos="batch") for i in range(3)]
    peak = 0
    for _ in range(6):
        engine.step()
        peak = max(peak, [a.handle.request.qos for a in engine._active if a is not None].count("batch"))
    assert peak == 1
    gold = engine.submit([3, 9], max_new_tokens=4, qos="gold")
    engine.step()
    assert gold.status == "running"
    engine.run_until_idle()
    return engine, waiters + [gold]


def test_engine_slot_floor_reserves_capacity_for_gold(pair):
    _, hs = mirror(pair, _slot_floor, QOS_KEYS)
    assert all(h.status == "done" for h in hs)


def test_engine_page_floor_holds_pages_back_from_batch(pair):
    """A gold page floor (a quarter of the pool) is invisible to batch
    admission: batch requests that would eat into it wait."""
    engine = port_engine(pair[2], n_slots=4, page_pool_tokens=64,
                         qos={"classes": {"gold": {"page_floor_frac": 0.25}}})
    assert engine._pages_reserved_above("batch") == 2 and engine._pages_reserved_above("gold") == 0
    hs = [engine.submit([1 + i] * 20, max_new_tokens=10, qos="batch") for i in range(2)]  # 4 pages each
    engine.step()
    assert [h.status for h in hs] == ["running", "queued"]
    engine.run_until_idle()
    assert all(h.status == "done" for h in hs)


def _brownout(build, fault, chaos):
    engine = build(qos={"classes": {}})
    assert engine.brownout_rung == "normal" and engine._spec_enabled
    assert engine.set_brownout("no_spec") == {"rung": "no_spec", "previous": "normal"}
    assert not engine._spec_enabled
    engine.set_brownout("shrink_batch")
    clamped = engine.submit([1, 2], max_new_tokens=24, qos="batch")
    gold = engine.submit([1, 3], max_new_tokens=24, qos="gold")
    assert clamped.request.max_new_tokens == 16 and gold.request.max_new_tokens == 24
    engine.set_brownout("suspend_batch")
    suspended = engine.submit([1, 4], max_new_tokens=4, qos="batch")
    still_gold = engine.submit([1, 5], max_new_tokens=4, qos="gold")
    engine.set_brownout("normal")
    back = engine.submit([1, 6], max_new_tokens=24, qos="batch")
    assert back.request.max_new_tokens == 24 and engine._spec_enabled
    assert engine.set_brownout("normal") == {"rung": "normal", "previous": "normal"}
    with pytest.raises(ValueError):
        engine.set_brownout("bogus")
    engine.run_until_idle()
    return engine, [clamped, gold, suspended, still_gold, back]


def test_engine_brownout_rungs_and_full_revert(pair):
    engine, (clamped, gold, suspended, still_gold, back) = mirror(pair, _brownout, QOS_KEYS)
    assert suspended.status == "rejected" and suspended.retryable and "brownout" in suspended.error
    assert engine.stats["rejected_brownout"] == 1 and engine.stats["brownout_transitions"] == 4
    assert len(clamped.tokens) == 16 and len(back.tokens) == 24 and still_gold.status == "done"
    assert engine.metrics_snapshot()["brownout_rung"] == "normal"


def test_brownout_no_spec_turns_speculation_off(pair):
    engine = port_engine(pair[2], draft_k=2, sampling=port_engine(pair[2]).sampling)
    engine.set_brownout("no_spec")
    h = engine.submit([1, 2, 1, 2, 1, 2], max_new_tokens=8)
    engine.run_until_idle()
    assert h.status == "done" and engine.stats["spec_ticks"] == 0
    engine.set_brownout("normal")
    engine.submit([1, 2, 1, 2, 1, 2], max_new_tokens=8)
    engine.run_until_idle()
    assert engine.stats["spec_ticks"] > 0


def test_engine_per_class_histograms_and_exports(pair):
    engine = port_engine(pair[2], qos={"classes": {}})
    for i, q in enumerate(("gold", "batch", None)):
        engine.submit([3 + i, 7], max_new_tokens=4, qos=q)
    engine.run_until_idle()
    text = engine.prometheus_text()
    for family in ("serve_ttft_seconds_gold", "serve_ttft_seconds_standard", "serve_ttft_seconds_batch",
                   "serve_itl_seconds_gold", "serve_brownout_rung", "serve_rejected_quota", "serve_shed_lower_class",
                   "serve_preempted_for_class", "serve_stalled_streams"):
        assert family in text, family
    assert "serve_ttft_seconds_standard_count 1" in text
    snap = engine.metrics_snapshot()
    for key in ("rejected_quota", "rejected_brownout", "shed_lower_class", "preempted_for_class",
                "brownout_transitions", "stalled_streams"):
        assert snap[key] == 0
    assert snap["queue_by_class"] == {"gold": 0, "standard": 0, "batch": 0}


def test_shed_ewma_stays_cold_across_breaker_rebuild(pair):
    engine = port_engine(pair[2], n_slots=1, shed_warmup=4)
    tight = engine.submit([1], max_new_tokens=20, deadline=0.001)
    assert tight.status == "queued" and engine.stats["shed_infeasible"] == 0
    engine.run_until_idle()
    for _ in range(8):
        engine._itl_ewma.update(0.1)
    before = engine._itl_ewma.value
    engine._rebuild_device_state()
    assert engine._itl_ewma.warm and engine._itl_ewma.value == before
    doomed = engine.submit([1, 2], max_new_tokens=20, deadline=engine.now() + 0.5)
    assert doomed.status == "rejected" and "shed" in doomed.error


def test_slow_client_chaos_bounds_emit_buffer(pair):
    """An SSE consumer stalls mid-stream: its emit buffer hits the bound and
    the stream finishes retryably; a concurrent healthy stream equals the
    undisturbed one. (The stall is 5 s of wall time; the engine needs only
    a few ticks of it to overflow a 3-event buffer.)"""
    model = pair[2]
    chaos = ServingChaosMonkey([ServeFault("slow_client", step=2, duration=5.0)])
    engine = port_engine(model, n_slots=2, chaos=chaos, emit_buffer_max=3)
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    results = {}

    def client(i):
        code, _, body = http_call(server.port, "POST", "/generate",
                                  {"tokens": [3 + i, 7, 11], "max_new_tokens": 24, "stream": True}, timeout=120)
        events = sse_events(body)
        results[i] = ([e["token"] for e in events if "token" in e], events[-1])

    try:
        t0 = threading.Thread(target=client, args=(0,))
        t0.start()
        wait_for(lambda: engine.stats["submitted"] >= 1, msg="first admission")
        t1 = threading.Thread(target=client, args=(1,))
        t1.start()
        t0.join(120)
        t1.join(120)
        stalled_toks, stalled_done = results[0]
        assert stalled_done["status"] == "failed" and stalled_done["retryable"] is True
        assert "stalled" in stalled_done["error"] and engine.stats["stalled_streams"] == 1
        assert chaos.fired_log
        healthy_toks, healthy_done = results[1]
        assert healthy_done["status"] == "done" and healthy_toks == reference(model, [4, 7, 11], 24)
    finally:
        server.stop()


def test_qos_headers_and_brownout_over_http(pair):
    """``X-Tenant-Key`` / ``X-QoS-Class`` win over the body; an unknown class
    is served as standard; ``POST /admin/brownout`` moves the rung (400 on a
    bad one); a suspended batch request gets 429 with ``Retry-After``."""
    engine = port_engine(pair[2], qos={"classes": {}})
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    try:
        wait_for(lambda: engine.lifecycle.state == "ready", msg="READY")
        code, _, _ = http_call(server.port, "POST", "/generate",
                               {"prompt": "ab", "max_new_tokens": 2, "stream": False, "qos": "batch"},
                               {"X-QoS-Class": "gold", "X-Tenant-Key": "t1"})
        assert code == 200 and engine._h_ttft_class["gold"].count == 1
        code, _, _ = http_call(server.port, "POST", "/generate",
                               {"prompt": "ab", "max_new_tokens": 2, "stream": False}, {"X-QoS-Class": "nope"})
        assert code == 200 and engine._h_ttft_class["standard"].count == 1
        assert http_call(server.port, "POST", "/admin/brownout", {"rung": "bogus"})[0] == 400
        code, _, body = http_call(server.port, "POST", "/admin/brownout", {"rung": "suspend_batch"})
        assert code == 200 and json.loads(body) == {"rung": "suspend_batch", "previous": "normal"}
        code, headers, body = http_call(server.port, "POST", "/generate", {"prompt": "ab", "qos": "batch"})
        assert code == 429 and int(headers["Retry-After"]) == 5 and "brownout" in json.loads(body)["error"]
        health = json.loads(http_call(server.port, "GET", "/healthz")[2])
        assert health["brownout_rung"] == "suspend_batch"
    finally:
        server.stop()
