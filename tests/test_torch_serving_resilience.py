"""The port's serving resilience layer against the JAX package. CPU,
float32, greedy, cache 64 / chunk 16 / page 8.

The engine-level cases of JAX's ``tests/test_serving_resilience.py``, each
run through the port's engine AND JAX's ``ServingEngine`` (paged) under the
same fault plan: the request outcomes (status, retryable, tokens emitted)
and the resilience counters must be equal, and every request no fault
touched must equal an undisturbed port engine's stream. Time comes from an
injected clock wherever it matters (deadlines, drain, shedding). Then the
HTTP surface (``/healthz`` codes and body keys against JAX's, 413, 503 with
``Retry-After`` while draining, ``/admin/reload`` 200/409, SIGTERM under
chaos) and the serve CLI in a subprocess (reload, SIGHUP, SIGTERM drain
with a request in flight, exit 0).
"""
import copy
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_serving import (ByteTokenizer, FakeClock, http_call, jax_engine, make_pair, port_engine, reference,
                            sse_events, wait_for)
from _torch_serving import mirror as _mirror
from zero_transformer_tpu.serving import ServeFault as JaxFault
from zero_transformer_tpu.serving import ServingChaosMonkey as JaxChaos
from zero_transformer_tpu.serving import ServingServer as JaxServer
from zero_transformer_tpu.serving.resilience import CircuitBreaker as JaxBreaker
from zero_transformer_tpu.serving.resilience import ItlEwma as JaxEwma
from zero_transformer_tpu.serving.resilience import Lifecycle as JaxLifecycle
from zero_transformer_tpu.serving.resilience import infeasible_deadline as jax_infeasible
from zero_transformer_tpu_torch.convert import params_to_jax
from zero_transformer_tpu_torch.obs import MetricsLogger
from zero_transformer_tpu_torch.serving import (DEGRADED, DRAINING, READY, STARTING, STOPPED, ReloadError, ServeFault,
                                                ServingChaosMonkey, ServingServer)
from zero_transformer_tpu_torch.serving.resilience import (CircuitBreaker, ItlEwma, Lifecycle, infeasible_deadline,
                                                           validate_reload)

ROOT = Path(__file__).resolve().parent.parent
RES_KEYS = ("tick_faults", "poisoned_slots", "breaker_trips", "completed", "tokens_out", "rejected_draining",
            "drain_forced", "reloads", "reloads_rejected", "shed_infeasible", "prefill_faults", "submitted")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


@pytest.fixture(scope="module")
def pair2():
    """A second, differently initialized model: the hot-reload artifact."""
    return make_pair(seed=1)


def mirror(pair, scenario):
    return _mirror(pair, scenario, RES_KEYS)


# ------------------------------------------------ the primitives, vs JAX


def test_lifecycle_state_machine():
    clock = FakeClock()
    lc = Lifecycle(clock)
    assert lc.state == STARTING
    clock.t = 2.0
    assert lc.uptime_s == 2.0
    assert lc.to(READY)
    assert lc.to(DEGRADED) and lc.to(READY, reason="recovered")
    assert lc.to(DRAINING)
    assert not lc.to(READY) and not lc.to(DEGRADED)
    assert lc.to(STOPPED) and not lc.to(READY)
    assert [s for s, _, _ in lc.history] == [STARTING, READY, DEGRADED, READY, DRAINING, STOPPED]


@settings(max_examples=100, deadline=None)
@given(moves=st.lists(st.sampled_from((STARTING, READY, DEGRADED, DRAINING, STOPPED)), max_size=12))
def test_lifecycle_matches_jax(moves):
    port, ref = Lifecycle(FakeClock()), JaxLifecycle(FakeClock())
    for m in moves:
        assert port.to(m) == ref.to(m)
        assert port.state == ref.state


@settings(max_examples=100, deadline=None)
@given(threshold=st.integers(1, 4), cooldown=st.integers(1, 3), events=st.lists(st.booleans(), max_size=30))
def test_circuit_breaker_matches_jax(threshold, cooldown, events):
    port, ref = CircuitBreaker(threshold, cooldown), JaxBreaker(threshold, cooldown)
    for fault in events:
        out = (port.record_fault(), ref.record_fault()) if fault else (port.record_clean(), ref.record_clean())
        assert out[0] == out[1]
        assert (port.open, port.trips, port.consecutive_faults) == (ref.open, ref.trips, ref.consecutive_faults)


def test_circuit_breaker_threshold_and_cooldown():
    br = CircuitBreaker(threshold=3, cooldown=2)
    assert not br.record_fault() and not br.record_fault()
    assert br.record_fault() and br.open and br.trips == 1
    assert not br.record_clean() and br.record_clean() and not br.open
    br2 = CircuitBreaker(threshold=1, cooldown=2)
    assert br2.record_fault() and br2.open and not br2.record_clean()
    br2.record_fault()
    assert not br2.record_clean() and br2.open


@settings(max_examples=200, deadline=None)
@given(samples=st.lists(st.floats(1e-4, 1.0), max_size=12), deadline=st.floats(0.0, 30.0),
       max_new=st.integers(1, 200), depth=st.integers(0, 40), slots=st.integers(1, 8))
def test_infeasible_deadline_matches_jax(samples, deadline, max_new, depth, slots):
    port, ref = ItlEwma(warmup=3), JaxEwma(warmup=3)
    for s in samples:
        port.update(s)
        ref.update(s)
    assert port.floor_s() == ref.floor_s() and port.warm == ref.warm
    assert infeasible_deadline(deadline, 0.0, max_new, depth, slots, port) == \
        jax_infeasible(deadline, 0.0, max_new, depth, slots, ref)


def test_infeasible_deadline_math():
    itl = ItlEwma(decay=0.9, warmup=2)
    assert not infeasible_deadline(1.0, 0.0, 100, 0, 1, itl)
    itl.update(0.05)
    itl.update(0.05)
    assert infeasible_deadline(1.0, 0.0, 100, 0, 1, itl)
    assert not infeasible_deadline(10.0, 0.0, 100, 0, 1, itl)
    assert infeasible_deadline(6.0, 0.0, 100, 30, 1, itl)


def test_validate_reload(pair):
    _, _, model = pair
    state = model.state_dict()
    validate_reload(state, {k: v.double() for k, v in state.items()})  # floats cast, not refused
    with pytest.raises(ReloadError, match="structure"):
        validate_reload(state, {"bogus": torch.zeros(2)})
    name = next(iter(state))
    with pytest.raises(ReloadError, match="mismatch"):
        validate_reload(state, {**state, name: torch.zeros(1, *state[name].shape)})
    with pytest.raises(ReloadError, match="non-finite"):
        validate_reload(state, {**state, name: torch.full_like(state[name], float("nan"))})
    with pytest.raises(ReloadError, match="mismatch"):
        validate_reload(state, {**state, name: state[name].to(torch.int8)})
    with pytest.raises(ReloadError, match="unreadable"):
        validate_reload(state, [1, 2])


# ------------------------------------------------ the engine, vs JAX's


def test_run_marks_ready_and_stop_marks_stopped(pair):
    engine = port_engine(pair[2])
    assert engine.lifecycle.state == STARTING
    stop = threading.Event()
    thread = threading.Thread(target=engine.run, args=(stop,), daemon=True)
    thread.start()
    wait_for(lambda: engine.lifecycle.state == READY, msg="READY")
    stop.set()
    thread.join(timeout=30)
    assert engine.lifecycle.state == STOPPED


def _tick_fault(build, fault, chaos):
    engine = build(n_slots=2, chaos=chaos([fault("tick_fault", step=2, duration=1)]))
    hs = [engine.submit([1, 2], max_new_tokens=8), engine.submit([3, 4], max_new_tokens=8),
          engine.submit([5, 6], max_new_tokens=8)]
    engine.run_until_idle()
    return engine, hs


def test_tick_fault_fails_only_active_slots(pair):
    engine, (a, b, queued) = mirror(pair, _tick_fault)
    assert a.status == b.status == "failed" and a.retryable and b.retryable and "retryable" in a.error
    assert queued.status == "done" and queued.tokens == reference(pair[2], [5, 6])
    assert engine.stats["tick_faults"] == 1 and engine.stats["breaker_trips"] == 0
    assert a.result(timeout=1) == a.tokens


def _breaker(build, fault, chaos):
    engine = build(n_slots=1, chaos=chaos([fault("tick_fault", step=1, duration=3)]))
    victims = [engine.submit([i + 1], max_new_tokens=4) for i in range(3)]
    for _ in range(4):  # tick 0 clean, ticks 1-3 faulted
        engine.step()
    assert engine.lifecycle.state == DEGRADED and engine._breaker.open
    after = engine.submit([9, 9], max_new_tokens=8)
    engine.run_until_idle()
    return engine, victims + [after]


def test_breaker_trips_rebuilds_and_recovers(pair):
    engine, hs = mirror(pair, _breaker)
    assert all(v.status == "failed" and v.retryable for v in hs[:3])
    assert engine.stats["breaker_trips"] == 1 and engine.lifecycle.state == READY and not engine._breaker.open
    assert hs[3].status == "done" and hs[3].tokens == reference(pair[2], [9, 9])


def test_rebuild_allocates_fresh_device_state(pair):
    engine = port_engine(pair[2], n_slots=2, prefix_cache_chunks=8,
                         chaos=ServingChaosMonkey([ServeFault("tick_fault", step=12, duration=1)]))
    engine.submit(list(range(1, 40)), max_new_tokens=8)
    engine.run_until_idle()
    old_pools, old_slots, old_index = engine.pools, engine.slots, engine._prefix_cache
    assert len(old_index) == 2
    engine.submit(list(range(1, 40)), max_new_tokens=8)
    engine.run_until_idle()
    assert engine.stats["tick_faults"] == 1
    assert engine.pools is not old_pools and engine.slots is not old_slots
    assert engine._prefix_cache is not old_index and engine._prefix_cache._pool is engine.slots.pool
    assert len(engine._prefix_cache) == 0 and engine.slots.pool.in_use == 0
    assert all(p.k.device.type == "cpu" for p in engine.pools)
    h = engine.submit(list(range(1, 40)), max_new_tokens=8)
    engine.run_until_idle()
    assert h.tokens == reference(pair[2], list(range(1, 40)))


def _probe(build, fault, chaos):
    engine = build(n_slots=1, chaos=chaos([fault("tick_fault", step=1, duration=3)]))
    hs = [engine.submit([i + 1], max_new_tokens=4) for i in range(3)]
    for _ in range(4):
        engine.step()
    assert engine.lifecycle.state == DEGRADED and engine.queue_depth == 0 and engine.active_count == 0
    assert engine.step() is False  # the probe tick reports idle...
    assert engine.lifecycle.state == READY  # ...and proved the engine clean
    return engine, hs


def test_degraded_idle_engine_self_probes_back_to_ready(pair):
    engine, _ = mirror(pair, _probe)
    assert not engine._breaker.open


def test_breaker_escalates_after_max_rebuilds(pair):
    jcfg, params, model = pair
    for build, fault, chaos in ((lambda **a: jax_engine(jcfg, params, **a), JaxFault, JaxChaos),
                                (lambda **a: port_engine(model, **a), ServeFault, ServingChaosMonkey)):
        engine = build(n_slots=1, chaos=chaos([fault("tick_fault", step=0, duration=10_000)]),
                       breaker_threshold=2, max_rebuilds=1)
        for i in range(8):
            engine.submit([i + 1], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="rebuilds"):
            engine.run(threading.Event())
        assert engine.lifecycle.state == STOPPED
        assert engine.submit([1], max_new_tokens=2).status == "failed"


def _nan(build, fault, chaos):
    engine = build(n_slots=2, chaos=chaos([fault("nan_logits", step=2, duration=1, slots=[0])]))
    hs = [engine.submit([5, 6], max_new_tokens=8), engine.submit([7, 8], max_new_tokens=8)]
    engine.run_until_idle()
    return engine, hs


def test_nan_logits_retire_only_poisoned_slot(pair):
    engine, (poisoned, neighbor) = mirror(pair, _nan)
    assert poisoned.status == "failed" and poisoned.retryable and "non-finite" in poisoned.error
    assert 0 < len(poisoned.tokens) < 8
    assert neighbor.status == "done" and neighbor.tokens == reference(pair[2], [7, 8])
    assert engine.stats["poisoned_slots"] == 1 and engine.stats["tick_faults"] == 0
    assert engine.lifecycle.state != DEGRADED


def _prefill_fault(build, fault, chaos):
    engine = build(n_slots=2, chaos=chaos([fault("prefill_fault", step=2, duration=1)]))
    hog = engine.submit([1, 2], max_new_tokens=10)
    engine.step()
    engine.step()
    late = engine.submit(list(range(3, 40)), max_new_tokens=4)  # prefills at tick 2: faulted
    engine.run_until_idle()
    return engine, [hog, late]


def test_prefill_fault_fails_only_prefilling_slots(pair):
    engine, (hog, late) = mirror(pair, _prefill_fault)
    assert late.status == "failed" and late.retryable and "prefill chunk failed" in late.error
    assert hog.status == "done" and hog.tokens == reference(pair[2], [1, 2], 10)
    assert engine.stats["prefill_faults"] == 1 and engine.stats["breaker_trips"] == 0
    assert engine.slots.pool.in_use == 0


def _drain(build, fault, chaos):
    engine = build(n_slots=1)
    hog = engine.submit([1, 2, 3], max_new_tokens=8)
    queued = engine.submit([4, 5], max_new_tokens=4)
    engine.step()
    assert engine.begin_drain(deadline_s=60.0) and not engine.begin_drain(deadline_s=60.0)
    assert queued.status == "rejected" and queued.retryable and "draining" in queued.error
    assert queued.retry_after >= 1.0
    late = engine.submit([6], max_new_tokens=2)
    while not engine.poll_drain():
        engine.step()
    return engine, [hog, queued, late]


def test_drain_under_load(pair):
    engine, (hog, queued, late) = mirror(pair, _drain)
    assert late.status == "rejected" and late.retryable and engine.stats["rejected_draining"] == 2
    assert hog.status == "done" and hog.tokens == reference(pair[2], [1, 2, 3])
    assert engine.lifecycle.state == STOPPED and engine.drain_latency_s is not None
    assert engine.stats["drain_forced"] == 0


def _drain_deadline(build, fault, chaos):
    clock = FakeClock()
    engine = build(n_slots=1, clock=clock)
    hog = engine.submit([1, 2], max_new_tokens=30)
    engine.step()
    engine.begin_drain(deadline_s=5.0)
    engine.step()
    assert not engine.poll_drain()
    clock.t = 10.0
    assert engine.poll_drain()
    return engine, [hog]


def test_drain_deadline_force_finishes(pair):
    engine, (hog,) = mirror(pair, _drain_deadline)
    assert hog.status == "failed" and hog.retryable and "drain deadline" in hog.error
    assert engine.stats["drain_forced"] == 1 and engine.lifecycle.state == STOPPED
    assert hog.result(timeout=1) == hog.tokens


def test_scheduler_thread_drains_and_exits(pair):
    engine = port_engine(pair[2], n_slots=1)
    stop = threading.Event()
    thread = threading.Thread(target=engine.run, args=(stop,), daemon=True)
    thread.start()
    handle = engine.submit([1, 2], max_new_tokens=6)
    wait_for(lambda: handle.status != "queued", msg="admission")
    engine.begin_drain(deadline_s=30.0)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert handle.status == "done" and len(handle.tokens) == 6 and engine.lifecycle.state == STOPPED


def test_hot_reload_swaps_without_retiring_slots(pair, pair2):
    model, model2 = pair[2], pair2[2]
    # a reload copies the weights into the engine's model in place: give it its own
    engine = port_engine(copy.deepcopy(model), n_slots=1)
    mid = engine.submit([1, 2], max_new_tokens=10)
    for _ in range(3):
        engine.step()
    assert mid.status == "running"
    engine.reload_params(model2.state_dict())
    engine.run_until_idle()
    assert mid.status == "done" and len(mid.tokens) == 10
    assert engine.stats["reloads"] == 1 and engine.wait_reload(timeout=0.1)
    fresh = engine.submit([5, 6, 7], max_new_tokens=8)
    engine.run_until_idle()
    assert fresh.tokens == reference(model2, [5, 6, 7]) != reference(model, [5, 6, 7])


def test_reload_restarts_a_mid_prefill_slot_on_fresh_pages(pair, pair2):
    """A slot mid-prefill when the swap lands restarts from token zero on
    fresh pages (its shared pre-reload pages are old-weight K/V), so its
    stream equals a fresh engine's on the new weights."""
    model, model2 = pair[2], pair2[2]
    engine = port_engine(copy.deepcopy(model), n_slots=2, prefix_cache_chunks=8)
    prompt = list(range(1, 56))
    engine.submit(list(range(1, 41)) + [5], max_new_tokens=4)
    engine.run_until_idle()
    h = engine.submit(prompt, max_new_tokens=6)
    engine.step()  # admitted with a 32-token hit, one of its two novel chunks done
    assert h.prefix_hit_tokens == 32 and h.status == "running" and len(engine._prefilling) == 1
    engine.reload_params(model2.state_dict())
    engine.run_until_idle()
    assert h.status == "done" and h.prefix_hit_tokens == 0
    assert h.tokens == reference(model2, prompt, 6)


def test_reload_rejects_mismatched_and_corrupt(pair):
    model = pair[2]
    engine = port_engine(model, n_slots=1)
    stop = threading.Event()
    thread = threading.Thread(target=engine.run, args=(stop,), daemon=True)
    thread.start()
    try:
        with pytest.raises(ReloadError, match="mismatch"):
            engine.reload_params({"bogus": torch.zeros(2, 2)})
        with pytest.raises(ReloadError, match="mismatch"):
            engine.reload_params({k: torch.zeros((1,) + tuple(v.shape)) for k, v in model.state_dict().items()})

        def corrupt_loader():
            raise OSError("truncated npz")

        with pytest.raises(ReloadError, match="failed to load"):
            engine.reload_params(corrupt_loader)
        assert engine.stats["reloads_rejected"] == 3 and engine.stats["reloads"] == 0
        assert engine.lifecycle.state == READY
        handle = engine.submit([3, 7, 11], max_new_tokens=8)
        assert handle.result(timeout=60) == reference(model, [3, 7, 11])
    finally:
        stop.set()
        thread.join(timeout=30)


def test_chaos_corrupt_reload_artifact_rejected(pair, pair2):
    chaos = ServingChaosMonkey([ServeFault("corrupt_reload", step=0)])
    engine = port_engine(copy.deepcopy(pair[2]), n_slots=1, chaos=chaos)
    with pytest.raises(ReloadError, match="mismatch"):
        engine.reload_params(pair2[2].state_dict())
    assert engine.stats["reloads_rejected"] == 1
    engine.reload_params(pair2[2].state_dict())  # one-shot: the retry goes through
    engine.step()
    assert engine.stats["reloads"] == 1


def _shed(build, fault, chaos):
    clock = FakeClock()
    engine = build(n_slots=1, clock=clock, shed_warmup=4)
    for _ in range(8):
        engine._itl_ewma.update(0.1)
    doomed = engine.submit([1, 2], max_new_tokens=20, deadline=1.0)
    feasible = engine.submit([1, 2], max_new_tokens=20, deadline=100.0)
    assert feasible.status == "queued"
    engine.run_until_idle()
    return engine, [doomed, feasible]


def test_infeasible_deadline_sheds_at_admission(pair):
    engine, (doomed, feasible) = mirror(pair, _shed)
    assert doomed.status == "rejected" and doomed.retryable and "shed" in doomed.error
    assert engine.stats["shed_infeasible"] == 1 and feasible.status == "done"


def test_shed_is_inert_before_warmup(pair):
    engine = port_engine(pair[2], n_slots=1, clock=FakeClock())
    tight = engine.submit([1], max_new_tokens=20, deadline=0.001)
    assert tight.status == "queued" and engine.stats["shed_infeasible"] == 0


def test_metrics_exports_resilience_counters(pair):
    engine = port_engine(pair[2])
    engine.submit([1, 2], max_new_tokens=4)
    engine.run_until_idle()
    snap = engine.metrics_snapshot()
    for key in ("state", "uptime_s", "breaker_open", "itl_ewma_ms", "tick_faults", "poisoned_slots",
                "breaker_trips", "shed_infeasible", "rejected_draining", "drain_forced", "reloads",
                "reloads_rejected"):
        assert key in snap, key


def test_resilience_events_land_in_metrics_timeline(pair, tmp_path):
    metrics = MetricsLogger(directory=tmp_path)
    chaos = ServingChaosMonkey([ServeFault("nan_logits", step=2, duration=1, slots=[0])])
    engine = port_engine(pair[2], n_slots=1, chaos=chaos, metrics=metrics)
    engine.submit([1, 2], max_new_tokens=8)
    engine.run_until_idle()
    engine.begin_drain(deadline_s=10.0)
    while not engine.poll_drain():
        engine.step()
    metrics.close()
    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    events = [r["event"] for r in lines if "event" in r]
    assert "poisoned_slots" in events and "drain_begin" in events and "drain_done" in events


# ------------------------------------------------------------ HTTP surface


def test_healthz_lifecycle_codes_and_body(pair):
    jcfg, params, model = pair
    engine = port_engine(model)
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start(start_scheduler=False)
    try:
        code, _, body = http_call(server.port, "GET", "/healthz")
        body = json.loads(body)
        assert code == 503 and body["state"] == "starting"
        # the body's keys are JAX's, plus the paged-attention kernel gauge
        # that JAX keeps on /metrics only: a replica's probe reads it there
        jserver = JaxServer(jax_engine(jcfg, params), ByteTokenizer(), port=0)
        try:
            assert set(body) == set(jserver._healthz()[1]) | {"kernel_paged_attention"}
            assert body["kernel_paged_attention"] == 0  # the CPU's plain path
        finally:
            jserver._httpd.server_close()
        server.start_scheduler()
        wait_for(lambda: engine.lifecycle.state == READY, msg="READY")
        code, _, body = http_call(server.port, "GET", "/healthz")
        body = json.loads(body)
        assert code == 200 and body["status"] == "ok" and body["breaker_open"] is False
    finally:
        server.stop()
    engine2 = port_engine(model)
    server2 = ServingServer(engine2, ByteTokenizer(), port=0)
    server2.start(start_scheduler=False)
    try:
        engine2.begin_drain(deadline_s=30.0)
        code, _, body = http_call(server2.port, "GET", "/healthz")
        assert code == 503 and json.loads(body)["state"] == "draining"
    finally:
        server2.stop()


def test_oversized_body_413(pair):
    server = ServingServer(port_engine(pair[2]), ByteTokenizer(), port=0, max_body_bytes=512)
    server.start()
    try:
        code, _, body = http_call(server.port, "POST", "/generate", b'{"prompt": "' + b"x" * 4096 + b'"}')
        assert code == 413 and "exceeds" in json.loads(body)["error"]
    finally:
        server.stop()


def test_draining_maps_to_503_with_retry_after(pair):
    engine = port_engine(pair[2])
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start(start_scheduler=False)
    try:
        engine.begin_drain(deadline_s=30.0)
        code, headers, body = http_call(server.port, "POST", "/generate", {"prompt": "ab"})
        assert code == 503 and int(headers["Retry-After"]) >= 1 and "draining" in json.loads(body)["error"]
    finally:
        server.stop()


def _write_npz(model, path: Path) -> Path:
    np.savez(path, **params_to_jax(model.state_dict()))
    return path


def test_admin_reload_endpoint(pair, pair2, tmp_path):
    good = _write_npz(pair2[2], tmp_path / "good.npz")
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(good.read_bytes()[: good.stat().st_size // 2])
    engine = port_engine(copy.deepcopy(pair[2]))
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    try:
        code, _, body = http_call(server.port, "POST", "/admin/reload", {"params": str(good)})
        body = json.loads(body)
        assert code == 200 and body["reloaded"] is True and body["reloads"] == 1
        code, _, body = http_call(server.port, "POST", "/admin/reload", {"params": str(corrupt)})
        body = json.loads(body)
        assert code == 409 and body["state"] == "ready" and body["reloads"] == 1
        assert http_call(server.port, "GET", "/healthz")[0] == 200
        code, _, _ = http_call(server.port, "POST", "/admin/reload", {})
        assert code == 400  # no configured source and no path
    finally:
        server.stop()


def test_serving_chaos_end_to_end(pair):
    """Decode faults, a NaN window and a mid-load SIGTERM over HTTP: every
    request ends (none hangs), the server drains and the scheduler exits,
    and every completed request equals the undisturbed stream."""
    model = pair[2]
    prompts = [[3 + i, 7, 11 + i] for i in range(10)]
    refs = {i: reference(model, p, 12) for i, p in enumerate(prompts)}
    chaos = ServingChaosMonkey([ServeFault("tick_fault", step=8, duration=1),
                                ServeFault("nan_logits", step=16, duration=1, slots=[0]),
                                ServeFault("sigterm", step=24)])
    engine = port_engine(model, n_slots=2, chaos=chaos)
    server = ServingServer(engine, ByteTokenizer(), port=0)
    old_term, old_hup = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGHUP)
    server.install_signal_handlers(drain_deadline_s=30.0)
    server.start()
    results = {}

    def client(i):
        try:
            code, _, body = http_call(server.port, "POST", "/generate",
                                      {"tokens": prompts[i], "max_new_tokens": 12, "stream": False}, timeout=120)
            results[i] = (code, json.loads(body))
        except Exception as exc:  # torn down mid-drain: terminal too
            results[i] = (None, {"status": "connection_error", "error": repr(exc)})

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a client hung"
        wait_for(lambda: engine.lifecycle.state == STOPPED, msg="STOPPED")
        server._scheduler.join(timeout=30)
        assert not server._scheduler.is_alive()
        assert engine.active_count == 0 and engine.queue_depth == 0
        assert len(chaos.fired_log) == 3 and len(results) == len(prompts)
        completed = [i for i, (code, doc) in results.items() if code == 200 and doc.get("status") == "done"]
        assert completed
        for i in completed:
            assert results[i][1]["tokens"] == refs[i], f"request {i} garbled"
    finally:
        server.stop()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGHUP, old_hup)


# ----------------------------------------------------------- the serve CLI


def test_serve_cli_reload_sighup_and_sigterm_drain(pair, pair2, tmp_path):
    """``python -m zero_transformer_tpu_torch.serve --server --device cpu``:
    a good ``/admin/reload`` 200, a truncated one 409 with the engine READY,
    SIGHUP reloads ``--params`` again, and SIGTERM with a stream in flight
    lets it finish, prints ``drain_done`` and exits 0."""
    first = _write_npz(pair[2], tmp_path / "a.npz")
    second = _write_npz(pair2[2], tmp_path / "b.npz")
    bad = tmp_path / "bad.npz"
    bad.write_bytes(second.read_bytes()[:100])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "zero_transformer_tpu_torch.serve", "--model", "test", "--params", str(first),
         "--device", "cpu", "--dtype", "float32", "--server", "--port", "0", "--greedy", "--cache-len", "64",
         "--prefill-chunk", "16", "--page-size", "8", "--obs-dir", str(tmp_path / "obs")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
    try:
        line = proc.stdout.readline()
        assert "serving on" in line, line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        wait_for(lambda: http_call(port, "GET", "/healthz")[0] == 200, msg="READY")
        code, _, body = http_call(port, "POST", "/admin/reload", {"params": str(second)})
        assert code == 200 and json.loads(body)["reloads"] == 1
        code, _, body = http_call(port, "POST", "/admin/reload", {"params": str(bad)})
        assert code == 409 and json.loads(body)["state"] == "ready"
        proc.send_signal(signal.SIGHUP)  # reloads --params
        wait_for(lambda: json.loads(http_call(port, "GET", "/healthz")[2])["reloads"] == 2, msg="SIGHUP reload")
        metrics = json.loads(http_call(port, "GET", "/metrics")[2])
        assert metrics["prefix_entries"] == 0 and metrics["reloads_rejected"] == 1
        # a stream in flight when SIGTERM lands
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/generate", json.dumps({"prompt": "abcde", "max_new_tokens": 50}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        first_event = resp.readline()
        assert first_event.startswith(b"data: ")
        proc.send_signal(signal.SIGTERM)
        events = sse_events(first_event + resp.read())
        conn.close()
        assert events[-1]["done"] and events[-1]["status"] == "done"
        assert len([e for e in events if "token" in e]) == 50
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "EVENT drain_done" in out
    assert (tmp_path / "obs" / "flightrec").is_dir() and (tmp_path / "obs" / "trace_serve.json").is_file()


def test_serving_config_and_cli_defaults(pair, tmp_path, capsys):
    """``serve --server`` without flags builds JAX's default engine: the
    prefix cache at 256 chunks and a 30 s drain; the slab layout, the
    bucket cap and the fused-tail control are accepted and validated as
    JAX's, and so are the roles; ``--prefill-chunk 0`` turns the cache off
    and falls back to the slab layout with JAX's message."""
    from zero_transformer_tpu.config import ServingConfig as JaxServing
    from zero_transformer_tpu_torch.config import ServingConfig
    from zero_transformer_tpu_torch.serve import build_engine, build_parser

    for fields in (dict(kv_layout="slab", prefill_chunk=0, prefix_cache_chunks=0), dict(max_prefill_buckets=2),
                   dict(fused_tail=False), dict(kv_layout="slab", prefill_chunk=24)):
        assert ServingConfig(**fields) == ServingConfig(**fields) and JaxServing(**fields)
    assert [ServingConfig(role=r).role for r in ("mixed", "prefill", "decode")] == ["mixed", "prefill", "decode"]
    for bad in (dict(prefix_cache_chunks=-1), dict(drain_deadline_s=-1.0), dict(role="router"),
                dict(role="prefill", draft_k=2), dict(kv_layout="slab", prefill_chunk=0), dict(kv_layout="ring"),
                dict(prefill_chunk=0, prefix_cache_chunks=0), dict(max_prefill_buckets=0),
                dict(fused_tail=False, draft_k=2), dict(role="decode", kv_layout="slab")):
        with pytest.raises(ValueError) as port_exc:
            ServingConfig(**bad)
        with pytest.raises(ValueError) as jax_exc:
            JaxServing(**bad)
        assert str(port_exc.value) == str(jax_exc.value)
    params = _write_npz(pair[2], tmp_path / "p.npz")
    args = build_parser().parse_args(["--model", "test", "--params", str(params), "--device", "cpu", "--server",
                                      "--dtype", "float32", "--cache-len", "64", "--prefill-chunk", "16",
                                      "--page-size", "8"])
    assert args.prefix_cache == 256 and args.drain_deadline == 30.0
    engine, _ = build_engine(args)
    assert engine._prefix_cache is not None and engine._prefix_cache.capacity == 256
    assert engine.kv_layout == "paged" and engine.fused_tail and engine.max_prefill_buckets == 8
    args.prefill_chunk = 0
    capsys.readouterr()
    engine, _ = build_engine(args)
    assert "falling back to --kv-layout slab" in capsys.readouterr().out
    assert engine.kv_layout == "slab" and engine._prefix_cache is None and engine.prefill_chunk == 0
