"""Observability of the port's serving engine against the JAX package. CPU,
float32, greedy.

- The Prometheus exposition names the same metric families (and types) as
  JAX's ``prometheus_text()`` for the same traffic, and its counters equal
  ``metrics_snapshot()``; the snapshot carries JAX's key set (the JAX
  compile-family sanitizer's ``dispatch_*`` gauges aside: the port has no
  jitted dispatch sites).
- Every request leaves a well-nested span tree keyed by its request id
  (``request`` over ``queue`` / ``prefill`` / ``decode``) whatever its
  outcome; ``X-Request-Id`` is sanitized, echoed in the response headers
  and the final SSE event, and ``GET /admin/spans`` serves the track.
- The flight recorder dumps on a breaker trip and on a drain; a drain
  writes ``trace_serve.json`` and ``spans.jsonl``; ``POST /admin/profile``
  captures a ``torch.profiler`` trace of N busy ticks (202; 409 while one
  runs or without an obs directory); admin routes are loopback-or-token;
  the migration routes (once 501) answer their own refusals.
"""
import json
import re
import socket
from types import SimpleNamespace

import pytest
import torch

from _torch_serving import (ByteTokenizer, FakeClock, http_call, jax_engine, make_pair, port_engine, sse_events,
                            wait_for)
from zero_transformer_tpu_torch.obs import MetricsLogger, coverage_fraction, span_tree
from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey, ServingServer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


def _traffic(engine):
    for i, q in enumerate(("gold", "batch", None)):
        engine.submit([3 + i, 7, 11], max_new_tokens=4, qos=q)
    engine.run_until_idle()
    engine.submit(list(range(1, 40)), max_new_tokens=3)
    engine.run_until_idle()


def _families(text: str):
    return {m.group(1): m.group(2) for m in re.finditer(r"^# TYPE (\S+) (\S+)$", text, re.M)}


def _samples(text: str):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def test_prometheus_families_match_jax(pair):
    jcfg, params, model = pair
    jeng = jax_engine(jcfg, params, prefix_cache_chunks=8, qos={"classes": {}})
    teng = port_engine(model, prefix_cache_chunks=8, qos={"classes": {}})
    _traffic(jeng)
    _traffic(teng)
    port_text, jax_text = teng.prometheus_text(), jeng.prometheus_text()
    assert _families(port_text) == _families(jax_text)
    # the counters and histogram counts of the same traffic agree too
    ps, js = _samples(port_text), _samples(jax_text)
    for name, value in js.items():
        if name.endswith("_total") or name.endswith("_count") or name in ("serve_prefix_cache_entries",
                                                                          "serve_slots", "serve_queue_depth"):
            assert ps[name] == value, name


def test_prometheus_counters_equal_snapshot(pair):
    engine = port_engine(pair[2], prefix_cache_chunks=8)
    _traffic(engine)
    samples, snap = _samples(engine.prometheus_text()), engine.metrics_snapshot()
    counters = [n for n, t in _families(engine.prometheus_text()).items() if t == "counter"]
    assert len(counters) >= 38
    for name in counters:
        key = name[len("serve_"):-len("_total")]
        assert samples[name] == snap[key], name
    assert samples["serve_ttft_seconds_count"] == 4 and snap["completed"] == 4
    assert samples['serve_ttft_seconds_bucket{le="+Inf"}'] == 4


def test_snapshot_carries_jax_keys(pair):
    jcfg, params, model = pair
    jeng, teng = jax_engine(jcfg, params, prefix_cache_chunks=8), port_engine(model, prefix_cache_chunks=8)
    _traffic(jeng)
    _traffic(teng)
    jsnap, tsnap = jeng.metrics_snapshot(), teng.metrics_snapshot()
    missing = {k for k in jsnap if not k.startswith("dispatch_")} - set(tsnap)
    assert not missing, missing
    for key in ("prefix_hits", "prefix_misses", "prefix_stores", "prefix_entries", "cow_copies", "kv_layout",
                "role", "queue_by_class", "brownout_rung", "free_pages", "page_pool_peak"):
        assert tsnap[key] == jsnap[key], key


def test_span_tree_per_request_for_every_outcome(pair):
    clock = FakeClock()
    engine = port_engine(pair[2], n_slots=1, clock=clock)
    done = engine.submit([1, 2, 3], max_new_tokens=3, request_id="req-done")
    clock.t = 1.0
    expired = engine.submit([4, 5], max_new_tokens=3, request_id="req-exp", deadline=1.5)
    rejected = engine.submit([], max_new_tokens=2, request_id="req-rej")  # invalid: an empty prompt
    engine.step()
    clock.t = 2.0
    engine.run_until_idle()
    assert (done.status, expired.status, rejected.status) == ("done", "expired", "rejected")
    spans = engine.tracer.spans()
    for h, phases in ((done, {"queue", "prefill", "decode"}), (expired, {"queue"}), (rejected, {"queue"})):
        tree = span_tree(spans, h.rid)
        assert tree["root"][5]["outcome"] == h.status and tree["root"][5]["id"] == h.rid
        assert {s[2] for s in tree["children"]} == phases
        assert coverage_fraction(tree) == pytest.approx(1.0)
    engine_spans = {s[2] for s in spans if s[1] == "engine"}
    assert {"prefill_chunk", "decode_step", "emit", "tick"} <= engine_spans


def test_request_id_sanitized_and_echoed(pair):
    engine = port_engine(pair[2])
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    try:
        code, headers, body = http_call(server.port, "POST", "/generate",
                                        {"prompt": "hello", "max_new_tokens": 3}, {"X-Request-Id": "trace-1/ab:c"})
        events = sse_events(body)
        assert code == 200 and headers["X-Request-Id"] == "trace-1/ab:c"
        assert events[-1]["request_id"] == "trace-1/ab:c" and events[-1]["done"]
        ledger = events[-1]["ledger"]
        assert ledger["tokens_out"] == 3 and ledger["prefill_chunks"] == 1 and ledger["decode_ticks"] == 3
        code, headers, body = http_call(server.port, "POST", "/generate",
                                        {"prompt": "hi", "max_new_tokens": 2, "stream": False,
                                         "request_id": "bad id\r\nX-Evil: 1"})
        doc = json.loads(body)
        assert code == 200 and doc["request_id"] == headers["X-Request-Id"] == "badidX-Evil:1"
        code, _, body = http_call(server.port, "GET", "/admin/spans?request_id=trace-1/ab:c")
        spans = json.loads(body)["spans"]
        assert code == 200 and {s["name"] for s in spans} == {"request", "queue", "prefill", "decode"}
        assert http_call(server.port, "GET", "/admin/spans?tail=x")[0] == 400
    finally:
        server.stop()


def test_metrics_content_negotiation(pair):
    engine = port_engine(pair[2])
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    try:
        http_call(server.port, "POST", "/generate", {"prompt": "abc", "max_new_tokens": 2, "stream": False})
        code, headers, body = http_call(server.port, "GET", "/metrics",
                                        headers={"Accept": "text/plain;version=0.0.4"})
        text = body.decode()
        assert code == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        assert _samples(text)["serve_completed_total"] == 1 and 'serve_ttft_seconds_bucket{le="+Inf"} 1' in text
        assert http_call(server.port, "GET", "/metrics?format=prometheus")[2].decode().startswith("# HELP")
        code, headers, body = http_call(server.port, "GET", "/metrics")
        assert headers["Content-Type"] == "application/json" and json.loads(body)["completed"] == 1
    finally:
        server.stop()


def test_flight_recorder_dumps_on_breaker_and_drain(pair, tmp_path):
    chaos = ServingChaosMonkey([ServeFault("tick_fault", step=1, duration=3)])
    engine = port_engine(pair[2], n_slots=1, chaos=chaos, obs_dir=str(tmp_path))
    for i in range(3):
        engine.submit([i + 1], max_new_tokens=4)
    for _ in range(4):
        engine.step()
    assert engine.stats["breaker_trips"] == 1
    engine.submit([5, 6], max_new_tokens=3)
    engine.run_until_idle()
    engine.begin_drain(deadline_s=5.0)
    assert engine.poll_drain()
    dumps = sorted(p.name for p in (tmp_path / "flightrec").iterdir())
    assert dumps == ["001_breaker_open.json", "002_drain.json"]
    doc = json.loads((tmp_path / "flightrec" / "001_breaker_open.json").read_text())
    assert doc["extra"]["trips"] == 1 and any(t.get("fault") for t in doc["ticks"])
    assert "tick_fault" in {e["event"] for e in doc["events"]}
    drain = json.loads((tmp_path / "flightrec" / "002_drain.json").read_text())
    assert drain["ticks"] and drain["spans"] and "drain_begin" in {e["event"] for e in drain["events"]}
    trace = json.loads((tmp_path / "trace_serve.json").read_text())
    assert trace["traceEvents"]
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    assert {json.loads(line)["name"] for line in lines} >= {"request", "decode_step"}


def test_admin_profile_capture(pair, tmp_path):
    engine = port_engine(pair[2], obs_dir=str(tmp_path))
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start()
    try:
        code, _, body = http_call(server.port, "POST", "/admin/profile", {"ticks": 2})
        info = json.loads(body)
        assert code == 202 and info["accepted"] and info["path"].startswith(str(tmp_path / "profiles"))
        assert http_call(server.port, "POST", "/admin/profile", {"ticks": 2})[0] == 409  # one at a time
        assert http_call(server.port, "POST", "/admin/profile", {"ticks": "x"})[0] == 400
        http_call(server.port, "POST", "/generate", {"prompt": "abc", "max_new_tokens": 6, "stream": False})
        wait_for(lambda: engine.profiles_completed, msg="the capture")
        assert (tmp_path / "profiles" / info["path"].rsplit("/", 1)[1] / "trace.json").is_file()
        assert not engine.profile_active
    finally:
        server.stop()
    bare = ServingServer(port_engine(pair[2]), ByteTokenizer(), port=0)
    bare.start()
    try:
        assert http_call(bare.port, "POST", "/admin/profile", {"ticks": 2})[0] == 409  # no obs directory
    finally:
        bare.stop()


def test_admin_routes_need_loopback_or_token(pair):
    server = ServingServer(port_engine(pair[2]), ByteTokenizer(), port=0, admin_token="s3cret")
    try:
        def handler(peer, auth=""):
            return SimpleNamespace(client_address=(peer, 1), headers={"Authorization": auth})

        assert server._admin_allowed(handler("127.0.0.1"))
        assert server._admin_allowed(handler("::1"))
        assert not server._admin_allowed(handler("10.0.0.7"))
        assert not server._admin_allowed(handler("10.0.0.7", "Bearer wrong"))
        assert server._admin_allowed(handler("10.0.0.7", "Bearer s3cret"))
        server.admin_token = None
        assert not server._admin_allowed(handler("10.0.0.7", "Bearer s3cret"))
    finally:
        server._httpd.server_close()


@pytest.mark.parametrize("path", ["/attach", "/ingest", "/admin/migrate", "/admin/migrate_all"])
def test_later_slice_routes_answer_501(pair, path):
    """The migration routes, once answered 501, are served: each answers
    its own refusal of a request that names no live or pending stream (or a
    body that is not a page span), an unknown route stays 404, and a
    ``prefill_to`` whose target is down ends the stream ``failed`` and
    retryable."""
    server = ServingServer(port_engine(pair[2]), ByteTokenizer(), port=0)
    server.start()
    try:
        code, _, body = http_call(server.port, "POST", path, {"request_id": "x", "target": "y"})
        want = {"/attach": 404, "/ingest": 400, "/admin/migrate": 404, "/admin/migrate_all": 202}[path]
        assert code == want, (code, body)
        assert http_call(server.port, "POST", "/nope", {})[0] == 404
        with socket.socket() as probe:  # a port nothing listens on
            probe.bind(("127.0.0.1", 0))
            dead = probe.getsockname()[1]
        code, _, body = http_call(server.port, "POST", "/generate",
                                  {"prompt": "a", "prefill_to": f"http://127.0.0.1:{dead}"})
        done = sse_events(body)[-1]
        assert code == 200 and done["status"] == "failed" and done["retryable"], done
    finally:
        server.stop()


def test_metrics_interval_logs_the_snapshot(pair, tmp_path):
    metrics = MetricsLogger(directory=tmp_path)
    engine = port_engine(pair[2], metrics=metrics, metrics_interval=2)
    engine.submit([1, 2], max_new_tokens=5)
    engine.run_until_idle()
    metrics.close()
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in rows if "serve/tokens_out" in r]
    assert [r["step"] for r in logged] == [2, 4] and logged[-1]["serve/tokens_out"] == 4


def test_trace_off_keeps_histograms(pair):
    engine = port_engine(pair[2], trace=False)
    engine.submit([1, 2], max_new_tokens=3)
    engine.run_until_idle()
    assert len(engine.tracer) == 0 and engine._h_ttft.count == 1
