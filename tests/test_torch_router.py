"""The port's fleet router (``serving/router.py``) and its entry point
(``serve_router.py``), against JAX's.

- Pure logic on identical fixtures, both packages, equal results: the
  replica registry's probe state machine (ejection after consecutive
  failures, exponential backoff, recovery, lifecycle states, cordons),
  ``chunk_prefix_key``, ``PrefixAffinity``, ``pick_replica`` and
  ``pick_decode_replica`` over seeded random fleets.
- Each router over its package's ``StubReplica`` (HTTP, no model): the
  relay with ``X-Request-Id``, least-loaded routing, a pre-stream 5xx and
  a mid-stream death resumed token-exactly on the survivor, ejection with
  a flight dump and recovery, a rolling reload under load with zero
  drops, and ``/metrics`` in JSON and Prometheus text.
- The port's router over port CPU replicas (the ``test`` model): routed
  streams equal JAX ``generate`` with prefix affinity, a replica's tick
  fault resumed on the other replica with the exact greedy trajectory, a
  rolling reload with a live stream, ``/slo`` with every default
  objective, the fleet ``/metrics`` parsed by ``parse_exposition``, and
  ``/admin/trace`` passing ``verify_stitched``.
- ``python -m zero_transformer_tpu_torch.serve_router``: ``--replica-worker
  --device cpu`` prints ``REPLICA_PORT`` and serves through a router
  process that prints its bound port; ``--stub`` prints ``STUB_PORT``.
"""
import importlib.util
import json
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import WEIGHT_SCALE, http_call, make_pair, wait_for
from zero_transformer_tpu.inference.generate import decode_model as jax_decode_model
from zero_transformer_tpu.inference.generate import generate as jax_generate
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.serving import router as jrouter
from zero_transformer_tpu_torch import serve_router as tserve_router
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.obs import parse_exposition, verify_stitched
from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey, ServingEngine, ServingServer
from zero_transformer_tpu_torch.serving import router as trouter

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CACHE_LEN = 48


def _jax_serve_router():
    spec = importlib.util.spec_from_file_location("jax_serve_router", ROOT / "scripts" / "serve_router.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLANES = {"port": lambda: (trouter, tserve_router.StubReplica),
          "jax": lambda: (jrouter, _jax_serve_router().StubReplica)}


@pytest.fixture(params=sorted(PLANES))
def plane(request):
    """(router module, StubReplica class) of one package."""
    return PLANES[request.param]()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def both(fn):
    out = {"jax": fn(jrouter), "port": fn(trouter)}
    assert out["port"] == out["jax"]
    return out["port"]


def test_module_surface_matches_jax():
    from zero_transformer_tpu_torch import serving

    for name in ("EJECTED", "PrefixAffinity", "Replica", "ReplicaRegistry", "RouterServer", "chunk_prefix_key",
                 "pick_decode_replica", "pick_replica", "run_router", "SlotKVCache"):
        assert name in serving.__all__ and hasattr(serving, name), name
    assert (trouter.UNKNOWN, trouter.EJECTED) == (jrouter.UNKNOWN, jrouter.EJECTED) == ("unknown", "ejected")
    assert trouter._RID_UNSAFE.pattern == jrouter._RID_UNSAFE.pattern
    assert [f.name for f in trouter.dataclasses.fields(trouter.Replica)] == \
        [f.name for f in jrouter.dataclasses.fields(jrouter.Replica)]


# --------------------------------------------------------------- pure logic


def test_registry_state_machine_matches_jax():
    def run(mod):
        clk = FakeClock()
        reg = mod.ReplicaRegistry(["http://h:1", "http://h:2"], clock=clk, probe_interval=1.0, eject_threshold=3,
                                  backoff_base_s=2.0, backoff_max_s=8.0)
        r1, log = "h:1", []

        def snap(tag):
            rep = reg.get(r1)
            log.append((tag, rep.state, rep.backoff_s, rep.consecutive_failures,
                        sorted(r.id for r in reg.due()), sorted(r.id for r in reg.routable())))

        snap("start")
        log.append(reg.observe_probe(r1, True, 200, {"state": "ready"}))
        for _ in range(3):
            log.append(reg.observe_probe(r1, False))
            snap("fail")
        for dt in (1.0, 1.1, 0.0, 0.0, 0.0):
            clk.t += dt
            snap("wait")
            log.append(reg.observe_probe(r1, False))
        log.append(reg.observe_probe(r1, True, 200, {"state": "ready", "itl_ewma_ms": 3.5, "queue_depth": 7,
                                                     "active_slots": 2, "free_pages": 11}))
        snap("recovered")
        for state, code in (("draining", 503), ("stopped", 503), ("degraded", 503), ("starting", 503),
                            ("ready", 200)):
            reg.observe_probe(r1, True, code, {"state": state})
            snap(state)
        reg.cordon(r1)
        snap("cordoned")
        reg.uncordon(r1)
        log.append(reg.observe_relay_failure(r1, "connect refused"))
        snap("relay failure")
        rep = reg.get(r1)
        log.append((rep.itl_ewma_ms, rep.queue_depth, rep.active_slots, rep.free_pages))
        return log

    log = both(run)
    assert [("ejected", "h:1")] in log and any(isinstance(e, list) and ("recovered", "h:1") in e for e in log)
    assert any(isinstance(e, tuple) and e[:3] == ("fail", "ejected", 2.0) for e in log)


@pytest.mark.parametrize("prompt,chunk", [(None, 4), ([1, 2, 3], 4), ([1, 2, 3, 4], 4), ([1, 2, 3, 4, 5, 6], 4),
                                          (list(range(8)), 4), (list(range(130)), 64), ([], 8)])
def test_chunk_prefix_key_matches_jax(prompt, chunk):
    both(lambda mod: mod.chunk_prefix_key(prompt, chunk))


def test_affinity_matches_jax():
    def run(mod):
        aff = mod.PrefixAffinity(chunk_tokens=4, capacity=8)
        a = [1, 2, 3, 4, 5, 6, 7, 8, 9]
        aff.record(a, "r1")
        out = [aff.lookup([1, 2, 3, 4, 99, 98, 97, 96]), aff.lookup(a), aff.lookup([9, 9, 9, 9])]
        aff.record([1, 2, 3, 4, 5, 6, 7, 8], "r2")
        out += [aff.lookup(a), aff.lookup([1, 2, 3, 4, 50])]
        aff.forget_replica("r2")
        out.append(aff.lookup(a))
        for i in range(20):
            aff.record([i] * 4, "rX")
        return out + [len(aff), aff.lookup([19] * 4), aff.lookup([0] * 4)]

    out = both(run)
    assert out[:6] == ["r1", "r1", None, "r2", "r2", None]


@pytest.mark.parametrize("seed", range(4))
def test_pick_policies_match_jax_on_random_fleets(seed):
    rng = np.random.default_rng(seed)
    states = ["ready", "degraded", "ejected", "draining", "unknown"]
    fleets = []
    for _ in range(50):
        n = int(rng.integers(0, 6))
        fleets.append([dict(id=f"r{i}", state=states[int(rng.integers(0, 5))], q=int(rng.integers(0, 4)),
                            itl=float(rng.choice([0.0, 1.0, 2.5, 10.0])), slots=int(rng.integers(0, 3)),
                            relays=int(rng.integers(0, 3)), free=int(rng.integers(0, 9)))
                       for i in range(n)])

    def run(mod):
        out = []
        for fleet in fleets:
            reps = []
            for f in fleet:
                r = mod.Replica(id=f["id"], url=f"http://h/{f['id']}", host="h", port=1)
                r.state, r.queue_depth, r.itl_ewma_ms = f["state"], f["q"], f["itl"]
                r.active_slots, r.active_relays, r.free_pages = f["slots"], f["relays"], f["free"]
                reps.append(r)
            pick = mod.pick_replica(reps)
            aff = mod.pick_replica(reps, affinity_id=fleet[-1]["id"] if fleet else None)
            dec = mod.pick_decode_replica(reps)
            out.append(tuple(None if r is None else r.id for r in (pick, aff, dec)))
        return out

    picks = both(run)
    assert any(p[0] is not None for p in picks)


# ---------------------------------------------------------- stub fleets (HTTP)


def _sse(port, body, headers=None, timeout=60.0):
    """(status, headers, events, json doc) of one POST /generate."""
    status, hdrs, raw = http_call(port, "POST", "/generate", body, headers=headers, timeout=timeout)
    if "text/event-stream" not in hdrs.get("Content-Type", ""):
        return status, hdrs, [], json.loads(raw or b"{}")
    return status, hdrs, [json.loads(x[6:]) for x in raw.splitlines() if x.startswith(b"data: ")], None


def _ids(events):
    return [e["token"] for e in events if "token" in e]


def test_relay_propagates_request_id_and_least_loaded(plane):
    mod, Stub = plane
    stubs = [Stub(itl_s=0.001).start() for _ in range(2)]
    router = mod.RouterServer([s.url for s in stubs], chunk_tokens=4)
    router.start(probe=False)  # the registry is hand-fed: scraped load stays as set
    try:
        ids = [f"127.0.0.1:{s.port}" for s in stubs]
        router.registry.observe_probe(ids[0], True, 200, {"state": "ready", "queue_depth": 3, "itl_ewma_ms": 2.0})
        router.registry.observe_probe(ids[1], True, 200, {"state": "ready", "queue_depth": 0, "itl_ewma_ms": 2.0})
        status, hdrs, events, _ = _sse(router.port, {"tokens": [1, 2, 3, 4, 5], "max_new_tokens": 6},
                                       headers={"X-Request-Id": "client-id-042"})
        done = events[-1]
        assert status == 200 and hdrs["X-Request-Id"] == "client-id-042"
        assert done["status"] == "done" and done["request_id"] == "client-id-042" and done["failovers"] == 0
        assert _ids(events) == list(range(1005, 1011))
        # least-loaded: the replica with no backlog served it
        assert stubs[1].seen_request_ids == ["client-id-042"] and not stubs[0].requests
        relays = [s for s in router.tracer.by_track("client-id-042") if s[2] == "relay"]
        assert [s[5]["replica"] for s in relays] == [ids[1]]
        # the backlog moves: a new prefix goes to the other replica now
        router.registry.observe_probe(ids[1], True, 200, {"state": "ready", "queue_depth": 9, "itl_ewma_ms": 2.0})
        _, _, _, doc = _sse(router.port, {"tokens": [9, 8, 7, 6, 5], "max_new_tokens": 3, "stream": False})
        assert doc["status"] == "done" and doc["tokens"] == list(range(1005, 1008)) and doc["replica"] == ids[0]
        assert router.stats["tokens_relayed"] == 9 and router.stats["dropped_streams"] == 0
    finally:
        router.stop()
        for s in stubs:
            s.stop()


def test_prestream_5xx_and_midstream_death_fail_over_exactly(plane):
    mod, Stub = plane
    a = Stub(itl_s=0.005, die_after_tokens=3).start()
    sick = Stub(fail_5xx_requests=1).start()
    b = Stub(itl_s=0.005).start()
    router = mod.RouterServer([a.url, sick.url, b.url], chunk_tokens=4, max_attempts=3)
    router.start(probe=False)
    try:
        ids = {s: f"127.0.0.1:{s.port}" for s in (a, sick, b)}
        for rid in ids.values():
            router.registry.observe_probe(rid, True, 200, {"state": "ready"})
        router.registry.get(ids[sick]).queue_depth = 99
        tokens = [7, 8, 9, 10]
        router.affinity.record(tokens, ids[a])
        status, _, events, _ = _sse(router.port, {"tokens": tokens, "max_new_tokens": 6},
                                    headers={"X-Request-Id": "failover-1"})
        done = events[-1]
        assert done["status"] == "done" and done["failovers"] == 1, done
        # a emitted 1004..1006 and died; b resumed prompt + generated -> one continuous sequence
        assert _ids(events) == [1004, 1005, 1006, 1007, 1008, 1009]
        assert b.seen_bodies[-1]["tokens"] == tokens + [1004, 1005, 1006]
        assert b.seen_bodies[-1]["max_new_tokens"] == 3
        assert router.stats["resumed_streams"] == 1 and router.stats["dropped_streams"] == 0
        assert router.affinity.lookup(tokens) == ids[b]
        # a pre-stream 500 fails over silently and feeds the victim's breaker
        router.affinity.record([6, 6, 6, 6], ids[sick])
        _, _, events, _ = _sse(router.port, {"tokens": [6, 6, 6, 6], "max_new_tokens": 4})
        assert events[-1]["status"] == "done" and _ids(events) == [1004, 1005, 1006, 1007]
        assert router.registry.get(ids[sick]).consecutive_failures >= 1
        assert router.stats["failovers"] == 2
    finally:
        router.stop()
        for s in (a, sick, b):
            s.stop()


def test_ejection_dumps_flight_recorder_and_recovers(plane, tmp_path):
    mod, Stub = plane
    stub = Stub().start()
    port, rid = stub.port, f"127.0.0.1:{stub.port}"
    router = mod.RouterServer([stub.url], probe_interval=0.02, eject_threshold=3, backoff_base_s=0.05,
                              backoff_max_s=0.2, obs_dir=str(tmp_path))
    router.start()
    try:
        assert router.wait_ready(10.0)
        stub.stop()
        wait_for(lambda: router.registry.get(rid).state == "ejected", 10, "ejection")
        assert router.stats["ejections"] == 1
        dumps = list((tmp_path / "flightrec").glob("*replica_ejected*.json"))
        assert len(dumps) == 1 and json.loads(dumps[0].read_text())["extra"]["replica"] == rid
        assert http_call(router.port, "GET", "/healthz")[0] == 503
        stub2 = Stub(port=port).start()
        try:
            wait_for(lambda: router.registry.get(rid).state == "ready", 10, "recovery")
            assert router.stats["recoveries"] == 1 and http_call(router.port, "GET", "/healthz")[0] == 200
        finally:
            stub2.stop()
    finally:
        router.stop()


def test_rolling_reload_under_load_drops_nothing(plane):
    mod, Stub = plane
    stubs = [Stub(itl_s=0.005, slots=4).start() for _ in range(2)]
    router = mod.RouterServer([s.url for s in stubs], probe_interval=0.02, chunk_tokens=4)
    router.start()
    results = []
    try:
        wait_for(lambda: len(router.registry.routable()) == 2, 10, "fleet ready")

        def client(i):
            for j in range(3):
                _, _, events, doc = _sse(router.port, {"tokens": [i, j, 1, 2], "max_new_tokens": 20})
                results.append(events[-1] if events else doc)

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        ok, steps = router.rolling_reload(drain_timeout_s=30.0, ready_timeout_s=30.0)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ok and [s["ok"] for s in steps] == [True, True]
        assert all(s.reloads == 1 for s in stubs)
        assert len(results) == 12 and all(r.get("status") == "done" for r in results)
        assert router.stats["dropped_streams"] == 0 and router.stats["reload_steps"] == 2
    finally:
        router.stop()
        for s in stubs:
            s.stop()


def test_router_metrics_json_and_prometheus(plane):
    mod, Stub = plane
    stub = Stub(itl_s=0.001).start()
    router = mod.RouterServer([stub.url], probe_interval=0.02, chunk_tokens=4)
    router.start()
    try:
        assert router.wait_ready(10.0)
        _sse(router.port, {"tokens": [1, 2, 3, 4], "max_new_tokens": 2})
        snap = json.loads(http_call(router.port, "GET", "/metrics")[2])
        assert snap["requests"] == 1 and snap["tokens_relayed"] == 2 and snap["routable_replicas"] == 1
        text = http_call(router.port, "GET", "/metrics", headers={"Accept": "text/plain"})[2].decode()
        parsed = parse_exposition(text)
        assert parsed["router_requests_total"]["samples"] and "router_tokens_relayed_total 2" in text
        assert 'router_replica_up{replica="127.0.0.1:' in text
    finally:
        router.stop()
        stub.stop()


# ----------------------------------------------------- port CPU replicas


class _Tok:
    """JAX's test tokenizer: bytes shifted into 1..250, ids shown as <id>."""

    eos_token_id = None

    def encode(self, text):
        return [1 + (b % 250) for b in text.encode()]

    def decode(self, ids, **kw):
        return "".join(f"<{t}>" for t in ids)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0, scale=WEIGHT_SCALE)


def jax_reference(pair, prompt, max_new):
    jcfg, params, _ = pair
    toks = jax_generate(jax_decode_model(jcfg, CACHE_LEN), params, jnp.asarray([prompt], jnp.int32), max_new,
                        jax.random.PRNGKey(0), JaxSampling(greedy=True))
    return jax.device_get(toks)[0].tolist()


def _replica(pair, chaos=None, reload_source=None, **kw):
    engine = ServingEngine(pair[2], n_slots=2, cache_len=CACHE_LEN, sampling=SamplingConfig(greedy=True),
                           prefill_chunk=8, page_size=4, device="cpu", chaos=chaos, **kw)
    server = ServingServer(engine, _Tok(), port=0, reload_source=reload_source)
    server.start()
    return server


def test_port_fleet_affinity_parity_slo_metrics_and_trace(pair):
    servers = [_replica(pair) for _ in range(2)]
    router = trouter.RouterServer([f"http://127.0.0.1:{s.port}" for s in servers], probe_interval=0.05,
                                  chunk_tokens=4, stream_timeout=120, metrics_scrape_interval=0.05)
    router.start()
    try:
        wait_for(lambda: len(router.registry.routable()) == 2, 30, "fleet ready")
        routed = {0: set(), 1: set()}
        for g, prefix in enumerate(([3, 5, 7, 9, 11, 13], [4, 6, 8, 10, 12, 14])):
            for tail in ([17, 19], [21, 23], [25, 27]):
                prompt = prefix + tail
                _, _, events, _ = _sse(router.port, {"tokens": prompt, "max_new_tokens": 8},
                                       headers={"X-Request-Id": f"g{g}-{tail[0]}"}, timeout=120)
                assert events[-1]["status"] == "done", events[-1]
                assert _ids(events) == jax_reference(pair, prompt, 8), prompt
                routed[g].add(router.affinity.lookup(prompt))
        assert all(len(v) == 1 for v in routed.values()), routed
        assert router.stats["affinity_hits"] == 4 and router.stats["failovers"] == 0
        # the SLO engine answers with every default objective
        slo = json.loads(http_call(router.port, "GET", "/slo")[2])
        assert set(slo["objectives"]) >= {o.name for o in trouter.default_objectives()}
        # the fleet /metrics folds the replicas' families
        wait_for(lambda: "fleet_serve_tokens_out_total" in http_call(
            router.port, "GET", "/metrics", headers={"Accept": "text/plain"})[2].decode(), 30, "fleet rollup")
        fleet = parse_exposition(http_call(router.port, "GET", "/metrics", headers={"Accept": "text/plain"})[2]
                                 .decode())
        assert "fleet_serve_tokens_out_total" in fleet and "router_requests_total" in fleet
        # one request's stitched trace over the router and its replica
        status, _, raw = http_call(router.port, "GET", "/admin/trace?request_id=g0-17")
        assert status == 200
        verdict = verify_stitched(json.loads(raw), "g0-17", slack_s=0.25)
        assert not verdict["orphans"] and verdict["coverage"] >= 0.95, verdict
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_port_fleet_failover_resumes_exact_greedy_trajectory(pair):
    chaos = ServingChaosMonkey([ServeFault("tick_fault", step=2, duration=1)])
    a, b = _replica(pair, chaos=chaos), _replica(pair)
    a_id, b_id = f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"
    router = trouter.RouterServer([f"http://{a_id}", f"http://{b_id}"], probe_interval=0.05, chunk_tokens=4,
                                  stream_timeout=120)
    router.start()
    try:
        wait_for(lambda: len(router.registry.routable()) == 2, 30, "fleet ready")
        prompt = [9, 11, 13, 15, 17, 19]
        router.affinity.record(prompt, a_id)
        _, _, events, _ = _sse(router.port, {"tokens": prompt, "max_new_tokens": 10},
                               headers={"X-Request-Id": "fleet-failover"}, timeout=240)
        done = events[-1]
        assert done["status"] == "done" and done["failovers"] == 1, done
        assert _ids(events) == jax_reference(pair, prompt, 10)
        assert router.stats["resumed_streams"] == 1
        relays = [s for s in router.tracer.by_track("fleet-failover") if s[2] == "relay"]
        assert [s[5]["replica"] for s in relays] == [a_id, b_id]
    finally:
        router.stop()
        for s in (a, b):
            s.stop()


def test_port_fleet_rolling_reload_with_live_stream(pair):
    state = pair[2].state_dict()
    servers = [_replica(pair, reload_source=lambda path=None: state) for _ in range(2)]
    for s in servers:  # a reload copies into the engine's model in place: give each its own
        s.engine.model = type(s.engine.model)(s.engine.cfg, device="cpu")
        s.engine.model.load_state_dict(state)
    router = trouter.RouterServer([f"http://127.0.0.1:{s.port}" for s in servers], probe_interval=0.05,
                                  chunk_tokens=4, stream_timeout=120)
    router.start()
    out = {}
    try:
        wait_for(lambda: len(router.registry.routable()) == 2, 30, "fleet ready")
        prompt = [2, 4, 6, 8]

        def client():
            out["r"] = _sse(router.port, {"tokens": prompt, "max_new_tokens": 32}, timeout=240)

        t = threading.Thread(target=client, daemon=True)
        t.start()
        time.sleep(0.05)
        ok, steps = router.rolling_reload(drain_timeout_s=120.0, ready_timeout_s=120.0)
        t.join(timeout=240)
        assert not t.is_alive() and ok and [s["ok"] for s in steps] == [True, True], steps
        _, _, events, _ = out["r"]
        assert events[-1]["status"] == "done" and _ids(events) == jax_reference(pair, prompt, 32)
        assert router.stats["dropped_streams"] == 0
        assert [json.loads(http_call(s.port, "GET", "/healthz")[2])["reloads"] for s in servers] == [1, 1]
    finally:
        router.stop()
        for s in servers:
            s.stop()


# ------------------------------------------------------------ the entry point


def _spawn(*args):
    proc = subprocess.Popen([sys.executable, "-m", "zero_transformer_tpu_torch.serve_router", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def _printed(proc, lines, pattern, timeout=240.0):
    found = {}

    def seen():
        for line in lines:
            m = re.search(pattern, line)
            if m:
                found["v"] = int(m.group(1))
                return True
        assert proc.poll() is None, "".join(lines)
        return False

    wait_for(seen, timeout, pattern)
    return found["v"]


def test_cli_worker_router_and_stub_processes():
    """Two ``--replica-worker --device cpu`` processes (slab one-shot, as
    JAX's workers with ``--prefill-chunk 0``) behind a router process on
    ``--port 0``: the router prints its bound port, a routed stream equals
    an in-process engine on the same seed's weights, SIGTERM ends each
    process with 0. ``--stub`` prints its port and answers the surface."""
    from zero_transformer_tpu_torch.models import model_getter

    worker_args = ["--replica-worker", "--device", "cpu", "--port", "0", "--greedy", "--cache-len", "64",
                   "--slots", "2", "--prefill-chunk", "0", "--init-seed", "3"]
    workers = [_spawn(*worker_args) for _ in range(2)]
    stub = _spawn("--stub", "--port", "0", "--itl-ms", "1")
    procs = [p for p, _ in workers] + [stub[0]]
    try:
        ports = [_printed(p, lines, r"REPLICA_PORT=(\d+)") for p, lines in workers]
        stub_port = _printed(*stub, r"STUB_PORT=(\d+)")
        router, lines = _spawn(*sum((["--replica", f"http://127.0.0.1:{p}"] for p in ports), []), "--port", "0",
                               "--probe-interval", "0.05", "--chunk-tokens", "8")
        procs.append(router)
        rport = _printed(router, lines, r"routing on http://127\.0\.0\.1:(\d+)")
        wait_for(lambda: http_call(rport, "GET", "/healthz")[0] == 200, 60, "router ready")
        prompt = [5, 9, 13, 17, 21, 25, 29, 33, 37]
        _, _, events, _ = _sse(rport, {"tokens": prompt, "max_new_tokens": 6}, timeout=120)
        assert events[-1]["status"] == "done", events[-1]
        model = model_getter("test", device="cpu", seed=3, dropout=0.0)
        eng = ServingEngine(model, n_slots=1, cache_len=64, sampling=SamplingConfig(temperature=0.9, top_k=20,
                                                                                    greedy=True),
                            prefill_chunk=0, kv_layout="slab", device="cpu")
        h = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle()
        assert _ids(events) == h.tokens
        _, _, events, _ = _sse(stub_port, {"tokens": [1, 2, 3], "max_new_tokens": 3})
        assert _ids(events) == [1003, 1004, 1005]
        for p in [router] + [w for w, _ in workers]:
            p.send_signal(signal.SIGTERM)
        for p in [router] + [w for w, _ in workers]:
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
