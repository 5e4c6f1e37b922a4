"""The port's disaggregated replicas over HTTP, fronted by JAX's router
and by the port's (each case runs under both).

- A ``RouterServer`` (HTTP only, no device code) over a port
  ``--role prefill`` server and a port ``--role decode`` server splits a
  request by phase (``prefill_to`` dispatch, the page ship to
  ``/ingest``, ``/attach``): the client's SSE ids equal JAX ``generate``,
  one disaggregated dispatch, zero replayed tokens, no dropped stream.
- ``POST /admin/migrate`` on the replica serving a routed stream moves it
  to the other replica mid-decode; the router follows the ``migrated``
  done event with an attach, with zero replay.
- The port's routes: ``/healthz`` reports the role, free pages and
  migrations in flight; ``/ingest`` answers 400 on a torn blob and 413
  past its bound; ``/attach`` is consume-once (404 after); ``/admin/migrate``
  404s an unknown stream; a ship to a dead port fails the stream
  retryably with a flight dump.
- The serve CLI's ``--role`` equals JAX's flag (default and choices).
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_serving import WEIGHT_SCALE, http_call, make_pair, sse_events, wait_for
from zero_transformer_tpu.inference.generate import decode_model as jax_decode_model
from zero_transformer_tpu.inference.generate import generate as jax_generate
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.serving import RouterServer as JaxRouterServer
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.serving import RouterServer, ServingEngine, ServingServer, page_span_to_wire

torch.set_num_threads(1)

CACHE_LEN, CHUNK, PAGE = 48, 8, 4


class _Tok:
    """JAX's test tokenizer: bytes shifted into 1..250, ids shown as <id>."""

    eos_token_id = None

    def encode(self, text):
        return [1 + (b % 250) for b in text.encode()]

    def decode(self, ids, **kw):
        return "".join(f"<{t}>" for t in ids)


@pytest.fixture(params=["jax", "port"])
def router_cls(request):
    """The fleet router of either package."""
    return {"jax": JaxRouterServer, "port": RouterServer}[request.param]


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0, scale=WEIGHT_SCALE)


def _prompt(length, offset=0):
    return [(3 + offset + i) % 250 + 1 for i in range(length)]


def jax_reference(pair, prompt, max_new):
    jcfg, params, _ = pair
    toks = jax_generate(jax_decode_model(jcfg, CACHE_LEN), params, jnp.asarray([prompt], jnp.int32), max_new,
                        jax.random.PRNGKey(0), JaxSampling(greedy=True))
    return jax.device_get(toks)[0].tolist()


def _server(pair, role, tick_s=0.0, **kw):
    engine = ServingEngine(pair[2], n_slots=2, cache_len=CACHE_LEN, sampling=SamplingConfig(greedy=True),
                           prefill_chunk=CHUNK, page_size=PAGE, device="cpu", role=role, **kw)
    if tick_s:
        step = engine.step
        engine.step = lambda: (time.sleep(tick_s), step())[1]  # slow ticks: a window to act mid-stream
    server = ServingServer(engine, _Tok(), port=0)
    server.start()
    return engine, server


def _sse(port, path, body, timeout=120.0):
    status, headers, raw = http_call(port, "POST", path, body, timeout=timeout)
    if "text/event-stream" not in headers.get("Content-Type", ""):
        return status, [], json.loads(raw or b"{}")
    events = sse_events(raw)
    ids = [int(e["token"]) for e in events if "token" in e]
    done = next((e for e in events if e.get("done")), None)
    return status, ids, done


def _router(router_cls, *servers):
    router = router_cls([f"127.0.0.1:{s.port}" for s in servers], probe_interval=0.05, chunk_tokens=CHUNK,
                          stream_timeout=120.0)
    router.start()
    assert router.wait_ready(30)
    return router


def test_router_disaggregates_and_stream_is_jax_generate(pair, router_cls):
    ed, sd = _server(pair, "decode")
    ep, sp = _server(pair, "prefill")
    router = _router(router_cls, sp, sd)
    try:
        wait_for(lambda: any(r.role == "prefill" for r in router.registry.routable()), 30, "role scrape")
        prompt = _prompt(13)
        expect = jax_reference(pair, prompt, 8)
        status, ids, done = _sse(router.port, "/generate", {"tokens": prompt, "max_new_tokens": 8, "seed": 3})
        assert status == 200 and done and done.get("status") == "done", done
        assert ids == expect
        assert router.stats["disagg_dispatches"] == 1
        assert router.stats["resume_replayed_tokens"] == 0 and router.stats["dropped_streams"] == 0
        assert ep.stats["prefill_handoffs"] == 1 and ep.stats["decode_ticks"] == 0
        assert ed.stats["migrations_in"] == 1 and ed.stats["prefill_chunks"] == 0
        # the prefill replica's JSON answer names the decode replica
        status, _, doc = _sse(sp.port, "/generate", {"tokens": prompt, "max_new_tokens": 4, "stream": False,
                                                     "prefill_to": f"http://127.0.0.1:{sd.port}",
                                                     "request_id": "json-1"})
        assert doc["status"] == "migrated" and doc["migrated_to"] == f"http://127.0.0.1:{sd.port}"
        status, ids, done = _sse(sd.port, "/attach", {"request_id": "json-1"})
        assert done["status"] == "done" and ids == expect[:4]
        assert _sse(sd.port, "/attach", {"request_id": "json-1"})[0] == 404  # consume-once
    finally:
        router.stop()
        sd.stop()
        sp.stop()


def test_admin_migrate_moves_a_live_routed_stream(pair, router_cls):
    e1, s1 = _server(pair, "mixed", tick_s=0.02)
    e2, s2 = _server(pair, "mixed", tick_s=0.02)
    router = _router(router_cls, s1, s2)
    try:
        prompt = _prompt(13)
        expect = jax_reference(pair, prompt, 24)
        got = {}

        def client():
            got["r"] = _sse(router.port, "/generate",
                            {"tokens": prompt, "max_new_tokens": 24, "seed": 7, "request_id": "live-mig-1"})

        t = threading.Thread(target=client, daemon=True)
        t.start()
        src = {}

        def find_src():
            for e, s, other in ((e1, s1, s2), (e2, s2, s1)):
                for act in list(e._active):
                    if act is not None and act.handle.rid == "live-mig-1" and len(act.handle.tokens) >= 3:
                        src["server"], src["target"] = s, other
                        return True
            return False

        wait_for(find_src, 60, "stream decoding on a replica")
        status, _, body = http_call(src["server"].port, "POST", "/admin/migrate",
                                    {"request_id": "live-mig-1", "target": f"http://127.0.0.1:{src['target'].port}"})
        assert status == 202, body
        t.join(timeout=120)
        assert not t.is_alive(), "the migrated stream hung"
        _, ids, done = got["r"]
        assert done and done.get("status") == "done", done
        assert ids == expect
        assert router.stats["migration_resumes"] == 1
        assert router.stats["resume_replayed_tokens"] == 0 and router.stats["dropped_streams"] == 0
        assert src["target"].engine.stats["prefill_chunks"] == 0
    finally:
        router.stop()
        s1.stop()
        s2.stop()


def test_port_routes_health_ingest_and_failed_ship(pair, tmp_path):
    ed, sd = _server(pair, "decode")
    ep, sp = _server(pair, "prefill", obs_dir=str(tmp_path))
    try:
        sp.max_ingest_bytes = 64
        for s, role in ((sd, "decode"), (sp, "prefill")):
            status, _, raw = http_call(s.port, "GET", "/healthz")
            health = json.loads(raw)
            assert status == 200 and health["role"] == role
            assert health["migrations_in_flight"] == 0 and health["free_pages"] == ed.free_pages
            assert health["kernel_paged_attention"] == 0  # the CPU's plain path
        assert http_call(sd.port, "POST", "/ingest", b"ZTPG1 torn")[0] == 400
        assert http_call(sp.port, "POST", "/ingest", b"x" * 65)[0] == 413
        blob = page_span_to_wire({"kind": "decode", "prompt": [1], "max_new_tokens": 2, "page_size": PAGE,
                                  "n_blocks": 0, "leaves": {}})
        status, _, raw = http_call(sd.port, "POST", "/ingest", blob)
        assert status == 503 and "bad import payload" in json.loads(raw)["error"]
        assert http_call(sd.port, "POST", "/attach", {"request_id": "nobody"})[0] == 404
        assert http_call(sd.port, "POST", "/admin/migrate", {"request_id": "nobody", "target": "x"})[0] == 404
        assert http_call(sd.port, "POST", "/admin/migrate_all", {"target": "x"})[0] == 202
        # a prefill-role replica needs a decode target, and refuses imports
        status, _, doc = _sse(sp.port, "/generate", {"tokens": _prompt(9), "max_new_tokens": 4})
        assert status == 400 and "prefill_to" in doc["error"]
        # a ship to a dead port: the stream ends failed and retryable, the flight recorder dumps
        status, ids, done = _sse(sp.port, "/generate", {"tokens": _prompt(9), "max_new_tokens": 4,
                                                        "prefill_to": "http://127.0.0.1:9"})
        assert status == 200 and ids == [] and done["status"] == "failed" and done["retryable"], done
        assert "migration failed" in done["error"] and ep.stats["migration_failures"] == 1
        assert list((tmp_path / "flightrec").glob("*migration_failed*"))
        text = http_call(sp.port, "GET", "/metrics?format=prometheus")[2].decode()
        assert "serve_migration_failures_total 1" in text and "serve_migrations_in_flight 0" in text
    finally:
        sd.stop()
        sp.stop()


def test_cli_role_matches_jax(monkeypatch, capsys):
    """``--role`` as JAX's serve CLI parses it (its parser lives inside
    ``main``: the namespace is captured where it builds the generator):
    the default, each role, and a refused one."""
    from zero_transformer_tpu import serve as jax_serve
    from zero_transformer_tpu_torch import serve

    def jax_args(*more):
        seen = {}

        def capture(args):
            seen.update(vars(args))
            raise SystemExit(0)

        monkeypatch.setattr(jax_serve, "_build_generator", capture)
        with pytest.raises(SystemExit) as exc:
            jax_serve.main(["--model", "test", "--params", "p.msgpack", *more])
        return seen.get("role", exc.value.code)

    def port_args(*more):
        try:
            return serve.build_parser().parse_args(["--model", "test", "--params", "p.npz", *more]).role
        except SystemExit as exc:
            return exc.code

    assert port_args() == jax_args() == "mixed"
    for role in ("mixed", "prefill", "decode", "router"):
        assert port_args("--role", role) == jax_args("--role", role), role
    assert port_args("--role", "router") == 2  # argparse's refusal
    capsys.readouterr()
