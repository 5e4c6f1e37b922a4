"""The port's SLO engine and fleet plane (``obs/slo.py``, ``obs/fleet.py``)
against JAX's on identical fixtures.

- ``SLOEngine``: burn rates, verdicts, budgets and the fast-burn callback
  under an injected clock, for latency, availability and ``zero``
  objectives; ``parse_slo_config`` and ``default_objectives``.
- ``parse_exposition`` on a port engine's Prometheus text and on edge
  cases; ``FleetAggregator`` rollups, ``render`` and ``good_total_below``.
- ``estimate_clock_offset``, ``stitch_spans`` / ``verify_stitched``,
  ``detect_stragglers``, ``request_ids_in``, ``TenantLedger`` and the
  ledger helpers.

Every case runs the same calls through both packages and asserts equal
results. Both modules are stdlib-only copies; nothing here touches a card.
"""
import json
import math

import numpy as np
import pytest
import torch

from _torch_serving import make_pair, port_engine
from zero_transformer_tpu.obs import fleet as jfleet
from zero_transformer_tpu.obs import slo as jslo
from zero_transformer_tpu_torch import obs as tobs
from zero_transformer_tpu_torch.obs import fleet as tfleet
from zero_transformer_tpu_torch.obs import slo as tslo

torch.set_num_threads(1)

PLANES = {"jax": (jslo, jfleet), "port": (tslo, tfleet)}


def both(fn):
    """``fn(slo_module, fleet_module)`` for JAX and the port; asserts the
    two results equal and returns the port's."""
    out = {name: fn(*mods) for name, mods in PLANES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_obs_exports_the_fleet_plane():
    for name in ("SLOEngine", "Objective", "parse_slo_config", "default_objectives", "FleetAggregator",
                 "TenantLedger", "parse_exposition", "stitch_spans", "verify_stitched", "estimate_clock_offset",
                 "new_engine_ledger", "complete_ledger", "request_ids_in", "LEDGER_KEYS"):
        assert name in tobs.__all__ and hasattr(tobs, name), name
    assert tfleet.LEDGER_KEYS == jfleet.LEDGER_KEYS
    assert tfleet.FLEET_OBS_REQUIRED_KEYS == jfleet.FLEET_OBS_REQUIRED_KEYS


# ---------------------------------------------------------------- SLO engine


def _series(seed: int, n: int):
    """Cumulative (bad, total) samples: a calm stretch, a burst of bad
    events, then calm again."""
    rng = np.random.default_rng(seed)
    bad = total = 0.0
    out = []
    for i in range(n):
        step = float(rng.integers(5, 20))
        frac = 0.5 if n // 3 <= i < n // 3 + 4 else 0.002
        total += step
        bad += math.floor(step * frac + rng.random())
        out.append((bad, total))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["ratio", "zero"])
def test_slo_engine_burn_rates_under_an_injected_clock(seed, kind):
    series = _series(seed, 40)

    def run(slo, _fleet):
        t = [0.0]
        fired = []
        eng = slo.SLOEngine(clock=lambda: t[0])
        obj = slo.Objective(name="o", metric="availability", kind=kind, target=0.99,
                            short_window_s=5.0, long_window_s=20.0, fast_burn=4.0)
        i = [0]
        eng.add_objective(obj, lambda: series[i[0]])
        eng.on_fast_burn(lambda o, snap: fired.append((o.name, t[0], snap["state"])))
        snaps = []
        for i[0] in range(len(series)):
            t[0] += 1.0
            snaps.append(json.loads(json.dumps(eng.evaluate(), sort_keys=True)))
        return snaps, fired

    snaps, fired = both(run)
    states = {s["objectives"]["o"]["state"] for s in snaps}
    assert "fast_burn" in states and snaps[0]["objectives"]["o"]["state"] != "fast_burn"
    assert fired and fired[0][2] == "fast_burn"


def test_slo_config_parsing_and_defaults():
    spec = [{"name": "ttft", "metric": "ttft_p99", "threshold_s": 0.5, "target": 0.99},
            {"name": "gold", "metric": "ttft_p99", "threshold_s": 0.2, "qos_class": "gold"},
            {"name": "drops", "metric": "dropped_streams", "kind": "zero"}]
    both(lambda slo, _f: [vars(o) for o in slo.parse_slo_config(spec)])
    both(lambda slo, _f: [vars(o) for o in slo.parse_slo_config({"objectives": spec, "qos": {}})])
    objs = both(lambda slo, _f: [vars(o) for o in slo.default_objectives()])
    assert {o["name"] for o in objs} >= {"ttft_p99", "itl_p99", "availability", "dropped_streams"}
    for bad in ([{"name": "x", "metric": "ttft_p99", "oops": 1}], [{"name": "x", "metric": "nope"}]):
        errors = []
        for slo, _f in PLANES.values():
            with pytest.raises(ValueError) as exc:
                slo.parse_slo_config(bad)
            errors.append(str(exc.value))
        assert errors[0] == errors[1]


# --------------------------------------------------------- metrics and ledger


@pytest.fixture(scope="module")
def engine_text():
    """A port engine's Prometheus text after a few requests."""
    _, _, model = make_pair()
    eng = port_engine(model, prefix_cache_chunks=4)
    for i in range(3):
        eng.submit([(5 * i + j) % 200 + 1 for j in range(20 + 3 * i)], max_new_tokens=5)
    eng.run_until_idle()
    return eng.prometheus_text()


def test_parse_exposition_matches_jax(engine_text):
    parsed = both(lambda _s, fleet: fleet.parse_exposition(engine_text))
    assert parsed["serve_tokens_out_total"]["type"] == "counter"
    assert parsed["serve_ttft_seconds"]["type"] == "histogram"
    edge = ("# HELP x_total a\n# TYPE x_total counter\nx_total 3\n"
            'y{replica="a",le="0.5"} 1\ny{replica="b"} NaN\nz +Inf\nbroken line here\n')
    both(lambda _s, fleet: json.dumps(fleet.parse_exposition(edge), sort_keys=True, default=str))


def test_fleet_aggregator_matches_jax(engine_text):
    other = engine_text.replace("serve_tokens_out_total 15", "serve_tokens_out_total 40")

    def run(_s, fleet):
        agg = fleet.FleetAggregator()
        agg.update("r1", "mixed", engine_text)
        agg.update("r2", "decode", other)
        return (agg.render(), agg.good_total_below("serve_ttft_seconds", 0.1),
                agg.good_total_below("serve_ttft_seconds", 1e9), agg.good_total_below("absent", 1.0))

    rendered, *_ = both(run)
    assert "fleet_" in rendered


def test_clock_offset_and_trace_stitching_match_jax():
    both(lambda _s, f: [f.estimate_clock_offset(100.105, t0=0.1, t1=0.11),
                        f.estimate_clock_offset(107.0, t0=5.0, t1=6.0, prev=(100.0, 0.01, 0.11), now=6.0),
                        f.estimate_clock_offset(107.5, t0=50.0, t1=51.0, prev=(100.0, 0.01, 0.11), now=51.0,
                                                max_age_s=30.0)])
    rid = "req-1"
    groups = [
        {"process": "router", "offset_s": 0.0, "spans": [
            {"track": rid, "name": "route", "t0": 10.0, "t1": 11.0, "attrs": {"outcome": "done"}},
            {"track": rid, "name": "relay", "t0": 10.01, "t1": 10.99, "attrs": {"replica": "a", "hop": 0}}]},
        {"process": "replica a", "offset_s": 5.0, "spans": [
            {"track": rid, "name": "request", "t0": 15.02, "t1": 15.98, "attrs": {"hop": 0}},
            {"track": rid, "name": "queue", "t0": 15.02, "t1": 15.1, "attrs": None},
            {"track": "engine", "name": "tick", "t0": 15.2, "t1": 15.3, "attrs": {"tick": 1}}]},
        {"process": "replica b", "offset_s": -2.0, "spans": [
            {"track": rid, "name": "request", "t0": 7.5, "t1": 8.5, "attrs": {"hop": 1}}]},
    ]
    doc, verdict, ids = both(lambda _s, f: (f.stitch_spans(groups), f.verify_stitched(f.stitch_spans(groups), rid),
                                            f.request_ids_in(f.stitch_spans(groups))))
    assert ids == [rid] and verdict["orphans"]


def test_stragglers_and_ledgers_match_jax():
    groups = [{"process": f"w{i}", "spans": [{"track": "t", "name": "compute", "t0": float(j),
                                              "t1": float(j) + (0.5 if i == 2 else 0.1), "attrs": None}
                                             for j in range(6)]} for i in range(4)]
    result = both(lambda _s, f: f.detect_stragglers(groups))
    assert result["w2"]["straggler"] and not result["w0"]["straggler"]

    def ledgers(_s, f):
        tl = f.TenantLedger(capacity=3)
        tl.record("prod", {"tokens_out": 10})
        for i in range(5):
            tl.record(f"t{i}", {"tokens_out": 1, "decode_ms": 2.5})
            tl.record("prod", {"tokens_out": 10})
        return (tl.snapshot(), tl.totals(), f.new_engine_ledger(),
                f.complete_ledger({"tokens_out": 3, "queue_ms": "x"}, failovers=1, replayed_tokens=2),
                f.complete_ledger(None))

    both(ledgers)
