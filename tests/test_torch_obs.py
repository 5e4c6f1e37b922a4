"""The port's training observability (``obs/``) on the CPU.

- ``Tracer``: the ring's bound and drop count, the Perfetto export and the
  incremental ``spans.jsonl``.
- ``Registry``: the exposition text byte-equal to JAX's ``Registry`` fed the
  same observations (counters, gauges, labelled callback gauges, histograms,
  escaped help), and conformant to the 0.0.4 grammar (JAX
  ``tests/test_obs.py``'s checker).
- ``parse_profile_window`` equal to JAX's on good and bad specs.
- A ``FlightRecorder`` without a directory records and never writes.
- ``hbm_device_stats`` is None off a card; ``MetricsLogger.event`` tags a
  line of the timeline.
- A CPU trainer run writes ``spans.jsonl`` holding the six span names
  (``data_fetch``, ``dispatch``, ``device_sync``, ``checkpoint_save``,
  ``replica_audit``, ``evaluate``) and ``trace_train.json`` beside
  ``metrics.jsonl``, and its flight ring holds the log points.
- The CLI's ``--metrics-port`` serves conformant ``/metrics`` with the
  trainer's gauge; ``--profile-window 3:2`` writes a Chrome trace of
  steps 3 and 4 and of no other step.
"""
import json
import re
import socket
import urllib.request
from pathlib import Path

import pytest
import torch

from zero_transformer_tpu import obs as jobs
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch import obs
from zero_transformer_tpu_torch import train as ttrain
from zero_transformer_tpu_torch.obs import spans
from zero_transformer_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
TRAIN_TEST = str(ROOT / "configs" / "train_test.yaml")
SPAN_NAMES = {"data_fetch", "dispatch", "device_sync", "checkpoint_save", "replica_audit", "evaluate"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------------ tracer


def test_tracer_ring_bounds_and_drop_count():
    tr = obs.Tracer(capacity=4)
    for i in range(10):
        tr.add("s", "t", float(i), float(i) + 0.5)
    assert len(tr) == 4 and tr.dropped == 6
    doc = tr.chrome_trace()
    assert doc["otherData"]["dropped_spans"] == 6
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 4
    assert [e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"] == ["t"]
    disabled = obs.Tracer(enabled=False)
    disabled.add("s", "t", 0.0, 1.0)
    with disabled.span("x"):
        pass
    assert len(disabled) == 0


def test_tracer_jsonl_is_incremental(tmp_path):
    tr = obs.Tracer()
    tr.add("a", "t", 0.0, 1.0)
    path = tmp_path / "spans.jsonl"
    assert tr.write_jsonl(path) == 1
    assert tr.write_jsonl(path) == 0
    with tr.span("b", "t", k=1):
        pass
    assert tr.write_jsonl(path) == 1
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["a", "b"] and lines[1]["attrs"] == {"k": 1}
    root = (0, "r1", "request", 0.0, 10.0, None)
    kids = [(1, "r1", "queue", 0.0, 4.0, None), (2, "r1", "decode", 3.0, 9.0, None)]
    assert obs.coverage_fraction(obs.span_tree([root, *kids], "r1")) == pytest.approx(0.9)
    assert obs.span_dict(root) == {"track": "r1", "name": "request", "t0": 0.0, "t1": 10.0, "attrs": None}


# ---------------------------------------------------------------- registry

EXPOSITION_LINE = re.compile(
    r"^(?:"
    r"# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|"
    r'[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)+\})?'
    r" (?:NaN|[+-]Inf|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)"
    r")$"
)


def assert_conformant(text: str, histograms: bool = True) -> None:
    """Every line in the 0.0.4 grammar; histogram buckets cumulative with
    ``+Inf`` equal to ``_count`` (JAX ``tests/test_obs.py``)."""
    assert text.endswith("\n")
    buckets, counts = {}, {}
    for line in text.splitlines():
        assert EXPOSITION_LINE.match(line), f"malformed exposition line: {line!r}"
        if "_bucket{" in line:
            name = line.split("_bucket{", 1)[0]
            le = re.search(r'le="([^"]+)"', line).group(1)
            buckets.setdefault(name, []).append((le, float(line.rsplit(" ", 1)[1])))
        elif re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*_count \d", line):
            counts[line.split("_count ", 1)[0]] = float(line.rsplit(" ", 1)[1])
    assert bool(buckets) == histograms
    for name, series in buckets.items():
        values = [v for _, v in series]
        assert values == sorted(values) and series[-1][0] == "+Inf" and values[-1] == counts[name]


def _fill(module) -> str:
    reg = module.Registry()
    reg.counter("a_reqs", "count").inc(3)
    reg.counter("a_reqs", "count").inc(0.5)
    g = reg.gauge("b_depth", 'weird "help"\nline with a \\ backslash')
    g.set(2.5)
    g.dec(4)
    h = reg.histogram("c_seconds", "lat", buckets=(0.1, 1.0, 5.0))
    for v in (0.05, 0.1, 0.7, 3.0, 9.0, 0.0):
        h.observe(v)
    reg.histogram("d_default_seconds", "default buckets").observe(0.003)
    reg.gauge_func("e_hbm", "per device", lambda: [({"device": "0"}, 1.0), ({"device": 'x"y'}, float("inf"))])
    reg.counter_func("f_done", "done", lambda: 7)
    reg.gauge_func("g_none", "absent", lambda: None)
    reg.gauge_func("h_nan", "nan", lambda: float("nan"))
    reg.gauge_func("i_broken", "raises", lambda: 1 / 0)
    return reg.render()


def test_exposition_is_byte_equal_to_jax_and_conformant():
    text = _fill(obs)
    assert text == _fill(jobs)
    assert_conformant(text)
    assert 'c_seconds_bucket{le="+Inf"} 6' in text and "a_reqs_total 3.5" in text
    reg = obs.Registry()
    reg.counter("x", "c")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x", "g")
    with pytest.raises(ValueError):
        obs.Histogram("h", "bad", buckets=(1.0, 0.5))


@pytest.mark.parametrize("spec", ["100:20", "1:1", "x:y", "100", "0:5", "5:0", ":", "3:-2", " 4:2"])
def test_parse_profile_window_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)

    assert outcome(obs.parse_profile_window) == outcome(jobs.parse_profile_window)


def test_flight_recorder_without_a_directory_is_a_silent_noop(tmp_path):
    fr = obs.FlightRecorder(directory=None)
    fr.tick({"step": 1})
    fr.event("boom", detail="x")
    assert fr.dump("anything") is None
    assert len(fr.ticks()) == 1 and len(fr.events()) == 1
    tr = obs.Tracer()
    tr.add("s", "train", 0.0, 1.0)
    fr = obs.FlightRecorder(directory=tmp_path, tracer=tr, max_dumps=2)
    fr.tick({"step": 2})
    paths = [fr.dump("a/b"), fr.dump("c"), fr.dump("d")]
    assert [Path(p).name for p in paths] == ["001_a_b.json", "002_c.json", "003_d.json"]
    assert sorted(p.name for p in (tmp_path / "flightrec").iterdir()) == ["002_c.json", "003_d.json"]
    doc = json.loads(Path(paths[-1]).read_text())
    assert doc["reason"] == "d" and doc["ticks"][0]["step"] == 2 and doc["spans"][0]["name"] == "s"


def test_memory_stats_off_a_card_and_logger_events(tmp_path, capsys):
    assert obs.hbm_device_stats(torch.device("cpu")) is None and obs.hbm_used_gb(torch.device("cpu")) is None
    logger = obs.MetricsLogger(str(tmp_path))
    logger.log({"loss": 1.5}, 3)
    logger.event("anomaly_rollback", 4, to_step=2)
    logger.close()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines == [{"step": 3, "loss": 1.5}, {"step": 4, "event": "anomaly_rollback", "to_step": 2}]
    assert "EVENT anomaly_rollback to_step=2" in capsys.readouterr().out


# ------------------------------------------------------------- the trainer


def _cfg(run_dir, **over):
    return tconfig.apply_dotted_overrides(tconfig.load_config(TRAIN_TEST), {
        "checkpoint.directory": str(run_dir), "checkpoint.async_save": False, "checkpoint.save_frequency": 5,
        "training.total_steps": 10, "training.log_frequency": 5, "training.evaluation_frequency": 10,
        "training.maximum_evaluation_steps": 1, "optimizer.warmup_steps": 2, **over})


def test_trainer_writes_the_six_spans_and_the_trace(tmp_path):
    run = tmp_path / "run"
    trainer = Trainer(_cfg(run), device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    names = {s[spans.NAME] for s in trainer.tracer.by_track("train")}
    assert names == SPAN_NAMES
    lines = [json.loads(x) for x in (run / "spans.jsonl").read_text().splitlines()]
    assert {x["name"] for x in lines} == SPAN_NAMES
    assert len(lines) == len(trainer.tracer)  # each span written once
    doc = json.loads((run / "trace_train.json").read_text())
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} == SPAN_NAMES
    assert (run / "metrics.jsonl").exists()
    assert [t[1]["step"] for t in trainer.flight.ticks()] == [5, 10]
    assert trainer.registry.render() == ("# HELP train_bubble_frac analytic pipeline-bubble fraction of the "
                                         "configured schedule\n# TYPE train_bubble_frac gauge\n"
                                         "train_bubble_frac 0\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_metrics_port_serves_conformant_metrics(tmp_path, monkeypatch):
    port, scraped = _free_port(), []
    train = Trainer.train

    def train_then_scrape(self, max_steps=None):
        state = train(self, max_steps)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            scraped.append((r.status, r.headers["Content-Type"], r.read().decode()))
        return state

    monkeypatch.setattr(Trainer, "train", train_then_scrape)
    ttrain.main(["--cfg", TRAIN_TEST, "--device", "cpu", "--max-steps", "2", "--metrics-port", str(port),
                 "--set", f"checkpoint.directory={tmp_path / 'run'}"])
    status, ctype, text = scraped[0]
    assert status == 200 and ctype == obs.Registry.CONTENT_TYPE
    assert_conformant(text, histograms=False)
    assert "train_bubble_frac 0" in text
    with pytest.raises(OSError):  # the exporter stopped with the run
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5)


def test_cli_profile_window_traces_those_steps(tmp_path):
    run = tmp_path / "run"
    ttrain.main(["--cfg", TRAIN_TEST, "--device", "cpu", "--max-steps", "6", "--profile-window", "3:2",
                 "--set", f"checkpoint.directory={run}", "training.log_frequency=3"])
    traces = sorted((run / "profile").rglob("trace.json"))
    assert [p.parent.name for p in traces] == ["steps_3-4"]
    doc = json.loads(traces[0].read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    steps = {e["name"] for e in events if str(e.get("name", "")).startswith("train_step ")}
    assert steps == {"train_step 3", "train_step 4"}
