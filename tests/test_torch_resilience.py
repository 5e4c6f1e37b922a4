"""The port's resilience layer on the CPU: escalation, the supervisor, chaos.

- ``classify`` over JAX's exception zoo (``tests/test_resilience.py``
  :98-175: types, message fingerprints, cause chains both ways, a cycle),
  ``backoff_delay`` under seeded and pinned rngs, and the
  ``ResilienceConfig`` validation: each equal to the JAX function's result.
- Escalation through the port's ``Trainer`` on ``--device cpu`` (the
  ``test`` model of ``configs/train_test.yaml``): ``halt`` raises
  ``AnomalyHalt`` at the first log point after a NaN at a non-log step and
  checkpoints nothing; a NaN read at a log point raises "non-finite loss";
  ``skip_batch`` completes with the flagged steps dropped and halts at its
  streak limit; ``rollback`` restores the snapshot's bits (their digests at
  capture) and completes, and halts once its budget is spent; flight dumps
  and events land beside ``metrics.jsonl``.
- The replica audit in a 4-rank gloo world at ZeRO 0: it runs exactly on
  the steps ``audit_frequency`` divides (JAX's cadence; the port used to
  audit at every log point of a multi-rank world, a cadence that differs);
  a ``replica_perturb`` on one rank trips it at the first audit after the
  fault, which halts under ``halt`` and heals by rollback under
  ``rollback``.
- Chaos end to end under ``Supervisor``: ``loader_error``, ``sigterm``,
  ``ckpt_fail``, ``ckpt_slow``, ``hang`` (watchdog timeout 2 s, the hook
  force-saves) and ``ckpt_truncate`` / ``ckpt_bitflip`` (quarantine, fall
  back a step): each run ends at the uninterrupted run's final step with
  params bit-equal to it (JAX ``tests/test_resilience.py`` :221-560 is the
  model; the port's own uninterrupted run is the reference).
"""
import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.resilience import RetryableError as JaxRetryable
from zero_transformer_tpu.resilience.supervisor import backoff_delay as jax_backoff_delay
from zero_transformer_tpu.resilience.supervisor import classify as jax_classify
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.resilience import AnomalyHalt, HangError, RetryableError
from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault, corrupt_step_dir
from zero_transformer_tpu_torch.resilience.detect import leaf_checksum
from zero_transformer_tpu_torch.resilience.supervisor import Supervisor, backoff_delay, classify
from zero_transformer_tpu_torch.resilience.watchdog import Watchdog, dump_stacks
from zero_transformer_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
TRAIN_TEST = str(ROOT / "configs" / "train_test.yaml")
TOTAL = 12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny_config(run_dir, total_steps=TOTAL, log_frequency=2, save_frequency=4, **resilience):
    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(TRAIN_TEST), {
        "checkpoint.directory": str(run_dir), "checkpoint.save_frequency": save_frequency,
        "checkpoint.async_save": False, "training.total_steps": total_steps,
        "training.log_frequency": log_frequency, "training.evaluation_frequency": 0,
    })
    return dataclasses.replace(cfg, resilience=tconfig.ResilienceConfig(**resilience))


def params_of(state) -> dict:
    return {k: v.clone() for k, v in state.shards.state_leaves().items() if k.startswith("params/")}


def all_finite(params: dict) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in params.values())


def assert_bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def events(run_dir, name):
    lines = [json.loads(x) for x in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [x for x in lines if x.get("event") == name]


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The uninterrupted run: final step and params."""
    torch.set_num_threads(1)
    t = Trainer(tiny_config(tmp_path_factory.mktemp("clean") / "run"), device="cpu")
    try:
        state = t.train()
        return state.step, params_of(state)
    finally:
        t.close()


# -------------------------------------------------- the supervisor against JAX


def _chain(outer, inner, implicit=False):
    try:
        try:
            raise inner
        except BaseException as e:
            if implicit:
                raise outer
            raise outer from e
    except BaseException as e:  # noqa: BLE001 - the test builds the chain
        return e


def _zoo(retryable, halt):
    """JAX's exception zoo, built from one package's error classes."""
    ki = KeyboardInterrupt()
    ki.__cause__ = retryable("mid-retry when interrupted")
    a, b = RuntimeError("a"), RuntimeError("b")
    a.__cause__, b.__cause__ = b, a
    return {
        "retryable": retryable("x"), "oserror": OSError("disk detached"),
        "connection_reset": ConnectionResetError("peer"), "timeout": TimeoutError(),
        "resource_exhausted": RuntimeError("RESOURCE_EXHAUSTED: hbm oom"),
        "unavailable": RuntimeError("UNAVAILABLE: socket closed"), "value": ValueError("d_model must divide"),
        "type": TypeError("bad arg"), "file_not_found": FileNotFoundError("no such config"),
        "halt": halt("diverged"), "keyboard": KeyboardInterrupt(), "novel": RuntimeError("some novel crash"),
        "raise_from": _chain(ValueError("while decoding shard 7"), retryable("shard read reset")),
        "implicit_context": _chain(KeyError("cleanup lookup failed"), retryable("watchdog abort"), implicit=True),
        "retryable_wraps_fatal": _chain(retryable("transient wrapper"), ValueError("bad shape deep down")),
        "interrupt_beats_chain": ki, "cycle": a, "permission": PermissionError("ro"),
        "not_implemented": NotImplementedError("x"), "preempted_text": RuntimeError("job preempted by scheduler"),
    }


@pytest.mark.parametrize("case", sorted(_zoo(RetryableError, AnomalyHalt)))
def test_classify_matches_jax(case):
    from zero_transformer_tpu.resilience import AnomalyHalt as JaxHalt

    port, ref = _zoo(RetryableError, AnomalyHalt)[case], _zoo(JaxRetryable, JaxHalt)[case]
    assert classify(port) == jax_classify(ref)
    assert issubclass(HangError, RetryableError) and not issubclass(AnomalyHalt, RetryableError)


def test_backoff_delay_matches_jax():
    for attempt in (1, 2, 3, 7, 12):
        for jitter in (0.0, 0.1, 0.5):
            for edge in (0.0, 0.5, 1.0):
                assert backoff_delay(2.0, 300.0, attempt, jitter, rng=lambda: edge) == \
                    jax_backoff_delay(2.0, 300.0, attempt, jitter, rng=lambda: edge)
    a, b = random.Random(7).random, random.Random(7).random
    got = [backoff_delay(1.0, 60.0, k % 8 + 1, 0.1, rng=a) for k in range(64)]
    assert got == [jax_backoff_delay(1.0, 60.0, k % 8 + 1, 0.1, rng=b) for k in range(64)]


VALIDATION = [
    {}, {"anomaly_response": "retry"}, {"ema_decay": 1.5}, {"ema_decay": 0.0}, {"loss_spike_factor": -1.0},
    {"grad_spike_factor": -0.5}, {"rollback_after": 0}, {"max_consecutive_anomalies": 0},
    {"snapshot_frequency": -1}, {"max_rollbacks": -1}, {"audit_frequency": -1},
    {"audit_frequency": 5, "anomaly_detection": False}, {"watchdog_timeout_s": -1.0}, {"max_restarts": -1},
    {"backoff_base_s": 0.0}, {"backoff_base_s": 10.0, "backoff_max_s": 5.0}, {"backoff_jitter": 1.0},
    {"backoff_jitter": -0.1}, {"backoff_jitter": 0.999}, {"anomaly_response": "rollback", "loss_spike_factor": 3.0},
]


@pytest.mark.parametrize("kw", VALIDATION, ids=[",".join(sorted(k)) or "defaults" for k in VALIDATION])
def test_config_validation_matches_jax(kw):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(**kw))
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(tconfig.ResilienceConfig) == outcome(jconfig.ResilienceConfig)


def test_supervisor_fatal_propagates_and_budget_backs_off(tmp_path):
    cfg = tiny_config(tmp_path / "run", max_restarts=2, backoff_base_s=0.01, backoff_jitter=0.5)
    calls = []

    def fatal(c):
        calls.append(c)
        raise ValueError("shape mismatch: d_model")

    with pytest.raises(ValueError, match="shape mismatch"):
        Supervisor(cfg, trainer_factory=fatal, sleep_fn=lambda s: None).run()
    assert len(calls) == 1

    class Always:
        def __init__(self, c):
            calls.append(c)

        def train(self, max_steps=None):
            raise OSError("bucket gone")

        def close(self):
            pass

    sleeps = []
    sup = Supervisor(cfg, trainer_factory=Always, sleep_fn=sleeps.append, rng=lambda: 1.0)
    with pytest.raises(RetryableError, match="restart budget exhausted"):
        sup.run()
    assert sleeps == pytest.approx([0.015, 0.03])
    assert [c.checkpoint.resume for c in calls[1:]] == [False, True, True]


def test_supervisor_refuses_a_multi_rank_world(tmp_path):
    with pytest.raises(NotImplementedError, match="one process"):
        Supervisor(dataclasses.replace(tiny_config(tmp_path), mesh=tconfig.MeshConfig(data=2)))


# ----------------------------------------------------------- the watchdog


def test_watchdog_fires_only_past_deadline():
    import time

    hooks = []
    wd = Watchdog(timeout_s=0.4, on_hang=lambda: hooks.append("hang"), poll_s=0.05)
    wd.start()
    try:
        for _ in range(4):
            time.sleep(0.1)
            wd.beat()
        assert not wd.fired and hooks == []
        deadline = time.monotonic() + 30
        with pytest.raises(KeyboardInterrupt):
            while time.monotonic() < deadline:
                time.sleep(0.05)
    finally:
        wd.stop()
    assert wd.fired and hooks == ["hang"] and 0.4 < wd.fired_after_s < 5.0
    text = dump_stacks("unit test")
    assert "thread stacks" in text and "MainThread" in text


# ------------------------------------------------- escalation in the trainer


def test_halt_at_the_log_point_after_a_non_log_nan(tmp_path):
    run = tmp_path / "run"
    t = Trainer(tiny_config(run, log_frequency=5, save_frequency=100), device="cpu",
                chaos=ChaosMonkey([Fault("nan_step", 2, 1)]))
    try:
        with pytest.raises(AnomalyHalt, match=r"1 flagged step\(s\) by step 5"):
            t.train()
        assert t.ckpt.latest_step() is None
        assert all_finite(params_of(t.state))
    finally:
        t.close()
    dumps = sorted((run / "flightrec").glob("*_anomaly_halt.json"))
    assert dumps and json.loads(dumps[0].read_text())["extra"]["cause"] == "policy_halt"


def test_nan_read_at_a_log_point_still_raises_non_finite_loss(tmp_path):
    t = Trainer(tiny_config(tmp_path / "run", log_frequency=3), device="cpu",
                chaos=ChaosMonkey([Fault("nan_step", 2, 1)]))
    try:
        with pytest.raises(RuntimeError, match="non-finite loss nan at step 3"):
            t.train()
    finally:
        t.close()


def test_skip_batch_drops_the_window_and_completes(tmp_path, clean):
    t = Trainer(tiny_config(tmp_path / "run", anomaly_response="skip_batch"), device="cpu",
                chaos=ChaosMonkey([Fault("nan_step", 4, 2)]))
    try:
        state = t.train()
        assert state.step == clean[0] == TOTAL
        assert t.resilience_report["anomalies"] == 2 and t.resilience_report["rollbacks"] == 0
        assert int(state.optimizer.count) == TOTAL - 2
        assert all_finite(params_of(state))
    finally:
        t.close()


def test_skip_batch_streak_limit_halts(tmp_path):
    t = Trainer(tiny_config(tmp_path / "run", total_steps=50, save_frequency=1000, anomaly_response="skip_batch",
                            max_consecutive_anomalies=4), device="cpu",
                chaos=ChaosMonkey([Fault("nan_step", 0, 1000)]))
    try:
        with pytest.raises(AnomalyHalt, match="consecutive"):
            t.train()
    finally:
        t.close()


def test_rollback_restores_the_snapshot_bits_and_completes(tmp_path):
    run = tmp_path / "run"
    t = Trainer(tiny_config(run, total_steps=14, anomaly_response="rollback", rollback_after=2, max_rollbacks=5,
                            snapshot_frequency=2), device="cpu", chaos=ChaosMonkey([Fault("nan_step", 4, 4)]))
    seen = []
    rollback = t._rollback

    def checked(snapshot):
        digests = [leaf_checksum(h) for h in snapshot.host_tensors()]
        rollback(snapshot)
        restored = [leaf_checksum(d) for d in snapshot.device_tensors(t.state)]
        seen.append((snapshot.step, digests == restored, snapshot.bytes))

    t._rollback = checked
    try:
        state = t.train()
        assert state.step == 14 and all_finite(params_of(state))
        assert t.resilience_report["rollbacks"] >= 1 and t.resilience_report["anomalies"] >= 2
    finally:
        t.close()
    assert seen and all(ok for _, ok, _ in seen) and seen[0][0] == 4 and seen[0][2] > 0
    ev = events(run, "anomaly_rollback")
    assert ev and ev[0]["to_step"] == 4 and ev[0]["step"] == 6
    spans = [json.loads(x)["name"] for x in (run / "spans.jsonl").read_text().splitlines()]
    assert "replica_audit" in spans and (run / "trace_train.json").exists()


def test_rollback_budget_exhaustion_halts(tmp_path):
    run = tmp_path / "run"
    t = Trainer(tiny_config(run, total_steps=50, log_frequency=1, save_frequency=1000,
                            anomaly_response="rollback", rollback_after=1, max_rollbacks=2, snapshot_frequency=1),
                device="cpu", chaos=ChaosMonkey([Fault("nan_step", 2, 1000)]))
    try:
        with pytest.raises(AnomalyHalt, match="rollback budget exhausted"):
            t.train()
        assert t.resilience_report["rollbacks"] == 2
    finally:
        t.close()
    assert len(events(run, "anomaly_rollback")) == 2
    dump = json.loads(sorted((run / "flightrec").glob("*_anomaly_halt.json"))[-1].read_text())
    assert dump["extra"]["cause"] == "rollback_budget" and dump["ticks"] and dump["spans"]


# ------------------------------------------------ the replica audit, 4 ranks


def test_replica_audit_cadence_trip_and_heal(tmp_path):
    base = {"checkpoint.save_frequency": 1000, "checkpoint.async_save": False, "training.log_frequency": 2,
            "training.evaluation_frequency": 0, "mesh.data": 4, "mesh.zero_stage": 0, "optimizer.warmup_steps": 2}
    runs = [
        dict(name="cadence", overrides={**base, "training.total_steps": 6, "resilience.audit_frequency": 3}),
        dict(name="off", overrides={**base, "training.total_steps": 4}),
        dict(name="halt", perturb=5, overrides={**base, "training.total_steps": 12,
                                                 "resilience.audit_frequency": 2}),
        dict(name="heal", perturb=5, overrides={**base, "training.total_steps": 12, "resilience.audit_frequency": 2,
                                                 "resilience.anomaly_response": "rollback",
                                                 "resilience.snapshot_frequency": 2}),
    ]
    for r in runs:
        r["config"] = TRAIN_TEST
        r["overrides"]["checkpoint.directory"] = str(tmp_path / r["name"])
    ranks = _torch_dist.run_world("trainer_chaos_runs", runs, tmp_path, world=4, sequence=1)
    got = {r["name"]: r for r in ranks[0]}
    # JAX audits after the steps audit_frequency divides (in the step,
    # anomaly.py:169-181); the old port cadence, every log point of a
    # multi-rank world, would have been [2, 4, 6]
    jax_cadence = [s for s in range(1, 7) if s % 3 == 0]
    assert got["cadence"]["audit_steps"] == jax_cadence != [2, 4, 6]
    assert got["cadence"]["error"] is None and got["off"]["audit_steps"] is None
    assert "cross-replica divergence at step 6" in got["halt"]["error"]
    assert got["halt"]["audit_steps"] == [2, 4, 6]
    heal = got["heal"]
    assert heal["error"] is None and heal["step"] == 12
    assert heal["report"]["replica_audit_failures"] == 1 and heal["report"]["rollbacks"] == 1
    for rank in ranks:  # healed: every rank ends with the same params
        for n, p in ranks[0][3]["params"].items():
            assert np.array_equal(rank[3]["params"][n], p), n
    assert events(tmp_path / "heal", "replica_heal_rollback")


# ------------------------------------------------ chaos under the supervisor


def supervise(run_dir, chaos, **resilience):
    sleeps = []
    sup = Supervisor(tiny_config(run_dir, **resilience), trainer_factory=lambda c: Trainer(c, device="cpu",
                                                                                          chaos=chaos),
                     sleep_fn=sleeps.append)
    state = sup.run()
    return state, sup, sleeps


CHAOS = {
    "loader_error": ([Fault("loader_error", 6, exc=OSError)], {}, 1, "OSError"),
    "sigterm": ([Fault("sigterm", 5)], {}, 1, "preempted at step 5"),
    "ckpt_fail": ([Fault("ckpt_fail", 4, exc=OSError)], {}, 1, "OSError"),
    "ckpt_slow": ([Fault("ckpt_slow", 4, duration=0.5)], {}, 0, None),
    "hang": ([Fault("hang", 3, duration=60.0)], {"watchdog_timeout_s": 2.0}, 1, "HangError"),
    "ckpt_truncate": ([Fault("ckpt_truncate", 8), Fault("loader_error", 9, exc=OSError)], {}, 1, "OSError"),
    "ckpt_bitflip": ([Fault("ckpt_bitflip", 8), Fault("loader_error", 9, exc=OSError)], {}, 1, "OSError"),
}


@pytest.mark.parametrize("kind", sorted(CHAOS))
def test_supervised_chaos_ends_bit_equal_to_the_uninterrupted_run(tmp_path, clean, kind):
    faults, resilience, restarts, reason = CHAOS[kind]
    chaos = ChaosMonkey(faults)
    run = tmp_path / "run"
    state, sup, sleeps = supervise(run, chaos, **resilience)
    assert state.step == clean[0] == TOTAL
    assert_bit_equal(params_of(state), clean[1])
    assert len(sup.history) == restarts == len(sleeps)
    if reason:
        assert reason in sup.history[0].reason
    assert all(f.fired or f.kind == "nan_step" for f in faults)
    if kind == "hang":  # the hook force-saved the hung step: the restart resumed there
        assert sup.history[0].step == 3 and events(run, "watchdog_abort")
        assert sorted((run / "flightrec").glob("*_watchdog_abort.json"))
    if kind.startswith("ckpt_") and kind not in ("ckpt_fail", "ckpt_slow"):
        assert list(run.glob("8.quarantined*"))
        assert events(run, "ckpt_quarantined")[0]["step"] == 8
        assert events(run, "restore_fallback")[0]["fallback_steps"] == 4
        assert sorted((run / "flightrec").glob("*_quarantine.json"))


def test_supervisor_max_steps_is_a_budget_for_the_whole_run(tmp_path):
    chaos = ChaosMonkey([Fault("sigterm", 5)])
    sup = Supervisor(tiny_config(tmp_path / "run", total_steps=100), sleep_fn=lambda s: None,
                     trainer_factory=lambda c: Trainer(c, device="cpu", chaos=chaos))
    assert sup.run(max_steps=12).step == 12


@pytest.mark.parametrize("kind", ["ckpt_truncate", "ckpt_bitflip"])
def test_corrupt_step_dir_touches_the_tensor_files(tmp_path, kind):
    step_dir = tmp_path / "4"
    step_dir.mkdir()
    data = bytes(range(256)) * 8
    for name in ("params.safetensors", "opt_state.safetensors"):
        (step_dir / name).write_bytes(data)
    (step_dir / "meta.json").write_text("{}")
    touched = corrupt_step_dir(step_dir, kind)
    assert sorted(Path(p).name for p in touched) == ["opt_state.safetensors", "params.safetensors"]
    out = (step_dir / "params.safetensors").read_bytes()
    if kind == "ckpt_truncate":
        assert out == data[:len(data) // 2]
    else:
        assert len(out) == len(data) and out[:len(data) // 2] == data[:len(data) // 2] and out != data
    assert (step_dir / "meta.json").read_text() == "{}"
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("sigkill", 1)
