"""Training observability: spans, Prometheus metrics, the flight recorder,
profile windows and the metrics sink.

Counterpart of ``zero_transformer_tpu/obs/`` for the trainer
(``training/trainer.py``, ``train.py``): ``Tracer`` (spans of the step
loop, exported as ``spans.jsonl`` and a Perfetto ``trace_train.json``),
``Registry`` and ``MetricsExporter`` (``train --metrics-port``),
``FlightRecorder`` (dumps on an anomaly halt, a watchdog abort and a
quarantined checkpoint), ``ProfileWindow`` (``train --profile-window``)
and ``MetricsLogger``; the fleet router's SLO engine (``slo``) and fleet
plane (``fleet``: trace stitching, ``/metrics`` aggregation, the cost
ledger).
"""
from zero_transformer_tpu_torch.obs.exporter import MetricsExporter
from zero_transformer_tpu_torch.obs.fleet import (ENGINE_LEDGER_KEYS, FLEET_OBS_REQUIRED_KEYS, LEDGER_KEYS,
                                                  ROUTER_LEDGER_KEYS, FleetAggregator, TenantLedger, complete_ledger,
                                                  estimate_clock_offset, new_engine_ledger, parse_exposition,
                                                  request_ids_in, stitch_spans, verify_stitched)
from zero_transformer_tpu_torch.obs.flight import FlightRecorder
from zero_transformer_tpu_torch.obs.logging import (MetricsLogger, hbm_device_stats, hbm_used_gb,
                                                    model_flops_per_token, peak_flops)
from zero_transformer_tpu_torch.obs.metrics import LATENCY_BUCKETS, Counter, Gauge, Histogram, Registry
from zero_transformer_tpu_torch.obs.profiling import ProfileWindow, parse_profile_window
from zero_transformer_tpu_torch.obs.slo import Objective, SLOEngine, default_objectives, parse_slo_config
from zero_transformer_tpu_torch.obs.spans import Tracer, coverage_fraction, span_dict, span_tree

__all__ = [
    "Counter", "ENGINE_LEDGER_KEYS", "FLEET_OBS_REQUIRED_KEYS", "FleetAggregator", "FlightRecorder", "Gauge",
    "Histogram", "LATENCY_BUCKETS", "LEDGER_KEYS", "MetricsExporter", "MetricsLogger", "Objective", "ProfileWindow",
    "ROUTER_LEDGER_KEYS", "Registry", "SLOEngine", "TenantLedger", "Tracer", "complete_ledger", "coverage_fraction",
    "default_objectives", "estimate_clock_offset", "hbm_device_stats", "hbm_used_gb", "model_flops_per_token",
    "new_engine_ledger", "parse_exposition", "parse_profile_window", "parse_slo_config", "peak_flops",
    "request_ids_in", "span_dict", "span_tree", "stitch_spans", "verify_stitched",
]
