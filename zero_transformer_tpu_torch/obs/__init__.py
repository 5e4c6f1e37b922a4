"""Training observability: spans, Prometheus metrics, the flight recorder,
profile windows and the metrics sink.

Counterpart of ``zero_transformer_tpu/obs/`` for the trainer
(``training/trainer.py``, ``train.py``): ``Tracer`` (spans of the step
loop, exported as ``spans.jsonl`` and a Perfetto ``trace_train.json``),
``Registry`` and ``MetricsExporter`` (``train --metrics-port``),
``FlightRecorder`` (dumps on an anomaly halt, a watchdog abort and a
quarantined checkpoint), ``ProfileWindow`` (``train --profile-window``)
and ``MetricsLogger``. The serving plane's SLO engine and the fleet
aggregation are not ported.
"""
from zero_transformer_tpu_torch.obs.exporter import MetricsExporter
from zero_transformer_tpu_torch.obs.flight import FlightRecorder
from zero_transformer_tpu_torch.obs.logging import (MetricsLogger, hbm_device_stats, hbm_used_gb,
                                                    model_flops_per_token, peak_flops)
from zero_transformer_tpu_torch.obs.metrics import LATENCY_BUCKETS, Counter, Gauge, Histogram, Registry
from zero_transformer_tpu_torch.obs.profiling import ProfileWindow, parse_profile_window
from zero_transformer_tpu_torch.obs.spans import Tracer, coverage_fraction, span_dict, span_tree

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsExporter", "MetricsLogger",
    "ProfileWindow", "Registry", "Tracer", "coverage_fraction", "hbm_device_stats", "hbm_used_gb",
    "model_flops_per_token", "parse_profile_window", "peak_flops", "span_dict", "span_tree",
]
