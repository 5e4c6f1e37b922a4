"""Continuous-batching serving (counterpart of ``zero_transformer_tpu/serving``)."""
from zero_transformer_tpu_torch.serving.engine import MIGRATED, ROLES, RequestHandle, ServingEngine
from zero_transformer_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache
from zero_transformer_tpu_torch.serving.qos import (BROWNOUT_RUNGS, BrownoutController, ClassQueue, QosClassConfig,
                                                    QosPolicy, TenantBuckets, TokenBucket, rung_at_least)
from zero_transformer_tpu_torch.serving.resilience import (DEGRADED, DRAINING, READY, STARTING, STOPPED, ReloadError,
                                                           ServeFault, ServingChaosMonkey)
from zero_transformer_tpu_torch.serving.server import ServingServer, run_server
from zero_transformer_tpu_torch.serving.slots import PagedKVCache
from zero_transformer_tpu_torch.serving.wire import page_span_from_wire, page_span_to_wire

__all__ = [
    "BROWNOUT_RUNGS", "BrownoutController", "ClassQueue", "DEGRADED", "DRAINING", "MIGRATED", "PagedKVCache",
    "PagedPrefixIndex", "PrefixCache", "QosClassConfig", "QosPolicy", "READY", "ROLES", "ReloadError",
    "RequestHandle", "STARTING", "STOPPED", "ServeFault", "ServingChaosMonkey", "ServingEngine", "ServingServer",
    "TenantBuckets", "TokenBucket", "page_span_from_wire", "page_span_to_wire", "rung_at_least", "run_server",
]
