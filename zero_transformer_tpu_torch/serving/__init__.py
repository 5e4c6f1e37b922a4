"""Continuous-batching serving (counterpart of ``zero_transformer_tpu/serving``)."""
from zero_transformer_tpu_torch.serving.engine import RequestHandle, ServingEngine
from zero_transformer_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache
from zero_transformer_tpu_torch.serving.qos import (BROWNOUT_RUNGS, BrownoutController, ClassQueue, QosClassConfig,
                                                    QosPolicy, TenantBuckets, TokenBucket, rung_at_least)
from zero_transformer_tpu_torch.serving.resilience import (DEGRADED, DRAINING, READY, STARTING, STOPPED, ReloadError,
                                                           ServeFault, ServingChaosMonkey)
from zero_transformer_tpu_torch.serving.server import ServingServer, run_server

__all__ = [
    "BROWNOUT_RUNGS", "BrownoutController", "ClassQueue", "DEGRADED", "DRAINING", "PagedPrefixIndex", "PrefixCache",
    "QosClassConfig", "QosPolicy", "READY", "ReloadError", "RequestHandle", "STARTING", "STOPPED", "ServeFault",
    "ServingChaosMonkey", "ServingEngine", "ServingServer", "TenantBuckets", "TokenBucket", "rung_at_least",
    "run_server",
]
