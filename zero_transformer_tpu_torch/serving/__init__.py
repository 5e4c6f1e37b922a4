"""Continuous-batching serving and the fleet router (counterpart of
``zero_transformer_tpu/serving``)."""
from zero_transformer_tpu_torch.serving.engine import MIGRATED, ROLES, RequestHandle, ServingEngine
from zero_transformer_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache
from zero_transformer_tpu_torch.serving.qos import (BROWNOUT_RUNGS, BrownoutController, ClassQueue, QosClassConfig,
                                                    QosPolicy, TenantBuckets, TokenBucket, rung_at_least)
from zero_transformer_tpu_torch.serving.resilience import (DEGRADED, DRAINING, READY, STARTING, STOPPED,
                                                           CircuitBreaker, Lifecycle, ReloadError, ServeFault,
                                                           ServingChaosMonkey)
from zero_transformer_tpu_torch.serving.router import (EJECTED, PrefixAffinity, Replica, ReplicaRegistry,
                                                       RouterServer, chunk_prefix_key, pick_decode_replica,
                                                       pick_replica, run_router)
from zero_transformer_tpu_torch.serving.server import ServingServer, run_server
from zero_transformer_tpu_torch.serving.slots import PagedKVCache, SlotKVCache
from zero_transformer_tpu_torch.serving.wire import page_span_from_wire, page_span_to_wire

__all__ = [
    "BROWNOUT_RUNGS", "BrownoutController", "CircuitBreaker", "ClassQueue", "DEGRADED", "DRAINING", "EJECTED",
    "Lifecycle", "MIGRATED", "PagedKVCache", "PagedPrefixIndex", "PrefixAffinity", "PrefixCache", "QosClassConfig",
    "QosPolicy", "READY", "ROLES", "ReloadError", "Replica", "ReplicaRegistry", "RequestHandle", "RouterServer",
    "STARTING", "STOPPED", "ServeFault", "ServingChaosMonkey", "ServingEngine", "ServingServer", "SlotKVCache",
    "TenantBuckets", "TokenBucket", "chunk_prefix_key", "page_span_from_wire", "page_span_to_wire",
    "pick_decode_replica", "pick_replica", "rung_at_least", "run_router", "run_server",
]
