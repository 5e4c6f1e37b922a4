"""Continuous-batching serving (counterpart of ``zero_transformer_tpu/serving``)."""
from zero_transformer_tpu_torch.serving.engine import RequestHandle, ServingEngine
from zero_transformer_tpu_torch.serving.server import ServingServer, run_server

__all__ = ["RequestHandle", "ServingEngine", "ServingServer", "run_server"]
