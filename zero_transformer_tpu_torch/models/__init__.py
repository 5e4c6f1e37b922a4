"""Model definitions (counterpart of ``zero_transformer_tpu/models``)."""
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.models.registry import model_getter

__all__ = ["Transformer", "model_getter"]
