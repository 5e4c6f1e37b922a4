"""Training (counterpart of ``zero_transformer_tpu/training``)."""
