"""The train step (counterpart of ``zero_transformer_tpu/parallel``)."""
