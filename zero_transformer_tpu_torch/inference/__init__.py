"""Decode-side inference: the slab-cache generation loops, prompt-lookup
speculative decoding, sampling and the paged decode model's pools
(counterpart of ``zero_transformer_tpu/inference``), and tensor-parallel
serving's ``serve_mesh``, ``shard_for_inference`` and
``scatter_for_inference``."""
from zero_transformer_tpu_torch.inference.generate import (
    SlabCache,
    decode_model,
    generate,
    generate_tokens,
    init_cache,
    prefill,
    scatter_for_inference,
    serve_mesh,
    shard_for_inference,
    stream_tokens,
)
from zero_transformer_tpu_torch.inference.sampling import (
    SamplingConfig,
    apply_repetition_penalty,
    process_logits,
    sample_token,
    top_k_filter,
    top_p_filter,
)
from zero_transformer_tpu_torch.inference.speculative import generate_speculative, ngram_propose


__all__ = [
    "SamplingConfig",
    "SlabCache",
    "apply_repetition_penalty",
    "decode_model",
    "generate",
    "generate_speculative",
    "generate_tokens",
    "init_cache",
    "ngram_propose",
    "prefill",
    "process_logits",
    "sample_token",
    "scatter_for_inference",
    "serve_mesh",
    "shard_for_inference",
    "stream_tokens",
    "top_k_filter",
    "top_p_filter",
]
