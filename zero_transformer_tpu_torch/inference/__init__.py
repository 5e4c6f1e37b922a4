"""Decode-side inference: the slab-cache generation loops, prompt-lookup
speculative decoding, sampling and the paged decode model's pools
(counterpart of ``zero_transformer_tpu/inference``).

``serve_mesh`` and ``shard_for_inference`` (tensor-parallel serving) come
with ROADMAP Queue 1 item 13; here they raise ``NotImplementedError``."""
from zero_transformer_tpu_torch.inference.generate import (
    SlabCache,
    decode_model,
    generate,
    generate_tokens,
    init_cache,
    prefill,
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


def serve_mesh(tensor: int):
    raise NotImplementedError("tensor-parallel serving (serve_mesh) is ROADMAP Queue 1 item 13")


def shard_for_inference(model, params, mesh):
    raise NotImplementedError("tensor-parallel serving (shard_for_inference) is ROADMAP Queue 1 item 13")


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
    "serve_mesh",
    "shard_for_inference",
    "stream_tokens",
    "top_k_filter",
    "top_p_filter",
]
