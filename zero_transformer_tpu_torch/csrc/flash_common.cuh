// Shared by the flash forward (flash_fwd.cu) and backward (flash_bwd.cu)
// kernels: the score bias, written once so that the backward recomputes
// exactly the probabilities the forward normalised.
//
// It is zero_transformer_tpu/ops/pallas/flash.py::_bias_block followed by
// _scores: s * scale + (ALiBi -slope * max(q_pos - k_pos, 0) plus the causal
// NEG_INF mask, summed as one bias in that order), then + the packed-document
// mask (NEG_INF where the query's and the key's document ids differ), as a
// separate add after it (_scores :108-110). The serving path's validity mask
// comes after both, in each kernel.
#pragma once

namespace flash {

constexpr float NEG_INF = -1e10f;  // ops/positions.py NEG_INF

// docs: whether the document mask is on (the kernel was given [B, T] ids).
// A key of another document adds NEG_INF, like a key past the causal limit;
// a row whose first key tiles lie all in earlier documents keeps m = -1e10
// there, and the first tile with a key of its own document wipes what they
// added to l and acc with alpha = exp(-1e10 - m_new) = 0, as on the TPU.
__device__ __forceinline__ float biased_score(float dot, float scale, int dist, float slope,
                                              int causal, int alibi, bool docs, int q_doc,
                                              int k_doc) {
  float bias = 0.f;
  if (alibi) bias = bias - slope * (float)max(dist, 0);
  if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF);
  float x = dot * scale + bias;
  if (docs) x = x + (q_doc == k_doc ? 0.f : NEG_INF);
  return x;
}

}  // namespace flash
