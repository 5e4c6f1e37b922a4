// Shared by the flash forward (flash_fwd.cu) and backward (flash_bwd.cu)
// kernels: the score bias, written once so that the backward recomputes
// exactly the probabilities the forward normalised.
//
// It is zero_transformer_tpu/ops/pallas/flash.py::_bias_block followed by
// _scores: s * scale + (ALiBi -slope * max(q_pos - k_pos, 0) plus the causal
// NEG_INF mask, summed as one bias in that order).
#pragma once

namespace flash {

constexpr float NEG_INF = -1e10f;  // ops/positions.py NEG_INF

__device__ __forceinline__ float biased_score(float dot, float scale, int dist, float slope,
                                              int causal, int alibi) {
  float bias = 0.f;
  if (alibi) bias = bias - slope * (float)max(dist, 0);
  if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF);
  return dot * scale + bias;
}

}  // namespace flash
