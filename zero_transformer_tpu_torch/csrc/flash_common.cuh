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
//
// Positions are global: every kernel takes int32 offsets [2, B] (row 0 the
// query offset, row 1 the key offset of each batch row, flash.py
// _offsets_arg :264), so a sequence-parallel shard's query and key tiles
// sit at their ring positions; dist = (q_off + qi) - (kv_off + kj). The
// tile skips below are flash.py _run_predicate (:118) at those offsets.
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

// Key tiles a query tile visits under the causal limit: tile j (keys
// [j * bk, (j + 1) * bk) local) runs iff kv_off + j * bk <= q_last, the
// global position of the query tile's last row.
__device__ __forceinline__ int causal_key_tiles(int n_tiles, int q_last, int kv_off, int bk) {
  const int reach = q_last - kv_off;  // local index of the last key it can see
  return reach < 0 ? 0 : min(n_tiles, reach / bk + 1);
}

// The first query tile (of n_q, bq rows each, starting at global q_off)
// whose last row sees the key tile starting at local key k0; n_q if none.
__device__ __forceinline__ int first_query_tile(int k0, int q_off, int kv_off, int bq, int n_q) {
  const int need = kv_off + k0 - q_off - (bq - 1);  // tile i runs iff i * bq >= need
  return need <= 0 ? 0 : min(n_q, (need + bq - 1) / bq);
}

}  // namespace flash
