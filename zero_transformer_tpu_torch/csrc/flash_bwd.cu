// Flash attention backward for the training path: dq (K2) and dk/dv (K3).
//
// Replaces the TPU kernels zero_transformer_tpu/ops/pallas/flash.py::_dq_kernel
// (:176) and ::_dkv_kernel (:214), both launched by _bwd (:343) under the
// custom VJP of flash_attention (:421-448). They compute the same functions:
// the scores are recomputed with exactly the forward's bias
// (flash_common.cuh), p = exp(s - lse) from the forward's saved lse [B, H, T],
// dp = do . v^T, ds = p * (dp - delta) with delta = rowsum(do * o) computed
// outside the kernel in f32 (flash.py:354-355), and
//   K2: dq = scale * sum_j ds . k
//   K3: dv = sum_i p^T . do, dk = scale * sum_i ds^T . q
// with every sum in f32, whatever the input dtype (bf16 or f32); the bf16
// kernels round p and ds to bf16 for their second products, as the forward
// rounds p for o. T need not be a multiple of the tile: rows and keys past
// the end get p = 0. With int32 document ids (query ids [B, T], key ids
// [B, S]; packed documents) the scores carry the forward's document mask,
// from the same header: the query ids of a tile sit in registers or shared
// memory beside lse/delta, the key ids beside the key tile; tiles that hold
// no pair of one document are still visited (skipping them is sound only
// for monotone ids).
//
// flash_grads (flash.py:577) reaches the same two kernel bodies for
// sequence parallelism: the query shard at global q_off against a key shard
// at kv_off (offs [2, B], as in the forward), separate query and key ids,
// the GLOBAL lse and delta of the ring's merged softmax from the caller, the
// caller's slope table, and f32 grads from bf16 inputs (the ring sums them
// over its steps). Both causal tile skips are _run_predicate (:118) at
// those offsets (flash_common.cuh): K2's key-tile limit and K3's first
// query tile. A K3 CTA whose key tile no query tile sees (a future shard)
// writes zeros. The training entry passes zero offsets and one id array
// twice.
//
// The TPU kernels carry dq (and dk, dv) in VMEM scratch across a sequential
// grid axis. Here one CTA owns one output tile and walks the other axis in a
// loop, so the two kernels need no atomics and their grads are identical
// from run to run, in both designs below:
// - K2: one CTA per (64-row q tile, head, batch row); it loops over 64-key
//   tiles up to the causal limit of its last row and writes dq once.
// - K3: one CTA per (64-key tile, kv head, batch row); for GQA it loops over
//   the G query heads of its kv head inside the CTA, and for each over the q
//   tiles from the first that sees the key tile to the last, accumulating
//   dk and dv for all G heads in one set of f32 registers. The group sum of
//   flash.py:415-417 thus happens in f32, and dk/dv are written once,
//   directly as [B, S, KVH, D] (no [B, S, H, D] intermediate, no sum in
//   torch).
//
// What bounds it on an H100: the products, at every shape the port runs.
// - 125m training (B = 8, H = KVH = 12, T = S = 1024, D = 64, bf16): K2
//   moves 5 x 12.6 MB plus 0.8 MB of lse/delta (19 us at 3.35 TB/s) and
//   does 19.3 GFLOP causal (19.5 us at the bf16 tensor-core peak); K3 moves
//   6 x 12.6 MB and does 25.8 GFLOP (26 us): the bytes and the products
//   bound it about equally.
// - 580m at D = 128: on the ring's past shard (B = 1, 2048 queries against
//   2048 earlier keys, 12 heads, bf16 in, f32 out) K2 does 38.7 GFLOP and
//   K3 51.5 GFLOP, 0.039 and 0.052 ms at the peak; the one-card step (B 1,
//   T 8192, causal) 309 and 412 GFLOP a layer, 0.313 and 0.417 ms. Each
//   moves under 60 MB: the products bound them by 3-10x.
// Two designs, by input type:
// - bf16 (D = 64: 125m, byte_25m; D = 128: 417m, 580m, 1_3b): wgmma, the
//   Hopper section below. Both products of a step read shared-memory tiles
//   in one 128-byte-swizzled layout (hopper.cuh), K-major for s and dp and
//   through the descriptor's transpose bit for the second products, whose
//   A operand (p or ds, rounded to bf16) comes from the first products'
//   registers, as in FlashAttention-3. Loads are cp.async into a ring of two
//   stages that the threads fill for the next step before they multiply on
//   the current one. cp.async and not TMA: a TMA ring needs a producer warp
//   and mbarrier transaction counts per stage, and tensor maps encoded per
//   call through the driver API (a 128-wide row as two 64-wide swizzled
//   boxes); the copies are a small part of a step (a 64-row stage of K and
//   V is 32 KB against 2 x 64 x 64 x 128 x 3 multiply-adds), and a count
//   that does not match hangs the card instead of failing a bar. K3's
//   registers decide the CTA: one warpgroup holding dk and dv for 64 keys
//   x 128 needs 128 f32 registers a thread plus 64 for s^T and dp^T, so a
//   CTA is that one warpgroup, two CTAs an SM, with no producer warp and no
//   setmaxnreg; ptxas reports no spill (chip_smoke.py prints its lines).
// - f32 (the parity path) at D = 64 and 128: plain FMA in f32 on the CUDA
//   cores (like K1's f32 path), whose peak is 67 TFLOP/s. Tiles are staged
//   in shared memory with rows padded by one word (conflict-free column
//   walks); each of 256 threads owns a 4 x 4 block of the 64 x 64 score
//   tile and a 4 x D/16 block of the output tile. This path computes the
//   plain version's arithmetic in the same order (sequential FMAs), which
//   the card's f32 GEMMs also do: at D = 64 (scale 1/8 exact) its MHA grads
//   match the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score block
constexpr int LDP = BK + 1;   // padded row of a [64][64] probability tile

// Stage rows [r0, r0 + 64) of head `head` of a [rows, heads, D] slab into
// shared memory, row stride D + 1; rows at or past n are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0, int n,
                                      int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? src[((size_t)row * heads + head) * D + d] : 0.f;
  }
}

// ------------------------------------------------------------------ K2: dq

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ slopes, const int* __restrict__ offs,
                const int* __restrict__ qids, const int* __restrict__ kids,
                float* __restrict__ dq, int Tq, int S, int H,
                int KVH, float scale, int causal, int alibi) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ks = dOs + BQ * LD;   // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* dSs = Vs + BK * LD;   // [BQ][LDP]
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ int qdoc_s[BQ], kdoc_s[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * BQ;
  const int q_off = offs[b], kv_off = offs[gridDim.z + b];
  const float slope = alibi ? slopes[h] : 0.f;
  const bool has_docs = qids != nullptr;
  const size_t qbase = (size_t)b * Tq * H * D, kbase = (size_t)b * S * KVH * D;

  stage<D>(Qs, q + qbase, q0, Tq, H, h);
  stage<D>(dOs, dout + qbase, q0, Tq, H, h);
  if (tid < BQ) {
    const int qi = q0 + tid;
    const size_t r = ((size_t)b * H + h) * Tq + qi;
    lse_s[tid] = qi < Tq ? lse[r] : 0.f;
    delta_s[tid] = qi < Tq ? delta[r] : 0.f;
    qdoc_s[tid] = has_docs && qi < Tq ? qids[(size_t)b * Tq + qi] : 0;
  }

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = flash::causal_key_tiles(n_tiles, q_off + min(q0 + BQ, Tq) - 1, kv_off, BK);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is fully consumed
    stage<D>(Ks, k + kbase, k0, S, KVH, kvh);
    stage<D>(Vs, v + kbase, k0, S, KVH, kvh);
    if (tid < BK) kdoc_s[tid] = has_docs && k0 + tid < S ? kids[(size_t)b * S + k0 + tid] : 0;
    __syncthreads();

    // s = q . k^T and dp = do . v^T for rows ty + 16 r, keys tx + 16 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = Qs[(ty + 16 * r) * LD + d];
        da[r] = dOs[(ty + 16 * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = Ks[(tx + 16 * c) * LD + d];
        vb[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
          dp[r][c] = fmaf(da[r], vb[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r, qi = q0 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = tx + 16 * c, kp = k0 + jj;
        float p = 0.f;
        if (qi < Tq && kp < S)
          p = expf(flash::biased_score(s[r][c], scale, (q_off + qi) - (kv_off + kp), slope, causal,
                                       alibi, has_docs, qdoc_s[i], kdoc_s[jj]) -
                   lse_s[i]);
        dSs[i * LDP + jj] = p * (dp[r][c] - delta_s[i]);
      }
    }
    __syncthreads();

    // dq += ds . k (scale applied once at the end)
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float ds[4], kk[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = dSs[(ty + 16 * r) * LDP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = Ks[jj * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(ds[r], kk[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi < Tq) {
      float* out = dq + qbase + ((size_t)qi * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) out[tx + 16 * c] = scale * acc[r][c];
    }
  }
}

// -------------------------------------------------------------- K3: dk, dv

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ slopes, const int* __restrict__ offs,
                 const int* __restrict__ qids, const int* __restrict__ kids,
                 float* __restrict__ dk, float* __restrict__ dv,
                 int Tq, int S, int H, int KVH, float scale, int causal, int alibi) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Qs = Vs + BK * LD;    // [BQ][LD]
  float* dOs = Qs + BQ * LD;   // [BQ][LD]
  float* Ps = dOs + BQ * LD;   // [BK][LDP]: p transposed, [key][query]
  float* dSs = Ps + BK * LDP;  // [BK][LDP]: ds transposed
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ int qdoc_s[BQ], kdoc_s[BK];

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * BK;
  const int q_off = offs[b], kv_off = offs[gridDim.z + b];
  const bool has_docs = qids != nullptr;
  const size_t qbase = (size_t)b * Tq * H * D, kbase = (size_t)b * S * KVH * D;

  stage<D>(Ks, k + kbase, k0, S, KVH, kvh);
  stage<D>(Vs, v + kbase, k0, S, KVH, kvh);
  if (tid < BK) kdoc_s[tid] = has_docs && k0 + tid < S ? kids[(size_t)b * S + k0 + tid] : 0;

  // rows ty + 16 r of the key tile, dims tx + 16 c
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int n_q = (Tq + BQ - 1) / BQ;
  // the first q tile whose last row reaches key tile kt (i >= kt when both
  // offsets are 0); none for a future shard, and the tile writes zeros
  const int i_first = causal ? flash::first_query_tile(k0, q_off, kv_off, BQ, n_q) : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float slope = alibi ? slopes[h] : 0.f;
    for (int i = i_first; i < n_q; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous q tile is fully consumed
      stage<D>(Qs, q + qbase, q0, Tq, H, h);
      stage<D>(dOs, dout + qbase, q0, Tq, H, h);
      if (tid < BQ) {
        const int qi = q0 + tid;
        const size_t r = ((size_t)b * H + h) * Tq + qi;
        lse_s[tid] = qi < Tq ? lse[r] : 0.f;
        delta_s[tid] = qi < Tq ? delta[r] : 0.f;
        qdoc_s[tid] = has_docs && qi < Tq ? qids[(size_t)b * Tq + qi] : 0;
      }
      __syncthreads();

      // s^T = k . q^T and dp^T = v . do^T for keys ty + 16 r, queries tx + 16 c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], db[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = Ks[(ty + 16 * r) * LD + d];
          va[r] = Vs[(ty + 16 * r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qb[c] = Qs[(tx + 16 * c) * LD + d];
          db[c] = dOs[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ka[r], qb[c], s[r][c]);
            dp[r][c] = fmaf(va[r], db[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jj = ty + 16 * r, kp = k0 + jj;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ii = tx + 16 * c, qi = q0 + ii;
          float p = 0.f;
          if (qi < Tq && kp < S)
            p = expf(flash::biased_score(s[r][c], scale, (q_off + qi) - (kv_off + kp), slope,
                                         causal, alibi, has_docs, qdoc_s[ii], kdoc_s[jj]) -
                     lse_s[ii]);
          Ps[jj * LDP + ii] = p;
          dSs[jj * LDP + ii] = p * (dp[r][c] - delta_s[ii]);
        }
      }
      __syncthreads();

      // dv += p^T . do, dk += ds^T . q (scale applied once at the end)
#pragma unroll 4
      for (int ii = 0; ii < BQ; ++ii) {
        float pp[4], ds[4], dd[DC], qq[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pp[r] = Ps[(ty + 16 * r) * LDP + ii];
          ds[r] = dSs[(ty + 16 * r) * LDP + ii];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dd[c] = dOs[ii * LD + tx + 16 * c];
          qq[c] = Qs[ii * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[r][c] = fmaf(pp[r], dd[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds[r], qq[c], dk_acc[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty + 16 * r;
    if (kp < S) {
      const size_t a = kbase + ((size_t)kp * KVH + kvh) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[a + tx + 16 * c] = scale * dk_acc[r][c];
        dv[a + tx + 16 * c] = dv_acc[r][c];
      }
    }
  }
}

// ------------------------------------------- bf16: wgmma (Hopper, sm_90a)

// Every bf16 call (D = 64 or 128) runs both kernels on Hopper's warpgroup
// products. A CTA is one warpgroup (128 threads) that owns a 64-row output
// tile (K2: 64 query rows, K3: 64 keys) held in shared memory. The other
// side streams through a ring of STAGES shared-memory stages of 64 rows
// (K2: K and V tiles with their key ids; K3: Q and dO tiles with their lse,
// delta and query ids): the threads issue the next stage's cp.async copies
// before they multiply on the stage that has landed, so the loads run ahead
// of the products. Tiles use hopper.cuh's 128-byte-swizzled layout, read
// K-major by the first products and MN-major (transposed) by the second,
// so nothing is copied transposed:
// - K2, per key tile: s = q . k^T and dp = do . v^T (m64n64k16, both
//   operands in shared memory); p = exp(s - lse) while dp is still in
//   flight; ds = p (dp - delta); dq += ds . k with ds from registers
//   (rounded to bf16) and k read transposed from the K tile.
// - K3, per (query head, q tile): s^T = k . q^T and dp^T = v . do^T; p^T
//   while dp^T is in flight; dv += p^T . do, and ds^T while that runs; then
//   dk += ds^T . q; do and q read transposed from their tiles.
// Two CTAs share an SM: K3 at D = 128 holds dk and dv (128 f32 registers a
// thread) plus s^T and dp^T (64), and 2 x 128 threads at up to 256
// registers fill the register file. Two one-warpgroup CTAs rather than
// FlashAttention-3's two consumer warpgroups in one CTA: independent CTAs
// drift apart, so one's exp and ds work overlaps the other's products,
// where two warpgroups that share a stage meet at its barrier in step (on
// an H100 side by side: as fast at D = 128, faster at D = 64). The tile
// index is the grid's slowest axis, ordered so that under the causal limit
// the CTAs with the most work start first (K2: the last q tiles; K3: the
// first key tiles), over every head and batch row, and the wave's tail
// holds the short ones.
namespace wg {

constexpr int THREADS = 128;  // one warpgroup
constexpr int BT = 64;        // rows of every tile: the output tile and each stage
constexpr int STAGES = 2;

// bytes of dynamic shared memory: 1 KB to align the tiles, then K2: Q, dO,
// STAGES x (K, V) and STAGES x BT key ids; K3: K, V, STAGES x (Q, dO) and
// STAGES x BT of lse, delta and query ids
template <int D>
constexpr int dq_smem() { return 1024 + (2 + 2 * STAGES) * BT * D * 2 + STAGES * BT * 4; }
template <int D>
constexpr int dkv_smem() { return 1024 + (2 + 2 * STAGES) * BT * D * 2 + 3 * STAGES * BT * 4; }

}  // namespace wg

using bf16 = __nv_bfloat16;

// two neighbouring grads, rounded to bf16 or kept in f32 (flash_grads)
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

template <typename OutT, int D>
__global__ void __launch_bounds__(wg::THREADS, 2)
flash_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ slopes, const int* __restrict__ offs,
                      const int* __restrict__ qids, const int* __restrict__ kids,
                      OutT* __restrict__ dq, int Tq, int S, int H, int KVH, float scale, int causal,
                      int alibi) {
  constexpr int BT = wg::BT, STAGES = wg::STAGES, THREADS = wg::THREADS;
  constexpr int NB = D / 64;  // 64-column blocks of an output row
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(hopper::align1024(smem_raw));
  bf16* dOs = Qs + BT * D;
  bf16* Ks = dOs + BT * D;                                     // STAGES tiles
  bf16* Vs = Ks + STAGES * BT * D;                             // STAGES tiles
  int* kdoc = reinterpret_cast<int*>(Vs + STAGES * BT * D);    // STAGES x [BT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KVH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BT;  // the last q tiles (most key tiles) first
  const int q_off = offs[b], kv_off = offs[gridDim.y + b];
  const float slope = alibi ? slopes[h] : 0.f;
  const bool has_docs = qids != nullptr;
  const size_t qld = (size_t)H * D, kld = (size_t)KVH * D;
  const bf16* ksrc = k + (size_t)b * S * kld + (size_t)kvh * D;
  const bf16* vsrc = v + (size_t)b * S * kld + (size_t)kvh * D;

  int n_tiles = (S + BT - 1) / BT;
  if (causal) n_tiles = flash::causal_key_tiles(n_tiles, q_off + min(q0 + BT, Tq) - 1, kv_off, BT);

  auto load_keys = [&](int j) {
    const int st = j % STAGES, k0 = j * BT;
    hopper::load_tile<BT, D>(Ks + st * BT * D, ksrc, k0, S, kld, tid, THREADS);
    hopper::load_tile<BT, D>(Vs + st * BT * D, vsrc, k0, S, kld, tid, THREADS);
    if (has_docs && tid < BT)
      hopper::copy4(kdoc + st * BT + tid, kids + (size_t)b * S + min(k0 + tid, S - 1), k0 + tid < S);
  };
  hopper::load_tile<BT, D>(Qs, q + (size_t)b * Tq * qld + (size_t)h * D, q0, Tq, qld, tid, THREADS);
  hopper::load_tile<BT, D>(dOs, dout + (size_t)b * Tq * qld + (size_t)h * D, q0, Tq, qld, tid,
                           THREADS);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_keys(j);
    hopper::commit_copies();
  }

  // rows r0 and r0 + 8 of the tile: the accumulator layout's
  int qi_r[2], qdoc_r[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi_r[r] = q0 + 16 * warp + lane / 4 + 8 * r;
    const bool ok = qi_r[r] < Tq;
    const size_t at = ((size_t)b * H + h) * Tq + qi_r[r];
    lse_r[r] = ok ? lse[at] : 0.f;
    delta_r[r] = ok ? delta[at] : 0.f;
    qdoc_r[r] = has_docs && ok ? qids[(size_t)b * Tq + qi_r[r]] : 0;
  }

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + STAGES - 1 < n_tiles) load_keys(j + STAGES - 1);
    hopper::commit_copies();
    hopper::wait_copies<STAGES - 1>();  // tile j (and q, do) have landed
    hopper::fence_async_proxy();
    __syncthreads();
    const int st = j % STAGES, k0 = j * BT;
    const bf16* Kt = Ks + st * BT * D;
    const bf16* Vt = Vs + st * BT * D;
    const int* kd = kdoc + st * BT;
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // s = q . k^T
      hopper::mma_ss(s, hopper::desc_k<BT>(Qs, 0, kk), hopper::desc_k<BT>(Kt, 0, kk), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dp = do . v^T
      hopper::mma_ss(dp, hopper::desc_k<BT>(dOs, 0, kk), hopper::desc_k<BT>(Vt, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // s has landed; dp may still be in flight
    hopper::fence_regs(s);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1), kp = k0 + col;
      float p = 0.f;
      if (qi_r[r] < Tq && kp < S)
        p = expf(flash::biased_score(s[e], scale, (q_off + qi_r[r]) - (kv_off + kp), slope, causal,
                                     alibi, has_docs, qdoc_r[r], has_docs ? kd[col] : 0) -
                 lse_r[r]);
      s[e] = p;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - delta_r[(e >> 1) & 1]);  // ds
    uint32_t a[4][4];
    hopper::to_a(a, dp);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)  // dq += ds . k (k read transposed)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::mma_rs(acc[nb], a[kk], hopper::desc_mn<BT>(Kt, nb, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
    __syncthreads();  // stage st is free for the copies issued next
  }
  hopper::wait_copies<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi_r[r] < Tq) {
      OutT* out = dq + ((size_t)b * Tq + qi_r[r]) * qld + (size_t)h * D + 2 * (lane & 3);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store2(out + 64 * nb + 8 * j, scale * acc[nb][4 * j + 2 * r], scale * acc[nb][4 * j + 2 * r + 1]);
    }
  }
}

template <typename OutT, int D>
__global__ void __launch_bounds__(wg::THREADS, 2)
flash_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ slopes, const int* __restrict__ offs,
                       const int* __restrict__ qids, const int* __restrict__ kids,
                       OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq, int S, int H, int KVH,
                       float scale, int causal, int alibi) {
  constexpr int BT = wg::BT, STAGES = wg::STAGES, THREADS = wg::THREADS;
  constexpr int NB = D / 64;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(hopper::align1024(smem_raw));
  bf16* Vs = Ks + BT * D;
  bf16* Qs = Vs + BT * D;                                           // STAGES tiles
  bf16* dOs = Qs + STAGES * BT * D;                                 // STAGES tiles
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * BT * D);   // STAGES x [BT]
  float* delta_s = lse_s + STAGES * BT;                             // STAGES x [BT]
  int* qdoc_s = reinterpret_cast<int*>(delta_s + STAGES * BT);      // STAGES x [BT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KVH;
  const int k0 = blockIdx.z * BT;  // the first key tiles (most q tiles) first
  const int q_off = offs[b], kv_off = offs[gridDim.y + b];
  const bool has_docs = qids != nullptr;
  const size_t qld = (size_t)H * D, kld = (size_t)KVH * D;

  const int n_q = (Tq + BT - 1) / BT;
  // the first q tile whose last row sees the key tile; none for a future
  // shard, and the CTA writes zeros
  const int i_first = causal ? flash::first_query_tile(k0, q_off, kv_off, BT, n_q) : 0;
  const int per_head = n_q - i_first, n_items = G * per_head;

  auto load_queries = [&](int it) {
    const int st = it % STAGES, hq = kvh * G + it / per_head, r0 = (i_first + it % per_head) * BT;
    const size_t at = (size_t)b * Tq * qld + (size_t)hq * D;
    hopper::load_tile<BT, D>(Qs + st * BT * D, q + at, r0, Tq, qld, tid, THREADS);
    hopper::load_tile<BT, D>(dOs + st * BT * D, dout + at, r0, Tq, qld, tid, THREADS);
    if (tid < BT) {
      const int qi = r0 + tid;
      const bool ok = qi < Tq;
      const size_t row = ((size_t)b * H + hq) * Tq + min(qi, Tq - 1);
      hopper::copy4(lse_s + st * BT + tid, lse + row, ok);
      hopper::copy4(delta_s + st * BT + tid, delta + row, ok);
      if (has_docs) hopper::copy4(qdoc_s + st * BT + tid, qids + (size_t)b * Tq + min(qi, Tq - 1), ok);
    }
  };
  hopper::load_tile<BT, D>(Ks, k + (size_t)b * S * kld + (size_t)kvh * D, k0, S, kld, tid, THREADS);
  hopper::load_tile<BT, D>(Vs, v + (size_t)b * S * kld + (size_t)kvh * D, k0, S, kld, tid, THREADS);
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_items) load_queries(it);
    hopper::commit_copies();
  }

  // keys r0 and r0 + 8 of the tile (the accumulator's rows)
  int kp_r[2], kdoc_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kp_r[r] = k0 + 16 * warp + lane / 4 + 8 * r;
    kdoc_r[r] = has_docs && kp_r[r] < S ? kids[(size_t)b * S + kp_r[r]] : 0;
  }

  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + STAGES - 1 < n_items) load_queries(it + STAGES - 1);
    hopper::commit_copies();
    hopper::wait_copies<STAGES - 1>();  // item it (and k, v) have landed
    hopper::fence_async_proxy();
    __syncthreads();
    const int st = it % STAGES, hq = kvh * G + it / per_head, q0 = (i_first + it % per_head) * BT;
    const bf16* Qt = Qs + st * BT * D;
    const bf16* dOt = dOs + st * BT * D;
    const float* ls = lse_s + st * BT;
    const float* dl = delta_s + st * BT;
    const int* qd = qdoc_s + st * BT;
    const float slope = alibi ? slopes[hq] : 0.f;
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // s^T = k . q^T (rows keys, columns queries)
      hopper::mma_ss(s, hopper::desc_k<BT>(Ks, 0, kk), hopper::desc_k<BT>(Qt, 0, kk), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dp^T = v . do^T
      hopper::mma_ss(dp, hopper::desc_k<BT>(Vs, 0, kk), hopper::desc_k<BT>(dOt, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // s^T has landed; dp^T may still be in flight
    hopper::fence_regs(s);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1), qi = q0 + col;
      float p = 0.f;
      if (qi < Tq && kp_r[r] < S)
        p = expf(flash::biased_score(s[e], scale, (q_off + qi) - (kv_off + kp_r[r]), slope, causal,
                                     alibi, has_docs, has_docs ? qd[col] : 0, kdoc_r[r]) -
                 ls[col]);
      s[e] = p;
    }
    uint32_t pa[4][4];
    hopper::to_a(pa, s);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dv_acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)  // dv += p^T . do (do read transposed)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::mma_rs(dv_acc[nb], pa[kk], hopper::desc_mn<BT>(dOt, nb, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // dp^T has landed; dv may still be in flight
    hopper::fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - dl[8 * (e >> 2) + 2 * (lane & 3) + (e & 1)]);
    uint32_t da[4][4];
    hopper::to_a(da, dp);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dk_acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)  // dk += ds^T . q (q read transposed)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::mma_rs(dk_acc[nb], da[kk], hopper::desc_mn<BT>(Qt, nb, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      hopper::fence_regs(dk_acc[nb]);
      hopper::fence_regs(dv_acc[nb]);
    }
    __syncthreads();  // stage st is free for the copies issued next
  }
  hopper::wait_copies<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp_r[r] < S) {
      const size_t at = ((size_t)b * S + kp_r[r]) * kld + (size_t)kvh * D + 2 * (lane & 3);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int e = 4 * j + 2 * r, c = 64 * nb + 8 * j;
          store2(dk + at + c, scale * dk_acc[nb][e], scale * dk_acc[nb][e + 1]);
          store2(dv + at + c, dv_acc[nb][e], dv_acc[nb][e + 1]);
        }
    }
  }
}

// ------------------------------------------------------------------ launch

// the pointer and shape arguments every launch passes on, in order
#define BWD_PARAMS                                                                             \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, const void *slopes, const void *offs, const void *qids,               \
      const void *kids
#define BWD_CAST(T)                                                                            \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),                \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                             \
      static_cast<const float*>(delta), static_cast<const float*>(slopes),                     \
      static_cast<const int*>(offs), static_cast<const int*>(qids),                            \
      static_cast<const int*>(kids)

template <int D>
int launch_dq(BWD_PARAMS, void* dq, int B, int Tq, int S, int H, int KVH, float scale, int causal,
              int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP);
  cudaFuncSetAttribute(flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      BWD_CAST(float), static_cast<float*>(dq), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(BWD_PARAMS, void* dk, void* dv, int B, int Tq, int S, int H, int KVH, float scale,
               int causal, int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * LDP);
  cudaFuncSetAttribute(flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((S + BK - 1) / BK, KVH, B);
  flash_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      BWD_CAST(float), static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, H, KVH, scale,
      causal, alibi);
  return (int)cudaGetLastError();
}

template <typename OutT, int D>
int launch_dq_wgmma(BWD_PARAMS, void* dq, int B, int Tq, int S, int H, int KVH, float scale,
                    int causal, int alibi, cudaStream_t stream) {
  constexpr int smem = wg::dq_smem<D>();
  cudaFuncSetAttribute(flash_dq_wgmma_kernel<OutT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid(H, B, (Tq + wg::BT - 1) / wg::BT);
  flash_dq_wgmma_kernel<OutT, D><<<grid, wg::THREADS, smem, stream>>>(
      BWD_CAST(bf16), static_cast<OutT*>(dq), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <typename OutT, int D>
int launch_dkv_wgmma(BWD_PARAMS, void* dk, void* dv, int B, int Tq, int S, int H, int KVH,
                     float scale, int causal, int alibi, cudaStream_t stream) {
  constexpr int smem = wg::dkv_smem<D>();
  cudaFuncSetAttribute(flash_dkv_wgmma_kernel<OutT, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(KVH, B, (S + wg::BT - 1) / wg::BT);
  flash_dkv_wgmma_kernel<OutT, D><<<grid, wg::THREADS, smem, stream>>>(
      BWD_CAST(bf16), static_cast<OutT*>(dk), static_cast<OutT*>(dv), Tq, S, H, KVH, scale,
      causal, alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and do); out_dtype: the grads',
// 0 = float32 or 1 = bfloat16 (float32 inputs take float32 only). bf16
// takes the wgmma kernels, float32 the FMA ones. lse
// and delta are f32 [B, H, T]; slopes f32 [H]; offs int32 [2, B] (query
// offsets, then key offsets); qids [B, T] and kids [B, S] int32 document ids,
// both or neither. q, do, dq are [B, T, H, D]; k, v, dk, dv are
// [B, S, KVH, D], all contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_dq(BWD_PARAMS, void* dq, int dtype, int out_dtype, int B, int Tq, int S, int H,
                        int KVH, int D, float scale, int causal, int alibi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((qids == nullptr) != (kids == nullptr)) return (int)cudaErrorInvalidValue;
#define DQ_ARGS \
  q, k, v, dout, lse, delta, slopes, offs, qids, kids, dq, B, Tq, S, H, KVH, scale, causal, alibi, st
  if (dtype == 0 && out_dtype == 0 && D == 64) return launch_dq<64>(DQ_ARGS);
  if (dtype == 0 && out_dtype == 0 && D == 128) return launch_dq<128>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 64) return launch_dq_wgmma<bf16, 64>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 64) return launch_dq_wgmma<float, 64>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 128) return launch_dq_wgmma<bf16, 128>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 128) return launch_dq_wgmma<float, 128>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_dkv(BWD_PARAMS, void* dk, void* dv, int dtype, int out_dtype, int B, int Tq,
                         int S, int H, int KVH, int D, float scale, int causal, int alibi,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((qids == nullptr) != (kids == nullptr)) return (int)cudaErrorInvalidValue;
#define DKV_ARGS                                                                               \
  q, k, v, dout, lse, delta, slopes, offs, qids, kids, dk, dv, B, Tq, S, H, KVH, scale, causal, \
      alibi, st
  if (dtype == 0 && out_dtype == 0 && D == 64) return launch_dkv<64>(DKV_ARGS);
  if (dtype == 0 && out_dtype == 0 && D == 128) return launch_dkv<128>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 64) return launch_dkv_wgmma<bf16, 64>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 64) return launch_dkv_wgmma<float, 64>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 128) return launch_dkv_wgmma<bf16, 128>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 128) return launch_dkv_wgmma<float, 128>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
