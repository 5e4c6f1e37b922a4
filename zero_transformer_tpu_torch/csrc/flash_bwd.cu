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
// tensor-core path rounds p and ds to bf16 for its second products, as the
// forward rounds p for o. T need not be a multiple of the 64-row tile: rows
// and keys past the end get p = 0. With int32 document ids (query ids
// [B, T], key ids [B, S]; packed documents) the scores carry the forward's
// document mask, from the same header: the query ids of a tile sit in
// registers or shared memory beside lse/delta, the key ids beside the key
// tile; tiles that hold no pair of one document are still visited
// (skipping them is sound only for monotone ids).
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
// from run to run:
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
// What bounds it on an H100: at the training shape (B = 8, H = KVH = 12,
// T = S = 1024, D = 64, bf16) K2 must move 5 x 12.6 MB (q, k, v, do in, dq
// out) plus 0.8 MB of lse/delta, 19 us at 3.35 TB/s, and do 19.3 GFLOP
// causal (three products of 2*T*S*D/2 per head), 19.5 us at the bf16
// tensor-core peak; K3 moves 6 x 12.6 MB (dk, dv out) and does 25.8 GFLOP
// (four products), 26 us. Both sit at the ridge: the tensor-core rate and
// the bytes bound them about equally. Two designs:
// - bf16 at D = 64 (the training path): mma.sync on the tensor cores (see
//   the tensor-core section below). It reaches a small share of the bound:
//   each CTA loads a tile, then computes, with no loads in flight behind
//   the products (cp.async double buffering, then wgmma + TMA, are the next
//   steps), and K3 needs 238 registers a thread.
// - f32, and bf16 at D = 128 (580m's ring shape among them): plain FMA in
//   f32 on the CUDA cores (like K1's f32 path), whose peak is 67 TFLOP/s:
//   at that shape (a 2048-token shard, 12 heads of 128) a past shard's K3
//   does 51.5 GFLOP, 0.77 ms at that peak. Tiles are staged in shared
//   memory as f32 with rows padded by one word (conflict-free column
//   walks); each of 256 threads owns a 4 x 4 block of the 64 x 64 score
//   tile and a 4 x D/16 block of the output tile. In f32 this path computes
//   the plain version's arithmetic in the same order (sequential FMAs),
//   which the card's f32 GEMMs also do: at D = 64 (scale 1/8 exact) its MHA
//   grads match the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score block
constexpr int LDP = BK + 1;   // padded row of a [64][64] probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [r0, r0 + 64) of head `head` of a [rows, heads, D] slab into
// shared memory as f32, row stride D + 1; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n,
                                      int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? to_f32(src[((size_t)row * heads + head) * D + d]) : 0.f;
  }
}

// ------------------------------------------------------------------ K2: dq

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const float* __restrict__ slopes,
                const int* __restrict__ offs, const int* __restrict__ qids,
                const int* __restrict__ kids, OutT* __restrict__ dq, int Tq, int S, int H,
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

  stage<T, D>(Qs, q + qbase, q0, Tq, H, h);
  stage<T, D>(dOs, dout + qbase, q0, Tq, H, h);
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
    stage<T, D>(Ks, k + kbase, k0, S, KVH, kvh);
    stage<T, D>(Vs, v + kbase, k0, S, KVH, kvh);
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
      OutT* out = dq + qbase + ((size_t)qi * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) out[tx + 16 * c] = from_f32<OutT>(scale * acc[r][c]);
    }
  }
}

// -------------------------------------------------------------- K3: dk, dv

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ slopes,
                 const int* __restrict__ offs, const int* __restrict__ qids,
                 const int* __restrict__ kids, OutT* __restrict__ dk, OutT* __restrict__ dv,
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

  stage<T, D>(Ks, k + kbase, k0, S, KVH, kvh);
  stage<T, D>(Vs, v + kbase, k0, S, KVH, kvh);
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
      stage<T, D>(Qs, q + qbase, q0, Tq, H, h);
      stage<T, D>(dOs, dout + qbase, q0, Tq, H, h);
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
        dk[a + tx + 16 * c] = from_f32<OutT>(scale * dk_acc[r][c]);
        dv[a + tx + 16 * c] = from_f32<OutT>(dv_acc[r][c]);
      }
    }
  }
}

// ------------------------------------------------- bf16 tensor-core paths

// bf16 at D = 64 (the training shape) runs the same two designs on the
// tensor cores: mma.sync.m16n8k16 in the FlashAttention-2 register layout,
// 4 warps of 16 rows per CTA. The score and dp accumulators (f32) become the
// p and ds A-operands without touching shared memory; p and ds are rounded
// to bf16 for the dv, dk and dq products (as FlashAttention-2 does), and
// every sum stays in f32. Tiles sit in shared memory as bf16 with rows
// padded by 8 elements (conflict-free fragment loads), plus the transposed
// copies that serve as B operands of the second products (K^T for dq,
// Q^T and dO^T for dk and dv).

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr int MD = 64;            // head width of the tensor-core path
constexpr int LDM = MD + 8;       // padded row of a [64][D] bf16 tile
constexpr int LDT = 64 + 8;       // padded row of a transposed [D][64] tile
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring grads, rounded to bf16 or kept in f32 (flash_grads)
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// Stage rows [r0, r0 + 64) of head `head` of a [rows, heads, 64] bf16 slab:
// into dst ([64][LDM]) and/or transposed into dst_t ([64][LDT]); rows at or
// past n are zero.
__device__ __forceinline__ void stage_bf16(bf16* dst, bf16* dst_t, const bf16* __restrict__ src,
                                           int r0, int n, int heads, int head) {
  constexpr int VPR = MD / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += MMA_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) val = *reinterpret_cast<const uint4*>(src + ((size_t)row * heads + head) * MD + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * LDM + c) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(c + i) * LDT + r] = e[i];
    }
  }
}

// A-operand fragments (16 rows x 64) of the warp's rows of a [64][LDM] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[MD / 16][4], const bf16* tile, int rw, int g,
                                       int t4) {
#pragma unroll
  for (int kk = 0; kk < MD / 16; ++kk) {
    const bf16* base = tile + (rw + g) * LDM + kk * 16 + t4 * 2;
    a[kk][0] = ld32(base);
    a[kk][1] = ld32(base + 8 * LDM);
    a[kk][2] = ld32(base + 8);
    a[kk][3] = ld32(base + 8 * LDM + 8);
  }
}

// acc[nb] (16 x 8 blocks over 64 columns) = A (16 x 64) . tile^T, tile [64][LDM]
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[MD / 16][4],
                                         const bf16* tile, int g, int t4) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MD / 16; ++kk) {
      const bf16* p = tile + (nb * 8 + g) * LDM + kk * 16 + t4 * 2;
      mma_bf16(acc[nb], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// out[nd] += X (16 x 64, f32 accumulators in C layout, rounded to bf16) .
// tile_t^T, tile_t [D][LDT] holding the [64][D] operand transposed
__device__ __forceinline__ void mma_cols(float (&out)[MD / 8][4], const float (&x)[8][4],
                                         const bf16* tile_t, int g, int t4) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kb][0], x[2 * kb][1]),
                            pack_bf16(x[2 * kb][2], x[2 * kb][3]),
                            pack_bf16(x[2 * kb + 1][0], x[2 * kb + 1][1]),
                            pack_bf16(x[2 * kb + 1][2], x[2 * kb + 1][3])};
#pragma unroll
    for (int nd = 0; nd < MD / 8; ++nd) {
      const bf16* p = tile_t + (nd * 8 + g) * LDT + kb * 16 + t4 * 2;
      mma_bf16(out[nd], xa, ld32(p), ld32(p + 8));
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ slopes, const int* __restrict__ offs,
                    const int* __restrict__ qids, const int* __restrict__ kids,
                    OutT* __restrict__ dq, int Tq, int S, int H, int KVH, float scale, int causal,
                    int alibi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDM]
  bf16* dOs = Qs + BQ * LDM;                     // [BQ][LDM]
  bf16* Ks = dOs + BQ * LDM;                     // [BK][LDM]
  bf16* Vs = Ks + BK * LDM;                      // [BK][LDM]
  bf16* Kt = Vs + BK * LDM;                      // [D][LDT]
  __shared__ int kdoc_s[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 16;
  const int q0 = qt * BQ;
  const int q_off = offs[b], kv_off = offs[gridDim.z + b];
  const float slope = alibi ? slopes[h] : 0.f;
  const size_t qbase = (size_t)b * Tq * H * MD, kbase = (size_t)b * S * KVH * MD;

  stage_bf16(Qs, nullptr, q + qbase, q0, Tq, H, h);
  stage_bf16(dOs, nullptr, dout + qbase, q0, Tq, H, h);
  // rows g and g + 8 of the warp's 16, the accumulator fragment's mapping
  const bool has_docs = qids != nullptr;
  int qi_r[2], qdoc_r[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi_r[r] = q0 + rw + g + 8 * r;
    const size_t at = ((size_t)b * H + h) * Tq + qi_r[r];
    lse_r[r] = qi_r[r] < Tq ? lse[at] : 0.f;
    delta_r[r] = qi_r[r] < Tq ? delta[at] : 0.f;
    qdoc_r[r] = has_docs && qi_r[r] < Tq ? qids[(size_t)b * Tq + qi_r[r]] : 0;
  }
  __syncthreads();
  uint32_t qa[MD / 16][4], da[MD / 16][4];
  load_a(qa, Qs, rw, g, t4);
  load_a(da, dOs, rw, g, t4);

  float acc[MD / 8][4];
#pragma unroll
  for (int nd = 0; nd < MD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = flash::causal_key_tiles(n_tiles, q_off + min(q0 + BQ, Tq) - 1, kv_off, BK);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is fully consumed
    stage_bf16(Ks, Kt, k + kbase, k0, S, KVH, kvh);
    stage_bf16(Vs, nullptr, v + kbase, k0, S, KVH, kvh);
    if (threadIdx.x < BK) {
      const int kp = k0 + (int)threadIdx.x;
      kdoc_s[threadIdx.x] = has_docs && kp < S ? kids[(size_t)b * S + kp] : 0;
    }
    __syncthreads();
    float s[8][4], ds[8][4];
    mma_rows(s, qa, Ks, g, t4);   // s = q . k^T
    mma_rows(ds, da, Vs, g, t4);  // dp = do . v^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = nb * 8 + t4 * 2 + (e & 1), kp = k0 + col;
        float p = 0.f;
        if (qi_r[r] < Tq && kp < S)
          p = expf(flash::biased_score(s[nb][e], scale, (q_off + qi_r[r]) - (kv_off + kp), slope,
                                       causal, alibi, has_docs, qdoc_r[r], kdoc_s[col]) -
                   lse_r[r]);
        ds[nb][e] = p * (ds[nb][e] - delta_r[r]);
      }
    mma_cols(acc, ds, Kt, g, t4);  // dq += ds . k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi_r[r] < Tq) {
      OutT* out = dq + qbase + ((size_t)qi_r[r] * H + h) * MD + t4 * 2;
#pragma unroll
      for (int nd = 0; nd < MD / 8; ++nd)
        store2(out + nd * 8, scale * acc[nd][2 * r], scale * acc[nd][2 * r + 1]);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ slopes, const int* __restrict__ offs,
                     const int* __restrict__ qids, const int* __restrict__ kids,
                     OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq, int S, int H, int KVH,
                     float scale, int causal, int alibi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDM]
  bf16* Vs = Ks + BK * LDM;                      // [BK][LDM]
  bf16* Qs = Vs + BK * LDM;                      // [BQ][LDM]
  bf16* dOs = Qs + BQ * LDM;                     // [BQ][LDM]
  bf16* Qt = dOs + BQ * LDM;                     // [D][LDT]
  bf16* dOt = Qt + MD * LDT;                     // [D][LDT]
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ int qdoc_s[BQ];

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 16;
  const int k0 = kt * BK;
  const int q_off = offs[b], kv_off = offs[gridDim.z + b];
  const size_t qbase = (size_t)b * Tq * H * MD, kbase = (size_t)b * S * KVH * MD;

  stage_bf16(Ks, nullptr, k + kbase, k0, S, KVH, kvh);
  stage_bf16(Vs, nullptr, v + kbase, k0, S, KVH, kvh);
  __syncthreads();
  uint32_t ka[MD / 16][4], va[MD / 16][4];
  load_a(ka, Ks, rw, g, t4);
  load_a(va, Vs, rw, g, t4);
  // keys g and g + 8 of the warp's 16 (the fragment's rows) and their ids
  const int kp_r[2] = {k0 + rw + g, k0 + rw + g + 8};
  const bool has_docs = qids != nullptr;
  int kdoc_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kdoc_r[r] = has_docs && kp_r[r] < S ? kids[(size_t)b * S + kp_r[r]] : 0;

  float dk_acc[MD / 8][4], dv_acc[MD / 8][4];
#pragma unroll
  for (int nd = 0; nd < MD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  const int n_q = (Tq + BQ - 1) / BQ;
  const int i_first = causal ? flash::first_query_tile(k0, q_off, kv_off, BQ, n_q) : 0;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float slope = alibi ? slopes[h] : 0.f;
    for (int i = i_first; i < n_q; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous q tile is fully consumed
      stage_bf16(Qs, Qt, q + qbase, q0, Tq, H, h);
      stage_bf16(dOs, dOt, dout + qbase, q0, Tq, H, h);
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        const size_t at = ((size_t)b * H + h) * Tq + qi;
        lse_s[threadIdx.x] = qi < Tq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = qi < Tq ? delta[at] : 0.f;
        qdoc_s[threadIdx.x] = has_docs && qi < Tq ? qids[(size_t)b * Tq + qi] : 0;
      }
      __syncthreads();
      float p[8][4], ds[8][4];
      mma_rows(p, ka, Qs, g, t4);    // s^T = k . q^T (rows keys, columns queries)
      mma_rows(ds, va, dOs, g, t4);  // dp^T = v . do^T
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + t4 * 2 + (e & 1), qi = q0 + col, kp = kp_r[e >> 1];
          float pv = 0.f;
          if (qi < Tq && kp < S)
            pv = expf(flash::biased_score(p[nb][e], scale, (q_off + qi) - (kv_off + kp), slope,
                                          causal, alibi, has_docs, qdoc_s[col], kdoc_r[e >> 1]) -
                      lse_s[col]);
          p[nb][e] = pv;
          ds[nb][e] = pv * (ds[nb][e] - delta_s[col]);
        }
      mma_cols(dv_acc, p, dOt, g, t4);  // dv += p^T . do
      mma_cols(dk_acc, ds, Qt, g, t4);  // dk += ds^T . q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kp_r[r] < S) {
      const size_t at = kbase + ((size_t)kp_r[r] * KVH + kvh) * MD + t4 * 2;
#pragma unroll
      for (int nd = 0; nd < MD / 8; ++nd) {
        store2(dk + at + nd * 8, scale * dk_acc[nd][2 * r], scale * dk_acc[nd][2 * r + 1]);
        store2(dv + at + nd * 8, dv_acc[nd][2 * r], dv_acc[nd][2 * r + 1]);
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

template <typename T, typename OutT, int D>
int launch_dq(BWD_PARAMS, void* dq, int B, int Tq, int S, int H, int KVH, float scale, int causal,
              int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP);
  cudaFuncSetAttribute(flash_dq_kernel<T, OutT, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_dq_kernel<T, OutT, D><<<grid, THREADS, smem, stream>>>(
      BWD_CAST(T), static_cast<OutT*>(dq), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT, int D>
int launch_dkv(BWD_PARAMS, void* dk, void* dv, int B, int Tq, int S, int H, int KVH, float scale,
               int causal, int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * LDP);
  cudaFuncSetAttribute(flash_dkv_kernel<T, OutT, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((S + BK - 1) / BK, KVH, B);
  flash_dkv_kernel<T, OutT, D><<<grid, THREADS, smem, stream>>>(
      BWD_CAST(T), static_cast<OutT*>(dk), static_cast<OutT*>(dv), Tq, S, H, KVH, scale, causal,
      alibi);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_dq_mma(BWD_PARAMS, void* dq, int B, int Tq, int S, int H, int KVH, float scale,
                  int causal, int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * 64 * LDM + MD * LDT);
  cudaFuncSetAttribute(flash_dq_mma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_dq_mma_kernel<OutT><<<grid, MMA_THREADS, smem, stream>>>(
      BWD_CAST(bf16), static_cast<OutT*>(dq), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_dkv_mma(BWD_PARAMS, void* dk, void* dv, int B, int Tq, int S, int H, int KVH,
                   float scale, int causal, int alibi, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (4 * 64 * LDM + 2 * MD * LDT);
  cudaFuncSetAttribute(flash_dkv_mma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((S + BK - 1) / BK, KVH, B);
  flash_dkv_mma_kernel<OutT><<<grid, MMA_THREADS, smem, stream>>>(
      BWD_CAST(bf16), static_cast<OutT*>(dk), static_cast<OutT*>(dv), Tq, S, H, KVH, scale,
      causal, alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and do); out_dtype: the grads',
// 0 = float32 or 1 = bfloat16 (float32 inputs take float32 only). bf16 at
// D = 64 takes the tensor-core kernels, everything else the FMA ones. lse
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
  if (dtype == 0 && out_dtype == 0 && D == 64) return launch_dq<float, float, 64>(DQ_ARGS);
  if (dtype == 0 && out_dtype == 0 && D == 128) return launch_dq<float, float, 128>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 64) return launch_dq_mma<bf16>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 64) return launch_dq_mma<float>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 128) return launch_dq<bf16, bf16, 128>(DQ_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 128) return launch_dq<bf16, float, 128>(DQ_ARGS);
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
  if (dtype == 0 && out_dtype == 0 && D == 64) return launch_dkv<float, float, 64>(DKV_ARGS);
  if (dtype == 0 && out_dtype == 0 && D == 128) return launch_dkv<float, float, 128>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 64) return launch_dkv_mma<bf16>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 64) return launch_dkv_mma<float>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 128) return launch_dkv<bf16, bf16, 128>(DKV_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 128) return launch_dkv<bf16, float, 128>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
