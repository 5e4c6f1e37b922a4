// Paged decode attention: reads K/V straight from the page pool through each
// row's block table.
//
// Replaces the TPU kernel zero_transformer_tpu/ops/pallas/paged_attention.py::
// _kernel (driven by paged_attention at :178). Same function: q [B, T, H, D]
// (T = 1 decode, up to 8 for a verify window) against pools
// [n_pages, page, KVH, D] addressed through block_table [B, n_blocks]
// (page 0 is the serving layer's trash page); per-row ALiBi, the causal mask
// inside the window when T > 1, and validity pos < q_offset[b] + T. The TPU
// kernel stages the whole row in VMEM and runs one full softmax so that it is
// bitwise equal to the gather path; this kernel splits the row's keys across
// CTAs and merges their softmax statistics instead, and matches the gather
// path to a tolerance. Keys at or past q_offset + T are masked on the TPU
// (they add exp(-1e10) = 0), so the page walk simply stops there.
//
// What bounds it on an H100: decode does 4*D flops per key per query row
// against 4*D bytes of bf16 K/V, about one flop per byte: reading the pages
// is the whole cost. A call at the serving shapes (B = 4 rows, 12 kv heads,
// contexts up to 1024) must move about 6 MB, 2 us at full HBM rate; the
// split-KV grid below exists to keep more of those reads in flight at once,
// and the kernel still reaches a small share of the rate (too few loads in
// flight per SM: memory-level parallelism, not the payload, bounds it).
//
// Design (split-KV, "flash decoding"):
// - paged_partial_kernel, one CTA (4 warps) per (256-key split, kv head and
//   block of up to 8 of its query rows, batch row): rows are the kv head's
//   G query heads times the T window positions. A group of D/VEC lanes owns
//   one key and loads its K (then V) row with 16-byte vector loads, straight
//   from the page the block table names; the group reduces q.k with
//   shuffles. Scores of the split sit in shared memory; one warp per row
//   takes their max and sum; the P.V pass reuses the key mapping and sums
//   the per-lane accumulators across lane groups (shuffles) and warps
//   (shared memory). It writes the split's unnormalised output and (m, l).
// - paged_combine_kernel, one CTA per (query row, batch row), D threads:
//   out = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s.
// Splits past the row's last key write an empty partial (l = 0) and exit.
// NaN-poisoned q rows come out NaN; an all-zero (trash) table reads page 0
// and runs without a fault.
//
// int8 pools (the TPU kernel's int8 branch, paged_attention.py:121-135): the
// partial kernel is a template on (compute type T, storage type S). With
// S = int8 a lane loads 16 int8 values in one 16-byte load (D/16 lanes per
// key: 4 at D 64, 8 at D 128) and the key's float32 scale for its kv head,
// k_scale[(pg * page + pos % page) * KVH + kvh], and dequantizes as the TPU
// kernel does: f32(int8) * scale, rounded to T (for bf16, __float2bfloat16
// and back) before the q.k dot and the p.v sum. A trash page with scale 0
// reads as zeros. Per key and kv head it moves 2 * D + 8 bytes of K/V and
// scales against 4 * D for bf16 (0.53x at D 64); the same memory-level
// parallelism bounds it as the bf16 path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int SPLIT = 256;         // keys per partial CTA (ops/paged_attention.py _SPLIT)
constexpr int RMAX = 8;            // query rows per partial CTA
constexpr float NEG_INF = -1e10f;  // ops/positions.py NEG_INF
constexpr float INIT_M = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of the storage type per lane: 4 floats, 8 bf16 or 16 int8
template <typename S> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One lane's 16 bytes of a K or V row as float values of the compute type T.
// Pools in the compute type: a plain load (the scales are not read).
template <typename T>
__device__ __forceinline__ void load_kv(const T* p, const float* /*scales*/, size_t /*srow*/, float* out) {
  load16(p, out);
}
// int8 pools: f32(int8) * the row's f32 scale, rounded to T.
template <typename T>
__device__ __forceinline__ void load_kv(const int8_t* p, const float* scales, size_t srow, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  const float sc = scales[srow];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = to_f(from_f<T>(static_cast<float>(b[i]) * sc));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, s));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

// k_scale/v_scale [n_pages, page, KVH] f32 are read only when S is int8.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const T* __restrict__ q, const S* __restrict__ k_pool,
                     const S* __restrict__ v_pool, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ table,
                     const int* __restrict__ q_offset, const float* __restrict__ slopes,
                     float* __restrict__ part_o, float* __restrict__ part_ml, int Tq, int H,
                     int KVH, int page, int n_blocks, float scale, int causal, int alibi) {
  constexpr int VEC = Vec<S>::N;
  constexpr int LPK = D / VEC;   // lanes per key
  constexpr int KPI = 32 / LPK;  // keys per warp step
  __shared__ __align__(16) float Qs[RMAX][D];
  __shared__ float Sc[RMAX][SPLIT];
  __shared__ float Red[NWARPS][RMAX][D];
  __shared__ float Ms[RMAX], Ls[RMAX];

  const int split = blockIdx.x, b = blockIdx.z, n_splits = gridDim.x;
  const int G = H / KVH, R = G * Tq;
  const int n_rc = (R + RMAX - 1) / RMAX;
  const int kvh = blockIdx.y / n_rc, r0 = (blockIdx.y % n_rc) * RMAX;
  const int nr = min(RMAX, R - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPK, li = lane % LPK;
  const int off = q_offset[b];
  const int n_keys = min(off + Tq, n_blocks * page);  // keys past off + T are invalid
  const int k_begin = split * SPLIT;
  const int n_local = min(k_begin + SPLIT, n_keys) - k_begin;
  const int* tbl = table + (size_t)b * n_blocks;

  // partial rows are (b, split, t, h): row r of this CTA is window position
  // t = (r0 + r) / G of query head kvh * G + (r0 + r) % G
  auto prow = [&](int r) {
    const int rr = r0 + r;
    return (((size_t)b * n_splits + split) * Tq + rr / G) * H + kvh * G + rr % G;
  };

  if (n_local <= 0) {  // no key of this row falls in the split: empty partial
    for (int idx = tid; idx < nr * D; idx += THREADS) part_o[prow(idx / D) * D + idx % D] = 0.f;
    for (int r = tid; r < nr; r += THREADS) {
      part_ml[prow(r) * 2] = INIT_M;
      part_ml[prow(r) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < nr * D; idx += THREADS) {
    const int rr = r0 + idx / D, d = idx % D;
    Qs[idx / D][d] = to_f(q[((size_t)(b * Tq + rr / G) * H + kvh * G + rr % G) * D + d]);
  }
  __syncthreads();

  // pass 1: scores, biases in the gather path's order
  for (int base = warp * KPI; base < n_local; base += NWARPS * KPI) {
    const int kl = base + grp, pos = k_begin + kl;
    const bool valid = kl < n_local;
    float kf[VEC];
    if (valid) {
      const size_t row = ((size_t)tbl[pos / page] * page + pos % page) * KVH + kvh;
      load_kv<T>(k_pool + row * D + li * VEC, k_scale, row, kf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < nr) {  // uniform across the warp: the shuffles below stay converged
        const float4* qv = reinterpret_cast<const float4*>(&Qs[r][li * VEC]);
        float dot = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qq = qv[e4];
          dot = fmaf(qq.x, kf[4 * e4], dot);
          dot = fmaf(qq.y, kf[4 * e4 + 1], dot);
          dot = fmaf(qq.z, kf[4 * e4 + 2], dot);
          dot = fmaf(qq.w, kf[4 * e4 + 3], dot);
        }
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
        if (li == 0 && valid) {
          const int rr = r0 + r, t = rr / G;
          const int dist = off + t - pos;
          float x = dot * scale;
          if (alibi) {
            float bias = -slopes[kvh * G + rr % G] * (float)max(dist, 0);
            if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF);
            x = x + bias;
          } else if (causal) {
            x = x + (dist >= 0 ? 0.f : NEG_INF);
          }
          Sc[r][kl] = x;
        }
      }
    }
  }
  __syncthreads();

  // pass 2: the split's softmax statistics, one warp per row
  for (int r = warp; r < nr; r += NWARPS) {
    float mx = INIT_M;
    for (int kl = lane; kl < n_local; kl += 32) mx = fmaxf(mx, Sc[r][kl]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int kl = lane; kl < n_local; kl += 32) {
      const float p = expf(Sc[r][kl] - mx);
      Sc[r][kl] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      Ms[r] = mx;
      Ls[r] = sum;
    }
  }
  __syncthreads();

  // pass 3: P.V with the pass-1 key mapping
  float acc[RMAX][VEC];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  for (int base = warp * KPI; base < n_local; base += NWARPS * KPI) {
    const int kl = base + grp, pos = k_begin + kl;
    if (kl < n_local) {
      float vf[VEC];
      const size_t row = ((size_t)tbl[pos / page] * page + pos % page) * KVH + kvh;
      load_kv<T>(v_pool + row * D + li * VEC, v_scale, row, vf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < nr) {
          const float p = Sc[r][kl];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }
  // sum the warp's key groups (lanes with the same li), then the warps
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[r][e];
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) a += __shfl_xor_sync(FULL, a, o);
        if (grp == 0) Red[warp][r][li * VEC + e] = a;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += Red[w][r][d];
    part_o[prow(r) * D + d] = a;
  }
  for (int r = tid; r < nr; r += THREADS) {
    part_ml[prow(r) * 2] = Ms[r];
    part_ml[prow(r) * 2 + 1] = Ls[r];
  }
}

template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ part_o,
                                     const float* __restrict__ part_ml, T* __restrict__ o,
                                     int rows, int n_splits, int D) {
  const int row = blockIdx.x, b = blockIdx.y, d = threadIdx.x;  // row = t * H + h
  float M = INIT_M;
  for (int s = 0; s < n_splits; ++s)
    M = fmaxf(M, part_ml[(((size_t)b * n_splits + s) * rows + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t pr = ((size_t)b * n_splits + s) * rows + row;
    const float w = expf(part_ml[pr * 2] - M);
    num += w * part_o[pr * D + d];
    den += w * part_ml[pr * 2 + 1];
  }
  // den == 0 only when no key was visited: the TPU kernel's l == 0 -> 0
  o[((size_t)b * rows + row) * D + d] = from_f<T>(den == 0.f ? 0.f : num / den);
}

template <typename T, typename S, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* table, const void* q_offset, const void* slopes, void* o,
           void* part_o, void* part_ml, int B, int Tq, int H, int KVH, int page, int n_blocks,
           float scale, int causal, int alibi, cudaStream_t stream) {
  const int R = (H / KVH) * Tq;
  const int n_rc = (R + RMAX - 1) / RMAX;
  const int n_splits = (n_blocks * page + SPLIT - 1) / SPLIT;
  paged_partial_kernel<T, S, D><<<dim3(n_splits, KVH * n_rc, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(k_pool), static_cast<const S*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(q_offset),
      static_cast<const float*>(slopes), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), Tq, H, KVH, page, n_blocks, scale, causal, alibi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T><<<dim3(Tq * H, B), D, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml), static_cast<T*>(o),
      Tq * H, n_splits, D);
  return (int)cudaGetLastError();
}

// Storage of the pools: Same stores the compute type T, int8_t int8.
struct Same {};
template <typename T, typename S> struct Store { using type = S; };
template <typename T> struct Store<T, Same> { using type = T; };

// Launch with storage S (Same or int8_t) for the compute type and head
// width the codes name.
template <typename S>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* table, const void* q_offset, const void* slopes,
             void* o, void* part_o, void* part_ml, int dtype, int B, int Tq, int H, int KVH, int D,
             int page, int n_blocks, float scale, int causal, int alibi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, DD)                                                                      \
  return launch<T, typename Store<T, S>::type, DD>(q, k_pool, v_pool, k_scale, v_scale, table,   \
                                                   q_offset, slopes, o, part_o, part_ml, B, Tq,  \
                                                   H, KVH, page, n_blocks, scale, causal, alibi, \
                                                   st)
  if (dtype == 0 && D == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and the output): 0 = float32, 1 = bfloat16; the pools are of
// that dtype too. part_o [B, n_splits, T, H, D] and part_ml
// [B, n_splits, T, H, 2] are float32 scratch with n_splits =
// ceil(n_blocks * page / 256). Returns cudaGetLastError() after the launches.
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                               const void* table, const void* q_offset, const void* slopes,
                               void* o, void* part_o, void* part_ml, int dtype, int B, int Tq,
                               int H, int KVH, int D, int page, int n_blocks, float scale,
                               int causal, int alibi, void* stream) {
  return dispatch<Same>(q, k_pool, v_pool, nullptr, nullptr, table, q_offset, slopes, o, part_o,
                        part_ml, dtype, B, Tq, H, KVH, D, page, n_blocks, scale, causal, alibi,
                        stream);
}

// The same over int8 pools with float32 scale pools k_scale/v_scale
// [n_pages, page, KVH, 1]; q and the output are of dtype.
extern "C" int paged_attention_int8(const void* q, const void* k_pool, const void* v_pool,
                                    const void* k_scale, const void* v_scale, const void* table,
                                    const void* q_offset, const void* slopes, void* o,
                                    void* part_o, void* part_ml, int dtype, int B, int Tq, int H,
                                    int KVH, int D, int page, int n_blocks, float scale,
                                    int causal, int alibi, void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset, slopes, o, part_o,
                          part_ml, dtype, B, Tq, H, KVH, D, page, n_blocks, scale, causal, alibi,
                          stream);
}
