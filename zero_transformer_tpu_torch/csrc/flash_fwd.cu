// Flash attention forward for the serving shapes (chunked prefill windows).
//
// Replaces the TPU kernel zero_transformer_tpu/ops/pallas/flash.py::_fwd_kernel
// as reached through flash_serving (flash.py:504 -> _fwd :292). It computes
// the same function: s = scale * q.k^T in f32, plus the ALiBi bias
// -slope * max(q_pos - k_pos, 0) and the causal NEG_INF mask added as one
// bias, plus the [B, S] kv-validity mask (0 = masked); an online softmax over
// key tiles with m starting at -1e30; a row with l == 0 outputs 0; lse =
// m + log(l). GQA reads kv head h / (H / KVH). Every row b has its own query
// position offset q_offset[b].
//
// What bounds it on an H100: at the serving shapes (T = 64 queries against
// up to S = 1024 cached keys, D = 64) each (row, head) reads its K/V once and
// does 4*T*D flops per key, about 64 flops per byte of bf16 K/V, well below
// the card's ~295 flop/byte ridge: reading K/V bounds it, and so does the
// causal limit, which decides how many keys a window needs at all. A call at
// the serving shapes (B = 4, H = 12) must move about 6.7 MB, 2 us at full
// HBM rate; this kernel reaches a small share of that rate, because with
// one CTA per (tile, head, row) and a load-then-compute loop per tile few
// loads are in flight at once: occupancy and memory-level parallelism, not
// the payload, are what it lacks (cp.async double buffering is the next
// step).
//
// Design: one CTA per (q tile of 64 rows, head, batch row); it stages 64-key
// K/V tiles in shared memory and stops the key loop at the causal limit
// q_offset + tile_end, so dead tiles cost nothing; m and l stay in f32
// registers.
// - bf16 (the serving path): 4 warps of 16 query rows each run
//   mma.sync.m16n8k16 on the tensor cores for S = Q.K^T and O += P.V, in the
//   FlashAttention-2 register layout (the S accumulator becomes the P
//   operand without touching shared memory; P is rounded to bf16 for the
//   product, as the reference path rounds its softmax weights). Q, K and
//   the transposed V sit in shared memory with padded rows, so fragment
//   loads are bank-conflict free.
// - float32 (tests, parity runs): plain FMA, four threads per query row,
//   each owning D/4 interleaved dims, K/V tiles staged as f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 256
constexpr float NEG_INF = -1e10f;    // ops/positions.py NEG_INF
constexpr float INIT_M = -1e30f;     // flash.py _INIT_M

// ---------------------------------------------------------------- f32 FMA

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ slopes,
                     const int* __restrict__ q_offset, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ lse, int Tq, int S, int H,
                     int KVH, float scale, int causal, int alibi) {
  constexpr int DP = D / TPR;  // dims per thread
  extern __shared__ float smem[];
  float* Ks = smem;                                   // [BK][D]
  float* Vs = Ks + BK * D;                            // [BK][D]
  int* Sg = reinterpret_cast<int*>(Vs + BK * D);      // [BK]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int qi = qt * BQ + row;
  const bool row_ok = qi < Tq;
  const int off = q_offset[b];
  const int q_pos = off + qi;
  const float slope = alibi ? slopes[h] : 0.f;

  float qr[DP];
  const float* qp = q + ((size_t)(b * Tq + (row_ok ? qi : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) qr[i] = row_ok ? qp[part + TPR * i] : 0.f;

  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  float m = INIT_M, l = 0.f;

  // key tiles to visit: all of them, or up to the causal limit of the tile's
  // last query row (the TPU kernel's _run_predicate, per tile)
  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = off + min(qt * BQ + BQ, Tq) - 1;
    n_tiles = last_q < 0 ? 0 : min(n_tiles, last_q / BK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int key = idx / D, d = idx % D, kp = k0 + key;
      float kk = 0.f, vv = 0.f;
      if (kp < S) {
        const size_t a = ((size_t)(b * S + kp) * KVH + kvh) * D + d;
        kk = k[a];
        vv = v[a];
      }
      Ks[idx] = kk;
      Vs[idx] = vv;
    }
    if (tid < BK) {
      const int kp = k0 + tid;
      Sg[tid] = seg == nullptr ? 1 : (kp < S ? seg[(size_t)b * S + kp] : 0);
    }
    __syncthreads();

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int key = 0; key < BK; ++key) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], Ks[key * D + part + TPR * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + key;
      const int dist = q_pos - kp;
      // flash.py _scores order: s * scale + (alibi + causal), then + validity
      float bias = 0.f;
      if (alibi) bias = bias - slope * (float)max(dist, 0);
      if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF);
      float x = dot * scale + bias;
      if (seg != nullptr) x = x + (Sg[key] != 0 ? 0.f : NEG_INF);
      if (kp >= S) x = -INFINITY;  // tile overhang past the cache: no key
      s[key] = x;
      tmax = fmaxf(tmax, x);
    }

    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int key = 0; key < BK; ++key) {
      s[key] = expf(s[key] - m_new);
      psum += s[key];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int key = 0; key < BK; ++key) a = fmaf(s[key], Vs[key * D + part + TPR * i], a);
      acc[i] = a;
    }
  }

  if (row_ok) {
    const float l_safe = l == 0.f ? 1.f : l;
    float* op = o + ((size_t)(b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[part + TPR * i] = acc[i] / l_safe;
    if (lse != nullptr && part == 0) lse[((size_t)b * H + h) * Tq + qi] = m + logf(l_safe);
  }
}

// ---------------------------------------------------------------- bf16 mma

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = BQ

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ slopes,
                     const int* __restrict__ q_offset, const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Tq, int S, int H,
                     int KVH, float scale, int causal, int alibi) {
  using bf16 = __nv_bfloat16;
  constexpr int LDK = D + 8;   // padded row of Qs and Ks (bf16 elements)
  constexpr int LDV = BK + 8;  // padded row of the transposed V tile
  constexpr int NB = BK / 8;   // key blocks of 8 per tile (S columns)
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int ND = D / 8;    // output dim blocks of 8
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [BQ][LDK]
  bf16* Ks = Qs + BQ * LDK;                          // [BK][LDK]
  bf16* Vt = Ks + BK * LDK;                          // [D][LDV]
  int* Sg = reinterpret_cast<int*>(Vt + D * LDV);    // [BK]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int rw = warp * 16;                // the warp's first query row in the tile
  const int off = q_offset[b];
  const float slope = alibi ? slopes[h] : 0.f;

  for (int idx = tid; idx < BQ * VPR; idx += MMA_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8, qi = qt * BQ + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < Tq) val = *reinterpret_cast<const uint4*>(q + ((size_t)(b * Tq + qi) * H + h) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * LDK + c) = val;
  }
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* base = Qs + (rw + g) * LDK + kk * 16 + t4 * 2;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * LDK);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * LDK + 8);
  }

  float oacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nd][e] = 0.f;
  float m[2] = {INIT_M, INIT_M}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int q_pos0 = off + qt * BQ + rw + g;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = off + min(qt * BQ + BQ, Tq) - 1;
    n_tiles = last_q < 0 ? 0 : min(n_tiles, last_q / BK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * VPR; idx += MMA_THREADS) {
      const int key = idx / VPR, c = (idx % VPR) * 8, kp = k0 + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kp < S) {
        const size_t a = ((size_t)(b * S + kp) * KVH + kvh) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + a);
        vv = *reinterpret_cast<const uint4*>(v + a);
      }
      *reinterpret_cast<uint4*>(Ks + key * LDK + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + key] = ve[i];
    }
    if (tid < BK) {
      const int kp = k0 + tid;
      Sg[tid] = seg == nullptr ? 1 : (kp < S ? seg[(size_t)b * S + kp] : 0);
    }
    __syncthreads();

    // S = Q.K^T on the tensor cores
    float sacc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* kb = Ks + (nb * 8 + g) * LDK + kk * 16 + t4 * 2;
        mma_bf16(sacc[nb], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }
    // flash.py _scores order: s * scale + (alibi + causal), then + validity
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + t4 * 2 + (e & 1), kp = k0 + col;
        const int dist = q_pos0 + (e >> 1) * 8 - kp;
        float bias = 0.f;
        if (alibi) bias = bias - slope * (float)max(dist, 0);
        if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF);
        float x = sacc[nb][e] * scale + bias;
        if (seg != nullptr) x = x + (Sg[col] != 0 ? 0.f : NEG_INF);
        if (kp >= S) x = -INFINITY;  // tile overhang past the cache: no key
        sacc[nb][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share a row
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[nb][e] - m[e >> 1]);
        sacc[nb][e] = p;
        psum[e >> 1] += p;
      }
    // l stays a per-lane partial (alpha is common to the quad); summed at the end
    l[0] = alpha[0] * l[0] + psum[0];
    l[1] = alpha[1] * l[1] + psum[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nd][e] *= alpha[e >> 1];

    // O += P.V: two S column blocks form one 16-key A operand
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kb][0], sacc[2 * kb][1]), pack_bf16(sacc[2 * kb][2], sacc[2 * kb][3]),
          pack_bf16(sacc[2 * kb + 1][0], sacc[2 * kb + 1][1]),
          pack_bf16(sacc[2 * kb + 1][2], sacc[2 * kb + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* vb = Vt + (nd * 8 + g) * LDV + kb * 16 + t4 * 2;
        mma_bf16(oacc[nd], pa, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = qt * BQ + rw + g + r * 8;
    if (qi < Tq) {
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      bf16* op = o + ((size_t)(b * Tq + qi) * H + h) * D + t4 * 2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<uint32_t*>(op + nd * 8) =
            pack_bf16(oacc[nd][2 * r] / l_safe, oacc[nd][2 * r + 1] / l_safe);
      if (lse != nullptr && t4 == 0) lse[((size_t)b * H + h) * Tq + qi] = m[r] + logf(l_safe);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* slopes,
               const void* q_offset, const void* seg, void* o, void* lse, int B, int Tq, int S,
               int H, int KVH, float scale, int causal, int alibi, cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(float) + BK * sizeof(int);
  cudaFuncSetAttribute(flash_fwd_fma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(slopes), static_cast<const int*>(q_offset),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(lse), Tq, S, H,
      KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* slopes,
                const void* q_offset, const void* seg, void* o, void* lse, int B, int Tq, int S,
                int H, int KVH, float scale, int causal, int alibi, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * ((BQ + BK) * (D + 8) + D * (BK + 8)) + BK * sizeof(int);
  cudaFuncSetAttribute(flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(slopes),
      static_cast<const int*>(q_offset), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Tq, S, H, KVH, scale, causal,
      alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel). q, k,
// v rows must be 16-byte aligned (contiguous tensors). seg and lse may be
// null. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* slopes,
                         const void* q_offset, const void* seg, void* o, void* lse, int dtype,
                         int B, int Tq, int S, int H, int KVH, int D, float scale, int causal,
                         int alibi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, slopes, q_offset, seg, o, lse, B, Tq, S, H, KVH, scale,
                          causal, alibi, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, slopes, q_offset, seg, o, lse, B, Tq, S, H, KVH, scale,
                           causal, alibi, st);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, slopes, q_offset, seg, o, lse, B, Tq, S, H, KVH, scale,
                           causal, alibi, st);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, slopes, q_offset, seg, o, lse, B, Tq, S, H, KVH, scale,
                            causal, alibi, st);
  return (int)cudaErrorInvalidValue;
}
