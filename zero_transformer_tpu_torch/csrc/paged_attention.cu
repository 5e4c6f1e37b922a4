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
// the CTAs of a thread-block cluster and merges their softmax statistics, and
// matches the gather path to a tolerance. Keys at or past q_offset + T are
// masked on the TPU (they add exp(-1e10) = 0), so the walk stops there.
//
// What bounds it on an H100: bytes. Decode does 4*D flops per key per query
// row against 4*D bytes of bf16 K/V, about one flop per byte; a call at the
// serving shapes (B = 4 rows, 12 kv heads, contexts up to 1024) moves about
// 6 MB, 2 us at full HBM rate. Reaching that rate takes ~2 MB of reads in
// flight across the card (3.35 TB/s x ~0.6 us of latency), so the design
// puts every byte a CTA needs in flight before it consumes the first:
//
// - One launch. The splits of one (batch row, kv head, block of NR of its
//   query rows) form one cluster of n_splits <= 8 CTAs (grid x, cluster x).
//   The split plan (keys per CTA a multiple of page, at least ceil(S / 8))
//   comes from the wrapper, ops/paged_attention.py::split_plan.
// - Each CTA reads its split's block-table entries in one read (each key's
//   pool row into shared memory), then issues cp.async 16-byte copies of
//   the K and V rows (and for int8 the 4-byte scales) of its live keys into
//   a ring of 32-key stages; each stage completes on its own mbarrier, so a
//   warp starts on a tile as soon as it lands, with no CTA barrier. At the
//   serving shapes the ring holds the whole split (128 keys): all of the
//   call's bytes are requested at once. A long split (1024 keys at S 8192)
//   streams through up to 8 stages of at most 64 KB in all.
// - One pass: each group of D / CV lanes owns one key of an 8-warp step and
//   keeps its own online softmax (m, l, acc) per query row, so a tile's K
//   and V are consumed together with no score pass in shared memory; lanes
//   hold CV elements (8 of bf16 or int8, 4 of f32). The rows are a template
//   (NR = 1, 2, 4 or 8 of the kv head's G * T), so their loops unroll and
//   interleave; every row's score comes first, then one warp vote on whether
//   any max moved, so the rescale is rare. Scores are in log2 units (exp2).
// - The merge: key groups merge by shuffles, warps through shared memory;
//   then every CTA writes its (m, l, o) into the leader's (split 0's) shared
//   memory (distributed shared memory), one cluster barrier, and the leader
//   merges the splits in split order, out = sum_s 2^(m_s - M) o_s /
//   sum_s 2^(m_s - M) l_s. Every CTA arrives on the cluster barrier at entry
//   and waits before its first remote write, so the leader has started.
//   Fixed orders everywhere and no atomics: reruns are bit-equal.
// A split with no live key joins the cluster barriers with l = 0 and
// m = -1e30. NaN-poisoned q rows come out NaN; an all-zero (trash) table
// reads page 0 without a fault; a row that visits no key writes 0.
//
// int8 pools (the TPU kernel's int8 branch, paged_attention.py:121-135):
// storage type S = int8 with f32 scale pools [n_pages, page, KVH, 1]; the
// scale of a key is k_scale[(pg * page + pos % page) * KVH + kvh], and a
// read dequantizes as the TPU kernel does: f32(int8) * scale, rounded to the
// compute type T before the q.k dot and the p.v sum. A trash page with
// scale 0 reads as zeros. Per key and kv head it moves 2 * D + 8 bytes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_SPLITS = 8;          // CTAs per cluster (ops/paged_attention.py MAX_SPLITS)
constexpr int TILE = 32;               // keys per ring stage
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 64 * 1024;  // the ring's ceiling per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF2 = -1e10f * LOG2E;  // ops/positions.py NEG_INF, in log2 units
constexpr float INIT_M = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of a K or V row a lane holds: 16 bytes of f32 or bf16, 8 of int8
template <typename S> struct Lane { static constexpr int CV = sizeof(S) == 4 ? 4 : 8; };

// One lane's CV elements of a K or V row in shared memory, as floats of the
// compute type T (int8: f32(int8) * sc, rounded to T).
template <typename T>
__device__ __forceinline__ void load_row(const float* p, float /*sc*/, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float /*sc*/, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void load_row(const int8_t* p, float sc, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(from_f<T>(static_cast<float>(b[i]) * sc));
}

// Bytes of one ring stage: TILE K rows, TILE V rows, and for int8 their
// TILE + TILE f32 scales.
template <typename S, int D>
struct Stage {
  static constexpr int BYTES = TILE * 2 * D * (int)sizeof(S) + (std::is_same<S, int8_t>::value ? TILE * 8 : 0);
};

// CTAs an SM must hold (the register budget): the serving shapes (one row a
// CTA, 384 CTAs at B 4 x 12 kv heads x 8 splits) fit the card in one wave at 4
template <int NR>
struct Resident { static constexpr int CTAS = NR == 1 ? 4 : NR == 2 ? 3 : 1; };

// grid (n_splits, KVH * row blocks of NR, B), clusters of (n_splits, 1, 1);
// dynamic shared memory: the leader's inbox of every split's (m, l, o), the
// pool row of each key of the split, then n_stages ring stages.
// k_scale/v_scale [n_pages, page, KVH] f32 are read only when S is int8.

template <typename T, typename S, int D, int NR>
__global__ void __launch_bounds__(THREADS, Resident<NR>::CTAS)
paged_decode_kernel(const T* __restrict__ q, const S* __restrict__ k_pool, const S* __restrict__ v_pool,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ q_offset,
                    const float* __restrict__ slopes, T* __restrict__ o, int Tq, int H, int KVH, int page,
                    int n_blocks, int per_split, int n_stages, float scale, int causal, int alibi) {
  constexpr bool INT8 = std::is_same<S, int8_t>::value;
  constexpr int CV = Lane<S>::CV;
  constexpr int LPK = D / CV;         // lanes per key
  constexpr int KPI = 32 / LPK;       // keys per warp step
  constexpr int KPS = NWARPS * KPI;   // keys per CTA step
  constexpr int ROW = D * (int)sizeof(S);
  constexpr int CH = ROW / 16;        // 16-byte chunks per K or V row
  constexpr int STAGE = Stage<S, D>::BYTES;
  static_assert(TILE % KPS == 0, "a tile is whole CTA steps");

  __shared__ __align__(16) float Qs[NR][D];  // lane-interleaved: see the q load
  __shared__ __align__(16) float Red[NWARPS][NR][D];
  __shared__ float Mw[NWARPS][NR], Lw[NWARPS][NR];
  __shared__ __align__(8) uint64_t full[MAX_STAGES];  // ring slot s holds its tile
  extern __shared__ __align__(16) unsigned char dyn[];

  cg::cluster_group cluster = cg::this_cluster();
  hopper::cluster_arrive_relaxed();  // this CTA has started: peers may write to it after the wait
  const int split = (int)cluster.block_rank(), n_splits = (int)cluster.num_blocks(), b = blockIdx.z;
  // the leader's (split 0's) inbox: m and l [n_splits][NR], o [n_splits][NR][D]
  float* in_m = reinterpret_cast<float*>(dyn);
  float* in_l = in_m + n_splits * NR;
  float* in_o = in_l + n_splits * NR;
  int* rows = reinterpret_cast<int*>(in_o + n_splits * NR * D);  // pool row of each key
  unsigned char* ring = dyn + ((((2 + D) * n_splits * NR + per_split) * 4 + 15) & ~15);
  const int G = H / KVH, R = G * Tq;
  const int n_rc = (R + NR - 1) / NR;
  const int kvh = blockIdx.y / n_rc, r0 = (blockIdx.y % n_rc) * NR;
  const int nr = min(NR, R - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPK, li = lane % LPK;
  const int k_begin = split * per_split;

  // the split's table entries in one read, beside the offset that cuts the
  // split: each key's pool row, (page * page size + slot) * KVH + kv head
  const int* tbl = table + (size_t)b * n_blocks + k_begin / page;
  for (int kl = tid; kl < min(per_split, n_blocks * page - k_begin); kl += THREADS)
    rows[kl] = (tbl[kl / page] * page + kl % page) * KVH + kvh;
  const int off = q_offset[b];
  const int n_keys = min(off + Tq, n_blocks * page);  // keys past off + T are invalid
  const int n_local = max(0, min(k_begin + per_split, n_keys) - k_begin);
  const int n_tiles = (n_local + TILE - 1) / TILE;
  // q rows: element d = li * CV + 4 j + t of a row sits at (j * LPK + li) * 4 + t,
  // so each lane's float4 reads of q are contiguous across the group; rows
  // past nr are zero and never written out
  for (int idx = tid; idx < NR * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, rr = r0 + r;
    const int at = ((d % CV) / 4 * LPK + d / CV) * 4 + d % 4;
    Qs[r][at] = r < nr ? to_f(q[((size_t)(b * Tq + rr / G) * H + kvh * G + rr % G) * D + d]) : 0.f;
  }
  // scores in log2 units (exp2 is one instruction): scale, slopes and the
  // mask value carry log2(e)
  const float scale2 = scale * LOG2E;
  float slope2[NR];
  int trow[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    slope2[r] = alibi && r < nr ? slopes[kvh * G + (r0 + r) % G] * LOG2E : 0.f;
    trow[r] = (r0 + r) / G;
  }
  if (tid == 0) {
    for (int st = 0; st < n_stages; ++st) hopper::mbar_init(&full[st], THREADS);
  }
  __syncthreads();

  // copies of tile `tile` into ring slot `slot`: K rows, V rows, scales
  auto issue = [&](int tile, int slot) {
    unsigned char* st = ring + slot * STAGE;
    const int kt0 = tile * TILE, nk = min(TILE, n_local - kt0);
    for (int i = tid; i < 2 * TILE * CH; i += THREADS) {
      const int kv = i / (TILE * CH), kt = i % (TILE * CH) / CH, c = i % CH;
      // keys past the split's last are zero-filled (nothing is read)
      const S* src = (kv ? v_pool : k_pool) + (kt < nk ? (size_t)rows[kt0 + kt] * D : 0);
      hopper::copy16(st + (kv * TILE + kt) * ROW + c * 16, reinterpret_cast<const unsigned char*>(src) + c * 16,
                     kt < nk);
    }
    if constexpr (INT8) {
      for (int i = tid; i < 2 * TILE; i += THREADS) {
        const int kv = i / TILE, kt = i % TILE;
        hopper::copy4(st + 2 * TILE * ROW + i * 4, (kv ? v_scale : k_scale) + (kt < nk ? rows[kt0 + kt] : 0), kt < nk);
      }
    }
    hopper::copies_arrive(&full[slot]);  // every thread, copies or not
  };

  // every stage's copies are requested before the first is consumed
  for (int s = 0; s < min(n_stages, n_tiles); ++s) issue(s, s);

  float m[NR], l[NR], acc[NR][CV];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = INIT_M;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CV; ++e) acc[r][e] = 0.f;
  }
  // up to 4 rows keep this lane's q slice in registers, 8 read it from Qs
  constexpr bool QREG = NR <= 4;
  float qreg[QREG ? NR : 1][CV];
  if constexpr (QREG) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < CV / 4; ++c)
#pragma unroll
        for (int t = 0; t < 4; ++t) qreg[r][4 * c + t] = Qs[r][(c * LPK + li) * 4 + t];
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % n_stages;
    hopper::mbar_wait(&full[slot], (j / n_stages) & 1);  // each warp on its own: no CTA barrier
    const unsigned char* st = ring + slot * STAGE;
    const S* kt_rows = reinterpret_cast<const S*>(st);
    const S* vt_rows = reinterpret_cast<const S*>(st + TILE * ROW);
    const float* scales = reinterpret_cast<const float*>(st + 2 * TILE * ROW);
    const int kt_end = min(TILE, n_local - j * TILE);
    for (int kt0 = 0; kt0 < kt_end; kt0 += KPS) {
      const int kt = kt0 + warp * KPI + grp;
      const bool valid = kt < kt_end;  // rows past it are zeros
      float kf[CV], vf[CV];
      load_row<T>(kt_rows + kt * D + li * CV, INT8 ? scales[kt] : 1.f, kf);
      load_row<T>(vt_rows + kt * D + li * CV, INT8 ? scales[TILE + kt] : 1.f, vf);
      const int pos = k_begin + j * TILE + kt;
      // every row's score first, then one vote on whether any max moves
      float x[NR];
      bool up = false;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float qv[CV];
#pragma unroll
        for (int c = 0; c < CV / 4; ++c) {
          float4 qq;
          if constexpr (QREG) {
            qq = make_float4(qreg[r][4 * c], qreg[r][4 * c + 1], qreg[r][4 * c + 2], qreg[r][4 * c + 3]);
          } else {
            qq = *reinterpret_cast<const float4*>(&Qs[r][(c * LPK + li) * 4]);
          }
          qv[4 * c] = qq.x; qv[4 * c + 1] = qq.y; qv[4 * c + 2] = qq.z; qv[4 * c + 3] = qq.w;
        }
        float d0 = 0.f, d1 = 0.f;  // two chains
#pragma unroll
        for (int e = 0; e < CV; e += 2) {
          d0 = fmaf(qv[e], kf[e], d0);
          d1 = fmaf(qv[e + 1], kf[e + 1], d1);
        }
        float dot = d0 + d1;
#pragma unroll
        for (int s = LPK / 2; s > 0; s >>= 1) dot += __shfl_xor_sync(FULL, dot, s);
        // biases in the gather path's order
        const int dist = off + trow[r] - pos;
        float xr = dot * scale2;
        if (alibi) {
          float bias = -slope2[r] * (float)max(dist, 0);
          if (causal) bias = bias + (dist >= 0 ? 0.f : NEG_INF2);
          xr = xr + bias;
        } else if (causal) {
          xr = xr + (dist >= 0 ? 0.f : NEG_INF2);
        }
        x[r] = xr;
        up |= valid && xr > m[r];  // a NaN score never raises m: it poisons l and acc below
      }
      if (__any_sync(FULL, up)) {  // rare once a group has seen a few keys
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float mn = valid ? fmaxf(m[r], x[r]) : m[r];
          const float a = exp2f(m[r] - mn);
          l[r] *= a;
#pragma unroll
          for (int e = 0; e < CV; ++e) acc[r][e] *= a;
          m[r] = mn;
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float p = valid ? exp2f(x[r] - m[r]) : 0.f;
        l[r] += p;
#pragma unroll
        for (int e = 0; e < CV; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
    if (j + n_stages < n_tiles) {
      __syncthreads();  // every warp is done with the slot
      issue(j + n_stages, slot);
    }
  }

  // merge the warp's key groups (lanes with the same li), then the warps
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int s = LPK; s < 32; s <<= 1) {
      const float mo = __shfl_xor_sync(FULL, m[r], s), lo = __shfl_xor_sync(FULL, l[r], s);
      const float mn = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mn), w = exp2f(mo - mn);
      l[r] = l[r] * a + lo * w;
#pragma unroll
      for (int e = 0; e < CV; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[r][e], s);
        acc[r][e] = acc[r][e] * a + ao * w;
      }
      m[r] = mn;
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < CV; ++e) Red[warp][r][li * CV + e] = acc[r][e];
    }
    if (lane == 0) {
      Mw[warp][r] = m[r];
      Lw[warp][r] = l[r];
    }
  }
  __syncthreads();
  // the CTA's (m, l, o) into the leader's inbox, once every CTA has started
  hopper::cluster_wait();
  float* lead_m = cluster.map_shared_rank(in_m, 0);
  float* lead_l = cluster.map_shared_rank(in_l, 0);
  float* lead_o = cluster.map_shared_rank(in_o, 0);
  for (int idx = tid; idx < nr * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = INIT_M;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, Mw[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float wt = exp2f(Mw[w][r] - mx);
      num += wt * Red[w][r][d];
      den += wt * Lw[w][r];
    }
    lead_o[(split * NR + r) * D + d] = num;
    if (d == 0) {
      lead_m[split * NR + r] = mx;
      lead_l[split * NR + r] = den;
    }
  }
  hopper::cluster_arrive();  // release: the inbox writes land before the barrier
  hopper::cluster_wait();
  if (split != 0) return;
  // the leader merges the splits in split order
  for (int idx = tid; idx < nr * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = INIT_M;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, in_m[s * NR + r]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float wt = exp2f(in_m[s * NR + r] - mx);
      num += wt * in_o[(s * NR + r) * D + d];
      den += wt * in_l[s * NR + r];
    }
    const int rr = r0 + r;
    // den == 0 only when no key was visited: the TPU kernel's l == 0 -> 0
    o[((size_t)(b * Tq + rr / G) * H + kvh * G + rr % G) * D + d] = from_f<T>(den == 0.f ? 0.f : num / den);
  }
}

template <typename T, typename S, int D, int NR>
int launch_rows(const void* q, const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
                const void* table, const void* q_offset, const void* slopes, void* o, int B, int Tq, int H,
                int KVH, int page, int n_blocks, int per_split, int n_splits, float scale, int causal, int alibi,
                cudaStream_t stream) {
  constexpr int STAGE = Stage<S, D>::BYTES;
  const int n_tiles = (per_split + TILE - 1) / TILE;
  const int n_stages = std::min(n_tiles, std::min(MAX_STAGES, RING_BYTES / STAGE));
  const size_t smem = (size_t)((((2 + D) * n_splits * NR + per_split) * 4 + 15) & ~15) + (size_t)n_stages * STAGE;
  auto kernel = paged_decode_kernel<T, S, D, NR>;
  static size_t smem_set = 0;  // per instantiation: above 48 KB less the static part needs the opt-in
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int R = (H / KVH) * Tq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, KVH * ((R + NR - 1) / NR), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const S*>(k_pool), static_cast<const S*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(q_offset), static_cast<const float*>(slopes), static_cast<T*>(o), Tq, H, KVH,
      page, n_blocks, per_split, n_stages, scale, causal, alibi);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// rows a CTA carries: the kv head's G * T rows, rounded up to 1, 2, 4 or 8
template <typename T, typename S, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
           const void* table, const void* q_offset, const void* slopes, void* o, int B, int Tq, int H,
           int KVH, int page, int n_blocks, int per_split, int n_splits, float scale, int causal, int alibi,
           cudaStream_t stream) {
  if (n_splits < 1 || n_splits > MAX_SPLITS || per_split < page || per_split % page ||
      (n_splits - 1) * per_split >= n_blocks * page || n_splits * per_split < n_blocks * page)
    return (int)cudaErrorInvalidValue;
  const int R = (H / KVH) * Tq;
#define ROWS_LAUNCH(NR)                                                                                     \
  return launch_rows<T, S, D, NR>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset, slopes, o, B, Tq, H, \
                                  KVH, page, n_blocks, per_split, n_splits, scale, causal, alibi, stream)
  if (R == 1) ROWS_LAUNCH(1);
  if (R == 2) ROWS_LAUNCH(2);
  if (R <= 4) ROWS_LAUNCH(4);
  ROWS_LAUNCH(8);
#undef ROWS_LAUNCH
}

// Storage of the pools: Same stores the compute type T, int8_t int8.
struct Same {};
template <typename T, typename S> struct Store { using type = S; };
template <typename T> struct Store<T, Same> { using type = T; };

// Launch with storage S (Same or int8_t) for the compute type and head
// width the codes name.
template <typename S>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale, const void* v_scale,
             const void* table, const void* q_offset, const void* slopes, void* o, int dtype, int B, int Tq,
             int H, int KVH, int D, int page, int n_blocks, int per_split, int n_splits, float scale,
             int causal, int alibi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tq < 1 || KVH < 1 || H % KVH) return (int)cudaErrorInvalidValue;
#define PAGED_LAUNCH(T, DD)                                                                            \
  return launch<T, typename Store<T, S>::type, DD>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset, \
                                                   slopes, o, B, Tq, H, KVH, page, n_blocks, per_split,  \
                                                   n_splits, scale, causal, alibi, st)
  if (dtype == 0 && D == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and the output): 0 = float32, 1 = bfloat16; the pools are of
// that dtype too. The split plan: per_split keys per CTA (a multiple of
// page) over n_splits <= 8 CTAs that cover n_blocks * page keys. Returns
// the launch's error, else cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* k_pool, const void* v_pool, const void* table,
                               const void* q_offset, const void* slopes, void* o, int dtype, int B, int Tq,
                               int H, int KVH, int D, int page, int n_blocks, int per_split, int n_splits,
                               float scale, int causal, int alibi, void* stream) {
  return dispatch<Same>(q, k_pool, v_pool, nullptr, nullptr, table, q_offset, slopes, o, dtype, B, Tq, H, KVH,
                        D, page, n_blocks, per_split, n_splits, scale, causal, alibi, stream);
}

// The same over int8 pools with float32 scale pools k_scale/v_scale
// [n_pages, page, KVH, 1]; q and the output are of dtype.
extern "C" int paged_attention_int8(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* table, const void* q_offset,
                                    const void* slopes, void* o, int dtype, int B, int Tq, int H, int KVH, int D,
                                    int page, int n_blocks, int per_split, int n_splits, float scale,
                                    int causal, int alibi, void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, q_offset, slopes, o, dtype, B, Tq, H,
                          KVH, D, page, n_blocks, per_split, n_splits, scale, causal, alibi, stream);
}
