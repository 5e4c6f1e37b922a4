// Flash attention forward (K1): the serving shapes (chunked prefill windows)
// and the training forward, which also writes the lse its backward needs.
//
// Replaces the TPU kernel zero_transformer_tpu/ops/pallas/flash.py::_fwd_kernel
// as reached through flash_serving (flash.py:504 -> _fwd :292) and through
// the custom VJP of flash_attention (:462 -> _flash_fwd :431). It computes
// the same function: s = scale * q.k^T in f32, plus the ALiBi bias
// -slope * max(q_pos - k_pos, 0) and the causal NEG_INF mask added as one
// bias, plus the packed-document mask (int32 query ids [B, T] against key
// ids [B, S]: keys of another document masked), plus the [B, S] kv-validity
// mask (0 = masked); an online softmax over key tiles with m starting at -1e30; a row
// with l == 0 outputs 0; lse = m + log(l). GQA reads kv head h / (H / KVH).
// Every row b has its own query and key position offsets (offs [2, B]).
//
// flash_partial (flash.py:551) reaches the same kernel body for sequence
// parallelism: the query shard at global q_off against a key shard at
// kv_off, separate query and key document ids (q_ids [B, T], k_ids [B, S]:
// the key ids ride the ring with their shard), the caller's slope table,
// and an f32 output from bf16 inputs (the ring merges the partial outputs
// in f32 and rounds once). The causal tile limit is _run_predicate (:118)
// at those offsets, in both the wgmma and the FMA path. A row that sees no
// key of the shard (causal, q_pos < kv_off: a future shard) writes o = 0
// and lse = -1e30, as _write (:169-174) does for a row whose every tile was
// skipped; the row-level test makes that independent of the tile size (the
// TPU kernel's 512-row blocks, this kernel's 64). The ring's merge weighs
// such a shard exp(-1e30 - m) = 0.
//
// What bounds it on an H100, shape by shape (bytes: q, k, v read once, o
// and lse written once, at 3.35 TB/s; products: 4 * D flops per visible
// (query, key) pair at the bf16 tensor-core peak, 989 TFLOP/s):
// - serving prefill chunk (125m: B 4, T 64 against up to S 1024 cached keys,
//   12 heads of 64): ~6.7 MB, 2 us; its 48 CTAs (one q tile a row and head)
//   cannot fill 132 SMs, so each CTA's chain of up to 16 key tiles, the
//   latency of each tile's load, product and softmax, decides it;
// - 125m training (B 8, T = S 1024, 12 x 64, causal): 50.7 MB (15 us) and
//   12.9 GFLOP (13 us); byte_25m packed (B 32, T = S 512, 8 x 64): 20 us of
//   bytes: bytes and products about equal at D 64;
// - 580m at D 128, one card (B 1, T = S 8192, 12 heads, causal): 206 GFLOP,
//   0.21 ms, against 100 MB (0.03 ms); the ring's past shard (B 1, 2048
//   queries against 2048 earlier keys, bf16 in, f32 out): 25.8 GFLOP
//   (26 us) against 31.5 MB (9.4 us): the tensor cores bound it.
// Between the two products of each key tile sit the bias, the masks and
// the exp of 64 x 64 scores: ~16 instructions a score on the CUDA cores,
// about as many issue cycles as the tile's products take on the tensor
// cores at D 128, and twice as many at D 64. And every 64-row CTA reads
// each K/V tile it visits from L2: 3.25 GB a call at the one-card
// 580m shape (99,072 tile visits of 32 KB), 0.40 GB on the ring's past
// shard, ~2-3 TB/s at this kernel's times: by that arithmetic the L2
// reads, not HBM or the tensor cores, are the nearest limit (not measured
// apart; PERF.md: a CTA of two warpgroups, 128 rows a visit, halved them
// and was faster at the one-card shape only).
//
// Design: one CTA per (q tile, head, batch row); it streams 64-key K/V
// tiles through shared memory up to the causal limit
// q_off + tile_end - kv_off, so dead tiles cost nothing; m and l stay in f32
// registers. The score bias is flash_common.cuh's, shared with the backward
// kernels (flash_bwd.cu) so both see the same probabilities. With document
// ids, each thread keeps its rows' ids in registers and each key tile's ids
// sit in shared memory beside the validity mask; key tiles that hold no key
// of a row's document are still visited (the ids may be arbitrary: skipping
// them is sound only for monotone ids).
// - bf16 (every serving, training and ring call; D 64 and 128): Hopper's
//   warpgroup products (wgmma), the section below, in FlashAttention-3's
//   structure without its producer warp: s = q.k^T with both operands in
//   shared memory, p rounded to bf16 from the s registers as the A operand
//   of o += p.v, whose V tile is read through the descriptor's transpose
//   bit (no transposed copy). K/V tiles stream through a cp.async ring that
//   loads ahead of the products; the causal CTAs with the most key tiles
//   launch first.
// - float32 (tests, parity runs): plain FMA, four threads per query row,
//   each owning D/4 interleaved dims, K/V tiles staged as f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row (FMA)
constexpr int THREADS = BQ * TPR;    // 256
constexpr float INIT_M = -1e30f;     // flash.py _INIT_M

// ---------------------------------------------------------------- f32 FMA

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ slopes,
                     const int* __restrict__ offs, const int* __restrict__ seg,
                     const int* __restrict__ qids, const int* __restrict__ kids,
                     float* __restrict__ o, float* __restrict__ lse, int Tq, int S, int H, int KVH,
                     float scale, int causal, int alibi) {
  constexpr int DP = D / TPR;  // dims per thread
  extern __shared__ float smem[];
  float* Ks = smem;                                   // [BK][D]
  float* Vs = Ks + BK * D;                            // [BK][D]
  int* Sg = reinterpret_cast<int*>(Vs + BK * D);      // [BK]
  int* Dk = Sg + BK;                                  // [BK] key document ids

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int qi = qt * BQ + row;
  const bool row_ok = qi < Tq;
  const int off = offs[b], kv_off = offs[gridDim.z + b];
  const int q_pos = off + qi;
  const float slope = alibi ? slopes[h] : 0.f;
  const bool has_docs = qids != nullptr;
  const int q_doc = has_docs && row_ok ? qids[(size_t)b * Tq + qi] : 0;

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
  if (causal) n_tiles = flash::causal_key_tiles(n_tiles, off + min(qt * BQ + BQ, Tq) - 1, kv_off, BK);

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
      Dk[tid] = has_docs && kp < S ? kids[(size_t)b * S + kp] : 0;
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
      // flash.py _scores order: s * scale + (alibi + causal), + documents,
      // then + validity
      float x = flash::biased_score(dot, scale, q_pos - (kv_off + kp), slope, causal, alibi,
                                    has_docs, q_doc, Dk[key]);
      if (seg != nullptr) x = x + (Sg[key] != 0 ? 0.f : flash::NEG_INF);
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
    const bool dead = causal && q_pos < kv_off;  // no key of the shard is visible
    const float l_safe = l == 0.f ? 1.f : l;
    float* op = o + ((size_t)(b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[part + TPR * i] = dead ? 0.f : acc[i] / l_safe;
    if (lse != nullptr && part == 0)
      lse[((size_t)b * H + h) * Tq + qi] = dead ? INIT_M : m + logf(l_safe);
  }
}

// ------------------------------------------- bf16: wgmma (Hopper, sm_90a)

// Every bf16 call runs one template. A CTA is one warpgroup (128 threads)
// and owns 64 query rows; its Q tile is copied once into hopper.cuh's
// 128-byte-swizzled layout (rows at or past T are zero). Per 64-key tile j:
// - s = q . k^T: D / 16 m64n64k16 products, both operands K-major in shared
//   memory; the scores land in the accumulator layout hopper.cuh documents
//   (a row's 16 scores in the four lanes of a quad);
// - the bias, the masks and the online softmax on those registers (the row
//   max over the quad with two shuffles), o rescaled by alpha;
// - o += p . v: p rounded to bf16 in registers (to_a) as A, the V tile read
//   MN-major (the descriptor's transpose bit), D / 64 blocks of 64 columns
//   per k-step of 16 keys.
// FlashAttention-3's intra-warpgroup overlap: the products of tile j + 1's
// s and of tile j's p . v are issued together, and the softmax of tile j + 1
// runs while p . v is still in flight (o is rescaled once it lands). K and V
// stream through two rings of two cp.async slots each, whose loads are
// issued where their slots fall free: K of tile j + 2 once s of tile j has
// landed, V of tile j + 1 once p . v of tile j - 1 has, so every copy has a
// whole tile's work to land in. A key tile's validity and ids ride with its
// K tile. The products are issued and waited without branches (ptxas
// serializes a wgmma pipeline split by one, warning C7514): the s product
// after the last tile (and the prologue's, when there is no tile) is
// issued on a stale slot and never read.
// Two CTAs share an SM at D 128 (82 KB of shared memory each), three at
// D 64, so one CTA's bias and exp work also overlaps another's products.
// The q tile is the grid's slowest axis, the last tiles (most key tiles
// under the causal limit) first. Each output row is written once by one
// CTA, no atomics.
namespace wg {

constexpr int THREADS = 128;  // one warpgroup a CTA

// bytes of dynamic shared memory: 1 KB to align the tiles, the Q tile, two
// K and two V slots, two slots of BK validity flags and of key ids
template <int D>
constexpr int SMEM = 1024 + (BQ * D + 4 * BK * D) * 2 + 4 * BK * 4;

// CTAs an SM, to bound the registers
template <int D>
constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;

}  // namespace wg

using bf16 = __nv_bfloat16;

// two neighbouring outputs, rounded to bf16 or kept in f32 (flash_partial)
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

template <typename OutT, int D>
__global__ void __launch_bounds__(wg::THREADS, wg::MIN_BLOCKS<D>)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ slopes,
                       const int* __restrict__ offs, const int* __restrict__ seg,
                       const int* __restrict__ qids, const int* __restrict__ kids,
                       OutT* __restrict__ o, float* __restrict__ lse, int Tq, int S, int H, int KVH,
                       float scale, int causal, int alibi) {
  constexpr int THREADS = wg::THREADS;
  constexpr int NB = D / 64;  // 64-column blocks of an output row
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(hopper::align1024(smem_raw));  // [BQ][D]
  bf16* Ks = Qs + BQ * D;                                           // 2 slots
  bf16* Vs = Ks + 2 * BK * D;                                       // 2 slots
  int* valid_s = reinterpret_cast<int*>(Vs + 2 * BK * D);           // 2 x [BK], with K
  int* kdoc_s = valid_s + 2 * BK;                                   // 2 x [BK], with K

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KVH);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the last q tiles (most key tiles) first
  const int off = offs[b], kv_off = offs[gridDim.y + b];
  const float slope = alibi ? slopes[h] : 0.f;
  const bool has_docs = qids != nullptr, has_seg = seg != nullptr;
  const size_t qld = (size_t)H * D, kld = (size_t)KVH * D;
  const bf16* ksrc = k + (size_t)b * S * kld + (size_t)kvh * D;
  const bf16* vsrc = v + (size_t)b * S * kld + (size_t)kvh * D;

  // key tiles the CTA visits: up to its last row's causal limit
  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = flash::causal_key_tiles(n_tiles, off + min(q0 + BQ, Tq) - 1, kv_off, BK);

  auto load_k = [&](int j) {  // K tile j with its keys' validity and ids, into K slot j % 2
    const int st = j % 2, k0 = j * BK;
    hopper::load_tile<BK, D>(Ks + st * BK * D, ksrc, k0, S, kld, tid, THREADS);
    if (tid < BK) {
      const int kp = k0 + tid;
      const size_t at = (size_t)b * S + min(kp, S - 1);
      if (has_seg) hopper::copy4(valid_s + st * BK + tid, seg + at, kp < S);
      if (has_docs) hopper::copy4(kdoc_s + st * BK + tid, kids + at, kp < S);
    }
  };
  auto load_v = [&](int j) {  // V tile j into V slot j % 2
    hopper::load_tile<BK, D>(Vs + (j % 2) * BK * D, vsrc, j * BK, S, kld, tid, THREADS);
  };
  auto issue_s = [&](float (&s)[32], int j) {  // s = q . k^T of tile j, one wgmma group
    const bf16* Kt = Ks + (j % 2) * BK * D;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::mma_ss(s, hopper::desc_k<BQ>(Qs, 0, kk), hopper::desc_k<BK>(Kt, 0, kk), kk);
    hopper::wgmma_commit();
  };

  // rows r0 and r0 + 8 of the warpgroup's 64: the accumulator layout's
  int qpos_r[2], qdoc_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + lane / 4 + 8 * r;
    qpos_r[r] = off + qi;
    qdoc_r[r] = has_docs && qi < Tq ? qids[(size_t)b * Tq + qi] : 0;
  }
  float m_r[2] = {INIT_M, INIT_M}, l_r[2] = {0.f, 0.f};
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;

  // prologue: q and K tile 0, then s of tile 0 while V tile 0 and K tile 1 load
  hopper::load_tile<BQ, D>(Qs, q + (size_t)b * Tq * qld + (size_t)h * D, q0, Tq, qld, tid, THREADS);
  if (n_tiles > 0) load_k(0);
  hopper::commit_copies();
  hopper::wait_copies<0>();
  hopper::fence_async_proxy();
  __syncthreads();
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  issue_s(s, 0);  // with no tile, on a slot never loaded: not read
  if (n_tiles > 0) load_v(0);
  if (n_tiles > 1) load_k(1);
  hopper::commit_copies();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);

  for (int j = 0; j < n_tiles; ++j) {
    // s holds tile j's scores; p . v of tile j - 1 may still be in flight
    float alpha[2];
    {
      const int k0 = j * BK;
      const int* vs = valid_s + (j % 2) * BK;
      const int* kd = kdoc_s + (j % 2) * BK;
      // flash.py _scores order: s * scale + (alibi + causal), + documents,
      // then + validity. Below the diagonal the causal term adds 0: a tile
      // wholly visible to the tile's first row skips it.
      const bool diag = causal && kv_off + k0 + BK - 1 > off + q0;
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1), kp = k0 + col;
        float x = flash::biased_score(s[e], scale, qpos_r[r] - (kv_off + kp), slope, diag, alibi,
                                      has_docs, qdoc_r[r], has_docs ? kd[col] : 0);
        if (has_seg) x = x + (vs[col] != 0 ? 0.f : flash::NEG_INF);
        if (kp >= S) x = -INFINITY;  // tile overhang past the keys: no key
        s[e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the four lanes of a quad share a row
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m_r[r], tmax[r]);
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = expf(s[e] - m_r[(e >> 1) & 1]);
        s[e] = p;
        psum[(e >> 1) & 1] += p;
      }
      // l stays a per-lane partial (alpha is common to the quad); summed at the end
      l_r[0] = alpha[0] * l_r[0] + psum[0];
      l_r[1] = alpha[1] * l_r[1] + psum[1];
    }
    hopper::wgmma_wait<0>();  // p . v of tile j - 1 has landed
    uint32_t pa[4][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      hopper::fence_regs(acc[nb]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[nb][e] *= alpha[(e >> 1) & 1];
    }
    hopper::to_a(pa, s);
    hopper::wait_copies<0>();  // V tile j and K tile j + 1 have landed
    hopper::fence_async_proxy();
    __syncthreads();  // every warp is done with V tile j - 1 and K tile j: their slots are free
    if (j + 1 < n_tiles) load_v(j + 1);
    if (j + 2 < n_tiles) load_k(j + 2);
    hopper::commit_copies();
    issue_s(s, j + 1);  // after the last tile, on a stale slot: not read
    const bf16* Vt = Vs + (j % 2) * BK * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // o += p . v (v read transposed)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) hopper::mma_rs(acc[nb], pa[kk], hopper::desc_mn<BK>(Vt, nb, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // s of tile j + 1, the older group, has landed
    hopper::fence_regs(s);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
  hopper::wait_copies<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + 16 * warp + lane / 4 + 8 * r;
    if (qi < Tq) {
      const bool dead = causal && qpos_r[r] < kv_off;  // no key of the shard is visible
      const float l_safe = l == 0.f ? 1.f : l;
      OutT* out = o + ((size_t)(b * Tq + qi) * H + h) * D + 2 * (lane & 3);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = 4 * jj + 2 * r;
          store2(out + 64 * nb + 8 * jj, dead ? 0.f : acc[nb][e] / l_safe, dead ? 0.f : acc[nb][e + 1] / l_safe);
        }
      if (lse != nullptr && (lane & 3) == 0)
        lse[((size_t)b * H + h) * Tq + qi] = dead ? INIT_M : m_r[r] + logf(l_safe);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* slopes, const void* offs,
               const void* seg, const void* qids, const void* kids, void* o, void* lse, int B,
               int Tq, int S, int H, int KVH, float scale, int causal, int alibi,
               cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(float) + 2 * BK * sizeof(int);
  cudaFuncSetAttribute(flash_fwd_fma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_fma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(slopes), static_cast<const int*>(offs),
      static_cast<const int*>(seg), static_cast<const int*>(qids), static_cast<const int*>(kids),
      static_cast<float*>(o), static_cast<float*>(lse), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

template <typename OutT, int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* slopes, const void* offs,
                 const void* seg, const void* qids, const void* kids, void* o, void* lse, int B,
                 int Tq, int S, int H, int KVH, float scale, int causal, int alibi,
                 cudaStream_t stream) {
  constexpr int smem = wg::SMEM<D>;
  cudaFuncSetAttribute(flash_fwd_wgmma_kernel<OutT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid(H, B, (Tq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<OutT, D><<<grid, wg::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(slopes), static_cast<const int*>(offs),
      static_cast<const int*>(seg), static_cast<const int*>(qids), static_cast<const int*>(kids),
      static_cast<OutT*>(o), static_cast<float*>(lse), Tq, S, H, KVH, scale, causal, alibi);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); out_dtype:
// the output's, 0 = float32 or 1 = bfloat16 (float32 inputs take float32
// only). q, k, v must start 16-byte aligned and be contiguous (the bf16
// kernel copies them 16 bytes at a time). offs is int32 [2, B] (query
// offsets, then key offsets). seg ([B, S] int32 validity), the document
// ids (qids [B, T] and kids [B, S] int32, both or neither) and lse may be
// null. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* slopes,
                         const void* offs, const void* seg, const void* qids, const void* kids,
                         void* o, void* lse, int dtype, int out_dtype, int B, int Tq, int S, int H,
                         int KVH, int D, float scale, int causal, int alibi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((qids == nullptr) != (kids == nullptr)) return (int)cudaErrorInvalidValue;
#define FWD_ARGS \
  q, k, v, slopes, offs, seg, qids, kids, o, lse, B, Tq, S, H, KVH, scale, causal, alibi, st
  if (dtype == 0 && out_dtype == 0 && D == 64) return launch_f32<64>(FWD_ARGS);
  if (dtype == 0 && out_dtype == 0 && D == 128) return launch_f32<128>(FWD_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 64) return launch_wgmma<bf16, 64>(FWD_ARGS);
  if (dtype == 1 && out_dtype == 1 && D == 128) return launch_wgmma<bf16, 128>(FWD_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 64) return launch_wgmma<float, 64>(FWD_ARGS);
  if (dtype == 1 && out_dtype == 0 && D == 128) return launch_wgmma<float, 128>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
