// Hopper (sm_90a) building blocks of the tensor-core flash backward
// (flash_bwd.cu): asynchronous copies into 128-byte-swizzled shared-memory
// tiles, the wgmma descriptors that read those tiles either way round, and
// the m64n64k16 bf16 -> f32 wgmma forms the kernels issue.
//
// Tile layout. A tile of R rows x D bf16 (D a multiple of 64) is stored as
// D / 64 column blocks of R x 64; a block row is 128 bytes, a block R * 128
// bytes, and inside a block the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). Every 8 rows form one 1024-byte swizzle atom, the pattern
// wgmma's 128-byte swizzle mode reads (and TMA's SWIZZLE_128B writes); tiles
// start 1024-aligned. The same bytes serve as
// - a K-major operand (rows on M or N, the D columns the reduction): 16
//   columns of one block per k-step, 8-row groups 1024 bytes apart; and as
// - an MN-major operand (rows the reduction, D columns on N): 16 rows per
//   k-step, two 8-row groups 1024 bytes apart, one 64-column block per
//   m64n64 instruction (the descriptor's transpose bit).
// So q . k^T and ds . k read one K tile with no transposed copy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ------------------------------------------------------------- cp.async

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0 reads
// nothing; src must still be a mapped address)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed copy groups are still in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async lands through the generic proxy, wgmma reads through the async
// proxy: each thread fences its own copies before the barrier that
// publishes them
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (of D / 8 per row) of row r in an R-row tile
template <int R>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

// Rows [r0, r0 + R) of a [n rows, ld] bf16 slab (src points at the first
// row's first wanted column; D columns are copied) into an R-row tile, by
// all nthreads threads; rows at or past n are zero.
template <int R, int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src, int r0, int n,
                                          size_t ld, int tid, int nthreads) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  for (int i = tid; i < R * CPR; i += nthreads) {
    const int r = i / CPR, c = i % CPR, row = r0 + r;
    const bool ok = row < n;
    copy16(base + tile_offset<R>(r, c), src + (ok ? (size_t)row * ld : 0) + c * 8, ok);
  }
}

// ---------------------------------------------------------------- wgmma

// Descriptor of an operand at shared address addr: 128-byte swizzle, the
// 8-row groups 1024 bytes apart. That stride is SBO for K-major operands;
// LBO carries the same 1024 bytes, the other field an m64n64k16 MN-major
// operand may read for its second 8-row group (its 64 columns are one
// swizzle atom, so no other stride is needed).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t stride = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) | ((uint64_t)1 << 62);
}

// K-major operand: rows [r0, r0 + 64) of an R-row tile, columns
// [16 kk, 16 kk + 16)
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int kk) {
  return desc(smem_addr(tile) + (kk / 4) * (R * 128) + r0 * 128 + (kk % 4) * 32);
}

// MN-major operand: rows [16 kk, 16 kk + 16) (the reduction) of an R-row
// tile, columns [64 nb, 64 nb + 64)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int nb, int kk) {
  return desc(smem_addr(tile) + nb * (R * 128) + kk * 2048);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D32_STR                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "   \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) = [d +] A . B^T: A 64 x 16 and B 64 x 16, both K-major
// descriptors. The accumulator layout: thread t of the warpgroup holds, in
// d[4 j + 2 i + c], row 16 (t / 32) + (t % 32) / 4 + 8 i and column
// 8 j + 2 (t % 4) + c.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A . B: A 64 x 16 bf16 from registers (the
// accumulator layout of 16 columns, two bf16 a register: a[0] row r,
// columns 2c..2c+1; a[1] row r + 8; a[2], a[3] the same 8 columns on), B
// 16 x 64 an MN-major descriptor.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_D32
#undef HOPPER_D32_STR

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x 64 f32 accumulator, rounded to bf16, as the A operands of four
// k-steps of 16 columns
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

}  // namespace hopper
