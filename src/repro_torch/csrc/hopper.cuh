// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tensor and bulk copies, named barriers, register reallocation between
// warpgroups, 128-byte-swizzled shared-memory matrix descriptors and bf16
// wgmma (m64nNk16, float32 accumulators): N 64 with A from shared memory,
// N 64 and 128 with A from registers.
//
// Tiles are panels of 64 rows x 128 bytes (64 bf16), 1024-byte aligned, in
// the 128-byte swizzle that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// the 16-byte chunk c of row r sits at r * 128 + ((c ^ (r % 8)) * 16).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int PANEL = 64 * 128;   // bytes of one 64 x 64 bf16 panel

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a panel
__device__ inline uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// -- mbarriers ----------------------------------------------------------------

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ inline bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` to complete.  A barrier that stays
// open for 2^32 clocks (about two seconds) means a fault in the protocol:
// trap, so the launch fails instead of hanging the card.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// -- TMA ----------------------------------------------------------------------

__device__ inline void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                   uint32_t bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ inline void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                   uint32_t bar, int c0, int c1, int c2,
                                   int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// contiguous bytes (a multiple of 16, 16-byte aligned at both ends)
__device__ inline void bulk_load(uint32_t dst, const void* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
// (TMA, wgmma)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- barriers and registers ---------------------------------------------------

__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// arrive at a named barrier without waiting (a producer's half of a
// hand-off whose consumers named_sync on the same id and count)
__device__ inline void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
template <int N> __device__ inline void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ inline void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand: K-major (rows of the M or N
// index, K along the row; a k16 step advances `addr` by 32 bytes inside the
// row) or MN-major (rows of the K index, 64 M or N values along the row; a
// k16 step advances `addr` by 16 rows, 2048 bytes).  Groups of 8 rows lie
// 1024 bytes apart; `lbo` is an MN-major operand's stride between 64-wide
// blocks (the next panel), unused by K-major ones.
__device__ inline uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ inline void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ inline void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// The compiler sees a wgmma use its registers when it starts; the tensor
// cores read and write them until the wait.  An empty volatile use on both sides
// keeps them in place.
template <int N> __device__ inline void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),               \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),           \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),           \
  "+f"(d[31])
#define HOPPER_D64(d)                                                        \
  HOPPER_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),           \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),           \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),           \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define HOPPER_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, float32) = A . B (+ d when accumulate), A and B bf16 in shared
// memory; A K-major, B K-major (TB 0) or MN-major (TB 1)
template <int TB>
__device__ inline void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}
// d (64 x 64, float32) += A . B, A (64 x 16 bf16) in registers in the
// accumulator's row layout, B in shared memory, K-major (TB 0) or MN-major
// (TB 1)
template <int TB>
__device__ inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}
// d (64 x 128, float32) += A . B as above at N = 128 (an MN-major B spans
// two panels, `lbo` apart)
template <int TB>
__device__ inline void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}
#undef HOPPER_D64
#undef HOPPER_R64
#undef HOPPER_D32
#undef HOPPER_R32

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The A operand of k16 step kk from a 64 x N float32 accumulator (columns
// 16 kk .. 16 kk + 15 as the K index), rounded to bf16
template <int R>
__device__ inline void acc_to_a(uint32_t (&a)[4], const float (&x)[R],
                                int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

}  // namespace hopper
