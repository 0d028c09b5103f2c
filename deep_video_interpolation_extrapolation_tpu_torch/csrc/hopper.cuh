// Hopper building blocks (sm_90a): warpgroup MMA (wgmma) with A from
// registers and B from shared memory, ldmatrix, mbarriers and the bulk
// (non-tensor) TMA copy.
//
// Shared-memory B operands use the no-swizzle ("interleaved") canonical
// layout: every 8 x 16-byte core matrix is 128 contiguous bytes, so a wgmma
// reads each core matrix from all 32 banks at once and needs no swizzle.
//   K-major B (for each n, 8 consecutive k): core matrix = 8 n-rows of 8 k;
//     LBO = bytes between the two 8-k halves of a k16 step,
//     SBO = bytes between consecutive groups of 8 n.
//   MN-major B (for each k, 8 consecutive n): core matrix = 8 k-rows of 8 n;
//     LBO = bytes between consecutive groups of 8 k,
//     SBO = bytes between consecutive groups of 8 n.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dvie {
namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory descriptor of the operand at shared address `addr`,
// no swizzle; addresses and byte offsets multiples of 16.  Adding k to it
// moves the start by 16 k bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr >> 4) & 0x3FFF);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// make this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads operands through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads of an accumulator across a wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], f32 += bf16 x bf16.  A: this
// thread's 4 registers of the warpgroup's A fragment (ldmatrix x4 layout);
// B: descriptor.  TRANS_B = 0: K-major B, 1: MN-major B.
// d[4j + {0,1,2,3}] = (row 16 warp + lane/4 {,,+8,+8}, col 8j + 2(lane%4) {,+1,,+1})
template <int TRANS_B>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- mbarriers and the bulk copy -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed.  The poll loop is
// PTX (no divergent C++ around later wgmmas); a wait that never ends (a
// pipeline fault) traps after 2^36 cycles (about 40 s, far beyond any
// real wait, even under time slicing): a launch error instead of a hung
// card.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 68719476736;\n"
      "@p trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// arrive on bar from the threads where `cond` holds, predicated in PTX
__device__ __forceinline__ void mbar_arrive_if(uint64_t *bar, bool cond) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"((uint32_t)cond)
      : "memory");
}
// bytes (multiple of 16, both addresses 16-byte aligned) global -> shared,
// completion counted on bar
__device__ __forceinline__ void bulk_load(void *dst, const void *src, uint32_t bytes,
                                          uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// named barrier over the first `threads` threads of the block (id 1..15)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace hop
}  // namespace dvie
