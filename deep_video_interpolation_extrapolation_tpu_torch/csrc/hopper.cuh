// Hopper building blocks (sm_90a): warpgroup MMA (wgmma) with A from
// registers or shared memory and B from shared memory (N = 64; N = 208 for
// the heads' taps products, N = 16 for the stem's dx), ldmatrix, mbarriers,
// setmaxnreg and the bulk (non-tensor) TMA copy; and (namespace tiled) the pixel tiles and weight ring of the
// persistent conv kernels.
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
#include <cuda_runtime.h>
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

// move this warpgroup's registers a thread to R (all its warps execute it):
// a producer warpgroup gives up what its consumers take
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
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

// d[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (as wgmma64),
// K-major B.  d[4j + {0,1,2,3}] as wgmma64, j < 2.
__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64] with both operands in shared memory
// (K-major A and B, no swizzle): A's descriptor as B's, its core matrices
// 8 rows of 8 k.
template <int TRANS_B>
__device__ __forceinline__ void wgmma64ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
}

// d[64 x 208] += A[64 x 16] . B[16 x 208], A from registers (as wgmma64),
// K-major B (no swizzle).  d[4j + {0,1,2,3}] as wgmma64, j < 26.
__device__ __forceinline__ void wgmma208(float (&d)[104], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103}, "
      "{%104, %105, %106, %107}, %108, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// The A fragments of a 64 x 64 bf16 operand from a wgmma64 accumulator
// layout (FA3's P.V): k-step kk takes accumulator columns [16 kk, 16 kk + 16),
// so a[kk] = {d[8kk..+1], d[8kk+2..+3], d[8kk+4..+5], d[8kk+6..+7]} packed.
// The values must already be what the next product should read (rounded,
// activated).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
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

// ---- 2-D pixel tiles and the weight-unit ring --------------------------------
//
// The pieces of the persistent wgmma conv kernels (the layer1 Bottleneck
// train chain, K1 and K2).  A block walks TH x 16 pixel tiles of NHWC
// images; a warpgroup owns 64 tile pixels (4 tile rows), and each of its
// warps one tile row, so a warp's accumulator rows are 16 consecutive
// pixels of one image row.  A comes by ldmatrix at each lane's own row of
// a region staged in shared memory (a shifted view of a staged tile is no
// valid wgmma descriptor).  Weights come as 8 KB units of 64 K x 64 N bf16
// in the no-swizzle K-major core-matrix order, streamed by one producer
// warp into a ring of NST slots by bulk TMA copies under full/empty
// mbarriers, in the order the consumers take them.  No wgmma sits under a
// thread-dependent branch: ptxas serializes wgmmas on a divergent path
// (C7518).
namespace tiled {

constexpr int TW = 16;            // tile width
constexpr int UB = 64 * 64 * 2;   // a weight unit
constexpr int NST = 8;            // weight ring slots

struct Tile {
  int b, y0, x0;
};

__host__ __device__ inline int n_tiles(int B, int H, int W, int th) {
  return B * ((H + th - 1) / th) * ((W + TW - 1) / TW);
}

__device__ __forceinline__ Tile tile_at(int t, int th, int H, int W) {
  const int tx = (W + TW - 1) / TW, ty = (H + th - 1) / th;
  Tile r;
  r.x0 = (t % tx) * TW;
  t /= tx;
  r.y0 = (t % ty) * th;
  r.b = t / ty;
  return r;
}

__device__ __forceinline__ bool inside(int yy, int xx, int H, int W) {
  return yy >= 0 && yy < H && xx >= 0 && xx < W;
}

__device__ __forceinline__ long pix(int b, int yy, int xx, int H, int W) {
  return ((long)b * H + yy) * W + xx;
}

__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16 *p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(p));
}

__device__ __forceinline__ void st2(__nv_bfloat16 *p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162 *>(p) = __floats2bfloat162_rn(a, b);
}

struct Ring {
  uint64_t *full, *empty;
  uint32_t base;  // shared address of slot 0
  int seq;        // units consumed so far
};

// the producer warp's lane 0: `units` units of w for every tile of this
// block (tiles blockIdx.x, + gridDim.x, ... below nt)
__device__ __forceinline__ void produce(uint64_t *full, uint64_t *empty, unsigned char *ring,
                                        const __nv_bfloat16 *__restrict__ w, int units, int nt) {
  int seq = 0;
  for (int t = blockIdx.x; t < nt; t += gridDim.x)
    for (int u = 0; u < units; ++u, ++seq) {
      const int s = seq % NST;
      mbar_wait(&empty[s], ((seq / NST) & 1) ^ 1);
      mbar_expect_tx(&full[s], UB);
      bulk_load(ring + s * UB, w + (long)u * (UB / 2), UB, &full[s]);
    }
}

__device__ __forceinline__ void init_ring(uint64_t *full, uint64_t *empty, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// acc += A . unit at descriptor d (4 k-steps; A in registers), then wait
// for all but these wgmmas
__device__ __forceinline__ void mma_unit(float (&acc)[32], const uint32_t (&a)[4][4], uint64_t d) {
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma64<0>(acc, a[j], d + ((j * 2048) >> 4));
  wg_commit();
  wg_wait<1>();
}

// One unit of the ring: acc += A . unit.  After the wait for all but this
// unit's wgmmas, the previous unit's slot is released when `release_prev`
// (it belongs to the same sequence).
__device__ __forceinline__ void step(float (&acc)[32], const uint32_t (&a)[4][4], Ring &r,
                                     bool release_prev) {
  const int s = r.seq % NST;
  mbar_wait(&r.full[s], (r.seq / NST) & 1);
  mma_unit(acc, a, desc(r.base + s * UB, 1024, 128));
  mbar_arrive_if(&r.empty[(r.seq + NST - 1) % NST], release_prev && (threadIdx.x & 31) == 0);
  ++r.seq;
}

// the end of a sequence of units: every wgmma done, the last slot released
__device__ __forceinline__ void finish(float (&acc)[32], Ring &r) {
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive_if(&r.empty[(r.seq + NST - 1) % NST], (threadIdx.x & 31) == 0);
}

// a 64 x 64 A operand (4 k-steps) by ldmatrix from this lane's row address
__device__ __forceinline__ void ld_a(uint32_t (&a)[4][4], uint32_t addr) {
#pragma unroll
  for (int j = 0; j < 4; ++j) ldsm4(a[j], addr + j * 32);
}

// acc += sum over nu units of A(u) . unit u, A(u) by ldmatrix at abase +
// off(u) (this lane's row; 16 k per k-step); the next unit's A is loaded
// while the current unit's wgmmas run.  `after`: a unit of the same
// sequence precedes this one (its slot is released here).
template <class Off>
__device__ __forceinline__ void gemm_ld(float (&acc)[32], uint32_t abase, int nu, Off off, Ring &r,
                                        bool after) {
  uint32_t a0[4][4], a1[4][4];
  ld_a(a0, abase + off(0));
#pragma unroll 1
  for (int u = 0; u < nu; u += 2) {
    step(acc, a0, r, after || u > 0);
    if (u + 1 < nu) {
      ld_a(a1, abase + off(u + 1));
      step(acc, a1, r, true);
      if (u + 2 < nu) ld_a(a0, abase + off(u + 2));
    }
  }
}

// A offsets of unit u: 64 channels further on; or tap u of a 3x3 conv on a
// 1-ring region of pitch PW positions, LD elements per position
struct ChanOff {
  __device__ __forceinline__ uint32_t operator()(int u) const { return (uint32_t)u * 128; }
};
template <int PW, int LD>
struct TapOff {
  __device__ __forceinline__ uint32_t operator()(int u) const {
    return (uint32_t)(((u / 3 - 1) * PW + u % 3 - 1) * LD * 2);
  }
};

// a persistent launch of `kern` over nt tiles: at most one block per tile,
// as many blocks as fit on the card at once
template <class Kern, class... Args>
int launch(Kern kern, int threads, int smem_bytes, int nt, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  if (nt < 1) return (int)cudaErrorInvalidValue;
  kern<<<nt < sms * occ ? nt : sms * occ, threads, smem_bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tiled
}  // namespace hop
}  // namespace dvie
