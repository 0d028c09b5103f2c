// Shared helpers of the hand-written Hopper kernels.
//
// Every kernel here is an NHWC bf16 kernel with f32 accumulation on the
// tensor cores, through WMMA 16x16x16 bf16 tiles read from shared memory
// (the BasicBlock chain, the layer1 Bottleneck and K4 through wgmma
// instead: hopper.cuh).
// Pixels are flattened to rows m = (b*H + y)*W + x, so a tile of rows is a
// run of consecutive pixels and an output tile is one contiguous span of
// device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dvie {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// round to bf16 and back: the rounding point of the JAX reference
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// lrelu applied to a bf16 value in bf16 arithmetic (input already rounded)
__device__ __forceinline__ float lrelu_bf(float v) { return v >= 0.f ? v : rbf(0.2f * v); }

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// 8 bf16 <-> 8 f32 through one 16-byte word
__device__ __forceinline__ void unpack8(const uint4 &u, float *f) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float *f) {
  uint4 u;
  __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 ldg16(const bf16 *p) {
  return __ldg(reinterpret_cast<const uint4 *>(p));
}

__device__ __forceinline__ void st16(bf16 *p, const uint4 &v) {
  *reinterpret_cast<uint4 *>(p) = v;
}

// Asynchronous 16-byte global->shared copy (sm_80+).  With valid == false
// nothing is read and the 16 destination bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void *smem_dst, const void *gmem_src,
                                           bool valid = true) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Asynchronous copy of a (rows x cols) bf16 block (cols % 8 == 0, rows
// 16-byte aligned) of a row-major global matrix into shared memory.
__device__ __forceinline__ void load_block_async(bf16 *dst, int lds, const bf16 *src, long ld,
                                                 int rows, int cols) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, v = i % vpr;
    cp_async16(dst + r * lds + v * 8, src + r * ld + v * 8);
  }
}

// acc[j] += A(16 x 16*ksteps) . B(16*ksteps x 16*NJ), A rows at a_s (lda),
// B at b_s (ldb); one warp.
template <int NJ>
__device__ __forceinline__ void warp_mma(FragC (&acc)[NJ], const bf16 *a_s, int lda,
                                         const bf16 *b_s, int ldb, int ksteps) {
  FragA a;
  FragB b;
  for (int kk = 0; kk < ksteps; ++kk) {
    wmma::load_matrix_sync(a, a_s + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::load_matrix_sync(b, b_s + kk * 16 * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// acc0[j] += A rows [0,16) . B, acc1[j] += A rows [16,32) . B: two 16-row
// groups of one warp sharing every B fragment they load.
template <int NJ>
__device__ __forceinline__ void warp_mma2(FragC (&acc0)[NJ], FragC (&acc1)[NJ], const bf16 *a_s,
                                          int lda, const bf16 *b_s, int ldb, int ksteps) {
  FragA a0, a1;
  FragB b;
  for (int kk = 0; kk < ksteps; ++kk) {
    wmma::load_matrix_sync(a0, a_s + kk * 16, lda);
    wmma::load_matrix_sync(a1, a_s + 16 * lda + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::load_matrix_sync(b, b_s + kk * 16 * ldb + j * 16, ldb);
      wmma::mma_sync(acc0[j], a0, b, acc0[j]);
      wmma::mma_sync(acc1[j], a1, b, acc1[j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(FragC (&acc)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
}

template <int NJ>
__device__ __forceinline__ void store(float *c_s, int ldc, FragC (&acc)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(c_s + j * 16, acc[j], ldc, wmma::mem_row_major);
}

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// 8 channels [c, c+8) of the bilinear sample of src (B,Hi,Wi,C) at output
// pixel (yy, xx) of image b, rounded to bf16; sh, sw = in/out size
// (F.interpolate's half-pixel, edge-clamped align_corners=False rule)
__device__ __forceinline__ uint4 bilerp8(const bf16 *__restrict__ src, long b, int Hi, int Wi,
                                         int C, int c, int yy, int xx, float sh, float sw) {
  const float fy = fmaxf((yy + 0.5f) * sh - 0.5f, 0.f);
  const float fx = fmaxf((xx + 0.5f) * sw - 0.5f, 0.f);
  const int y0 = min((int)fy, Hi - 1), x0 = min((int)fx, Wi - 1);
  const int y1 = min(y0 + 1, Hi - 1), x1 = min(x0 + 1, Wi - 1);
  const float ly = fy - y0, lx = fx - x0;
  const bf16 *base = src + b * Hi * Wi * C + c;
  float a[8], bq[8], cq[8], d[8], o[8];
  unpack8(ldg16(base + ((long)y0 * Wi + x0) * C), a);
  unpack8(ldg16(base + ((long)y0 * Wi + x1) * C), bq);
  unpack8(ldg16(base + ((long)y1 * Wi + x0) * C), cq);
  unpack8(ldg16(base + ((long)y1 * Wi + x1) * C), d);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    o[k] = (1.f - ly) * ((1.f - lx) * a[k] + lx * bq[k]) + ly * ((1.f - lx) * cq[k] + lx * d[k]);
  return pack8(o);
}

}  // namespace dvie
