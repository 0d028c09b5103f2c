// Shared helpers of the hand-written Hopper kernels: bf16 rounding, the
// lrelu, 16-byte loads, stores and cp.async copies.  The matrix products
// run on wgmma (hopper.cuh).  Pixels are flattened to rows m = (b*H + y)*W
// + x of NHWC tensors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dvie {

using bf16 = __nv_bfloat16;

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

// Asynchronous 16-byte global->shared copy (sm_80+) of the first `bytes`
// (0..16) source bytes, the rest of the 16 destination bytes zero-filled
// (a run's tail at the end of a tensor).
__device__ __forceinline__ void cp_async_bytes16(void *smem_dst, const void *gmem_src, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes));
}

// The same copy of all 16 bytes; with valid == false nothing is read and
// the 16 destination bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void *smem_dst, const void *gmem_src,
                                           bool valid = true) {
  cp_async_bytes16(smem_dst, gmem_src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace dvie
