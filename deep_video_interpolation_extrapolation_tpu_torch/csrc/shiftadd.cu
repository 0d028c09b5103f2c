// The 9-way shifted add + bias that finishes the HRNet heads, bf16 NHWC:
//   out[b,y,x,c] = bf16(b2[c] + sum_{ky,kx} yt[b, y+ky-1, x+kx-1, (3ky+kx)*co + c])
// with yt zero outside the image (the 3x3 conv's SAME padding), the taps
// summed in f32 in the order t = 0..8 and rounded once.
//
// Replaces ops/pallas_shiftadd.py:shifted_add_bias (pallas_call at :111),
// the tail of the taps-in-N heads (the taps come from K4, the 4-part head
// or the dual head).  The TPU kernel extracts tap t from the 207-lane rows
// by a lane roll of co*t and resolves the +-1-row halo by a one-tile delay;
// on Hopper every thread gathers its own 9 taps, so neither is needed.
//
// Bound on the H100 at the serving shape (B=1, 512x1024, co = 23): yt
// 217.1 MB read once, out 24.1 MB written, 72 us of HBM time at 3.35 TB/s;
// 9 f32 adds per output element, 0.22 GFLOP, nothing next to the bytes.
// Design: one thread per output element (pixel, channel), so a warp's 32
// threads cover ~1.4 pixels' 23 channels and each tap's reads are runs of
// 23 contiguous bf16 values, 414 bytes apart; the 9 taps of a pixel's
// neighbourhood re-read lines that neighbouring warps just brought into L2,
// so device memory sees yt about once.  Vector loads of whole tap rows are
// for a later pass.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int SA_THREADS = 256;

__global__ void __launch_bounds__(SA_THREADS)
    shifted_add_bias_kernel(const bf16 *__restrict__ yt, const float *__restrict__ b2,
                            bf16 *__restrict__ out, int H, int W, int co, long total) {
  const long e = (long)blockIdx.x * SA_THREADS + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % co);
  const long m = e / co;
  const int x = (int)(m % W);
  const long t = m / W;
  const int y = (int)(t % H);
  const long b = t / H;
  const int n = 9 * co;
  float acc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int yy = y + ky - 1;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int xx = x + kx - 1;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        acc += bf(yt[((b * H + yy) * W + xx) * n + (3 * ky + kx) * co + c]);
    }
  }
  out[e] = __float2bfloat16(acc + b2[c]);
}

}  // namespace
}  // namespace dvie

// yt (B,H,W,9*co) bf16, b2 (co,) f32, out (B,H,W,co) bf16 (checked by the
// Python wrapper).
extern "C" int dvie_shifted_add_bias(const void *yt, const void *b2, void *out, int B, int H,
                                     int W, int co, void *stream) {
  using dvie::bf16;
  const long total = (long)B * H * W * co;
  const unsigned blocks = (unsigned)((total + dvie::SA_THREADS - 1) / dvie::SA_THREADS);
  dvie::shifted_add_bias_kernel<<<blocks, dvie::SA_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16 *)yt, (const float *)b2, (bf16 *)out, H, W, co, total);
  return (int)cudaGetLastError();
}
