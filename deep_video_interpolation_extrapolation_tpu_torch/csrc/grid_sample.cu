// Bilinear grid sample (the backward warp), NHWC, bf16 or f32:
//   fx = (gx + 1) * 0.5 * (W - 1),  fy = (gy + 1) * 0.5 * (H - 1)   (f32)
//   out[b,i,j,c] = sum over the 4 corners (y, x) of (fy, fx) of
//                  relu(1 - |fy - y|) * relu(1 - |fx - x|) * x[b,y,x,c]
// over the corners inside the image (zero padding, align_corners=True: torch
// F.grid_sample's rule), summed in f32 and rounded once to x's type.  With
// max_disp = R >= 0 a corner also counts only if y - i and x - j both lie in
// [-R, R+1]: the window of the TPU kernel, so a sample farther than R pixels
// from its output pixel gives 0, and one at the window's edge keeps only the
// corners inside it.  R < 0 is unbounded (ops/warp.grid_sample's function).
//
// Replaces ops/pallas_warp.py:grid_sample_pallas (pallas_call at :134).  The
// TPU has no vector gather, so its kernel rolls the image over every offset
// of a (2R+2)^2 window and accumulates hat-weighted copies (324 passes at R
// = 8).  Hopper gathers: each thread reads its 4 corners directly, and the
// window survives only as the per-corner bound above.
//
// Bound on the H100 at the shape of warp.py:130 (8x512x1024, C = 3, bf16):
// x 25.2 MB + grid 33.6 MB (f32) + out 25.2 MB = 83.9 MB, 25 us of HBM time
// at 3.35 TB/s; ~40 f32 operations per pixel, 0.17 GFLOP: bound by bytes.
// Design: one thread per output pixel, all C channels; the grid is read as
// one float2, the corners as scalar loads that hit L2 for smooth flows.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int GS_THREADS = 256;

__device__ __forceinline__ float ld(const float *p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16 *p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float *p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16 *p, float v) { *p = __float2bfloat16(v); }

// whether integer coordinate v (held as a float) is a corner that counts
// along an axis of n pixels for the output pixel at p
__device__ __forceinline__ bool counts(float v, int n, int p, int R) {
  return v >= 0.f && v <= (float)(n - 1) &&
         (R < 0 || (v - (float)p >= (float)-R && v - (float)p <= (float)(R + 1)));
}

template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
    grid_sample_kernel(const T *__restrict__ x, const float2 *__restrict__ grid,
                       T *__restrict__ out, int H, int W, int C, int R, long total) {
  const long m = (long)blockIdx.x * GS_THREADS + threadIdx.x;
  if (m >= total) return;
  const int j = (int)(m % W);
  const long t = m / W;
  const int i = (int)(t % H);
  const long b = t / H;
  const float2 g = grid[m];
  const float fx = (g.x + 1.f) * 0.5f * (float)(W - 1);
  const float fy = (g.y + 1.f) * 0.5f * (float)(H - 1);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = fx - x0, ty = fy - y0;
  const bool vx0 = counts(x0, W, j, R), vx1 = counts(x0 + 1.f, W, j, R);
  const bool vy0 = counts(y0, H, i, R), vy1 = counts(y0 + 1.f, H, i, R);
  // corner addresses, taken only where the corner counts (the int casts
  // are then in range)
  const long row0 = vy0 ? (b * H + (long)y0) * W : 0, row1 = vy1 ? (b * H + (long)y0 + 1) * W : 0;
  const long col0 = vx0 ? (long)x0 : 0, col1 = vx1 ? (long)x0 + 1 : 0;
  for (int c = 0; c < C; ++c) {
    const float v00 = vy0 && vx0 ? ld(x + (row0 + col0) * C + c) : 0.f;
    const float v01 = vy0 && vx1 ? ld(x + (row0 + col1) * C + c) : 0.f;
    const float v10 = vy1 && vx0 ? ld(x + (row1 + col0) * C + c) : 0.f;
    const float v11 = vy1 && vx1 ? ld(x + (row1 + col1) * C + c) : 0.f;
    const float top = v00 * (1.f - tx) + v01 * tx;
    const float bot = v10 * (1.f - tx) + v11 * tx;
    st(out + m * C + c, top * (1.f - ty) + bot * ty);
  }
}

}  // namespace
}  // namespace dvie

// x, out (B,H,W,C) bf16 (is_bf16 != 0) or f32, grid (B,H,W,2) f32;
// max_disp < 0: unbounded (checked by the Python wrapper).
extern "C" int dvie_grid_sample(const void *x, const void *grid, void *out, int B, int H, int W,
                                int C, int max_disp, int is_bf16, void *stream) {
  using dvie::bf16;
  const long total = (long)B * H * W;
  const unsigned blocks = (unsigned)((total + dvie::GS_THREADS - 1) / dvie::GS_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    dvie::grid_sample_kernel<bf16><<<blocks, dvie::GS_THREADS, 0, s>>>(
        (const bf16 *)x, (const float2 *)grid, (bf16 *)out, H, W, C, max_disp, total);
  else
    dvie::grid_sample_kernel<float><<<blocks, dvie::GS_THREADS, 0, s>>>(
        (const float *)x, (const float2 *)grid, (float *)out, H, W, C, max_disp, total);
  return (int)cudaGetLastError();
}
