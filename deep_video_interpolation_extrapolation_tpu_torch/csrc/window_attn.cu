// Fused window attention of the stage-3 refiner, bf16 NHWC, C = Cv = 128.
//
// Replaces ops/pallas_corr.py fused_window_attention (pallas_call at :196),
// the attention of MSResAttnRefine at n_scales == 1 (attn_refine.py:159-177).
// For every pixel p: qn = q / max(|q|, 1e-12); for neighbour n = 0, 1, then
// wy = 0..win_h-1, then wx = 0..win_w-1, the key k at p + (wy - win_h/2,
// wx - win_w/2) (zero outside the map) gives s = qn . k / max(|k|, 1e-12);
// one online softmax over all 2*win_h*win_w logits (the zero-padded offsets
// take part with s = 0, as in the reference's zero-pad unfold) weights the
// values at the same offsets, out = sum p*v / max(l, 1e-12); per neighbour
// the flow is the first offset whose s is strictly above the best so far
// (jnp.argmax's tie rule).  Keys are normalised in f32 through a per-pixel
// inverse norm and never rounded; the TPU kernel rounds the normalised keys
// to bf16 (pallas_corr.py:85-86), the XLA oracle normalises in the input
// dtype: both within the bf16 tolerance of this one.
//
// Bound on the H100 at the serving shape (B=1, 128x256 at 1/4 of 512x1024,
// C = 128; on the path k1 = v1 and k2 = v2): 3 distinct bf16 inputs and the
// bf16 output, 4 x 8.39 MB, plus the f32 flow, 0.52 MB: 34.1 MB, 10.2 us of
// HBM time at 3.35 TB/s.  Work: 90 x (128 + 128) MACs per pixel over 32768
// pixels, 1.51 GFLOP: 1.5 us at the bf16 tensor-core peak, 22.5 us on the
// f32 CUDA cores this kernel uses.  So it is bound by bytes, and this first
// version is bound by neither: it issues ~50 warp instructions per pixel
// and offset (a 5-step shuffle reduction, two expf, the online-softmax
// update, replicated over the warp's lanes), ~0.15 ms at the SMs' issue
// rate.
//
// Design: one block per (image, row, 32-pixel segment of the row), 8 warps,
// each warp owning 4 output pixels; a lane holds 4 channels of each of its
// pixels (8-byte loads), and a dot product reduces by xor shuffles, so all
// lanes hold the same s and take the same softmax and argmax steps.  One
// neighbour at a time, the block stages its win_h x (32 + win_w - 1) x 128
// key and value slabs in shared memory with cp.async (zero-filled outside
// the map: 2 x 51 KB at 5x9), then the inverse norm of every key pixel; the
// online-softmax state stays in registers across both neighbours.  Tensor
// cores (the logits of a segment are a 32 x slab product) and overlapping
// the second neighbour's loads with the first's compute are for later.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int WA_SEG = 32;                  // output pixels of a block
constexpr int WA_WARPS = 8;
constexpr int WA_PPW = WA_SEG / WA_WARPS;   // output pixels of a warp
constexpr int WA_C = 128;                   // channels, 4 per lane
constexpr float WA_EPS = 1e-12f;

__device__ __forceinline__ void unpack4(const uint2 &u, float (&f)[4]) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WA_WARPS * 32)
    window_attn_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k1,
                       const bf16 *__restrict__ k2, const bf16 *__restrict__ v1,
                       const bf16 *__restrict__ v2, bf16 *__restrict__ out,
                       float *__restrict__ flow, int H, int W, int win_h, int win_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = WA_SEG + win_w - 1;
  const int slab = win_h * cols * WA_C;
  bf16 *ks = reinterpret_cast<bf16 *>(smem);
  bf16 *vs = ks + slab;
  float *kinv = reinterpret_cast<float *>(vs + slab);

  const int x0 = blockIdx.x * WA_SEG, y = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ph = win_h / 2, pw = win_w / 2;
  const long row = ((long)b * H + y) * W;

  float qn[WA_PPW][4], acc[WA_PPW][4], m[WA_PPW], l[WA_PPW];
  float best[WA_PPW][2], fl[WA_PPW][4];
#pragma unroll
  for (int j = 0; j < WA_PPW; ++j) {
    const int x = x0 + warp * WA_PPW + j;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (x < W) unpack4(__ldg(reinterpret_cast<const uint2 *>(q + (row + x) * WA_C + 4 * lane)), f);
    const float inv = 1.f / fmaxf(sqrtf(warp_sum(f[0] * f[0] + f[1] * f[1] + f[2] * f[2] +
                                                 f[3] * f[3])),
                                  WA_EPS);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qn[j][c] = f[c] * inv;
      acc[j][c] = 0.f;
      fl[j][c] = 0.f;
    }
    m[j] = -INFINITY;
    l[j] = 0.f;
    best[j][0] = best[j][1] = -INFINITY;
  }

#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const bf16 *kp = n ? k2 : k1;
    const bf16 *vp = n ? v2 : v1;
    if (n) __syncthreads();  // the first neighbour's slabs are read
    // stage the slabs, 16 bytes (8 channels) per copy, zero outside the map
    for (int i = threadIdx.x; i < win_h * cols * (WA_C / 8); i += blockDim.x) {
      const int chunk = i % (WA_C / 8), pix = i / (WA_C / 8);
      const int gy = y + pix / cols - ph, gx = x0 + pix % cols - pw;
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long src = valid ? (((long)b * H + gy) * W + gx) * WA_C + chunk * 8 : 0;
      cp_async16(ks + pix * WA_C + chunk * 8, kp + src, valid);
      cp_async16(vs + pix * WA_C + chunk * 8, vp + src, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int pix = warp; pix < win_h * cols; pix += WA_WARPS) {
      float f[4];
      unpack4(*reinterpret_cast<const uint2 *>(ks + pix * WA_C + 4 * lane), f);
      const float ss = warp_sum(f[0] * f[0] + f[1] * f[1] + f[2] * f[2] + f[3] * f[3]);
      if (lane == 0) kinv[pix] = 1.f / fmaxf(sqrtf(ss), WA_EPS);
    }
    __syncthreads();

    for (int wy = 0; wy < win_h; ++wy) {
      for (int wx = 0; wx < win_w; ++wx) {
        const float fdx = (float)(wx - pw), fdy = (float)(wy - ph);
#pragma unroll
        for (int j = 0; j < WA_PPW; ++j) {
          const int pix = wy * cols + warp * WA_PPW + j + wx;
          float kf[4], vf[4];
          unpack4(*reinterpret_cast<const uint2 *>(ks + pix * WA_C + 4 * lane), kf);
          unpack4(*reinterpret_cast<const uint2 *>(vs + pix * WA_C + 4 * lane), vf);
          const float s = warp_sum(qn[j][0] * kf[0] + qn[j][1] * kf[1] + qn[j][2] * kf[2] +
                                   qn[j][3] * kf[3]) *
                          kinv[pix];
          if (s > best[j][n]) {
            best[j][n] = s;
            fl[j][2 * n] = fdx;
            fl[j][2 * n + 1] = fdy;
          }
          const float m_new = fmaxf(m[j], s);
          const float scale = expf(m[j] - m_new), p = expf(s - m_new);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = acc[j][c] * scale + p * vf[c];
          l[j] = l[j] * scale + p;
          m[j] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < WA_PPW; ++j) {
    const int x = x0 + warp * WA_PPW + j;
    if (x >= W) continue;
    const float inv = 1.f / fmaxf(l[j], WA_EPS);
    uint2 u;
    __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&u);
    h[0] = __floats2bfloat162_rn(acc[j][0] * inv, acc[j][1] * inv);
    h[1] = __floats2bfloat162_rn(acc[j][2] * inv, acc[j][3] * inv);
    *reinterpret_cast<uint2 *>(out + (row + x) * WA_C + 4 * lane) = u;
    if (lane == 0)
      *reinterpret_cast<float4 *>(flow + (row + x) * 4) =
          make_float4(fl[j][0], fl[j][1], fl[j][2], fl[j][3]);
  }
}

}  // namespace
}  // namespace dvie

// q, k1, k2, v1, v2, out (B,H,W,128) bf16, flow (B,H,W,4) f32; odd win_h,
// win_w; B*H*W*128 < 2^31 (checked by the Python wrapper, with the shared
// memory of the window).
extern "C" int dvie_window_attn(const void *q, const void *k1, const void *k2, const void *v1,
                                const void *v2, void *out, void *flow, int B, int H, int W,
                                int win_h, int win_w, void *stream) {
  using dvie::bf16;
  const int cols = dvie::WA_SEG + win_w - 1;
  const int smem = 2 * win_h * cols * dvie::WA_C * (int)sizeof(bf16) + win_h * cols * 4;
  cudaError_t e = cudaFuncSetAttribute(dvie::window_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((W + dvie::WA_SEG - 1) / dvie::WA_SEG), (unsigned)H, (unsigned)B);
  dvie::window_attn_kernel<<<grid, dvie::WA_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16 *)q, (const bf16 *)k1, (const bf16 *)k2, (const bf16 *)v1, (const bf16 *)v2,
      (bf16 *)out, (float *)flow, H, W, win_h, win_w);
  return (int)cudaGetLastError();
}
