// K4: fused upsample-concat + dual-head 1x1 + lrelu + taps-in-N product:
//   cat = [p0, bf16(up2(p1)), bf16(up4(p2))]                   (448 ch)
//   h   = bf16(lrelu(cat . W1 + b1))                           (896 ch)
//   yt  = bf16(h . W2t)                                        (207 = 9*23 ch)
// Bilinear upsampling is the half-pixel, edge-clamped form of
// F.interpolate(mode="bilinear", align_corners=False).  Two modes, one
// kernel: with W2t (dvie_ups_head_taps) the output is yt and h never
// leaves shared memory; without it (dvie_ups_head_1x1) the output is h.
//
// Replaces ops/pallas_upshead.py:_pallas_impl (pallas_call at :342), the
// kernel of ups_head_taps_x0f4 and ups_head_taps (taps mode, the
// forward of the heads) and of ups_head_1x1 (:362, h mode: the h that the
// explicit backward _explicit_taps_bwd recomputes, :449).  With
// csrc/shiftadd.cu after it, it also covers ups_head_taps_fold (:817).  A
// third entry, dvie_dual_head_taps, runs the taps mode on one full-resolution
// part (C1 = C2 = 0: no upsampling): with the shift-add kernel after it, it
// replaces ops/pallas_head.py:fused_dual_head (pallas_call at :147).  The f4
// packing of p0 and the lane rolls of the TPU kernel are dropped.
//
// Bound on the H100 at the main-path shape (B=1, 512x1024): FLOPs
// 2*524288*(448*896 + 896*208) = 616 GFLOP (207 taps padded to 208); bytes
// p0 64 + p1 32 + p2 16 + yt 207 MiB = 319 MiB.  622 us of tensor cores at
// 989 TFLOP/s vs 100 us of HBM: compute-bound.  The 896-ch h (896 MiB at
// B=1) never reaches device memory, which is what the TPU kernel buys.
// h mode at the train recipe (24x128x128): 2*393216*448*896 = 316 GFLOP
// and 705 MB of h written: compute-bound (320 us vs 210 us at peak).
// Design: one block of 8 warps owns 128 consecutive pixels (each warp 16
// rows).  It builds the 448-ch concat in shared memory (p0 copied, p1/p2
// interpolated in f32 from 16-byte neighbour loads, rounded to bf16), then
// walks W1 in 14 chunks of 64 hidden channels: chunk GEMM (K=448, W1 fed in
// 64-row pieces by cp.async into a double buffer, the next piece in flight
// during the MMAs) -> +b1, lrelu, bf16 into shared h -> in taps mode,
// accumulate h . W2t[chunk] into per-warp 16x208 f32 fragments that live
// across all chunks (W2t's rows for the chunk arrive by cp.async during
// the chunk GEMM); in h mode, store the chunk of h.  The 128-pixel tile
// reads the 1.17 MB of weights once per 128 pixels (4.8 GB of L2 traffic
// per 512x1024 frame).  N=207 is padded to 208 in the weight copy the
// wrapper prepares, never in the output: yt keeps its 207-wide rows and
// leaves as one contiguous span per block.  216 KB of shared memory: one
// block of 8 warps per SM.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int TM = 128, NT = 256, KC = 64, CT_MAX = 448, N2P = 208;
constexpr int LDA = CT_MAX + 8, LDB = 64 + 8, LDC = 64 + 4, LDH = 64 + 8;
constexpr int LDW2 = N2P + 8, LDY = N2P + 4;
constexpr int OFF_W1 = align128(TM * LDA * 2);             // concat
constexpr int OFF_W2 = OFF_W1 + align128(2 * KC * LDB * 2);  // W1 double buffer
constexpr int OFF_C = OFF_W2 + align128(64 * LDW2 * 2);      // W2t chunk
constexpr int OFF_H = OFF_C + align128(NT / 32 * 16 * LDC * 4);
constexpr int SMEM = OFF_H + align128(TM * LDH * 2);
static_assert(TM * LDY * 4 <= OFF_W1, "yt staging must fit in the concat buffer");
static_assert(SMEM <= 232448, "shared memory per block");

__global__ void __launch_bounds__(NT, 1)
ups_head_taps_kernel(const bf16 *__restrict__ p0, const bf16 *__restrict__ p1,
                     const bf16 *__restrict__ p2, const bf16 *__restrict__ w1,
                     const float *__restrict__ b1, const bf16 *__restrict__ w2t,
                     bf16 *__restrict__ yt, bf16 *__restrict__ hout, int B, int H, int W,
                     int H1, int W1, int H2, int W2, int C0, int C1, int C2, int N1, int N2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *As = reinterpret_cast<bf16 *>(smem);
  bf16 *W1s = reinterpret_cast<bf16 *>(smem + OFF_W1);
  bf16 *W2s = reinterpret_cast<bf16 *>(smem + OFF_W2);
  float *Cw = reinterpret_cast<float *>(smem + OFF_C) + (threadIdx.x >> 5) * 16 * LDC;
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + OFF_H);
  float *Ys = reinterpret_cast<float *>(smem);  // reuses As after the last chunk

  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int CT = C0 + C1 + C2;
  const int nk = CT / KC;                 // W1 pieces per hidden chunk
  const int steps = (N1 / 64) * nk;       // W1 pieces in all
  const float sh1 = (float)H1 / H, sw1 = (float)W1 / W;
  const float sh2 = (float)H2 / H, sw2 = (float)W2 / W;

  // the first W1 piece flies while the concat is built
  load_block_async(W1s, LDB, w1, N1, KC, 64);
  cp_async_commit();

  // ---- the 448-ch concat of the pyramid at this tile's pixels
  for (int i = threadIdx.x; i < TM * (CT / 8); i += blockDim.x) {
    const int r = i / (CT / 8), g = (i % (CT / 8)) * 8;
    const long m = m0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m < M) {
      const int xx = (int)(m % W);
      const long t = m / W;
      const int yy = (int)(t % H);
      const long bb = t / H;
      if (g < C0)
        val = ldg16(p0 + m * C0 + g);
      else if (g < C0 + C1)
        val = bilerp8(p1, bb, H1, W1, C1, g - C0, yy, xx, sh1, sw1);
      else
        val = bilerp8(p2, bb, H2, W2, C2, g - C0 - C1, yy, xx, sh2, sw2);
    }
    st16(As + r * LDA + g, val);
  }

  FragC yacc[N2P / 16];
  zero(yacc);
  FragC hacc[4];
  int it = 0;
  for (int nc = 0; nc < N1 / 64; ++nc) {
    // W2t rows of this hidden chunk (padded to N2P columns by the wrapper);
    // the previous chunk's product finished before the barrier below
    if (w2t) load_block_async(W2s, LDW2, w2t + (long)nc * 64 * N2P, N2P, 64, N2P);
    cp_async_commit();
    zero(hacc);
    for (int kc = 0; kc < nk; ++kc, ++it) {
      if (it + 1 < steps) {
        const int nn = (it + 1) / nk, kk = (it + 1) % nk;
        load_block_async(W1s + ((it + 1) & 1) * KC * LDB, LDB,
                         w1 + (long)kk * KC * N1 + nn * 64, N1, KC, 64);
      }
      cp_async_commit();   // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // all but the newest group (the next piece) landed
      __syncthreads();
      warp_mma(hacc, As + row0 * LDA + kc * KC, LDA, W1s + (it & 1) * KC * LDB, LDB, KC / 16);
      __syncthreads();     // this buffer is refilled two steps on
    }
    // bias + lrelu + bf16 on this warp's own 16 rows, then h . W2t
    store(Cw, LDC, hacc);
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int r = i / 64, c = i % 64;
      Hs[(row0 + r) * LDH + c] = __float2bfloat16(lrelu(Cw[r * LDC + c] + b1[nc * 64 + c]));
    }
    __syncwarp();
    if (w2t) {
      warp_mma(yacc, Hs + row0 * LDH, LDH, W2s, LDW2, 64 / 16);
    } else {  // h mode: this warp's 16 rows of the chunk
      for (int i = lane; i < 16 * 8; i += 32) {
        const int r = i / 8, c = (i % 8) * 8;
        const long m = m0 + row0 + r;
        if (m < M)
          st16(hout + m * N1 + nc * 64 + c,
               *reinterpret_cast<const uint4 *>(Hs + (row0 + r) * LDH + c));
      }
    }
    __syncthreads();
  }
  if (!w2t) return;

  store(Ys + row0 * LDY, LDY, yacc);
  __syncthreads();
  const long rows = M - m0 < TM ? M - m0 : TM;
  for (long e = threadIdx.x; e < rows * N2; e += blockDim.x) {
    const int r = (int)(e / N2), c = (int)(e % N2);
    yt[m0 * N2 + e] = __float2bfloat16(Ys[r * LDY + c]);
  }
}

}  // namespace
}  // namespace dvie

namespace dvie {
namespace {

int launch(const void *p0, const void *p1, const void *p2, const void *w1, const void *b1,
           const void *w2t, void *yt, void *h, int B, int H, int W, int H1, int W1, int H2, int W2,
           int C0, int C1, int C2, int N1, int N2, void *stream) {
  cudaError_t e = cudaFuncSetAttribute(ups_head_taps_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const long M = (long)B * H * W;
  dim3 grid((unsigned)((M + TM - 1) / TM));
  ups_head_taps_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      (const bf16 *)p0, (const bf16 *)p1, (const bf16 *)p2, (const bf16 *)w1,
      (const float *)b1, (const bf16 *)w2t, (bf16 *)yt, (bf16 *)h, B, H, W, H1, W1, H2, W2, C0,
      C1, C2, N1, N2);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// p0 (B,H,W,C0), p1 (B,H1,W1,C1), p2 (B,H2,W2,C2), w1 (C0+C1+C2, N1) bf16,
// b1 (N1,) f32, w2t (N1, 208) bf16 (the taps matrix zero-padded from N2
// columns), yt (B,H,W,N2) bf16.  C0, C1, C2 % 8 == 0, (C0+C1+C2) % 64 == 0
// and <= 448, N1 % 64 == 0, N2 <= 208 (checked by the Python wrapper).
extern "C" int dvie_ups_head_taps(const void *p0, const void *p1, const void *p2, const void *w1,
                                  const void *b1, const void *w2t, void *yt, int B, int H, int W,
                                  int H1, int W1, int H2, int W2, int C0, int C1, int C2, int N1,
                                  int N2, void *stream) {
  return dvie::launch(p0, p1, p2, w1, b1, w2t, yt, nullptr, B, H, W, H1, W1, H2, W2, C0, C1, C2,
                      N1, N2, stream);
}

// h mode: the same pyramid, w1 and b1; h (B,H,W,N1) bf16.
extern "C" int dvie_ups_head_1x1(const void *p0, const void *p1, const void *p2, const void *w1,
                                 const void *b1, void *h, int B, int H, int W, int H1, int W1,
                                 int H2, int W2, int C0, int C1, int C2, int N1, void *stream) {
  return dvie::launch(p0, p1, p2, w1, b1, nullptr, nullptr, h, B, H, W, H1, W1, H2, W2, C0, C1,
                      C2, N1, 0, stream);
}

// The dual head of ops/pallas_head.fused_dual_head: the taps mode on one
// full-resolution part feat (B,H,W,C), C % 64 == 0 and <= 448; w1 (C, N1)
// bf16, b1 (N1,) f32, w2t (N1, 208) bf16, yt (B,H,W,N2) bf16.  The pyramid's
// other two parts have no channels, so every concat row is a copy of feat.
extern "C" int dvie_dual_head_taps(const void *feat, const void *w1, const void *b1,
                                   const void *w2t, void *yt, int B, int H, int W, int C, int N1,
                                   int N2, void *stream) {
  return dvie::launch(feat, feat, feat, w1, b1, w2t, yt, nullptr, B, H, W, H, W, H, W, C, 0, 0,
                      N1, N2, stream);
}
