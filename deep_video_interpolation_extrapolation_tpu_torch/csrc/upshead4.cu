// The 4-part head of --highres_large: fused upsample-concat + dual-head
// 1x1 + lrelu + taps-in-N product over the stage-4 pyramid:
//   cat = [p0, bf16(up2(p1)), bf16(up4(p2)), bf16(up8(p3))]   (64+128+256+512 = 960 ch)
//   h   = lrelu(bf16(bf16(cat . W1) + bf16(b1)))               (1920 ch)
//   yt  = bf16(h . W2t)                                        (207 = 9*23 ch)
// rounded where ops/pallas_upshead.py:_ups_head_taps_ref4 rounds, with
// F.interpolate's half-pixel, edge-clamped bilinear rule.
//
// Replaces ops/pallas_upshead.py:ups_head_taps4 (_pallas_impl4, pallas_call
// at :1096).  Its backward (_bwd_taps4) is the vjp of the XLA reference, so
// the port's backward is autograd of the plain version (ops/upshead.py).
// The TPU kernel's f8 column packing, lane rolls and per-phase blend tables
// exist for the 128-lane VMEM layout and are dropped; its pre-dot (p2 and
// p3 multiplied by their W1 rows at low resolution, then expanded) is not
// taken here: it rounds differently from the plain version and needs the
// expanded f32 partial sums of two parts per hidden chunk.
//
// Bound on the H100 at the main-path shape (B=1, 512x1024, M = 524,288
// pixels): 2*M*(960*1920 + 1920*208) = 2.35 TFLOP as written (207 taps
// padded to 208); bytes p0 64 + p1 32 + p2 16 + p3 8 + yt 207 MiB = 327 MiB.
// 2.4 ms of tensor cores at 989 TFLOP/s vs 0.1 ms of HBM: compute-bound.
// The 1920-ch h (2 GB at B=1) and the 960-ch concat (1 GB) never reach
// device memory.
// Design.  K4 (upshead.cu) stages the whole concat of a 128-pixel tile in
// shared memory; at 960 channels that is 128 x 968 x 2 = 242 KB, over the
// 227 KB a block may have.  Here a block of 8 warps owns 64 consecutive
// pixels: the concat is 121 KB (p0 copied, p1..p3 interpolated in f32 from
// 16-byte neighbour loads, rounded to bf16).  The block walks W1 in 30
// chunks of 64 hidden channels: chunk GEMM (K = 960 in 15 pieces of 64
// rows, double-buffered by cp.async; warp w computes rows 16*(w%4) and
// hidden columns 32*(w/4) of the chunk) -> +b1, lrelu, bf16 into a shared
// 64x64 h chunk -> h . W2t[chunk] into f32 yt fragments that stay live
// across all chunks (warp w: rows 16*(w%4), tap columns 0-111 or 112-207),
// W2t's 64 rows of the chunk arriving by cp.async during the chunk GEMM.
// 193 KB of shared memory: one block per SM.  Each 64-pixel tile reads the
// 4.5 MB of weights once, from L2: 37 GB of L2 traffic per 512x1024 frame.
// Prediction (written before the first run): WMMA at about K4's rate
// (92 TFLOP/s at B=1 512x1024) less the halved tile: 30-40 ms per frame.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int TM = 64, NT = 256, KC = 64, CT_MAX = 960, N2P = 208;
constexpr int LDA = CT_MAX + 8, LDB = 64 + 8, LDC = 32 + 4, LDH = 64 + 8;
constexpr int LDW2 = N2P + 8, LDY = N2P + 4;
constexpr int NY = 7;                  // yt fragments per warp: 7 + 6 = 13 = 208 / 16
constexpr int OFF_W1 = align128(TM * LDA * 2);             // concat
constexpr int OFF_W2 = OFF_W1 + align128(2 * KC * LDB * 2);  // W1 double buffer
constexpr int OFF_C = OFF_W2 + align128(64 * LDW2 * 2);      // W2t chunk
constexpr int OFF_H = OFF_C + align128(NT / 32 * 16 * LDC * 4);
constexpr int SMEM = OFF_H + align128(TM * LDH * 2);
static_assert(TM * LDY * 4 <= OFF_W1, "yt staging must fit in the concat buffer");
static_assert(SMEM <= 232448, "shared memory per block");

__global__ void __launch_bounds__(NT, 1)
ups_head_taps4_kernel(const bf16 *__restrict__ p0, const bf16 *__restrict__ p1,
                      const bf16 *__restrict__ p2, const bf16 *__restrict__ p3,
                      const bf16 *__restrict__ w1, const float *__restrict__ b1,
                      const bf16 *__restrict__ w2t, bf16 *__restrict__ yt, int B, int H, int W,
                      int H1, int W1, int H2, int W2, int H3, int W3, int C0, int C1, int C2,
                      int C3, int N1, int N2) {
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
  const int row0 = (warp & 3) * 16;      // this warp's 16 pixels
  const int hc0 = (warp >> 2) * 32;      // its hidden columns of a chunk
  const int j0 = (warp >> 2) * NY;       // its first yt fragment
  const int nj = (warp >> 2) ? N2P / 16 - NY : NY;
  const int CT = C0 + C1 + C2 + C3;
  const int nk = CT / KC;                // W1 pieces per hidden chunk
  const int steps = (N1 / 64) * nk;      // W1 pieces in all
  const float sh1 = (float)H1 / H, sw1 = (float)W1 / W;
  const float sh2 = (float)H2 / H, sw2 = (float)W2 / W;
  const float sh3 = (float)H3 / H, sw3 = (float)W3 / W;

  // the first W1 piece flies while the concat is built
  load_block_async(W1s, LDB, w1, N1, KC, 64);
  cp_async_commit();

  // ---- the concat of the pyramid at this tile's pixels
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
      else if (g < C0 + C1 + C2)
        val = bilerp8(p2, bb, H2, W2, C2, g - C0 - C1, yy, xx, sh2, sw2);
      else
        val = bilerp8(p3, bb, H3, W3, C3, g - C0 - C1 - C2, yy, xx, sh3, sw3);
    }
    st16(As + r * LDA + g, val);
  }

  FragC yacc[NY];
  zero(yacc);
  FragC hacc[2];
  int it = 0;
  for (int nc = 0; nc < N1 / 64; ++nc) {
    // W2t rows of this hidden chunk (padded to N2P columns by the wrapper);
    // the previous chunk's product finished before the barrier below
    load_block_async(W2s, LDW2, w2t + (long)nc * 64 * N2P, N2P, 64, N2P);
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
      warp_mma(hacc, As + row0 * LDA + kc * KC, LDA, W1s + (it & 1) * KC * LDB + hc0, LDB,
               KC / 16);
      __syncthreads();     // this buffer is refilled two steps on
    }
    // bf16, + b1 in bf16, lrelu on this warp's 16 x 32 of the chunk
    store(Cw, LDC, hacc);
    __syncwarp();
    for (int i = lane; i < 16 * 32; i += 32) {
      const int r = i / 32, c = i % 32;
      const float v = rbf(rbf(Cw[r * LDC + c]) + rbf(b1[nc * 64 + hc0 + c]));
      Hs[(row0 + r) * LDH + hc0 + c] = __float2bfloat16(lrelu_bf(v));
    }
    __syncthreads();       // the chunk's 64 h columns of every row are in
    {
      FragA a;
      FragB b;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::load_matrix_sync(a, Hs + row0 * LDH + kk * 16, LDH);
#pragma unroll
        for (int j = 0; j < NY; ++j) {
          if (j < nj) {
            wmma::load_matrix_sync(b, W2s + kk * 16 * LDW2 + (j0 + j) * 16, LDW2);
            wmma::mma_sync(yacc[j], a, b, yacc[j]);
          }
        }
      }
    }
    __syncthreads();       // Hs and W2s are refilled by the next chunk
  }

#pragma unroll
  for (int j = 0; j < NY; ++j)
    if (j < nj)
      wmma::store_matrix_sync(Ys + row0 * LDY + (j0 + j) * 16, yacc[j], LDY,
                              wmma::mem_row_major);
  __syncthreads();
  const long rows = M - m0 < TM ? M - m0 : TM;
  for (long e = threadIdx.x; e < rows * N2; e += blockDim.x) {
    const int r = (int)(e / N2), c = (int)(e % N2);
    yt[m0 * N2 + e] = __float2bfloat16(Ys[r * LDY + c]);
  }
}

}  // namespace
}  // namespace dvie

// p0 (B,H,W,C0), p1 (B,H1,W1,C1), p2 (B,H2,W2,C2), p3 (B,H3,W3,C3),
// w1 (C0+C1+C2+C3, N1) bf16, b1 (N1,) f32, w2t (N1, 208) bf16 (the taps
// matrix zero-padded from N2 columns), yt (B,H,W,N2) bf16.  Every Ci % 8
// == 0, C0+C1+C2+C3 % 64 == 0 and <= 960, N1 % 64 == 0, N2 <= 208
// (checked by the Python wrapper).
extern "C" int dvie_ups_head_taps4(const void *p0, const void *p1, const void *p2,
                                   const void *p3, const void *w1, const void *b1,
                                   const void *w2t, void *yt, int B, int H, int W, int H1, int W1,
                                   int H2, int W2, int H3, int W3, int C0, int C1, int C2, int C3,
                                   int N1, int N2, void *stream) {
  using dvie::bf16;
  cudaError_t e = cudaFuncSetAttribute(dvie::ups_head_taps4_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, dvie::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long M = (long)B * H * W;
  dim3 grid((unsigned)((M + dvie::TM - 1) / dvie::TM));
  dvie::ups_head_taps4_kernel<<<grid, dvie::NT, dvie::SMEM, (cudaStream_t)stream>>>(
      (const bf16 *)p0, (const bf16 *)p1, (const bf16 *)p2, (const bf16 *)p3, (const bf16 *)w1,
      (const float *)b1, (const bf16 *)w2t, (bf16 *)yt, B, H, W, H1, W1, H2, W2, H3, W3, C0, C1,
      C2, C3, N1, N2);
  return (int)cudaGetLastError();
}
