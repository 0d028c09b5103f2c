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
//
// Design: a back-to-back GEMM on wgmma (hopper.cuh).  A persistent block
// of two consumer warpgroups and one producer warp walks 128-pixel tiles;
// each warpgroup owns 64 pixel rows.
// - The concat is built in shared memory by the consumers (p0 copied,
//   p1/p2 interpolated in f32 from 16-byte neighbour loads (Bil, bil8),
//   rounded to bf16) straight into the no-swizzle K-major core-matrix
//   layout (8 pixels x 8 channels per 128 bytes), so the first product
//   reads A by descriptor (wgmma with both operands in shared memory).
// - W1 streams through a 4-slot ring in units of 64 input x 64 hidden
//   channels (8 KB), W2t (zero-padded to 208 columns) in chunks of 64
//   hidden rows x 208 (26 KB) through a 2-slot ring, both by bulk TMA
//   copies under full/empty mbarriers from the producer warp, in the order
//   the consumers take them (the wrapper lays the weights out so).
// - Per 64 hidden channels: hacc (64x64 f32) = cat . W1[:, chunk] over
//   CT/64 units; bias, lrelu and the bf16 rounding in registers; the
//   accumulators become the A operand of the second product in registers
//   (FA3's P.V, acc_to_a), yacc (64x208 f32, 104 registers a thread) +=
//   h . W2t[chunk] by four wgmma m64n208k16, left in flight while the next
//   chunk's first product runs.  yacc lives across all chunks; at the end
//   it is rounded, staged in the concat's room and leaves as one
//   contiguous span of yt (207 columns).
// - h mode (no W2t): each chunk of h goes through a small staging buffer
//   to 16-byte stores.
// - The taps and h modes are two instantiations: no wgmma sits under a
//   branch.
//
// Prediction (written before the first chip run of this design, NVIDIA
// H100 at 700 W): taps at B=1 512x1024 from 6.71 to 1.2-2.6 ms (20-45% of
// the bf16 peak); h mode at 24x128x128 from 3.96 to 0.8-1.6 ms.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;

constexpr int TM = 128, NWG = 2, CT = NWG * 128, NT = CT + 32;
constexpr int CT_MAX = 448, N2P = 208;
constexpr int UB1 = 64 * 64 * 2, NS1 = 4;     // a W1 unit; its ring slots
constexpr int UB2 = 64 * N2P * 2, NS2 = 2;    // a W2t chunk; its ring slots
constexpr int LDH = 64 + 8;                   // h mode staging pitch
constexpr int O_R1 = TM * CT_MAX * 2;         // after the concat
constexpr int O_R2 = O_R1 + NS1 * UB1;
constexpr int O_BAR = O_R2 + NS2 * UB2;
constexpr int SMEM = O_BAR + 2 * (NS1 + NS2) * 8;
static_assert(SMEM <= 232448, "shared memory per block");
static_assert(NWG * 64 * LDH * 2 <= NS2 * UB2, "h staging fits the W2t ring");

// the four neighbours (element offsets of their channel 0) and weights of
// the bilinear sample of (B,Hi,Wi,C) at output pixel (yy, xx) of image b:
// F.interpolate's half-pixel, edge-clamped rule (align_corners=False),
// split so the taps are found once
struct Bil {
  long o00, o01, o10, o11;
  float ly, lx;
};

__device__ __forceinline__ Bil bil_at(long b, int Hi, int Wi, int C, int yy, int xx, float sh,
                                      float sw) {
  const float fy = fmaxf((yy + 0.5f) * sh - 0.5f, 0.f);
  const float fx = fmaxf((xx + 0.5f) * sw - 0.5f, 0.f);
  const int y0 = min((int)fy, Hi - 1), x0 = min((int)fx, Wi - 1);
  const int y1 = min(y0 + 1, Hi - 1), x1 = min(x0 + 1, Wi - 1);
  const long base = b * Hi * Wi;
  Bil q;
  q.o00 = (base + (long)y0 * Wi + x0) * C;
  q.o01 = (base + (long)y0 * Wi + x1) * C;
  q.o10 = (base + (long)y1 * Wi + x0) * C;
  q.o11 = (base + (long)y1 * Wi + x1) * C;
  q.ly = fy - y0;
  q.lx = fx - x0;
  return q;
}

// channels [c, c+8) of that sample, rounded to bf16
__device__ __forceinline__ uint4 bil8(const bf16 *__restrict__ src, const Bil &q, int c) {
  float a[8], b[8], cq[8], d[8], o[8];
  unpack8(ldg16(src + q.o00 + c), a);
  unpack8(ldg16(src + q.o01 + c), b);
  unpack8(ldg16(src + q.o10 + c), cq);
  unpack8(ldg16(src + q.o11 + c), d);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    o[k] = (1.f - q.ly) * ((1.f - q.lx) * a[k] + q.lx * b[k]) +
           q.ly * ((1.f - q.lx) * cq[k] + q.lx * d[k]);
  return pack8(o);
}

template <bool TAPS>
__global__ void __launch_bounds__(NT, 1)
ups_head_kernel(const bf16 *__restrict__ p0, const bf16 *__restrict__ p1,
                const bf16 *__restrict__ p2, const bf16 *__restrict__ w1u,
                const float *__restrict__ b1, const bf16 *__restrict__ w2u,
                bf16 *__restrict__ out, int B, int H, int W, int H1, int W1, int H2, int W2,
                int C0, int C1, int C2, int N1, int N2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full1 = reinterpret_cast<uint64_t *>(smem + O_BAR), *empty1 = full1 + NS1;
  uint64_t *full2 = empty1 + NS1, *empty2 = full2 + NS2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long M = (long)B * H * W;
  const int nt = (int)((M + TM - 1) / TM);
  const int CTc = C0 + C1 + C2, NKU = CTc / 64, NCH = N1 / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 4 * NWG);
    }
    for (int s = 0; s < NS2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer: W1 units, then the chunk's W2t rows
    if (lane == 0) {
      int q1 = 0, q2 = 0;
      for (int t = blockIdx.x; t < nt; t += gridDim.x)
        for (int nc = 0; nc < NCH; ++nc) {
          for (int u = 0; u < NKU; ++u, ++q1) {
            const int s = q1 % NS1;
            mbar_wait(&empty1[s], ((q1 / NS1) & 1) ^ 1);
            mbar_expect_tx(&full1[s], UB1);
            bulk_load(smem + O_R1 + s * UB1, w1u + ((long)nc * NKU + u) * (UB1 / 2), UB1,
                      &full1[s]);
          }
          if (TAPS) {
            const int s = q2 % NS2;
            mbar_wait(&empty2[s], ((q2 / NS2) & 1) ^ 1);
            mbar_expect_tx(&full2[s], UB2);
            bulk_load(smem + O_R2 + s * UB2, w2u + (long)nc * (UB2 / 2), UB2, &full2[s]);
            ++q2;
          }
        }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, ct = threadIdx.x;
  const uint32_t cat = smem_u32(smem), r1 = smem_u32(smem + O_R1), r2 = smem_u32(smem + O_R2);
  const float sh1 = (float)H1 / H, sw1 = (float)W1 / W;
  const float sh2 = (float)H2 / H, sw2 = (float)W2 / W;
  const int lrow = wq * 16 + (lane >> 2), ec = 2 * (lane & 3);  // accumulator row, column
  bf16 *Hst = reinterpret_cast<bf16 *>(smem + O_R2) + wg * 64 * LDH;  // h mode staging
  int q1 = 0, q2 = 0;
  float yacc[TAPS ? 104 : 1];

  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x) {
    const long m0 = (long)ti * TM;
    bar_sync(1, CT);  // the previous tile is done with the concat's room
    // ---- the concat at this tile's pixels: core matrix (channel group g,
    // 8 pixels) at (g * TM + pixel) * 16 bytes.  Thread ct always builds
    // pixel ct % TM, so its coordinates and bilinear taps are found once;
    // each part is its own unrolled loop, so several 16-byte loads fly at
    // once.
    {
      const int r = ct % TM, g0 = ct / TM;
      const long m = m0 + r;
      const bool ok = m < M;
      const long mm = ok ? m : 0;
      const int xx = (int)(mm % W), yy = (int)((mm / W) % H);
      const long bb = mm / W / H;
      unsigned char *row = smem + (long)r * 16;
      const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 4
      for (int g = g0; g < C0 / 8; g += CT / TM)
        *reinterpret_cast<uint4 *>(row + (long)g * TM * 16) = ok ? ldg16(p0 + mm * C0 + g * 8) : zero;
      if (C1) {
        const Bil q = bil_at(bb, H1, W1, C1, yy, xx, sh1, sw1);
#pragma unroll 4
        for (int g = g0; g < C1 / 8; g += CT / TM)
          *reinterpret_cast<uint4 *>(row + (long)(C0 / 8 + g) * TM * 16) =
              ok ? bil8(p1, q, g * 8) : zero;
      }
      if (C2) {
        const Bil q = bil_at(bb, H2, W2, C2, yy, xx, sh2, sw2);
#pragma unroll 4
        for (int g = g0; g < C2 / 8; g += CT / TM)
          *reinterpret_cast<uint4 *>(row + (long)((C0 + C1) / 8 + g) * TM * 16) =
              ok ? bil8(p2, q, g * 8) : zero;
      }
    }
    fence_async_smem();  // the concat is read by wgmma
    bar_sync(1, CT);

    if constexpr (TAPS) {
#pragma unroll
      for (int i = 0; i < 104; ++i) yacc[i] = 0.f;
    }
    const uint32_t abase = cat + wg * 64 * 16;
#pragma unroll 1
    for (int nc = 0; nc < NCH; ++nc) {
      float hacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
#pragma unroll 1
      for (int u = 0; u < NKU; ++u, ++q1) {
        const int s = q1 % NS1;
        mbar_wait(&full1[s], (q1 / NS1) & 1);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma64ss<0>(hacc, desc(abase + (4 * u + j) * 2 * TM * 16, TM * 16, 128),
                       desc(r1 + s * UB1 + j * 2048, 1024, 128));
        wg_commit();
        wg_wait<1>();
        mbar_arrive_if(&empty1[(q1 + NS1 - 1) % NS1], u > 0 && lane == 0);
        // the previous chunk's taps product is done: its W2t slot is free
        mbar_arrive_if(&empty2[(q2 + NS2 - 1) % NS2], TAPS && u == 0 && nc > 0 && lane == 0);
      }
      wg_wait<0>();
      fence_acc(hacc);
      mbar_arrive_if(&empty1[(q1 + NS1 - 1) % NS1], lane == 0);
      // h = bf16(lrelu(hacc + b1)) in registers
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = *reinterpret_cast<const float2 *>(b1 + nc * 64 + 8 * j + ec);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          hacc[4 * j + 2 * hh] = rbf(lrelu(hacc[4 * j + 2 * hh] + b.x));
          hacc[4 * j + 2 * hh + 1] = rbf(lrelu(hacc[4 * j + 2 * hh + 1] + b.y));
        }
      }
      if constexpr (TAPS) {  // yacc += h . W2t[chunk], left in flight
        uint32_t ha[4][4];
        acc_to_a(ha, hacc);
        const int s = q2 % NS2;
        mbar_wait(&full2[s], (q2 / NS2) & 1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma208(yacc, ha[kk], desc(r2 + s * UB2 + kk * 2 * N2P * 16, N2P * 16, 128));
        wg_commit();
        ++q2;
      } else {  // h mode: this warpgroup's 64 rows of the chunk
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162 *>(Hst + (lrow + 8 * hh) * LDH + 8 * j + ec) =
                __floats2bfloat162_rn(hacc[4 * j + 2 * hh], hacc[4 * j + 2 * hh + 1]);
        bar_sync(2 + wg, 128);
        for (int i = ct % 128; i < 64 * 8; i += 128) {
          const int r = i / 8, v = (i % 8) * 8;
          const long m = m0 + wg * 64 + r;
          if (m < M)
            st16(out + m * N1 + nc * 64 + v, *reinterpret_cast<const uint4 *>(Hst + r * LDH + v));
        }
        bar_sync(2 + wg, 128);
      }
    }
    if constexpr (TAPS) {
      wg_wait<0>();
      fence_acc(yacc);
      mbar_arrive_if(&empty2[(q2 + NS2 - 1) % NS2], lane == 0);
      bar_sync(1, CT);  // both warpgroups are done reading the concat
      bf16 *Ys = reinterpret_cast<bf16 *>(smem);  // yt rows, as in device memory
#pragma unroll
      for (int j = 0; j < 26; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wg * 64 + lrow + 8 * hh, c = 8 * j + ec;
          if (c < N2) Ys[r * N2 + c] = __float2bfloat16(yacc[4 * j + 2 * hh]);
          if (c + 1 < N2) Ys[r * N2 + c + 1] = __float2bfloat16(yacc[4 * j + 2 * hh + 1]);
        }
      bar_sync(1, CT);
      const long rows = M - m0 < TM ? M - m0 : TM;
      const long n = rows * N2, nv = n / 8;  // the span starts 16-byte aligned
      for (long e = ct; e < nv; e += CT)
        st16(out + m0 * N2 + e * 8, reinterpret_cast<const uint4 *>(Ys)[e]);
      for (long e = nv * 8 + ct; e < n; e += CT) out[m0 * N2 + e] = Ys[e];
    }
  }
}

int launch(const void *p0, const void *p1, const void *p2, const void *w1u, const void *b1,
           const void *w2u, void *out, int B, int H, int W, int H1, int W1, int H2, int W2,
           int C0, int C1, int C2, int N1, int N2, void *stream) {
  auto kern = w2u ? ups_head_kernel<true> : ups_head_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long M = (long)B * H * W;
  const long tiles = (M + TM - 1) / TM;
  kern<<<(unsigned)(tiles < sms ? tiles : sms), NT, SMEM, (cudaStream_t)stream>>>(
      (const bf16 *)p0, (const bf16 *)p1, (const bf16 *)p2, (const bf16 *)w1u, (const float *)b1,
      (const bf16 *)w2u, (bf16 *)out, B, H, W, H1, W1, H2, W2, C0, C1, C2, N1, N2);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// p0 (B,H,W,C0), p1 (B,H1,W1,C1), p2 (B,H2,W2,C2) bf16; w1u: W1 (C0+C1+C2,
// N1) as (N1/64, CT/64, 8, 64, 8) bf16 units (ops/upshead.py: w1_units);
// b1 (N1,) f32; w2u: the taps matrix zero-padded to 208 columns as
// (N1/64, 8, 208, 8) bf16 chunks (w2_chunks); yt (B,H,W,N2) bf16.  C0, C1,
// C2 % 8 == 0, (C0+C1+C2) % 64 == 0 and <= 448, N1 % 64 == 0, N2 <= 208
// (checked by the Python wrapper).
extern "C" int dvie_ups_head_taps(const void *p0, const void *p1, const void *p2, const void *w1u,
                                  const void *b1, const void *w2u, void *yt, int B, int H, int W,
                                  int H1, int W1, int H2, int W2, int C0, int C1, int C2, int N1,
                                  int N2, void *stream) {
  return dvie::launch(p0, p1, p2, w1u, b1, w2u, yt, B, H, W, H1, W1, H2, W2, C0, C1, C2, N1, N2,
                      stream);
}

// h mode: the same pyramid, w1u and b1; h (B,H,W,N1) bf16.
extern "C" int dvie_ups_head_1x1(const void *p0, const void *p1, const void *p2, const void *w1u,
                                 const void *b1, void *h, int B, int H, int W, int H1, int W1,
                                 int H2, int W2, int C0, int C1, int C2, int N1, void *stream) {
  return dvie::launch(p0, p1, p2, w1u, b1, nullptr, h, B, H, W, H1, W1, H2, W2, C0, C1, C2, N1, 0,
                      stream);
}

// The dual head of ops/pallas_head.fused_dual_head: the taps mode on one
// full-resolution part feat (B,H,W,C), C % 64 == 0 and <= 448; w1u, b1, w2u
// as dvie_ups_head_taps with CT = C; yt (B,H,W,N2) bf16.  The pyramid's
// other two parts have no channels, so every concat row is a copy of feat.
extern "C" int dvie_dual_head_taps(const void *feat, const void *w1u, const void *b1,
                                   const void *w2u, void *yt, int B, int H, int W, int C, int N1,
                                   int N2, void *stream) {
  return dvie::launch(feat, feat, feat, w1u, b1, w2u, yt, B, H, W, H, W, H, W, C, 0, 0, N1, N2,
                      stream);
}
