// The 4-part head of --highres_large: fused upsample-concat + dual-head
// 1x1 + lrelu + taps-in-N product over the stage-4 pyramid:
//   cat = [p0, bf16(up2(p1)), bf16(up4(p2)), bf16(up8(p3))]   (64+128+256+512 = 960 ch)
//   h   = lrelu(bf16(bf16(cat . W1) + bf16(b1)))               (1920 ch)
//   yt  = bf16(h . W2t)                                        (207 = 9*23 ch)
// rounded where ops/pallas_upshead.py:_ups_head_taps_ref4 rounds, with
// F.interpolate's half-pixel, edge-clamped bilinear rule.
//
// Replaces ops/pallas_upshead.py:ups_head_taps4 (_pallas_impl4, pallas_call
// at :1096) in both its modes: taps (yt, the forward of the heads) and h
// (w2t=None: h itself, 1920 channels in bf16, written to device memory),
// which the port's explicit backward (ops/upshead.py: ups_head_taps4_bwd)
// recomputes h with.  The JAX backward (_bwd_taps4) is the vjp of the XLA
// reference: its products run outside any Pallas kernel, and so do the
// port's (library products on bf16 operands).
// The TPU kernel's f8 column packing, lane rolls and per-phase blend tables
// exist for the 128-lane VMEM layout and are dropped; its pre-dot (p2 and
// p3 multiplied by their W1 rows at low resolution, then expanded) is not
// taken here: it rounds differently from the plain version.
//
// Bound on the H100 at the main-path shape (B=1, 512x1024, M = 524,288
// pixels): 2*M*(960*1920 + 1920*208) = 2.35 TFLOP as written (207 taps
// padded to 208), 2.14 TFLOP on W2t's nonzero blocks (the yardstick of
// chip_smoke.bound): 2.16 ms of tensor cores at 989 TFLOP/s against 0.1 ms
// of HBM (p0 64 + p1 32 + p2 16 + p3 8 + yt 207 MiB).  The 1920-ch h and
// the 960-ch concat never reach device memory.
//
// Design: K4's back-to-back GEMM on wgmma (upshead.cu), at 960 -> 1920.
// - A persistent block of two consumer warpgroups and a producer warpgroup
//   (one thread of it issues the copies) walks 64-pixel tiles; setmaxnreg
//   moves registers from the producer (40 a thread) to the consumers (232),
//   whose yacc, hacc and h fragments need more than the 168 a thread of an
//   even split (ptxas serializes the wgmmas otherwise, C7512).
// - The concat of a tile (64 x 960 bf16, 122,880 B) is built once by the
//   consumers straight into the no-swizzle K-major core-matrix layout (p0
//   copied, p1..p3 interpolated in f32 from 16-byte neighbour loads, K4's
//   Bil/bil8), and the first product reads it by descriptor.  A 128-pixel concat (245,760 B) would not fit a block.
// - Both warpgroups share the 64 pixel rows and split the 30 hidden chunks
//   of 64: warpgroup 0 takes the even chunks, warpgroup 1 the odd ones.
//   Per chunk: hacc (64x64 f32) = cat . W1[:, chunk] over 15 units of 64
//   input channels; bias, bf16 rounding and lrelu in registers; acc_to_a;
//   yacc (64x208 f32, 104 registers) += h . W2t[chunk] by four wgmma
//   m64n208k16, left in flight while the next chunk's first product runs.
//   At the end of a tile the two yaccs are summed in f32 through the
//   concat's room, rounded once and stored as one contiguous span of yt.
// - Weights: W1 units (64 x 64, 8 KB) through a 6-slot ring, W2t chunks
//   (64 hidden rows x 208, 26 KB) through a 2-slot ring, by bulk TMA copies
//   under full/empty mbarriers from the producer, in the order the
//   consumers take them: W1 units of chunks 2p and 2p+1 interleaved (even
//   slots warpgroup 0's, odd ones warpgroup 1's), the pair's two W2t
//   chunks after its W1 unit pair IW2, so a W2t chunk lands while its
//   chunk's first product runs (ops/upshead.py: w1_units4, w2_chunks).
// - Every 64-pixel tile streams the 4.5 MB of weights from L2 (~37 GB a
//   512x1024 frame, ~5.7 TB/s at 6.5 ms), which does not bound it: on half
//   the SMs the kernel took 1.9x as long, and with a 4-slot W1 ring 1.14x
//   (H100 at 700 W).  A cluster of two blocks on neighbouring SMs, each
//   with its own tile and every W1 unit and W2t chunk multicast into both
//   by one bulk copy, halves that traffic but ran slower: 8.68 ms against
//   6.64 (8.61 and 6.47 on the card alone; one call).  It is not kept.
// - No wgmma under a thread-dependent branch (C7518).
// - The taps width is a template parameter, N2P in {208, 216}: 208 takes a
//   head of 23 channels (rgb 3 + seg 20), 216 one of 24 (ExtraInpaintNet's
//   rgb 3 + mask 1 + seg 20 under --inpaint_mask; dvie_ups_head_taps4_n216)
//   by wgmma m64n216k16, 108 accumulator registers a thread and a 27 KB W2t
//   chunk: 227,456 B of shared memory against 225,408 (the yt staging,
//   82,944 B, in the concat's 122,880).  The 208 instance is the code it
//   was.
// - h mode (TAPS = false, dvie_ups_head_1x1_4): no W2t; each warpgroup's
//   chunk of h goes through a staging buffer in the W2t ring's room to
//   16-byte stores.  At the train recipe (24x128x128, M = 393,216): 1.45
//   TFLOP, 1.47 ms of tensor cores against 0.45 ms of HBM (h 1.45 GiB).
//   The two modes are two instantiations: no wgmma sits under a branch.
//
// Prediction (written before the first chip run of this design, NVIDIA
// H100 at 700 W): 27.24 -> 6-10 ms at B=1 512x1024 without the cluster
// (22-36% of the bf16 peak), 4.5-7 ms with it; --highres_large serving
// 24.4 -> 38-50 frames/s.  Measured (the same card): 6.47 ms on the card
// alone, 33% of the peak, without the cluster.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;

constexpr int TM = 64, NWG = 2, CT = NWG * 128, NT = CT + 128;
constexpr int R_CONS = 232, R_PROD = 40;  // registers a thread after setmaxnreg
constexpr int CT_MAX = 960;
constexpr int UB1 = 64 * 64 * 2, NS1 = 6;     // a W1 unit; its ring slots (3 a warpgroup)
constexpr int NS2 = NWG;                      // the W2t ring: one slot a warpgroup
constexpr int IW2 = 4;                        // a pair's W2t chunks follow its W1 unit pair IW2
constexpr int O_R1 = TM * CT_MAX * 2;         // after the concat
constexpr int O_R2 = O_R1 + NS1 * UB1;
constexpr int LDH = 64 + 8;                   // h mode staging pitch

// The layout of an instance whose taps matrix is padded to N2P columns
// (208: 9 x 23 = 207; 216: 9 x 24): a W2t chunk of 64 hidden rows (26 or
// 27 KB), the barriers after the ring, the dynamic shared memory (225,408
// or 227,456 B), the bf16 yt rows after the f32 staging.
template <int N2P>
struct Lay {
  static constexpr int UB2 = 64 * N2P * 2;
  static constexpr int O_BAR = O_R2 + NS2 * UB2;
  static constexpr int SMEM = O_BAR + 2 * (NS1 + NS2) * 8;
  static constexpr int O_YB = TM * N2P * 4;
  static_assert(N2P == 208 || N2P == 216, "wgmma208 or wgmma216");
  static_assert(SMEM <= 232448, "shared memory per block");
  static_assert(O_YB + TM * N2P * 2 <= O_R1, "yt staging fits the concat's room");
  static_assert(NWG * 64 * LDH * 2 <= NS2 * UB2, "h staging fits the W2t ring");
};

// ---- the bilinear taps (K4's) -------------------------------------------------

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

// one upsampled part of the concat: channel groups g0, g0 + 4, ... of part
// (src, Hi, Wi, C) at pixel (bb, yy, xx) into `row` from group `gbase` on
__device__ __forceinline__ void cat_part(unsigned char *row, const bf16 *__restrict__ src, long bb,
                                         int Hi, int Wi, int C, int yy, int xx, int H, int W,
                                         int g0, int gbase, bool ok) {
  const Bil q = bil_at(bb, Hi, Wi, C, yy, xx, (float)Hi / H, (float)Wi / W);
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int g = g0; g < C / 8; g += CT / TM)
    *reinterpret_cast<uint4 *>(row + (long)(gbase + g) * TM * 16) = ok ? bil8(src, q, g * 8) : zero;
}

// TAPS: yt (B,H,W,N2) of the taps product; else h (B,H,W,N2): the first N2
// of the N1 (padded) hidden channels
template <bool TAPS, int N2P>
__global__ void __launch_bounds__(NT, 1)
ups_head_taps4_kernel(const bf16 *__restrict__ p0, const bf16 *__restrict__ p1,
                      const bf16 *__restrict__ p2, const bf16 *__restrict__ p3,
                      const bf16 *__restrict__ w1u, const float *__restrict__ b1,
                      const bf16 *__restrict__ w2u, bf16 *__restrict__ yt, int B, int H, int W,
                      int H1, int W1, int H2, int W2, int H3, int W3, int C0, int C1, int C2,
                      int C3, int N1, int N2) {
  constexpr int UB2 = Lay<N2P>::UB2, NACC = N2P / 2;  // yacc: f32 a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full1 = reinterpret_cast<uint64_t *>(smem + Lay<N2P>::O_BAR), *empty1 = full1 + NS1;
  uint64_t *full2 = empty1 + NS1, *empty2 = full2 + NS2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long M = (long)B * H * W;
  const int nt = (int)((M + TM - 1) / TM);
  const int NKU = (C0 + C1 + C2 + C3) / 64, NP = N1 / 128;  // W1 units a chunk, chunk pairs
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], 4);
    }
    for (int s = 0; s < NS2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<R_PROD>();
    if (warp == 4 * NWG && lane == 0) {
      const int iw2 = min(IW2, NKU - 1);
      int q1 = 0, q2 = 0;
      // the q-th copy into a ring of ns slots of ub bytes
      auto put = [&](unsigned char *ring, int ub, int ns, uint64_t *full, uint64_t *empty,
                     const bf16 *src, int q) {
        const int s = q % ns;
        mbar_wait(&empty[s], ((q / ns) & 1) ^ 1);
        mbar_expect_tx(&full[s], ub);
        bulk_load(ring + s * ub, src, ub, &full[s]);
      };
      for (int t = blockIdx.x; t < nt; t += gridDim.x)
        for (int p = 0; p < NP; ++p)
          for (int u = 0; u < NKU; ++u) {
            for (int j = 0; j < 2; ++j, ++q1)
              put(smem + O_R1, UB1, NS1, full1, empty1,
                  w1u + ((long)(p * NKU + u) * 2 + j) * (UB1 / 2), q1);
            if (TAPS && u == iw2)
              for (int j = 0; j < 2; ++j, ++q2)
                put(smem + O_R2, UB2, NS2, full2, empty2, w2u + (long)(2 * p + j) * (UB2 / 2), q2);
          }
    }
  } else {
    setmaxnreg_inc<R_CONS>();
    const int wg = warp >> 2, wq = warp & 3, ct = threadIdx.x;
    const uint32_t cat = smem_u32(smem), r1 = smem_u32(smem + O_R1), r2 = smem_u32(smem + O_R2);
    const int lrow = wq * 16 + (lane >> 2), ec = 2 * (lane & 3);  // accumulator row, column
    const bool rel = lane == 0;  // the lane that releases a slot for its warp
    int k1 = 0, k2 = 0;          // W1 units, W2t chunks this warpgroup has taken
    bf16 *Hst = reinterpret_cast<bf16 *>(smem + O_R2) + wg * 64 * LDH;  // h mode staging
    float yacc[TAPS ? NACC : 1];
    for (int t = blockIdx.x; t < nt; t += gridDim.x) {
      const long m0 = (long)t * TM;
      bar_sync(1, CT);  // the previous tile is done with the concat's room
      // ---- the concat at this tile's pixels: core matrix (channel group g,
      // 8 pixels) at (g * TM + pixel) * 16 bytes.  Thread ct builds pixel
      // ct % TM, channel groups ct / TM + 4k of each part.
      {
        const int r = ct % TM, g0 = ct / TM;
        const long m = m0 + r;
        const bool ok = m < M;
        const long mm = ok ? m : 0;
        const int xx = (int)(mm % W), yy = (int)((mm / W) % H);
        const long bb = mm / W / H;
        unsigned char *row = smem + (long)r * 16;
        const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 2
        for (int g = g0; g < C0 / 8; g += CT / TM)
          *reinterpret_cast<uint4 *>(row + (long)g * TM * 16) = ok ? ldg16(p0 + mm * C0 + g * 8) : zero;
        cat_part(row, p1, bb, H1, W1, C1, yy, xx, H, W, g0, C0 / 8, ok);
        cat_part(row, p2, bb, H2, W2, C2, yy, xx, H, W, g0, (C0 + C1) / 8, ok);
        cat_part(row, p3, bb, H3, W3, C3, yy, xx, H, W, g0, (C0 + C1 + C2) / 8, ok);
      }
      fence_async_smem();  // the concat is read by wgmma
      bar_sync(1, CT);

      if constexpr (TAPS) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) yacc[i] = 0.f;
      }
#pragma unroll 1
      for (int p = 0; p < NP; ++p) {
        const int nc = 2 * p + wg;  // this warpgroup's hidden chunk
        float hacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
#pragma unroll 1
        for (int u = 0; u < NKU; ++u, ++k1) {
          const int q = 2 * k1 + wg, s = q % NS1;
          mbar_wait(&full1[s], (q / NS1) & 1);
          wg_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma64ss<0>(hacc, desc(cat + (4 * u + j) * 2 * TM * 16, TM * 16, 128),
                         desc(r1 + s * UB1 + j * 2048, 1024, 128));
          wg_commit();
          wg_wait<1>();
          // the previous unit's product is done: its slot is free
          mbar_arrive_if(empty1 + (q + NS1 - 2) % NS1, u > 0 && rel);
          // the previous chunk's taps product is done: its W2t slot is free
          mbar_arrive_if(empty2 + wg, TAPS && u == 0 && p > 0 && rel);
        }
        wg_wait<0>();
        fence_acc(hacc);
        mbar_arrive_if(empty1 + (2 * (k1 - 1) + wg) % NS1, rel);
        // h = lrelu(bf16(bf16(hacc) + bf16(b1))) in registers
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = *reinterpret_cast<const float2 *>(b1 + nc * 64 + 8 * j + ec);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            hacc[4 * j + 2 * hh] = lrelu_bf(rbf(rbf(hacc[4 * j + 2 * hh]) + rbf(b.x)));
            hacc[4 * j + 2 * hh + 1] = lrelu_bf(rbf(rbf(hacc[4 * j + 2 * hh + 1]) + rbf(b.y)));
          }
        }
        if constexpr (TAPS) {  // yacc += h . W2t[chunk], left in flight
          uint32_t ha[4][4];
          acc_to_a(ha, hacc);
          mbar_wait(&full2[wg], k2 & 1);  // slot wg: this warpgroup's W2t chunks
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bd = desc(r2 + wg * UB2 + kk * 2 * N2P * 16, N2P * 16, 128);
            if constexpr (N2P == 208)
              wgmma208(yacc, ha[kk], bd);
            else
              wgmma216(yacc, ha[kk], bd);
          }
          wg_commit();
          ++k2;
        } else {  // h mode: this warpgroup's chunk of the tile's 64 rows
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<__nv_bfloat162 *>(Hst + (lrow + 8 * hh) * LDH + 8 * j + ec) =
                  __floats2bfloat162_rn(hacc[4 * j + 2 * hh], hacc[4 * j + 2 * hh + 1]);
          bar_sync(2 + wg, 128);
          if (nc * 64 < N2)  // a chunk of the zero padding past h's channels is not stored
            for (int i = ct % 128; i < 64 * 8; i += 128) {
              const int r = i / 8, v = (i % 8) * 8;
              const long m = m0 + r;
              if (m < M)
                st16(yt + m * N2 + nc * 64 + v, *reinterpret_cast<const uint4 *>(Hst + r * LDH + v));
            }
          bar_sync(2 + wg, 128);
        }
      }
      if constexpr (TAPS) {
        wg_wait<0>();
        fence_acc(yacc);
        mbar_arrive_if(empty2 + wg, rel);
        bar_sync(1, CT);  // both warpgroups are done reading the concat
        // yt = bf16(yacc of warpgroup 0 + yacc of warpgroup 1), f32 sum
        float *Y32 = reinterpret_cast<float *>(smem);
        bf16 *Yb = reinterpret_cast<bf16 *>(smem + Lay<N2P>::O_YB);  // yt rows, as in device memory
        if (wg == 1) {
#pragma unroll
          for (int j = 0; j < N2P / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2 *>(Y32 + (lrow + 8 * hh) * N2P + 8 * j + ec) =
                  make_float2(yacc[4 * j + 2 * hh], yacc[4 * j + 2 * hh + 1]);
        }
        bar_sync(1, CT);
        if (wg == 0) {
#pragma unroll
          for (int j = 0; j < N2P / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = lrow + 8 * hh, c = 8 * j + ec;
              const float2 o = *reinterpret_cast<const float2 *>(Y32 + r * N2P + c);
              if (c < N2) Yb[r * N2 + c] = __float2bfloat16(yacc[4 * j + 2 * hh] + o.x);
              if (c + 1 < N2) Yb[r * N2 + c + 1] = __float2bfloat16(yacc[4 * j + 2 * hh + 1] + o.y);
            }
        }
        bar_sync(1, CT);
        const long rows = M - m0 < TM ? M - m0 : TM;
        const long n = rows * N2, nv = n / 8;  // the span starts 16-byte aligned
        for (long e = ct; e < nv; e += CT)
          st16(yt + m0 * N2 + e * 8, reinterpret_cast<const uint4 *>(Yb)[e]);
        for (long e = nv * 8 + ct; e < n; e += CT) yt[m0 * N2 + e] = Yb[e];
      }
    }
  }
}

template <bool TAPS, int N2P>
int launch(const void *p0, const void *p1, const void *p2, const void *p3, const void *w1u,
           const void *b1, const void *w2u, void *out, int B, int H, int W, int H1, int W1, int H2,
           int W2, int H3, int W3, int C0, int C1, int C2, int C3, int N1, int N2,
           cudaStream_t st) {
  auto kern = ups_head_taps4_kernel<TAPS, N2P>;
  constexpr int SMEM = Lay<N2P>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long tiles = ((long)B * H * W + TM - 1) / TM;
  kern<<<(unsigned)(tiles < sms ? tiles : sms), NT, SMEM, st>>>(
      (const bf16 *)p0, (const bf16 *)p1, (const bf16 *)p2, (const bf16 *)p3, (const bf16 *)w1u,
      (const float *)b1, (const bf16 *)w2u, (bf16 *)out, B, H, W, H1, W1, H2, W2, H3, W3, C0, C1,
      C2, C3, N1, N2);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// p0 (B,H,W,C0), p1 (B,H1,W1,C1), p2 (B,H2,W2,C2), p3 (B,H3,W3,C3) bf16;
// w1u: W1 (C0+C1+C2+C3, N1) as (N1/128, CT/64, 2, 8, 64, 8) bf16 units,
// the units of hidden chunks 2p and 2p+1 interleaved (ops/upshead.py:
// w1_units4); b1 (N1,) f32; w2u: the taps matrix zero-padded to 208 columns
// as (N1/64, 8, 208, 8) bf16 chunks (w2_chunks); yt (B,H,W,N2) bf16.  Every
// Ci % 8 == 0, C0+C1+C2+C3 % 64 == 0 and <= 960, N1 % 128 == 0 (the wrapper
// pads W1, b1 and W2t with zero hidden channels), N2 <= 208 (checked by the
// Python wrapper).
extern "C" int dvie_ups_head_taps4(const void *p0, const void *p1, const void *p2,
                                   const void *p3, const void *w1u, const void *b1,
                                   const void *w2u, void *yt, int B, int H, int W, int H1, int W1,
                                   int H2, int W2, int H3, int W3, int C0, int C1, int C2, int C3,
                                   int N1, int N2, void *stream) {
  if (N1 % 128 || N2 > 208) return (int)cudaErrorInvalidValue;
  return dvie::launch<true, 208>(p0, p1, p2, p3, w1u, b1, w2u, yt, B, H, W, H1, W1, H2, W2, H3, W3,
                                 C0, C1, C2, C3, N1, N2, (cudaStream_t)stream);
}

// The taps mode at N2P = 216, a head of 24 channels (ExtraInpaintNet's rgb 3
// + mask 1 with seg 20): the same arguments, w2u padded to 216 columns as
// (N1/64, 8, 216, 8) chunks, 208 < N2 <= 216.
extern "C" int dvie_ups_head_taps4_n216(const void *p0, const void *p1, const void *p2,
                                        const void *p3, const void *w1u, const void *b1,
                                        const void *w2u, void *yt, int B, int H, int W, int H1,
                                        int W1, int H2, int W2, int H3, int W3, int C0, int C1,
                                        int C2, int C3, int N1, int N2, void *stream) {
  if (N1 % 128 || N2 > 216) return (int)cudaErrorInvalidValue;
  return dvie::launch<true, 216>(p0, p1, p2, p3, w1u, b1, w2u, yt, B, H, W, H1, W1, H2, W2, H3, W3,
                                 C0, C1, C2, C3, N1, N2, (cudaStream_t)stream);
}

// h mode: the same pyramid, w1u and b1 (N1 padded to a multiple of 128);
// h (B,H,W,NH) bf16, the first NH hidden channels, NH % 64 == 0, NH <= N1.
extern "C" int dvie_ups_head_1x1_4(const void *p0, const void *p1, const void *p2,
                                   const void *p3, const void *w1u, const void *b1, void *h, int B,
                                   int H, int W, int H1, int W1, int H2, int W2, int H3, int W3,
                                   int C0, int C1, int C2, int C3, int N1, int NH, void *stream) {
  if (N1 % 128 || NH % 64 || NH > N1) return (int)cudaErrorInvalidValue;
  return dvie::launch<false, 208>(p0, p1, p2, p3, w1u, b1, nullptr, h, B, H, W, H1, W1, H2, W2, H3,
                                  W3, C0, C1, C2, C3, N1, NH, (cudaStream_t)stream);
}
