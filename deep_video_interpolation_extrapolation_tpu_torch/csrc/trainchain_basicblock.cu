// The BasicBlock chain in training, NHWC bf16, f32 accumulation, at C = 64,
// 128 and 256 (branch 0, 1 and 2 of stage2 and stage3).  Per block:
//   h   = lrelu(bf16(conv3x3(x, k1)))
//   pre = bf16(conv3x3(h, k2))          y = lrelu(bf16(pre + x))
// with the residual add and lrelu in bf16, as ops/pallas_trainchain.py
// rounds.  Backward: dpre_y = lrelu'(y) * dy; dh = bf16(conv_t(dpre_y, k2));
// dpre_h = lrelu'(h) * dh; dx = bf16(conv_t(dpre_h, k1) + dpre_y), rounded
// once; dk1 = wgrad(x, dpre_h), dk2 = wgrad(h, dpre_y) in f32.
//
// Replaces ops/pallas_trainchain.py:basicblock_chain: the forward
// _bb_fwd_kernel (pallas_call at :704) and the backward _bb_bwd_kernel
// (:741), packed at C = 64 (DVIE_BBCHAIN=b0|all) and unpacked at C = 128
// and 256 (rest|all).  With N = 1 it is also pallas_resblock.
// fused_basicblock and pallas_bb.fused_basicblock_hwnc.  The TPU kernel
// holds whole planes in VMEM and chains all N blocks in one kernel; here a
// launch is one block over 2-D pixel tiles (chaining would need an 8-pixel
// halo), and the backward recomputes nothing: the forward stores y and h
// (the masks are their signs: lrelu keeps the sign).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  24x128x128, C = 64,
// per block: forward 2 convs = 2*M*576*64*2 = 58 GFLOP (59 us) against
// x in, y and h out, 150 MB (45 us): operations.  Backward: dh, dx and the
// two weight grads, 116 GFLOP (117 us), against dy, y, h, x in, dx out and
// dpre_y, dpre_h out and back in (~450 MB, 134 us): bytes, barely.
// 24x64x64, C = 128: the same operations per block (a quarter of the
// pixels, four times the MACs per pixel) on half the bytes: operations.
//
// Design: every conv is an implicit GEMM on wgmma m64n64k16 (M = pixels,
// N = 64 output channels per instruction, K = 9 taps x C input channels),
// A from registers, B from shared memory.
// - A: a block stages its tile's input on a 2-ring halo (pitch TW + 4) in
//   shared memory, 16 bytes of padding per position so that ldmatrix of 8
//   positions hits 8 distinct bank groups.  Each lane of the warpgroup
//   gives ldmatrix the address of its own A row, so a row is any region
//   position plus the tap's offset: no im2col, and conv1's output rows are
//   exactly the 1-ring positions ((TH + 2) x 18 of them, 3 m-tiles of 64 at
//   TH = 8), not runs that wrap across rows.
// - B: the weights are streamed in units of (tap, 64 input channels) x C
//   output channels (8-32 KB), laid out by the wrapper in the no-swizzle
//   K-major core-matrix order (hopper.cuh), by one producer warp with the
//   bulk TMA copy into a ring of 4 slots (2 at C = 256) under full/empty
//   mbarriers.  No whole 3x3 set is ever resident, which is what lets C =
//   128 (295 KB a set) and 256 (1.2 MB) run at all.
// - Warpgroups: conv1 has MT1 m-tiles and conv2 MT2 = TH * 16 / 64; one
//   m-tile per consumer warpgroup (NWG = MT1), each holding C / 2 f32
//   accumulators; the A registers of the next unit are loaded while the
//   current unit's wgmmas run (wait_group 1).  In conv2 the warpgroups past
//   MT2 recompute the last m-tile and store nothing: a wgmma under a branch
//   is serialized by ptxas (C7518), and the two ways timed alike (one call,
//   H100 700 W, C = 64, N = 4: forward 1.30 ms this way, 1.39 and 1.46 ms
//   in two builds with the branch).
// - Persistent blocks walk the tiles; the next tile's input region is
//   loaded (cp.async) while conv2 runs, which no longer reads it (the
//   residual is read from global memory, where it sits in L2).  The
//   epilogues run from the accumulator registers: conv1's writes h (bf16,
//   zero outside the image: conv2's SAME padding) to the 1-ring buffer,
//   conv2's adds the residual and stores.
// - C = 256: the 2-ring region (123 KB at 8x16) and h's 1-ring (92 KB) do
//   not fit beside a weight ring, so the tile shrinks to 4x16 (84 + 57 +
//   64 KB): two m-tiles for conv1, one for conv2.  Splitting the block in
//   two launches with h through HBM would add 2 x 50 MB-class round trips
//   per block; the smaller tile only re-reads more halo (1.9x vs 1.5x) from
//   L2.
// - Backward: the same kernel with dy as the staged input (masked in place
//   by the sign of y, read from global, and dpre_y stored at the tile), the
//   flipped and transposed taps, conv1's epilogue forming dpre_h (h from
//   global) and conv2's adding dpre_y: dx.
// - Weight grads: one launch for every block of the chain (wgrad_kernel):
//   a block stages a pixel tile of d (dpre_h or dpre_y, 64 output
//   channels, MN-major core matrices) and its 1-ring of a (x or h, 64 input
//   channels), and forms all nine tap products from shifted views of the
//   staged a (ldmatrix.trans), 3 taps per warpgroup, K = pixels.  Each
//   64x64 channel pair reads its operands once per chain; f32 partials per
//   pixel range, summed by the wrapper: deterministic, no atomics (the JAX
//   note at pallas_trainchain.py:26-33).
//
// Prediction (written before the first chip run of this design): at
// 24x128x128, C = 64, N = 4 the forward falls from 3.41 to 0.8-1.5 ms and
// the backward (weight grads included) from 7.36 to 1.5-3.0 ms; the train
// step rises from ~194.5 to 210-228 samples/s.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;

constexpr int TW = 16;  // tile width: one warp's 16 A rows are one tile row

template <int C_>
struct BB {
  static constexpr int C = C_;
  static constexpr int TH = C == 256 ? 4 : 8;
  static constexpr int NCH = C / 64;            // 64-channel chunks (N of a wgmma)
  static constexpr int PW2 = TW + 4, NPOS2 = (TH + 4) * PW2;  // the 2-ring region
  static constexpr int PW1 = TW + 2, NPOS1 = (TH + 2) * PW1;  // the 1-ring buffer
  static constexpr int MT1 = (NPOS1 + 63) / 64;  // conv1 m-tiles
  static constexpr int MT2 = TH * TW / 64;       // conv2 m-tiles
  static constexpr int NWG = MT1;                // consumer warpgroups
  static constexpr int CT = NWG * 128;           // consumer threads
  static constexpr int NT = CT + 32;             // + the weight producer warp
  static constexpr int LDS = C + 8;              // region pitch, elements
  static constexpr int U = 9 * NCH;              // weight units per conv
  static constexpr int UB = 64 * C * 2;          // bytes of a unit
  static constexpr int NST = C == 256 ? 2 : 4;   // weight ring slots
  static constexpr int O_X = NST * UB;
  static constexpr int O_H = align128(O_X + NPOS2 * LDS * 2);
  static constexpr int O_BAR = align128(O_H + NPOS1 * LDS * 2);
  static constexpr int SMEM = O_BAR + 2 * NST * 8;
  static_assert(SMEM <= 232448, "shared memory per block");
  static_assert(MT2 <= NWG && MT2 * 64 == TH * TW, "conv2 m-tiles");
};

struct Tile {
  int b, y0, x0;
};

template <int TH>
__device__ __forceinline__ Tile tile_at(int t, int H, int W) {
  const int tx = (W + TW - 1) / TW, ty = (H + TH - 1) / TH;
  Tile r;
  r.x0 = (t % tx) * TW;
  t /= tx;
  r.y0 = (t % ty) * TH;
  r.b = t / ty;
  return r;
}

__device__ __forceinline__ bool inside(int yy, int xx, int H, int W) {
  return yy >= 0 && yy < H && xx >= 0 && xx < W;
}

__device__ __forceinline__ long pix(int b, int yy, int xx, int H, int W) {
  return ((long)b * H + yy) * W + xx;
}

// g = lrelu'(s) * g on 8 channels: the mask from the sign of s, bf16
__device__ __forceinline__ uint4 masked8(const uint4 &s, const uint4 &g) {
  float sv[8], gv[8];
  unpack8(s, sv);
  unpack8(g, gv);
#pragma unroll
  for (int k = 0; k < 8; ++k) gv[k] = sv[k] >= 0.f ? gv[k] : rbf(0.2f * gv[k]);
  return pack8(gv);
}

__device__ __forceinline__ float masked(float s, float g) { return s >= 0.f ? g : rbf(0.2f * g); }

// cp.async the 2-ring region of tile t (zeros outside the image)
template <class K>
__device__ __forceinline__ void load_region(bf16 *Xs, const bf16 *__restrict__ src, const Tile &t,
                                            int H, int W) {
  constexpr int V = K::C / 8;
  for (int i = threadIdx.x; i < K::NPOS2 * V; i += K::CT) {
    const int l = i / V, c = (i % V) * 8;
    const int yy = t.y0 - 2 + l / K::PW2, xx = t.x0 - 2 + l % K::PW2;
    const bool ok = inside(yy, xx, H, W);
    cp_async16(Xs + l * K::LDS + c, ok ? src + pix(t.b, yy, xx, H, W) * K::C + c : src, ok);
  }
}

// the A fragments of weight unit u (tap u / NCH, input channels 64 (u % NCH)
// ...): 4 k-steps; `base` is this lane's row at the centre tap
template <class K, int PW>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t base, int u) {
  const int tap = u / K::NCH, kc = u % K::NCH;
  const uint32_t off = (((tap / 3 - 1) * PW + tap % 3 - 1) * K::LDS + kc * 64) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) ldsm4(a[j], base + off + j * 32);
}

// One weight unit of a conv: wait for its slot, issue its wgmmas on `cur`,
// release the previous unit's slot once its wgmmas are done, load the next
// unit's A into `nxt`.  No wgmma sits under a branch: ptxas serializes
// wgmmas on a divergent path (C7518).
template <class K, int PW>
__device__ __forceinline__ void conv_unit(float (&acc)[K::NCH][32], uint32_t (&cur)[4][4],
                                          uint32_t (&nxt)[4][4], uint32_t abase, int u, int &seq,
                                          uint64_t *full, uint64_t *empty, uint32_t ring) {
  const int s = seq % K::NST;
  mbar_wait(&full[s], (seq / K::NST) & 1);
  wg_fence();
  const uint64_t d0 = desc(ring + s * K::UB, K::C * 16, 128);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < K::NCH; ++n)
      wgmma64<0>(acc[n], cur[j], d0 + ((j * 32 * K::C + n * 1024) >> 4));
  wg_commit();
  wg_wait<1>();
  mbar_arrive_if(&empty[(seq + K::NST - 1) % K::NST], u > 0 && (threadIdx.x & 31) == 0);
  if (u + 1 < K::U) load_a<K, PW>(nxt, abase, u + 1);
  ++seq;
}

// acc = conv3x3 over this warpgroup's m-tile: A rows at `abase` (pitch
// PW), the weight units streamed through the ring
template <class K, int PW>
__device__ __forceinline__ void conv(float (&acc)[K::NCH][32], uint32_t abase, int &seq,
                                     uint64_t *full, uint64_t *empty, uint32_t ring) {
#pragma unroll
  for (int n = 0; n < K::NCH; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  uint32_t a0[4][4], a1[4][4];
  load_a<K, PW>(a0, abase, 0);
#pragma unroll 1
  for (int u = 0; u < K::U; u += 2) {
    conv_unit<K, PW>(acc, a0, a1, abase, u, seq, full, empty, ring);
    if (u + 1 < K::U) conv_unit<K, PW>(acc, a1, a0, abase, u + 1, seq, full, empty, ring);
  }
  wg_wait<0>();
#pragma unroll
  for (int n = 0; n < K::NCH; ++n) fence_acc(acc[n]);
  mbar_arrive_if(&empty[(seq - 1) % K::NST], (threadIdx.x & 31) == 0);
}

// One block's pass over every tile.
// Forward (BWD = false): src = x, w1/w2 = k1/k2 units; out = y; mid = h
//   (or null: not stored).
// Backward (BWD = true): src = dy, msk = y, hin = h, w1/w2 = flipped k2/k1
//   units; out = dx; mid = dpre_h; dpy = dpre_y.
template <int C, bool BWD>
__global__ void __launch_bounds__(BB<C>::NT, 1)
bb_kernel(const bf16 *__restrict__ src, const bf16 *__restrict__ msk,
          const bf16 *__restrict__ hin, const bf16 *__restrict__ w1,
          const bf16 *__restrict__ w2, bf16 *__restrict__ out, bf16 *__restrict__ mid,
          bf16 *dpy, int B, int H, int W) {
  using K = BB<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + K::O_X);
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + K::O_H);
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + K::O_BAR), *empty = full + K::NST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * K::NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * K::NWG) {  // the producer: both convs' units, tile after tile
    if (lane == 0) {
      int seq = 0;
      for (int t = blockIdx.x; t < nt; t += gridDim.x)
        for (int cv = 0; cv < 2; ++cv)
          for (int u = 0; u < K::U; ++u, ++seq) {
            const int s = seq % K::NST;
            mbar_wait(&empty[s], ((seq / K::NST) & 1) ^ 1);
            mbar_expect_tx(&full[s], K::UB);
            bulk_load(smem + s * K::UB, (cv ? w2 : w1) + (long)u * (K::UB / 2), K::UB, &full[s]);
          }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const uint32_t ring = smem_u32(smem);
  // this lane's ldmatrix row (of its warp's 16) and channel offset
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  // conv1: row i of m-tile wg is 1-ring position i (clamped past the end)
  const int i1 = min(wg * 64 + lr, K::NPOS1 - 1);
  const uint32_t a1 =
      smem_u32(Xs) + (((i1 / K::PW1 + 1) * K::PW2 + i1 % K::PW1 + 1) * K::LDS + lk) * 2;
  // conv2: row i of m-tile wg is tile pixel (i / 16, i % 16); a warpgroup
  // past the last m-tile recomputes its rows and stores nothing
  const int i2 = min(wg * 64 + lr, K::TH * TW - 1);
  const uint32_t a2 = smem_u32(Hs) + (((i2 / TW + 1) * K::PW1 + i2 % TW + 1) * K::LDS + lk) * 2;
  // accumulator rows and columns of this thread
  const int er = wg * 64 + wq * 16 + (lane >> 2), ec = 2 * (lane & 3);
  constexpr int V = C / 8;

  int seq = 0;
  if (blockIdx.x < nt) load_region<K>(Xs, src, tile_at<K::TH>(blockIdx.x, H, W), H, W);
  cp_async_commit();
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x) {
    const Tile t = tile_at<K::TH>(ti, H, W);
    cp_async_wait<0>();
    bar_sync(1, K::CT);
    if (BWD) {  // dpre_y = lrelu'(y) * dy on the region; stored at the tile
      for (int i = threadIdx.x; i < K::NPOS2 * V; i += K::CT) {
        const int l = i / V, c = (i % V) * 8, ry = l / K::PW2, rx = l % K::PW2;
        const int yy = t.y0 - 2 + ry, xx = t.x0 - 2 + rx;
        if (!inside(yy, xx, H, W)) continue;
        const long m = pix(t.b, yy, xx, H, W) * C + c;
        bf16 *p = Xs + l * K::LDS + c;
        const uint4 g = masked8(ldg16(msk + m), *reinterpret_cast<const uint4 *>(p));
        st16(p, g);
        if (ry >= 2 && ry < K::TH + 2 && rx >= 2 && rx < TW + 2) st16(dpy + m, g);
      }
      bar_sync(1, K::CT);
    }

    // ---- conv1 on the 1-ring -> Hs: h (forward) or dpre_h (backward)
    float acc[K::NCH][32];
    conv<K, K::PW2>(acc, a1, seq, full, empty, ring);
    {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = er + 8 * hh;
        if (i >= K::NPOS1) continue;
        const int yy = t.y0 - 1 + i / K::PW1, xx = t.x0 - 1 + i % K::PW1;
        const bool ok = inside(yy, xx, H, W);
        const long m = ok ? pix(t.b, yy, xx, H, W) * C : 0;
#pragma unroll
        for (int n = 0; n < K::NCH; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = n * 64 + 8 * j + ec;
            float v0 = rbf(acc[n][4 * j + 2 * hh]), v1 = rbf(acc[n][4 * j + 2 * hh + 1]);
            if (!ok) {
              v0 = v1 = 0.f;
            } else if (BWD) {
              const float2 s = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162 *>(hin + m + c));
              v0 = masked(s.x, v0);
              v1 = masked(s.y, v1);
            } else {
              v0 = lrelu_bf(v0);
              v1 = lrelu_bf(v1);
            }
            *reinterpret_cast<__nv_bfloat162 *>(Hs + i * K::LDS + c) = __floats2bfloat162_rn(v0, v1);
          }
      }
    }
    bar_sync(1, K::CT);  // Hs is whole; nothing reads Xs any more

    if (mid) {  // h or dpre_h at the tile's pixels
      for (int i = threadIdx.x; i < K::TH * TW * V; i += K::CT) {
        const int px = i / V, c = (i % V) * 8;
        const int yy = t.y0 + px / TW, xx = t.x0 + px % TW;
        if (inside(yy, xx, H, W))
          st16(mid + pix(t.b, yy, xx, H, W) * C + c,
               *reinterpret_cast<const uint4 *>(Hs + ((px / TW + 1) * K::PW1 + px % TW + 1) * K::LDS + c));
      }
    }
    if (ti + gridDim.x < nt) load_region<K>(Xs, src, tile_at<K::TH>(ti + gridDim.x, H, W), H, W);
    cp_async_commit();

    // ---- conv2 on the tile: y = lrelu(bf16(pre + x)), or dx = pre + dpre_y
    conv<K, K::PW1>(acc, a2, seq, full, empty, ring);
    if (wg < K::MT2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = er + 8 * hh;
        const int yy = t.y0 + i / TW, xx = t.x0 + i % TW;
        if (!inside(yy, xx, H, W)) continue;
        const long m = pix(t.b, yy, xx, H, W) * C;
#pragma unroll
        for (int n = 0; n < K::NCH; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = n * 64 + 8 * j + ec;
            const float a0 = acc[n][4 * j + 2 * hh], a1v = acc[n][4 * j + 2 * hh + 1];
            float2 r;
            __nv_bfloat162 o;
            if (BWD) {
              r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(dpy + m + c));
              o = __floats2bfloat162_rn(a0 + r.x, a1v + r.y);
            } else {
              r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(src + m + c));
              o = __floats2bfloat162_rn(lrelu_bf(rbf(rbf(a0) + r.x)), lrelu_bf(rbf(rbf(a1v) + r.y)));
            }
            *reinterpret_cast<__nv_bfloat162 *>(out + m + c) = o;
          }
      }
    }
  }
}

// ---- weight grads ---------------------------------------------------------

constexpr int GTH = 8, GPW = TW + 2, GNPOS = (GTH + 2) * GPW;  // a's 1-ring: 180
constexpr int GLD = 64 + 8;
constexpr int GNT = 384;  // 3 warpgroups, 3 taps each
constexpr int G_A = align128(GNPOS * GLD * 2);
constexpr int G_STAGE = G_A + GTH * TW * 64 * 2;
constexpr int GSMEM = 2 * G_STAGE;
constexpr int MAX_JOBS = 16;

struct GJobs {
  const bf16 *a[MAX_JOBS];  // (B,H,W,C): x or h
  const bf16 *d[MAX_JOBS];  // (B,H,W,C): dpre_h or dpre_y
  float *out[MAX_JOBS];     // (splits, 9, C, C): tap, input channel, output channel
};

// the A fragments of k-step ks (tile row ks) for this warpgroup's 3 taps
__device__ __forceinline__ void g_load_a(uint32_t (&a)[3][4], uint32_t base, int wg, int ks) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int tap = 3 * wg + k;
    ldsm4t(a[k], base + ((ks + tap / 3) * GPW + tap % 3) * GLD * 2);
  }
}

__device__ __forceinline__ void g_step(float (&acc)[3][32], uint32_t (&cur)[3][4],
                                       uint32_t (&nxt)[3][4], uint32_t abase, uint32_t dsm,
                                       int wg, int ks) {
  wg_fence();
  const uint64_t d = desc(dsm + ks * 2048, 1024, 128);
#pragma unroll
  for (int k = 0; k < 3; ++k) wgmma64<1>(acc[k], cur[k], d);
  wg_commit();
  wg_wait<1>();
  if (ks + 1 < GTH) g_load_a(nxt, abase, wg, ks + 1);
}

// blockIdx.y: the job; blockIdx.x: (input chunk, output chunk, pixel range)
__global__ void __launch_bounds__(GNT, 1)
wgrad_kernel(const GJobs jobs, int C, int B, int H, int W, int splits) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int job = blockIdx.y, nch = C / 64;
  int r = blockIdx.x;
  const int s = r % splits;
  r /= splits;
  const int nc = r % nch, mc = r / nch;
  const bf16 *__restrict__ a = jobs.a[job];
  const bf16 *__restrict__ dg = jobs.d[job];
  const int tx = (W + TW - 1) / TW, ty = (H + GTH - 1) / GTH, nt = B * tx * ty;
  const int t0 = (int)((long)s * nt / splits), t1 = (int)((long)(s + 1) * nt / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wq = warp & 3;

  auto load = [&](int ti, int buf) {
    const Tile t = tile_at<GTH>(ti, H, W);
    bf16 *As = reinterpret_cast<bf16 *>(smem + buf * G_STAGE);
    bf16 *Ds = reinterpret_cast<bf16 *>(smem + buf * G_STAGE + G_A);
    for (int i = threadIdx.x; i < GNPOS * 8; i += GNT) {
      const int l = i >> 3, v = i & 7;
      const int yy = t.y0 - 1 + l / GPW, xx = t.x0 - 1 + l % GPW;
      const bool ok = inside(yy, xx, H, W);
      cp_async16(As + l * GLD + v * 8, ok ? a + pix(t.b, yy, xx, H, W) * C + mc * 64 + v * 8 : a,
                 ok);
    }
    // d in MN-major core matrices: (pixel group of 8, channel group of 8)
    for (int i = threadIdx.x; i < GTH * TW * 8; i += GNT) {
      const int p = i >> 3, v = i & 7;
      const int yy = t.y0 + p / TW, xx = t.x0 + p % TW;
      const bool ok = inside(yy, xx, H, W);
      cp_async16(Ds + ((p >> 3) * 8 + v) * 64 + (p & 7) * 8,
                 ok ? dg + pix(t.b, yy, xx, H, W) * C + nc * 64 + v * 8 : dg, ok);
    }
  };

  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[k][i] = 0.f;
  // ldmatrix.trans: lane gives pixel (lane & 7) + 8 (lane >> 4) of the
  // k-step's tile row, input channels 16 wq + 8 ((lane >> 3) & 1) ...
  const int lp = (lane & 7) + 8 * (lane >> 4), lc = 16 * wq + 8 * ((lane >> 3) & 1);

  if (t0 < t1) load(t0, 0);
  cp_async_commit();
  for (int ti = t0, it = 0; ti < t1; ++ti, ++it) {
    if (ti + 1 < t1) load(ti + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();  // d is read by wgmma
    __syncthreads();
    const uint32_t abase = smem_u32(smem + (it & 1) * G_STAGE) + (lp * GLD + lc) * 2;
    const uint32_t dsm = smem_u32(smem + (it & 1) * G_STAGE + G_A);
    uint32_t a0[3][4], a1[3][4];
    g_load_a(a0, abase, wg, 0);
#pragma unroll 1
    for (int ks = 0; ks < GTH; ks += 2) {
      g_step(acc, a0, a1, abase, dsm, wg, ks);
      g_step(acc, a1, a0, abase, dsm, wg, ks + 1);
    }
    wg_wait<0>();
    __syncthreads();  // this stage is refilled next iteration
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) fence_acc(acc[k]);
  float *o = jobs.out[job] + (long)s * 9 * C * C;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = mc * 64 + 16 * wq + (lane >> 2) + 8 * hh;
      float *row = o + ((long)(3 * wg + k) * C + ci) * C + nc * 64 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2 *>(row + 8 * j) =
            make_float2(acc[k][4 * j + 2 * hh], acc[k][4 * j + 2 * hh + 1]);
    }
}

template <int C, bool BWD>
int launch_bb(const void *src, const void *msk, const void *hin, const void *w1, const void *w2,
              void *out, void *mid, void *dpy, int B, int H, int W, cudaStream_t st) {
  using K = BB<C>;
  auto kern = bb_kernel<C, BWD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, K::NT, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int nt = B * ((H + K::TH - 1) / K::TH) * ((W + TW - 1) / TW);
  kern<<<min(nt, sms * occ), K::NT, K::SMEM, st>>>(
      (const bf16 *)src, (const bf16 *)msk, (const bf16 *)hin, (const bf16 *)w1,
      (const bf16 *)w2, (bf16 *)out, (bf16 *)mid, (bf16 *)dpy, B, H, W);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int C, const void *src, const void *msk, const void *hin, const void *w1,
             const void *w2, void *out, void *mid, void *dpy, int B, int H, int W, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch_bb<64, BWD>(src, msk, hin, w1, w2, out, mid, dpy, B, H, W, st);
    case 128: return launch_bb<128, BWD>(src, msk, hin, w1, w2, out, mid, dpy, B, H, W, st);
    case 256: return launch_bb<256, BWD>(src, msk, hin, w1, w2, out, mid, dpy, B, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dvie

// One BasicBlock forward at C in {64, 128, 256}.  x (B,H,W,C); w1u, w2u:
// k1 and k2 as 9 * C / 64 weight units (tap, 64 input channels) of
// (8 k-groups, C outputs, 8 k) bf16; y (B,H,W,C); h (B,H,W,C) or null.
extern "C" int dvie_bb_chain_fwd(const void *x, const void *w1u, const void *w2u, void *y, void *h,
                                 int B, int H, int W, int C, void *stream) {
  return dvie::dispatch<false>(C, x, nullptr, nullptr, w1u, w2u, y, h, nullptr, B, H, W, stream);
}

// One BasicBlock backward but its weight grads.  dy, y, h (B,H,W,C): the
// output grad and what the forward stored; w1u, w2u: the flipped and
// transposed taps of k2 and k1 (the transposed convs as SAME convs), as
// units.  Outputs: dx, dpre_h, dpre_y (B,H,W,C) bf16.
extern "C" int dvie_bb_chain_bwd(const void *dy, const void *y, const void *h, const void *w1u,
                                 const void *w2u, void *dx, void *dpre_h, void *dpre_y, int B,
                                 int H, int W, int C, void *stream) {
  return dvie::dispatch<true>(C, dy, y, h, w1u, w2u, dx, dpre_h, dpre_y, B, H, W, stream);
}

// The weight grads of n <= 16 convs of one chain in one launch.  ptrs (a
// host array): n triples (a, d, out), a and d (B,H,W,C) bf16, out
// (splits, 9, C, C) f32 partials over `splits` pixel ranges.
extern "C" int dvie_bb_chain_wgrad(const void *ptrs, int n, int C, int B, int H, int W,
                                   int splits, void *stream) {
  using namespace dvie;
  if (n < 1 || n > MAX_JOBS || C % 64 || splits < 1) return (int)cudaErrorInvalidValue;
  GJobs jobs;
  const void *const *p = (const void *const *)ptrs;
  for (int i = 0; i < n; ++i) {
    jobs.a[i] = (const bf16 *)p[3 * i];
    jobs.d[i] = (const bf16 *)p[3 * i + 1];
    jobs.out[i] = (float *)p[3 * i + 2];
  }
  cudaError_t e =
      cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (e != cudaSuccess) return (int)e;
  const int nch = C / 64;
  wgrad_kernel<<<dim3((unsigned)(nch * nch * splits), (unsigned)n), GNT, GSMEM,
                 (cudaStream_t)stream>>>(jobs, C, B, H, W, splits);
  return (int)cudaGetLastError();
}
