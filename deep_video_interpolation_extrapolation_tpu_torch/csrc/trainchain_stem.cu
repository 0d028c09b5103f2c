// The HRNet stem in training: forward and backward, NHWC bf16, f32
// accumulation.
//   pre1 = bf16(conv3x3(x, k1)) + b1    s1 = lrelu(pre1)      (14 -> 64 ch)
//   pre2 = bf16(conv3x3(s1, k2)) + b2   y  = lrelu(pre2)      (64 -> 64 ch)
// with bias adds and lrelu in bf16, as ops/pallas_trainchain.py rounds.
// Backward: dpre2 = lrelu'(y) * dy; ds1 = bf16(conv_t(dpre2, k2)); dpre1 =
// lrelu'(s1) * ds1; dx = bf16(conv_t(dpre1, k1)); dk1, db1, dk2, db2 in f32.
//
// Replaces ops/pallas_trainchain.py:packed_stem: the forward kernel
// _stem_fwd_kernel (pallas_call at :530) and the backward _stem_bwd_kernel
// (:565).  The TPU kernel's width packing and its batch-only grid (one
// whole 128x128 plane per program) exist for its 128-lane VMEM and are
// dropped.  Its backward recomputes pre1, s1 and pre2; here the forward
// stores s1 when autograd will need it, y is the output it stores anyway,
// and the lrelu masks are their signs (a bf16 lrelu keeps the sign), so the
// backward recomputes nothing.
//
// Bound on the H100 at the recipe shape (24x128x128, M = 393,216 pixels):
//   forward: 2*M*(126*64 + 576*64) = 35.3 GFLOP (k1's 14 input channels):
//   36 us of tensor cores at 989 TFLOP/s; x 11 MB + y 50 MB (+ s1 50 MB
//   when stored): 18-33 us of HBM.  Operations.
//   backward: ds1, dx, dk2 and dk1, 2*M*(576*64 + 576*14 + 576*64 +
//   126*64) = 70 GFLOP (71 us) against dy, y, s1, x in, dx out and dpre2,
//   dpre1 out and back in (~320 MB, 96 us): bytes, barely.  (chip_smoke's
//   yardstick for this row still counts the recompute of the JAX kernel:
//   three passes, 0.107 ms.)
//
// Design: every conv is an implicit GEMM on wgmma (hopper.cuh), M = pixels,
// A from registers by ldmatrix at each lane's tap-shifted row of a region
// staged in shared memory (16 bytes of padding per position: conflict-free
// ldmatrix), B resident in shared memory for the whole block (loaded once
// by bulk TMA copies, laid out by ops/trainchain.stem_units).  Persistent
// blocks of three warpgroups walk 8x16 pixel tiles; the next tile's region
// is loaded (cp.async) while the tile's second conv runs, which no longer
// reads it.  As in the BasicBlock chain (trainchain_basicblock.cu), conv1's
// output rows are the tile's 1-ring positions (10 x 18, three m-tiles, one
// a warpgroup) and conv2's the tile's 128 pixels (two m-tiles; the third
// warpgroup recomputes the last and stores nothing: no wgmma sits under a
// thread-dependent branch, C7518).
// - Forward, one launch: x (16 ch, zero-padded from 14 by the wrapper) on
//   the 2-ring; conv1 (K = 9 taps x 16: one k16 step a tap, 18 KB of k1)
//   -> s1 on the 1-ring in shared memory, zero outside the image (conv2's
//   SAME padding), stored at the tile when autograd needs it; conv2 (72 KB
//   of k2); bias, lrelu and the bf16 rounding from the accumulators, staged
//   per warp for 16-byte stores.
// - Backward, one launch: dy on the 2-ring, masked in place by the sign of
//   y (dpre2, stored at the tile); ds1 on the 1-ring with the flipped k2
//   (72 KB), dpre1 = lrelu'(s1) * ds1 there, zero outside the image, stored
//   at the tile; dx on the tile with the flipped k1 (wgmma m64n16, 18 KB).
// - Weight grads, one launch (stem_wgrad_kernel), the BasicBlock chain's
//   wgrad_kernel at K = pixels: a block stages d (dpre2 or dpre1) at a
//   pixel tile as MN-major core matrices (B by descriptor) and the 1-ring
//   of a (s1 or x) and forms the tap products from shifted views of a by
//   ldmatrix.trans.  dk2 (64 x 64 a tap): each warpgroup three taps of one
//   tile.  dk1 (16 x 64 a tap): four taps stacked in the 64 rows of one
//   wgmma, one per warp, so three accumulators cover the nine taps, and
//   each warpgroup takes its own tile.  db2 and db1: f32 sums of the staged
//   d by the CUDA cores.  f32 partials per pixel range, summed by the
//   wrapper: deterministic, no atomics.
//
// Prediction (written before the first chip run of this design, NVIDIA
// H100 at 700 W): at 24x128x128 the forward 0.666 -> 0.15-0.30 ms, the
// backward with its weight grads 2.684 -> 0.6-1.1 ms; the b0 train step up
// 2-4%.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;
using hop::tiled::inside;
using hop::tiled::n_tiles;
using hop::tiled::pix;
using hop::tiled::Tile;
using hop::tiled::tile_at;

constexpr int TH = 8, TW = 16;
constexpr int NWG = 3, NT = NWG * 128;
constexpr int CI = 16, C = 64;
constexpr int PW2 = TW + 4, NPOS2 = (TH + 4) * PW2;  // the 2-ring region: 240
constexpr int PW1 = TW + 2, NPOS1 = (TH + 2) * PW1;  // the 1-ring: 180
constexpr int LDX = CI + 8, LDS = C + 8;             // region pitches, elements
constexpr int UK1 = 2 * 64 * 8 * 2;   // a k1 tap: (2 k-groups, 64 n, 8 k) bf16
constexpr int UK2 = 8 * 64 * 8 * 2;   // a k2 tap: (8, 64, 8)
constexpr int UKX = 8 * 16 * 8 * 2;   // a flipped k1 tap for dx: (8, 16, 8)
constexpr int ST = 16 * LDS * 2;      // a warp's y staging rows

// forward
constexpr int F_W1 = 0, F_W2 = F_W1 + 9 * UK1, F_X = F_W2 + 9 * UK2;
constexpr int F_H = F_X + NPOS2 * LDX * 2, F_ST = F_H + NPOS1 * LDS * 2;
constexpr int F_BAR = F_ST + 8 * ST, F_SMEM = F_BAR + 8;
// backward
constexpr int B_W2 = 0, B_WX = B_W2 + 9 * UK2, B_D = B_WX + 9 * UKX;
constexpr int B_H = B_D + NPOS2 * LDS * 2, B_BAR = B_H + NPOS1 * LDS * 2, B_SMEM = B_BAR + 8;
static_assert(F_SMEM <= 232448 && B_SMEM <= 232448, "shared memory per block");

__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma64<0>(d, a, b);
}
__device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  wgmma16(d, a, b);
}

// the A fragments of tap t: KS k-steps of 16 channels at this lane's row
// `abase` (centre tap) shifted by the tap, on a region of pitch PW
// positions of LD elements
template <int KS, int PW, int LD>
__device__ __forceinline__ void ld_tap(uint32_t (&a)[KS][4], uint32_t abase, int t) {
  const uint32_t off = ((t / 3 - 1) * PW + t % 3 - 1) * LD * 2;
#pragma unroll
  for (int j = 0; j < KS; ++j) ldsm4(a[j], abase + off + j * 32);
}

template <int KS, int N, int LBO>
__device__ __forceinline__ void mma_tap(float (&acc)[N], const uint32_t (&a)[KS][4],
                                        uint32_t wtap) {
  wg_fence();
#pragma unroll
  for (int j = 0; j < KS; ++j) mma(acc, a[j], desc(wtap + j * 2 * LBO, LBO, 128));
  wg_commit();
  wg_wait<1>();
}

// acc = conv3x3 over this warpgroup's m-tile: A at `abase`, the resident
// tap units at `wbase` (TB bytes a tap, LBO between k-groups); the next
// tap's A is loaded while the current tap's wgmmas run
template <int KS, int PW, int LD, int TB, int LBO, int N>
__device__ __forceinline__ void conv9(float (&acc)[N], uint32_t abase, uint32_t wbase) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  uint32_t a0[KS][4], a1[KS][4];
  ld_tap<KS, PW, LD>(a0, abase, 0);
#pragma unroll 1
  for (int t = 0; t < 8; t += 2) {
    mma_tap<KS, N, LBO>(acc, a0, wbase + t * TB);
    ld_tap<KS, PW, LD>(a1, abase, t + 1);
    mma_tap<KS, N, LBO>(acc, a1, wbase + (t + 1) * TB);
    ld_tap<KS, PW, LD>(a0, abase, t + 2);
  }
  mma_tap<KS, N, LBO>(acc, a0, wbase + 8 * TB);
  wg_wait<0>();
  fence_acc(acc);
}

// the nine tap units of each resident weight, once per block
__device__ __forceinline__ void load_weights(uint64_t *bar, unsigned char *d0,
                                             const bf16 *__restrict__ w0, int b0,
                                             unsigned char *d1, const bf16 *__restrict__ w1,
                                             int b1) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, 9 * (b0 + b1));
    for (int t = 0; t < 9; ++t) {
      bulk_load(d0 + t * b0, w0 + t * (b0 / 2), b0, bar);
      bulk_load(d1 + t * b1, w1 + t * (b1 / 2), b1, bar);
    }
  }
  __syncthreads();
}

// cp.async the 2-ring region of tile t of an NHWC tensor of CH channels
// (zeros outside the image), position pitch LD
template <int CH, int LD>
__device__ __forceinline__ void load_region(bf16 *Xs, const bf16 *__restrict__ src, const Tile &t,
                                            int H, int W) {
  constexpr int V = CH / 8;
  for (int i = threadIdx.x; i < NPOS2 * V; i += NT) {
    const int l = i / V, c = (i % V) * 8;
    const int yy = t.y0 - 2 + l / PW2, xx = t.x0 - 2 + l % PW2;
    const bool ok = inside(yy, xx, H, W);
    cp_async16(Xs + l * LD + c, ok ? src + pix(t.b, yy, xx, H, W) * CH + c : src, ok);
  }
}

// 64 channels of the 1-ring buffer Hs at the tile's pixels -> dst
__device__ __forceinline__ void store_tile(bf16 *__restrict__ dst, const bf16 *Hs, const Tile &t,
                                           int H, int W) {
  for (int i = threadIdx.x; i < TH * TW * 8; i += NT) {
    const int px = i >> 3, v = i & 7;
    const int yy = t.y0 + px / TW, xx = t.x0 + px % TW;
    if (inside(yy, xx, H, W))
      st16(dst + pix(t.b, yy, xx, H, W) * C + v * 8,
           *reinterpret_cast<const uint4 *>(Hs + ((px / TW + 1) * PW1 + px % TW + 1) * LDS + v * 8));
  }
}

__device__ __forceinline__ float masked(float s, float g) { return s >= 0.f ? g : rbf(0.2f * g); }

// this lane's ldmatrix rows: conv1 on the 1-ring (row i of m-tile wg is
// 1-ring position i, clamped past the end) over a 2-ring region of pitch
// LD; conv2 on the tile (row i is tile pixel i) over the 1-ring buffer
struct Rows {
  uint32_t a1, a2;
  int er, ec;  // accumulator row (of the block's) and column of this thread
};

template <int LD>
__device__ __forceinline__ Rows rows_of(uint32_t region, uint32_t ring1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wq = warp & 3;
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int i1 = min(wg * 64 + lr, NPOS1 - 1), i2 = min(wg * 64 + lr, TH * TW - 1);
  Rows r;
  r.a1 = region + (((i1 / PW1 + 1) * PW2 + i1 % PW1 + 1) * LD + lk) * 2;
  r.a2 = ring1 + (((i2 / TW + 1) * PW1 + i2 % TW + 1) * LDS + lk) * 2;
  r.er = wg * 64 + wq * 16 + (lane >> 2);
  r.ec = 2 * (lane & 3);
  return r;
}

// ---- forward ------------------------------------------------------------------

// x (B,H,W,16); w1u, w2u: the tap units of k1 and k2; b1, b2 (64,); y
// (B,H,W,64); s1o (B,H,W,64) or null
__global__ void __launch_bounds__(NT, 1)
stem_fwd_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w1u,
                const bf16 *__restrict__ b1, const bf16 *__restrict__ w2u,
                const bf16 *__restrict__ b2, bf16 *__restrict__ y, bf16 *__restrict__ s1o, int B,
                int H, int W) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *wbar = reinterpret_cast<uint64_t *>(smem + F_BAR);
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + F_X);
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + F_H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wq = warp & 3;
  const int nt = n_tiles(B, H, W, TH);
  load_weights(wbar, smem + F_W1, w1u, UK1, smem + F_W2, w2u, UK2);
  const Rows rw = rows_of<LDX>(smem_u32(Xs), smem_u32(Hs));
  bf16 *Ss = reinterpret_cast<bf16 *>(smem + F_ST + (warp & 7) * ST);
  float bias1[16], bias2[16];  // this thread's columns 8j + ec, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 u = tiled::ld2(b1 + 8 * j + rw.ec), v = tiled::ld2(b2 + 8 * j + rw.ec);
    bias1[2 * j] = u.x, bias1[2 * j + 1] = u.y, bias2[2 * j] = v.x, bias2[2 * j + 1] = v.y;
  }

  if (blockIdx.x < nt) load_region<CI, LDX>(Xs, x, tile_at(blockIdx.x, TH, H, W), H, W);
  cp_async_commit();
  mbar_wait(wbar, 0);
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x) {
    const Tile t = tile_at(ti, TH, H, W);
    cp_async_wait<0>();
    __syncthreads();  // the region has landed; the last tile's conv2 is done with Hs

    // ---- conv1 on the 1-ring -> s1 = lrelu(bf16(acc) + b1), 0 outside
    float acc[32];
    conv9<1, PW2, LDX, UK1, 1024>(acc, rw.a1, smem_u32(smem + F_W1));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = rw.er + 8 * hh;
      if (i >= NPOS1) continue;
      const bool ok = inside(t.y0 - 1 + i / PW1, t.x0 - 1 + i % PW1, H, W);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v0 = lrelu_bf(rbf(rbf(acc[4 * j + 2 * hh]) + bias1[2 * j]));
        float v1 = lrelu_bf(rbf(rbf(acc[4 * j + 2 * hh + 1]) + bias1[2 * j + 1]));
        tiled::st2(Hs + i * LDS + 8 * j + rw.ec, ok ? v0 : 0.f, ok ? v1 : 0.f);
      }
    }
    __syncthreads();  // Hs is whole; nothing reads Xs any more
    if (s1o) store_tile(s1o, Hs, t, H, W);
    if (ti + gridDim.x < nt) load_region<CI, LDX>(Xs, x, tile_at(ti + gridDim.x, TH, H, W), H, W);
    cp_async_commit();

    // ---- conv2 on the tile -> y = lrelu(bf16(acc) + b2), one tile row a warp
    conv9<4, PW1, LDS, UK2, 1024>(acc, rw.a2, smem_u32(smem + F_W2));
    if (wg < 2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tiled::st2(Ss + ((lane >> 2) + 8 * hh) * LDS + 8 * j + rw.ec,
                     lrelu_bf(rbf(rbf(acc[4 * j + 2 * hh]) + bias2[2 * j])),
                     lrelu_bf(rbf(rbf(acc[4 * j + 2 * hh + 1]) + bias2[2 * j + 1])));
      __syncwarp();
      const int yy = t.y0 + wg * 4 + wq;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane + 32 * k, col = i >> 3, v = i & 7;
        if (inside(yy, t.x0 + col, H, W))
          st16(y + pix(t.b, yy, t.x0 + col, H, W) * C + v * 8,
               *reinterpret_cast<const uint4 *>(Ss + col * LDS + v * 8));
      }
    }
  }
  cp_async_wait<0>();
}

// ---- backward -----------------------------------------------------------------

// dy, y, s1 (B,H,W,64); w2f: the flipped k2 tap units; wxf: the flipped k1
// tap units (64 -> 16); out: dpre2, dpre1 (B,H,W,64), dx (B,H,W,cx)
__global__ void __launch_bounds__(NT, 1)
stem_bwd_kernel(const bf16 *__restrict__ dy, const bf16 *__restrict__ y,
                const bf16 *__restrict__ s1, const bf16 *__restrict__ w2f,
                const bf16 *__restrict__ wxf, bf16 *__restrict__ dpre2, bf16 *__restrict__ dpre1,
                bf16 *__restrict__ dx, int B, int H, int W, int cx) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *wbar = reinterpret_cast<uint64_t *>(smem + B_BAR);
  bf16 *Ds = reinterpret_cast<bf16 *>(smem + B_D);
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + B_H);
  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  const int nt = n_tiles(B, H, W, TH);
  load_weights(wbar, smem + B_W2, w2f, UK2, smem + B_WX, wxf, UKX);
  const Rows rw = rows_of<LDS>(smem_u32(Ds), smem_u32(Hs));

  if (blockIdx.x < nt) load_region<C, LDS>(Ds, dy, tile_at(blockIdx.x, TH, H, W), H, W);
  cp_async_commit();
  mbar_wait(wbar, 0);
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x) {
    const Tile t = tile_at(ti, TH, H, W);
    cp_async_wait<0>();
    __syncthreads();
    // dpre2 = lrelu'(y) * dy on the region, in place; stored at the tile
    for (int i = threadIdx.x; i < NPOS2 * 8; i += NT) {
      const int l = i >> 3, c = (i & 7) * 8, ry = l / PW2, rx = l % PW2;
      const int yy = t.y0 - 2 + ry, xx = t.x0 - 2 + rx;
      if (!inside(yy, xx, H, W)) continue;
      const long m = pix(t.b, yy, xx, H, W) * C + c;
      float sv[8], gv[8];
      unpack8(ldg16(y + m), sv);
      unpack8(*reinterpret_cast<const uint4 *>(Ds + l * LDS + c), gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) gv[k] = masked(sv[k], gv[k]);
      const uint4 g = pack8(gv);
      st16(Ds + l * LDS + c, g);
      if (ry >= 2 && ry < TH + 2 && rx >= 2 && rx < TW + 2) st16(dpre2 + m, g);
    }
    __syncthreads();

    // ---- ds1 on the 1-ring; dpre1 = lrelu'(s1) * bf16(ds1), 0 outside
    float acc[32];
    conv9<4, PW2, LDS, UK2, 1024>(acc, rw.a1, smem_u32(smem + B_W2));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = rw.er + 8 * hh;
      if (i >= NPOS1) continue;
      const int yy = t.y0 - 1 + i / PW1, xx = t.x0 - 1 + i % PW1;
      const bool ok = inside(yy, xx, H, W);
      const long m = ok ? pix(t.b, yy, xx, H, W) * C : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + rw.ec;
        const float2 s = tiled::ld2(s1 + m + c);
        const float v0 = masked(s.x, rbf(acc[4 * j + 2 * hh]));
        const float v1 = masked(s.y, rbf(acc[4 * j + 2 * hh + 1]));
        tiled::st2(Hs + i * LDS + c, ok ? v0 : 0.f, ok ? v1 : 0.f);
      }
    }
    __syncthreads();  // Hs is whole; nothing reads Ds any more
    store_tile(dpre1, Hs, t, H, W);
    if (ti + gridDim.x < nt) load_region<C, LDS>(Ds, dy, tile_at(ti + gridDim.x, TH, H, W), H, W);
    cp_async_commit();

    // ---- dx = bf16(conv_t(dpre1, k1)) on the tile, 16 columns (cx kept)
    float ax[8];
    conv9<4, PW1, LDS, UKX, 256>(ax, rw.a2, smem_u32(smem + B_WX));
    if (wg < 2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = rw.er + 8 * hh;
        const int yy = t.y0 + i / TW, xx = t.x0 + i % TW;
        if (!inside(yy, xx, H, W)) continue;
        bf16 *o = dx + pix(t.b, yy, xx, H, W) * cx;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * j + rw.ec;
          const __nv_bfloat162 v = __floats2bfloat162_rn(ax[4 * j + 2 * hh], ax[4 * j + 2 * hh + 1]);
          if (c + 1 < cx && !(cx & 1)) {
            *reinterpret_cast<__nv_bfloat162 *>(o + c) = v;
          } else {
            if (c < cx) o[c] = v.x;
            if (c + 1 < cx) o[c + 1] = v.y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- weight grads -------------------------------------------------------------
//
// Blocks [0, s0): dk2 and db2 over pixel range blockIdx.x of s0 (a = s1, d
// = dpre2); blocks [s0, s0 + s1): dk1 and db1 over range blockIdx.x - s0 of
// s1 (a = x, 16 channels; d = dpre1).  Per pipeline step a dk2 block takes
// one 8x16 tile (three taps a warpgroup), a dk1 block three (one a
// warpgroup, its four warps' rows four taps of each wgmma).  Both run the
// same instructions on other addresses.

constexpr int G_D = TH * TW * 64 * 2;                 // d at a tile: 16 KB
constexpr int G_SLOT2 = align128(NPOS1 * LDS * 2 + G_D), G_SLOT1 = align128(NPOS1 * LDX * 2 + G_D);
constexpr int G_STAGE = G_SLOT2 > 3 * G_SLOT1 ? G_SLOT2 : 3 * G_SLOT1;
constexpr int G_SUM = 2 * G_STAGE, G_SMEM = G_SUM + 6 * 64 * 4;
static_assert(G_SMEM <= 232448, "shared memory per block");

// dk2p (s0, 9, 64, 64), dk1p (3 s1, 9, 16, 64): f32 partials [tap, input
// channel, output channel]; dbp (s0 + s1, 64): db2 then db1 partials
__global__ void __launch_bounds__(NT, 1)
stem_wgrad_kernel(const bf16 *__restrict__ s1, const bf16 *__restrict__ dpre2,
                  const bf16 *__restrict__ x, const bf16 *__restrict__ dpre1,
                  float *__restrict__ dk2p, float *__restrict__ dk1p, float *__restrict__ dbp,
                  int B, int H, int W, int s0, int s1n) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const bool k1job = blockIdx.x >= s0;
  const int split = k1job ? blockIdx.x - s0 : blockIdx.x, splits = k1job ? s1n : s0;
  const bf16 *__restrict__ a = k1job ? x : s1;
  const bf16 *__restrict__ dg = k1job ? dpre1 : dpre2;
  const int ca = k1job ? CI : C, lda = k1job ? LDX : LDS;  // a's channels and pitch
  const int nslot = k1job ? 3 : 1, slot_b = k1job ? G_SLOT1 : G_SLOT2;
  const int a_b = NPOS1 * lda * 2;  // a's region, then d, in a slot
  const int nt = n_tiles(B, H, W, TH);
  const int t0 = (int)((long)split * nt / splits), t1 = (int)((long)(split + 1) * nt / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wq = warp & 3;

  auto load = [&](int ti, int buf) {  // tiles ti .. ti + nslot - 1 (zeros past t1)
    for (int g = 0; g < nslot; ++g) {
      const int tg = ti + g;
      const bool have = tg < t1;
      const Tile t = tile_at(have ? tg : t0, TH, H, W);
      bf16 *As = reinterpret_cast<bf16 *>(smem + buf * G_STAGE + g * slot_b);
      bf16 *Ds = reinterpret_cast<bf16 *>(smem + buf * G_STAGE + g * slot_b + a_b);
      const int va = ca / 8;
      for (int i = threadIdx.x; i < NPOS1 * va; i += NT) {
        const int l = i / va, v = i % va;
        const int yy = t.y0 - 1 + l / PW1, xx = t.x0 - 1 + l % PW1;
        const bool ok = have && inside(yy, xx, H, W);
        cp_async16(As + l * lda + v * 8, ok ? a + pix(t.b, yy, xx, H, W) * ca + v * 8 : a, ok);
      }
      // d in MN-major core matrices: (pixel group of 8, channel group of 8)
      for (int i = threadIdx.x; i < TH * TW * 8; i += NT) {
        const int p = i >> 3, v = i & 7;
        const int yy = t.y0 + p / TW, xx = t.x0 + p % TW;
        const bool ok = have && inside(yy, xx, H, W);
        cp_async16(Ds + ((p >> 3) * 8 + v) * 64 + (p & 7) * 8,
                   ok ? dg + pix(t.b, yy, xx, H, W) * C + v * 8 : dg, ok);
      }
    }
  };

  // this warpgroup's slot, and the tap of each accumulator k at this warp:
  // dk2 3 wg + k (rows: input channels 16 wq ...); dk1 4 k + wq (rows:
  // the 16 input channels; taps 9-11 are computed and dropped)
  const int sg = k1job ? wg : 0;
  // ldmatrix.trans: lane gives pixel (lane & 7) + 8 (lane >> 4) of the
  // k-step's tile row, channels lc ...
  const int lp = (lane & 7) + 8 * (lane >> 4);
  const int lc = (k1job ? 0 : 16 * wq) + 8 * ((lane >> 3) & 1);
  uint32_t abase[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int tap = k1job ? min(4 * k + wq, 8) : 3 * wg + k;
    abase[k] = smem_u32(smem + sg * slot_b) + (((tap / 3) * PW1 + tap % 3 + lp) * lda + lc) * 2;
  }
  const uint32_t kstride = PW1 * lda * 2;  // one tile row further down

  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[k][i] = 0.f;
  float bsum = 0.f;  // db of channel threadIdx.x % 64 over pixels threadIdx.x / 64 + 6 i

  if (t0 < t1) load(t0, 0);
  cp_async_commit();
  for (int ti = t0, it = 0; ti < t1; ti += nslot, ++it) {
    if (ti + nslot < t1) load(ti + nslot, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();  // d is read by wgmma
    __syncthreads();
    const uint32_t stage = (it & 1) * G_STAGE;
    const uint32_t dsm = smem_u32(smem + stage + sg * slot_b + a_b);
    uint32_t a0[3][4], a1[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) ldsm4t(a0[k], abase[k] + stage);
#pragma unroll 1
    for (int ks = 0; ks < TH; ks += 2) {
      wg_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k) wgmma64<1>(acc[k], a0[k], desc(dsm + ks * 2048, 1024, 128));
      wg_commit();
      wg_wait<1>();
#pragma unroll
      for (int k = 0; k < 3; ++k) ldsm4t(a1[k], abase[k] + stage + (ks + 1) * kstride);
      wg_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wgmma64<1>(acc[k], a1[k], desc(dsm + (ks + 1) * 2048, 1024, 128));
      wg_commit();
      wg_wait<1>();
      if (ks + 2 < TH) {
#pragma unroll
        for (int k = 0; k < 3; ++k) ldsm4t(a0[k], abase[k] + stage + (ks + 2) * kstride);
      }
    }
    // the bias grads from the staged d, while the last wgmmas run
    {
      const int c = threadIdx.x & 63;
      for (int g = 0; g < nslot; ++g) {
        const bf16 *Ds = reinterpret_cast<const bf16 *>(smem + stage + g * slot_b + a_b);
        for (int p = threadIdx.x >> 6; p < TH * TW; p += NT / 64)
          bsum += bf(Ds[((p >> 3) * 8 + (c >> 3)) * 64 + (p & 7) * 8 + (c & 7)]);
      }
    }
    wg_wait<0>();
    __syncthreads();  // this stage is refilled next iteration
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) fence_acc(acc[k]);
  // weight-grad partials
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = (lane >> 2) + 8 * hh;
      const int tap = k1job ? 4 * k + wq : 3 * wg + k;
      if (tap > 8) continue;
      float *row = k1job ? dk1p + (((long)(3 * split + wg) * 9 + tap) * CI + r) * C
                         : dk2p + (((long)split * 9 + tap) * C + 16 * wq + r) * C;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2 *>(row + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[k][4 * j + 2 * hh], acc[k][4 * j + 2 * hh + 1]);
    }
  // bias-grad partial: the six pixel groups of each channel summed in order
  float *sums = reinterpret_cast<float *>(smem + G_SUM);
  sums[threadIdx.x] = bsum;
  __syncthreads();
  if (threadIdx.x < 64) {
    float s = 0.f;
    for (int r = 0; r < NT / 64; ++r) s += sums[r * 64 + threadIdx.x];
    dbp[(long)blockIdx.x * 64 + threadIdx.x] = s;
  }
}

template <class Kern, class... Args>
int launch(Kern kern, int smem_bytes, int blocks, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  kern<<<blocks < sms ? blocks : sms, NT, smem_bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// The forward.  x16 (B,H,W,16): x zero-padded from 14 channels; w1u: k1 as
// 9 tap units (2, 64, 8) bf16 (rows 14, 15 of each tap zero); w2u: k2 as 9
// tap units (8, 64, 8); b1, b2 (64,); y (B,H,W,64); s1 (B,H,W,64) or NULL
// (not stored).  All bf16 (ops/trainchain.py: stem_units).
extern "C" int dvie_stem_fwd(const void *x16, const void *w1u, const void *b1, const void *w2u,
                             const void *b2, void *y, void *s1, int B, int H, int W,
                             void *stream) {
  using dvie::bf16;
  return dvie::launch(dvie::stem_fwd_kernel, dvie::F_SMEM,
                      (int)dvie::hop::tiled::n_tiles(B, H, W, dvie::TH), (cudaStream_t)stream,
                      (const bf16 *)x16, (const bf16 *)w1u, (const bf16 *)b1, (const bf16 *)w2u,
                      (const bf16 *)b2, (bf16 *)y, (bf16 *)s1, B, H, W);
}

// The backward: one launch for dx, one for the weight grads.  dy, y, s1
// (B,H,W,64): the output grad and what the forward stored; x16 (B,H,W,16);
// w2f: the flipped transposed k2 as 9 tap units (8, 64, 8); wxf: the
// flipped transposed k1 as 9 tap units (8, 16, 8).  Scratch: dpre2, dpre1
// (B,H,W,64) bf16.  Outputs: dx (B,H,W,cx) bf16, cx <= 16; f32 partials
// dk2p (s0, 9, 64, 64), dk1p (3 s1, 9, 16, 64), dbp (s0 + s1, 64): db2's
// s0 rows, then db1's.
extern "C" int dvie_stem_bwd(const void *dy, const void *y, const void *s1, const void *x16,
                             const void *w2f, const void *wxf, void *dpre2, void *dpre1, void *dx,
                             void *dk2p, void *dk1p, void *dbp, int B, int H, int W, int cx,
                             int s0, int s1n, void *stream) {
  using dvie::bf16;
  cudaStream_t st = (cudaStream_t)stream;
  if (cx < 1 || cx > dvie::CI || s0 < 1 || s1n < 1) return (int)cudaErrorInvalidValue;
  int e = dvie::launch(dvie::stem_bwd_kernel, dvie::B_SMEM,
                       (int)dvie::hop::tiled::n_tiles(B, H, W, dvie::TH), st, (const bf16 *)dy,
                       (const bf16 *)y, (const bf16 *)s1, (const bf16 *)w2f, (const bf16 *)wxf,
                       (bf16 *)dpre2, (bf16 *)dpre1, (bf16 *)dx, B, H, W, cx);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(dvie::stem_wgrad_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, dvie::G_SMEM);
  if (ce != cudaSuccess) return (int)ce;
  dvie::stem_wgrad_kernel<<<(unsigned)(s0 + s1n), dvie::NT, dvie::G_SMEM, st>>>(
      (const bf16 *)s1, (const bf16 *)dpre2, (const bf16 *)x16, (const bf16 *)dpre1,
      (float *)dk2p, (float *)dk1p, (float *)dbp, B, H, W, s0, s1n);
  return (int)cudaGetLastError();
}
