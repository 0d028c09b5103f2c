// The layer1 Bottleneck in training: forward and backward, NHWC bf16, f32
// accumulation.
//   h1 = lrelu(bf16(x . k1))            (Ci -> 64)
//   h2 = lrelu(bf16(conv3x3(h1, k2)))   (64 -> 64)
//   pre_y = bf16(h2 . k3) + (bf16(x . kres) if kres else x)   (-> 256)
//   y = lrelu(pre_y)
// with residual adds and lrelu in bf16, as ops/pallas_trainchain.py rounds.
// The kernels take the two blocks of the main path: Ci = 64 with kres
// (block 0) and Ci = 256 with the identity residual (blocks 1-3).
//
// Replaces ops/pallas_trainchain.py:packed_bottleneck: the forward kernel
// _bn_fwd_kernel (pallas_call at :400; also pallas_resblock.fused_bottleneck,
// :270, the same function) and the backward _bn_bwd_kernel (:445), which
// recomputes h1, h2 and pre_y and returns dx and per-program f32 dk1, dk2,
// dk3, dkres partials.  Width packing, the A+E split of the taps and the
// batch-only grid are TPU devices and are dropped.
//
// Bound on the H100 at the recipe shape (24x128x128, M = 393,216 pixels):
//   forward: 2*M*(Ci*64 + 576*64 + 64*256) = 54.8 GFLOP at Ci = 256 (55 us
//   at 989 TFLOP/s) against x 201 MB + y 201 MB (120 us at 3.35 TB/s):
//   memory-bound.  h1 and h2 never reach device memory.
//   backward: the forward again, the three transposed products and the
//   four weight grads (about 3x the forward's operations), and the round
//   trips of h1, h2, dpre2, dpre1 (50 MB each) and dpre_y (201 MB).
//
// Design: every product runs on wgmma m64n64k16 (hopper.cuh; the pixel
// tiles and the weight ring are its namespace tiled, shared with K1 and
// K2), B from shared memory, A from registers, f32 accumulators in
// registers.
// - Weights: every (64 input x 64 output channel) block of k1, k2's nine
//   taps, k3, kres and their transposes is an 8 KB unit in the no-swizzle
//   K-major core-matrix order, laid out by the wrapper in the order a tile
//   consumes them; one producer warp streams the units of every tile into
//   an 8-slot ring by bulk TMA copies under full/empty mbarriers.
// - front_kernel (the forward, and the first backward launch): a block
//   owns an 8x16 pixel tile.  x is staged (cp.async) on the 1-pixel ring
//   (10x18 positions, 16 bytes of padding per position against bank
//   conflicts); conv1 runs on the ring positions (3 m-tiles, one per
//   consumer warpgroup; A by ldmatrix at each lane's own row, so the rows
//   are exactly the ring's positions) and writes h1 (zero outside the
//   image) to a ring buffer in shared memory; conv2 reads shifted views of
//   that buffer (one per tap; a shifted view of a swizzled tile would be no
//   valid descriptor, so A again comes by ldmatrix); h2 stays in registers
//   goes through a small per-warpgroup buffer (each warp its own rows) to
//   conv3's A operand, 64 output channels at a time, each chunk with
//   its residual (x . kres from the staged x, or x from device memory),
//   rounded and stored.  The third warpgroup repeats the second's tile
//   rows in conv2 and conv3 and stores nothing: a wgmma under a
//   thread-dependent branch is serialized by ptxas (C7518).  Persistent
//   blocks: the next tile's x lands while conv2 and conv3 run (at Ci = 64
//   into a second buffer, since x . kres still reads the current one).
//   In the backward (BWD) each pre_y chunk becomes dpre_y = lrelu'(pre_y)
//   * dy, is stored and feeds dh2 = dpre_y . k3^T from registers (FA3's
//   P.V: acc_to_a); dpre2 = lrelu'(h2) * bf16(dh2).
// - back_kernel (second backward launch; dh1 on the tile needs dpre2 one
//   ring out, and dpre2 there needs h2 and so h1 two rings out): dpre2
//   staged on the 1-ring, dh1 = bf16(conv_t(dpre2, k2)) as conv2 with the
//   flipped transposed taps, dpre1 = lrelu'(h1) * dh1 (stored), then dx =
//   bf16(dpre1 . k1^T + (dpre_y . kres^T | dpre_y)) per 64 input channels,
//   dpre1 from registers, dpre_y staged by cp.async; rounded once.
// - wgrad_kernel: all four weight grads in one launch, each a sum over
//   pixels of a(p)^T . d(p) (K = pixels): 9 products of 64x64 channel
//   pairs per block, 3 per warpgroup, A = a^T by ldmatrix.trans, B = d in
//   MN-major core matrices.  blockIdx.y = 0: dk2's nine taps, from shifted
//   views of h1 staged on the 1-ring of an 8x16 tile (the BasicBlock
//   chain's weight-grad kernel); 1: the 1x1 products dk1 (x, dpre1), dk3
//   (h2, dpre_y) and dkres (x, dpre_y) on 4x16 tiles, every operand chunk
//   staged once per tile and read by every product that needs it; job 1
//   reads about four times job 0's bytes and gets that many more blocks.
//   f32 partials per pixel range, summed by the wrapper: deterministic, no
//   atomics (pallas_trainchain.py:26-33).  No split-K job per tap.
//
// Prediction (written before the first chip run of this design, NVIDIA
// H100 at 700 W): at 24x128x128, Ci = 256, the forward falls from 1.11 to
// 0.3-0.6 ms and the backward with its weight grads from 3.01 to 0.8-1.5
// ms.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;
using namespace hop::tiled;

constexpr int TH = 8, TP = TH * TW;                  // the pixel tile
constexpr int P = 64, CO = 256;                      // planes, planes * 4
constexpr int PW = TW + 2, NPOS = (TH + 2) * PW;     // its 1-ring: 180 positions
constexpr int LDP = P + 8;                           // pitch of a 64-channel buffer

__device__ __forceinline__ float masked(float s, float g) { return s >= 0.f ? g : rbf(0.2f * g); }

using TapOffP = TapOff<PW, LDP>;  // a tap of a 3x3 conv on a 1-ring buffer of 64 channels

// ---- the forward, and the first backward launch -----------------------------

template <int CI>
struct Front {
  static constexpr bool RES = CI != CO;
  static constexpr int NK = CI / 64;
  static constexpr int LDX = CI + 8;
  static constexpr int NBUF = RES ? 2 : 1;  // x buffers: x . kres reads the current one late
  static constexpr int XB = align128(NPOS * LDX * 2);
  static constexpr int O_X = NST * UB;
  static constexpr int O_H = O_X + NBUF * XB;
  static constexpr int NWG = 3, CT = NWG * 128, NT = CT + 32;
  static constexpr int O_H2 = align128(O_H + NPOS * LDP * 2);  // h2, 64 rows per warpgroup
  static constexpr int O_BAR = align128(O_H2 + NWG * 64 * LDP * 2);
  static constexpr int SMEM = O_BAR + 2 * NST * 8;
  // units per tile: k1 (NK), k2 (9), then per 64 outputs k3 (1), kres (NK),
  // and in the backward k3^T (1)
  static constexpr int U_FWD = NK + 9 + 4 * (1 + (RES ? NK : 0));
  static constexpr int U_BWD = U_FWD + 4;
  static_assert(SMEM <= 232448, "shared memory per block");
};

// BWD = false: out = y (B,H,W,256).  BWD = true: out = dpre2 (B,H,W,64);
// h1 and h2 (B,H,W,64) and dpre_y (B,H,W,256) stored too.
template <int CI, bool BWD>
__global__ void __launch_bounds__(Front<CI>::NT, 1)
front_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ wu, const bf16 *__restrict__ dy,
             bf16 *__restrict__ out, bf16 *__restrict__ h1o, bf16 *__restrict__ h2o,
             bf16 *__restrict__ dpy, int B, int H, int W) {
  using K = Front<CI>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + K::O_H);
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + K::O_BAR), *empty = full + NST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  init_ring(full, empty, 4 * K::NWG);
  if (warp == 4 * K::NWG) {
    if (lane == 0) produce(full, empty, smem, wu, BWD ? K::U_BWD : K::U_FWD, nt);
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  Ring r{full, empty, smem_u32(smem), 0};
  // this lane's ldmatrix row (of its warp's 16) and channel offset
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int i1 = min(wg * 64 + lr, NPOS - 1);  // conv1: a 1-ring position
  const int i2 = min(wg * 64 + lr, TP - 1);    // conv2, conv3: a tile pixel
  const int p2 = (i2 / TW + 1) * PW + i2 % TW + 1;
  // accumulator rows and columns of this thread
  const int er = wg * 64 + wq * 16 + (lane >> 2), ec = 2 * (lane & 3);
  const int lrow = er - wg * 64;  // its row in the warpgroup's h2 buffer
  bf16 *H2s = reinterpret_cast<bf16 *>(smem + K::O_H2) + wg * 64 * LDP;
  const uint32_t h2base = smem_u32(H2s) + (lr * LDP + lk) * 2;
  constexpr int V = CI / 8;

  auto xbuf = [&](int k) {
    return reinterpret_cast<bf16 *>(smem + K::O_X + (k % K::NBUF) * K::XB);
  };
  auto load_region = [&](bf16 *Xs, const Tile &t) {
    for (int i = threadIdx.x; i < NPOS * V; i += K::CT) {
      const int l = i / V, c = (i % V) * 8;
      const int yy = t.y0 - 1 + l / PW, xx = t.x0 - 1 + l % PW;
      const bool ok = inside(yy, xx, H, W);
      cp_async16(Xs + l * K::LDX + c, ok ? x + pix(t.b, yy, xx, H, W) * CI + c : x, ok);
    }
  };

  if (blockIdx.x < nt) load_region(xbuf(0), tile_at(blockIdx.x, TH, H, W));
  cp_async_commit();
  int k = 0;
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x, ++k) {
    const Tile t = tile_at(ti, TH, H, W);
    bf16 *Xs = xbuf(k);
    cp_async_wait<0>();
    bar_sync(1, K::CT);

    // ---- conv1 on the 1-ring: h1 = lrelu(bf16(x . k1)), zero outside
    float acc[32];
    zero32(acc);
    gemm_ld(acc, smem_u32(Xs) + (i1 * K::LDX + lk) * 2, K::NK, ChanOff(), r, false);
    finish(acc, r);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = er + 8 * hh;
      if (i >= NPOS) continue;
      const bool ok = inside(t.y0 - 1 + i / PW, t.x0 - 1 + i % PW, H, W);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v0 = ok ? lrelu_bf(rbf(acc[4 * j + 2 * hh])) : 0.f;
        const float v1 = ok ? lrelu_bf(rbf(acc[4 * j + 2 * hh + 1])) : 0.f;
        st2(Hs + i * LDP + 8 * j + ec, v0, v1);
      }
    }
    bar_sync(1, K::CT);  // h1 is whole; conv1 is done with x
    if (BWD) {           // h1 at the tile's pixels
      for (int i = threadIdx.x; i < TP * (P / 8); i += K::CT) {
        const int px = i / (P / 8), c = (i % (P / 8)) * 8;
        const int yy = t.y0 + px / TW, xx = t.x0 + px % TW;
        if (inside(yy, xx, H, W))
          st16(h1o + pix(t.b, yy, xx, H, W) * P + c,
               *reinterpret_cast<const uint4 *>(Hs + ((px / TW + 1) * PW + px % TW + 1) * LDP + c));
      }
    }
    if (ti + gridDim.x < nt) load_region(xbuf(k + 1), tile_at(ti + gridDim.x, TH, H, W));
    cp_async_commit();

    // ---- conv2 on the tile: h2 = lrelu(bf16(conv3x3(h1, k2))), kept in registers
    zero32(acc);
    gemm_ld(acc, smem_u32(Hs) + (p2 * LDP + lk) * 2, 9, TapOffP(), r, false);
    finish(acc, r);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = lrelu_bf(rbf(acc[e]));
    // h2 to this warp's own rows of the warpgroup's buffer, read back by
    // ldmatrix as conv3's A for each 64 outputs: an A operand kept in
    // registers across other wgmma sequences came back corrupted (Ci = 64:
    // outputs 64-255 wrong; H100, sm_90a)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st2(H2s + (lrow + 8 * hh) * LDP + 8 * j + ec, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    __syncwarp();
    bool vrow[2];
    long mrow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = er + 8 * hh, yy = t.y0 + i / TW, xx = t.x0 + i % TW;
      vrow[hh] = wg < 2 && inside(yy, xx, H, W);
      mrow[hh] = vrow[hh] ? pix(t.b, yy, xx, H, W) : 0;
      if (BWD && vrow[hh]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st2(h2o + mrow[hh] * P + 8 * j + ec, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }

    // ---- conv3 + residual, 64 output channels at a time
    float accd[32];  // the backward's dh2 = dpre_y . k3^T
    zero32(accd);
#pragma unroll 1
    for (int nc = 0; nc < CO / 64; ++nc) {
      float pre[32];
      zero32(pre);
      uint32_t h2a[4][4];
      ld_a(h2a, h2base);
      step(pre, h2a, r, false);
      finish(pre, r);
#pragma unroll
      for (int e = 0; e < 32; ++e) pre[e] = rbf(pre[e]);
      if constexpr (K::RES) {  // + bf16(x . kres)
        float accr[32];
        zero32(accr);
        gemm_ld(accr, smem_u32(Xs) + (p2 * K::LDX + lk) * 2, K::NK, ChanOff(), r, false);
        finish(accr, r);
#pragma unroll
        for (int e = 0; e < 32; ++e) pre[e] = rbf(pre[e] + rbf(accr[e]));
      } else {  // + x
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 xv = vrow[hh] ? ld2(x + mrow[hh] * CO + nc * 64 + 8 * j + ec)
                                       : make_float2(0.f, 0.f);
            pre[4 * j + 2 * hh] = rbf(pre[4 * j + 2 * hh] + xv.x);
            pre[4 * j + 2 * hh + 1] = rbf(pre[4 * j + 2 * hh + 1] + xv.y);
          }
      }
      if constexpr (!BWD) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (vrow[hh]) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              st2(out + mrow[hh] * CO + nc * 64 + 8 * j + ec, lrelu_bf(pre[4 * j + 2 * hh]),
                  lrelu_bf(pre[4 * j + 2 * hh + 1]));
          }
      } else {  // dpre_y = lrelu'(pre_y) * dy, stored, then dh2 += dpre_y . k3^T
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = 4 * j + 2 * hh;
            const float2 g = vrow[hh] ? ld2(dy + mrow[hh] * CO + nc * 64 + 8 * j + ec)
                                      : make_float2(0.f, 0.f);
            pre[e] = masked(pre[e], g.x);
            pre[e + 1] = masked(pre[e + 1], g.y);
            if (vrow[hh]) st2(dpy + mrow[hh] * CO + nc * 64 + 8 * j + ec, pre[e], pre[e + 1]);
          }
        uint32_t da[4][4];
        acc_to_a(da, pre);
        step(accd, da, r, false);
        finish(accd, r);
      }
    }
    if constexpr (BWD) {  // dpre2 = lrelu'(h2) * bf16(dh2)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (vrow[hh]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = 4 * j + 2 * hh;
            const float2 hv = ld2(H2s + (lrow + 8 * hh) * LDP + 8 * j + ec);
            st2(out + mrow[hh] * P + 8 * j + ec, masked(hv.x, rbf(accd[e])),
                masked(hv.y, rbf(accd[e + 1])));
          }
        }
    }
  }
}

// ---- the second backward launch ---------------------------------------------

template <int CI>
struct Back {
  static constexpr bool RES = CI != CO;
  static constexpr int NK = CI / 64;
  static constexpr int LDY = CO + 8;
  static constexpr int DB = align128(NPOS * LDP * 2);
  static constexpr int O_D = NST * UB;                          // dpre2 rings, 2 buffers
  static constexpr int O_Y = O_D + 2 * DB;                      // dpre_y at the tile
  static constexpr int O_BAR = align128(O_Y + (RES ? TP * LDY * 2 : 0));
  static constexpr int SMEM = O_BAR + 2 * NST * 8;
  static constexpr int NWG = 2, CT = NWG * 128, NT = CT + 32;
  // units per tile: k2's flipped transposed taps (9), then per 64 input
  // channels k1^T (1) and kres^T (4)
  static constexpr int U = 9 + NK * (1 + (RES ? 4 : 0));
  static_assert(SMEM <= 232448, "shared memory per block");
};

template <int CI>
__global__ void __launch_bounds__(Back<CI>::NT, 1)
back_kernel(const bf16 *__restrict__ dpre2, const bf16 *__restrict__ h1,
            const bf16 *__restrict__ dpy, const bf16 *__restrict__ wu, bf16 *__restrict__ dpre1,
            bf16 *__restrict__ dx, int B, int H, int W) {
  using K = Back<CI>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16 *Ys = reinterpret_cast<bf16 *>(smem + K::O_Y);
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + K::O_BAR), *empty = full + NST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  init_ring(full, empty, 4 * K::NWG);
  if (warp == 4 * K::NWG) {
    if (lane == 0) produce(full, empty, smem, wu, K::U, nt);
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  Ring r{full, empty, smem_u32(smem), 0};
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int i2 = wg * 64 + lr;
  const int p2 = (i2 / TW + 1) * PW + i2 % TW + 1;
  const int er = wg * 64 + wq * 16 + (lane >> 2), ec = 2 * (lane & 3);

  auto dbuf = [&](int k) { return reinterpret_cast<bf16 *>(smem + K::O_D + (k & 1) * K::DB); };
  auto load_ring = [&](bf16 *Ds, const Tile &t) {  // dpre2 on the 1-ring, zeros outside
    for (int i = threadIdx.x; i < NPOS * (P / 8); i += K::CT) {
      const int l = i / (P / 8), c = (i % (P / 8)) * 8;
      const int yy = t.y0 - 1 + l / PW, xx = t.x0 - 1 + l % PW;
      const bool ok = inside(yy, xx, H, W);
      cp_async16(Ds + l * LDP + c, ok ? dpre2 + pix(t.b, yy, xx, H, W) * P + c : dpre2, ok);
    }
  };

  if (blockIdx.x < nt) load_ring(dbuf(0), tile_at(blockIdx.x, TH, H, W));
  cp_async_commit();
  int k = 0;
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x, ++k) {
    const Tile t = tile_at(ti, TH, H, W);
    cp_async_wait<0>();
    bar_sync(1, K::CT);  // the ring has landed; the previous tile is done with Ys
    if constexpr (K::RES) {
      for (int i = threadIdx.x; i < TP * (CO / 8); i += K::CT) {
        const int px = i / (CO / 8), c = (i % (CO / 8)) * 8;
        const int yy = t.y0 + px / TW, xx = t.x0 + px % TW;
        const bool ok = inside(yy, xx, H, W);
        cp_async16(Ys + px * K::LDY + c, ok ? dpy + pix(t.b, yy, xx, H, W) * CO + c : dpy, ok);
      }
    }
    cp_async_commit();
    if (ti + gridDim.x < nt) load_ring(dbuf(k + 1), tile_at(ti + gridDim.x, TH, H, W));
    cp_async_commit();

    // ---- dh1 = bf16(conv_t(dpre2, k2)); dpre1 = lrelu'(h1) * dh1
    float acc[32];
    zero32(acc);
    gemm_ld(acc, smem_u32(dbuf(k)) + (p2 * LDP + lk) * 2, 9, TapOffP(), r, false);
    finish(acc, r);
    bool vrow[2];
    long mrow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = er + 8 * hh, yy = t.y0 + i / TW, xx = t.x0 + i % TW;
      vrow[hh] = inside(yy, xx, H, W);
      mrow[hh] = vrow[hh] ? pix(t.b, yy, xx, H, W) : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * hh;
        const float2 hv = vrow[hh] ? ld2(h1 + mrow[hh] * P + 8 * j + ec) : make_float2(0.f, 0.f);
        acc[e] = vrow[hh] ? masked(hv.x, rbf(acc[e])) : 0.f;
        acc[e + 1] = vrow[hh] ? masked(hv.y, rbf(acc[e + 1])) : 0.f;
        if (vrow[hh]) st2(dpre1 + mrow[hh] * P + 8 * j + ec, acc[e], acc[e + 1]);
      }
    }
    uint32_t d1a[4][4];
    acc_to_a(d1a, acc);
    if constexpr (K::RES) {  // dpre_y at the tile has landed
      cp_async_wait<1>();
      bar_sync(1, K::CT);
    }

    // ---- dx = bf16(dpre1 . k1^T + (dpre_y . kres^T | dpre_y)), 64 channels at a time
#pragma unroll 1
    for (int cc = 0; cc < K::NK; ++cc) {
      zero32(acc);
      step(acc, d1a, r, false);
      if constexpr (K::RES)
        gemm_ld(acc, smem_u32(Ys) + (i2 * K::LDY + lk) * 2, CO / 64, ChanOff(), r, true);
      finish(acc, r);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (vrow[hh]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = 4 * j + 2 * hh, c = cc * 64 + 8 * j + ec;
            float v0 = acc[e], v1 = acc[e + 1];
            if constexpr (!K::RES) {
              const float2 g = ld2(dpy + mrow[hh] * CO + c);
              v0 += g.x;
              v1 += g.y;
            }
            st2(dx + mrow[hh] * CI + c, v0, v1);
          }
        }
    }
  }
}

// ---- the weight grads ---------------------------------------------------------

constexpr int GLD = 64 + 8;
constexpr int G_REG = align128(NPOS * GLD * 2);    // job 0: h1 on the 1-ring
constexpr int G_STAGE0 = G_REG + TP * 64 * 2;      // + dpre2 at the tile
constexpr int G_ABUF = 64 * GLD * 2;               // job 1: 64 pixels of a 64-ch chunk
constexpr int G_DBUF = 64 * 64 * 2;                // the same, MN-major core matrices
constexpr int G_NA = 5, G_ND = 5;                  // x chunks + h2; dpre1 + dpre_y chunks
constexpr int G_STAGE1 = G_NA * G_ABUF + G_ND * G_DBUF;
constexpr int G_STAGE = G_STAGE0 > G_STAGE1 ? G_STAGE0 : G_STAGE1;
constexpr int GSMEM = 2 * G_STAGE;
constexpr int GNT = 384;  // 3 warpgroups, 3 products each
static_assert(GSMEM <= 232448, "shared memory per block");

// stage 64-channel chunk `c` of `src` (C channels) at pixel p of a tile
// into an MN-major d buffer: core matrix (pixel group, channel group)
__device__ __forceinline__ void stage_d(bf16 *Ds, const bf16 *src, long m, bool ok, int C, int c,
                                        int p, int v) {
  cp_async16(Ds + ((p >> 3) * 8 + v) * 64 + (p & 7) * 8, ok ? src + m * C + c * 64 + v * 8 : src,
             ok);
}

// Blocks [0, s0): job 0 (dk2's nine taps on 8x16 tiles), one pixel range
// each; blocks [s0, s0 + s1): job 1 (the 1x1 products on 4x16 tiles, which
// read about four times the bytes).  out (s0 + s1, 9, 64, 64) f32: [block]
// [product][a channel][d channel].
__global__ void __launch_bounds__(GNT, 1)
wgrad_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ h1, const bf16 *__restrict__ h2,
             const bf16 *__restrict__ dpre2, const bf16 *__restrict__ dpre1,
             const bf16 *__restrict__ dpy, float *__restrict__ out, int B, int H, int W, int Ci,
             int s0, int s1) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int job = blockIdx.x < s0 ? 0 : 1, nk = Ci / 64;
  const int s = job ? blockIdx.x - s0 : blockIdx.x, splits = job ? s1 : s0;
  const int th = job ? 4 : TH;  // tile rows; one k-step (16 pixels) per row
  const int nt = B * ((H + th - 1) / th) * ((W + TW - 1) / TW);
  const int t0 = (int)((long)s * nt / splits), t1 = (int)((long)(s + 1) * nt / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, wq = warp & 3;

  // this warpgroup's three products: where its a and d sit in a stage
  uint32_t aoff[3], doff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int q = 3 * wg + k;
    if (job == 0) {  // tap q of dk2
      aoff[k] = ((q / 3) * PW + q % 3) * GLD * 2;
      doff[k] = G_REG;
    } else {  // dk1 per x chunk, dk3 and dkres per dpre_y chunk (a 9th slot repeats dk1's first)
      int ia = 0, id = 0;
      if (q < nk) {
        ia = q;
      } else if (q < nk + 4) {
        ia = nk;  // h2
        id = 1 + q - nk;
      } else if (nk == 1 && q < 9) {
        id = q - 4;  // x . dpre_y: dkres
      }
      aoff[k] = ia * G_ABUF;
      doff[k] = G_NA * G_ABUF + id * G_DBUF;
    }
  }
  const uint32_t astride = (job ? 16 : PW) * GLD * 2;

  auto load = [&](int ti, int buf) {
    unsigned char *st = smem + buf * G_STAGE;
    const Tile t = tile_at(ti, th, H, W);
    if (job == 0) {
      bf16 *As = reinterpret_cast<bf16 *>(st);
      for (int i = threadIdx.x; i < NPOS * 8; i += GNT) {
        const int l = i >> 3, v = i & 7;
        const int yy = t.y0 - 1 + l / PW, xx = t.x0 - 1 + l % PW;
        const bool ok = inside(yy, xx, H, W);
        cp_async16(As + l * GLD + v * 8, ok ? h1 + pix(t.b, yy, xx, H, W) * P + v * 8 : h1, ok);
      }
      for (int i = threadIdx.x; i < TP * 8; i += GNT) {
        const int p = i >> 3, v = i & 7, yy = t.y0 + p / TW, xx = t.x0 + p % TW;
        const bool ok = inside(yy, xx, H, W);
        stage_d(reinterpret_cast<bf16 *>(st + G_REG), dpre2, ok ? pix(t.b, yy, xx, H, W) : 0, ok, P,
                0, p, v);
      }
    } else {
      // a chunks: x (nk) then h2; d chunks: dpre1 then dpre_y (4)
      const int va = (nk + 1) * 8, vd = 5 * 8;
      for (int i = threadIdx.x; i < 64 * (va + vd); i += GNT) {
        const int p = i / (va + vd), q = i % (va + vd);
        const int yy = t.y0 + p / TW, xx = t.x0 + p % TW;
        const bool ok = inside(yy, xx, H, W);
        const long m = ok ? pix(t.b, yy, xx, H, W) : 0;
        if (q < va) {
          const int c = q >> 3, v = q & 7;
          const bf16 *src = c < nk ? x + m * Ci + c * 64 : h2 + m * P;
          cp_async16(reinterpret_cast<bf16 *>(st + c * G_ABUF) + p * GLD + v * 8,
                     ok ? src + v * 8 : x, ok);
        } else {
          const int c = (q - va) >> 3, v = q & 7;
          bf16 *Ds = reinterpret_cast<bf16 *>(st + G_NA * G_ABUF + c * G_DBUF);
          if (c == 0)
            stage_d(Ds, dpre1, m, ok, P, 0, p, v);
          else
            stage_d(Ds, dpy, m, ok, CO, c - 1, p, v);
        }
      }
    }
  };

  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k) zero32(acc[k]);
  // ldmatrix.trans: lane gives pixel (lane & 7) + 8 (lane >> 4) of the
  // k-step's 16, channels 16 wq + 8 ((lane >> 3) & 1) ...
  const int lp = (lane & 7) + 8 * (lane >> 4), lc = 16 * wq + 8 * ((lane >> 3) & 1);
  const uint32_t lpart = (lp * GLD + lc) * 2;

  if (t0 < t1) load(t0, 0);
  cp_async_commit();
  for (int ti = t0, it = 0; ti < t1; ++ti, ++it) {
    if (ti + 1 < t1) load(ti + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();  // d is read by wgmma
    __syncthreads();
    const uint32_t sb = smem_u32(smem + (it & 1) * G_STAGE);
    uint32_t a0[3][4], a1[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) ldsm4t(a0[k], sb + aoff[k] + lpart);
    // one k-step (16 pixels) of the three products; the next one's A loads
    auto kstep = [&](uint32_t(&cur)[3][4], uint32_t(&nxt)[3][4], int kk) {
      wg_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wgmma64<1>(acc[k], cur[k], desc(sb + doff[k] + kk * 2048, 1024, 128));
      wg_commit();
      wg_wait<1>();
      if (kk + 1 < th) {
#pragma unroll
        for (int k = 0; k < 3; ++k) ldsm4t(nxt[k], sb + aoff[k] + lpart + (kk + 1) * astride);
      }
    };
#pragma unroll 1
    for (int ks = 0; ks < th; ks += 2) {
      kstep(a0, a1, ks);
      kstep(a1, a0, ks + 1);
    }
    wg_wait<0>();
    __syncthreads();  // this stage is refilled next iteration
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) fence_acc(acc[k]);
  float *o = out + (long)blockIdx.x * 9 * 64 * 64;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = 16 * wq + (lane >> 2) + 8 * hh;
      float *row = o + ((long)(3 * wg + k) * 64 + ci) * 64 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2 *>(row + 8 * j) =
            make_float2(acc[k][4 * j + 2 * hh], acc[k][4 * j + 2 * hh + 1]);
    }
}

template <int CI, bool BWD>
int launch_front(const void *x, const void *wu, const void *dy, void *out, void *h1, void *h2,
                 void *dpy, int B, int H, int W, cudaStream_t st) {
  using K = Front<CI>;
  return launch(front_kernel<CI, BWD>, K::NT, K::SMEM, n_tiles(B, H, W, TH), st, (const bf16 *)x,
                (const bf16 *)wu, (const bf16 *)dy, (bf16 *)out, (bf16 *)h1, (bf16 *)h2,
                (bf16 *)dpy, B, H, W);
}

template <int CI>
int launch_back(const void *dpre2, const void *h1, const void *dpy, const void *wu, void *dpre1,
                void *dx, int B, int H, int W, cudaStream_t st) {
  using K = Back<CI>;
  return launch(back_kernel<CI>, K::NT, K::SMEM, n_tiles(B, H, W, TH), st, (const bf16 *)dpre2,
                (const bf16 *)h1, (const bf16 *)dpy, (const bf16 *)wu, (bf16 *)dpre1, (bf16 *)dx,
                B, H, W);
}

}  // namespace
}  // namespace dvie

// The forward.  x (B,H,W,Ci), Ci = 64 (with kres) or 256 (identity
// residual); wu: the forward's weight units in the order of
// Front<Ci>::U_FWD (ops/trainchain.py: bottleneck_units); y (B,H,W,256).
extern "C" int dvie_bottleneck_fwd(const void *x, const void *wu, void *y, int B, int H, int W,
                                   int Ci, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Ci == 64) return dvie::launch_front<64, false>(x, wu, nullptr, y, nullptr, nullptr, nullptr, B, H, W, st);
  if (Ci == 256) return dvie::launch_front<256, false>(x, wu, nullptr, y, nullptr, nullptr, nullptr, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}

// The backward but its weight grads: two launches.  x, dy (B,H,W,256); wf
// and wb: the units of the first (Front<Ci>::U_BWD) and second
// (Back<Ci>::U) launch.  Outputs h1, h2, dpre2, dpre1 (B,H,W,64), dpre_y
// (B,H,W,256) (what the weight grads read) and dx (B,H,W,Ci), bf16.
extern "C" int dvie_bottleneck_bwd(const void *x, const void *dy, const void *wf, const void *wb,
                                   void *h1, void *h2, void *dpre_y, void *dpre2, void *dpre1,
                                   void *dx, int B, int H, int W, int Ci, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int e;
  if (Ci == 64) {
    if ((e = dvie::launch_front<64, true>(x, wf, dy, dpre2, h1, h2, dpre_y, B, H, W, st))) return e;
    return dvie::launch_back<64>(dpre2, h1, dpre_y, wb, dpre1, dx, B, H, W, st);
  }
  if (Ci == 256) {
    if ((e = dvie::launch_front<256, true>(x, wf, dy, dpre2, h1, h2, dpre_y, B, H, W, st))) return e;
    return dvie::launch_back<256>(dpre2, h1, dpre_y, wb, dpre1, dx, B, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The four weight grads in one launch, from what dvie_bottleneck_bwd
// stored: out (s0 + s1, 9, 64, 64) f32 partials over pixel ranges; [0,
// s0): dk2 per tap (input, output channel); [s0, s0 + s1): Ci = 256: dk1
// per 64 x channels (4), dk3 per 64 dpre_y channels (4), unused; Ci = 64:
// dk1, dk3 (4), dkres (4); each (a channel, d channel).
extern "C" int dvie_bottleneck_wgrad(const void *x, const void *h1, const void *h2,
                                     const void *dpre2, const void *dpre1, const void *dpre_y,
                                     void *out, int B, int H, int W, int Ci, int s0, int s1,
                                     void *stream) {
  using namespace dvie;
  if ((Ci != 64 && Ci != 256) || s0 < 1 || s1 < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<<<(unsigned)(s0 + s1), GNT, GSMEM, (cudaStream_t)stream>>>(
      (const bf16 *)x, (const bf16 *)h1, (const bf16 *)h2, (const bf16 *)dpre2, (const bf16 *)dpre1,
      (const bf16 *)dpre_y, (float *)out, B, H, W, Ci, s0, s1);
  return (int)cudaGetLastError();
}
