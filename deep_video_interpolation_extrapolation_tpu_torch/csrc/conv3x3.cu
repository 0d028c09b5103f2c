// K1: 3x3 stride-1 zero-padded conv + bias + residual + leaky-ReLU(0.2),
// NHWC bf16 in and out, f32 accumulation, Cout = 64.
//
// Replaces ops/pallas_ae_conv.py:conv3x3_packed_ae_hwnc (the HWNC A+E
// kernel, pallas_call at :400) and also covers conv3x3_packed_ae (:183, the
// NHWC-packed form of the same function).  The TPU width packing, the A+E
// split of the taps and the HWNC view exist for the 128-lane MXU and are
// dropped: this is an implicit GEMM over logical NHWC pixels.
//
// Bound on the H100 at the main-path shape (B=1, 512x1024, Cout=64):
//   Cin=64 : 2*524288*576*64 = 38.7 GFLOP; x + res + out = 3 * 64 MiB.
//            39 us of tensor-core time at 989 TFLOP/s vs 60 us of HBM time
//            at 3.35 TB/s: memory-bound (192 FLOP/byte < 295).
//   Cin=256: 154.6 GFLOP vs 256 + 64 MiB: compute-bound (156 vs 100 us).
//
// Design (hopper.cuh, namespace tiled): the conv runs on wgmma m64n64k16
// (M = pixels, N = the 64 output channels, K = 9 taps x Cin), A from
// registers, B from shared memory, f32 accumulators in registers.
// - Persistent blocks walk 2-D pixel tiles 16 wide, each warpgroup 4 tile
//   rows (one m-tile), each warp one row.  At Cin = 64 a block holds three
//   independent groups of one warpgroup, each walking its own 4x16 tiles
//   on its own named barrier, so that one group's loads and epilogue
//   overlap the others' wgmmas (0.106 ms against 0.125 ms for two
//   warpgroups in lockstep on 8x16 tiles, B=1 512x1024, one call, H100
//   700 W).  At Cin = 256 one group of two warpgroups takes 8x16 tiles.
// - A: the tile's input and its 1-pixel halo (16 bytes of padding per
//   position so that ldmatrix of 8 positions hits 8 distinct bank groups)
//   are staged once per 64 input channels by cp.async, zero outside the
//   image (the SAME padding).  Each lane gives ldmatrix its own row
//   shifted by the tap, so there is no im2col and every tap reads the one
//   staged region.  Regions are double-buffered per group: the next region
//   (the next 64 channels, or the group's next tile) is issued once the
//   first tap's wgmmas run, and lands while the rest run.
// - B at Cin = 64: the 72 KB of weights (9 tap units of 64 x 64 in the
//   no-swizzle K-major core-matrix order, laid out by the wrapper) are
//   loaded once per block by bulk TMA copies and stay resident.
// - B at Cin = 256 (transition1's trans_0, 288 KB of weights): a producer
//   warp streams the 8 KB (64-channel chunk, tap) units of each tile
//   through an 8-slot ring (full/empty mbarriers), in the order the
//   consumers take them.
// - Epilogue from the accumulator registers: bias, residual and lrelu in
//   f32, one rounding to bf16.  Each warp stages its tile row's residual
//   by cp.async (16 bytes a lane) with the next region's loads into its
//   own rows of a shared buffer, adds it there, writes the bf16 result in
//   place and stores its row with 16-byte stores.
// - No wgmma under a thread-dependent branch (C7518); the next unit's A is
//   loaded while the current unit's wgmmas run, and no A register set is
//   kept across another's wgmmas beyond that.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;
using namespace hop::tiled;

constexpr int LDR = 64 + 8;  // region and staging pitch, elements

// A group of consumer warpgroups shares one tile (TH = 4 rows a warpgroup)
// and its region buffers, and syncs on its own named barrier.  Cin = 64:
// three groups of one warpgroup, each walking its own 4x16 tiles, so that
// one group's loads and epilogue overlap another's wgmmas; the nine tap
// units are resident.  Cin = 256: one group of two warpgroups (8x16
// tiles), fed by a producer warp through the weight ring.
template <int NK>  // Cin / 64
struct K1 {
  static constexpr int CIN = 64 * NK;
  static constexpr bool RESIDENT = NK == 1;
  static constexpr int GWG = RESIDENT ? 1 : 2;     // warpgroups a group
  static constexpr int NG = RESIDENT ? 3 : 1;      // groups a block
  static constexpr int TH = 4 * GWG, GT = 128 * GWG, CT = NG * GT;
  static constexpr int PW = TW + 2, NPOS = (TH + 2) * PW;  // the tile's 1-ring region
  static constexpr int NSLOT = RESIDENT ? 9 : NST;  // weight slots
  static constexpr int NT = CT + (RESIDENT ? 0 : 32);
  static constexpr int RB = align128(NPOS * LDR * 2);
  static constexpr int SB = 64 * LDR * 2;  // a warpgroup's output rows
  static constexpr int O_X = NSLOT * UB;   // 2 region buffers a group
  static constexpr int O_S = O_X + 2 * NG * RB;
  static constexpr int O_BAR = align128(O_S + NG * GWG * SB);
  static constexpr int SMEM = O_BAR + 2 * NSLOT * 8;
  static_assert(SMEM <= 232448, "shared memory per block");
};

// the cp.async loads of 64-channel chunk kc of tile ti's region into Xs,
// by the group's threads (gi: this thread's index in the group)
template <class K>
__device__ __forceinline__ void load_region(bf16 *Xs, const bf16 *__restrict__ x, int kc, int ti,
                                            int gi, int H, int W) {
  const Tile t = tile_at(ti, K::TH, H, W);
  for (int i = gi; i < K::NPOS * 8; i += K::GT) {
    const int l = i >> 3, v = i & 7;
    const int yy = t.y0 - 1 + l / K::PW, xx = t.x0 - 1 + l % K::PW;
    const bool ok = inside(yy, xx, H, W);
    cp_async16(Xs + l * LDR + v * 8,
               ok ? x + pix(t.b, yy, xx, H, W) * K::CIN + kc * 64 + v * 8 : x, ok);
  }
}

// acc += the 9 taps of one staged region: A by ldmatrix at abase + the
// tap's offset, B the resident tap units at wbase or the ring's next units.
// `loads` (the next region's cp.async) is issued once the first unit's
// wgmmas run.
template <class K, class Loads>
__device__ __forceinline__ void conv9(float (&acc)[32], uint32_t abase, uint32_t wbase, Ring &r,
                                      Loads loads) {
  const TapOff<K::PW, LDR> off;
  uint32_t a0[4][4], a1[4][4];
  auto unit = [&](const uint32_t(&a)[4][4], int u) {
    if constexpr (K::RESIDENT)
      mma_unit(acc, a, desc(wbase + u * UB, 1024, 128));
    else
      step(acc, a, r, u > 0);
  };
  ld_a(a0, abase + off(0));
  unit(a0, 0);
  loads();
#pragma unroll 1
  for (int u = 1; u < 9; u += 2) {
    ld_a(a1, abase + off(u));
    unit(a1, u);
    ld_a(a0, abase + off(u + 1));
    unit(a0, u + 1);
  }
  if constexpr (K::RESIDENT) {
    wg_wait<0>();
    fence_acc(acc);
  } else {
    finish(acc, r);
  }
}

template <int NK>
__global__ void __launch_bounds__(K1<NK>::NT, 1)
conv3x3_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ wu,
               const bf16 *__restrict__ bias, const bf16 *__restrict__ res,
               bf16 *__restrict__ out, int B, int H, int W, int relu) {
  using K = K1<NK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + K::O_BAR), *empty = full + K::NSLOT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = n_tiles(B, H, W, K::TH);
  if constexpr (K::RESIDENT) {  // the nine tap units, once per block
    if (threadIdx.x == 0) {
      mbar_init(&full[0], 1);
      mbar_init_fence();
      mbar_expect_tx(&full[0], 9 * UB);
      for (int u = 0; u < 9; ++u) bulk_load(smem + u * UB, wu + u * (UB / 2), UB, &full[0]);
    }
    __syncthreads();
  } else {
    init_ring(full, empty, K::CT / 32);
    if (warp == K::CT / 32) {  // the producer: every tile's 9 * NK units
      if (lane == 0) produce(full, empty, smem, wu, 9 * NK, nt);
      return;
    }
  }

  const int g = threadIdx.x / K::GT, gi = threadIdx.x % K::GT;  // group, index in it
  const int wg = gi >> 7, wq = warp & 3;  // warpgroup in the group, warp in it
  Ring r{full, empty, smem_u32(smem), 0};
  // this lane's ldmatrix row (tile pixel wg * 64 + lr) and channel offset
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int ia = wg * 64 + lr;
  const uint32_t aoff = (((ia / TW + 1) * K::PW + ia % TW + 1) * LDR + lk) * 2;
  // accumulator rows (of the warpgroup's 64) and columns of this thread
  const int er = wq * 16 + (lane >> 2), ec = 2 * (lane & 3);
  bf16 *Ss = reinterpret_cast<bf16 *>(smem + K::O_S + (warp >> 2) * K::SB);
  auto xbuf = [&](int s) {
    return reinterpret_cast<bf16 *>(smem + K::O_X + (2 * g + (s & 1)) * K::RB);
  };
  const int t0 = blockIdx.x * K::NG + g, dt = gridDim.x * K::NG;  // this group's tiles
  if constexpr (K::RESIDENT) mbar_wait(&full[0], 0);

  if (t0 < nt) load_region<K>(xbuf(0), x, 0, t0, gi, H, W);
  cp_async_commit();
  int s = 0;  // regions (tile, channel chunk) consumed
  for (int ti = t0; ti < nt; ti += dt) {
    const Tile t = tile_at(ti, K::TH, H, W);
    const int yy = t.y0 + wg * 4 + wq;  // this warp's tile row
    float acc[32];
    zero32(acc);
#pragma unroll 1
    for (int kc = 0; kc < NK; ++kc, ++s) {
      cp_async_wait<0>();
      bar_sync(1 + g, K::GT);  // region s has landed; region s - 1 is no longer read
      conv9<K>(acc, smem_u32(xbuf(s)) + aoff, smem_u32(smem), r, [&] {
        if (kc == 0 && res) {  // this warp's row of the residual, 16 bytes a lane
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = lane + 32 * k, col = i >> 3, v = i & 7;
            const bool ok = inside(yy, t.x0 + col, H, W);
            cp_async16(Ss + (wq * 16 + col) * LDR + v * 8,
                       ok ? res + pix(t.b, yy, t.x0 + col, H, W) * 64 + v * 8 : res, ok);
          }
        }
        cp_async_commit();
        if (kc + 1 < NK)
          load_region<K>(xbuf(s + 1), x, kc + 1, ti, gi, H, W);
        else if (ti + dt < nt)
          load_region<K>(xbuf(s + 1), x, 0, ti + dt, gi, H, W);
        cp_async_commit();
      });
    }

    // ---- epilogue: out = lrelu(acc + bias + res), rounded once
    cp_async_wait<1>();  // the residual (all but the next region)
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16 *row = Ss + (er + 8 * hh) * LDR;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + ec;
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if (bias) {
          const float2 b = ld2(bias + c);
          v0 += b.x;
          v1 += b.y;
        }
        if (res) {
          const float2 rv = ld2(row + c);
          v0 += rv.x;
          v1 += rv.y;
        }
        if (relu) {
          v0 = lrelu(v0);
          v1 = lrelu(v1);
        }
        st2(row + c, v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane + 32 * k, col = i >> 3, v = i & 7;
      if (inside(yy, t.x0 + col, H, W))
        st16(out + pix(t.b, yy, t.x0 + col, H, W) * 64 + v * 8,
             *reinterpret_cast<const uint4 *>(Ss + (wq * 16 + col) * LDR + v * 8));
    }
  }
  cp_async_wait<0>();
}

template <int NK>
int launch_k1(const void *x, const void *wu, const void *bias, const void *res, void *out, int B,
              int H, int W, int relu, cudaStream_t st) {
  using K = K1<NK>;
  const int blocks = (n_tiles(B, H, W, K::TH) + K::NG - 1) / K::NG;  // at most one tile a group
  return launch(conv3x3_kernel<NK>, K::NT, K::SMEM, blocks, st, (const bf16 *)x,
                (const bf16 *)wu, (const bf16 *)bias, (const bf16 *)res, (bf16 *)out, B, H, W,
                relu);
}

}  // namespace
}  // namespace dvie

// x (B,H,W,Cin); wu: the weights as 9 * Cin / 64 units of (8 k-groups, 64
// outputs, 8 k) bf16, ordered (64-channel chunk, tap ky*3+kx)
// (ops/conv3x3.py: conv_units); bias (64,) or NULL; res (B,H,W,64) or
// NULL; out (B,H,W,64); all bf16.  Cin in {64, 256}, Cout == 64 (checked
// by the Python wrapper; anything else returns cudaErrorInvalidValue).
extern "C" int dvie_conv3x3(const void *x, const void *wu, const void *bias, const void *res,
                            void *out, int B, int H, int W, int Cin, int Cout, int relu,
                            void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Cout != 64) return (int)cudaErrorInvalidValue;
  if (Cin == 64) return dvie::launch_k1<1>(x, wu, bias, res, out, B, H, W, relu, st);
  if (Cin == 256) return dvie::launch_k1<4>(x, wu, bias, res, out, B, H, W, relu, st);
  return (int)cudaErrorInvalidValue;
}
