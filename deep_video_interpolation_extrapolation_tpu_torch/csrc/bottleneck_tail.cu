// K2: the layer1 Bottleneck tail, NHWC bf16, f32 accumulation:
//   h2 = lrelu(bf16(conv3x3(h1, W2)))
//   y  = lrelu(bf16(h2 . W3) + (bf16(x . Wres) if Wres else x))
//   h1_next = lrelu(bf16(y . W1_next))            (skipped without W1_next)
// returning (y, h1_next), with bf16 rounding after every product exactly
// where the JAX reference rounds (ops/pallas_chain.py:_block_ref).
//
// Replaces ops/pallas_chain.py:fused_block (pallas_call at :495) and also
// covers fused_boundary (:163, the same tail without its conv3x3, whose h2
// arrives from outside).  Width packing, the A+E split and the HWNC view
// are TPU layout devices and are dropped.
//
// Bound on the H100 at the main-path shape (B=1, 512x1024, P=64, Co=256),
// per block of the chain: FLOPs 2*524288*(576*64 + 64*256 + 256*64) =
// 73.0 GFLOP (+17.2 with Wres, block 0); bytes h1 64 + x 256 (64 in block 0)
// + y 256 + h1_next 64 channels = 640 MiB.  At peak: 74-91 us of tensor
// cores vs 200 us of HBM: memory-bound.  What the TPU kernel buys, and this
// one keeps, is that h2 (64 ch) and y's re-read for the next conv1 never
// touch device memory.
//
// Design (hopper.cuh, namespace tiled; the layer1 Bottleneck train
// chain's forward, trainchain_bottleneck.cu, shifted by one product):
// every product runs on wgmma m64n64k16, A from registers, B from shared
// memory, f32 accumulators in registers.
// - Persistent blocks of two consumer warpgroups walk 8x16 pixel tiles;
//   warpgroup g owns tile rows 4g..4g+3 (one m-tile), each warp one row.
// - Weights: w2's nine taps, then per 64 outputs w3, wres and the 64 rows
//   of w1_next that this y chunk multiplies, as 8 KB units in the
//   no-swizzle K-major core-matrix order (laid out by the wrapper in the
//   order a tile takes them), streamed by one producer warp into an
//   8-slot ring by bulk TMA copies: once per 128-pixel tile.
// - h1 is staged (cp.async) on the tile's 1-pixel ring (10x18 positions,
//   zero outside the image: the SAME padding), with x at the tile in block
//   0 (Wres); the next tile's land while this tile's products run.  The
//   conv3x3 reads h1 at shifted rows by ldmatrix (each lane its own row).
// - h2 = lrelu(bf16(.)) goes through a per-warpgroup buffer (each warp its
//   own rows) into conv3's A operand, reloaded by ldmatrix for each 64
//   output channels: an A operand kept in registers across other products'
//   wgmmas came back corrupted in the train chain's forward.
// - Per chunk of 64 outputs: bf16(h2 . W3) + bf16(x . Wres) (x from the
//   staged tile) or + x (each warp's row of x staged by cp.async at the
//   start of the tile, 16 bytes a lane); rounded, lrelu, written into the
//   warp's rows of a shared buffer and stored from there with 16-byte
//   stores; and, from registers (acc_to_a), the A operand of h1n_acc +=
//   y_chunk . W1_next[chunk rows], used before any other A operand's
//   wgmma.  So y never needs a 256-channel buffer and is never re-read.
// - No wgmma under a thread-dependent branch (C7518): Wres and W1_next are
//   template parameters.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

using namespace hop;
using namespace hop::tiled;

constexpr int TH = 8, TP = TH * TW;               // the pixel tile
constexpr int P = 64, CO = 256;                   // planes, planes * 4
constexpr int PW = TW + 2, NPOS = (TH + 2) * PW;  // its 1-ring: 180 positions
constexpr int LDP = P + 8;                        // pitch of a 64-channel buffer
constexpr int NWG = 2, CT = NWG * 128, NT = CT + 32;

template <bool RES, bool NEXT>
struct Tail {
  static constexpr int HB = align128(NPOS * LDP * 2);        // h1 on the ring
  static constexpr int XB = RES ? align128(TP * LDP * 2) : 0;  // x at the tile (Cx = 64)
  static constexpr int LDO = RES ? LDP : CO + 8;              // output rows: x (identity) and y
  static constexpr int OB = 64 * LDO * 2;                     // a warpgroup's output rows
  static constexpr int O_H = NST * UB;
  static constexpr int O_X = O_H + 2 * HB;
  static constexpr int O_H2 = O_X + 2 * XB;                   // h2, 64 rows per warpgroup
  static constexpr int O_O = O_H2 + NWG * 64 * LDP * 2;
  static constexpr int O_BAR = align128(O_O + NWG * OB);
  static constexpr int SMEM = O_BAR + 2 * NST * 8;
  // units per tile: w2 (9), then per 64 outputs w3 (1), wres (1), w1n (1)
  static constexpr int U = 9 + (CO / 64) * (1 + RES + NEXT);
  static_assert(SMEM <= 232448, "shared memory per block");
};

template <bool RES, bool NEXT>
__global__ void __launch_bounds__(NT, 1)
tail_kernel(const bf16 *__restrict__ h1, const bf16 *__restrict__ x, const bf16 *__restrict__ wu,
            bf16 *__restrict__ y, bf16 *__restrict__ h1n, int B, int H, int W) {
  using K = Tail<RES, NEXT>;
  constexpr int CX = RES ? 64 : CO;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + K::O_BAR), *empty = full + NST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = n_tiles(B, H, W, TH);
  init_ring(full, empty, 4 * NWG);
  if (warp == 4 * NWG) {
    if (lane == 0) produce(full, empty, smem, wu, K::U, nt);
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  Ring r{full, empty, smem_u32(smem), 0};
  // this lane's ldmatrix row (tile pixel ia, and of the warpgroup's 64 lr)
  // and channel offset
  const int lr = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, lk = (lane >> 4) * 8;
  const int ia = wg * 64 + lr;
  const int pa = (ia / TW + 1) * PW + ia % TW + 1;  // its ring position
  // accumulator rows (of the warpgroup's 64) and columns of this thread
  const int er = wq * 16 + (lane >> 2), ec = 2 * (lane & 3);
  bf16 *H2s = reinterpret_cast<bf16 *>(smem + K::O_H2) + wg * 64 * LDP;
  bf16 *Os = reinterpret_cast<bf16 *>(smem + K::O_O + wg * K::OB);
  const uint32_t h2base = smem_u32(H2s) + (lr * LDP + lk) * 2;

  auto hbuf = [&](int k) { return reinterpret_cast<bf16 *>(smem + K::O_H + (k & 1) * K::HB); };
  auto xbuf = [&](int k) { return reinterpret_cast<bf16 *>(smem + K::O_X + (k & 1) * K::XB); };
  // h1 on tile ti's 1-ring (and in block 0 x at the tile) into buffers k
  auto load_tile = [&](int ti, int k) {
    const Tile t = tile_at(ti, TH, H, W);
    bf16 *Hs = hbuf(k);
    for (int i = threadIdx.x; i < NPOS * 8; i += CT) {
      const int l = i >> 3, v = i & 7;
      const int yy = t.y0 - 1 + l / PW, xx = t.x0 - 1 + l % PW;
      const bool ok = inside(yy, xx, H, W);
      cp_async16(Hs + l * LDP + v * 8, ok ? h1 + pix(t.b, yy, xx, H, W) * P + v * 8 : h1, ok);
    }
    if constexpr (RES) {
      bf16 *Xs = xbuf(k);
      for (int i = threadIdx.x; i < TP * 8; i += CT) {
        const int p = i >> 3, v = i & 7;
        const int yy = t.y0 + p / TW, xx = t.x0 + p % TW;
        const bool ok = inside(yy, xx, H, W);
        cp_async16(Xs + p * LDP + v * 8, ok ? x + pix(t.b, yy, xx, H, W) * CX + v * 8 : x, ok);
      }
    }
  };
  // this warp's tile row of 64 channels from the warp's rows of Os (from
  // column c0) to dst (C channels a pixel, from column d0), 16 bytes a lane
  auto store_row = [&](bf16 *dst, int C, int d0, int c0, const Tile &t, int yy) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane + 32 * k, col = i >> 3, v = i & 7;
      if (inside(yy, t.x0 + col, H, W))
        st16(dst + pix(t.b, yy, t.x0 + col, H, W) * C + d0 + v * 8,
             *reinterpret_cast<const uint4 *>(Os + (wq * 16 + col) * K::LDO + c0 + v * 8));
    }
  };

  load_tile(blockIdx.x, 0);
  cp_async_commit();
  int k = 0;
  for (int ti = blockIdx.x; ti < nt; ti += gridDim.x, ++k) {
    const Tile t = tile_at(ti, TH, H, W);
    const int yy = t.y0 + wg * 4 + wq;  // this warp's tile row
    cp_async_wait<0>();
    bar_sync(1, CT);  // tile k's h1 (and x) have landed; tile k - 1 is done with its buffers
    if constexpr (!RES) {  // this warp's row of x (256 channels), 16 bytes a lane
      for (int i = lane; i < 16 * (CO / 8); i += 32) {
        const int col = i / (CO / 8), v = i % (CO / 8);
        const bool ok = inside(yy, t.x0 + col, H, W);
        cp_async16(Os + (wq * 16 + col) * K::LDO + v * 8,
                   ok ? x + pix(t.b, yy, t.x0 + col, H, W) * CO + v * 8 : x, ok);
      }
    }
    cp_async_commit();
    if (ti + gridDim.x < nt) load_tile(ti + gridDim.x, k + 1);
    cp_async_commit();

    // ---- conv2 on the tile: h2 = lrelu(bf16(conv3x3(h1, w2)))
    float acc[32];
    zero32(acc);
    gemm_ld(acc, smem_u32(hbuf(k)) + (pa * LDP + lk) * 2, 9, TapOff<PW, LDP>(), r, false);
    finish(acc, r);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st2(H2s + (er + 8 * hh) * LDP + 8 * j + ec, lrelu_bf(rbf(acc[4 * j + 2 * hh])),
            lrelu_bf(rbf(acc[4 * j + 2 * hh + 1])));
    __syncwarp();
    if constexpr (!RES) {  // x's row has landed (all but the next tile's loads)
      cp_async_wait<1>();
      __syncwarp();
    }

    // ---- per 64 outputs: y = lrelu(bf16(h2 . w3) + residual); h1n_acc += y . w1n
    float acc1[32];  // h1_next's accumulators
    zero32(acc1);
#pragma unroll 1
    for (int nc = 0; nc < CO / 64; ++nc) {
      zero32(acc);
      uint32_t h2a[4][4];
      ld_a(h2a, h2base);
      step(acc, h2a, r, false);
      finish(acc, r);
      const int oc = RES ? 0 : nc * 64;  // the chunk's column in Os
      if constexpr (RES) {                // + bf16(x . wres)
        float accr[32];
        zero32(accr);
        uint32_t xa[4][4];
        ld_a(xa, smem_u32(xbuf(k)) + (ia * LDP + lk) * 2);
        step(accr, xa, r, false);
        finish(accr, r);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = lrelu_bf(rbf(rbf(acc[e]) + rbf(accr[e])));
      } else {  // + x, from the warp's staged row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 xv = ld2(Os + (er + 8 * hh) * K::LDO + oc + 8 * j + ec);
            const int e = 4 * j + 2 * hh;
            acc[e] = lrelu_bf(rbf(rbf(acc[e]) + xv.x));
            acc[e + 1] = lrelu_bf(rbf(rbf(acc[e + 1]) + xv.y));
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st2(Os + (er + 8 * hh) * K::LDO + oc + 8 * j + ec, acc[4 * j + 2 * hh],
              acc[4 * j + 2 * hh + 1]);
      if constexpr (NEXT) {  // y's chunk as A, used at once
        uint32_t ya[4][4];
        acc_to_a(ya, acc);
        step(acc1, ya, r, false);
      }
      __syncwarp();
      store_row(y, CO, nc * 64, oc, t, yy);
      if constexpr (NEXT) finish(acc1, r);
      __syncwarp();  // the warp's rows of Os are free again
    }

    if constexpr (NEXT) {  // h1_next = lrelu(bf16(y . w1n)), through Os's first 64 columns
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st2(Os + (er + 8 * hh) * K::LDO + 8 * j + ec, lrelu_bf(rbf(acc1[4 * j + 2 * hh])),
              lrelu_bf(rbf(acc1[4 * j + 2 * hh + 1])));
      __syncwarp();
      store_row(h1n, P, 0, 0, t, yy);
    }
  }
  cp_async_wait<0>();
}

template <bool RES, bool NEXT>
int launch_tail(const void *h1, const void *x, const void *wu, void *y, void *h1n, int B, int H,
                int W, cudaStream_t st) {
  return launch(tail_kernel<RES, NEXT>, NT, Tail<RES, NEXT>::SMEM, n_tiles(B, H, W, TH), st,
                (const bf16 *)h1, (const bf16 *)x, (const bf16 *)wu, (bf16 *)y, (bf16 *)h1n, B, H,
                W);
}

}  // namespace
}  // namespace dvie

// h1 (B,H,W,64); x (B,H,W,Cx): Cx = 64 with Wres, 256 without; wu: the
// units of a tile in the order the kernel takes them (ops/bottleneck_tail.py:
// tail_units): w2's nine taps, then per 64 outputs w3, wres (if res) and
// the 64 rows of w1_next (if next); y (B,H,W,256); h1n (B,H,W,64) if next.
// All bf16.
extern "C" int dvie_bottleneck_tail(const void *h1, const void *x, const void *wu, void *y,
                                    void *h1n, int B, int H, int W, int res, int next,
                                    void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (res && next) return dvie::launch_tail<true, true>(h1, x, wu, y, h1n, B, H, W, st);
  if (res) return dvie::launch_tail<true, false>(h1, x, wu, y, h1n, B, H, W, st);
  if (next) return dvie::launch_tail<false, true>(h1, x, wu, y, h1n, B, H, W, st);
  return dvie::launch_tail<false, false>(h1, x, wu, y, h1n, B, H, W, st);
}
