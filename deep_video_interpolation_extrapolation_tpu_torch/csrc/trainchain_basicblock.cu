// The BasicBlock chain in training: one block per launch, forward and
// backward, NHWC bf16, f32 accumulation, C = 64 (branch 0 of stage2 and
// stage3).  Per block:
//   h   = lrelu(bf16(conv3x3(x, k1)))
//   pre = bf16(conv3x3(h, k2))          y = lrelu(bf16(pre + x))
// with the residual add and lrelu in bf16, as ops/pallas_trainchain.py
// rounds.
//
// Replaces ops/pallas_trainchain.py:basicblock_chain: the forward
// _bb_fwd_kernel (pallas_call at :704) and the backward _bb_bwd_kernel
// (:741), which recomputes every block input, h and the masks (from the
// signs of h and of each block output) and returns dx and per-program f32
// weight-grad partials.  With N = 1 it is also pallas_resblock.
// fused_basicblock and pallas_bb.fused_basicblock_hwnc (one BasicBlock).
// The TPU kernel holds one whole 128x128 plane per program, so it chains
// all N blocks in one kernel; that is a VMEM layout.  Here a block of
// threads owns an 8x16 pixel tile (trainchain.cuh), and chaining four
// BasicBlocks in one launch would need an 8-pixel halo: one launch per
// BasicBlock instead.
//
// Saved state.  The TPU backward recomputes every block input, h and the
// pre-activations because VMEM is small.  On an 80 GB card the forward
// stores each block's output y and its h (2 x 50 MB per block at the
// 24x128x128 recipe), and the backward reads them: the masks are the signs
// of y and h (lrelu keeps the sign), so the backward runs no forward conv.
// It computes the same function.
//
// Bound on the H100 at the recipe shape (M = 393,216 pixels, C = 64):
// forward per block conv1 on the 1-ring (13 row fragments for 8 output
// rows: 1.63x) + conv2 = 2*M*576*64*2.63 = 76 GFLOP, x 50 MB in, y and h
// 100 MB out: 77 us of tensor cores at peak vs 45 us of HBM.  Backward per
// block: dh on the 1-ring (48 GFLOP), dx (29), dk1 + dk2 (58): 135 GFLOP,
// and dy, y, h, x in, dpre_y, dpre_h, dx out and back in for the weight
// grads (about 11 x 50 MB).
//
// Design.  Shared memory: the 2-ring region (40 KB at 160-byte positions),
// the 1-ring buffer (38 KB), the accumulator staging (35 KB) and ONE 3x3
// weight set (83 KB at LDW = C + 8).  The stem keeps both of its weight
// sets resident, but at Ci = 64 two sets are 166 KB and the whole would be
// 280 KB, over the 227 KB a block may have; so the forward loads k2 into
// k1's buffer after conv1 (a second 83 KB cp.async wave, from L2, not
// overlapped), for 197 KB in all: one block of 8 warps per SM.
// Forward, one launch: x on the 2-ring, conv1 -> h on the 1-ring (zero
// outside the image: conv2's SAME padding), k2 in, conv2 on the tile, the
// residual from the staged x, lrelu, y and h stored.
// Backward, two launches per block (dx needs dpre_h one ring out, which
// needs dpre_y two rings out, all inside one tile's launch):
//   1. bb_bwd: dy and y on the 2-ring -> dpre_y = lrelu'(y) * dy in place;
//      dh = bf16(conv_t(dpre_y, k2)) on the 1-ring; dpre_h = lrelu'(h) * dh
//      (h read from the forward's store, zero outside the image) while k1's
//      flipped taps arrive; dx = bf16(conv_t(dpre_h, k1) + dpre_y) on the
//      tile, rounded once; dpre_y and dpre_h stored for the weight grads;
//   2. wgrad_kernel: dk1 (x, dpre_h) and dk2 (h, dpre_y) as split-K f32
//      partials (trainchain.cuh).
// Prediction (written before the first run of this design): the backward
// at N = 4 falls from 12.4 ms (three launches per block, the forward and
// pre_h recomputed) to 6.5-7.5 ms; the forward rises by the h store, <= 0.1
// ms at N = 4.
#include "trainchain.cuh"

namespace dvie {
namespace {

using namespace tc;

constexpr int NT = 256;                // 8 warps, one output row each
constexpr int C = 64;
constexpr int PW = TW + 4;             // region pitch: a ring of 2 (20)
constexpr int XPOS = (TH + 4) * PW;    // 240 positions of the 2-ring region
constexpr int XALLOC = 256;            // zero positions past it: shifted reads
constexpr int R1 = PW + 1;             // first position of the 1-ring (21)
constexpr int NF1 = 13;                // 1-ring fragments: positions [21, 229)
constexpr int LDS = C + 16;            // 160-byte positions: 32-byte aligned views
constexpr int LDW = C + 8;
constexpr int LDC = C + 4;
constexpr int SPOS = 240;              // positions of the second buffer (a 2-ring)

constexpr int SZ_A = XALLOC * LDS * 2;         // 40960: a 2-ring region
constexpr int SZ_W = 9 * C * LDW * 2;          // 82944: one 3x3 weight set
constexpr int SZ_S = SPOS * LDS * 2;           // 38400: the 1-ring buffer
constexpr int SZ_C = NT / 32 * 16 * LDC * 4;   // 34816

constexpr int O_A = 0, O_W = align128(O_A + SZ_A), O_S = align128(O_W + SZ_W);
constexpr int O_C = align128(O_S + SZ_S);
constexpr int SMEM = O_C + SZ_C;
static_assert(SMEM <= 232448, "shared memory per block");
static_assert(R1 + 16 * NF1 - 1 + PW + 1 < XALLOC, "1-ring taps stay in the region");
static_assert(SPOS >= XPOS, "the second buffer holds a 2-ring region");

// offset of tap t (ky*3 + kx) in region positions
__device__ __forceinline__ int toff(int t) { return (t / 3 - 1) * PW + (t % 3 - 1); }

// image row / column of region position l (origin two pixels up-left)
__device__ __forceinline__ int ry(const Tile &t, int l) { return t.y0 - 2 + l / PW; }
__device__ __forceinline__ int rx(const Tile &t, int l) { return t.x0 - 2 + l % PW; }

__device__ __forceinline__ void load_weights(bf16 *Ws, const bf16 *w) {
  load_block_async(Ws, LDW, w, C, 9 * C, C);
}

__device__ __forceinline__ void wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
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

// a 3x3 conv of the staged region As with the weights Ws over 1-ring
// fragment f (positions R1 + 16 f ...), f32 in acc
__device__ __forceinline__ void ring_frag(FragC (&acc)[4], const bf16 *As, const bf16 *Ws, int f) {
  zero(acc);
  const int l0 = R1 + 16 * f;
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, As + (l0 + toff(tp)) * LDS, LDS, Ws + tp * C * LDW, LDW, C / 16);
}

// the same conv on the tile's output row r (positions (r+2)*PW + 2 ...)
__device__ __forceinline__ void tile_row(FragC (&acc)[4], const bf16 *As, const bf16 *Ws, int r) {
  zero(acc);
  const int l0 = (r + 2) * PW + 2;
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, As + (l0 + toff(tp)) * LDS, LDS, Ws + tp * C * LDW, LDW, C / 16);
}

// the forward of one block: y, and h at the tile's pixels where h_out is
// not null
__global__ void __launch_bounds__(NT, 1)
bb_fwd_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w1,
              const bf16 *__restrict__ w2, bf16 *__restrict__ y, bf16 *__restrict__ h_out, int H,
              int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + O_A);
  bf16 *Ws = reinterpret_cast<bf16 *>(smem + O_W);
  bf16 *Ss = reinterpret_cast<bf16 *>(smem + O_S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *Cw = reinterpret_cast<float *>(smem + O_C) + warp * 16 * LDC;
  const Tile t = tile_of(H, W);

  load_region(Xs, LDS, x, C, 0, C / 8, t, -2, -2, PW, XPOS, XALLOC, H, W);
  load_weights(Ws, w1);
  wait_all();

  // h on the 1-ring, zero outside the image
  for (int f = warp; f < NF1; f += NT / 32) {
    FragC acc[4];
    ring_frag(acc, Xs, Ws, f);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i % C, l = R1 + 16 * f + r;
      const float v = inside(ry(t, l), rx(t, l), H, W) ? lrelu_bf(rbf(Cw[r * LDC + c])) : 0.f;
      Ss[l * LDS + c] = __float2bfloat16(v);
    }
    __syncwarp();
  }
  __syncthreads();  // every warp is done with k1
  load_weights(Ws, w2);
  wait_all();

  // conv2 on the tile: warp = output row; + x, lrelu
  const int r = warp, l0 = (r + 2) * PW + 2, yy = t.y0 + r;
  FragC acc[4];
  tile_row(acc, Ss, Ws, r);
  store(Cw, LDC, acc);
  __syncwarp();
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int px = i / (C / 8), c = (i % (C / 8)) * 8, xx = t.x0 + px;
    if (yy >= H || xx >= W) continue;
    const long m = pix(t, yy, xx, H, W);
    float v[8], xr[8];
    unpack8(*reinterpret_cast<const uint4 *>(Xs + (l0 + px) * LDS + c), xr);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = lrelu_bf(rbf(rbf(Cw[px * LDC + c + k]) + xr[k]));
    st16(y + m * C + c, pack8(v));
    if (h_out) st16(h_out + m * C + c, *reinterpret_cast<const uint4 *>(Ss + (l0 + px) * LDS + c));
  }
}

// the backward of one block but its weight grads: dpre_y, dpre_h (stored)
// and dx on the tile, from the forward's y and h
__global__ void __launch_bounds__(NT, 1)
bb_bwd_kernel(const bf16 *__restrict__ dy, const bf16 *__restrict__ y,
              const bf16 *__restrict__ h, const bf16 *__restrict__ w1f,
              const bf16 *__restrict__ w2f, bf16 *__restrict__ dpre_y, bf16 *__restrict__ dpre_h,
              bf16 *__restrict__ dx, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *As = reinterpret_cast<bf16 *>(smem + O_A);  // dy, then dpre_y in place
  bf16 *Ws = reinterpret_cast<bf16 *>(smem + O_W);  // k2 flipped, then k1 flipped
  bf16 *Ss = reinterpret_cast<bf16 *>(smem + O_S);  // y, then dh, then dpre_h in place
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *Cw = reinterpret_cast<float *>(smem + O_C) + warp * 16 * LDC;
  const Tile t = tile_of(H, W);

  // ---- phase 1: dpre_y = lrelu'(y) * dy on the 2-ring (zero outside the
  // image, where dy is staged as zero)
  load_region(As, LDS, dy, C, 0, C / 8, t, -2, -2, PW, XPOS, XALLOC, H, W);
  load_region(Ss, LDS, y, C, 0, C / 8, t, -2, -2, PW, XPOS, SPOS, H, W);
  load_weights(Ws, w2f);
  wait_all();
  for (int i = threadIdx.x; i < XPOS * (C / 8); i += NT) {
    const int l = i / (C / 8), c = (i % (C / 8)) * 8;
    bf16 *p = As + l * LDS + c;
    st16(p, masked8(*reinterpret_cast<const uint4 *>(Ss + l * LDS + c),
                    *reinterpret_cast<const uint4 *>(p)));
  }
  __syncthreads();  // dpre_y is whole; y is no longer needed

  // ---- phase 2: dh = bf16(conv_t(dpre_y, k2)) on the 1-ring
  for (int f = warp; f < NF1; f += NT / 32) {
    FragC acc[4];
    ring_frag(acc, As, Ws, f);
    store(Cw, LDC, acc);
    __syncwarp();
    const int l0 = R1 + 16 * f;
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i % C;
      Ss[(l0 + r) * LDS + c] = __float2bfloat16(Cw[r * LDC + c]);
    }
    __syncwarp();
  }
  __syncthreads();  // every warp is done with k2 and dh is whole

  // ---- phase 3: k1's flipped taps fly while dpre_h = lrelu'(h) * dh is
  // formed on the 1-ring, zero outside the image
  load_weights(Ws, w1f);
  cp_async_commit();
  for (int i = threadIdx.x; i < 16 * NF1 * (C / 8); i += NT) {
    const int l = R1 + i / (C / 8), c = (i % (C / 8)) * 8;
    const int yy = ry(t, l), xx = rx(t, l);
    bf16 *p = Ss + l * LDS + c;
    st16(p, inside(yy, xx, H, W)
                ? masked8(ldg16(h + pix(t, yy, xx, H, W) * C + c),
                          *reinterpret_cast<const uint4 *>(p))
                : make_uint4(0, 0, 0, 0));
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase 4: dpre_y and dpre_h out at the tile's pixels;
  // dx = conv_t(dpre_h, k1) + dpre_y
  const int r = warp, l0 = (r + 2) * PW + 2, yy = t.y0 + r;
  FragC acc[4];
  tile_row(acc, Ss, Ws, r);
  store(Cw, LDC, acc);
  __syncwarp();
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int px = i / (C / 8), c = (i % (C / 8)) * 8, xx = t.x0 + px;
    if (yy >= H || xx >= W) continue;
    const long m = pix(t, yy, xx, H, W);
    const uint4 gy = *reinterpret_cast<const uint4 *>(As + (l0 + px) * LDS + c);
    st16(dpre_h + m * C + c, *reinterpret_cast<const uint4 *>(Ss + (l0 + px) * LDS + c));
    st16(dpre_y + m * C + c, gy);
    float v[8], g[8];
    unpack8(gy, g);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = Cw[px * LDC + c + k] + g[k];
    st16(dx + m * C + c, pack8(v));
  }
}

int set_smem() {
  cudaError_t e = cudaFuncSetAttribute(bb_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bb_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return (int)e;
}

}  // namespace
}  // namespace dvie

// One BasicBlock forward.  x (B,H,W,64), w1 and w2 (9,64,64): the taps of
// k1 and k2 (tap ky*3+kx, input rows, output columns); y (B,H,W,64); h
// (B,H,W,64) or null (not stored).  All bf16.
extern "C" int dvie_bb_chain_fwd(const void *x, const void *w1, const void *w2, void *y, void *h,
                                 int B, int H, int W, void *stream) {
  using dvie::bf16;
  int e = dvie::set_smem();
  if (e) return e;
  dvie::bb_fwd_kernel<<<dvie::tc::n_tiles(B, H, W), dvie::NT, dvie::SMEM,
                        (cudaStream_t)stream>>>((const bf16 *)x, (const bf16 *)w1,
                                                (const bf16 *)w2, (bf16 *)y, (bf16 *)h, H, W);
  return (int)cudaGetLastError();
}

// One BasicBlock backward.  x, y, h (B,H,W,64): the block's input and what
// its forward stored; dy (B,H,W,64); w1f, w2f (9,64,64): the taps of k1
// and k2 flipped and transposed (the transposed convs as SAME convs).
// Scratch: dpre_y, dpre_h (B,H,W,64) bf16.  Outputs: dx (B,H,W,64) bf16;
// f32 partials over `splits` pixel ranges: pk1, pk2 (splits,9,64,64).
extern "C" int dvie_bb_chain_bwd(const void *x, const void *y, const void *h, const void *dy,
                                 const void *w1f, const void *w2f, void *dpre_y, void *dpre_h,
                                 void *dx, void *pk1, void *pk2, int B, int H, int W, int splits,
                                 void *stream) {
  using dvie::bf16;
  namespace tc = dvie::tc;
  int e = dvie::set_smem();
  if (e) return e;
  cudaStream_t st = (cudaStream_t)stream;
  dvie::bb_bwd_kernel<<<tc::n_tiles(B, H, W), dvie::NT, dvie::SMEM, st>>>(
      (const bf16 *)dy, (const bf16 *)y, (const bf16 *)h, (const bf16 *)w1f, (const bf16 *)w2f,
      (bf16 *)dpre_y, (bf16 *)dpre_h, (bf16 *)dx, H, W);
  if ((e = (int)cudaGetLastError())) return e;
  tc::WJobs jobs;
  jobs.n = 0;
  const int C = dvie::C;
  for (int t = 0; t < 9; ++t)
    jobs.j[jobs.n++] = tc::job(x, C, dpre_h, C, (float *)pk1 + t * C * C, 9L * C * C, t / 3 - 1,
                               t % 3 - 1);
  for (int t = 0; t < 9; ++t)
    jobs.j[jobs.n++] = tc::job(h, C, dpre_y, C, (float *)pk2 + t * C * C, 9L * C * C, t / 3 - 1,
                               t % 3 - 1);
  return tc::launch_wgrad(jobs, B * H * W, H, W, splits, st);
}
