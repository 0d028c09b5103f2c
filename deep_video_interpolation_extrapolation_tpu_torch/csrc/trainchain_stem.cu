// The HRNet stem in training: forward and backward, NHWC bf16, f32
// accumulation.
//   pre1 = bf16(conv3x3(x, k1)) + b1    s1 = lrelu(pre1)      (14 -> 64 ch)
//   pre2 = bf16(conv3x3(s1, k2)) + b2   y  = lrelu(pre2)      (64 -> 64 ch)
// with bias adds and lrelu in bf16, as ops/pallas_trainchain.py rounds.
//
// Replaces ops/pallas_trainchain.py:packed_stem: the forward kernel
// _stem_fwd_kernel (pallas_call at :530) and the backward _stem_bwd_kernel
// (:565), which recomputes pre1, s1 and pre2 and returns dx and per-program
// f32 dk1, db1, dk2, db2 partials.  The TPU kernel's width packing and its
// batch-only grid (one whole 128x128 plane per program, no halo logic)
// exist for its 128-lane VMEM and are dropped: here a block owns an 8x16
// pixel tile and recomputes the halo rings it needs (trainchain.cuh).
//
// x arrives zero-padded from 14 to 16 channels (the wrapper pads it), and
// conv1's K is 9 taps x 16 = 144: each tap is then one 16-deep WMMA step
// over a shifted view of the staged x region (trainchain.cuh), where K =
// 126 padded to 128 as one flat dimension would need an im2col copy.
//
// Bound on the H100 at the recipe shape (24x128x128, M = 393,216 pixels):
//   forward: conv1 2*M*144*64 + conv2 2*M*576*64 = 36.2 GFLOP (the halo
//   recompute of s1 adds 63% of conv1: 13 row fragments for 8 output rows);
//   x 12.6 MB (16 ch) + y 50.3 MB: 37 us of tensor cores at peak vs 19 us
//   of HBM: compute-bound, at the small N = 64 of WMMA tiles.
//   backward: conv2 twice (recompute, ds1 on the 13-fragment ring), conv1
//   twice, dx (2*M*576*16), dk1 and dk2 (2*M*(144+576)*64): about 130
//   GFLOP; dpre2, s1, dpre1 round trips through HBM, 4 x 50 MB.
// Design.  Forward, one launch: stage x on a 2-pixel ring (12x20
// positions), conv1 -> s1 on the 1-pixel ring in shared memory (zeroed
// outside the image: conv2's SAME padding), conv2 on the tile, bias,
// lrelu, one bf16 store.  All weights (k1 20 KB, k2 83 KB) sit in shared
// memory for the whole block; 8 warps, one output row each.
// Backward, three launches (the dx path needs dpre1 one ring out, which
// needs dpre2 two rings out: recomputing that chain inside one block would
// mean conv2 on a 3-pixel ring and conv1 on a 4-pixel one):
//   1. stem_front in backward mode: the forward recomputed, then dpre2 =
//      lrelu'(pre2) * dy; stores dpre2 and s1 (bf16, device memory);
//   2. stem_bwd2: dpre2 on the 2-pixel ring from device memory -> ds1 on
//      the 1-pixel ring (conv with the flipped, transposed k2), pre1
//      recomputed there, dpre1 = lrelu'(pre1) * ds1 (zero outside the
//      image), stored, then dx on the tile (conv with the flipped,
//      transposed k1);
//   3. wgrad_kernel: dk1 (x, dpre1), dk2 (s1, dpre2), db1, db2 as split-K
//      f32 partials (trainchain.cuh).
#include "trainchain.cuh"

namespace dvie {
namespace {

using namespace tc;

constexpr int NT = 256;                // 8 warps, one output row each
constexpr int CI = 16, C = 64;         // padded input channels, planes
constexpr int PW = TW + 4;             // region pitch: a ring of 2 (20)
constexpr int XPOS = (TH + 4) * PW;    // 240 positions of the 2-ring region
constexpr int XALLOC = 256;            // zero positions past it: shifted reads
constexpr int R1 = PW + 1;             // first position of the 1-ring (21)
constexpr int NF1 = 13;                // 1-ring fragments: positions [21, 229)
constexpr int LDX = CI;                // 32-byte positions
constexpr int LDW = C + 8, LDWF = CI + 8;
constexpr int LDS = C + 16;            // 160-byte positions: 32-byte aligned views
constexpr int LDC = C + 4;
constexpr int SPOS = 240;              // 1-ring positions allocated

constexpr int SZ_X = XALLOC * LDX * 2;         // 8192
constexpr int SZ_W1 = 9 * CI * LDW * 2;        // 20736
constexpr int SZ_W2 = 9 * C * LDW * 2;         // 82944
constexpr int SZ_S = SPOS * LDS * 2;           // 38400
constexpr int SZ_C = NT / 32 * 16 * LDC * 4;   // 34816

// forward / backward-launch-1 layout
constexpr int F_X = 0, F_W1 = F_X + SZ_X, F_W2 = align128(F_W1 + SZ_W1);
constexpr int F_S = align128(F_W2 + SZ_W2), F_C = align128(F_S + SZ_S);
constexpr int F_SMEM = F_C + SZ_C;
// backward launch 2: phase 1 (D2, W2f) and phase 2 (X, W1, W1f) share U
constexpr int B_D2 = 0, B_W2F = align128(B_D2 + XALLOC * LDS * 2);
constexpr int B_X = 0, B_W1 = B_X + SZ_X, B_W1F = align128(B_W1 + SZ_W1);
constexpr int B_U = align128(B_W2F + SZ_W2);
static_assert(B_W1F + 9 * C * LDWF * 2 <= B_U, "phase-2 operands fit the union");
constexpr int B_S = B_U, B_C = align128(B_S + SZ_S);
constexpr int B_SMEM = B_C + SZ_C;
static_assert(F_SMEM <= 232448 && B_SMEM <= 232448, "shared memory per block");

// offset of tap t (ky*3 + kx) in region positions
__device__ __forceinline__ int toff(int t) { return (t / 3 - 1) * PW + (t % 3 - 1); }

// image row / column of region position l (origin two pixels up-left)
__device__ __forceinline__ int ry(const Tile &t, int l) { return t.y0 - 2 + l / PW; }
__device__ __forceinline__ int rx(const Tile &t, int l) { return t.x0 - 2 + l % PW; }

// conv1 over the 1-ring: fragment f (positions R1 + 16 f ...), f32 in acc
__device__ __forceinline__ void conv1_frag(FragC (&acc)[4], const bf16 *Xs, const bf16 *W1s,
                                           int f) {
  zero(acc);
  const int l0 = R1 + 16 * f;
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, Xs + (l0 + toff(tp)) * LDX, LDX, W1s + tp * CI * LDW, LDW, 1);
}

// mode 0: y = the stem output.  mode 1 (backward launch 1): out = dpre2 =
// lrelu'(pre2) * dy, and s1 stored at the tile's pixels.
__global__ void __launch_bounds__(NT, 1)
stem_front_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w1,
                  const bf16 *__restrict__ b1, const bf16 *__restrict__ w2,
                  const bf16 *__restrict__ b2, const bf16 *__restrict__ dy,
                  bf16 *__restrict__ out, bf16 *__restrict__ s1_out, int H, int W, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + F_X);
  bf16 *W1s = reinterpret_cast<bf16 *>(smem + F_W1);
  bf16 *W2s = reinterpret_cast<bf16 *>(smem + F_W2);
  bf16 *Ss = reinterpret_cast<bf16 *>(smem + F_S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *Cw = reinterpret_cast<float *>(smem + F_C) + warp * 16 * LDC;
  const Tile t = tile_of(H, W);

  load_region(Xs, LDX, x, CI, 0, CI / 8, t, -2, -2, PW, XPOS, XALLOC, H, W);
  load_block_async(W1s, LDW, w1, C, 9 * CI, C);
  load_block_async(W2s, LDW, w2, C, 9 * C, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // s1 on the 1-ring, zero outside the image
  for (int f = warp; f < NF1; f += NT / 32) {
    FragC acc[4];
    conv1_frag(acc, Xs, W1s, f);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i % C, l = R1 + 16 * f + r;
      const float v = inside(ry(t, l), rx(t, l), H, W)
                          ? lrelu_bf(rbf(rbf(Cw[r * LDC + c]) + bf(b1[c])))
                          : 0.f;
      Ss[l * LDS + c] = __float2bfloat16(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // conv2 on the tile: warp = output row
  const int r = warp, l0 = (r + 2) * PW + 2, yy = t.y0 + r;
  FragC acc[4];
  zero(acc);
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, Ss + (l0 + toff(tp)) * LDS, LDS, W2s + tp * C * LDW, LDW, C / 16);
  store(Cw, LDC, acc);
  __syncwarp();
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int px = i / (C / 8), c = (i % (C / 8)) * 8, xx = t.x0 + px;
    if (yy >= H || xx >= W) continue;
    const long m = pix(t, yy, xx, H, W);
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = rbf(rbf(Cw[px * LDC + c + k]) + bf(b2[c + k]));
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = lrelu_bf(v[k]);
    } else {
      float g[8];
      unpack8(ldg16(dy + m * C + c), g);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = v[k] >= 0.f ? g[k] : rbf(0.2f * g[k]);
      st16(s1_out + m * C + c, *reinterpret_cast<const uint4 *>(Ss + (l0 + px) * LDS + c));
    }
    st16(out + m * C + c, pack8(v));
  }
}

// backward launch 2: ds1, dpre1 (stored) and dx on the tile
__global__ void __launch_bounds__(NT, 1)
stem_bwd2_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ dpre2,
                 const bf16 *__restrict__ w1, const bf16 *__restrict__ b1,
                 const bf16 *__restrict__ w1f, const bf16 *__restrict__ w2f,
                 bf16 *__restrict__ dpre1, bf16 *__restrict__ dx, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *D2s = reinterpret_cast<bf16 *>(smem + B_D2);
  bf16 *W2Fs = reinterpret_cast<bf16 *>(smem + B_W2F);
  bf16 *Xs = reinterpret_cast<bf16 *>(smem + B_X);
  bf16 *W1s = reinterpret_cast<bf16 *>(smem + B_W1);
  bf16 *W1Fs = reinterpret_cast<bf16 *>(smem + B_W1F);
  bf16 *Ds = reinterpret_cast<bf16 *>(smem + B_S);  // ds1, then dpre1 in place
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *Cw = reinterpret_cast<float *>(smem + B_C) + warp * 16 * LDC;
  const Tile t = tile_of(H, W);

  // ---- phase 1: ds1 = bf16(conv_t(dpre2, k2)) on the 1-ring
  load_region(D2s, LDS, dpre2, C, 0, C / 8, t, -2, -2, PW, XPOS, XALLOC, H, W);
  load_block_async(W2Fs, LDW, w2f, C, 9 * C, C);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int f = warp; f < NF1; f += NT / 32) {
    FragC acc[4];
    zero(acc);
    const int l0 = R1 + 16 * f;
#pragma unroll 1
    for (int tp = 0; tp < 9; ++tp)
      warp_mma(acc, D2s + (l0 + toff(tp)) * LDS, LDS, W2Fs + tp * C * LDW, LDW, C / 16);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i % C;
      Ds[(l0 + r) * LDS + c] = __float2bfloat16(Cw[r * LDC + c]);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 2: pre1 recomputed on the 1-ring; dpre1 = lrelu'(pre1) * ds1
  load_region(Xs, LDX, x, CI, 0, CI / 8, t, -2, -2, PW, XPOS, XALLOC, H, W);
  load_block_async(W1s, LDW, w1, C, 9 * CI, C);
  load_block_async(W1Fs, LDWF, w1f, CI, 9 * C, CI);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int f = warp; f < NF1; f += NT / 32) {
    FragC acc[4];
    conv1_frag(acc, Xs, W1s, f);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i % C, l = R1 + 16 * f + r;
      const float pre = rbf(rbf(Cw[r * LDC + c]) + bf(b1[c]));
      const float d = bf(Ds[l * LDS + c]);
      const float v = inside(ry(t, l), rx(t, l), H, W) ? (pre >= 0.f ? d : rbf(0.2f * d)) : 0.f;
      Ds[l * LDS + c] = __float2bfloat16(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase 3: dpre1 out at the tile's pixels; dx = conv_t(dpre1, k1)
  const int r = warp, l0 = (r + 2) * PW + 2, yy = t.y0 + r;
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int px = i / (C / 8), c = (i % (C / 8)) * 8, xx = t.x0 + px;
    if (yy < H && xx < W)
      st16(dpre1 + pix(t, yy, xx, H, W) * C + c,
           *reinterpret_cast<const uint4 *>(Ds + (l0 + px) * LDS + c));
  }
  FragC acc[1];
  zero(acc);
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, Ds + (l0 + toff(tp)) * LDS, LDS, W1Fs + tp * C * LDWF, LDWF, C / 16);
  store(Cw, LDC, acc);
  __syncwarp();
  {
    const int px = lane / 2, c = (lane % 2) * 8, xx = t.x0 + px;
    if (yy < H && xx < W) st16(dx + pix(t, yy, xx, H, W) * CI + c, pack8(Cw + px * LDC + c));
  }
}

int set_smem() {
  cudaError_t e = cudaFuncSetAttribute(stem_front_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(stem_bwd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             B_SMEM);
  return (int)e;
}

}  // namespace
}  // namespace dvie

// x16 (B,H,W,16): x zero-padded from 14 channels; w1 (9,16,64) taps of k1
// (rows 14, 15 of each tap zero), b1 (64,), w2 (9,64,64), b2 (64,); y
// (B,H,W,64).  All bf16.
extern "C" int dvie_stem_fwd(const void *x16, const void *w1, const void *b1, const void *w2,
                             const void *b2, void *y, int B, int H, int W, void *stream) {
  using dvie::bf16;
  int e = dvie::set_smem();
  if (e) return e;
  dvie::stem_front_kernel<<<dvie::tc::n_tiles(B, H, W), dvie::NT, dvie::F_SMEM,
                            (cudaStream_t)stream>>>(
      (const bf16 *)x16, (const bf16 *)w1, (const bf16 *)b1, (const bf16 *)w2, (const bf16 *)b2,
      nullptr, (bf16 *)y, nullptr, H, W, 0);
  return (int)cudaGetLastError();
}

// The backward.  Inputs as dvie_stem_fwd plus dy (B,H,W,64), w1f (9,64,16)
// and w2f (9,64,64): the taps of k1 and k2 flipped and transposed (the
// transposed convs as SAME convs).  Scratch: dpre2, s1, dpre1 (B,H,W,64)
// bf16.  Outputs: dx16 (B,H,W,16) bf16; f32 partials over `splits` pixel
// ranges: pk1 (splits,9,16,64), pb1 (splits,16,64) (every row the same
// sum), pk2 (splits,9,64,64), pb2 (splits,16,64).
extern "C" int dvie_stem_bwd(const void *x16, const void *dy, const void *w1, const void *b1,
                             const void *w2, const void *b2, const void *w1f, const void *w2f,
                             void *dpre2, void *s1, void *dpre1, void *dx16, void *pk1, void *pb1,
                             void *pk2, void *pb2, int B, int H, int W, int splits,
                             void *stream) {
  using dvie::bf16;
  namespace tc = dvie::tc;
  int e = dvie::set_smem();
  if (e) return e;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = tc::n_tiles(B, H, W);
  dvie::stem_front_kernel<<<grid, dvie::NT, dvie::F_SMEM, st>>>(
      (const bf16 *)x16, (const bf16 *)w1, (const bf16 *)b1, (const bf16 *)w2, (const bf16 *)b2,
      (const bf16 *)dy, (bf16 *)dpre2, (bf16 *)s1, H, W, 1);
  if ((e = (int)cudaGetLastError())) return e;
  dvie::stem_bwd2_kernel<<<grid, dvie::NT, dvie::B_SMEM, st>>>(
      (const bf16 *)x16, (const bf16 *)dpre2, (const bf16 *)w1, (const bf16 *)b1,
      (const bf16 *)w1f, (const bf16 *)w2f, (bf16 *)dpre1, (bf16 *)dx16, H, W);
  if ((e = (int)cudaGetLastError())) return e;
  tc::WJobs jobs;
  jobs.n = 0;
  const int C = dvie::C, CI = dvie::CI;
  for (int t = 0; t < 9; ++t)
    jobs.j[jobs.n++] = tc::job(x16, CI, dpre1, C, (float *)pk1 + t * CI * C, 9L * CI * C,
                               t / 3 - 1, t % 3 - 1);
  for (int t = 0; t < 9; ++t)
    jobs.j[jobs.n++] = tc::job(s1, C, dpre2, C, (float *)pk2 + t * C * C, 9L * C * C, t / 3 - 1,
                               t % 3 - 1);
  jobs.j[jobs.n++] = tc::job(nullptr, CI, dpre1, C, (float *)pb1, (long)CI * C);
  jobs.j[jobs.n++] = tc::job(nullptr, CI, dpre2, C, (float *)pb2, (long)CI * C);
  return tc::launch_wgrad(jobs, B * H * W, H, W, splits, st);
}
