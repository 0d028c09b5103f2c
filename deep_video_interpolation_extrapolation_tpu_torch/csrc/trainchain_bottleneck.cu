// The layer1 Bottleneck in training: forward and backward, NHWC bf16, f32
// accumulation.
//   h1 = lrelu(bf16(x . k1))            (Ci -> 64)
//   h2 = lrelu(bf16(conv3x3(h1, k2)))   (64 -> 64)
//   pre_y = bf16(h2 . k3) + (bf16(x . kres) if kres else x)   (-> 256)
//   y = lrelu(pre_y)
// with residual adds and lrelu in bf16, as ops/pallas_trainchain.py rounds.
//
// Replaces ops/pallas_trainchain.py:packed_bottleneck: the forward kernel
// _bn_fwd_kernel (pallas_call at :400; also pallas_resblock.fused_bottleneck,
// :270, the same function) and the backward _bn_bwd_kernel (:445), which
// recomputes h1, h2 and pre_y and returns dx and per-program f32 dk1, dk2,
// dk3, dkres partials.  Width packing, the A+E split of the taps and the
// batch-only grid are TPU devices and are dropped: a block owns an 8x16
// pixel tile and recomputes h1 on the ring its conv3x3 needs
// (trainchain.cuh).
//
// Bound on the H100 at the recipe shape (24x128x128, M = 393,216 pixels):
//   forward: 2*M*(Ci*64 + 576*64 + 64*256) = 54.8 GFLOP at Ci = 256 (+12%
//   for h1 on the ring; + 2*M*64*256 with kres at Ci = 64); x 201 MB +
//   y 201 MB at Ci = 256: 55 us of tensor cores vs 120 us of HBM at peak:
//   memory-bound.  h1 and h2 (64 ch each) never reach device memory.
//   backward: about 2.5x the forward's products plus the weight grads
//   (2*M*(Ci*64 + 576*64 + 64*256 [+ Ci*256]) again), and the round trips
//   of h1, h2, dpre2, dpre1 (50 MB each) and dpre_y (201 MB).
// Design.  Forward, one launch of bottleneck_front: x staged in 64-channel
// chunks on the 1-pixel ring (10x18 positions) -> h1 on the ring in shared
// memory -> conv2 on the tile (all 9 taps of k2, 83 KB, in shared memory)
// -> h2 -> the 256 output channels in four 64-wide chunks, each with its
// residual, rounded and stored.  8 warps, one output row each.
// Backward, three launches (dh1 on the tile needs dpre2 one ring out, and
// dpre2 there needs h2, so h1, two rings out: one launch would redo
// conv2 on the ring as well):
//   1. bottleneck_front in backward mode: the forward recomputed, then
//      dpre_y = lrelu'(pre_y) * dy, dh2 = bf16(dpre_y . k3^T), dpre2 =
//      lrelu'(h2) * dh2; stores h1, h2, dpre_y and dpre2 (bf16);
//   2. bottleneck_bwd2 on 64-pixel rows: dh1 = bf16(conv_t(dpre2, k2)) from
//      device memory (shifted, zero-filled loads), dpre1 = lrelu'(h1) * dh1
//      (stored), dx = bf16(dpre1 . k1^T + (dpre_y . kres^T or dpre_y));
//   3. wgrad_kernel: dk1 (x, dpre1), dk2 (h1, dpre2), dk3 (h2, dpre_y),
//      dkres (x, dpre_y) as split-K f32 partials (trainchain.cuh).
#include "trainchain.cuh"

namespace dvie {
namespace {

using namespace tc;

constexpr int NT = 256;                 // 8 warps, one output row each
constexpr int P = 64, CO = 256;
constexpr int PW = TW + 2;              // region pitch: a ring of 1 (18)
constexpr int RPOS = (TH + 2) * PW;     // 180 positions
constexpr int NFR = 12, RALLOC = NFR * 16;  // h1 fragments: positions [0, 192)
constexpr int TP = TH * TW;             // 128 tile pixels
constexpr int LDX = 64 + 8, LDW = 64 + 8, LDH2 = P + 8, LDC = 64 + 4;
constexpr int LDH = P + 16;             // 160-byte positions: 32-byte aligned views
constexpr int LDY = CO + 8;

// shared memory: one union region U whose use changes by phase, the h1
// ring (dead after conv2) sharing room with the 256-ch pre_y / dpre_y
constexpr int SZ_U = 9 * P * LDW * 2;                     // 82944: all of k2
constexpr int U_X = 0, U_W = align128(RALLOC * LDX * 2);  // phase A: x chunk, k1 chunk
constexpr int U_W3 = 0, U_XT = align128(64 * LDW * 2), U_WR = align128(U_XT + TP * LDX * 2);
static_assert(U_W + 64 * LDW * 2 <= SZ_U && U_WR + 64 * LDW * 2 <= SZ_U &&
                  CO * LDW * 2 <= SZ_U, "every phase fits the union");
constexpr int OFF_HY = SZ_U;
constexpr int SZ_HY = RALLOC * LDH * 2 > TP * LDY * 2 ? RALLOC * LDH * 2 : TP * LDY * 2;
constexpr int OFF_H2 = align128(OFF_HY + SZ_HY);
constexpr int OFF_C = align128(OFF_H2 + TP * LDH2 * 2);
constexpr int SMEM = OFF_C + NT / 32 * 16 * LDC * 4;
static_assert(SMEM <= 232448, "shared memory per block");

__device__ __forceinline__ int toff(int t) { return (t / 3 - 1) * PW + (t % 3 - 1); }

// mode 0: out = y.  mode 1 (backward launch 1): out = dpre2; h1, h2 and
// dpre_y stored at the tile's pixels.
__global__ void __launch_bounds__(NT, 1)
bottleneck_front_kernel(const bf16 *__restrict__ x, const bf16 *__restrict__ w1,
                        const bf16 *__restrict__ w2, const bf16 *__restrict__ w3,
                        const bf16 *__restrict__ wres, const bf16 *__restrict__ w3t,
                        const bf16 *__restrict__ dy, bf16 *__restrict__ out,
                        bf16 *__restrict__ h1_out, bf16 *__restrict__ h2_out,
                        bf16 *__restrict__ dpre_y, int H, int W, int Ci, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char *U = smem;
  bf16 *Hs = reinterpret_cast<bf16 *>(smem + OFF_HY);  // h1 ring, phases A-B
  bf16 *Ys = reinterpret_cast<bf16 *>(smem + OFF_HY);  // pre_y / dpre_y, phases C-D
  bf16 *H2s = reinterpret_cast<bf16 *>(smem + OFF_H2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *Cw = reinterpret_cast<float *>(smem + OFF_C) + warp * 16 * LDC;
  const Tile t = tile_of(H, W);
  const int nk = Ci / 64;

  // ---- phase A: h1 = lrelu(bf16(x . k1)) on the ring (zero outside the
  // image, as x is); warps 0-3 own two fragments, 4-7 one
  {
    bf16 *Xs = reinterpret_cast<bf16 *>(U + U_X);
    bf16 *Ws = reinterpret_cast<bf16 *>(U + U_W);
    const int nf = warp + 8 < NFR ? 2 : 1;
    FragC acc[2][4];
    zero(acc[0]);
    zero(acc[1]);
    for (int kc = 0; kc < nk; ++kc) {
      load_region(Xs, LDX, x, Ci, kc * 64, 8, t, -1, -1, PW, RPOS, RALLOC, H, W);
      load_block_async(Ws, LDW, w1 + (long)kc * 64 * P, P, 64, P);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      warp_mma(acc[0], Xs + warp * 16 * LDX, LDX, Ws, LDW, 4);
      if (nf == 2) warp_mma(acc[1], Xs + (warp + 8) * 16 * LDX, LDX, Ws, LDW, 4);
      __syncthreads();
    }
    for (int q = 0; q < nf; ++q) {
      const int l0 = (warp + 8 * q) * 16;
      store(Cw, LDC, acc[q]);
      __syncwarp();
      for (int i = lane; i < 16 * P; i += 32) {
        const int r = i / P, c = i % P;
        Hs[(l0 + r) * LDH + c] = __float2bfloat16(lrelu_bf(rbf(Cw[r * LDC + c])));
      }
      __syncwarp();
    }
  }
  bf16 *W2s = reinterpret_cast<bf16 *>(U);
  load_block_async(W2s, LDW, w2, P, 9 * P, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r = warp, l0 = (r + 1) * PW + 1, yy = t.y0 + r;
  if (mode == 1) {  // h1 at the tile's pixels, for the weight grads
    for (int i = lane; i < 16 * (P / 8); i += 32) {
      const int px = i / (P / 8), c = (i % (P / 8)) * 8, xx = t.x0 + px;
      if (yy < H && xx < W)
        st16(h1_out + pix(t, yy, xx, H, W) * P + c,
             *reinterpret_cast<const uint4 *>(Hs + (l0 + px) * LDH + c));
    }
  }

  // ---- phase B: h2 = lrelu(bf16(conv3x3(h1, k2))) on this warp's row
  FragC acc[4];
  zero(acc);
#pragma unroll 1
  for (int tp = 0; tp < 9; ++tp)
    warp_mma(acc, Hs + (l0 + toff(tp)) * LDH, LDH, W2s + tp * P * LDW, LDW, P / 16);
  store(Cw, LDC, acc);
  __syncwarp();
  bf16 *H2w = H2s + r * 16 * LDH2;
  for (int i = lane; i < 16 * P; i += 32) {
    const int px = i / P, c = i % P;
    H2w[px * LDH2 + c] = __float2bfloat16(lrelu_bf(rbf(Cw[px * LDC + c])));
  }
  __syncwarp();
  if (mode == 1) {
    for (int i = lane; i < 16 * (P / 8); i += 32) {
      const int px = i / (P / 8), c = (i % (P / 8)) * 8, xx = t.x0 + px;
      if (yy < H && xx < W)
        st16(h2_out + pix(t, yy, xx, H, W) * P + c,
             *reinterpret_cast<const uint4 *>(H2w + px * LDH2 + c));
    }
  }
  __syncthreads();  // U (k2) and the h1 ring are free from here

  // ---- phase C: pre_y, 64 output channels at a time
  bf16 *Yw = Ys + r * 16 * LDY;
  bf16 *W3s = reinterpret_cast<bf16 *>(U + U_W3);
  bf16 *XTs = reinterpret_cast<bf16 *>(U + U_XT);
  bf16 *WRs = reinterpret_cast<bf16 *>(U + U_WR);
  for (int nc = 0; nc < CO / 64; ++nc) {
    load_block_async(W3s, LDW, w3 + nc * 64, CO, P, 64);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    zero(acc);
    warp_mma(acc, H2w, LDH2, W3s, LDW, P / 16);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * 64; i += 32) {
      const int px = i / 64, c = i % 64;
      Yw[px * LDY + nc * 64 + c] = __float2bfloat16(Cw[px * LDC + c]);
    }
    __syncwarp();
    if (wres) {  // + bf16(x . kres)
      zero(acc);
      for (int kc = 0; kc < nk; ++kc) {
        __syncthreads();
        load_region(XTs, LDX, x, Ci, kc * 64, 8, t, 0, 0, TW, TP, TP, H, W);
        load_block_async(WRs, LDW, wres + (long)kc * 64 * CO + nc * 64, CO, 64, 64);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        warp_mma(acc, XTs + r * 16 * LDX, LDX, WRs, LDW, 4);
      }
      store(Cw, LDC, acc);
      __syncwarp();
      for (int i = lane; i < 16 * 64; i += 32) {
        const int px = i / 64, c = i % 64;
        bf16 &yv = Yw[px * LDY + nc * 64 + c];
        yv = __float2bfloat16(rbf(bf(yv) + rbf(Cw[px * LDC + c])));
      }
    } else {  // + x (Ci == CO)
      for (int i = lane; i < 16 * 8; i += 32) {
        const int px = i / 8, c = nc * 64 + (i % 8) * 8, xx = t.x0 + px;
        float xv[8], v[8];
        if (yy < H && xx < W) {
          unpack8(ldg16(x + pix(t, yy, xx, H, W) * CO + c), xv);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) xv[k] = 0.f;
        }
        unpack8(*reinterpret_cast<const uint4 *>(Yw + px * LDY + c), v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = rbf(v[k] + xv[k]);
        st16(Yw + px * LDY + c, pack8(v));
      }
    }
    __syncwarp();
    __syncthreads();  // U is refilled by the next chunk
  }

  // ---- pre_y -> y (mode 0), or dpre_y = lrelu'(pre_y) * dy (mode 1)
  for (int i = lane; i < 16 * (CO / 8); i += 32) {
    const int px = i / (CO / 8), c = (i % (CO / 8)) * 8, xx = t.x0 + px;
    if (yy >= H || xx >= W) continue;
    const long m = pix(t, yy, xx, H, W);
    float v[8];
    unpack8(*reinterpret_cast<const uint4 *>(Yw + px * LDY + c), v);
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = lrelu_bf(v[k]);
      st16(out + m * CO + c, pack8(v));
    } else {
      float g[8];
      unpack8(ldg16(dy + m * CO + c), g);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = v[k] >= 0.f ? g[k] : rbf(0.2f * g[k]);
      const uint4 d = pack8(v);
      st16(Yw + px * LDY + c, d);
      st16(dpre_y + m * CO + c, d);
    }
  }
  if (mode == 0) return;

  // ---- phase D: dh2 = bf16(dpre_y . k3^T), dpre2 = lrelu'(h2) * dh2
  // (rows of dpre_y past the image are garbage and only feed rows that are
  // not stored)
  bf16 *W3Ts = reinterpret_cast<bf16 *>(U);
  load_block_async(W3Ts, LDW, w3t, P, CO, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  zero(acc);
  warp_mma(acc, Yw, LDY, W3Ts, LDW, CO / 16);
  store(Cw, LDC, acc);
  __syncwarp();
  for (int i = lane; i < 16 * (P / 8); i += 32) {
    const int px = i / (P / 8), c = (i % (P / 8)) * 8, xx = t.x0 + px;
    if (yy >= H || xx >= W) continue;
    float h[8], v[8];
    unpack8(*reinterpret_cast<const uint4 *>(H2w + px * LDH2 + c), h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = rbf(Cw[px * LDC + c + k]);
      v[k] = h[k] >= 0.f ? d : rbf(0.2f * d);
    }
    st16(out + pix(t, yy, xx, H, W) * P + c, pack8(v));
  }
}

// ---- backward launch 2, on rows of 64 consecutive pixels ----------------

constexpr int TM2 = 64, NT2 = 128, TK = 64, LDS2 = TK + 8;
constexpr int RPT = TM2 * (TK / 8) / NT2;       // staged rows per thread (4)
constexpr int STAGE2 = 2 * TM2 * LDS2 * 2;      // one A + one B tile
constexpr int OFF2_D = align128(2 * STAGE2);
constexpr int OFF2_C = align128(OFF2_D + TM2 * LDS2 * 2);
constexpr int SMEM2 = OFF2_C + NT2 / 32 * 16 * LDC * 4;

struct Rows {
  int m[RPT], y[RPT], x[RPT];  // flat pixel, row, column (y = -2 past the end)
};

// A tile: 64 pixels x channels [c0, c0+64) of src (C channels) at the pixel
// shifted by (dy, dx), zeros outside the image
__device__ __forceinline__ void load_a(bf16 *As, const Rows &rows, const bf16 *src, int C, int c0,
                                       int dy, int dx, int H, int W) {
  const int v = threadIdx.x % (TK / 8);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.x / (TK / 8) + k * (NT2 / (TK / 8));
    const bool ok = inside(rows.y[k] + dy, rows.x[k] + dx, H, W);
    const bf16 *p = ok ? src + (long)(rows.m[k] + dy * W + dx) * C + c0 + v * 8 : src;
    cp_async16(As + r * LDS2 + v * 8, p, ok);
  }
}

// acc += A . B over `steps` 64-deep steps, double-buffered; load(step, As,
// Bs) issues a step's loads.  A comes from the stage when a_s is null, else
// from shared memory at a_s (this warp's rows, step * 64 columns).
template <class Load>
__device__ __forceinline__ void pipe_gemm(FragC (&acc)[4], unsigned char *smem, int steps,
                                          Load load, const bf16 *a_s, int lda) {
  const int row0 = (threadIdx.x >> 5) * 16;
  auto stage = [&](int i) { return reinterpret_cast<bf16 *>(smem + (i & 1) * STAGE2); };
  load(0, stage(0), stage(0) + TM2 * LDS2);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1, stage(s + 1), stage(s + 1) + TM2 * LDS2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16 *As = stage(s);
    if (a_s)
      warp_mma(acc, a_s + row0 * lda + s * TK, lda, As + TM2 * LDS2, LDS2, TK / 16);
    else
      warp_mma(acc, As + row0 * LDS2, LDS2, As + TM2 * LDS2, LDS2, TK / 16);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT2)
bottleneck_bwd2_kernel(const bf16 *__restrict__ dpre2, const bf16 *__restrict__ h1,
                       const bf16 *__restrict__ dpre_y, const bf16 *__restrict__ w2f,
                       const bf16 *__restrict__ w1t, const bf16 *__restrict__ wrest,
                       bf16 *__restrict__ dpre1, bf16 *__restrict__ dx, int B, int H, int W,
                       int Ci) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Ds = reinterpret_cast<bf16 *>(smem + OFF2_D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  float *Cw = reinterpret_cast<float *>(smem + OFF2_C) + row0 * LDC;
  const long M = (long)B * H * W;
  const long m0 = (long)blockIdx.x * TM2;
  Rows rows;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long m = m0 + threadIdx.x / (TK / 8) + k * (NT2 / (TK / 8));
    rows.m[k] = (int)m;
    rows.x[k] = (int)(m % W);
    rows.y[k] = m < M ? (int)((m / W) % H) : -2;  // -2: every tap invalid
  }
  auto load_b = [&](bf16 *Bs, const bf16 *w, int ld, int k0, int n0) {
    load_block_async(Bs, LDS2, w + (long)k0 * ld + n0, ld, TK, 64);
  };

  // dh1 = bf16(conv_t(dpre2, k2)): a SAME conv with the flipped taps
  FragC acc[4];
  zero(acc);
  pipe_gemm(acc, smem, 9, [&](int s, bf16 *As, bf16 *Bs) {
    load_a(As, rows, dpre2, P, 0, s / 3 - 1, s % 3 - 1, H, W);
    load_b(Bs, w2f, P, s * P, 0);
  }, nullptr, 0);
  store(Cw, LDC, acc);
  __syncwarp();
  for (int i = lane; i < 16 * (P / 8); i += 32) {
    const int r = i / (P / 8), c = (i % (P / 8)) * 8;
    const long m = m0 + row0 + r;
    float h[8], v[8];
    if (m < M) {
      unpack8(ldg16(h1 + m * P + c), h);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = rbf(Cw[r * LDC + c + k]);
        v[k] = h[k] >= 0.f ? d : rbf(0.2f * d);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
    const uint4 d = pack8(v);
    st16(Ds + (row0 + r) * LDS2 + c, d);
    if (m < M) st16(dpre1 + m * P + c, d);
  }
  __syncwarp();

  // dx = bf16(dpre1 . k1^T + (dpre_y . kres^T | dpre_y)), 64 channels at a time
  for (int cc = 0; cc < Ci / 64; ++cc) {
    zero(acc);
    pipe_gemm(acc, smem, 1, [&](int, bf16 *, bf16 *Bs) { load_b(Bs, w1t, Ci, 0, cc * 64); },
              Ds, LDS2);
    if (wrest)
      pipe_gemm(acc, smem, CO / TK, [&](int s, bf16 *As, bf16 *Bs) {
        load_a(As, rows, dpre_y, CO, s * TK, 0, 0, H, W);
        load_b(Bs, wrest, Ci, s * TK, cc * 64);
      }, nullptr, 0);
    store(Cw, LDC, acc);
    __syncwarp();
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = cc * 64 + (i % 8) * 8;
      const long m = m0 + row0 + r;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = Cw[r * LDC + (i % 8) * 8 + k];
      if (!wrest) {  // identity residual: Ci == CO
        float g[8];
        unpack8(ldg16(dpre_y + m * CO + c), g);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += g[k];
      }
      st16(dx + m * Ci + c, pack8(v));
    }
    __syncwarp();
  }
}

int set_smem() {
  cudaError_t e = cudaFuncSetAttribute(bottleneck_front_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bottleneck_bwd2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM2);
  return (int)e;
}

}  // namespace
}  // namespace dvie

// x (B,H,W,Ci); w1 (Ci,64) = k1 as a matrix; w2 (9,64,64) the taps of k2;
// w3 (64,256); wres (Ci,256) or NULL (then Ci must be 256); y (B,H,W,256).
// All bf16, Ci % 64 == 0.
extern "C" int dvie_bottleneck_fwd(const void *x, const void *w1, const void *w2, const void *w3,
                                   const void *wres, void *y, int B, int H, int W, int Ci,
                                   void *stream) {
  using dvie::bf16;
  int e = dvie::set_smem();
  if (e) return e;
  dvie::bottleneck_front_kernel<<<dvie::tc::n_tiles(B, H, W), dvie::NT, dvie::SMEM,
                                  (cudaStream_t)stream>>>(
      (const bf16 *)x, (const bf16 *)w1, (const bf16 *)w2, (const bf16 *)w3,
      (const bf16 *)wres, nullptr, nullptr, (bf16 *)y, nullptr, nullptr, nullptr, H, W, Ci, 0);
  return (int)cudaGetLastError();
}

// The backward.  Inputs as dvie_bottleneck_fwd plus dy (B,H,W,256), w1t
// (64,Ci), w2f (9,64,64) (taps of k2 flipped and transposed), w3t (256,64),
// wrest (256,Ci) or NULL.  Scratch: h1, h2, dpre2, dpre1 (B,H,W,64), dpre_y
// (B,H,W,256).  Outputs: dx (B,H,W,Ci) bf16; f32 partials over `splits`
// pixel ranges: pk1 (splits,Ci,64), pk2 (splits,9,64,64), pk3
// (splits,64,256), pkres (splits,Ci,256) or NULL.
extern "C" int dvie_bottleneck_bwd(const void *x, const void *dy, const void *w1, const void *w2,
                                   const void *w3, const void *wres, const void *w1t,
                                   const void *w2f, const void *w3t, const void *wrest, void *h1,
                                   void *h2, void *dpre_y, void *dpre2, void *dpre1, void *dx,
                                   void *pk1, void *pk2, void *pk3, void *pkres, int B, int H,
                                   int W, int Ci, int splits, void *stream) {
  using dvie::bf16;
  namespace tc = dvie::tc;
  int e = dvie::set_smem();
  if (e) return e;
  cudaStream_t st = (cudaStream_t)stream;
  dvie::bottleneck_front_kernel<<<tc::n_tiles(B, H, W), dvie::NT, dvie::SMEM, st>>>(
      (const bf16 *)x, (const bf16 *)w1, (const bf16 *)w2, (const bf16 *)w3,
      (const bf16 *)wres, (const bf16 *)w3t, (const bf16 *)dy, (bf16 *)dpre2, (bf16 *)h1,
      (bf16 *)h2, (bf16 *)dpre_y, H, W, Ci, 1);
  if ((e = (int)cudaGetLastError())) return e;
  const long M = (long)B * H * W;
  dvie::bottleneck_bwd2_kernel<<<(unsigned)((M + dvie::TM2 - 1) / dvie::TM2), dvie::NT2,
                                 dvie::SMEM2, st>>>(
      (const bf16 *)dpre2, (const bf16 *)h1, (const bf16 *)dpre_y, (const bf16 *)w2f,
      (const bf16 *)w1t, (const bf16 *)wrest, (bf16 *)dpre1, (bf16 *)dx, B, H, W, Ci);
  if ((e = (int)cudaGetLastError())) return e;
  const int P = dvie::P, CO = dvie::CO;
  tc::WJobs jobs;
  jobs.n = 0;
  jobs.j[jobs.n++] = tc::job(x, Ci, dpre1, P, (float *)pk1, (long)Ci * P);
  for (int t = 0; t < 9; ++t)
    jobs.j[jobs.n++] = tc::job(h1, P, dpre2, P, (float *)pk2 + t * P * P, 9L * P * P, t / 3 - 1,
                               t % 3 - 1);
  jobs.j[jobs.n++] = tc::job(h2, P, dpre_y, CO, (float *)pk3, (long)P * CO);
  if (wres) jobs.j[jobs.n++] = tc::job(x, Ci, dpre_y, CO, (float *)pkres, (long)Ci * CO);
  return tc::launch_wgrad(jobs, (int)M, H, W, splits, st);
}
