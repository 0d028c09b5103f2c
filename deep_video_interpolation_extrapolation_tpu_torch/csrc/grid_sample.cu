// Bilinear grid sample (the backward warp), NHWC, bf16 or f32:
//   fx = (gx + 1) * 0.5 * (W - 1),  fy = (gy + 1) * 0.5 * (H - 1)   (f32)
//   out[b,i,j,c] = sum over the 4 corners (y, x) of (fy, fx) of
//                  relu(1 - |fy - y|) * relu(1 - |fx - x|) * x[b,y,x,c]
// over the corners inside the image (zero padding, align_corners=True: torch
// F.grid_sample's rule), summed in f32 and rounded once to x's type.  With
// max_disp = R >= 0 a corner also counts only if y - i and x - j both lie in
// [-R, R+1]: the window of the TPU kernel, so a sample farther than R pixels
// from its output pixel gives 0, and one at the window's edge keeps only the
// corners inside it.  R < 0 is unbounded (ops/warp.grid_sample's function).
//
// Two forward entries and a backward.  dvie_grid_sample reads an f32 grid
// (B,H,W,2).
// dvie_warp_steps reads the flow instead: x (B,H,W,C) is warped by each of
// T steps of flow (B,T,H,W,2), optionally times mask (B,T,H,W,1), into out
// (B,T,H,W,C) = stack_t backward_warp(x, flow[:, t] * mask[:, t]): the
// product is rounded to the flow's type as the model's own product is, and
// g = base - f with base the make_base_grid linspaces (bx, by, made once per
// shape by torch.linspace on the card, so the coordinates are the model's
// bit for bit).  No grid is written and there is no stack; x is read from
// HBM once for all T steps (L2 serves the rest).
// dvie_warp_steps_bwd is the flow entry's backward with respect to flow and
// mask (unbounded mode; see warp_bwd_kernel below).
//
// Replaces ops/pallas_warp.py:grid_sample_pallas (pallas_call at :134).  The
// TPU has no vector gather, so its kernel rolls a zero-padded halo slab over
// every offset of a (2R+2)^2 window.  Hopper gathers.  Bound on the H100 at
// 8x512x1024, C = 3, bf16: by bytes (x 25.2 MB, grid 33.6 MB f32 or flow
// 16.8 MB bf16, out 25.2 MB at 3.35 TB/s: 25 or 20 us; ~40 f32 operations a
// pixel).  What holds it is L1: on random flows each corner load of a warp
// touches up to 32 lines, one L1 wavefront each.  Design:
// - a block owns a TH x 64 tile of one image and step (TH = 16, or 8 where
//   16-row tiles would not fill the card: the VAE's 8x128x128); 256
//   threads, TH / 4 pixels each, a warp on 32 neighbouring columns of a row
//   (coalesced grid, flow and mask reads); 32-bit index math, no division
//   per pixel;
// - every coordinate load of a thread is issued before any is used (the
//   flow's layout and the mask are tested once, outside the pixel loop);
// - the two corners of a row (2C values, 12 bytes at C = 3 bf16) come in
//   at most two aligned 16-byte loads through L1 (__ldg), only where a
//   valid byte lies in them, both rows' loads issued together, and are
//   taken apart in registers: 3.25 loads a pixel on average where one per
//   corner and channel takes 12;
// - the bounded mode gathers the same way and tests each corner against
//   its window.  Staging the tile's window in shared memory (by cp.async,
//   and by double-buffered bulk copies) measured slower at R = 8: the
//   staging's latency on every tile cost more than the shared-memory
//   gathers saved over L1;
// - stores: the tile's outputs are staged in shared memory and written as
//   contiguous 16-byte chunks a row (elementwise where a row is not
//   16-byte aligned);
// - C = 3 bf16 (the frames) takes the pair loads; other channel counts and
//   f32 read each channel on its own and store directly.
// Coordinates, weights and sums use the _rn intrinsics in the plain
// version's order (no contraction into FMAs), so kernel and plain agree
// bit for bit.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int TW = 64, THREADS = 256, RPP = THREADS / TW;  // RPP: rows a pass

struct Geo {
  const unsigned char *x;  // frames (B,H,W,C), (H,W,C) contiguous
  long long sxb;           // bytes between frames
  unsigned char *out;      // (B,T,H,W,C) contiguous
  int B, T, H, W, C, R;    // R < 0: unbounded
};

__device__ __forceinline__ float ldf(const float *p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const bf16 *p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short *>(p)) << 16);
}
// both values of an aligned pair
__device__ __forceinline__ float2 ldf2(const float *p) {
  return __ldg(reinterpret_cast<const float2 *>(p));
}
__device__ __forceinline__ float2 ldf2(const bf16 *p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned *>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float round_as(const float *, float v) { return v; }
__device__ __forceinline__ float round_as(const bf16 *, float v) { return rbf(v); }
__device__ __forceinline__ void st_elem(float *p, float v) { *p = v; }
__device__ __forceinline__ void st_elem(bf16 *p, float v) { *p = __float2bfloat16(v); }

// normalized coordinate -> pixel coordinate, align_corners
__device__ __forceinline__ float pix(float g, int n) {
  return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f), (float)(n - 1));
}

// The pixels of a thread: column j, rows i0 + tid / TW + k * RPP (k < PPT).
// A coordinate source gives their pixel coordinates (fx, fy) for one step,
// 0 outside the image, with every load issued before any is used.
__device__ __forceinline__ int row_of(int i0, int k) {
  return i0 + (int)threadIdx.x / TW + k * RPP;
}

// The grid entry: (B,H,W,2) f32, contiguous.
struct GridSrc {
  const float2 *grid;
  struct At {
    const float2 *g;
    int H, W;
    __device__ __forceinline__ float base_x(int) const { return 0.f; }
    template <int PPT>
    __device__ __forceinline__ void tile(int i0, int j, float, float (&fx)[PPT],
                                         float (&fy)[PPT]) const {
      float2 v[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = row_of(i0, k);
        v[k] = make_float2(0.f, 0.f);
        if (i < H && j < W) v[k] = __ldg(g + i * W + j);
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        fx[k] = pix(v[k].x, W);
        fy[k] = pix(v[k].y, H);
      }
    }
  };
  __device__ __forceinline__ At bind(int b, int, int H, int W) const {
    return {grid + (long long)b * H * W, H, W};
  }
};

// The flow entry: flow (B,T,H,W,2) and mask (B,T,H,W,1) or null, any
// strides (elements; packed: the two values of a pixel adjacent and
// aligned as a pair), in TF; bx (W) and by (H) the base grid's linspaces.
template <typename TF>
struct FlowSrc {
  const TF *flow, *mask;
  const float *bx, *by;
  long long sfb, sft, smb, smt;
  int sfh, sfw, sfc, smh, smw;
  bool packed;
  struct At {
    const TF *f, *m;
    const float *bx, *by;
    int sfh, sfw, sfc, smh, smw, H, W;
    bool packed;
    __device__ __forceinline__ float base_x(int j) const { return __ldg(bx + j); }
    template <bool PACKED, bool MASK, int PPT>
    __device__ __forceinline__ void tile_(int i0, int j, float gx, float (&fx)[PPT],
                                          float (&fy)[PPT]) const {
      float2 u[PPT];
      float mk[PPT], gy[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = row_of(i0, k);
        u[k] = make_float2(0.f, 0.f);
        mk[k] = gy[k] = 0.f;
        if (i < H && j < W) {
          const TF *p = f + i * sfh + j * sfw;
          u[k] = PACKED ? ldf2(p) : make_float2(ldf(p), ldf(p + sfc));
          if (MASK) mk[k] = ldf(m + i * smh + j * smw);
          gy[k] = __ldg(by + i);
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (MASK) {  // flow * mask, rounded to the flow's type
          u[k].x = round_as(f, __fmul_rn(u[k].x, mk[k]));
          u[k].y = round_as(f, __fmul_rn(u[k].y, mk[k]));
        }
        fx[k] = pix(__fsub_rn(gx, u[k].x), W);
        fy[k] = pix(__fsub_rn(gy[k], u[k].y), H);
      }
    }
    // gx: base_x(j)
    template <int PPT>
    __device__ __forceinline__ void tile(int i0, int j, float gx, float (&fx)[PPT],
                                         float (&fy)[PPT]) const {
      if (packed) {
        if (m) tile_<true, true>(i0, j, gx, fx, fy);
        else tile_<true, false>(i0, j, gx, fx, fy);
      } else {
        if (m) tile_<false, true>(i0, j, gx, fx, fy);
        else tile_<false, false>(i0, j, gx, fx, fy);
      }
    }
  };
  __device__ __forceinline__ At bind(int b, int t, int H, int W) const {
    return {flow + b * sfb + t * sft, mask ? mask + b * smb + t * smt : nullptr,
            bx, by, sfh, sfw, sfc, smh, smw, H, W, packed};
  }
};

// whether integer coordinate v (a float) counts along an axis of n pixels
// for the output pixel at p: inside the image and, for R >= 0, within
// [p - R, p + R + 1]
__device__ __forceinline__ bool counts(float v, int n, int p, int R) {
  return v >= 0.f && v <= (float)(n - 1) &&
         (R < 0 || (v - (float)p >= (float)-R && v - (float)p <= (float)(R + 1)));
}

// The C bf16 channels of pixels x0 and x0 + 1 of one row (2 * C * 2 <= 16
// bytes from p, the address of x0's first byte) come in the one or two
// aligned 16-byte chunks that hold a byte of an ok pixel (p may lie outside
// the tensor when x0 is not ok): pair_issue loads them, pair_take shifts
// the bytes into place, 0 where not ok.
struct Pair {
  uint4 c0, c1;
  int s;
};

template <int C>
__device__ __forceinline__ Pair pair_issue(const unsigned char *p, bool ok0, bool ok1) {
  constexpr int PB = 2 * C;
  static_assert(2 * PB <= 16, "a pair load takes two pixels of at most 8 bytes");
  Pair L{make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u),
         (int)(reinterpret_cast<uintptr_t>(p) & 15)};
  const uint4 *a = reinterpret_cast<const uint4 *>(p - L.s);
  const int lo = ok0 ? 0 : PB, hi = ok1 ? 2 * PB : PB;
  if ((ok0 || ok1) && L.s + lo < 16) L.c0 = __ldg(a);
  if ((ok0 || ok1) && L.s + hi > 16) L.c1 = __ldg(a + 1);
  return L;
}

template <int C>
__device__ __forceinline__ void pair_take(const Pair &L, bool ok0, bool ok1, float (&v0)[C],
                                          float (&v1)[C]) {
  const uint32_t w[8] = {L.c0.x, L.c0.y, L.c0.z, L.c0.w, L.c1.x, L.c1.y, L.c1.z, L.c1.w};
  const int q = L.s >> 2;
  uint32_t r[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    r[k] = q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
  if (L.s & 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = __funnelshift_r(r[k], r[k + 1], 16);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {  // element e of r[0..3]: half e & 1 of word e >> 1
    const int e0 = c, e1 = C + c;
    v0[c] = ok0 ? __uint_as_float(e0 & 1 ? r[e0 >> 1] & 0xffff0000u : r[e0 >> 1] << 16) : 0.f;
    v1[c] = ok1 ? __uint_as_float(e1 & 1 ? r[e1 >> 1] & 0xffff0000u : r[e1 >> 1] << 16) : 0.f;
  }
}

__device__ __forceinline__ float blend(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

// The staged tile's rows to oimg as 16-byte chunks (elementwise where a
// row is not 16-byte aligned), once the block's samples are in.
template <typename TX, int TH>
__device__ __forceinline__ void store_tile(const unsigned char *tile, unsigned char *oimg, int i0,
                                           int j0, int H, int W, int nc) {
  const int PB = nc * (int)sizeof(TX), tid = threadIdx.x;
  __syncthreads();
  const int nr = min(TH, H - i0), tw = min(TW, W - j0), nb = tw * PB;
  unsigned char *dst = oimg + (i0 * W + j0) * PB;
  if (((reinterpret_cast<uintptr_t>(dst) | (uintptr_t)(W * PB) | (uintptr_t)nb) & 15) == 0) {
    const int cpr = nb >> 4;
    for (int k = tid; k < nr * cpr; k += THREADS) {
      const int r = k / cpr, q = k - r * cpr;
      *reinterpret_cast<uint4 *>(dst + r * W * PB + 16 * q) =
          *reinterpret_cast<const uint4 *>(tile + r * TW * PB + 16 * q);
    }
  } else {
    const int epr = tw * nc;
    for (int k = tid; k < nr * epr; k += THREADS) {
      const int r = k / epr, e = k - r * epr;
      reinterpret_cast<TX *>(dst + r * W * PB)[e] =
          reinterpret_cast<const TX *>(tile + r * TW * PB)[e];
    }
  }
}

// A block a (tile, step).  C > 0: C bf16 channels by pair loads, the
// outputs staged in shared memory; C == 0: g.C channels of TX one at a
// time, stored directly.
template <typename TX, int C, int TH, typename Src>
__global__ void __launch_bounds__(THREADS, 3) warp_kernel(const Src src, const Geo g) {
  constexpr int PPT = TH / RPP;
  extern __shared__ __align__(16) unsigned char tile[];
  const int nc = C > 0 ? C : g.C, PB = nc * (int)sizeof(TX);
  const int H = g.H, W = g.W, R = g.R;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH;
  const int b = (int)blockIdx.z / g.T, t = (int)blockIdx.z - b * g.T;
  const int jl = (int)threadIdx.x % TW, j = j0 + jl;
  const unsigned char *ximg = g.x + b * g.sxb;
  unsigned char *oimg = g.out + ((long long)b * g.T + t) * H * W * PB;
  const auto coords = src.bind(b, t, H, W);
  float fx[PPT], fy[PPT];
  coords.tile(i0, j, j < W ? coords.base_x(j) : 0.f, fx, fy);
  auto at = [&](int y, int x) { return ximg + (y * W + x) * PB; };
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int il = (int)threadIdx.x / TW + k * RPP, i = i0 + il;
    if (i >= H || j >= W) continue;
    const float x0 = floorf(fx[k]), y0 = floorf(fy[k]);
    const float tx = __fsub_rn(fx[k], x0), ty = __fsub_rn(fy[k], y0);
    const bool ox0 = counts(x0, W, j, R), ox1 = counts(x0 + 1.f, W, j, R);
    const bool oy0 = counts(y0, H, i, R), oy1 = counts(y0 + 1.f, H, i, R);
    // ints only where a corner counts (then they are in range)
    const int xi = ox0 || ox1 ? (int)x0 : 0;
    const int y0i = oy0 ? (int)y0 : 0, y1i = oy1 ? (int)y0 + 1 : 0;
    if constexpr (C > 0) {
      const Pair top = pair_issue<C>(at(y0i, xi), ox0 && oy0, ox1 && oy0);
      const Pair bot = pair_issue<C>(at(y1i, xi), ox0 && oy1, ox1 && oy1);
      float a0[C], a1[C], b0[C], b1[C];
      pair_take<C>(top, ox0 && oy0, ox1 && oy0, a0, a1);
      pair_take<C>(bot, ox0 && oy1, ox1 && oy1, b0, b1);
      TX *out = reinterpret_cast<TX *>(tile + (il * TW + jl) * PB);
#pragma unroll
      for (int c = 0; c < C; ++c)
        st_elem(out + c, blend(blend(a0[c], a1[c], tx), blend(b0[c], b1[c], tx), ty));
    } else {
      const TX *p0 = reinterpret_cast<const TX *>(at(y0i, xi));
      const TX *p1 = reinterpret_cast<const TX *>(at(y1i, xi));
      TX *out = reinterpret_cast<TX *>(oimg + (i * W + j) * PB);
      for (int c = 0; c < nc; ++c) {
        const float v00 = oy0 && ox0 ? ldf(p0 + c) : 0.f;
        const float v01 = oy0 && ox1 ? ldf(p0 + nc + c) : 0.f;
        const float v10 = oy1 && ox0 ? ldf(p1 + c) : 0.f;
        const float v11 = oy1 && ox1 ? ldf(p1 + nc + c) : 0.f;
        st_elem(out + c, blend(blend(v00, v01, tx), blend(v10, v11, tx), ty));
      }
    }
  }
  if constexpr (C > 0) store_tile<TX, TH>(tile, oimg, i0, j0, H, W, C);
}

template <typename TX, int C, int TH, typename Src>
int launch(const Src &src, const Geo &g, cudaStream_t s) {
  const size_t smem = C > 0 ? (size_t)TH * TW * C * sizeof(TX) : 0;
  const dim3 grid((g.W + TW - 1) / TW, (g.H + TH - 1) / TH, g.B * g.T);
  warp_kernel<TX, C, TH, Src><<<grid, THREADS, smem, s>>>(src, g);
  return (int)cudaGetLastError();
}

// 16-row tiles, or 8 where 16-row ones would give under 4 blocks an SM of
// the H100's 132
template <typename TX, int C, typename Src>
int launch_rows(const Src &src, const Geo &g, cudaStream_t s) {
  const long long blocks16 = (long long)((g.W + TW - 1) / TW) * ((g.H + 15) / 16) * g.B * g.T;
  return blocks16 < 4 * 132 ? launch<TX, C, 8>(src, g, s) : launch<TX, C, 16>(src, g, s);
}

// C = 3 bf16 on pair loads, the rest channel by channel
template <typename TX, typename Src>
int dispatch(const Src &src, const Geo &g, cudaStream_t s) {
  if constexpr (sizeof(TX) == 2) {
    if (g.C == 3) return launch_rows<TX, 3>(src, g, s);
  }
  return launch_rows<TX, 0>(src, g, s);
}

// ---- the flow entry's backward (row 18c) ----------------------------------
// The adjoint of warp_steps(x, flow, mask) in the unbounded mode with
// respect to flow and mask (x is data on every path that trains through
// it: the VideoVAE warps frame1 and the ground-truth frames).  Gather form:
// one thread an output pixel (b, t, i, j) forms the forward's coordinates
// with the same arithmetic, reads its own four corners of x and its dout
// row, and sums over C in f32:
//   d(fx) = sum_c dout_c * ((1 - ty) * (v01 - v00) + ty * (v11 - v10))
//   d(fy) = sum_c dout_c * ((1 - tx) * (v10 - v00) + tx * (v11 - v01))
// corners outside the image counting as 0, as in the forward.  fx = ((bx -
// f.x) + 1) * 0.5 * (W - 1), so d(f.x) = -d(fx) * (W - 1) * 0.5 (f.y alike),
// and through f = flow * mask: dflow = d(f) * mask, dmask = d(f) . flow.
// Each pixel writes only its own dflow and dmask: deterministic, no atomics.
// It replaces no TPU kernel: grid_sample_pallas has no backward, and the JAX
// package trains the VAE through XLA's differentiable grid_sample
// (ops/warp.py:116-142 there, use_pallas=None).
// Bound: bytes (x, flow, mask and dout read once, dflow and dmask written
// once; ~5.5 MB at the VAE's 8x128x128, T = 2, bf16: ~1.6 us at 3.35 TB/s),
// so at the VAE's shapes the launch itself dominates.  A block is a 64 x 4
// tile of one image and step: a warp on 32 neighbouring columns (coalesced
// flow, mask, dout and gradient traffic; the corner reads hit L1 / L2).
struct BwdGeo {
  const unsigned char *x;  // (B,H,W,C), (H,W,C) contiguous
  long long sxb;           // bytes between frames
  const unsigned char *dout;  // (B,T,H,W,C) contiguous, x's type
  unsigned char *dflow;       // (B,T,H,W,2) contiguous, the flow's type
  unsigned char *dmask;       // (B,T,H,W) contiguous, the flow's type, or null
  int B, T, H, W, C;
};

constexpr int BTW = 64, BTH = THREADS / BTW;

template <typename TX, typename TF>
__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(const FlowSrc<TF> src, const BwdGeo g) {
  const int H = g.H, W = g.W, C = g.C;
  const int j = blockIdx.x * BTW + (int)threadIdx.x % BTW;
  const int i = blockIdx.y * BTH + (int)threadIdx.x / BTW;
  const int b = (int)blockIdx.z / g.T, t = (int)blockIdx.z - b * g.T;
  if (i >= H || j >= W) return;
  const TF *f = src.flow + b * src.sfb + t * src.sft + i * src.sfh + j * src.sfw;
  const float ux = ldf(f), uy = ldf(f + src.sfc);
  float mk = 1.f, fxv = ux, fyv = uy;
  if (src.mask) {  // flow * mask, rounded to the flow's type, as the forward
    mk = ldf(src.mask + b * src.smb + t * src.smt + i * src.smh + j * src.smw);
    fxv = round_as(f, __fmul_rn(ux, mk));
    fyv = round_as(f, __fmul_rn(uy, mk));
  }
  const float px = pix(__fsub_rn(__ldg(src.bx + j), fxv), W);
  const float py = pix(__fsub_rn(__ldg(src.by + i), fyv), H);
  const float x0 = floorf(px), y0 = floorf(py);
  const float tx = __fsub_rn(px, x0), ty = __fsub_rn(py, y0);
  const bool ox0 = counts(x0, W, j, -1), ox1 = counts(x0 + 1.f, W, j, -1);
  const bool oy0 = counts(y0, H, i, -1), oy1 = counts(y0 + 1.f, H, i, -1);
  const int xi = ox0 || ox1 ? (int)x0 : 0;
  const int y0i = oy0 ? (int)y0 : 0, y1i = oy1 ? (int)y0 + 1 : 0;
  const long long PB = (long long)C * sizeof(TX);
  const unsigned char *ximg = g.x + b * g.sxb;
  const TX *p0 = reinterpret_cast<const TX *>(ximg + (y0i * W + xi) * PB);
  const TX *p1 = reinterpret_cast<const TX *>(ximg + (y1i * W + xi) * PB);
  const long long pix_id = (((long long)b * g.T + t) * H + i) * W + j;
  const TX *d = reinterpret_cast<const TX *>(g.dout) + pix_id * C;
  float sx = 0.f, sy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v00 = oy0 && ox0 ? ldf(p0 + c) : 0.f;
    const float v01 = oy0 && ox1 ? ldf(p0 + C + c) : 0.f;
    const float v10 = oy1 && ox0 ? ldf(p1 + c) : 0.f;
    const float v11 = oy1 && ox1 ? ldf(p1 + C + c) : 0.f;
    const float dc = ldf(d + c);
    sx += dc * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
    sy += dc * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
  }
  // d(loss)/d(f): through the pixel scale and g = base - f
  const float gfx = -(sx * (float)(W - 1) * 0.5f), gfy = -(sy * (float)(H - 1) * 0.5f);
  TF *df = reinterpret_cast<TF *>(g.dflow) + pix_id * 2;
  st_elem(df, gfx * mk);
  st_elem(df + 1, gfy * mk);
  if (g.dmask) st_elem(reinterpret_cast<TF *>(g.dmask) + pix_id, gfx * ux + gfy * uy);
}

template <typename TX, typename TF>
int launch_bwd(const FlowSrc<TF> &src, const BwdGeo &g, cudaStream_t s) {
  const dim3 grid((g.W + BTW - 1) / BTW, (g.H + BTH - 1) / BTH, g.B * g.T);
  warp_bwd_kernel<TX, TF><<<grid, THREADS, 0, s>>>(src, g);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// x, out (B,H,W,C) contiguous, bf16 (is_bf16 != 0) or f32, grid (B,H,W,2)
// f32; max_disp < 0: unbounded (checked by the Python wrapper).
extern "C" int dvie_grid_sample(const void *x, const void *grid, void *out, int B, int H, int W,
                                int C, int max_disp, int is_bf16, void *stream) {
  const int es = is_bf16 ? 2 : 4;
  const dvie::Geo g{(const unsigned char *)x, (long long)H * W * C * es, (unsigned char *)out,
                    B, 1, H, W, C, max_disp};
  const dvie::GridSrc src{(const float2 *)grid};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dvie::dispatch<dvie::bf16>(src, g, s) : dvie::dispatch<float>(src, g, s);
}

// x (B,H,W,C), (H,W,C) contiguous, frames sxb elements apart; flow
// (B,T,H,W,2) and mask (B,T,H,W,1) or NULL, in bf16 (flow_bf16 != 0) or
// f32, strides in elements; bx (W), by (H) f32; out (B,T,H,W,C)
// contiguous in x's type; max_disp < 0: unbounded.
extern "C" int dvie_warp_steps(const void *x, const void *flow, const void *mask, const void *bx,
                               const void *by, void *out, int B, int T, int H, int W, int C,
                               int max_disp, int x_bf16, int flow_bf16, long long sxb,
                               long long sfb, long long sft, int sfh, int sfw, int sfc,
                               long long smb, long long smt, int smh, int smw, void *stream) {
  using dvie::bf16;
  const int es = x_bf16 ? 2 : 4;
  const dvie::Geo g{(const unsigned char *)x, sxb * es, (unsigned char *)out, B, T, H, W, C,
                    max_disp};
  cudaStream_t s = (cudaStream_t)stream;
  // the two values of every pixel adjacent and aligned as a pair
  const int fs = flow_bf16 ? 2 : 4;
  const bool packed = sfc == 1 && ((sfb | sft | sfh | sfw) & 1) == 0 &&
                      (reinterpret_cast<uintptr_t>(flow) & (2 * fs - 1)) == 0;
  if (flow_bf16) {
    const dvie::FlowSrc<bf16> src{(const bf16 *)flow, (const bf16 *)mask, (const float *)bx,
                                  (const float *)by, sfb, sft, smb, smt, sfh, sfw, sfc, smh, smw,
                                  packed};
    return x_bf16 ? dvie::dispatch<bf16>(src, g, s) : dvie::dispatch<float>(src, g, s);
  }
  const dvie::FlowSrc<float> src{(const float *)flow, (const float *)mask, (const float *)bx,
                                 (const float *)by, sfb, sft, smb, smt, sfh, sfw, sfc, smh, smw,
                                 packed};
  return x_bf16 ? dvie::dispatch<bf16>(src, g, s) : dvie::dispatch<float>(src, g, s);
}

// The backward of dvie_warp_steps in the unbounded mode (row 18c): x, flow,
// mask (or NULL), bx, by and strides as dvie_warp_steps; dout (B,T,H,W,C)
// contiguous in x's type; dflow (B,T,H,W,2) and dmask (B,T,H,W) or NULL
// (exactly when mask is NULL) contiguous in the flow's type.
extern "C" int dvie_warp_steps_bwd(const void *x, const void *flow, const void *mask,
                                   const void *bx, const void *by, const void *dout, void *dflow,
                                   void *dmask, int B, int T, int H, int W, int C, int x_bf16,
                                   int flow_bf16, long long sxb, long long sfb, long long sft,
                                   int sfh, int sfw, int sfc, long long smb, long long smt,
                                   int smh, int smw, void *stream) {
  using dvie::bf16;
  const int es = x_bf16 ? 2 : 4;
  const dvie::BwdGeo g{(const unsigned char *)x, sxb * es, (const unsigned char *)dout,
                       (unsigned char *)dflow, (unsigned char *)dmask, B, T, H, W, C};
  cudaStream_t s = (cudaStream_t)stream;
  if (flow_bf16) {
    const dvie::FlowSrc<bf16> src{(const bf16 *)flow, (const bf16 *)mask, (const float *)bx,
                                  (const float *)by, sfb, sft, smb, smt, sfh, sfw, sfc, smh, smw,
                                  false};
    return x_bf16 ? dvie::launch_bwd<bf16>(src, g, s) : dvie::launch_bwd<float>(src, g, s);
  }
  const dvie::FlowSrc<float> src{(const float *)flow, (const float *)mask, (const float *)bx,
                                 (const float *)by, sfb, sft, smb, smt, sfh, sfw, sfc, smh, smw,
                                 false};
  return x_bf16 ? dvie::launch_bwd<bf16>(src, g, s) : dvie::launch_bwd<float>(src, g, s);
}
