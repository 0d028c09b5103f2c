// Shared pieces of the train-chain kernels (trainchain_stem.cu,
// trainchain_bottleneck.cu): 2-D pixel tiles with halo regions, and the
// split-K weight-grad kernel.
//
// 2-D tiles.  A block owns TH x TW output pixels of one image.  A 3x3 conv
// on the tile needs its input on a ring of halo pixels around it; such a
// region is staged in shared memory as positions l = ry * pw + rx (row
// pitch pw = TW + 2 * ring).  Because the output tile and its input region
// share the pitch, a run of 16 consecutive output positions reads, for tap
// (dy, dx), a run of 16 consecutive input positions at the constant offset
// dy * pw + dx: every tap's A operand is a plain strided view of the staged
// region, fed to WMMA with no im2col copy.  Positions of a run that wrap
// into the next row are computed and never used.
//
// Weight grads.  dk[t] = sum over pixels p of in(p + off_t)^T . d(p) is a
// product whose K dimension is the pixel count (393 k at the 24x128x128
// recipe).  wgrad_kernel splits that K into `splits` contiguous pixel
// ranges; each block computes one 64x64 tile of one weight over one range
// and stores it to its own slice of an f32 partials buffer, which the
// Python wrapper sums (.sum(0)).  No atomics and no buffer shared between
// blocks: the JAX kernels banned revisited accumulators after one corrupted
// an unrelated buffer (pallas_trainchain.py:26-33), and on the card atomics
// would also make the sums differ from run to run.
#pragma once

#include "common.cuh"

namespace dvie {
namespace tc {
namespace {  // each including .cu gets its own copy

using FragAcol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

constexpr int TH = 8, TW = 16;  // output tile: 8 rows x 16 columns

struct Tile {
  int b, y0, x0;
};

__host__ __device__ inline int tiles_x(int W) { return (W + TW - 1) / TW; }
__host__ __device__ inline int tiles_y(int H) { return (H + TH - 1) / TH; }
inline unsigned n_tiles(int B, int H, int W) {
  return (unsigned)(B * tiles_y(H) * tiles_x(W));
}

__device__ __forceinline__ Tile tile_of(int H, int W) {
  int id = blockIdx.x;
  Tile t;
  t.x0 = (id % tiles_x(W)) * TW;
  id /= tiles_x(W);
  t.y0 = (id % tiles_y(H)) * TH;
  t.b = id / tiles_y(H);
  return t;
}

// flat pixel index of image pixel (yy, xx) of the tile's image
__device__ __forceinline__ long pix(const Tile &t, int yy, int xx, int H, int W) {
  return ((long)t.b * H + yy) * W + xx;
}

__device__ __forceinline__ bool inside(int yy, int xx, int H, int W) {
  return yy >= 0 && yy < H && xx >= 0 && xx < W;
}

// cp.async a region of an NHWC tensor (C channels) into shared memory:
// position l (< nalloc) holds pixel (t.y0 + ry0 + l / pw, t.x0 + rx0 + l % pw),
// `vecs` 16-byte vectors from channel c0; zeros outside the image and at
// positions >= npos.
__device__ __forceinline__ void load_region(bf16 *dst, int ld, const bf16 *__restrict__ src,
                                            int C, int c0, int vecs, const Tile &t, int ry0,
                                            int rx0, int pw, int npos, int nalloc, int H,
                                            int W) {
  for (int i = threadIdx.x; i < nalloc * vecs; i += blockDim.x) {
    const int l = i / vecs, v = i % vecs;
    const int yy = t.y0 + ry0 + l / pw, xx = t.x0 + rx0 + l % pw;
    const bool ok = l < npos && inside(yy, xx, H, W);
    const bf16 *p = ok ? src + pix(t, yy, xx, H, W) * C + c0 + v * 8 : src;
    cp_async16(dst + l * ld + v * 8, p, ok);
  }
}

// ---- split-K weight grads -------------------------------------------------

struct WJob {
  const bf16 *a;  // (M, ca) bf16, or null: a column of ones (a bias grad)
  const bf16 *b;  // (M, cb) bf16
  float *out;     // partial s at out + s * split: (ca, cb) row-major f32
  long split;
  int ca, cb;     // ca % 8 == 0, cb % 64 == 0
  int dy, dx;     // a is read at pixel (y + dy, x + dx): a 3x3 tap
};

constexpr int MAX_JOBS = 20;
struct WJobs {
  WJob j[MAX_JOBS];
  int n;
};

constexpr int WT = 64, WNT = 128, WLD = 64 + 8;
constexpr int WSTAGE = 2 * WT * WLD * 2;  // one A + one B tile: 18432 bytes
constexpr int WSMEM = 2 * WSTAGE;

__host__ __device__ inline int job_tiles(const WJob &j) { return (j.ca + 63) / 64 * (j.cb / 64); }

// out[s] tile (ia, ib) = sum over the pixels of range s of
// a(p + shift)[ia*64 .. +64]^T . b(p)[ib*64 .. +64].  4 warps, each 16 rows
// (a channels) x 64 columns (b channels); 64 pixels per pipeline step,
// double-buffered with cp.async.
__global__ void __launch_bounds__(WNT) wgrad_kernel(const WJobs jobs, int M, int H, int W,
                                                    int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  int tile = blockIdx.x, ji = 0;
  while (ji + 1 < jobs.n && tile >= job_tiles(jobs.j[ji])) tile -= job_tiles(jobs.j[ji++]);
  const WJob jb = jobs.j[ji];
  const int ia = tile / (jb.cb / 64), ib = tile % (jb.cb / 64);
  const int s = blockIdx.y;
  const int p0 = s * chunk, p1 = min(M, p0 + chunk);
  const int steps = p1 > p0 ? (p1 - p0 + WT - 1) / WT : 0;
  const int warp = threadIdx.x >> 5;

  auto load = [&](int st, int buf) {
    bf16 *As = reinterpret_cast<bf16 *>(smem + buf * WSTAGE);
    bf16 *Bs = As + WT * WLD;
    const int v = threadIdx.x % 8;
    const int c = ia * 64 + v * 8;
#pragma unroll
    for (int k = 0; k < WT * 8 / WNT; ++k) {
      const int r = threadIdx.x / 8 + k * (WNT / 8);
      const int m = p0 + st * WT + r;
      const bool in = m < p1;
      cp_async16(Bs + r * WLD + v * 8, in ? jb.b + (long)m * jb.cb + ib * 64 + v * 8 : jb.b, in);
      if (jb.a) {
        bool ok = in && c < jb.ca;
        if (ok) {
          const int xx = m % W, yy = (m / W) % H;
          ok = inside(yy + jb.dy, xx + jb.dx, H, W);
        }
        const bf16 *src = ok ? jb.a + (long)(m + jb.dy * W + jb.dx) * jb.ca + c : jb.a;
        cp_async16(As + r * WLD + v * 8, src, ok);
      } else {  // bf16 1.0 = 0x3f80
        const unsigned one = in ? 0x3f803f80u : 0u;
        st16(As + r * WLD + v * 8, make_uint4(one, one, one, one));
      }
    }
  };

  FragC acc[4];
  zero(acc);
  if (steps) load(0, 0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1, (st + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16 *As = reinterpret_cast<const bf16 *>(smem + (st & 1) * WSTAGE);
    const bf16 *Bs = As + WT * WLD;
    FragAcol a;
    FragB b;
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk) {
      wmma::load_matrix_sync(a, As + warp * 16 + kk * 16 * WLD, WLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(b, Bs + kk * 16 * WLD + j * 16, WLD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // this stage is refilled two steps on
  }
  const int row = ia * 64 + warp * 16;
  if (row < jb.ca) {
    float *o = jb.out + s * jb.split + (long)row * jb.cb + ib * 64;
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(o + j * 16, acc[j], jb.cb, wmma::mem_row_major);
  }
}

// launch wgrad_kernel over every job's tiles x `splits` pixel ranges
inline int launch_wgrad(const WJobs &jobs, int M, int H, int W, int splits, cudaStream_t st) {
  int tiles = 0;
  for (int i = 0; i < jobs.n; ++i) tiles += job_tiles(jobs.j[i]);
  const int chunk = ((M + splits - 1) / splits + WT - 1) / WT * WT;
  wgrad_kernel<<<dim3((unsigned)tiles, (unsigned)splits), WNT, WSMEM, st>>>(jobs, M, H, W, chunk);
  return (int)cudaGetLastError();
}

inline WJob job(const void *a, int ca, const void *b, int cb, float *out, long split, int dy = 0,
                int dx = 0) {
  WJob j;
  j.a = (const bf16 *)a;
  j.b = (const bf16 *)b;
  j.out = out;
  j.split = split;
  j.ca = ca;
  j.cb = cb;
  j.dy = dy;
  j.dx = dx;
  return j;
}

}  // namespace
}  // namespace tc
}  // namespace dvie
