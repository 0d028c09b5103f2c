// Fused window attention of the stage-3 refiner, bf16 NHWC, C = Cv = 128.
//
// Replaces ops/pallas_corr.py fused_window_attention (pallas_call at :196),
// the attention of MSResAttnRefine at n_scales == 1 (attn_refine.py:159-177).
// For every pixel p: qn = q / max(|q|, 1e-12); for neighbour n = 0, 1, then
// wy = 0..win_h-1, then wx = 0..win_w-1, the key k at p + (wy - win_h/2,
// wx - win_w/2) (zero outside the map) gives s = qn . k / max(|k|, 1e-12);
// one softmax over all 2*win_h*win_w logits (the zero-padded offsets take
// part with s = 0, as in the reference's zero-pad unfold) weights the
// values at the same offsets, out = sum p*v / max(l, 1e-12); per neighbour
// the flow is the first offset whose s is strictly above the best so far
// (jnp.argmax's tie rule).
//
// Rounding points: qn is normalised in f32 and rounded to bf16 (the TPU
// kernel rounds the normalised keys instead, pallas_corr.py:85-86); keys
// stay raw bf16, their inverse norms are taken in f32 and scale the f32
// product per key column; P is rounded to bf16 as the A operand of P.V and
// l sums the rounded P; the P.V sum is f32, the output rounded once.
//
// Bound on the H100 at the serving shape (B=1, 128x256 at 1/4 of 512x1024,
// C = 128; on the path k1 = v1 and k2 = v2): 3 distinct bf16 inputs and the
// bf16 output, 4 x 8.39 MB, plus the f32 flow, 0.52 MB: 34.1 MB, 10.2 us of
// HBM time at 3.35 TB/s.  Work: 90 x (128 + 128) MACs per pixel, 1.51 GFLOP,
// 1.5 us at the bf16 tensor-core peak.  So it is bound by bytes.
//
// Design, flash-attention shaped with a band: a block owns a 4 x 16 query
// tile, one warp per 16-pixel row segment.  Per neighbour it stages the
// (4 + win_h - 1) x 24 key slab that covers its windows with cp.async
// (zero-filled outside the map; pixels 272 bytes apart, so ldmatrix reads
// 8 pixels from 8 bank groups).  For each window row wy a warp's queries
// see one 24-pixel slab row: the logits are a 16 x 24 tensor-core product
// (mma.sync m16n8k16, qn from registers, keys by ldmatrix), of which each
// query keeps the win_w columns of its band (9 of 24 at 5x9).  The online
// softmax and the argmax run on the accumulator registers (row max and sum
// over the 4 lanes of a row), and P.V is a 16 x 24 x 128 product (k16 +
// k8) with P from registers and V by ldmatrix.trans.  When k is v (the
// path) one slab per neighbour serves both products, and the second
// neighbour's slab is in flight while the first computes (two blocks an SM
// at 5x9); else k and v are staged apart (one block an SM).  The output
// leaves through shared memory as 16-byte stores.
#include "common.cuh"
#include "hopper.cuh"

namespace dvie {
namespace {

constexpr int WA_C = 128;       // channels of q, k and v
constexpr int WA_TX = 16;       // queries of a warp: one row segment
constexpr int WA_TY = 4;        // warps of a block: rows of the query tile
constexpr int WA_COLS = 24;     // slab columns: WA_TX + win_w - 1 <= 24
constexpr int WA_PITCH = 136;   // bf16 per slab pixel: 128 + 8 of padding
constexpr float WA_EPS = 1e-12f;
constexpr float WA_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&u));
}

// Slab s of a block: npix pixels of WA_PITCH bf16.  KV_SAME: slab n holds
// neighbour n's keys and values; else slab 2n its keys, 2n + 1 its values.
template <bool KV_SAME>
__global__ void __launch_bounds__(WA_TY * 32)
    window_attn_kernel(const bf16 *__restrict__ q, const bf16 *__restrict__ k1,
                       const bf16 *__restrict__ k2, const bf16 *__restrict__ v1,
                       const bf16 *__restrict__ v2, bf16 *__restrict__ out,
                       float *__restrict__ flow, int H, int W, int win_h, int win_w) {
  constexpr int NSLAB = KV_SAME ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int npix = (WA_TY + win_h - 1) * WA_COLS;
  bf16 *slabs = reinterpret_cast<bf16 *>(smem);
  float *kinv = reinterpret_cast<float *>(slabs + NSLAB * npix * WA_PITCH);  // [2][npix]

  const int x0 = blockIdx.x * WA_TX, y0 = blockIdx.y * WA_TY, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ph = win_h / 2, pw = win_w / 2;

  // both neighbours' slabs in flight at once: neighbour n is group n
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const bf16 *kp = n ? k2 : k1, *vp = n ? v2 : v1;
    bf16 *ks = slabs + (KV_SAME ? n : 2 * n) * npix * WA_PITCH;
    bf16 *vs = slabs + (2 * n + 1) * npix * WA_PITCH;
    for (int i = threadIdx.x; i < npix * (WA_C / 8); i += blockDim.x) {
      const int chunk = i % (WA_C / 8), pix = i / (WA_C / 8);
      const int gy = y0 + pix / WA_COLS - ph, gx = x0 + pix % WA_COLS - pw;
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long src = valid ? (((long)b * H + gy) * W + gx) * WA_C + chunk * 8 : 0;
      cp_async16(ks + pix * WA_PITCH + chunk * 8, kp + src, valid);
      if (!KV_SAME) cp_async16(vs + pix * WA_PITCH + chunk * 8, vp + src, valid);
    }
    cp_async_commit();
  }

  // qn as the A fragments of the logits product: qa[kk] holds rows g and
  // g + 8 (pixels x0 + g, x0 + g + 8 of row y), channels 16 kk + 2t (+1)
  // and 16 kk + 8 + 2t (+1); a row's norm sums over the 4 lanes t
  const int y = y0 + warp;
  bool live[2];
  uint32_t qa[8][4];
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int x = x0 + g + 8 * r;
    live[r] = y < H && x < W;
    const bf16 *qp = q + (((long)b * H + (live[r] ? y : 0)) * W + (live[r] ? x : 0)) * WA_C + 2 * t;
    float ss = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u =
            live[r] ? __ldg(reinterpret_cast<const unsigned int *>(qp + 16 * kk + 8 * h)) : 0u;
        qa[kk][r + 2 * h] = u;
        const float2 f = unpack2(u);
        ss += f.x * f.x + f.y * f.y;
      }
    inv[r] = 1.f / fmaxf(sqrtf(quad_sum(ss)), WA_EPS);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2(qa[kk][i]);
      qa[kk][i] = hop::pack_bf2(f.x * inv[i % 2], f.y * inv[i % 2]);
    }

  // online-softmax state of rows g, g + 8: acc[nt] columns 8 nt + 2t (+1)
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, fl[2][4];

  for (int n = 0; n < 2; ++n) {
    if (n == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const bf16 *ks = slabs + (KV_SAME ? n : 2 * n) * npix * WA_PITCH;
    const bf16 *vs = KV_SAME ? ks : slabs + (2 * n + 1) * npix * WA_PITCH;
    float *kv = kinv + n * npix;
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < WA_C / 8; ++c) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4 *>(ks + p * WA_PITCH + 8 * c), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
      }
      kv[p] = 1.f / fmaxf(sqrtf(ss), WA_EPS);
    }
    __syncthreads();

    float best[2] = {-INFINITY, -INFINITY};
    int bidx[2] = {0x7fffffff, 0x7fffffff};
    const uint32_t ks_u = hop::smem_u32(ks), vs_u = hop::smem_u32(vs);
    for (int wy = 0; wy < win_h; ++wy) {
      const int prow = (warp + wy) * WA_COLS;  // slab pixel of column 0
      // logits: s[nt] = qn . k over slab columns 8 nt .. 8 nt + 7
      float s[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const int pix = prow + nt * 8 + lane % 8;
#pragma unroll
        for (int kk = 0; kk < 8; kk += 2) {
          uint32_t kb[4];
          hop::ldsm4(kb, ks_u + 2 * (pix * WA_PITCH + (kk + lane / 16) * 16 + (lane / 8) % 2 * 8));
          mma_k16(s[nt], qa[kk], kb[0], kb[1]);
          mma_k16(s[nt], qa[kk + 1], kb[2], kb[3]);
        }
      }
      // the band: row r keeps columns j with 0 <= j - r < win_w
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, j = nt * 8 + 2 * t + e % 2, wx = j - g - 8 * r;
          if (wx >= 0 && wx < win_w) {
            const float v = s[nt][e] * kv[prow + j];
            s[nt][e] = v;
            mx[r] = fmaxf(mx[r], v);
            if (v > best[r]) {
              best[r] = v;
              bidx[r] = wy * win_w + wx;
            }
          } else {
            s[nt][e] = -INFINITY;
          }
        }
      float scale[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        scale[r] = exp2f((m[r] - m_new) * WA_LOG2E);
        m[r] = m_new;
        l[r] *= scale[r];
      }
      // P in bf16: pa[nt][r] packs row r's two columns of tile nt
      uint32_t pa[3][2];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[nt][r] = hop::pack_bf2(exp2f((s[nt][2 * r] - m[r]) * WA_LOG2E),
                                    exp2f((s[nt][2 * r + 1] - m[r]) * WA_LOG2E));
          const float2 p = unpack2(pa[nt][r]);
          l[r] += p.x + p.y;
        }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        acc[nt][0] *= scale[0];
        acc[nt][1] *= scale[0];
        acc[nt][2] *= scale[1];
        acc[nt][3] *= scale[1];
      }
      // P.V: slab columns 0..15 by k16, 16..23 by k8
      const uint32_t a16[4] = {pa[0][0], pa[0][1], pa[1][0], pa[1][1]};
#pragma unroll
      for (int nt = 0; nt < 16; nt += 2) {
        uint32_t vb[4];
        hop::ldsm4t(vb, vs_u + 2 * ((prow + (lane / 8) % 2 * 8 + lane % 8) * WA_PITCH +
                                    (nt + lane / 16) * 8));
        mma_k16(acc[nt], a16, vb[0], vb[1]);
        mma_k16(acc[nt + 1], a16, vb[2], vb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 16; nt += 4) {
        uint32_t vb[4];
        hop::ldsm4t(vb, vs_u + 2 * ((prow + 16 + lane % 8) * WA_PITCH + (nt + lane / 8) * 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_k8(acc[nt + i], pa[2][0], pa[2][1], vb[i]);
      }
    }
    // this neighbour's flow: the first maximum over the row's 4 lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[r], o);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], o);
        if (ob > best[r] || (ob == best[r] && oi < bidx[r])) {
          best[r] = ob;
          bidx[r] = oi;
        }
      }
      fl[r][2 * n] = (float)(bidx[r] % win_w - pw);
      fl[r][2 * n + 1] = (float)(bidx[r] / win_w - ph);
    }
  }

  // out = acc / l through this warp's 16 x 128 tile of shared memory (the
  // slabs are free once every warp is past its last P.V)
  __syncthreads();
  bf16 *ot = slabs + warp * WA_TX * WA_PITCH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float il = 1.f / fmaxf(quad_sum(l[r]), WA_EPS);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<uint32_t *>(ot + (g + 8 * r) * WA_PITCH + nt * 8 + 2 * t) =
          hop::pack_bf2(acc[nt][2 * r] * il, acc[nt][2 * r + 1] * il);
    if (t == 0 && live[r])
      *reinterpret_cast<float4 *>(flow + (((long)b * H + y) * W + x0 + g + 8 * r) * 4) =
          make_float4(fl[r][0], fl[r][1], fl[r][2], fl[r][3]);
  }
  __syncwarp();
  if (y < H) {
    const long row = ((long)b * H + y) * W + x0;
    for (int i = lane; i < WA_TX * (WA_C / 8); i += 32) {
      const int px = i / (WA_C / 8), c = i % (WA_C / 8);
      if (x0 + px < W)
        st16(out + (row + px) * WA_C + 8 * c,
             *reinterpret_cast<const uint4 *>(ot + px * WA_PITCH + 8 * c));
    }
  }
}

template <bool KV_SAME>
int launch(const void *q, const void *k1, const void *k2, const void *v1, const void *v2, void *out,
           void *flow, int B, int H, int W, int win_h, int win_w, cudaStream_t stream) {
  const int npix = (WA_TY + win_h - 1) * WA_COLS;
  const int smem = (KV_SAME ? 2 : 4) * npix * WA_PITCH * (int)sizeof(bf16) + 2 * npix * 4;
  cudaError_t e = cudaFuncSetAttribute(window_attn_kernel<KV_SAME>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((W + WA_TX - 1) / WA_TX), (unsigned)((H + WA_TY - 1) / WA_TY), (unsigned)B);
  window_attn_kernel<KV_SAME><<<grid, WA_TY * 32, smem, stream>>>(
      (const bf16 *)q, (const bf16 *)k1, (const bf16 *)k2, (const bf16 *)v1, (const bf16 *)v2,
      (bf16 *)out, (float *)flow, H, W, win_h, win_w);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// q, k1, k2, v1, v2, out (B,H,W,128) bf16, flow (B,H,W,4) f32; odd win_h,
// odd win_w <= 9; kv_same: k1 is v1 and k2 is v2 (one slab a neighbour).
// The Python wrapper checks shapes, the window and the shared memory.
extern "C" int dvie_window_attn(const void *q, const void *k1, const void *k2, const void *v1,
                                const void *v2, void *out, void *flow, int B, int H, int W,
                                int win_h, int win_w, int kv_same, void *stream) {
  return kv_same ? dvie::launch<true>(q, k1, k2, v1, v2, out, flow, B, H, W, win_h, win_w,
                                      (cudaStream_t)stream)
                 : dvie::launch<false>(q, k1, k2, v1, v2, out, flow, B, H, W, win_h, win_w,
                                       (cudaStream_t)stream);
}
