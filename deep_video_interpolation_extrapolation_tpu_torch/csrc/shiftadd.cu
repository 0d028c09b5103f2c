// The 9-way shifted add + bias that finishes the HRNet heads, bf16 NHWC:
//   out[b,y,x,c] = bf16(b2[c] + sum_{ky,kx} yt[b, y+ky-1, x+kx-1, (3ky+kx)*co + c])
// with yt zero outside the image (the 3x3 conv's SAME padding), the taps
// summed in f32 in the order t = 0..8 and rounded once.
//
// Replaces ops/pallas_shiftadd.py:shifted_add_bias (pallas_call at :111),
// the tail of the taps-in-N heads (the taps come from K4, the 4-part head
// or the dual head).  The TPU kernel extracts tap t from the 207-lane rows
// by a lane roll of co*t and resolves the +-1-row halo by a one-tile delay.
//
// Bound on the H100 at the serving shape (B=1, 512x1024, co = 23): yt
// 217.1 MB read once, out 24.1 MB written, 72 us of HBM time at 3.35 TB/s;
// 9 f32 adds per output element, 0.22 GFLOP, nothing next to the bytes.
// Every element of yt feeds exactly one output element (tap (ky, kx) of
// row r goes to row r - ky + 1), so the pass needs no reuse, only
// coalesced reads at the bytes bound.
//
// Design, a streaming pass: a block owns a strip of SA_TW output columns
// and walks down SA_RB rows of it.  Each yt row segment it needs (the
// strip and a 1-pixel halo, (SA_TW + 2) x 207 bf16, one contiguous run in
// NHWC) lands in a ring of SA_RING rows in shared memory by 16-byte
// cp.async copies from the 16-byte boundary at or below its start,
// SA_RING - 2 rows ahead of the row being formed.  An output row is formed
// from three ring rows (taps outside the image are skipped, as zeros);
// each thread keeps the same SA_EPT elements of the strip on every row, so
// their tap offsets are computed once.  The row is staged in shared memory
// and leaves as 16-byte stores (element stores only for the two partial
// chunks at the segment's ends).  co is a template parameter: 23, the
// width of every head but one (rgb 3 + seg 20), and 24, ExtraInpaintNet's
// with --inpaint_mask (rgb 3 + mask 1 + seg 20; dvie_shifted_add_bias_co24);
// the Python wrapper refuses others on the card.  The 23 instance is the
// code it was.
#include "common.cuh"

namespace dvie {
namespace {

constexpr int SA_THREADS = 256;
constexpr int SA_TW = 32;           // output columns of a strip
constexpr int SA_RB = 16;           // output rows a block walks down
constexpr int SA_RING = 5;          // yt rows in shared memory: 3 in use, 2 landing

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

// The sizes of the instance of SA_CO output channels: taps channels,
// elements a thread, bf16 elements of a ring row (the segment and up to 7
// of alignment) and of the output row, the dynamic shared memory (co 23:
// 70.3 KB, co 24: 73.3 KB)
template <int SA_CO>
struct SaLay {
  static constexpr int N = 9 * SA_CO;
  static constexpr int EPT = (SA_TW * SA_CO + SA_THREADS - 1) / SA_THREADS;
  static constexpr int SLOT = round8((SA_TW + 2) * N + 7);
  static constexpr int OUT = round8(SA_TW * SA_CO + 7);
  static constexpr int SMEM = (SA_RING * SLOT + OUT) * 2;
  static_assert(SA_CO == 23 || SA_CO == 24, "the heads' widths");
};

template <int SA_CO>
__global__ void __launch_bounds__(SA_THREADS)
    shifted_add_bias_kernel(const bf16 *__restrict__ yt, const float *__restrict__ b2,
                            bf16 *__restrict__ out, int H, int W) {
  constexpr int SA_N = SaLay<SA_CO>::N, SA_EPT = SaLay<SA_CO>::EPT;
  constexpr int SA_SLOT = SaLay<SA_CO>::SLOT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *ring = reinterpret_cast<bf16 *>(smem);
  bf16 *ob = ring + SA_RING * SA_SLOT;  // the output row segment, 16-byte aligned start

  const int x0 = blockIdx.x * SA_TW, b = blockIdx.z;
  const int y_lo = blockIdx.y * SA_RB, y_hi = min(y_lo + SA_RB, H);
  const int xs = max(x0 - 1, 0), xe = min(x0 + SA_TW + 1, W);  // staged columns
  const int ne = min(SA_TW, W - x0) * SA_CO;                     // output elements of a row
  const long total = (long)gridDim.z * H * W * SA_N;             // yt elements

  // the first element of yt row r's segment, and the ring slot of row r
  auto seg = [&](int r) { return (((long)b * H + r) * W + xs) * SA_N; };
  auto slot_of = [&](int r) { return ring + ((r + 1) % SA_RING) * SA_SLOT; };

  // stage yt row r (nothing for a row outside the image), one group each
  auto stage = [&](int r) {
    if (r >= 0 && r < H && r <= y_hi) {
      const long s0 = seg(r), a = s0 & ~7L, s1 = s0 + (long)(xe - xs) * SA_N;
      bf16 *dst = slot_of(r);
      const int chunks = (int)((s1 - a + 7) / 8);
      for (int i = threadIdx.x; i < chunks; i += SA_THREADS) {
        const long e = a + 8L * i, left = total - e;
        cp_async_bytes16(dst + 8 * i, yt + e, left >= 8 ? 16 : (int)(2 * left));
      }
    }
    cp_async_commit();
  };

  for (int r = y_lo - 1; r < y_lo - 1 + SA_RING; ++r) stage(r);

  // this thread's elements e = threadIdx.x + i * SA_THREADS = (px, c): the
  // offset of tap (1, kx = 0) in a staged row, the taps kx inside the
  // image (bit kx), the bias
  int off[SA_EPT], xok[SA_EPT];
  float bias[SA_EPT];
#pragma unroll
  for (int i = 0; i < SA_EPT; ++i) {
    const int e = threadIdx.x + i * SA_THREADS, px = e / SA_CO, c = e % SA_CO, x = x0 + px;
    off[i] = (x - 1 - xs) * SA_N + c;
    xok[i] = e < ne ? (x > 0) | 2 | (x + 1 < W ? 4 : 0) : 0;
    bias[i] = e < ne ? b2[c] : 0.f;
  }

  for (int y = y_lo; y < y_hi; ++y) {
    cp_async_wait<SA_RING - 3>();  // rows y - 1 .. y + 1 have landed
    __syncthreads();
    const bf16 *rows[3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = y + ky - 1;
      rows[ky] = yy >= 0 && yy < H ? slot_of(yy) + (int)(seg(yy) & 7) : nullptr;
    }
    const long o0 = (((long)b * H + y) * W + x0) * SA_CO, oa = o0 & ~7L;
#pragma unroll
    for (int i = 0; i < SA_EPT; ++i) {
      if (!xok[i]) continue;
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        if (rows[ky] == nullptr) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          if (xok[i] >> kx & 1) acc += bf(rows[ky][off[i] + kx * SA_N + (3 * ky + kx) * SA_CO]);
      }
      ob[(int)(o0 - oa) + threadIdx.x + i * SA_THREADS] = __float2bfloat16(acc + bias[i]);
    }
    __syncthreads();
    stage(y + SA_RING - 1);  // into the slot of row y - 1, now read
    // store: whole 16-byte chunks of [o0, o0 + ne) as one, the two partial
    // ends element by element (the neighbouring strips own the rest)
    const long o1 = o0 + ne;
    const int chunks = (int)((o1 - oa + 7) / 8);
    for (int i = threadIdx.x; i < chunks; i += SA_THREADS) {
      const long e = oa + 8L * i;
      if (e >= o0 && e + 8 <= o1) {
        st16(out + e, *reinterpret_cast<const uint4 *>(ob + 8 * i));
      } else {
        for (int j = 0; j < 8; ++j)
          if (e + j >= o0 && e + j < o1) out[e + j] = ob[8 * i + j];
      }
    }
  }
  cp_async_wait<0>();
}

template <int CO>
int launch(const void *yt, const void *b2, void *out, int B, int H, int W, void *stream) {
  constexpr int SMEM = SaLay<CO>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(shifted_add_bias_kernel<CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((W + SA_TW - 1) / SA_TW), (unsigned)((H + SA_RB - 1) / SA_RB),
            (unsigned)B);
  shifted_add_bias_kernel<CO><<<grid, SA_THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16 *)yt, (const float *)b2, (bf16 *)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dvie

// yt (B,H,W,207) bf16, b2 (23,) f32, out (B,H,W,23) bf16; yt and out
// 16-byte aligned (checked by the Python wrapper).
extern "C" int dvie_shifted_add_bias(const void *yt, const void *b2, void *out, int B, int H,
                                     int W, void *stream) {
  return dvie::launch<23>(yt, b2, out, B, H, W, stream);
}

// The same at co = 24: yt (B,H,W,216), b2 (24,), out (B,H,W,24).
extern "C" int dvie_shifted_add_bias_co24(const void *yt, const void *b2, void *out, int B, int H,
                                          int W, void *stream) {
  return dvie::launch<24>(yt, b2, out, B, H, W, stream);
}
