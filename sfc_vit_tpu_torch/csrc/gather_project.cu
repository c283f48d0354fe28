// Fused curve gather + projection (kernel #14):
// out[b, i, :] = concat_p x[b, lut[i * group + p], :] . W + bias
// over x bf16 [B, N, K], lut int32 [M * group], W bf16 [group * K, D] and
// an optional bf16 bias [D] -> out bf16 [B, M, D].
//
// Replaces: sfc_vit_tpu/ops/gather_project.py::_kernel (lines 57-78).  Its
// arithmetic: the group curve-consecutive rows of each output token are
// concatenated slot-major (feature p * K + kk multiplies W[p * K + kk]),
// the product sums in fp32, the bias is added in fp32 and the sum is
// rounded once.  The TPU kernel gathers with a one-hot matmul on the MXU
// only because Mosaic rejects unaligned dynamic row indexing; here each
// element of the gathered tile is one indexed load.
//
// Bound on this card: at the family-A flagship's shapes (batch 512, D =
// 256, group * K = 48, 64 output tokens per image) the kernel does 48
// multiply-adds per output element and moves x once, the LUT and W once
// and the output once: ~1.5 flops a byte, far under the H100's ~295 on
// the bf16 tensor cores, so the bytes bound it, almost all of them the
// bf16 output.
// Design (simple first): one 256-thread block per (64-token tile, image,
// 256-column slice of D).  The block gathers its tokens' rows in 32-column
// chunks of the group * K features into a bf16 shared tile, each element
// an indexed load through the LUT (the gathered values are x's own bf16,
// so nothing is rounded), and stages W's matching 32 rows beside it with
// cp.async (element loads where D is not a multiple of 8), zero past
// group * K and past D.  Eight warps each own 32 output columns of all 64
// rows: 4 x 2 WMMA accumulators, bf16 products summed in fp32 on the
// tensor cores (in FFMA the three levels' 1.2 G multiply-adds would take
// about twice the bytes' time).  The epilogue stages each 16 x 16
// accumulator through a per-warp fp32 tile, adds the bias in fp32 and
// rounds once, a lane pair per row, 16-byte stores where D is a multiple
// of 8.  Shared memory: 32 KB.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int TM = 64;                 // output tokens a block owns
constexpr int TN = 256;                // output columns a block owns
constexpr int KC = 32;                 // features gathered per chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int WN = TN / kWarps;        // columns a warp owns
constexpr int LDA = KC + 8;            // bf16 gathered rows
constexpr int LDW = TN + 8;            // bf16 W rows
constexpr int LDS = 16 + 4;            // fp32 staging rows

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
    gather_project_kernel(const bf16* __restrict__ x, const int* __restrict__ lut,
                          const bf16* __restrict__ w, const bf16* __restrict__ bias,
                          bf16* __restrict__ out, int n, int k, int m, int group, int d) {
  __shared__ __align__(128) bf16 a_s[TM * LDA];
  __shared__ __align__(128) bf16 w_s[KC * LDW];
  __shared__ __align__(128) float st_s[kWarps][16 * LDS];
  const int t0 = blockIdx.x * TM, b = blockIdx.y, n0 = blockIdx.z * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gk = group * k;
  const bf16* xb = x + static_cast<long long>(b) * n * k;
  const bf16 zero = __float2bfloat16(0.f);

  FragC acc[TM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const bool vec = d % 8 == 0;
  for (int c0 = 0; c0 < gk; c0 += KC) {
    // Both staging loops have fixed trip counts and are unrolled, so every
    // load of a chunk is in flight at once rather than one latency each.
    // W's rows c0.. of this block's columns, zero past gk and past d.
    if (vec) {
#pragma unroll
      for (int i = 0; i < KC * TN / 8 / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads, r = e / (TN / 8), c = (e % (TN / 8)) * 8;
        const bool ok = c0 + r < gk && n0 + c < d;
        sfc::cp_async16(&w_s[r * LDW + c],
                        ok ? w + static_cast<long long>(c0 + r) * d + n0 + c : w, ok);
      }
      sfc::cp_async_commit();
    } else {
#pragma unroll 8
      for (int i = 0; i < KC * TN / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads, r = e / TN, c = e % TN;
        w_s[r * LDW + c] = c0 + r < gk && n0 + c < d
                               ? w[static_cast<long long>(c0 + r) * d + n0 + c]
                               : zero;
      }
    }
    // Element (r, c) of the chunk: feature c0 + c of token t0 + r.  The
    // loads are unconditional (a masked element reads entry 0 and is
    // zeroed after), so the LUT loads are all in flight at once, then the
    // x loads.
    constexpr int kPer = TM * KC / kThreads;
    bool ok[kPer];
    int src[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / KC, f = c0 + e % KC;
      ok[i] = t0 + r < m && f < gk;
      const int p = ok[i] ? f / k : 0, kk = ok[i] ? f - p * k : 0;
      src[i] = lut[ok[i] ? (t0 + r) * group + p : 0] * k + kk;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const bf16 val = xb[src[i]];
      a_s[(e / KC) * LDA + e % KC] = ok[i] ? val : zero;
    }
    sfc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragB bfr[WN / 16];
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(bfr[j], &w_s[(kk * 16) * LDW + warp * WN + j * 16], LDW);
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        FragA af;
        wmma::load_matrix_sync(af, &a_s[(i * 16) * LDA + kk * 16], LDA);
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], af, bfr[j], acc[i][j]);
      }
    }
    __syncthreads();  // a_s and w_s are overwritten by the next chunk
  }

  // Lane pair (2r, 2r+1) owns row r of a staged 16 x 16 tile, 8 columns each.
  float* st = st_s[warp];
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      const int row = t0 + i * 16 + r, col = n0 + warp * WN + j * 16 + c8;
      if (row < m && col < d) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = st[r * LDS + c8 + e] +
                 (bias != nullptr && col + e < d ? __bfloat162float(bias[col + e]) : 0.f);
        bf16* o = out + (static_cast<long long>(b) * m + row) * d + col;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = sfc::pack_bf16x8(v);
        } else {
          for (int e = 0; e < 8 && col + e < d; ++e) o[e] = __float2bfloat16(v[e]);
        }
      }
      __syncwarp();  // st is overwritten by the next tile
    }
  }
}

}  // namespace

// x bf16 [batch, n, k] contiguous; lut int32 [m * group], each entry in
// [0, n); w bf16 [group * k, d] contiguous; bias bf16 [d] or null; out bf16
// [batch, m, d] contiguous, 16-byte aligned.
extern "C" int sfc_gather_project_bf16(const void* x, const void* lut, const void* w,
                                       const void* bias, void* out, int batch, int n, int k,
                                       int m, int group, int d, void* stream) {
  if (n < 1 || k < 1 || m < 1 || group < 1 || d < 1 || batch < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const dim3 grid((m + TM - 1) / TM, batch, (d + TN - 1) / TN);
  gather_project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(lut), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), n, k, m, group, d);
  return static_cast<int>(cudaGetLastError());
}
