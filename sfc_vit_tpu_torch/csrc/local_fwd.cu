// Curve-local attention forward on [B, N, H, Dh] (kernel #12): each query
// attends to the keys of the curve blocks within `halo` of its own, head
// dim 64, bf16 in and out, optionally with the window's fp32 log-sum-exp.
//
// Replaces: sfc_vit_tpu/ops/local_attention.py::_kernel (lines 82-124).
// Query i sees exactly the keys j with |i / block - j / block| <= halo
// and j < N, with the single K step's arithmetic of flash attention over
// that window: fp32 logits times scale, the row's max m and sum l, then
// P = exp(s - m) / l rounded to bf16 and an fp32 P.V, rounded once.  The
// TPU kernel reads 2 * halo + 1 clamped neighbour-block views and masks
// the out-of-range ones (in_range), so no key counts twice at the
// sequence's ends; here a query tile's key range [max(0, (j - halo) *
// block), min(N, (j + halo + 1) * block)) for its curve block j is
// computed directly, the same set.  block is a multiple of 64, so a query
// tile lies in one curve block.  Keys past the range get -1e30 (never
// -inf: p = 0, no NaN); lse = m + log(l).  q, k and v are read through
// their strides (batch, row, head; unit stride along Dh), so the
// [B, N, H, Dh] views of a packed QKV projection need no copy; out is
// contiguous.
//
// Bound on this card: at block 128, halo 1 a query meets at most 384
// keys: 4 * 384 * 64 flops per row on 4 * 128 bytes of q, k, v and out,
// ~190 flops a byte, under the H100's ~295, so the bytes bound it.
// Design (simple first): one 128-thread block per (64-query tile, b * h);
// each warp owns 16 query rows, keeps its 16 x 64 Q slice in WMMA
// fragments and streams 64-key K and V tiles through shared memory
// (cp.async, zero-filled past the range).  Logits go through a per-warp
// fp32 tile in shared memory, where a lane pair owns a row for the
// softmax; two passes over the window (max and sum, then P . V into
// register fragments).  Shared memory at Dh 64:
// 53 KB (Q, K, V, P and logits), four blocks an SM.  The flash forward #8
// has its own Hopper design in flash_fwd_sm90.cu.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BQ = 64, BK = 64;
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDP = BK + 8;  // bf16 P rows: 16-byte copy slots, 32-byte fragment starts

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct Smem {
  static constexpr int LDH = DH + 8;                         // bf16 tile rows
  static constexpr int LDS = (BK > DH ? BK : DH) + 4;        // fp32 logits / staging rows
  bf16 q[BQ * LDH];
  bf16 k[BK * LDH];
  bf16 v[BK * LDH];
  bf16 p[kWarps * 16 * LDP];
  float s[kWarps * 16 * LDS];
};

template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int r0, int n) {
  sfc::load_tile64<DH, kThreads>(dst, base, row_stride, r0, n);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    local_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int nq, int nk, int block, int halo,
                     long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                     long long ksh, long long vsb, long long vsn, long long vsh, float scale) {
  using S = Smem<DH>;
  constexpr int LDH = S::LDH, LDS = S::LDS;
  extern __shared__ __align__(128) unsigned char dyn[];
  S& sm = *reinterpret_cast<S*>(dyn);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  // The keys [lo, hi) this tile's queries see: the window of its curve
  // block.
  const int j = q0 / block;
  const int lo = max(0, (j - halo) * block);
  const int hi = min(nk, (j + halo + 1) * block);

  load_tile<DH>(sm.q, qb, qsn, q0, nq);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  FragA q_regs[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(q_regs[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);
  bf16* p_w = &sm.p[warp * 16 * LDP];
  float* s_w = &sm.s[warp * 16 * LDS];

  auto load_kv = [&](int k0, bool with_v) {
    load_tile<DH>(sm.k, kb, ksn, k0, hi);
    if (with_v) load_tile<DH>(sm.v, vb, vsn, k0, hi);
    sfc::cp_async_commit();
    sfc::cp_async_wait<0>();
    __syncthreads();
  };

  // Raw logits Q.K^T of this warp's 16 rows against the 64 keys in sm.k
  // (K^T as a col-major [Dh, keys] operand is sm.k read row-major).
  auto logits = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragC sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        FragBCol kf;
        wmma::load_matrix_sync(kf, &sm.k[(j * 16) * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, q_regs[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_w + j * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // P (16 x 64 bf16 at p_w) . V tile into fresh fragments.
  auto p_times_v = [&](FragC (&o)[DH / 16]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA pf;
      wmma::load_matrix_sync(pf, p_w + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        FragBRow vf;
        wmma::load_matrix_sync(vf, &sm.v[(kk * 16) * LDH + j * 16], LDH);
        wmma::mma_sync(o[j], pf, vf, o[j]);
      }
    }
  };

  // Lane pair (2r, 2r+1) owns row r; lane parity picks alternate columns.
  const int r = lane / 2, half = lane % 2;
  const int row = q0 + warp * 16 + r;
  bf16* out_row = out + ((static_cast<long long>(b) * nq + row) * heads + h) * DH;
  float m, l;

  // Pass 1: row max and row sum of exp(s - max), rescaled as the max grows.
  m = sfc::kNegInf;
  l = 0.f;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    load_kv(k0, false);
    logits();
    float tmax = sfc::kNegInf;
#pragma unroll 8
    for (int i = 0; i < BK / 2; ++i) {
      const int c = half + 2 * i;
      tmax = fmaxf(tmax, k0 + c < hi ? s_w[r * LDS + c] * scale : sfc::kNegInf);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll 8
    for (int i = 0; i < BK / 2; ++i) {
      const int c = half + 2 * i;
      const float sv = k0 + c < hi ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      psum += expf(sv - m_new);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * expf(m - m_new) + psum;
    m = m_new;
    __syncthreads();  // sm.k is overwritten by the next tile
  }

  // Pass 2: P = exp(s - m) / l rounded to bf16, then O += P . V in fp32.
  FragC of[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(of[j], 0.f);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    load_kv(k0, true);
    logits();
#pragma unroll 8
    for (int i = 0; i < BK / 2; ++i) {
      const int c = half + 2 * i;
      const float sv = k0 + c < hi ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      p_w[r * LDP + c] = __float2bfloat16(expf(sv - m) / l);
    }
    __syncwarp();
    p_times_v(of);
    __syncthreads();  // sm.k / sm.v are overwritten by the next tile
  }
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(s_w + j * 16, of[j], LDS, wmma::mem_row_major);
  __syncwarp();
  if (row < nq) {
#pragma unroll
    for (int c8 = 0; c8 < DH / 2; c8 += 8) {
      const int c = half * (DH / 2) + c8;
      *reinterpret_cast<uint4*>(out_row + c) = sfc::pack_bf16x8(&s_w[r * LDS + c]);
    }
  }
  if (lse != nullptr && half == 0 && row < nq)
    lse[static_cast<long long>(bh) * nq + row] = m + logf(l == 0.f ? 1.f : l);
}

template <int DH>
cudaError_t launch(cudaStream_t stream, int batch, int heads, int nq, int nk, int block,
                   int halo, const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, const long long* st, float scale) {
  auto kernel = local_fwd_kernel<DH>;
  const int smem = static_cast<int>(sizeof(Smem<DH>));
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, heads, nq, nk, block, halo,
                                           st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                                           st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// #12: q, k, v bf16 [batch, n, heads, dh] read through their (batch, row,
// head) strides in elements (unit stride along dh, rows 16-byte
// aligned); out bf16 [batch, n, heads, dh] contiguous; lse fp32 [batch,
// heads, n] or null.  dh must be 64, block a positive multiple of 64,
// halo >= 1.
extern "C" int sfc_local_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int heads, int n, int dh, int block,
                                  int halo, long long qsb, long long qsn, long long qsh,
                                  long long ksb, long long ksn, long long ksh, long long vsb,
                                  long long vsn, long long vsh, float scale, void* stream) {
  if (dh != 64 || n < 1 || heads < 1 || batch < 0 || block < BQ || block % BQ || halo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  return static_cast<int>(launch<64>(
      static_cast<cudaStream_t>(stream), batch, heads, n, n, block, halo,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), st, scale));
}
