// Flash attention forward on [B, N, H, Dh] (kernel #8):
// out[b, i, h] = softmax(q[b, i, h] . K[b, :, h]^T * scale) . V[b, :, h]
// for nq queries and nk keys (nq != nk allowed), head dim 64, bf16 in and
// out, optionally with the fp32 log-sum-exp of every softmax row; and its
// curve-local form (kernel #12), the same softmax over a window of keys.
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_fwd_kernel (lines
// 114-213).  Its two formulas, picked by the caller from the key length
// as the TPU launcher picks them (round_up(nk, 128) <= 4096):
//  * single K step (kStream false; lines 134-161): fp32 logits times
//    scale, the row's max m and sum l over every key, then
//    P = exp(s - m) / l rounded to bf16 and an fp32 P.V, rounded once.
//  * streaming (kStream true; lines 163-213): per key tile,
//    m' = max(m, max_tile(s)), p = exp(s - m') rounded to bf16
//    UNNORMALISED, alpha = exp(m - m'), l = sum(p) + alpha * l and
//    acc = acc * alpha + bf16(p) . V in fp32; out = bf16(acc * (1 / l)).
//    The TPU kernel's key tiles are 1,024 wide; here they are 64, so the
//    running max that p is rounded against moves every 64 keys.
// Keys at or past nk get -1e30 (never -inf: p = 0, no NaN); lse = m +
// log(l) (log(1) where l = 0).  q, k and v are read through their
// strides (batch, row, head; unit stride along Dh), so the [B, N, H, Dh]
// views of a packed QKV projection need no copy; out is contiguous.
//
// Curve-local (kWindow; #12, replaces sfc_vit_tpu/ops/local_attention.py::
// _kernel, lines 82-124): query i sees exactly the keys j with
// |i / block - j / block| <= halo and j < N, with the single K step's
// arithmetic over that window (normalise in fp32, then round).  The TPU
// kernel reads 2 * halo + 1 clamped neighbour-block views and masks the
// out-of-range ones (in_range), so no key counts twice at the sequence's
// ends; here a query tile's key range [max(0, (j - halo) * block),
// min(N, (j + halo + 1) * block)) for its curve block j is computed
// directly, the same set.  block is a multiple of 64, so a query tile lies
// in one curve block.  At block 128, halo 1 a query meets at most 384
// keys: 4 * 384 * 64 flops per row on 4 * 128 bytes of q, k, v and out,
// ~190 flops a byte, under the H100's ~295, so the bytes bound it.
//
// Bound on this card: one (b, h) at N = 16,384 and Dh = 64 is
// 4 * 16384^2 * 64 = 69 GFLOP on 6 MB of q/k/v/out, ~10^4 flops a byte,
// far above the H100's ~295: tensor-core bound (989 TFLOP/s in bf16).
// Design (simple first, as the repository's other attention kernels):
// one 128-thread block per (64-query tile, b * h); each warp owns 16
// query rows, keeps its 16 x 64 Q slice in WMMA fragments and streams
// 64-key K and V tiles through shared memory (cp.async, zero-filled past
// nk).  Logits go through a per-warp fp32 tile in shared memory, where a
// lane pair owns a row for the softmax.  Single step: two passes over
// the keys (max and sum, then P . V into register fragments), as
// attention_fwd.cu runs.  Streaming: one pass; since a WMMA fragment's
// element-to-row mapping is opaque, the fp32 accumulator lives in shared
// memory, each tile's P . V lands in fresh fragments, is staged through
// the logits tile and folded in as acc * alpha + pv by the row's lane
// pair.  Shared memory at Dh 64: 53 KB (Q, K, V, P and logits; the
// single step and the window, four blocks an SM), 70 KB streaming (and
// the accumulator, three blocks an SM).

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

template <int DH, bool kStream>
struct Smem {
  static constexpr int LDH = DH + 8;                         // bf16 tile rows
  static constexpr int LDS = (BK > DH ? BK : DH) + 4;        // fp32 logits / staging rows
  bf16 q[BQ * LDH];
  bf16 k[BK * LDH];
  bf16 v[BK * LDH];
  bf16 p[kWarps * 16 * LDP];
  float s[kWarps * 16 * LDS];
  float acc[kStream ? kWarps * 16 * LDS : 1];  // streaming only
};

template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int r0, int n) {
  sfc::load_tile64<DH, kThreads>(dst, base, row_stride, r0, n);
}

template <int DH, bool kStream, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int nq, int nk, int block, int halo,
                     long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                     long long ksh, long long vsb, long long vsn, long long vsh, float scale) {
  static_assert(!(kStream && kWindow), "the window takes the single K step's arithmetic");
  using S = Smem<DH, kStream>;
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
  // The keys [lo, hi) this tile's queries see: all, or the window of its
  // curve block.
  int lo = 0, hi = nk;
  if constexpr (kWindow) {
    const int j = q0 / block;
    lo = max(0, (j - halo) * block);
    hi = min(nk, (j + halo + 1) * block);
  }

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
  float* acc_w = &sm.acc[warp * 16 * LDS];

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

  if constexpr (!kStream) {
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
  } else {
    // One pass with a running max; the fp32 accumulator in shared memory.
#pragma unroll 8
    for (int c = half * (DH / 2); c < (half + 1) * (DH / 2); ++c) acc_w[r * LDS + c] = 0.f;
    m = __int_as_float(0xff800000);  // -inf, as the TPU's m_s: the first alpha is 0
    l = 0.f;
    for (int k0 = lo; k0 < hi; k0 += BK) {
      load_kv(k0, true);
      logits();
      float tmax = sfc::kNegInf;
#pragma unroll 8
      for (int i = 0; i < BK / 2; ++i) {
        const int c = half + 2 * i;
        tmax = fmaxf(tmax, k0 + c < hi ? s_w[r * LDS + c] * scale : sfc::kNegInf);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll 8
      for (int i = 0; i < BK / 2; ++i) {
        const int c = half + 2 * i;
        const float sv = k0 + c < hi ? s_w[r * LDS + c] * scale : sfc::kNegInf;
        const float p = expf(sv - m_new);
        psum += p;
        p_w[r * LDP + c] = __float2bfloat16(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = psum + alpha * l;
      m = m_new;
      __syncwarp();
      FragC pv[DH / 16];
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(pv[j], 0.f);
      p_times_v(pv);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j)
        wmma::store_matrix_sync(s_w + j * 16, pv[j], LDS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll 8
      for (int c = half * (DH / 2); c < (half + 1) * (DH / 2); ++c)
        acc_w[r * LDS + c] = acc_w[r * LDS + c] * alpha + s_w[r * LDS + c];
      __syncthreads();  // sm.k / sm.v and the warp's logits tile are reused next
    }
    const float inv = l == 0.f ? 1.f : 1.f / l;
    if (row < nq) {
#pragma unroll
      for (int c8 = 0; c8 < DH / 2; c8 += 8) {
        const int c = half * (DH / 2) + c8;
        float o8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o8[e] = acc_w[r * LDS + c + e] * inv;
        *reinterpret_cast<uint4*>(out_row + c) = sfc::pack_bf16x8(o8);
      }
    }
  }
  if (lse != nullptr && half == 0 && row < nq)
    lse[static_cast<long long>(bh) * nq + row] = m + logf(l == 0.f ? 1.f : l);
}

template <int DH, bool kStream, bool kWindow>
cudaError_t launch(cudaStream_t stream, int batch, int heads, int nq, int nk, int block,
                   int halo, const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   float* lse, const long long* st, float scale) {
  auto kernel = flash_fwd_kernel<DH, kStream, kWindow>;
  const int smem = static_cast<int>(sizeof(Smem<DH, kStream>));
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

// q bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh], each
// read through its (batch, row, head) strides in elements (unit stride
// along dh, rows 16-byte aligned); out bf16 [batch, nq, heads, dh]
// contiguous; lse fp32 [batch, heads, nq] or null.  streaming selects the
// one-pass form.  dh must be 64.
extern "C" int sfc_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int heads, int nq, int nk, int dh,
                                  long long qsb, long long qsn, long long qsh, long long ksb,
                                  long long ksn, long long ksh, long long vsb, long long vsn,
                                  long long vsh, float scale, int streaming, void* stream) {
  if (dh != 64 || nq < 1 || nk < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto* lp = static_cast<float*>(lse);
  const cudaError_t e =
      streaming
          ? launch<64, true, false>(s, batch, heads, nq, nk, 0, 0, qp, kp, vp, op, lp, st, scale)
          : launch<64, false, false>(s, batch, heads, nq, nk, 0, 0, qp, kp, vp, op, lp, st,
                                     scale);
  return static_cast<int>(e);
}

// #12: q, k, v bf16 [batch, n, heads, dh] read through their strides as
// above; out bf16 [batch, n, heads, dh] contiguous; lse fp32 [batch,
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
  return static_cast<int>(launch<64, false, true>(
      static_cast<cudaStream_t>(stream), batch, heads, n, n, block, halo,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), st, scale));
}
