// Softmax attention straight off the packed QKV projection:
// att[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale, keys < n_valid) . V
//
// Replaces: the per-(image, head) loop of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (lines
// 153-196).  It reads q, k and v from qkv [B, N, 3*inner] at columns
// h*Dh, inner + h*Dh and 2*inner + h*Dh, as that loop slices qkv_s.
// Logits are fp32 times scale; keys at or past n_valid get -1e30 (never
// -inf, so no NaN); the softmax is over the whole row; P is normalised by
// the row sum and rounded to bf16 BEFORE the P.V product, which
// accumulates in fp32 -- the TPU kernel's rounding point.
//
// Bound on this card: at ViT-B (N = 196, Dh = 64) one (image, head) is
// 2*2*196*196*64 = 9.8 MFLOP on 75 KB of q/k/v: tensor-core bound in
// principle, but small, so launch shape and the two passes dominate.
// Design: one 128-thread block per (image, head, 64-query tile); each warp
// owns 16 query rows whose Q fragments stay in registers.  Keys stream
// through shared memory in 64-row tiles (one head's whole K and V at
// N = 196 is 50 KB, and at N = 1024 it is 256 KB, more than a block may
// hold), so a TPU block's whole-sequence softmax becomes two passes over
// the key tiles: the first keeps a running max and a rescaled running sum,
// the second recomputes each logit tile, forms exp(s - max) / sum, rounds
// it to bf16 and multiplies by V.  Recomputing Q.K^T once costs a third
// more tensor work and keeps the TPU kernel's exact rounding point at any
// N.  Static shared memory is 44 KB: Q (reused for P), one K and one V
// tile, and a per-warp fp32 logits tile.
//
// The training forward also writes lse = m + log(l) per (image, head,
// row) in fp32, the TPU kernel's save_lse output (lines 189-190, 271-281):
// pass 1 already holds the row max m and the rescaled row sum l.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int DH = 64;
constexpr int BQ = 64, BKV = 64;
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDH = DH + 8;   // 144-byte rows: 16-byte copy slots, 32-byte fragment starts
constexpr int LDS = BKV + 4;  // fp32 logits rows

struct Smem {
  bf16 q[BQ * LDH];  // Q tile; once in registers, each warp's rows hold its P
  bf16 k[BKV * LDH];
  bf16 v[BKV * LDH];
  float s[kWarps * 16 * LDS];
};

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         float* __restrict__ lse, int n, int heads, int n_valid,
                         float scale) {
  __shared__ __align__(128) unsigned char raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int inner = heads * DH;
  const size_t row_stride = 3 * static_cast<size_t>(inner);
  const bf16* base = qkv + static_cast<size_t>(b) * n * row_stride;

  // Q tile (rows past n zero-filled).
  for (int c = tid; c < BQ * DH / 8; c += kThreads) {
    const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
    const int row = q0 + r;
    const bool ok = row < n;
    sfc::cp_async16(&sm.q[r * LDH + cc], ok ? base + row * row_stride + h * DH + cc : base, ok);
  }
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);
  // Only this warp reads or writes its 16 rows of sm.q from here on.
  bf16* p_w = &sm.q[warp * 16 * LDH];
  float* s_w = &sm.s[warp * 16 * LDS];

  auto load_kv = [&](int t, bool with_v) {
    const int k0 = t * BKV;
    for (int c = tid; c < BKV * DH / 8; c += kThreads) {
      const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
      const int row = k0 + r;
      const bool ok = row < n;
      const bf16* src = base + row * row_stride + h * DH + cc;
      sfc::cp_async16(&sm.k[r * LDH + cc], ok ? src + inner : base, ok);
      if (with_v) sfc::cp_async16(&sm.v[r * LDH + cc], ok ? src + 2 * inner : base, ok);
    }
    sfc::cp_async_commit();
    sfc::cp_async_wait<0>();
    __syncthreads();
  };

  // Raw logits Q.K^T of this warp's 16 rows against the 64 keys in sm.k.
  auto logits = [&]() {
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // K^T as a col-major [Dh, keys] operand is sm.k read row-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[(j * 16) * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_w + j * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // Lane pair (2r, 2r+1) owns row r; lane parity picks alternate columns.
  const int r = lane / 2, half = lane % 2;
  const int n_tiles = (n_valid + BKV - 1) / BKV;

  // Pass 1: row max and row sum of exp(s - max), rescaled as the max grows.
  float m = sfc::kNegInf, l = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t, false);
    logits();
    const int k0 = t * BKV;
    float tmax = sfc::kNegInf;
#pragma unroll 8
    for (int i = 0; i < BKV / 2; ++i) {
      const int c = half + 2 * i;
      const float sv = k0 + c < n_valid ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      tmax = fmaxf(tmax, sv);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll 8
    for (int i = 0; i < BKV / 2; ++i) {
      const int c = half + 2 * i;
      const float sv = k0 + c < n_valid ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      psum += expf(sv - m_new);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * expf(m - m_new) + psum;
    m = m_new;
    __syncthreads();  // sm.k is overwritten by the next tile
  }
  if (lse != nullptr && half == 0 && q0 + warp * 16 + r < n)
    lse[(static_cast<size_t>(b) * heads + h) * n + q0 + warp * 16 + r] = m + logf(l);

  // Pass 2: P = exp(s - m) / l rounded to bf16, then O += P . V in fp32.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(of[j], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t, true);
    logits();
    const int k0 = t * BKV;
#pragma unroll 8
    for (int i = 0; i < BKV / 2; ++i) {
      const int c = half + 2 * i;
      const float sv = k0 + c < n_valid ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      p_w[r * LDH + c] = __float2bfloat16(expf(sv - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, p_w + kk * 16, LDH);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, &sm.v[(kk * 16) * LDH + j * 16], LDH);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
    __syncthreads();  // sm.k / sm.v are overwritten by the next tile
  }

  // Write O: stage through the warp's logits tile, 16-byte stores.
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(s_w + j * 16, of[j], LDS, wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + warp * 16 + r;
  if (row < n) {
    bf16* dst = out + (static_cast<size_t>(b) * n + row) * inner + h * DH;
#pragma unroll
    for (int c8 = 0; c8 < DH / 2; c8 += 8) {
      const int c = half * (DH / 2) + c8;
      *reinterpret_cast<uint4*>(dst + c) = sfc::pack_bf16x8(&s_w[r * LDS + c]);
    }
  }
}

}  // namespace

// qkv: bf16 [batch, n, 3 * heads * dh]; out: bf16 [batch, n, heads * dh];
// lse: fp32 [batch, heads, n], or null.  Keys at or past n_valid
// (1 <= n_valid <= n) are masked.  dh must be 64.
extern "C" int sfc_attention_fwd_bf16(const void* qkv, void* out, void* lse,
                                      int batch, int n, int heads, int dh,
                                      int n_valid, float scale, void* stream) {
  if (dh != DH || n_valid < 1 || n_valid > n) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, heads, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}
