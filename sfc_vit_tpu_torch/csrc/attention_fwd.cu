// Softmax attention with probability dropout straight off the packed QKV
// projection: att[b, i, h*Dh:(h+1)*Dh] = bf16((P / keep) * mask) . V with
// P = softmax(q_i . K^T * scale, keys < n_valid), for head dims Dh = 64
// and 192, and lse = m + log(l) for every row.
//
// Replaces: the per-(image, head) loops of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (lines
// 109-139; kernel #5, the family-A flagship's training forward at Dh =
// 192 and 'hier''s at Dh = 64).  It serves only #5: the unmasked attention
// of #1 (sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel) and
// #7 run on csrc/packed_attn_sm90.cu (ops/_build.py::attention_fwd_route).
// It reads q, k and v from qkv [B, N, 3*inner] at columns h*Dh, inner +
// h*Dh and 2*inner + h*Dh, as those loops slice the packed block.  Logits
// are fp32 times scale; keys at or past n_valid get -1e30 (never -inf, so
// no NaN); the softmax is over the whole row and P = exp(s - m) / l in
// fp32.  The 0/1 mask [B, H, N, N] (uint8) and keep = 1 - rate give
// Pd = bf16((P / keep) * mask): divided by keep, not multiplied by its
// reciprocal, and rounded after the mask, as _torch_mha_kernel does.  The
// mask is drawn outside, so the kernel has no random number generator;
// as uint8 it is a quarter of the bf16 mask's bytes the TPU kernel read.
// P.V accumulates in fp32 and is rounded once.
//
// Bound on this card: the bytes.  At the flagship (N = 64, Dh = 192) one
// (image, head) is 2*2*64*64*192 = 3.1 MFLOP on 72 KB of q/k/v, 24 KB of
// output and the mask's 4 KB, about 30 flops a byte, far under the
// H100's ~295.  This is PR 3's WMMA design, not yet redesigned for Hopper
// (ROADMAP queue 2, next: the mask on packed_attn_sm90.cu's kernel).
// Design: one 128-thread block per (image, head, 64-query tile); each
// warp owns 16 query rows.  Keys stream through shared memory in 64-row
// tiles (one head's whole K and V at N = 1024 is more than a block may
// hold), so the whole-sequence softmax becomes two passes over the key
// tiles: the first keeps a running max and a rescaled running sum, the
// second recomputes each logit tile, forms P, drops, rounds and
// multiplies by V.  Recomputing Q.K^T costs a third more tensor work and
// keeps the TPU kernel's exact rounding point at any N.  At Dh = 64 a
// warp keeps its 16 x 64 Q slice in WMMA fragments (16 registers a
// thread) and writes P over its own Q rows in shared memory: 45 KB, five
// blocks an SM.  At Dh = 192 that slice would be 48 registers on top of
// the 96 of its output accumulators, so its fragments load from shared
// memory at each use and P has a buffer of its own: 103 KB of dynamic
// shared memory (Q, one K and one V tile, P and fp32 logits).
//
// lse = m + log(l) per (image, head, row) in fp32 is the TPU kernels'
// save_lse output: pass 1 already holds the row max m and the rescaled
// row sum l.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BQ = 64, BKV = 64;
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDS = BKV + 4;  // fp32 logits rows
constexpr int LDP = BKV + 8;  // bf16 P rows: 16-byte copy slots, 32-byte fragment starts

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Q in registers (and P over Q's rows) at Dh = 64 only; see above.
__host__ __device__ constexpr bool q_in_regs(int dh) { return dh == 64; }

template <int DH>
struct Smem {
  static constexpr int LDH = DH + 8;  // 16-byte copy slots, 32-byte fragment starts
  bf16 q[BQ * LDH];
  bf16 k[BKV * LDH];
  bf16 v[BKV * LDH];
  bf16 p[q_in_regs(DH) ? 16 : kWarps * 16 * LDP];  // unused at Dh = 64
  float s[kWarps * 16 * LDS];
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                         bf16* __restrict__ out, float* __restrict__ lse, int n,
                         int heads, int n_valid, float scale, float keep) {
  using S = Smem<DH>;
  constexpr int LDH = S::LDH;
  extern __shared__ __align__(128) unsigned char dyn[];
  S& sm = *reinterpret_cast<S*>(dyn);

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

  constexpr bool kQInRegs = q_in_regs(DH);
  static_assert(!kQInRegs || LDH == LDP, "P is written over Q's rows");
  bf16* q_w = &sm.q[warp * 16 * LDH];
  // Only this warp reads or writes its 16 rows of sm.q.
  bf16* p_w = kQInRegs ? q_w : &sm.p[warp * 16 * LDP];
  float* s_w = &sm.s[warp * 16 * LDS];
  FragA q_regs[kQInRegs ? DH / 16 : 1];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(q_regs[kk], q_w + kk * 16, LDH);
  }

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
  // K^T as a col-major [Dh, keys] operand is sm.k read row-major.
  auto logits = [&]() {
    if constexpr (kQInRegs) {
      // Keys outer: one accumulator live beside Q's fragments.
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
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
    } else {
      // Depth outer: each Q fragment loaded from shared memory once.
      FragC sf[BKV / 16];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        FragA qf;
        wmma::load_matrix_sync(qf, q_w + kk * 16, LDH);
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) {
          FragBCol kf;
          wmma::load_matrix_sync(kf, &sm.k[(j * 16) * LDH + kk * 16], LDH);
          wmma::mma_sync(sf[j], qf, kf, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
        wmma::store_matrix_sync(s_w + j * 16, sf[j], LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // Lane pair (2r, 2r+1) owns row r; lane parity picks alternate columns.
  const int r = lane / 2, half = lane % 2;
  const int row = q0 + warp * 16 + r;
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
  if (lse != nullptr && half == 0 && row < n)
    lse[(static_cast<size_t>(b) * heads + h) * n + row] = m + logf(l);

  // Pass 2: P = exp(s - m) / l (dropped and rescaled under a mask),
  // rounded to bf16, then O += P . V in fp32.
  const uint8_t* mask_row =
      mask + ((static_cast<size_t>(b) * heads + h) * n + (row < n ? row : 0)) * n;
  FragC of[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(of[j], 0.f);
  for (int t = 0; t < n_tiles; ++t) {
    load_kv(t, true);
    logits();
    const int k0 = t * BKV;
#pragma unroll 8
    for (int i = 0; i < BKV / 2; ++i) {
      const int c = half + 2 * i;
      const int key = k0 + c;
      const float sv = key < n_valid ? s_w[r * LDS + c] * scale : sfc::kNegInf;
      float p = expf(sv - m) / l;
      p = (row < n && key < n_valid && mask_row[key]) ? p / keep : 0.f;
      p_w[r * LDP + c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      FragA pf;
      wmma::load_matrix_sync(pf, p_w + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        FragBRow vf;
        wmma::load_matrix_sync(vf, &sm.v[(kk * 16) * LDH + j * 16], LDH);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
    __syncthreads();  // sm.k / sm.v are overwritten by the next tile
  }

  // Write O, 64 columns at a time: stage through the warp's logits tile,
  // 16-byte stores.
#pragma unroll
  for (int c0 = 0; c0 < DH; c0 += 64) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_w + j * 16, of[c0 / 16 + j], LDS, wmma::mem_row_major);
    __syncwarp();
    if (row < n) {
      bf16* dst = out + (static_cast<size_t>(b) * n + row) * inner + h * DH + c0;
#pragma unroll
      for (int c8 = 0; c8 < 32; c8 += 8) {
        const int c = half * 32 + c8;
        *reinterpret_cast<uint4*>(dst + c) = sfc::pack_bf16x8(&s_w[r * LDS + c]);
      }
    }
    __syncwarp();
  }
}

template <int DH>
cudaError_t launch(const dim3& grid, cudaStream_t stream, const bf16* qkv,
                   const uint8_t* mask, bf16* out, float* lse, int n, int heads,
                   int n_valid, float scale, float keep) {
  auto kernel = attention_fwd_kernel<DH>;
  const int smem = static_cast<int>(sizeof(Smem<DH>));
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(qkv, mask, out, lse, n, heads, n_valid, scale,
                                           keep);
  return cudaGetLastError();
}

}  // namespace

// qkv: bf16 [batch, n, 3 * heads * dh]; out: bf16 [batch, n, heads * dh];
// lse: fp32 [batch, heads, n], or null; mask: uint8 0/1 [batch, heads, n,
// n] with keep in (0, 1].  Keys at or past n_valid (1 <= n_valid <= n)
// are masked.  dh must be 64 or 192.
extern "C" int sfc_attention_fwd_bf16(const void* qkv, const void* mask, void* out,
                                      void* lse, int batch, int n, int heads, int dh,
                                      int n_valid, float scale, float keep,
                                      void* stream) {
  if ((dh != 64 && dh != 192) || n_valid < 1 || n_valid > n || mask == nullptr ||
      !(keep > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<bf16*>(out);
  auto* ls = static_cast<float*>(lse);
  const cudaError_t e =
      dh == 64 ? launch<64>(grid, s, q, mk, o, ls, n, heads, n_valid, scale, keep)
               : launch<192>(grid, s, q, mk, o, ls, n, heads, n_valid, scale, keep);
  return static_cast<int>(e);
}
