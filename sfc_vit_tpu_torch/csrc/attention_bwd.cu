// Softmax-attention backward straight off the packed QKV projection: the
// per-(image, head) part of the attention-block backward.
//
// Replaces: the per-(image, head) loop of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel
// (lines 423-496) on the path the TPU trains with (with_acts + with_lse:
// the forward saved qkv, att and the log-sum-exp).  It reads q, k and v
// from qkv [B, N, 3*inner] at columns h*64, inner + h*64 and
// 2*inner + h*64, da from datt [B, N, inner] (= bf16(gp . W_out^T)), the
// forward's att and lse [B, H, N], and writes dq, dk and dv into the
// packed dqkv [B, N, 3*inner] at the same columns.  The TPU's rounding
// points: pn = bf16(exp(s * scale - lse)) (keys at or past n_valid give
// pn = 0); dpn = da . v^T in fp32; delta = rowsum(da * att_h) in fp32 (the
// flash identity of lines 469-477); ds = bf16(pn * (dpn - delta) * scale);
// dq = ds . k, dk = ds^T . q and dv = pn^T . da, each one fp32 sum over
// the whole sequence rounded once to bf16.
//
// Bound on this card: at ViT-B (N = 196, Dh = 64) one (image, head) is
// 4 products of 196 x 196 x 64 (the logits twice, dp twice), 3 more for
// dq/dk/dv: ~34 MFLOP on ~150 KB of operands, tensor-core bound in
// principle but small, so launch shape and exp throughput dominate.
// Design: the TPU walked one image group's heads in order inside one
// grid step; Hopper blocks run in no order, so each (image, head) is
// split over two kernels that never write the same element.  Kernel 1
// (one block per (image, head, 64-query tile)) computes delta for its
// rows, writes it to a scratch [B, H, N], and streams the key tiles to
// form dq.  Kernel 2 (one block per (image, head, 64-key tile)) keeps
// its keys' K and V fragments in registers and streams the query tiles
// to form dk and dv, transposed: s^T = K . Q^T and dp^T = V . dA^T, so
// each warp owns 16 keys and no atomics are needed.  Both recompute the
// logits (the TPU recomputed them too).  128 threads, 4 warps of 16 rows,
// 64-row tiles through shared memory (80 KB / 71 KB, dynamic), each
// warp's fp32 logits and dp tiles and its bf16 pn / ds tiles in shared
// memory for the elementwise step.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int DH = 64;
constexpr int BT = 64;  // rows of a query or key tile
constexpr int kWarps = BT / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDH = DH + 8;  // 144-byte rows: 16-byte copy slots, 32-byte fragment starts
constexpr int LDS = BT + 4;  // fp32 rows

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct DqSmem {
  bf16 q[BT * LDH];
  bf16 da[BT * LDH];
  bf16 k[BT * LDH];  // first the att tile (for delta), then each K tile
  bf16 v[BT * LDH];
  bf16 ds[kWarps * 16 * LDH];
  float s[kWarps * 16 * LDS];
  float dp[kWarps * 16 * LDS];
};

struct DkvSmem {
  bf16 kv[2 * BT * LDH];  // this block's K and V tile, then each warp's pn^T and ds^T
  bf16 q[BT * LDH];
  bf16 da[BT * LDH];
  float s[kWarps * 16 * LDS];
  float dp[kWarps * 16 * LDS];
  float lse[BT];
  float delta[BT];
};

// Rows r0.. of a [*, width] bf16 tensor, columns col..col+63, into a
// [BT][LDH] tile; rows at or past n are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int r0,
                                          int n, size_t width, int col) {
  for (int c = threadIdx.x; c < BT * DH / 8; c += kThreads) {
    const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
    const bool ok = r0 + r < n;
    sfc::cp_async16(&dst[r * LDH + cc], ok ? base + (r0 + r) * width + col + cc : base, ok);
  }
}

// Each warp's 16 x 64 fp32 product of A fragments (16 rows x 64 deep, in
// registers) with the transpose of a [64][LDH] bf16 tile (B col_major).
__device__ __forceinline__ void rows_times_tile_t(const FragA (&a)[DH / 16],
                                                  const bf16* tile, float* out) {
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBCol b;
      wmma::load_matrix_sync(b, &tile[(j * 16) * LDH + kk * 16], LDH);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[j] += P (16 x 64 bf16 at p, ld LDH) . tile ([64][LDH], row_major).
__device__ __forceinline__ void accumulate(FragC (&acc)[DH / 16], const bf16* p,
                                           const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, p + kk * 16, LDH);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragBRow b;
      wmma::load_matrix_sync(b, &tile[(kk * 16) * LDH + j * 16], LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// Rounds a warp's accumulators to bf16 rows row0.. (< n) of dst at column
// col, staged through the warp's fp32 tile.
__device__ __forceinline__ void store_rows(FragC (&acc)[DH / 16], float* stage,
                                           bf16* dst, int row0, int n,
                                           size_t width, int col) {
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32, r = lane / 2, half = lane % 2;
  if (row0 + r < n) {
    bf16* out = dst + (row0 + r) * width + col;
#pragma unroll
    for (int c8 = 0; c8 < DH / 2; c8 += 8) {
      const int c = half * (DH / 2) + c8;
      *reinterpret_cast<uint4*>(out + c) = sfc::pack_bf16x8(&stage[r * LDS + c]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ att,
                            const bf16* __restrict__ datt, const float* __restrict__ lse,
                            float* __restrict__ delta, bf16* __restrict__ dqkv, int n,
                            int heads, int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char dyn[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns row r
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * DH;
  const size_t w3 = 3 * static_cast<size_t>(inner), w1 = inner;
  const bf16* qkv_b = qkv + static_cast<size_t>(b) * n * w3;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * n;

  load_rows(sm.q, qkv_b, q0, n, w3, h * DH);
  load_rows(sm.da, datt + static_cast<size_t>(b) * n * w1, q0, n, w1, h * DH);
  load_rows(sm.k, att + static_cast<size_t>(b) * n * w1, q0, n, w1, h * DH);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(da * att_h) in fp32; rows past n are zero tiles.
  const int row = q0 + warp * 16 + r;
  float dl = 0.f;
  {
    const bf16* da_r = &sm.da[(warp * 16 + r) * LDH + half * (DH / 2)];
    const bf16* at_r = &sm.k[(warp * 16 + r) * LDH + half * (DH / 2)];
#pragma unroll 8
    for (int c = 0; c < DH / 2; ++c) dl += __bfloat162float(da_r[c]) * __bfloat162float(at_r[c]);
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  }
  const float lse_r = row < n ? lse[bh + row] : 0.f;
  if (row < n && half == 0) delta[bh + row] = dl;

  FragA qf[DH / 16], daf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);
    wmma::load_matrix_sync(daf[kk], &sm.da[warp * 16 * LDH + kk * 16], LDH);
  }
  __syncthreads();  // sm.k (the att tile) is overwritten below

  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* ds_w = &sm.ds[warp * 16 * LDH];
  FragC dq[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  const int n_tiles = (n_valid + BT - 1) / BT;  // keys past n_valid add nothing
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    load_rows(sm.k, qkv_b, k0, n, w3, inner + h * DH);
    load_rows(sm.v, qkv_b, k0, n, w3, 2 * inner + h * DH);
    sfc::cp_async_commit();
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t(qf, sm.k, s_w);    // s = q . k^T
    rows_times_tile_t(daf, sm.v, dp_w);  // dp = da . v^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;
      const float p = k0 + c < n_valid ? expf(s_w[r * LDS + c] * scale - lse_r) : 0.f;
      const float pf = __bfloat162float(__float2bfloat16(p));
      ds_w[r * LDH + c] = __float2bfloat16(pf * (dp_w[r * LDS + c] - dl) * scale);
    }
    __syncwarp();
    accumulate(dq, ds_w, sm.k);  // dq += ds . k
    __syncthreads();             // sm.k / sm.v are overwritten by the next tile
  }
  store_rows(dq, s_w, dqkv + static_cast<size_t>(b) * n * w3, q0 + warp * 16, n, w3, h * DH);
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dqkv, int n, int heads, int n_valid,
                             float scale) {
  extern __shared__ __align__(128) unsigned char dyn[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns key r
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * DH;
  const size_t w3 = 3 * static_cast<size_t>(inner), w1 = inner;
  const bf16* qkv_b = qkv + static_cast<size_t>(b) * n * w3;
  const bf16* datt_b = datt + static_cast<size_t>(b) * n * w1;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * n;

  load_rows(sm.kv, qkv_b, k0, n, w3, inner + h * DH);
  load_rows(sm.kv + BT * LDH, qkv_b, k0, n, w3, 2 * inner + h * DH);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();
  FragA kf[DH / 16], vf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], &sm.kv[warp * 16 * LDH + kk * 16], LDH);
    wmma::load_matrix_sync(vf[kk], &sm.kv[BT * LDH + warp * 16 * LDH + kk * 16], LDH);
  }
  __syncthreads();  // sm.kv now holds each warp's pn^T and ds^T tiles

  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* pt_w = &sm.kv[warp * 16 * LDH];
  bf16* dst_w = &sm.kv[BT * LDH + warp * 16 * LDH];
  const bool key_ok = k0 + warp * 16 + r < n_valid;
  FragC dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  const int n_tiles = (n + BT - 1) / BT;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BT;
    load_rows(sm.q, qkv_b, q0, n, w3, h * DH);
    load_rows(sm.da, datt_b, q0, n, w1, h * DH);
    sfc::cp_async_commit();
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const bool ok = q0 + i < n;  // past n: zero q and da rows add nothing
      sm.lse[i] = ok ? lse[bh + q0 + i] : 0.f;
      sm.delta[i] = ok ? delta[bh + q0 + i] : 0.f;
    }
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t(kf, sm.q, s_w);    // s^T = k . q^T
    rows_times_tile_t(vf, sm.da, dp_w);  // dp^T = v . da^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;  // query q0 + c
      const float p = key_ok ? expf(s_w[r * LDS + c] * scale - sm.lse[c]) : 0.f;
      const bf16 pn = __float2bfloat16(p);
      const float pf = __bfloat162float(pn);
      pt_w[r * LDH + c] = pn;
      dst_w[r * LDH + c] = __float2bfloat16(pf * (dp_w[r * LDS + c] - sm.delta[c]) * scale);
    }
    __syncwarp();
    accumulate(dv, pt_w, sm.da);  // dv += pn^T . da
    accumulate(dk, dst_w, sm.q);  // dk += ds^T . q
    __syncthreads();              // sm.q / sm.da / lse / delta are overwritten next
  }
  bf16* out = dqkv + static_cast<size_t>(b) * n * w3;
  store_rows(dk, s_w, out, k0 + warp * 16, n, w3, inner + h * DH);
  __syncwarp();
  store_rows(dv, s_w, out, k0 + warp * 16, n, w3, 2 * inner + h * DH);
}

}  // namespace

// qkv bf16 [batch, n, 3*heads*dh], att and datt bf16 [batch, n, heads*dh],
// lse fp32 [batch, heads, n]; delta fp32 [batch, heads, n] is scratch;
// dqkv bf16 [batch, n, 3*heads*dh] receives dq, dk and dv (every element
// is written).  Keys at or past n_valid (1 <= n_valid <= n) are masked.
// dh must be 64.
extern "C" int sfc_attention_bwd_bf16(const void* qkv, const void* att,
                                      const void* datt, const void* lse,
                                      void* delta, void* dqkv, int batch, int n,
                                      int heads, int dh, int n_valid,
                                      float scale, void* stream) {
  if (dh != DH || n_valid < 1 || n_valid > n) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(sizeof(DqSmem)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(DkvSmem)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + BT - 1) / BT, heads, batch);
  auto s = static_cast<cudaStream_t>(stream);
  attention_bwd_dq_kernel<<<grid, kThreads, sizeof(DqSmem), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(att),
      static_cast<const bf16*>(datt), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), n, heads, n_valid, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkv_kernel<<<grid, kThreads, sizeof(DkvSmem), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(datt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), n, heads, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}
