// Softmax-attention backward straight off the packed QKV projection, for
// every head dim Dh that is a multiple of 16 up to 256, optionally with
// probability dropout.
//
// What is left to this file: the lengths past csrc/attention_bwd_sm90.cu's
// limits (ops/_build.py::attention_bwd_route): #4 past 256 tokens, and
// #6's masked forms past 192 tokens at Dh 64 and past 64 at Dh 192, up
// to family A's 1,024 (models/layers.py::TORCH_MHA_MAX_N), past 64 tokens
// from Dh 80 ('hier''s fusion layers at Dh 128, 192 tokens; family B at
// dim_head 128, 196), and Dh 208 to 256 at any length.  Both main paths'
// shapes at their own head dims (the flagship's 64 tokens at Dh 192,
// 'hier''s 64 and 192 at Dh 64) run on the Hopper kernel.
//
// Replaces: the per-(image, head) loops of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel
// (lines 423-496) on the path the TPU trains with (with_acts + with_lse:
// the forward saved qkv, att and the log-sum-exp), and, with a mask,
// of sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel
// (lines 331-378).  It reads q, k and v from qkv [B, N, 3*inner] at
// columns h*Dh, inner + h*Dh and 2*inner + h*Dh, da from datt
// [B, N, inner] (= bf16(gp . W_out^T)), the forward's att and lse
// [B, H, N], and writes dq, dk and dv into the packed dqkv [B, N, 3*inner]
// at the same columns.  Keys at or past n_valid give p = 0.
//
// The TPU kernels' rounding points.  Without dropout (#4):
// pn = bf16(exp(s * scale - lse)); dpn = da . v^T in fp32;
// ds = bf16(pn * (dpn - delta) * scale); dv = pn^T . da.  With the 0/1
// mask and keep (#6): pf = exp(s * scale - lse) stays fp32;
// pdf = (pf / keep) * mask; dp = ((da . v^T) / keep) * mask;
// ds = bf16(pf * (dp - delta) * scale); dv = bf16(pdf)^T . da.  In both,
// delta = rowsum(da * att_h) in fp32 (the flash identity, which holds
// under the mask), dq = ds . k and dk = ds^T . q, each one fp32 sum over
// the whole sequence rounded once to bf16.
//
// Bound on this card: at ViT-B (N = 196, Dh = 64) one (image, head) is
// 4 products of 196 x 196 x 64 (the logits twice, dp twice), 3 more for
// dq/dk/dv: ~34 MFLOP on ~150 KB of operands; at the flagship (N = 64,
// Dh = 192) ~10 MFLOP on ~125 KB.  Tensor-core bound in principle but
// small, so launch shape and exp throughput dominate.
// Design: the TPU walked one image group's heads in order inside one
// grid step; Hopper blocks run in no order, so each (image, head) is
// split over two kernels that never write the same element.  Kernel 1
// (one block per (image, head, 64-query tile, 64-column chunk of Dh))
// computes delta for its rows (the first chunk writes it to a scratch
// [B, H, N]) and streams the key tiles to form its chunk of dq.
// Kernel 2 (one block per (image, head, 64-key tile, column chunk))
// streams the query tiles to form its chunk of dk and dv, transposed:
// s^T = K . Q^T and dp^T = V . dA^T, so each warp owns 16 keys and no
// atomics are needed.  Both recompute the logits at the full depth Dh
// (the TPU recomputed them too).  The column chunks keep every block's
// accumulators at 16 x 64 per output (32 registers a thread each) at
// any Dh: at Dh = 192 three blocks recompute one tile's logits, where
// whole-row dk and dv would need 192 accumulator registers a thread.
// The kernels are instanced by the padded width DH = 64 C (C = ceil(Dh /
// 64) chunks); a ragged head's columns past Dh load as zeros (the
// cp.async predicate), add nothing to the logits, dp or delta, and are
// never stored.
// 128 threads, 4 warps of 16 rows, 64-row tiles through dynamic shared
// memory (at Dh = 192: 143 KB for kernel 1, 152 KB for kernel 2; at 256
// 175 and 185 KB), each
// warp's fp32 logits and dp tiles and its bf16 p / ds tiles there too.
// At Dh = 64 the fixed A operands (q and da, or k and v) stay in WMMA
// fragments (32 registers a thread) and kernel 2 writes its p^T / ds^T
// tiles over its own rows of the K and V tiles (71 KB, three blocks an
// SM); at Dh = 192 they load from shared memory at each use.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BT = 64;  // rows of a query or key tile
constexpr int DC = 64;  // output columns of one block (a chunk of Dh)
constexpr int kWarps = BT / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDS = BT + 4;  // fp32 rows
constexpr int LDP = BT + 8;  // bf16 p / ds rows

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct DqSmem {
  static constexpr int LDH = DH + 8;  // 16-byte copy slots, 32-byte fragment starts
  bf16 q[BT * LDH];
  bf16 da[BT * LDH];
  bf16 k[BT * LDH];  // first the att tile (for delta), then each K tile
  bf16 v[BT * LDH];
  bf16 ds[kWarps * 16 * LDP];
  float s[kWarps * 16 * LDS];
  float dp[kWarps * 16 * LDS];
};

// A operands in registers (see above) at Dh = 64 only.
__host__ __device__ constexpr bool a_in_regs(int dh) { return dh == 64; }

template <int DH>
struct DkvSmem {
  static constexpr int LDH = DH + 8;
  static constexpr int kP = a_in_regs(DH) ? 16 : kWarps * 16 * LDP;  // unused at Dh = 64
  bf16 k[BT * LDH];  // this block's keys; at Dh = 64 then each warp's p^T
  bf16 v[BT * LDH];  // at Dh = 64 then each warp's ds^T
  bf16 q[BT * LDH];
  bf16 da[BT * LDH];
  bf16 pt[kP];  // each warp's p^T (or dropped pd^T)
  bf16 dst[kP];  // each warp's ds^T
  float s[kWarps * 16 * LDS];
  float dp[kWarps * 16 * LDS];
  float lse[BT];
  float delta[BT];
};

// The warp's 16 rows of a [BT][DH + 8] shared tile as a WMMA A operand:
// held in registers at Dh = 64, loaded at each use at Dh = 192.
template <int DH>
struct RowsA {
  static constexpr bool kRegs = a_in_regs(DH);
  const bf16* rows;
  FragA regs[kRegs ? DH / 16 : 1];

  __device__ __forceinline__ explicit RowsA(const bf16* r) : rows(r) {
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wmma::load_matrix_sync(regs[kk], r + kk * 16, DH + 8);
    }
  }
  __device__ __forceinline__ void get(FragA& f, int kk) const {
    if constexpr (kRegs) f = regs[kk];
    else wmma::load_matrix_sync(f, rows + kk * 16, DH + 8);
  }
};

// Rows r0.. of a [*, width] bf16 tensor, columns col..col+DH-1, into a
// [BT][DH + 8] tile; rows at or past n and columns at or past dh (a
// ragged head) are zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int r0, int n,
                                          size_t width, int col, int dh) {
  constexpr int LDH = DH + 8;
  for (int c = threadIdx.x; c < BT * DH / 8; c += kThreads) {
    const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
    const bool ok = r0 + r < n && cc < dh;
    sfc::cp_async16(&dst[r * LDH + cc], ok ? base + (r0 + r) * width + col + cc : base, ok);
  }
}

// The warp's 16 x 64 fp32 product of its 16 rows a with the transpose
// of a [64][DH + 8] tile (B col_major), summed over the full depth DH;
// written to out (ld LDS).
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(const RowsA<DH>& a, const bf16* tile,
                                                  float* out) {
  constexpr int LDH = DH + 8;
  if constexpr (RowsA<DH>::kRegs) {
    // Columns outer: one accumulator live beside the A fragments.
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        FragBCol bf;
        wmma::load_matrix_sync(bf, &tile[(j * 16) * LDH + kk * 16], LDH);
        wmma::mma_sync(acc, a.regs[kk], bf, acc);
      }
      wmma::store_matrix_sync(out + j * 16, acc, LDS, wmma::mem_row_major);
    }
  } else {
    // Depth outer: each A fragment loaded from shared memory once.
    FragC acc[BT / 16];
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragA af;
      a.get(af, kk);
#pragma unroll
      for (int j = 0; j < BT / 16; ++j) {
        FragBCol bf;
        wmma::load_matrix_sync(bf, &tile[(j * 16) * LDH + kk * 16], LDH);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BT / 16; ++j)
      wmma::store_matrix_sync(out + j * 16, acc[j], LDS, wmma::mem_row_major);
  }
}

// acc[j] += P (16 x 64 bf16 at p, ld LDP) . tile[:, col0 + 16 j ..] (the
// [64][DH + 8] tile row_major).
template <int DH>
__device__ __forceinline__ void accumulate(FragC (&acc)[DC / 16], const bf16* p,
                                           const bf16* tile, int col0) {
  constexpr int LDH = DH + 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, p + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < DC / 16; ++j) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, &tile[(kk * 16) * LDH + col0 + j * 16], LDH);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// Rounds a warp's 16 x 64 accumulators to bf16 rows row0.. (< n) of dst
// at column col, its first `cols` columns (a ragged head's last chunk is
// narrower), staged through the warp's fp32 tile.
__device__ __forceinline__ void store_rows(FragC (&acc)[DC / 16], float* stage, bf16* dst,
                                           int row0, int n, size_t width, int col, int cols) {
#pragma unroll
  for (int j = 0; j < DC / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32, r = lane / 2, half = lane % 2;
  if (row0 + r < n) {
    bf16* out = dst + (row0 + r) * width + col;
#pragma unroll
    for (int c8 = 0; c8 < DC / 2; c8 += 8) {
      const int c = half * (DC / 2) + c8;
      if (c < cols) *reinterpret_cast<uint4*>(out + c) = sfc::pack_bf16x8(&stage[r * LDS + c]);
    }
  }
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ att,
                            const bf16* __restrict__ datt, const float* __restrict__ lse,
                            const uint8_t* __restrict__ mask, float* __restrict__ delta,
                            bf16* __restrict__ dqkv, int n, int heads, int dh, int n_valid,
                            float scale, float keep) {
  using S = DqSmem<DH>;
  constexpr int LDH = S::LDH;
  constexpr int kChunks = DH / DC;
  extern __shared__ __align__(128) unsigned char dyn[];
  S& sm = *reinterpret_cast<S*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns row r
  const int q0 = (blockIdx.x / kChunks) * BT, col0 = (blockIdx.x % kChunks) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * dh;
  const size_t w3 = 3 * static_cast<size_t>(inner), w1 = inner;
  const bf16* qkv_b = qkv + static_cast<size_t>(b) * n * w3;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * n;

  load_rows<DH>(sm.q, qkv_b, q0, n, w3, h * dh, dh);
  load_rows<DH>(sm.da, datt + static_cast<size_t>(b) * n * w1, q0, n, w1, h * dh, dh);
  load_rows<DH>(sm.k, att + static_cast<size_t>(b) * n * w1, q0, n, w1, h * dh, dh);
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
  if (row < n && half == 0 && col0 == 0) delta[bh + row] = dl;
  const uint8_t* mask_row = kDrop ? mask + (bh + (row < n ? row : 0)) * n : nullptr;
  __syncthreads();  // sm.k (the att tile) is overwritten below

  const RowsA<DH> q_w(&sm.q[warp * 16 * LDH]);
  const RowsA<DH> da_w(&sm.da[warp * 16 * LDH]);
  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* ds_w = &sm.ds[warp * 16 * LDP];
  FragC dq[DC / 16];
#pragma unroll
  for (int j = 0; j < DC / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  const int n_tiles = (n_valid + BT - 1) / BT;  // keys past n_valid add nothing
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    load_rows<DH>(sm.k, qkv_b, k0, n, w3, inner + h * dh, dh);
    load_rows<DH>(sm.v, qkv_b, k0, n, w3, 2 * inner + h * dh, dh);
    sfc::cp_async_commit();
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t<DH>(q_w, sm.k, s_w);    // s = q . k^T
    rows_times_tile_t<DH>(da_w, sm.v, dp_w);  // dp = da . v^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;
      const int key = k0 + c;
      const float p = key < n_valid ? expf(s_w[r * LDS + c] * scale - lse_r) : 0.f;
      float pf, dp = dp_w[r * LDS + c];
      if (kDrop) {
        pf = p;
        dp = (row < n && key < n_valid && mask_row[key]) ? dp / keep : 0.f;
      } else {
        pf = __bfloat162float(__float2bfloat16(p));
      }
      ds_w[r * LDP + c] = __float2bfloat16(pf * (dp - dl) * scale);
    }
    __syncwarp();
    accumulate<DH>(dq, ds_w, sm.k, col0);  // dq += ds . k
    __syncthreads();                       // sm.k / sm.v are overwritten by the next tile
  }
  store_rows(dq, s_w, dqkv + static_cast<size_t>(b) * n * w3, q0 + warp * 16, n, w3,
             h * dh + col0, dh - col0);
}

template <int DH, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                             const float* __restrict__ lse, const uint8_t* __restrict__ mask,
                             const float* __restrict__ delta, bf16* __restrict__ dqkv,
                             int n, int heads, int dh, int n_valid, float scale, float keep) {
  using S = DkvSmem<DH>;
  constexpr int LDH = S::LDH;
  constexpr int kChunks = DH / DC;
  extern __shared__ __align__(128) unsigned char dyn[];
  S& sm = *reinterpret_cast<S*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns key r
  const int k0 = (blockIdx.x / kChunks) * BT, col0 = (blockIdx.x % kChunks) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * dh;
  const size_t w3 = 3 * static_cast<size_t>(inner), w1 = inner;
  const bf16* qkv_b = qkv + static_cast<size_t>(b) * n * w3;
  const bf16* datt_b = datt + static_cast<size_t>(b) * n * w1;
  const size_t bh = (static_cast<size_t>(b) * heads + h) * n;

  load_rows<DH>(sm.k, qkv_b, k0, n, w3, inner + h * dh, dh);
  load_rows<DH>(sm.v, qkv_b, k0, n, w3, 2 * inner + h * dh, dh);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  const RowsA<DH> k_w(&sm.k[warp * 16 * LDH]);
  const RowsA<DH> v_w(&sm.v[warp * 16 * LDH]);
  __syncwarp();  // at Dh = 64 this warp's K and V rows are free from here on
  static_assert(!RowsA<DH>::kRegs || LDH == LDP, "p^T / ds^T go over K / V rows");
  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* pt_w = RowsA<DH>::kRegs ? &sm.k[warp * 16 * LDH] : &sm.pt[warp * 16 * LDP];
  bf16* dst_w = RowsA<DH>::kRegs ? &sm.v[warp * 16 * LDH] : &sm.dst[warp * 16 * LDP];
  const int key = k0 + warp * 16 + r;
  const bool key_ok = key < n_valid;
  FragC dk[DC / 16], dv[DC / 16];
#pragma unroll
  for (int j = 0; j < DC / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  const int n_tiles = (n + BT - 1) / BT;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BT;
    load_rows<DH>(sm.q, qkv_b, q0, n, w3, h * dh, dh);
    load_rows<DH>(sm.da, datt_b, q0, n, w1, h * dh, dh);
    sfc::cp_async_commit();
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const bool ok = q0 + i < n;  // past n: zero q and da rows add nothing
      sm.lse[i] = ok ? lse[bh + q0 + i] : 0.f;
      sm.delta[i] = ok ? delta[bh + q0 + i] : 0.f;
    }
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t<DH>(k_w, sm.q, s_w);    // s^T = k . q^T
    rows_times_tile_t<DH>(v_w, sm.da, dp_w);  // dp^T = v . da^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;  // query q0 + c
      const float p = key_ok ? expf(s_w[r * LDS + c] * scale - sm.lse[c]) : 0.f;
      float pf, dp = dp_w[r * LDS + c];
      if (kDrop) {
        const bool kept = key_ok && q0 + c < n && mask[(bh + q0 + c) * n + key];
        pf = p;
        pt_w[r * LDP + c] = __float2bfloat16(kept ? p / keep : 0.f);
        dp = kept ? dp / keep : 0.f;
      } else {
        const bf16 pn = __float2bfloat16(p);
        pf = __bfloat162float(pn);
        pt_w[r * LDP + c] = pn;
      }
      dst_w[r * LDP + c] = __float2bfloat16(pf * (dp - sm.delta[c]) * scale);
    }
    __syncwarp();
    accumulate<DH>(dv, pt_w, sm.da, col0);  // dv += p^T . da
    accumulate<DH>(dk, dst_w, sm.q, col0);  // dk += ds^T . q
    __syncthreads();                        // sm.q / sm.da / lse / delta are overwritten next
  }
  bf16* out = dqkv + static_cast<size_t>(b) * n * w3;
  store_rows(dk, s_w, out, k0 + warp * 16, n, w3, inner + h * dh + col0, dh - col0);
  __syncwarp();
  store_rows(dv, s_w, out, k0 + warp * 16, n, w3, 2 * inner + h * dh + col0, dh - col0);
}

template <int DH, bool kDrop>
cudaError_t launch(cudaStream_t s, const bf16* qkv, const bf16* att, const bf16* datt,
                   const float* lse, const uint8_t* mask, float* delta, bf16* dqkv,
                   int batch, int n, int heads, int dh, int n_valid, float scale, float keep) {
  auto dq_kernel = attention_bwd_dq_kernel<DH, kDrop>;
  auto dkv_kernel = attention_bwd_dkv_kernel<DH, kDrop>;
  const int dq_smem = static_cast<int>(sizeof(DqSmem<DH>));
  const int dkv_smem = static_cast<int>(sizeof(DkvSmem<DH>));
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dq_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(((n + BT - 1) / BT) * (DH / DC), heads, batch);
  dq_kernel<<<grid, kThreads, dq_smem, s>>>(qkv, att, datt, lse, mask, delta, dqkv, n, heads,
                                            dh, n_valid, scale, keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<<<grid, kThreads, dkv_smem, s>>>(qkv, datt, lse, mask, delta, dqkv, n, heads,
                                              dh, n_valid, scale, keep);
  return cudaGetLastError();
}

}  // namespace

// qkv bf16 [batch, n, 3*heads*dh], att and datt bf16 [batch, n, heads*dh],
// lse fp32 [batch, heads, n]; mask uint8 0/1 [batch, heads, n, n] or null
// (no dropout), with keep in (0, 1]; delta fp32 [batch, heads, n] is
// scratch; dqkv bf16 [batch, n, 3*heads*dh] receives dq, dk and dv (every
// element is written).  Keys at or past n_valid (1 <= n_valid <= n) are
// masked.  dh a multiple of 16 up to 256.
extern "C" int sfc_attention_bwd_bf16(const void* qkv, const void* att, const void* datt,
                                      const void* lse, const void* mask, void* delta,
                                      void* dqkv, int batch, int n, int heads, int dh,
                                      int n_valid, float scale, float keep, void* stream) {
  if (dh < 16 || dh > 256 || dh % 16 || n_valid < 1 || n_valid > n ||
      (mask != nullptr && !(keep > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* a = static_cast<const bf16*>(att);
  const auto* da = static_cast<const bf16*>(datt);
  const auto* ls = static_cast<const float*>(lse);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* dl = static_cast<float*>(delta);
  auto* out = static_cast<bf16*>(dqkv);
  // The instance of the padded width 64 C, with the mask or without.
  auto go = [&](auto DHP) {
    constexpr int P = decltype(DHP)::value;
    return mask ? launch<P, true>(s, q, a, da, ls, mk, dl, out, batch, n, heads, dh, n_valid,
                                  scale, keep)
                : launch<P, false>(s, q, a, da, ls, mk, dl, out, batch, n, heads, dh, n_valid,
                                   scale, keep);
  };
  cudaError_t e;
  switch ((dh + 63) / 64) {
    case 1: e = go(std::integral_constant<int, 64>{}); break;
    case 2: e = go(std::integral_constant<int, 128>{}); break;
    case 3: e = go(std::integral_constant<int, 192>{}); break;
    default: e = go(std::integral_constant<int, 256>{}); break;
  }
  return static_cast<int>(e);
}
