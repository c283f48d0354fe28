// Curve-local attention backward on [B, N, H, Dh] (kernel #13), head dim
// 64, from the forward's fp32 log-sum-exp lse of each query's window and
// delta = rowsum(g * O) (both [B, H, N]).
//
// Replaces: sfc_vit_tpu/ops/local_attention.py::_bwd_kernel (lines
// 198-299; launcher _local_bwd, lines 305-377).  Query i sees exactly the
// keys j with |i / block - j / block| <= halo and j < N.  Over that window:
// s = q . k^T * scale in fp32, p = exp(s - lse), dp = g . v^T in fp32
// (bf16 operands, exact products), ds = p * (dp - delta) * scale; then dq
// = sum over the key window of ds . k, dk = sum over the query-side window
// of ds^T . q and dv = sum over it of p^T . g, each an fp32 sum rounded
// once to bf16.  Like the TPU kernel, p and ds stay fp32: they enter the
// tensor-core products as a two-term bf16 split, p = hi + lo
// (sfc::split_bf16), two bf16 products summed in fp32 (about 16 bits of
// mantissa, against 10 for TF32 at half the bf16 rate).  The TPU kernel
// writes dk and dv in fp32 and its launcher casts them; here the same
// fp32 sums are rounded once as they are stored.
//
// Bound on this card: at block 128, halo 1 the nominal work (12 x 384 x
// 64 flops a row, the TPU kernel's estimate) is ~330 flops a byte of q, k,
// v, g, dq, dk, dv, lse and delta: just above the H100's ~295, so the
// tensor cores bound it, barely; the kernel executes 20 x 64 flops a
// (query, key) pair, as the dQ half recomputes s and dp and the split
// doubles the four fp32-operand products.
// Design: two halves of one grid (blockIdx.z 0: dq of a 64-query tile over
// the key tiles of its window; 1: dk and dv of a 64-key tile over the
// QUERY-side window, the 2 * halo + 1 query blocks whose window holds it):
// scatter as gather, each output row written by one block, no atomics.
// block is a multiple of 64, so a tile lies in one curve block and its
// window is whole tiles.  128 threads, four warps of 16 rows, 64-row tiles
// streamed through shared memory with cp.async (zero-filled past the
// window), logits and dp tiles in fp32 shared memory where a lane pair
// owns a row; the dQ half keeps the warp's Q and G rows in WMMA
// fragments and its dq in accumulators, the dK/dV half its K and V rows
// and dk, dv (s^T = K . Q^T, dp^T = V . G^T).  Shared memory at Dh 64:
// 106 KB.  The streaming flash backward #10 / #11 has its own Hopper
// design in flash_bwd_dq_sm90.cu and flash_bwd_dkv_sm90.cu.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BT = 64;  // rows of a query or key tile
constexpr int kWarps = BT / 16;
constexpr int kThreads = kWarps * 32;
constexpr int LDP = BT + 8;  // bf16 p / ds rows

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct Dims {
  static constexpr int LDH = DH + 8;                  // bf16 tile rows
  static constexpr int LDS = (BT > DH ? BT : DH) + 4;  // fp32 tile / staging rows
};

template <int DH>
struct DqSmem {
  bf16 q[BT * Dims<DH>::LDH];
  bf16 g[BT * Dims<DH>::LDH];
  bf16 k[BT * Dims<DH>::LDH];
  bf16 v[BT * Dims<DH>::LDH];
  bf16 ds_hi[kWarps * 16 * LDP];
  bf16 ds_lo[kWarps * 16 * LDP];
  float s[kWarps * 16 * Dims<DH>::LDS];
  float dp[kWarps * 16 * Dims<DH>::LDS];
};

template <int DH>
struct DkvSmem {
  bf16 k[BT * Dims<DH>::LDH];  // this block's keys
  bf16 v[BT * Dims<DH>::LDH];
  bf16 q[BT * Dims<DH>::LDH];  // the current query tile
  bf16 g[BT * Dims<DH>::LDH];
  bf16 pt_hi[kWarps * 16 * LDP];  // each warp's 16 rows of p^T (keys x queries)
  bf16 pt_lo[kWarps * 16 * LDP];
  bf16 dst_hi[kWarps * 16 * LDP];  // each warp's 16 rows of ds^T
  bf16 dst_lo[kWarps * 16 * LDP];
  float s[kWarps * 16 * Dims<DH>::LDS];
  float dp[kWarps * 16 * Dims<DH>::LDS];
  float lse[BT];
  float delta[BT];
};

template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int r0, int n) {
  sfc::load_tile64<DH, kThreads>(dst, base, row_stride, r0, n);
}

// The warp's 16 x 64 fp32 product of its 16 rows (fragments a) with the
// transpose of a [64][DH + 8] tile (B col_major), written to out.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(const FragA (&a)[DH / 16], const bf16* tile,
                                                  float* out) {
  constexpr int LDH = Dims<DH>::LDH;
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, &tile[(j * 16) * LDH + kk * 16], LDH);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, Dims<DH>::LDS, wmma::mem_row_major);
  }
}

// acc[j] += (hi + lo) . tile[:, 16 j ..]: hi / lo the warp's 16 x 64 bf16
// split (ld LDP), tile a [64][DH + 8] row-major tile.
template <int DH>
__device__ __forceinline__ void accumulate_split(FragC (&acc)[DH / 16], const bf16* hi,
                                                 const bf16* lo, const bf16* tile) {
  constexpr int LDH = Dims<DH>::LDH;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    FragA ah, al;
    wmma::load_matrix_sync(ah, hi + kk * 16, LDP);
    wmma::load_matrix_sync(al, lo + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, &tile[(kk * 16) * LDH + j * 16], LDH);
      wmma::mma_sync(acc[j], ah, bf, acc[j]);
      wmma::mma_sync(acc[j], al, bf, acc[j]);
    }
  }
}

// Rounds a warp's 16 x DH accumulators to bf16 rows row0.. (< n) of a
// contiguous [B, n, heads, DH] output at (b, h), staged through stage.
template <int DH>
__device__ __forceinline__ void store_rows(FragC (&acc)[DH / 16], float* stage, bf16* out,
                                           int b, int h, int heads, int row0, int n) {
  constexpr int LDS = Dims<DH>::LDS;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32, r = lane / 2, half = lane % 2;
  const int row = row0 + r;
  if (row < n) {
    bf16* dst = out + ((static_cast<long long>(b) * n + row) * heads + h) * DH;
#pragma unroll
    for (int c8 = 0; c8 < DH / 2; c8 += 8) {
      const int c = half * (DH / 2) + c8;
      *reinterpret_cast<uint4*>(dst + c) = sfc::pack_bf16x8(&stage[r * LDS + c]);
    }
  }
  __syncwarp();
}

struct Args {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int heads, nq, nk;
  int block, halo;  // the curve block and the window's halo
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh;
  float scale;
};

// The rows [lo, hi) of the other side (n rows in all) that the 64-row
// tile at r0 meets: the window of its curve block.
__device__ __forceinline__ void tile_range(const Args& a, int r0, int n, int& lo, int& hi) {
  const int j = r0 / a.block;
  lo = max(0, (j - a.halo) * a.block);
  hi = min(n, (j + a.halo + 1) * a.block);
}

// dq of the 64 queries at blockIdx.x over the keys of their window.
template <int DH>
__device__ __forceinline__ void dq_tile(const Args& a, unsigned char* dyn) {
  constexpr int LDH = Dims<DH>::LDH, LDS = Dims<DH>::LDS;
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns query row r
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  int lo, hi;
  tile_range(a, q0, a.nk, lo, hi);
  const bf16* kb = a.k + b * a.ksb + h * a.ksh;
  const bf16* vb = a.v + b * a.vsb + h * a.vsh;

  load_tile<DH>(sm.q, a.q + b * a.qsb + h * a.qsh, a.qsn, q0, a.nq);
  load_tile<DH>(sm.g, a.g + b * a.gsb + h * a.gsh, a.gsn, q0, a.nq);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  FragA q_regs[DH / 16], g_regs[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(q_regs[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);
    wmma::load_matrix_sync(g_regs[kk], &sm.g[warp * 16 * LDH + kk * 16], LDH);
  }
  const int row = q0 + warp * 16 + r;
  const bool row_ok = row < a.nq;
  const long long bhn = static_cast<long long>(bh) * a.nq;
  const float lse_r = row_ok ? a.lse[bhn + row] : 0.f;
  const float dl = row_ok ? a.delta[bhn + row] : 0.f;
  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* hi_w = &sm.ds_hi[warp * 16 * LDP];
  bf16* lo_w = &sm.ds_lo[warp * 16 * LDP];
  FragC dq[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  for (int k0 = lo; k0 < hi; k0 += BT) {
    load_tile<DH>(sm.k, kb, a.ksn, k0, hi);
    load_tile<DH>(sm.v, vb, a.vsn, k0, hi);
    sfc::cp_async_commit();
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t<DH>(q_regs, sm.k, s_w);   // s = q . k^T
    rows_times_tile_t<DH>(g_regs, sm.v, dp_w);  // dp = g . v^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;
      const float p =
          row_ok && k0 + c < hi ? expf(s_w[r * LDS + c] * a.scale - lse_r) : 0.f;
      sfc::split_bf16(p * (dp_w[r * LDS + c] - dl) * a.scale, hi_w[r * LDP + c],
                      lo_w[r * LDP + c]);
    }
    __syncwarp();
    accumulate_split<DH>(dq, hi_w, lo_w, sm.k);  // dq += ds . k
    __syncthreads();                             // sm.k / sm.v are overwritten next
  }
  store_rows<DH>(dq, s_w, a.dq, b, h, a.heads, q0 + warp * 16, a.nq);
}

// dk, dv of the 64 keys at blockIdx.x over the query-side window: the
// queries whose window holds them.
template <int DH>
__device__ __forceinline__ void dkv_tile(const Args& a, unsigned char* dyn) {
  constexpr int LDH = Dims<DH>::LDH, LDS = Dims<DH>::LDS;
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns key r
  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  int lo, hi;
  tile_range(a, k0, a.nq, lo, hi);
  const bf16* qb = a.q + b * a.qsb + h * a.qsh;
  const bf16* gb = a.g + b * a.gsb + h * a.gsh;
  const long long bhn = static_cast<long long>(bh) * a.nq;

  load_tile<DH>(sm.k, a.k + b * a.ksb + h * a.ksh, a.ksn, k0, a.nk);
  load_tile<DH>(sm.v, a.v + b * a.vsb + h * a.vsh, a.vsn, k0, a.nk);
  sfc::cp_async_commit();
  sfc::cp_async_wait<0>();
  __syncthreads();

  FragA k_regs[DH / 16], v_regs[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(k_regs[kk], &sm.k[warp * 16 * LDH + kk * 16], LDH);
    wmma::load_matrix_sync(v_regs[kk], &sm.v[warp * 16 * LDH + kk * 16], LDH);
  }
  const bool key_ok = k0 + warp * 16 + r < a.nk;
  float* s_w = &sm.s[warp * 16 * LDS];
  float* dp_w = &sm.dp[warp * 16 * LDS];
  bf16* pth_w = &sm.pt_hi[warp * 16 * LDP];
  bf16* ptl_w = &sm.pt_lo[warp * 16 * LDP];
  bf16* dsh_w = &sm.dst_hi[warp * 16 * LDP];
  bf16* dsl_w = &sm.dst_lo[warp * 16 * LDP];
  FragC dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  for (int q0 = lo; q0 < hi; q0 += BT) {
    load_tile<DH>(sm.q, qb, a.qsn, q0, hi);
    load_tile<DH>(sm.g, gb, a.gsn, q0, hi);
    sfc::cp_async_commit();
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const bool ok = q0 + i < hi;  // past hi: zero q and g rows, p forced to 0
      sm.lse[i] = ok ? a.lse[bhn + q0 + i] : 0.f;
      sm.delta[i] = ok ? a.delta[bhn + q0 + i] : 0.f;
    }
    sfc::cp_async_wait<0>();
    __syncthreads();
    rows_times_tile_t<DH>(k_regs, sm.q, s_w);   // s^T = k . q^T
    rows_times_tile_t<DH>(v_regs, sm.g, dp_w);  // dp^T = v . g^T
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < BT / 2; ++i) {
      const int c = half + 2 * i;  // query q0 + c
      const float p =
          key_ok && q0 + c < hi ? expf(s_w[r * LDS + c] * a.scale - sm.lse[c]) : 0.f;
      sfc::split_bf16(p, pth_w[r * LDP + c], ptl_w[r * LDP + c]);
      sfc::split_bf16(p * (dp_w[r * LDS + c] - sm.delta[c]) * a.scale, dsh_w[r * LDP + c],
                      dsl_w[r * LDP + c]);
    }
    __syncwarp();
    accumulate_split<DH>(dv, pth_w, ptl_w, sm.g);  // dv += p^T . g
    accumulate_split<DH>(dk, dsh_w, dsl_w, sm.q);  // dk += ds^T . q
    __syncthreads();  // q, g, lse, delta and ds^T are overwritten next
  }
  store_rows<DH>(dk, s_w, a.dk, b, h, a.heads, k0 + warp * 16, a.nk);
  store_rows<DH>(dv, s_w, a.dv, b, h, a.heads, k0 + warp * 16, a.nk);
}

// The dQ half (blockIdx.z 0) and the dK/dV half (1) of one grid.
template <int DH>
__global__ void __launch_bounds__(kThreads) local_bwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  if (blockIdx.z == 0)
    dq_tile<DH>(a, dyn);
  else
    dkv_tile<DH>(a, dyn);
}

}  // namespace

// q and g bf16 [batch, n, heads, dh], k and v bf16 [batch, n, heads, dh],
// each read through its (batch, row, head) strides in elements (unit
// stride along dh, rows 16-byte aligned); lse and delta fp32 [batch,
// heads, n]; dq, dk, dv bf16 [batch, n, heads, dh] contiguous.  dh must be
// 64, block a positive multiple of 64, halo >= 1.
extern "C" int sfc_local_bwd_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dq, void* dk,
                                  void* dv, int batch, int heads, int n, int dh, int block,
                                  int halo, long long qsb, long long qsn, long long qsh,
                                  long long ksb, long long ksn, long long ksh, long long vsb,
                                  long long vsn, long long vsh, long long gsb, long long gsn,
                                  long long gsh, float scale, void* stream) {
  if (dh != 64 || n < 1 || heads < 1 || batch < 0 || block < BT || block % BT || halo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.heads = heads;
  a.nq = a.nk = n;
  a.block = block;
  a.halo = halo;
  a.qsb = qsb, a.qsn = qsn, a.qsh = qsh;
  a.ksb = ksb, a.ksn = ksn, a.ksh = ksh;
  a.vsb = vsb, a.vsn = vsn, a.vsh = vsh;
  a.gsb = gsb, a.gsn = gsn, a.gsh = gsh;
  a.scale = scale;
  static_assert(sizeof(DkvSmem<64>) >= sizeof(DqSmem<64>), "one size for both halves");
  constexpr int smem = static_cast<int>(sizeof(DkvSmem<64>));
  cudaError_t e = cudaFuncSetAttribute(local_bwd_kernel<64>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  local_bwd_kernel<64><<<dim3((n + BT - 1) / BT, batch * heads, 2), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
