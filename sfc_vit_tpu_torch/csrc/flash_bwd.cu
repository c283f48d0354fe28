// Flash attention backward on [B, N, H, Dh], head dim 64: the streaming
// dQ kernel (#10), the streaming dK/dV kernel (#11) and the one-pass
// fused kernel (#9), from the forward's fp32 log-sum-exp lse and
// delta = rowsum(g * O) (both [B, H, Nq]).
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_dq_kernel (lines
// 440-479), ::_dkv_kernel (lines 482-530) and ::_fused_bwd_kernel (lines
// 317-373).  The arithmetic of all three: s = q . k^T * scale in fp32,
// keys at or past nk give p = 0, p = exp(s - lse), dp = g . v^T in fp32
// (bf16 operands, exact products), ds = p * (dp - delta) * scale; then
// dq = sum over keys of ds . k, dk = sum over queries of ds^T . q and
// dv = sum over queries of p^T . g, each an fp32 sum rounded once to
// bf16 (#9's dq: an fp32 buffer the caller rounds).  Like the TPU
// kernels, p and ds stay fp32: they enter the tensor-core products as a
// two-term bf16 split, p = hi + lo (sfc::split_bf16), two bf16 products
// summed in fp32 (about 16 bits of mantissa, against 10 for TF32 at half
// the bf16 rate).  #9 departs from the TPU's _fused_bwd_kernel in two
// places, both at the level of fp32 or bf16 ulps: p = exp(s - lse) from
// the forward's lse where the TPU kernel divides by its own row sum, and
// delta = rowsum(g * O) over the bf16 output where it takes
// rowsum(dp * p) in fp32.  Its dq is summed with fp32 atomics, in an
// order that changes from run to run.
//
// Bound on this card: one (b, h) at N = 16,384 is 6 (dQ) + 8 (dK/dV)
// = 14 x 16384^2 x 64 = 240 GFLOP nominal (the TPU kernels' cost
// estimate) on ~10 MB of operands: tensor-core bound.  The split doubles
// the four fp32-operand products' tensor work.
// Design: the TPU walked the (q tile, k tile) grid in order with VMEM
// scratch; Hopper blocks run in no order, so each output is owned by one
// block that loops over the other axis.  128 threads, four warps of 16
// rows, 64-row tiles streamed through shared memory with cp.async
// (zero-filled past the sequence ends), logits and dp tiles in fp32
// shared memory where a lane pair owns a row.
//  * dQ (#10): one block per (64-query tile, b * h); the warp's Q and G
//    rows stay in WMMA fragments, its dq in accumulators over the keys.
//  * dK/dV (#11): one block per (64-key tile, b * h), transposed:
//    s^T = K . Q^T and dp^T = V . G^T, so each warp owns 16 keys (K and V
//    in fragments, dk and dv in accumulators) and nothing is shared
//    between blocks.
//  * fused (#9): #11's loop; after each query tile every warp's ds^T
//    rows together hold the block's 64 x 64 ds^T, which a col-major A
//    operand reads as ds; each warp forms dq for 16 of the tile's queries
//    (ds . K) and adds it to the fp32 dq buffer with atomics.  The logits
//    are computed once per (query, key) pair, as the TPU kernel intends.
// Shared memory at Dh 64: 88 KB (dQ), 106 KB (dK/dV and fused).

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
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
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
  bf16 dst_hi[kWarps * 16 * LDP];  // ds^T; the four warps' rows make the block's 64 x 64
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
  float* dq32;       // fused: fp32 [B, nq, H, DH], accumulated with atomics
  bf16 *dq, *dk, *dv;
  int heads, nq, nk;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh;
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args a) {
  constexpr int LDH = Dims<DH>::LDH, LDS = Dims<DH>::LDS;
  extern __shared__ __align__(128) unsigned char dyn[];
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns query row r
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
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

  const int n_tiles = (a.nk + BT - 1) / BT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    load_tile<DH>(sm.k, kb, a.ksn, k0, a.nk);
    load_tile<DH>(sm.v, vb, a.vsn, k0, a.nk);
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
          row_ok && k0 + c < a.nk ? expf(s_w[r * LDS + c] * a.scale - lse_r) : 0.f;
      sfc::split_bf16(p * (dp_w[r * LDS + c] - dl) * a.scale, hi_w[r * LDP + c],
                      lo_w[r * LDP + c]);
    }
    __syncwarp();
    accumulate_split<DH>(dq, hi_w, lo_w, sm.k);  // dq += ds . k
    __syncthreads();                             // sm.k / sm.v are overwritten next
  }
  store_rows<DH>(dq, s_w, a.dq, b, h, a.heads, q0 + warp * 16, a.nq);
}

// #11 and, with kFused, #9.
template <int DH, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Args a) {
  constexpr int LDH = Dims<DH>::LDH, LDS = Dims<DH>::LDS;
  extern __shared__ __align__(128) unsigned char dyn[];
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // lane pair (2r, 2r+1) owns key r
  const int k0 = blockIdx.x * BT, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
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

  const int n_tiles = (a.nq + BT - 1) / BT;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BT;
    load_tile<DH>(sm.q, qb, a.qsn, q0, a.nq);
    load_tile<DH>(sm.g, gb, a.gsn, q0, a.nq);
    sfc::cp_async_commit();
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const bool ok = q0 + i < a.nq;  // past nq: zero q and g rows, p forced to 0
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
      const float p = key_ok && q0 + c < a.nq
                          ? expf(s_w[r * LDS + c] * a.scale - sm.lse[c])
                          : 0.f;
      sfc::split_bf16(p, pth_w[r * LDP + c], ptl_w[r * LDP + c]);
      sfc::split_bf16(p * (dp_w[r * LDS + c] - sm.delta[c]) * a.scale, dsh_w[r * LDP + c],
                      dsl_w[r * LDP + c]);
    }
    if constexpr (kFused) {
      __syncthreads();  // every warp's ds^T rows: the block's 64 keys x 64 queries
      // dq of queries q0 + 16 warp .. += ds . K: ds (queries x keys) is
      // ds^T read as a col-major A operand.
      FragC dq[DH / 16];
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(dq[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragACol ah, al;
        wmma::load_matrix_sync(ah, &sm.dst_hi[(kk * 16) * LDP + warp * 16], LDP);
        wmma::load_matrix_sync(al, &sm.dst_lo[(kk * 16) * LDP + warp * 16], LDP);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
          FragBRow bf;
          wmma::load_matrix_sync(bf, &sm.k[(kk * 16) * LDH + j * 16], LDH);
          wmma::mma_sync(dq[j], ah, bf, dq[j]);
          wmma::mma_sync(dq[j], al, bf, dq[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < DH / 16; ++j)
        wmma::store_matrix_sync(s_w + j * 16, dq[j], LDS, wmma::mem_row_major);
      __syncwarp();
      const int row = q0 + warp * 16 + r;
      if (row < a.nq) {
        float* dst = a.dq32 + ((static_cast<long long>(b) * a.nq + row) * a.heads + h) * DH;
#pragma unroll 8
        for (int c = half * (DH / 2); c < (half + 1) * (DH / 2); ++c)
          atomicAdd(dst + c, s_w[r * LDS + c]);
      }
    } else {
      __syncwarp();
    }
    accumulate_split<DH>(dv, pth_w, ptl_w, sm.g);  // dv += p^T . g
    accumulate_split<DH>(dk, dsh_w, dsl_w, sm.q);  // dk += ds^T . q
    __syncthreads();  // q, g, lse, delta and ds^T are overwritten next
  }
  store_rows<DH>(dk, s_w, a.dk, b, h, a.heads, k0 + warp * 16, a.nk);
  store_rows<DH>(dv, s_w, a.dv, b, h, a.heads, k0 + warp * 16, a.nk);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int tiles, int bh, cudaStream_t s, const Args& a) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, bh), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, int heads, int nq, int nk, const long long* st,
               float scale) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.qsb = st[0], a.qsn = st[1], a.qsh = st[2];
  a.ksb = st[3], a.ksn = st[4], a.ksh = st[5];
  a.vsb = st[6], a.vsn = st[7], a.vsh = st[8];
  a.gsb = st[9], a.gsn = st[10], a.gsh = st[11];
  a.scale = scale;
  return a;
}

bool bad(int batch, int heads, int nq, int nk, int dh) {
  return dh != 64 || nq < 1 || nk < 1 || heads < 1 || batch < 0;
}

}  // namespace

// Common arguments: q and g bf16 [batch, nq, heads, dh], k and v bf16
// [batch, nk, heads, dh], each read through its (batch, row, head) strides
// in elements (unit stride along dh, rows 16-byte aligned); lse and delta
// fp32 [batch, heads, nq].  Outputs are contiguous [batch, n, heads, dh].
// dh must be 64.

// #10: dq bf16 [batch, nq, heads, dh].
extern "C" int sfc_flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int batch,
                                 int heads, int nq, int nk, int dh, long long qsb,
                                 long long qsn, long long qsh, long long ksb, long long ksn,
                                 long long ksh, long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh, float scale,
                                 void* stream) {
  if (bad(batch, heads, nq, nk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  Args a = make_args(q, k, v, g, lse, delta, heads, nq, nk, st, scale);
  a.dq = static_cast<bf16*>(dq);
  return static_cast<int>(launch(flash_dq_kernel<64>, static_cast<int>(sizeof(DqSmem<64>)),
                                 (nq + BT - 1) / BT, batch * heads,
                                 static_cast<cudaStream_t>(stream), a));
}

// #11: dk, dv bf16 [batch, nk, heads, dh].
extern "C" int sfc_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int batch, int heads, int nq, int nk, int dh, long long qsb,
                                  long long qsn, long long qsh, long long ksb, long long ksn,
                                  long long ksh, long long vsb, long long vsn, long long vsh,
                                  long long gsb, long long gsn, long long gsh, float scale,
                                  void* stream) {
  if (bad(batch, heads, nq, nk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  Args a = make_args(q, k, v, g, lse, delta, heads, nq, nk, st, scale);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return static_cast<int>(launch(flash_dkv_kernel<64, false>,
                                 static_cast<int>(sizeof(DkvSmem<64>)), (nk + BT - 1) / BT,
                                 batch * heads, static_cast<cudaStream_t>(stream), a));
}

// #9: dq32 fp32 [batch, nq, heads, dh], zeroed by the caller and summed
// into with atomics; dk, dv bf16 [batch, nk, heads, dh].
extern "C" int sfc_flash_fused_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dq32, void* dk, void* dv, int batch, int heads,
                                        int nq, int nk, int dh, long long qsb, long long qsn,
                                        long long qsh, long long ksb, long long ksn,
                                        long long ksh, long long vsb, long long vsn,
                                        long long vsh, long long gsb, long long gsn,
                                        long long gsh, float scale, void* stream) {
  if (bad(batch, heads, nq, nk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  Args a = make_args(q, k, v, g, lse, delta, heads, nq, nk, st, scale);
  a.dq32 = static_cast<float*>(dq32);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return static_cast<int>(launch(flash_dkv_kernel<64, true>,
                                 static_cast<int>(sizeof(DkvSmem<64>)), (nk + BT - 1) / BT,
                                 batch * heads, static_cast<cudaStream_t>(stream), a));
}
