// Streaming flash attention backward, dQ (kernel #10), redesigned for
// Hopper, on [B, N, H, Dh] with head dim 64 (128 and 256 below), from
// the forward's fp32 log-sum-exp lse and delta = rowsum(g * O) (both [B,
// H, Nq]).
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_dq_kernel (lines
// 440-479), launched by _streaming_bwd past _FUSED_BWD_MAX.  With s = q .
// k^T * scale in fp32, keys at or past nk giving p = 0, p = exp(s - lse),
// dp = g . v^T in fp32 (bf16 operands, exact products) and ds = p * (dp -
// delta) * scale: dq = sum over keys of ds . k, an fp32 sum rounded once
// to bf16.  Like the TPU kernel, ds stays fp32: it enters the tensor-core
// product as a two-term bf16 split, ds = hi + lo (two bf16 products summed
// in fp32, about 16 bits of mantissa), so the kernel executes 8 x
// B.H.Nq.Nk.Dh operations against the nominal 6.
//
// Bound on this card: at [2, 16384, 6, 64] the nominal 6 x 2 x 6 x 16384^2
// x 64 = 1.24 TFLOP on ~30 MB: tensor-core bound.
// Design: the dK/dV kernel #11's loop transposed: one block per (128-query
// tile, b * h), two consumer warpgroups of 64 queries each and one
// producer warp (nine warps: at most 168 registers a thread).  Q and G
// come once by TMA into 128-byte-swizzled shared memory; the producer
// keeps 64-key K and V tiles in flight through a ring of kStages stages
// (TMA, mbarriers).  Each thread reads lse and delta of its two query rows
// once, into registers.  Per key tile each warpgroup computes s = Q.K^T
// and dp = G.V^T by wgmma into registers, forms ds there and splits it
// into hi / lo bf16 registers, the A operand of dq += ds.K (K [keys][dh]
// through the transpose bit).  dq stays in registers across the whole key
// loop and is rounded once at the end by the block that owns its rows: no
// fp32 buffer, no atomics, the same result on every run.
//
// The windowed instance (kWindow) is the dQ half of the curve-local
// backward #13: sfc_vit_tpu/ops/local_attention.py::_bwd_kernel (lines
// 198-299, called at :341), scatter as gather, dq of a query block over
// the 2 halo + 1 key blocks of its window (:68-71), with the same p, dp
// and ds.  block is a multiple of 64, so each warpgroup's 64 rows lie in
// one curve block and its window is whole 64-key tiles
// (sm90.cuh::local_tile_window, ops/_build.py::local_tile_window).  The
// block walks the union of its two warpgroups' windows (they differ where
// a 128-query tile straddles two curve blocks: block 64 or 192); the
// producer marks in each ring slot which warpgroups' windows hold its
// tile, and a warpgroup waits for each tile outside its own window and
// releases it unread, so the ring's phases stay in step.  At [2, 16384, 6,
// 64], block 128, halo 1 a block walks 6 key tiles instead of 256: the
// window holds 2.3 % of the square's (query, key) pairs, 29 nominal GFLOP
// of dq.  A persistent form of this instance (blocks walking (b * h,
// 128-query block) items, the next item's Q and G in flight) took it from
// 0.140 to 0.114 ms on an H100 at 700 W, but its item loop around the
// shared code made #10's full-range instance 6.5 % slower there, so the
// instance stays one block per item.
//
// Head dims 128 and 256 (flash_bwd_dq_wide_sm90; flash_wide.cuh's
// bwd_wide): the same formula, over every key or the window, on C = Dh /
// 64 sub-heads, in one walk over the key tiles.  A block is two
// warpgroups over 64 queries (one block an SM); Q and G stay resident; a
// ring of whole 64-key K / V tiles (4 stages at Dh 128, 2 at 256) comes by
// TMA.  Per key tile, once: s and dp of each warpgroup's 32 keys against
// the 64 queries (m64n32), ds split into bf16 hi + lo and written to two
// exchange tiles in shared memory, then each warpgroup adds ds K into its
// half of dq's columns (C / 2 sub-heads, 32 C fp32 registers): 8 x
// B.H.Nq.Nk.Dh executed operations at every head dim, each K and V
// sub-block read once from its stage.  The next tile's s and
// dp are issued with this tile's ds K, so at Dh 128 the exp2 and the
// split run beside the products.  Bound at [2, 16384, 3, 128]: the
// nominal 6 x 2 x 3 x 16384^2 x 128 = 1.24 TFLOP, 1.251 ms at 989
// TFLOP/s; at [1, 8300 x 9000, 2, 256] 0.232 ms.  Each dq row and column
// has one owner and one fp32 sum in a fixed order: the same bits on every
// call.

#include "flash_wide.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BQ = 128;  // queries per block: two warpgroups of 64 rows
constexpr int BKT = 64;  // keys per tile of the loop
constexpr int kStages = 6;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kTileBytes = BKT * 128;              // 64 rows of 64 bf16
using hw::kLog2e;
using Ring = hw::Ring<kStages>;

struct Smem {
  unsigned char q[BQ * 128];
  unsigned char g[BQ * 128];
  unsigned char k[kStages][kTileBytes];
  unsigned char v[kStages][kTileBytes];
  uint64_t qg_full, full[kStages], empty[kStages];
  uint32_t own[kStages];  // the windowed instance: bit w, warpgroup w's window holds the tile
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap q, k, v, g;
  const float *lse, *delta;
  bf16* dq;
  int heads, nq, nk;
  int block, halo;  // the windowed instance's curve block and halo
  float scale, scale_log2;
};

// kWindow: #13's instance, over the curve-local window of each query
// block (nq == nk); otherwise #10's, over every key.
template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  // The key tiles [t0, t1) the block walks: every one, or its two
  // warpgroups' windows together.
  int t0 = 0, t1 = (p.nk + BKT - 1) / BKT;
  if constexpr (kWindow) hw::local_tile_window(q0 / BKT, BQ, p.nk, p.block, p.halo, t0, t1);

  if (tid == 0) {
    hw::bar_init(&sm.qg_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], kConsumerWarps);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      hw::bar_expect_tx(&sm.qg_full, 2 * BQ * 128);
      hw::tma_load4(sm.q, &p.q, &sm.qg_full, 0, h, q0, b);
      hw::tma_load4(sm.g, &p.g, &sm.qg_full, 0, h, q0, b);
      // Each warpgroup's own window (its 64 queries' curve block; none for
      // queries wholly past nq).
      int w[2][2] = {{t0, t1}, {0, 0}};
      if constexpr (kWindow) {
        hw::local_tile_window(q0 / BKT, 64, p.nk, p.block, p.halo, w[0][0], w[0][1]);
        if (q0 + 64 < p.nq)
          hw::local_tile_window(q0 / BKT + 1, 64, p.nk, p.block, p.halo, w[1][0], w[1][1]);
      }
      Ring r;
      for (int t = t0; t < t1; ++t, r.next()) {
        hw::bar_wait(&sm.empty[r.slot], r.phase ^ 1);  // the first pass finds every slot free
        if constexpr (kWindow)  // released to the consumers by the arrival below
          sm.own[r.slot] = (w[0][0] <= t && t < w[0][1]) | (w[1][0] <= t && t < w[1][1]) << 1;
        hw::bar_expect_tx(&sm.full[r.slot], 2 * kTileBytes);
        hw::tma_load4(sm.k[r.slot], &p.k, &sm.full[r.slot], 0, h, t * BKT, b);
        hw::tma_load4(sm.v[r.slot], &p.v, &sm.full[r.slot], 0, h, t * BKT, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the
  // block; in s, dp and dq this thread holds rows qr and qr + 8, in s and
  // dp columns (keys) 8 j + c0 + {0, 1}.  Queries at or past nq need no
  // mask: a row of dq reads only its own row of s and dp, and such rows
  // are never stored (their lse and delta read as 0).
  const int wg = warp / 4;
  const int qr = wg * 64 + (warp % 4) * 16 + lane / 4;  // within the block's 128
  const int c0 = 2 * (lane % 4);
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + qr + 8 * hf;
    const long long at = static_cast<long long>(bh) * p.nq + row;
    lse2[hf] = row < p.nq ? p.lse[at] * kLog2e : 0.f;
    dl[hf] = row < p.nq ? p.delta[at] : 0.f;
  }
  const uint64_t qdesc = hw::desc_sw128(sm.q + wg * 64 * 128);
  const uint64_t gdesc = hw::desc_sw128(sm.g + wg * 64 * 128);
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  hw::bar_wait(&sm.qg_full, 0);

  Ring r;
  for (int t = t0; t < t1; ++t, r.next()) {
    hw::bar_wait(&sm.full[r.slot], r.phase);
    if constexpr (kWindow) {
      if (!(sm.own[r.slot] >> wg & 1u)) {  // another warpgroup's tile: released unread
        if (lane == 0) hw::bar_arrive(&sm.empty[r.slot]);
        continue;
      }
    }
    const uint64_t kdesc = hw::desc_sw128(sm.k[r.slot]), vdesc = hw::desc_sw128(sm.v[r.slot]);
    float s[32], dp[32];
    hw::fence_regs(s);
    hw::fence_regs(dp);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_ss<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_ss<0, 0>(dp, gdesc + 2 * kk, vdesc + 2 * kk, kk);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_regs(dp);

    // ds = exp(s - lse) (dp - delta) scale, in place in dp.  Keys at or
    // past nk (zero K and V rows: s = 0, p = exp(-lse) otherwise) give p
    // = 0: dq sums over them.
    const bool ragged_k = (t + 1) * BKT > p.nk;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool k_ok = !ragged_k || t * BKT + 8 * jj + c0 + e < p.nk;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * jj + 2 * hf + e;
          const float pv = k_ok ? hw::exp2_approx(s[i] * p.scale_log2 - lse2[hf]) : 0.f;
          dp[i] = pv * (dp[i] - dl[hf]) * p.scale;
        }
      }

    // dq += ds . K: ds's split from registers, K [keys][dh] through the
    // transpose bit.
    uint32_t dsh[4][4], dsl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::split_a(dp, kk, dsh[kk], dsl[kk]);
    hw::fence_regs(dq);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dq, dsh[kk], kdesc + kk * (2048 >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dq, dsl[kk], kdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dq);
    hw::fence_frags(dsh);
    hw::fence_frags(dsl);
    if (lane == 0) hw::bar_arrive(&sm.empty[r.slot]);  // K and V read
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + qr + 8 * hf;
    if (row >= p.nq) continue;
    bf16* dst = p.dq + ((static_cast<long long>(b) * p.nq + row) * p.heads + h) * 64 + c0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          hw::pack_bf16x2(dq[4 * jj + 2 * hf], dq[4 * jj + 2 * hf + 1]);
  }
}

namespace fw = sfc::flash_wide;

// C: sub-heads (2 or 4).  kWindow: #13's dq over the block's key window.
template <int C, bool kWindow>
__global__ void __launch_bounds__(fw::kBwdThreads, 1)
    flash_bwd_dq_wide_sm90(const __grid_constant__ fw::BwdParams p) {
  fw::bwd_wide<C, false, kWindow>(p);
}

// The wide instances' call (dh 128 or 256).
int run_wide(const void* q, const void* k, const void* v, const void* g, const void* lse,
             const void* delta, void* dq, int batch, int heads, int nq, int nk, int dh,
             const long long (&st)[12], float scale, int block, int halo, void* stream) {
  fw::BwdParams p{};
  cudaError_t e = fw::bwd_params(&p, q, k, v, g, lse, delta, dq, nullptr, batch, heads, nq, nk, dh,
                                 st, scale, block, halo);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  fw::with_wide(dh, [&](auto C) {
    constexpr int c = decltype(C)::value, smem = fw::kBwdSmemBytes<c, false>;
    e = block ? fw::launch_bwd(flash_bwd_dq_wide_sm90<c, true>, smem, p, batch, s)
              : fw::launch_bwd(flash_bwd_dq_wide_sm90<c, false>, smem, p, batch, s);
  });
  return static_cast<int>(e);
}

}  // namespace

// q and g bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh],
// each read through its (batch, row, head) strides in elements (unit
// stride along dh; strides multiples of 8 elements, bases on 16 bytes, as
// TMA requires); lse and delta fp32 [batch, heads, nq] contiguous.  dq
// bf16 [batch, nq, heads, dh] contiguous.  dh 64, 128 or 256.
// block > 0 takes #13's windowed instance: query i meets the keys j with
// |i / block - j / block| <= halo, block a multiple of 64, halo >= 1, nq ==
// nk; block 0 (#10) meets every key.
extern "C" int sfc_flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int batch,
                                 int heads, int nq, int nk, int dh, long long qsb,
                                 long long qsn, long long qsh, long long ksb, long long ksn,
                                 long long ksh, long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh, float scale,
                                 int block, int halo, void* stream) {
  const bool window = block != 0;
  if ((dh != 64 && dh != 128 && dh != 256) || nq < 1 || nk < 1 || heads < 1 || batch < 0 ||
      (window && (block < 0 || block % 64 || halo < 1 || nq != nk)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (dh != 64) {
    const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
    return run_wide(q, k, v, g, lse, delta, dq, batch, heads, nq, nk, dh, st, scale, block, halo,
                    stream);
  }
  Params p{};
  cudaError_t e = hw::map_bnhd(&p.q, q, batch, nq, heads, qsb, qsn, qsh, BQ);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.g, g, batch, nq, heads, gsb, gsn, gsh, BQ);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.k, k, batch, nk, heads, ksb, ksn, ksh, BKT);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.v, v, batch, nk, heads, vsb, vsn, vsh, BKT);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.block = block;
  p.halo = halo;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  auto kernel = window ? flash_bwd_dq_sm90<true> : flash_bwd_dq_sm90<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nq + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of #10's kernel (#13's windowed
// instance where `windowed`), into out[3].
extern "C" int sfc_flash_dq_attrs(int windowed, int* out) {
  return windowed ? hw::kernel_attrs(flash_bwd_dq_sm90<true>, kSmemBytes, out)
                  : hw::kernel_attrs(flash_bwd_dq_sm90<false>, kSmemBytes, out);
}

// The same for the instances at dh 128 and 256.
extern "C" int sfc_flash_dq_wide_attrs(int dh, int windowed, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  fw::with_wide(dh, [&](auto C) {
    constexpr int c = decltype(C)::value, smem = fw::kBwdSmemBytes<c, false>;
    err = windowed ? hw::kernel_attrs(flash_bwd_dq_wide_sm90<c, true>, smem, out)
                   : hw::kernel_attrs(flash_bwd_dq_wide_sm90<c, false>, smem, out);
  });
  return err;
}
