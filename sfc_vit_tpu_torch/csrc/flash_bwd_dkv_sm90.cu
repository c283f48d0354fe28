// Streaming flash attention backward, dK and dV (kernel #11), redesigned
// for Hopper, on [B, N, H, Dh] with head dim 64 (128 and 256 below),
// from the forward's fp32 log-sum-exp lse and delta = rowsum(g * O) (both
// [B, H, Nq]).
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_dkv_kernel (lines
// 482-530), launched by _streaming_bwd past _FUSED_BWD_MAX.  With s = q .
// k^T * scale in fp32, queries at or past nq giving p = 0, p = exp(s -
// lse), dp = g . v^T in fp32 (bf16 operands, exact products) and ds = p *
// (dp - delta) * scale: dk = sum over queries of ds^T . q and dv = sum over
// queries of p^T . g, each an fp32 sum rounded once to bf16.  Like the TPU
// kernel, p and ds stay fp32: they enter the tensor-core products as a
// two-term bf16 split, x = hi + lo (two bf16 products summed in fp32,
// about 16 bits of mantissa), so the kernel executes 12 x B.H.Nq.Nk.Dh
// operations against the nominal 8.
//
// Bound on this card: at [2, 16384, 6, 64] the nominal 8 x 2 x 6 x 16384^2
// x 64 = 1.65 TFLOP on ~30 MB: tensor-core bound.
// Design: the fused backward #9 (flash_bwd_fused_sm90.cu) without its dQ,
// with a producer warp.  One block per (128-key tile, b * h): two consumer
// warpgroups of 64 keys each and one producer warp (nine warps: at most
// 168 registers a thread, which the consumers fit without dQ; #9 needs
// 203).  K and V come once by TMA into 128-byte-swizzled shared memory;
// the producer brings 64-query tiles of Q and G with their lse / delta
// rows through a ring of kStages stages (TMA, mbarriers).  Per query tile
// each warpgroup computes s^T = K.Q^T and dp^T = V.G^T by wgmma into
// registers, forms p and ds for its own elements and splits them into hi
// / lo bf16 registers, the A operand of dK += ds^T.Q and dV += p^T.G (Q
// and G read through the transpose bit).  dK and dV stay in registers
// across the whole query loop and are rounded once at the end: each
// output row has one owner, no reduce-add, the same result on every run.
//
// The windowed instance (kWindow) is the dK/dV half of the curve-local
// backward #13: sfc_vit_tpu/ops/local_attention.py::_bwd_kernel (lines
// 198-299, called at :341), scatter as gather, dk and dv of a key block
// over the 2 halo + 1 query blocks whose window holds it (the window is
// symmetric: :68-71), with the same p and ds.  block is a multiple of
// 64, so each warpgroup's 64 keys lie in one curve block and its query
// window is whole 64-query tiles (sm90.cuh::local_tile_window,
// ops/_build.py::local_tile_window).  The block walks the union of its
// two warpgroups' windows; the producer marks in each ring slot which
// warpgroups' windows hold its tile (bits beside the tile), and a
// warpgroup takes p = 0 on a tile outside its own, so it adds nothing.
// The two windows differ only where a 128-key block straddles two curve
// blocks (block 64 or 192, off the main paths), and a branch around such a
// tile, or the window bounds held in registers, spilled at the nine warps'
// 168 registers a thread.  lse and
// delta keep their boxes from the tile's first row rounded down to 16
// bytes (ROADMAP F2).  At [2, 16384, 6, 64], block 128, halo 1: 6 query
// tiles a block instead of 256, 38 nominal GFLOP of dk and dv.  Unlike
// #13's dq instance it stays one block per (128-key block, b * h): its
// persistent form spilled at the nine warps' 168 registers a thread.
//
// Head dims 128 and 256 (flash_bwd_dkv_wide_sm90; flash_wide.cuh's
// bwd_wide): the same formula, over every query or the window, on C = Dh
// / 64 sub-heads, in one walk over the query tiles.  A block is two
// warpgroups over 64 keys (one block an SM); K and V stay resident; a ring
// of whole 64-query Q / G tiles with their lse and delta rows (a TMA box
// each, a stage ahead of their use: 4 stages at Dh 128, 2 at 256) comes by
// TMA.  Per query tile, once: s^T and dp^T of each warpgroup's 32 queries
// against the 64 keys (m64n32), p and ds split into bf16 hi + lo and
// written to four exchange tiles in shared memory, then each warpgroup
// adds ds^T Q and p^T G into its half of dk's and dv's columns (C / 2
// sub-heads each: 64 C fp32 registers, 128 at Dh 256, where a warpgroup
// holding all of dk and dv would need 256): 12 x B.H.Nq.Nk.Dh executed
// operations at every head dim, each Q and G sub-block read once from its
// stage.  The next tile's s^T and dp^T are issued
// with this tile's products, so at Dh 128 the exp2 and the splits run
// beside them.  Bound at [2, 16384, 3, 128]: the nominal 8 x 2 x 3 x
// 16384^2 x 128 = 1.65 TFLOP, 1.668 ms at 989 TFLOP/s; at [1, 8300 x
// 9000, 2, 256] 0.309 ms.  Each dk and dv row and column has one owner
// and one fp32 sum in a fixed order: the same bits on every call.

#include "flash_wide.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BKEYS = 128;  // keys per block: two warpgroups of 64
constexpr int BQT = 64;     // queries per tile of the loop
constexpr int kStages = 6;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kQTileBytes = BQT * 128;
static_assert(BQT == 64, "hw::kRowBox is a 64-row tile's box");
using hw::kLog2e;
using hw::kRowBox;
using hw::kRowSlot;
using Ring = hw::Ring<kStages>;

struct Smem {
  unsigned char k[BKEYS * 128];
  unsigned char v[BKEYS * 128];
  unsigned char q[kStages][kQTileBytes];
  unsigned char g[kStages][kQTileBytes];
  float lse[kStages][kRowSlot];
  float delta[kStages][kRowSlot];
  uint32_t own[kStages];  // the windowed instance: bit w, warpgroup w's window holds the tile
  uint64_t kv_full, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap q, k, v, g, lse, delta;
  bf16 *dk, *dv;
  int heads, nq, nk;
  int block, halo;  // the windowed instance's curve block and halo
  float scale, scale_log2;
};

// kWindow: #13's instance, over the query-side window of each key block
// (nq == nk); otherwise #11's, over every query.
template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BKEYS, bh = blockIdx.y;
  // The query tiles [j0, j1) the block walks: every one, or its two
  // warpgroups' windows together.
  int j0 = 0, j1 = (p.nq + BQT - 1) / BQT;
  if constexpr (kWindow) hw::local_tile_window(k0 / BQT, BKEYS, p.nq, p.block, p.halo, j0, j1);

  if (tid == 0) {
    hw::bar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], kConsumerWarps);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      const int b = bh / p.heads, h = bh % p.heads;
      hw::bar_expect_tx(&sm.kv_full, 2 * BKEYS * 128);
      hw::tma_load4(sm.k, &p.k, &sm.kv_full, 0, h, k0, b);
      hw::tma_load4(sm.v, &p.v, &sm.kv_full, 0, h, k0, b);
      // Each warpgroup's own window (its 64 keys' curve block; none for
      // keys wholly past nk).
      int w[2][2] = {{j0, j1}, {0, 0}};
      if constexpr (kWindow) {
        hw::local_tile_window(k0 / BQT, 64, p.nq, p.block, p.halo, w[0][0], w[0][1]);
        if (k0 + 64 < p.nk)
          hw::local_tile_window(k0 / BQT + 1, 64, p.nq, p.block, p.halo, w[1][0], w[1][1]);
      }
      Ring r;
      for (int j = j0; j < j1; ++j, r.next()) {
        hw::bar_wait(&sm.empty[r.slot], r.phase ^ 1);  // the first pass finds every slot free
        if constexpr (kWindow)  // released to the consumers by the arrival below
          sm.own[r.slot] = (w[0][0] <= j && j < w[0][1]) | (w[1][0] <= j && j < w[1][1]) << 1;
        uint64_t* full = &sm.full[r.slot];
        const int r0 = hw::rows_start(bh * p.nq + j * BQT);
        hw::bar_expect_tx(full, 2 * kQTileBytes + 2 * kRowBox * 4);
        hw::tma_load4(sm.q[r.slot], &p.q, full, 0, h, j * BQT, b);
        hw::tma_load4(sm.g[r.slot], &p.g, full, 0, h, j * BQT, b);
        hw::tma_load1(sm.lse[r.slot], &p.lse, full, r0);
        hw::tma_load1(sm.delta[r.slot], &p.delta, full, r0);
      }
    }
    return;
  }

  // Warpgroup wg owns keys 64 wg .. 64 wg + 63 of the block.  In s^T,
  // dp^T, dk and dv this thread holds rows (keys) kr and kr + 8; in s^T and
  // dp^T columns (queries) 8 j + c0 + {0, 1}.  Keys at or past nk need no
  // mask: a key's row of dk and dv reads only its own row of s^T and dp^T,
  // and such rows are never stored.
  const int wg = warp / 4;
  const int kr = (warp % 4) * 16 + lane / 4;  // within the warpgroup's 64
  const int c0 = 2 * (lane % 4);
  float dk[32], dv[32];
  // dK and dV (+)= the products of query tile j from ring slot `slot`, whose
  // query 0 sits at row_off of its lse / delta slot, then the slot
  // released.  V's descriptor is K's a fixed distance on, and the block's
  // b, h and first key are formed again for the stores: with more of them
  // live beside dk and dv, ptxas serialized the wgmma for want of
  // registers (C7512) at the nine warps' 168 a thread.
  auto tile = [&](int j, int slot, int row_off, uint64_t kdesc) {
    const uint64_t vdesc = kdesc + (sizeof(sm.k) >> 4);
    const uint64_t qdesc = hw::desc_sw128(sm.q[slot]), gdesc = hw::desc_sw128(sm.g[slot]);
    float st[32], dpt[32];
    hw::fence_regs(st);
    hw::fence_regs(dpt);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_ss<0, 0>(st, kdesc + 2 * kk, qdesc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_ss<0, 0>(dpt, vdesc + 2 * kk, gdesc + 2 * kk, kk);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(st);
    hw::fence_regs(dpt);

    // p = exp(s - lse) and ds = p (dp - delta) scale, in place.  Queries
    // at or past nq (zero Q and G rows, and lse / delta rows of the next
    // (b, h) or zeros) give p = 0: dk and dv sum over them; so do, in the
    // windowed instance, the queries of a tile outside this warpgroup's
    // window (the slot's bit; a branch around the tile spilled).
    const bool ragged_q = (j + 1) * BQT > p.nq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + c0 + e;
        const float lse2 = sm.lse[slot][row_off + c] * kLog2e;
        const float dl = sm.delta[slot][row_off + c];
        const bool q_ok =
            (!ragged_q || j * BQT + c < p.nq) && (!kWindow || (sm.own[slot] >> wg & 1u));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * jj + 2 * hf + e;
          const float pv = q_ok ? hw::exp2_approx(st[i] * p.scale_log2 - lse2) : 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - dl) * p.scale;
        }
      }

    // dK += ds^T . Q (Q [queries][dh] through the transpose bit), then dV
    // += p^T . G, its split formed while dK runs.
    uint32_t dh[4][4], dlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::split_a(dpt, kk, dh[kk], dlo[kk]);
    hw::fence_regs(dk);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dk, dh[kk], qdesc + kk * (2048 >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dk, dlo[kk], qdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();

    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::split_a(st, kk, ph[kk], pl[kk]);
    hw::fence_regs(dv);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dv, ph[kk], gdesc + kk * (2048 >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dv, pl[kk], gdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dk);
    hw::fence_regs(dv);
    hw::fence_frags(dh);
    hw::fence_frags(dlo);
    hw::fence_frags(ph);
    hw::fence_frags(pl);
    if (lane == 0) hw::bar_arrive(&sm.empty[slot]);  // Q, G, lse, delta read
  };

  const uint64_t kdesc = hw::desc_sw128(sm.k + wg * 64 * 128);
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  hw::bar_wait(&sm.kv_full, 0);
  {
    // Query 0 of a tile in its lse / delta slot (tiles start on 64 queries).
    const int row_off = bh * p.nq - hw::rows_start(bh * p.nq);
    Ring r;
    for (int j = j0; j < j1; ++j, r.next()) {
      hw::bar_wait(&sm.full[r.slot], r.phase);
      tile(j, r.slot, row_off, kdesc);
    }
  }

  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = blockIdx.x * BKEYS + wg * 64 + kr + 8 * hf;
    if (key >= p.nk) continue;
    const long long off = ((static_cast<long long>(b) * p.nk + key) * p.heads + h) * 64 + c0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      *reinterpret_cast<uint32_t*>(p.dk + off + 8 * jj) =
          hw::pack_bf16x2(dk[4 * jj + 2 * hf], dk[4 * jj + 2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + 8 * jj) =
          hw::pack_bf16x2(dv[4 * jj + 2 * hf], dv[4 * jj + 2 * hf + 1]);
    }
  }
}

namespace fw = sfc::flash_wide;

// C: sub-heads (2 or 4).  kWindow: #13's dk and dv over the query tiles
// whose window holds the block's keys.
template <int C, bool kWindow>
__global__ void __launch_bounds__(fw::kBwdThreads, 1)
    flash_bwd_dkv_wide_sm90(const __grid_constant__ fw::BwdParams p) {
  fw::bwd_wide<C, true, kWindow>(p);
}

// The wide instances' call (dh 128 or 256).
int run_wide(const void* q, const void* k, const void* v, const void* g, const void* lse,
             const void* delta, void* dk, void* dv, int batch, int heads, int nq, int nk, int dh,
             const long long (&st)[12], float scale, int block, int halo, void* stream) {
  fw::BwdParams p{};
  cudaError_t e = fw::bwd_params(&p, q, k, v, g, lse, delta, dk, dv, batch, heads, nq, nk, dh,
                                 st, scale, block, halo);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  fw::with_wide(dh, [&](auto C) {
    constexpr int c = decltype(C)::value, smem = fw::kBwdSmemBytes<c, true>;
    e = block ? fw::launch_bwd(flash_bwd_dkv_wide_sm90<c, true>, smem, p, batch, s)
              : fw::launch_bwd(flash_bwd_dkv_wide_sm90<c, false>, smem, p, batch, s);
  });
  return static_cast<int>(e);
}

}  // namespace

// q and g bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh],
// each read through its (batch, row, head) strides in elements (unit
// stride along dh; strides multiples of 8 elements, bases on 16 bytes, as
// TMA requires); lse and delta fp32 [batch, heads, nq] contiguous.  dk, dv
// bf16 [batch, nk, heads, dh] contiguous.  dh 64, 128 or 256.
// block > 0 takes #13's windowed instance: key j meets the queries i with
// |i / block - j / block| <= halo, block a multiple of 64, halo >= 1, nq ==
// nk; block 0 (#11) meets every query.
extern "C" int sfc_flash_dkv_bf16(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int batch, int heads, int nq, int nk, int dh, long long qsb,
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
    return run_wide(q, k, v, g, lse, delta, dk, dv, batch, heads, nq, nk, dh, st, scale, block,
                    halo, stream);
  }
  Params p{};
  const long long rows = static_cast<long long>(batch) * heads * nq;
  cudaError_t e = hw::map_bnhd(&p.q, q, batch, nq, heads, qsb, qsn, qsh, BQT);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.g, g, batch, nq, heads, gsb, gsn, gsh, BQT);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.k, k, batch, nk, heads, ksb, ksn, ksh, BKEYS);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.v, v, batch, nk, heads, vsb, vsn, vsh, BKEYS);
  if (e == cudaSuccess) e = hw::map_f32_rows(&p.lse, lse, rows, kRowBox);
  if (e == cudaSuccess) e = hw::map_f32_rows(&p.delta, delta, rows, kRowBox);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.block = block;
  p.halo = halo;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  auto kernel = window ? flash_bwd_dkv_sm90<true> : flash_bwd_dkv_sm90<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nk + BKEYS - 1) / BKEYS, batch * heads);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of #11's kernel (#13's windowed
// instance where `windowed`), into out[3].
extern "C" int sfc_flash_dkv_attrs(int windowed, int* out) {
  return windowed ? hw::kernel_attrs(flash_bwd_dkv_sm90<true>, kSmemBytes, out)
                  : hw::kernel_attrs(flash_bwd_dkv_sm90<false>, kSmemBytes, out);
}

// The same for the instances at dh 128 and 256.
extern "C" int sfc_flash_dkv_wide_attrs(int dh, int windowed, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  fw::with_wide(dh, [&](auto C) {
    constexpr int c = decltype(C)::value, smem = fw::kBwdSmemBytes<c, true>;
    err = windowed ? hw::kernel_attrs(flash_bwd_dkv_wide_sm90<c, true>, smem, out)
                   : hw::kernel_attrs(flash_bwd_dkv_wide_sm90<c, false>, smem, out);
  });
  return err;
}
