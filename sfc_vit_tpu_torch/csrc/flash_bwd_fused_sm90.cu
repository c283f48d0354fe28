// Fused flash attention backward on [B, N, H, Dh] (kernel #9), redesigned
// for Hopper, head dim 64, from the forward's fp32 log-sum-exp lse and
// delta = rowsum(g * O) (both [B, H, Nq]).
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_fused_bwd_kernel (lines
// 317-373).  With s = q . k^T * scale in fp32, keys at or past nk and
// queries at or past nq giving p = 0, p = exp(s - lse), dp = g . v^T in
// fp32 (bf16 operands, exact products) and ds = p * (dp - delta) * scale:
// dq = sum over keys of ds . k (an fp32 buffer the caller rounds), dk =
// sum over queries of ds^T . q and dv = sum over queries of p^T . g, each
// an fp32 sum rounded once to bf16.  Like the TPU kernel, p and ds stay
// fp32: they enter the tensor-core products as a two-term bf16 split, p =
// hi + lo (two bf16 products summed in fp32, about 16 bits of mantissa),
// so the kernel executes 16 x B.H.Nq.Nk.Dh operations against the nominal
// 10.  It departs from the TPU kernel at the level of fp32 or bf16 ulps:
// p from the forward's lse where the TPU kernel divides by its own row
// sum, delta over the bf16 output where it takes rowsum(dp * p) in fp32,
// and dq summed by bulk reduce-adds in an order that changes from run to
// run.
//
// Bound on this card: at [16, 4096, 6, 64] the nominal 10 x 16 x 6 x
// 4096^2 x 64 = 1.03 TFLOP on ~50 MB: tensor-core bound.
// Design: one block per (128-key tile, b * h): two warpgroups of 64 keys
// each.  K and V stay in shared memory; thread 0 brings 64-query tiles of
// Q and G (128-byte-swizzled) and their lse / delta rows through a ring of
// kStages stages (TMA, mbarriers), kStages - 1 tiles ahead.  Per
// query tile each warpgroup computes s^T = K.Q^T and dp^T = V.G^T by wgmma
// into registers, forms p and ds for its own elements and splits them into
// hi / lo bf16 registers, which are the A operand of dV += p^T.G and dK +=
// ds^T.Q (G and Q read through the transpose bit); dK and dV stay in
// registers across the whole query loop.  dQ = ds.K needs ds with queries
// as rows: the warpgroup writes ds^T hi / lo to its own swizzled tile and
// wgmma reads it back as a transposed A operand; the 64 x 64 fp32 partial
// dq goes to a swizzled staging tile and is added to the global buffer by
// two TMA bulk reduce-adds (cp.reduce.async.bulk.tensor .add.f32), no
// scalar atomics.

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BKEYS = 128;  // keys per block: two warpgroups of 64
constexpr int BQT = 64;     // queries per tile of the loop
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32;
constexpr int kQTileBytes = BQT * 128;
static_assert(BQT == 64, "hw::kRowBox is a 64-row tile's box");
using hw::kLog2e;
using hw::kRowBox;
using hw::kRowSlot;

struct Smem {
  unsigned char k[BKEYS * 128];
  unsigned char v[BKEYS * 128];
  unsigned char q[kStages][kQTileBytes];
  unsigned char g[kStages][kQTileBytes];
  unsigned char ds_hi[2][64 * 128];  // per warpgroup: ds^T, its 64 keys x 64 queries
  unsigned char ds_lo[2][64 * 128];
  unsigned char dq[2][2][64 * 128];  // per warpgroup: fp32 dq, 64 queries x two halves of 32
  float lse[kStages][kRowSlot];
  float delta[kStages][kRowSlot];
  uint64_t kv_full, full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;

struct Params {
  CUtensorMap q, k, v, g, lse, delta, dq;
  bf16 *dk, *dv;
  int heads, nq, nk;
  float scale, scale_log2;
};

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_fused_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BKEYS, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int qtiles = (p.nq + BQT - 1) / BQT;

  // Thread 0 issues every TMA load: K and V once, then the query tiles
  // through the ring, tile j + kStages - 1 as tile j starts (no producer
  // warp: eight warps may hold 255 registers a thread, nine only 168,
  // three warps sharing one of the SM's four register files).
  auto load_tile = [&](int j) {
    const int slot = j % kStages;
    const int r0 = hw::rows_start(bh * p.nq + j * BQT);
    hw::bar_expect_tx(&sm.full[slot], 2 * kQTileBytes + 2 * kRowBox * 4);
    hw::tma_load4(sm.q[slot], &p.q, &sm.full[slot], 0, h, j * BQT, b);
    hw::tma_load4(sm.g[slot], &p.g, &sm.full[slot], 0, h, j * BQT, b);
    hw::tma_load1(sm.lse[slot], &p.lse, &sm.full[slot], r0);
    hw::tma_load1(sm.delta[slot], &p.delta, &sm.full[slot], r0);
  };
  if (tid == 0) {
    hw::bar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], kConsumerWarps);
    }
    hw::fence_barrier_init();
    hw::bar_expect_tx(&sm.kv_full, 2 * BKEYS * 128);
    hw::tma_load4(sm.k, &p.k, &sm.kv_full, 0, h, k0, b);
    hw::tma_load4(sm.v, &p.v, &sm.kv_full, 0, h, k0, b);
    for (int j = 0; j < kStages - 1 && j < qtiles; ++j) load_tile(j);
  }
  __syncthreads();

  // Consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of the block.
  // In s^T, dp^T, dk, dv this thread holds rows (keys) kr and kr + 8; in
  // s^T and dp^T columns (queries) 8 j + c0 + {0, 1}; in dq the same
  // places, rows being queries and columns dh.
  const int wg = warp / 4, t = tid % 128;
  const int kr = (warp % 4) * 16 + lane / 4;  // within the warpgroup's 64
  const int c0 = 2 * (lane % 4);
  const int key0 = k0 + wg * 64;
  const bool ragged_keys = key0 + 64 > p.nk;
  // Query 0 of a tile in its lse / delta slot (tiles start on 64 queries).
  const int row_off = bh * p.nq - hw::rows_start(bh * p.nq);
  const unsigned char* k_wg = sm.k + wg * 64 * 128;
  const unsigned char* v_wg = sm.v + wg * 64 * 128;
  const uint64_t kdesc = hw::desc_sw128(k_wg), vdesc = hw::desc_sw128(v_wg);
  const uint64_t dshi_desc = hw::desc_sw128(sm.ds_hi[wg]), dslo_desc = hw::desc_sw128(sm.ds_lo[wg]);
  const float lse_scale = kLog2e;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  hw::bar_wait(&sm.kv_full, 0);

  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < qtiles; ++j) {
    if (tid == 0 && j + kStages - 1 < qtiles) {
      // The slot of tile j - 1 (empty from the start when j = 0) once
      // every warp has released it.
      if (j > 0) hw::bar_wait(&sm.empty[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      load_tile(j + kStages - 1);
    }
    hw::bar_wait(&sm.full[slot], phase);
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

    // p = exp(s - lse) and ds = p (dp - delta) scale, in place.
    const bool ragged_q = (j + 1) * BQT > p.nq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + c0 + e;
        const float lse2 = sm.lse[slot][row_off + c] * lse_scale;
        const float dl = sm.delta[slot][row_off + c];
        const bool q_ok = !ragged_q || j * BQT + c < p.nq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * jj + 2 * hf + e;
          const bool ok = q_ok && (!ragged_keys || key0 + kr + 8 * hf < p.nk);
          const float pv = ok ? hw::exp2_approx(st[i] * p.scale_log2 - lse2) : 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] - dl) * p.scale;
        }
      }

    // ds^T hi / lo: registers for dK += ds^T . Q (Q through the transpose
    // bit), and the warpgroup's shared tile for dQ.
    uint32_t dh[4][4], dlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::split_a(dpt, kk, dh[kk], dlo[kk]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A-fragment register e of step kk: row kr (+8 for odd e), columns
        // 16 kk + c0 (+8 for e >= 2).
        const int row = kr + 8 * (e % 2), col = 16 * kk + c0 + 8 * (e / 2);
        const int off = hw::sw128_bf16(row, col);
        *reinterpret_cast<uint32_t*>(sm.ds_hi[wg] + off) = dh[kk][e];
        *reinterpret_cast<uint32_t*>(sm.ds_lo[wg] + off) = dlo[kk][e];
      }
    hw::fence_async_shared();
    hw::fence_regs(dk);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dk, dh[kk], qdesc + kk * (2048 >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(dk, dlo[kk], qdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();

    // dV += p^T . G (G [queries][dh] through the transpose bit), its
    // split formed while dK runs.
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
    hw::named_sync(1 + wg, 128);  // the warpgroup's whole ds^T tile is written

    // dq (64 queries) = ds . K over this warpgroup's 64 keys: ds is ds^T
    // read through the transpose bit, K [keys][dh] likewise.
    float dq[32];
    hw::fence_regs(dq);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hw::wgmma_ss<1, 1>(dq, dshi_desc + kk * (2048 >> 4), kdesc + kk * (2048 >> 4), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hw::wgmma_ss<1, 1>(dq, dslo_desc + kk * (2048 >> 4), kdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dq);
    if (lane == 0) hw::bar_arrive(&sm.empty[slot]);  // Q, G, lse, delta read

    // dq to the staging tile (once the last reduce-add has read it), then
    // one bulk reduce-add per 32-column half.
    if (t == 0) hw::bulk_wait_read();
    hw::named_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = kr + 8 * hf, col = 8 * (jj % 4) + c0;
        *reinterpret_cast<float2*>(sm.dq[wg][jj / 4] + hw::sw128_f32(row, col)) =
            make_float2(dq[4 * jj + 2 * hf], dq[4 * jj + 2 * hf + 1]);
      }
    hw::fence_async_shared();
    hw::named_sync(1 + wg, 128);
    if (t == 0) {
      hw::tma_reduce_add4(&p.dq, sm.dq[wg][0], 0, h, j * BQT, b);
      hw::tma_reduce_add4(&p.dq, sm.dq[wg][1], 32, h, j * BQT, b);
      hw::bulk_commit();
    }
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (t == 0) hw::bulk_wait_all();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = key0 + kr + 8 * hf;
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

}  // namespace

// q and g bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh],
// each read through its (batch, row, head) strides in elements (unit
// stride along dh; strides multiples of 8 elements, bases on 16 bytes);
// lse and delta fp32 [batch, heads, nq] contiguous.  dq32 fp32 [batch, nq,
// heads, dh] contiguous, zeroed by the caller and summed into by bulk
// reduce-adds; dk, dv bf16 [batch, nk, heads, dh] contiguous.  dh must be
// 64.
extern "C" int sfc_flash_fused_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dq32, void* dk, void* dv, int batch, int heads,
                                        int nq, int nk, int dh, long long qsb, long long qsn,
                                        long long qsh, long long ksb, long long ksn,
                                        long long ksh, long long vsb, long long vsn,
                                        long long vsh, long long gsb, long long gsn,
                                        long long gsh, float scale, void* stream) {
  if (dh != 64 || nq < 1 || nk < 1 || heads < 1 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  const long long rows = static_cast<long long>(batch) * heads * nq;
  cudaError_t e = hw::map_bnhd(&p.q, q, batch, nq, heads, qsb, qsn, qsh, BQT);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.g, g, batch, nq, heads, gsb, gsn, gsh, BQT);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.k, k, batch, nk, heads, ksb, ksn, ksh, BKEYS);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.v, v, batch, nk, heads, vsb, vsn, vsh, BKEYS);
  if (e == cudaSuccess) e = hw::map_f32_rows(&p.lse, lse, rows, kRowBox);
  if (e == cudaSuccess) e = hw::map_f32_rows(&p.delta, delta, rows, kRowBox);
  if (e == cudaSuccess) e = hw::map_bnhd_f32(&p.dq, dq32, batch, nq, heads, BQT);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  e = cudaFuncSetAttribute(flash_bwd_fused_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nk + BKEYS - 1) / BKEYS, batch * heads);
  flash_bwd_fused_sm90<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of the kernel, into out[3].
extern "C" int sfc_flash_fused_bwd_attrs(int* out) {
  return hw::kernel_attrs(flash_bwd_fused_sm90, kSmemBytes, out);
}
