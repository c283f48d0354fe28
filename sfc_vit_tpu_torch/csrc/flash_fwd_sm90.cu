// Flash attention forward on [B, N, H, Dh] (kernel #8), redesigned for
// Hopper: out[b, i, h] = softmax(q[b, i, h] . K[b, :, h]^T * scale) .
// V[b, :, h] for nq queries and nk keys (nq != nk allowed), head dim 64,
// bf16 in and out, optionally with the fp32 log-sum-exp of every row.
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_fwd_kernel (lines
// 114-213).  Its two formulas, picked by the caller from the key length
// as the TPU launcher picks them (round_up(nk, 128) <= 4096):
//  * single K step (kSingle; lines 134-161): fp32 logits times scale, the
//    row's max m and sum l over every key, then P = exp(s - m) / l rounded
//    to bf16 and an fp32 P.V, rounded once.  A 128-row fp32 logits strip
//    over 4,096 keys (2 MB) does not fit a block, so two passes: the first
//    computes the logits only (no V) for m and l, the second recomputes
//    them for P.V: 1.5x the nominal 4 x Nq x Nk x Dh operations.
//  * streaming (lines 163-213): per 128-key tile, m' = max(m,
//    max_tile(s)), p = exp(s - m') rounded to bf16 UNNORMALISED, alpha =
//    exp(m - m'), l = sum(p) + alpha * l and acc = acc * alpha + bf16(p).V
//    in fp32; out = bf16(acc / l).  The TPU kernel's key tiles are 1,024
//    wide; here they are 128 (FLASH_STREAM_BLOCK_K), so the running max
//    that p is rounded against moves every 128 keys: JAX's own formula at
//    block_k 128.
// Keys at or past nk get -1e30 (never -inf: p = 0, no NaN), masked only in
// the ragged last tile; lse = m + log(l).  Exponentials are exp2 with
// log2(e) folded into the scale.  q, k and v are read through their
// strides (batch, row, head; unit stride along Dh): the TMA maps take any
// row stride that is a multiple of 16 bytes, so the views of a packed QKV
// projection need no copy.  out is contiguous.
//
// Bound on this card: one (b, h) at N = 16,384 is 4 x 16384^2 x 64 = 69
// GFLOP on 6 MB of q/k/v/out: tensor-core bound (989 TFLOP/s in bf16).
// Design: one block per (128-query tile, b * h): two consumer warpgroups of
// 64 query rows each and one producer warp (nine warps: at most 168
// registers a thread, three warps sharing one of the SM's four register
// files).  The producer keeps K and V
// tiles in flight through a ring of kStages 128-byte-swizzled stages (TMA,
// mbarrier completion).  S = Q.K^T is m64n64 wgmma chains from shared
// memory, one per 64-key half of a tile; the accumulator stays in
// registers, where each thread's rows are known, so the row max and sum
// are quad shuffles and the streaming form rescales the O accumulator in
// registers.  P.V is wgmma with P rounded to bf16 in registers as the A
// operand and V read through the transpose bit.  The halves are
// pipelined: the next half's logits are issued before this half's
// exponentials run, and P.V of one half overlaps the next half's softmax.
// No shared tile holds logits, P or the accumulator.

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BQ = 128;  // queries per block: two warpgroups of 64 rows
constexpr int BK = 128;  // keys per tile (the Python FLASH_STREAM_BLOCK_K)
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kTileBytes = BK * 128;  // 128 rows of 64 bf16
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

struct Smem {
  unsigned char q[BQ * 128];
  unsigned char k[kStages][kTileBytes];
  unsigned char v[kStages][kTileBytes];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap q, k, v;
  bf16* out;
  float* lse;
  int heads, nq, nk;
  float scale_log2;  // scale * log2(e)
};

// A ring of kStages slots: the slot and the parity of its current phase.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ Smem& smem(unsigned char* dyn) {
  const uint32_t pad = (1024 - (sfc::smem_addr(dyn) & 1023)) & 1023;
  return *reinterpret_cast<Smem*>(dyn + pad);
}

template <bool kSingle>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = smem(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int tiles = (p.nk + BK - 1) / BK;

  if (tid == 0) {
    hw::bar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.k_full[s], 1);
      hw::bar_init(&sm.v_full[s], 1);
      hw::bar_init(&sm.k_empty[s], kConsumerWarps);
      hw::bar_init(&sm.v_empty[s], kConsumerWarps);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      hw::bar_expect_tx(&sm.q_full, BQ * 128);
      hw::tma_load4(sm.q, &p.q, &sm.q_full, 0, h, q0, b);
      Ring kr, vr;
      auto load = [&](Ring& r, unsigned char (*buf)[kTileBytes], uint64_t* full,
                      uint64_t* empty, const CUtensorMap* map, int t) {
        hw::bar_wait(&empty[r.slot], r.phase ^ 1);
        hw::bar_expect_tx(&full[r.slot], kTileBytes);
        hw::tma_load4(buf[r.slot], map, &full[r.slot], 0, h, t * BK, b);
        r.next();
      };
      if constexpr (kSingle)
        for (int t = 0; t < tiles; ++t) load(kr, sm.k, sm.k_full, sm.k_empty, &p.k, t);
      for (int t = 0; t < tiles; ++t) {
        load(kr, sm.k, sm.k_full, sm.k_empty, &p.k, t);
        load(vr, sm.v, sm.v_full, sm.v_empty, &p.v, t);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the
  // block; this thread rows r0 and r0 + 8, columns 8 j + c0 + {0, 1}.
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  Ring kr, vr;
  hw::bar_wait(&sm.q_full, 0);
  // The warpgroup's 64 x 64 Q slice as A fragments in registers: the
  // logits' products then read only K from shared memory.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qf[kk][e] = *reinterpret_cast<const uint32_t*>(
          sm.q + hw::sw128_bf16(r0 + 8 * (e % 2), 16 * kk + c0 + 8 * (e / 2)));

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2], l[2] = {0.f, 0.f};  // m in log2 units; l this thread's share of the row sum

  // Logits stream as 64-key halves (a: keys 0-63 of a tile, b: 64-127)
  // through two accumulators, so that the tensor cores compute one while
  // the exponentials of the other run; P . V goes a half at a time too (V
  // rows 0-63, then 64-127), P rounded to bf16 in registers.  The logits
  // are raw: the scale is folded into exp2's argument, exp2(s * c - m)
  // with m the scaled max (c > 0, so the max commutes with the scale).
  // ptxas still serializes the wgmma of both forms (its C7513: P's
  // fragments of one half are formed while P.V of the other is in flight);
  // the single step's waits are static (the same groups and wait counts
  // every iteration, no branch around a wgmma or a wait), which cleared
  // its C7515 and took it from 2.27 to 2.12 ms at [16, 4096, 6, 64] on an
// H100 SXM at 700 W.
  const float c = p.scale_log2;
  const int last = tiles - 1;
  float sa[32], sb[32];
  auto issue_half = [&](float (&d)[32], const Ring& r, int half) {
    const uint64_t kdesc = hw::desc_sw128(sm.k[r.slot]) + half * (64 * 128 >> 4);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<0>(d, qf[kk], kdesc + 2 * kk, kk);
    hw::wgmma_commit();
  };
  // Keys at or past nk to -1e30 (raw logits; only the last tile is ragged).
  auto mask = [&](float (&d)[32], int key0) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (key0 + 8 * (i / 4) + c0 + (i % 2) >= p.nk) d[i] = sfc::kNegInf;
  };
  uint32_t pa[4][4], pb[4][4];
  auto issue_pv = [&](const uint32_t (&f)[4][4], int half) {
    const uint64_t vdesc = hw::desc_sw128(sm.v[vr.slot]) + half * (64 * 128 >> 4);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<1>(o, f[kk], vdesc + kk * (2048 >> 4), 1);
    hw::wgmma_commit();
  };

  if constexpr (kSingle) {
    // Online max and sum over one half.
    auto stats = [&](float (&d)[32]) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = sfc::kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx * c);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += hw::exp2_approx(fmaf(d[4 * j + 2 * hf + e], c, -m_new));
        l[hf] = l[hf] * hw::exp2_approx(m[hf] - m_new) + sum;
        m[hf] = m_new;
      }
    };
    m[0] = m[1] = sfc::kNegInf;
    // Pass 1: m and l.
    hw::bar_wait(&sm.k_full[kr.slot], kr.phase);
    issue_half(sa, kr, 0);
    for (int t = 0; t < tiles; ++t) {
      issue_half(sb, kr, 1);
      hw::wgmma_wait<1>();  // a done
      hw::fence_regs(sa);
      if (t == last) mask(sa, t * BK);
      stats(sa);
      Ring next = kr;
      next.next();
      if (t < last) hw::bar_wait(&sm.k_full[next.slot], next.phase);
      issue_half(sa, t < last ? next : kr, 0);  // on the last tile a product discarded
      hw::wgmma_wait<1>();  // b done
      hw::fence_regs(sb);
      if (t < last && lane == 0) hw::bar_arrive(&sm.k_empty[kr.slot]);
      if (t == last) mask(sb, t * BK + 64);
      stats(sb);
      if (t < last) kr = next;
    }
    hw::wgmma_wait<0>();  // the discarded product
    if (lane == 0) hw::bar_arrive(&sm.k_empty[kr.slot]);
    kr.next();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    // Pass 2: P = exp(s - m) / l rounded to bf16, then o += P . V.
    auto probs = [&](float (&d)[32], uint32_t (&f)[4][4]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i / 2) % 2;
        d[i] = hw::exp2_approx(fmaf(d[i], c, -m[hf])) * inv[hf];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(d, kk, f[kk]);
    };
    // Groups complete in issue order; each wait leaves the newest in
    // flight.  Per tile: b, P.V of a, the next tile's a, P.V of b; empty
    // groups stand in for the P.V of a tile before the first.
    hw::wgmma_commit();
    hw::bar_wait(&sm.k_full[kr.slot], kr.phase);
    issue_half(sa, kr, 0);
    hw::wgmma_commit();
    for (int t = 0; t < tiles; ++t) {
      issue_half(sb, kr, 1);
      hw::wgmma_wait<2>();  // a and the last tile's P.V of a done
      hw::fence_regs(sa);
      hw::fence_frags(pa);
      if (t == last) mask(sa, t * BK);
      probs(sa, pa);
      hw::bar_wait(&sm.v_full[vr.slot], vr.phase);
      issue_pv(pa, 0);
      Ring next = kr;
      next.next();
      if (t < last) hw::bar_wait(&sm.k_full[next.slot], next.phase);
      issue_half(sa, t < last ? next : kr, 0);  // on the last tile a product discarded
      hw::wgmma_wait<2>();  // b and the last tile's P.V of b done
      hw::fence_regs(sb);
      hw::fence_frags(pb);
      if (lane == 0) {
        hw::bar_arrive(&sm.k_empty[kr.slot]);
        if (t > 0) hw::bar_arrive(&sm.v_empty[(vr.slot + kStages - 1) % kStages]);
      }
      kr = next;
      if (t == last) mask(sb, t * BK + 64);
      probs(sb, pb);
      issue_pv(pb, 1);
      vr.next();
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    hw::fence_frags(pa);
    hw::fence_frags(pb);
  } else {
    // Per 128-key tile: the tile's max m' (both halves), alpha, o rescaled,
    // then p = exp(s - m') rounded to bf16 unnormalised, a half at a time;
    // the next tile's first half is issued while the second half's
    // exponentials run.
    m[0] = m[1] = __int_as_float(0xff800000);  // -inf, as the TPU's m_s: the first alpha is 0
    // p = exp2(s c - m') into fragments, adding this thread's share of the
    // row sums.
    auto probs = [&](float (&d)[32], uint32_t (&f)[4][4], float (&sum)[2]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i / 2) % 2;
        d[i] = hw::exp2_approx(fmaf(d[i], c, -m[hf]));
        sum[hf] += d[i];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(d, kk, f[kk]);
    };
    hw::bar_wait(&sm.k_full[kr.slot], kr.phase);
    issue_half(sa, kr, 0);
    for (int t = 0; t < tiles; ++t) {
      issue_half(sb, kr, 1);
      hw::wgmma_wait<0>();  // both halves, and the last tile's P . V
      hw::fence_regs(sa);
      hw::fence_regs(sb);
      hw::fence_regs(o);
      hw::fence_frags(pa);
      hw::fence_frags(pb);
      if (lane == 0) hw::bar_arrive(&sm.k_empty[kr.slot]);
      kr.next();
      if (t > 0) {
        if (lane == 0) hw::bar_arrive(&sm.v_empty[vr.slot]);
        vr.next();
      }
      if (t == last) {
        mask(sa, t * BK);
        mask(sb, t * BK + 64);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = sfc::kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx = fmaxf(mx, fmaxf(sa[4 * j + 2 * hf + e], sb[4 * j + 2 * hf + e]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx * c);
        alpha[hf] = hw::exp2_approx(m[hf] - m_new);
        m[hf] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
      probs(sa, pa, sum);
      hw::bar_wait(&sm.v_full[vr.slot], vr.phase);
      issue_pv(pa, 0);
      if (t < last) {
        hw::bar_wait(&sm.k_full[kr.slot], kr.phase);
        issue_half(sa, kr, 0);
      }
      if (t < last)
        hw::wgmma_wait<2>();
      else
        hw::wgmma_wait<1>();
      probs(sb, pb, sum);
      issue_pv(pb, 1);
      l[0] = sum[0] + alpha[0] * l[0];
      l[1] = sum[1] + alpha[1] * l[1];
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    hw::fence_frags(pa);
    hw::fence_frags(pb);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= p.nq) continue;
    const float inv = kSingle || l[hf] == 0.f ? 1.f : 1.f / l[hf];
    bf16* dst = p.out + ((static_cast<long long>(b) * p.nq + row) * p.heads + h) * 64 + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          hw::pack_bf16x2(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[static_cast<long long>(bh) * p.nq + row] =
          m[hf] * kLn2 + logf(l[hf] == 0.f ? 1.f : l[hf]);
  }
}

}  // namespace

// q bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh], each
// read through its (batch, row, head) strides in elements (unit stride
// along dh; strides multiples of 8 elements and the bases on 16 bytes, as
// TMA requires); out bf16 [batch, nq, heads, dh] contiguous; lse fp32
// [batch, heads, nq] or null.  streaming selects the one-pass form.  dh
// must be 64.
extern "C" int sfc_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int heads, int nq, int nk, int dh,
                                  long long qsb, long long qsn, long long qsh, long long ksb,
                                  long long ksn, long long ksh, long long vsb, long long vsn,
                                  long long vsh, float scale, int streaming, void* stream) {
  if (dh != 64 || nq < 1 || nk < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  Params p{};
  cudaError_t e = hw::map_bnhd(&p.q, q, batch, nq, heads, qsb, qsn, qsh, BQ);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.k, k, batch, nk, heads, ksb, ksn, ksh, BK);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.v, v, batch, nk, heads, vsb, vsn, vsh, BK);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale_log2 = scale * kLog2e;
  auto kernel = streaming ? flash_fwd_sm90<false> : flash_fwd_sm90<true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nq + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of the streaming (1) or
// single-step (0) kernel, into out[3].
extern "C" int sfc_flash_fwd_attrs(int streaming, int* out) {
  return hw::kernel_attrs(streaming ? flash_fwd_sm90<false> : flash_fwd_sm90<true>,
                          kSmemBytes, out);
}
