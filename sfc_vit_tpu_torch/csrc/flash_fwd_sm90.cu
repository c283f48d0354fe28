// Flash attention forward on [B, N, H, Dh] (kernel #8), redesigned for
// Hopper: out[b, i, h] = softmax(q[b, i, h] . K[b, :, h]^T * scale) .
// V[b, :, h] for nq queries and nk keys (nq != nk allowed), head dim 64
// (128 and 256 below), bf16 in and out, optionally with the fp32
// log-sum-exp of every row.
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
//
// The windowed instance (kWindow, single step only) is the curve-local
// forward #12: sfc_vit_tpu/ops/local_attention.py::_kernel (lines 82-124,
// called at :169), query i over exactly the keys j with |i / block - j /
// block| <= halo and j < n (nq == nk == n), with the single step's
// arithmetic over that window (the TPU kernel reads 2 halo + 1 clamped
// neighbour-block views and masks the out-of-range ones, so no key counts
// twice at the sequence's ends: the same set).  block is a multiple of 64,
// so each warpgroup's 64 queries lie in one curve block, whose window is
// the key range [max(0, (qb - halo) block), min(n, (qb + halo + 1) block))
// (ops/_build.py::local_fwd_key_range).  A block walks the 128-key tiles
// that its two warpgroups' windows touch (sm90.cuh::local_tile_window's
// 64-row tiles, rounded out to 128 keys: ops/_build.py::local_fwd_tiles),
// and each warpgroup gives -1e30 to the keys outside its own window, only
// in a 64-key half that its window does not hold whole.  The two
// warpgroups differ where a 128-query tile straddles two curve blocks
// (block 64 or 192).  At [2, 16384, 6, 64], block 128, halo 1 a block
// walks 3 tiles in each pass instead of 128.
//
// Head dims 128 and 256 (flash_fwd_wide_sm90, on csrc/flash_wide.cuh's
// forward blocks): the same formulas and TPU kernels (#8's _fwd_kernel, and
// #12's _kernel as the windowed instance), every instance (single step,
// streaming, windowed) over C = Dh / 64 sub-heads.  Bound: operations, #8's
// nominal 4 x B H Nq Nk Dh at 989 TFLOP/s (the single step executes 6 such
// units, its first pass being logits only; the streaming form 4), and #12's
// bytes (a window of a few tiles).  Design: a block is two warpgroups over
// 128 queries of one (b, h) (256 threads, one block an SM, 255 registers a
// thread, no producer warp), sharing each K and V entry, so the L2 feeds
// each key to 128 queries.  Q's sub-blocks stay resident; a ring of 32 KB
// entries of K or V (128 keys of both sub-heads at Dh 128, six slots; 64
// keys of all four at Dh 256, five) is kept in flight by TMA, each slot
// freed by its own empty barrier once every warp's wgmma_wait has retired
// the products that read it, never by a block barrier.  The first warp of
// each warpgroup loads entries, claiming each by an atomic, when its
// warpgroup reaches one not yet loaded, so the warpgroup ahead does the
// loading and neither waits on the other's progress to be fed.  O stays
// whole in registers (C x 32 a thread) beside one step's logits and P, so
// the keys are walked once (the single step twice: m and l, then P V) at
// both head dims.  The logits
// of an entry are one m64n128 (Dh 128) or m64n64 (Dh 256) product a k16
// step, P V one m64n128 / m64n256 product a k16 step over all sub-heads.
// Overlap: the first pass keeps two logits accumulators, the next entry's
// product running under this one's max and sum; at Dh 128 the walk issues
// step st + 1's logits with step st's P V and runs step st + 1's
// exponentials while P V is on the tensor cores (at Dh 256, where O is
// twice as wide, that was slower or did not fit); the two warpgroups
// interleave on the tensor cores.  (Making them take strict
// turns through named barriers was slower in every case measured.)  The
// streaming form's step is 128 keys, so the running max that p is rounded
// against moves every 128 keys (FLASH_STREAM_BLOCK_K), as at Dh 64; keys
// at or past nk are -1e30 and add nothing.  The windowed instance walks the
// keys of the union of its two warpgroups' windows (sm90.cuh::
// local_tile_window over 128 rows); each warpgroup gives -1e30 to the keys
// outside its own window (ops/_build.py::local_fwd_key_range), and leaves
// an entry wholly outside it out of m and l (the windows differ where a
// 128-query block straddles two curve blocks: block 64 or 192).

#include "flash_wide.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BQ = 128;  // queries per block: two warpgroups of 64 rows
constexpr int BK = 128;  // keys per tile (the Python FLASH_STREAM_BLOCK_K)
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kTileBytes = BK * 128;  // 128 rows of 64 bf16
using hw::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

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
  int block, halo;   // the windowed instance's curve block and halo
  float scale_log2;  // scale * log2(e)
};

using Ring = hw::Ring<kStages>;

// kWindow: #12's instance (kSingle only; nq == nk), over the curve-local
// window of each query block; otherwise #8's, over every key.
template <bool kSingle, bool kWindow = false>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90(const __grid_constant__ Params p) {
  static_assert(kSingle || !kWindow, "the windowed instance is the single step's");
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  // The key tiles [t0, t1) the block walks: every one, or those its two
  // warpgroups' windows touch (64-row tiles rounded out to 128 keys).
  int t0 = 0, t1 = (p.nk + BK - 1) / BK;
  if constexpr (kWindow) {
    int lo, hi;
    hw::local_tile_window(q0 / 64, BQ, p.nk, p.block, p.halo, lo, hi);
    t0 = lo / 2;
    t1 = (hi + 1) / 2;
  }

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
        for (int t = t0; t < t1; ++t) load(kr, sm.k, sm.k_full, sm.k_empty, &p.k, t);
      for (int t = t0; t < t1; ++t) {
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
  const int last = t1 - 1;
  // The keys [klo, khi) this warpgroup's rows see: every key, or the
  // window of their curve block.
  int klo = 0, khi = p.nk;
  if constexpr (kWindow) {
    const int qb = (q0 + 64 * wg) / p.block;
    klo = max(0, (qb - p.halo) * p.block);
    khi = min(p.nk, (qb + p.halo + 1) * p.block);
  }
  float sa[32], sb[32];
  auto issue_half = [&](float (&d)[32], const Ring& r, int half) {
    const uint64_t kdesc = hw::desc_sw128(sm.k[r.slot]) + half * (64 * 128 >> 4);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::wgmma_rs<0>(d, qf[kk], kdesc + 2 * kk, kk);
    hw::wgmma_commit();
  };
  // Keys outside [klo, khi) to -1e30 (raw logits), in a 64-key half from
  // key0 that the range does not hold whole: #8's ragged last tile, or
  // the edges of a warpgroup's window.
  auto mask = [&](float (&d)[32], int key0) {
    if (key0 >= klo && key0 + 64 <= khi) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * (i / 4) + c0 + (i % 2);
      if (key < klo || key >= khi) d[i] = sfc::kNegInf;
    }
  };
  // Whether a 64-key half holds a key of [klo, khi).  The windowed
  // instance leaves a half outside its warpgroup's window out of m and l:
  // a first half all -1e30 would set m to -1e30 c, and fma(s, c, -m) is
  // then the product's rounding error, whose exp2 may be inf.  (#8's
  // rows meet a key below nk first.)
  auto live = [&](int key0) { return !kWindow || (key0 + 64 > klo && key0 < khi); };
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
    for (int t = t0; t < t1; ++t) {
      issue_half(sb, kr, 1);
      hw::wgmma_wait<1>();  // a done
      hw::fence_regs(sa);
      if (kWindow || t == last) mask(sa, t * BK);
      if (live(t * BK)) stats(sa);
      Ring next = kr;
      next.next();
      if (t < last) hw::bar_wait(&sm.k_full[next.slot], next.phase);
      issue_half(sa, t < last ? next : kr, 0);  // on the last tile a product discarded
      hw::wgmma_wait<1>();  // b done
      hw::fence_regs(sb);
      if (t < last && lane == 0) hw::bar_arrive(&sm.k_empty[kr.slot]);
      if (kWindow || t == last) mask(sb, t * BK + 64);
      if (live(t * BK + 64)) stats(sb);
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
    for (int t = t0; t < t1; ++t) {
      issue_half(sb, kr, 1);
      hw::wgmma_wait<2>();  // a and the last tile's P.V of a done
      hw::fence_regs(sa);
      hw::fence_frags(pa);
      if (kWindow || t == last) mask(sa, t * BK);
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
        if (t > t0) hw::bar_arrive(&sm.v_empty[(vr.slot + kStages - 1) % kStages]);
      }
      kr = next;
      if (kWindow || t == last) mask(sb, t * BK + 64);
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
    for (int t = 0; t < t1; ++t) {
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

namespace fw = sfc::flash_wide;

struct WideParams {
  CUtensorMap q, k, v;  // map_strided_heads over [B, N, H, Dh], 64-row boxes
  bf16* out;            // [B, nq, H, Dh] contiguous
  float* lse;           // [B, H, nq] or null
  int heads, dh, nq, nk;
  int block, halo;      // the windowed instance's curve block and halo
  float scale_log2;     // scale * log2(e)
};

// C: sub-heads (2 or 4).  kSingle: the single K step's two passes (P
// normalised before P V), else the streaming form.  kWindow (#12,
// kSingle only): over the key tiles of the block's curve-local window.
template <int C, bool kSingle, bool kWindow>
__global__ void __launch_bounds__(fw::kFwdThreads, 1)
    flash_fwd_wide_sm90(const __grid_constant__ WideParams p) {
  static_assert(kSingle || !kWindow, "the windowed instance is the single step's");
  // KT: keys a ring entry (a unit of the walk), KT / 2 logits a thread:
  // 128 at Dh 128 (the logits one m64n128 product a k16 step), 64 at Dh
  // 256.  H: units a step, the streaming form's 128 keys.  kOverlap: step
  // st + 1's logits are issued with step st's P V and its exponentials run
  // while P V is on the tensor cores.  At Dh 256 it is off: in the
  // streaming form O (128 registers), a step's logits (64) and P (32) would
  // all be live at once, and the single step ran slower with it.
  constexpr int NS = fw::fwd_slots(C), KT = fw::fwd_keys(C), SR = KT / 2, KS = KT / 16;
  constexpr int H = kSingle ? 1 : 128 / KT;
  constexpr bool kOverlap = C == 2;
  using Sm = fw::FwdSmem<C>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Sm& sm = hw::aligned_smem<Sm>(dyn);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * ((tid / 32) % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int q0 = blockIdx.x * 128, bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int nq = p.nq, nk = p.nk, row0 = q0 + 64 * wg;
  // A second warpgroup wholly past nq has nothing to do and leaves.
  const int groups = q0 + 64 < nq ? 2 : 1;
  // The keys [k0, k0 + KT units) the block walks: every one, or the union
  // of its two warpgroups' curve-local windows (64-key tiles [t0, t1)).
  int t0 = 0, t1 = (nk + 63) / 64;
  if constexpr (kWindow) hw::local_tile_window(q0 / 64, 128, nk, p.block, p.halo, t0, t1);
  const int k0 = 64 * t0, units = (64 * (t1 - t0) + KT - 1) / KT, steps = (units + H - 1) / H;
  // The ring's entries, in the order both warpgroups take them: the single
  // step's first pass (K of every unit), then per step K's H units and V's.
  const int first = kSingle ? units : 0, total = first + 2 * H * steps;

  if (tid == 0) {
    hw::bar_init(&sm.q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], 4 * groups);  // every warp of the block, once an entry
    }
    sm.issued = 0;
    hw::fence_barrier_init();
  }
  __syncthreads();
  // The first warp of each warpgroup loads the ring's entries, in order:
  // it claims the next entry by an atomic on sm.issued and loads it into
  // the slot of the entry NS before once every warp has released that.  It
  // waits for a slot only for entries up to `need` (the one its warpgroup
  // is about to take), and else loads while slots are free.  So the
  // warpgroup ahead does the loading (its other wait being for the one
  // behind to free a slot), and the one behind finds its entries loaded.
  // The whole warp runs it, lane x loading the entry's x-th 64-row box (a
  // divergent lane 0 alone was held back by its warp's other lanes).  It
  // runs before a take, only for an entry not yet seen loaded (`seen`:
  // the entries below it are), and then loads ahead while slots are free:
  // its chain of shared-memory round trips is long, and running it after
  // every issue of products, to keep the ring fuller, was slower.
  int seen = 0;
  auto feed = [&](int need) SFC_INLINE_LAMBDA {
    for (;;) {
      int i = lane == 0 ? *reinterpret_cast<volatile int*>(&sm.issued) : 0;
      i = __shfl_sync(0xffffffffu, i, 0);
      seen = i;
      if (i >= total) break;
      const int slot = i % NS;
      if (i >= NS) {
        const uint32_t parity = (i / NS - 1) & 1;
        if (i <= need)
          hw::bar_wait(&sm.empty[slot], parity);
        else if (!__shfl_sync(0xffffffffu, fw::bar_test(&sm.empty[slot], parity) ? 1 : 0, 0))
          break;
      }
      const int won = lane == 0 ? atomicCAS(&sm.issued, i, i + 1) == i : 0;
      if (!__shfl_sync(0xffffffffu, won, 0)) continue;
      int unit = i;
      bool is_v = false;
      if (!kSingle || i >= first) {
        const int j = i - first, u = j / (2 * H), r = j - 2 * H * u;
        is_v = r >= H;
        unit = H * u + (is_v ? r - H : r);
      }
      // Box x: sub-head x / (KT / 64), keys 64 (x % (KT / 64)) on.
      if (lane == 0) hw::bar_expect_tx(&sm.full[slot], C * KT * 128);
      if (lane < C * KT / 64)
        hw::tma_load4(sm.ring[slot] + lane * fw::kSub, is_v ? &p.v : &p.k, &sm.full[slot],
                      64 * (lane / (KT / 64)), h, k0 + KT * unit + 64 * (lane % (KT / 64)), b);
    }
  };
  if (tid == 0) {
    hw::bar_expect_tx(&sm.q_full, groups * C * fw::kSub);
    for (int w = 0; w < groups; ++w)
      for (int c = 0; c < C; ++c)
        hw::tma_load4(sm.q[w][c], &p.q, &sm.q_full, 64 * c, h, q0 + 64 * w, b);
  }
  if (tid < 32) feed(-1);
  if (wg >= groups) return;

  // The next entry this warpgroup takes: its descriptor once it has landed.
  int e = 0;
  auto take = [&]() SFC_INLINE_LAMBDA {
    if (tid % 128 < 32 && e >= seen) feed(e);
    hw::bar_wait(&sm.full[e % NS], (e / NS) & 1);
    return hw::desc_sw128(sm.ring[e++ % NS]);
  };
  // Entries i .. i + n - 1 read by no product in flight: each warp arrives.
  auto release = [&](int i, int n) SFC_INLINE_LAMBDA {
    if (lane == 0)
      for (int x = 0; x < n; ++x) hw::bar_arrive(&sm.empty[(i + x) % NS]);
  };

  const float c = p.scale_log2;
  const uint64_t dq = hw::desc_sw128(sm.q[wg][0]);
  // The keys [klo, khi) this warpgroup's rows see: every key below nk, or
  // the window of their curve block (block a multiple of 64: one block).
  int klo = 0, khi = nk;
  if constexpr (kWindow) {
    const int qb = row0 / p.block;
    klo = max(0, (qb - p.halo) * p.block);
    khi = min(nk, (qb + p.halo + 1) * p.block);
  }
  // Keys outside [klo, khi) to -1e30 (raw logits), in a unit from key0
  // that the range does not hold whole.
  auto mask = [&](float (&d)[SR], int key0) SFC_INLINE_LAMBDA {
    if (key0 >= klo && key0 + KT <= khi) return;
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int key = key0 + 8 * (i / 4) + c0 + (i % 2);
      if (key < klo || key >= khi) d[i] = sfc::kNegInf;
    }
  };
  auto quad_max = [](float v) SFC_INLINE_LAMBDA {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) SFC_INLINE_LAMBDA {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };
  hw::bar_wait(&sm.q_full, 0);

  // m: the rows' max (log2 units, the scale folded in: exp2(s c - m));
  // l: this thread's share of the rows' sums.
  float m[2], l[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};
  if constexpr (kSingle) {
    // Pass 1: m and l over every key, logits only.  Two accumulators: the
    // next unit's logits run on the tensor cores while this one's max and
    // sum are taken.  After the last unit a product of Q with itself
    // stands in (its result unread), so every wait is the same.  A unit
    // outside this warpgroup's window stays out of m and l: a first unit
    // all -1e30 would set m to -1e30 c, and fma(s, c, -m) is then the
    // product's rounding error, whose exp2 may be inf.
    m[0] = m[1] = sfc::kNegInf;
    float sa[SR], sb[SR];
    auto issue = [&](float (&d)[SR], uint64_t dk) SFC_INLINE_LAMBDA {
      hw::wgmma_fence();
      fw::logits_tile<C, KT>(d, dq, dk);
      hw::wgmma_commit();
    };
    auto stats = [&](float (&d)[SR], int t) SFC_INLINE_LAMBDA {
      const int key0 = k0 + KT * t;
      mask(d, key0);
      if (kWindow && (key0 + KT <= klo || key0 >= khi)) return;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = sfc::kNegInf;
#pragma unroll
        for (int j = 0; j < SR / 4; ++j)
          mx = fmaxf(mx, fmaxf(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]));
        const float m_new = fmaxf(m[hf], quad_max(mx) * c);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SR / 4; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) sum += hw::exp2_approx(fmaf(d[4 * j + 2 * hf + x], c, -m_new));
        l[hf] = l[hf] * hw::exp2_approx(m[hf] - m_new) + sum;
        m[hf] = m_new;
      }
    };
    issue(sa, take());
    for (int t = 0; t < units; t += 2) {
      uint64_t dk = dq;
      if (t + 1 < units) dk = take();
      issue(sb, dk);
      hw::wgmma_wait<1>();
      hw::fence_regs(sa);
      release(t, 1);
      stats(sa, t);
      dk = dq;
      if (t + 2 < units) dk = take();
      issue(sa, dk);
      hw::wgmma_wait<1>();
      hw::fence_regs(sb);
      if (t + 1 < units) {
        release(t + 1, 1);
        stats(sb, t + 1);
      }
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(sa);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] = quad_sum(l[hf]);
      inv[hf] = 1.f / l[hf];
    }
  } else {
    m[0] = m[1] = __int_as_float(0xff800000);  // -inf, as the TPU's m_s: the first alpha is 0
  }

  // The walk: per step (H units) the logits, then p (the single step's P
  // = exp(s - m) / l; the streaming form's p = exp(s - m') against the
  // step's running max m', O rescaled by alpha = exp(m - m')) rounded to
  // bf16 straight into A fragments, then O += P V.  O stays whole in
  // registers (C x 32 a thread).
  float o[C][32], s[H][SR], alpha[2] = {1.f, 1.f};
  uint32_t pf[H][KS][4];
#pragma unroll
  for (int cc = 0; cc < C; ++cc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cc][i] = 0.f;
  // p of step st in s (fp32, in place); the streaming form's alpha, m, l.
  auto softmax = [&](int st) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int x = 0; x < H; ++x) mask(s[x], k0 + KT * (H * st + x));
    if constexpr (kSingle) {
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int hf = (i / 2) % 2;
        s[0][i] = hw::exp2_approx(fmaf(s[0][i], c, -m[hf])) * inv[hf];
      }
    } else {
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = sfc::kNegInf;
#pragma unroll
        for (int x = 0; x < H; ++x)
#pragma unroll
          for (int j = 0; j < SR / 4; ++j)
            mx = fmaxf(mx, fmaxf(s[x][4 * j + 2 * hf], s[x][4 * j + 2 * hf + 1]));
        const float m_new = fmaxf(m[hf], quad_max(mx) * c);
        alpha[hf] = hw::exp2_approx(m[hf] - m_new);
        m[hf] = m_new;
      }
#pragma unroll
      for (int x = 0; x < H; ++x)
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const int hf = (i / 2) % 2;
          s[x][i] = hw::exp2_approx(fmaf(s[x][i], c, -m[hf]));
          sum[hf] += s[x][i];
        }
      l[0] = sum[0] + alpha[0] * l[0];
      l[1] = sum[1] + alpha[1] * l[1];
    }
  };
  // O rescaled by alpha (no product on O in flight) and p into fragments
  // (no product on them in flight).
  auto finish = [&]() SFC_INLINE_LAMBDA {
    if constexpr (!kSingle) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cc][i] *= alpha[(i / 2) % 2];
    }
#pragma unroll
    for (int x = 0; x < H; ++x)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) hw::acc_to_a(s[x], kk, pf[x][kk]);
  };
  // Every register the chains below read or write, fenced once before one
  // wgmma_fence, with nothing in flight (an operand fence between two
  // chains in flight makes ptxas serialize the wgmma, C7515).
  auto fence_all = [&]() SFC_INLINE_LAMBDA {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
#pragma unroll
    for (int x = 0; x < H; ++x) {
      hw::fence_regs(s[x]);
      hw::fence_frags(pf[x]);
    }
    hw::wgmma_fence();
  };
  auto logits = [&](const uint64_t (&dk)[H]) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int x = 0; x < H; ++x) fw::logits_tile<C, KT>(s[x], dq, dk[x]);
    hw::wgmma_commit();
  };
  auto pv = [&](const uint64_t (&dv)[H]) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int x = 0; x < H; ++x) fw::pv_tile<C, KT>(o, pf[x], dv[x]);
    hw::wgmma_commit();
  };
  auto after_pv = [&](int st) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
#pragma unroll
    for (int x = 0; x < H; ++x) hw::fence_frags(pf[x]);
    release(first + 2 * H * st + H, H);
  };
  uint64_t dk[H], dv[H];
  if constexpr (kOverlap) {
    // Step st + 1's logits and step st's P V are issued together; step st
    // + 1's softmax runs while P V is on the tensor cores.
#pragma unroll
    for (int x = 0; x < H; ++x) dk[x] = take();
    fence_all();
    logits(dk);
    hw::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < H; ++x) hw::fence_regs(s[x]);
    release(first, H);
    softmax(0);
    finish();
    for (int st = 0; st + 1 < steps; ++st) {
#pragma unroll
      for (int x = 0; x < H; ++x) dv[x] = take();
#pragma unroll
      for (int x = 0; x < H; ++x) dk[x] = take();
      fence_all();
      logits(dk);
      pv(dv);
      hw::wgmma_wait<1>();  // the logits done, P V may still run
#pragma unroll
      for (int x = 0; x < H; ++x) hw::fence_regs(s[x]);
      release(first + 2 * H * (st + 1), H);
      softmax(st + 1);
      hw::wgmma_wait<0>();
      after_pv(st);
      finish();
    }
#pragma unroll
    for (int x = 0; x < H; ++x) dv[x] = take();
    fence_all();
    pv(dv);
    hw::wgmma_wait<0>();
    after_pv(steps - 1);
  } else {
    for (int st = 0; st < steps; ++st) {
#pragma unroll
      for (int x = 0; x < H; ++x) dk[x] = take();
      fence_all();
      logits(dk);
      hw::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < H; ++x) hw::fence_regs(s[x]);
      release(first + 2 * H * st, H);
      softmax(st);
      finish();
#pragma unroll
      for (int x = 0; x < H; ++x) dv[x] = take();
      fence_all();
      pv(dv);
      hw::wgmma_wait<0>();
      after_pv(st);
    }
  }
  if constexpr (!kSingle) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] = quad_sum(l[hf]);
      inv[hf] = l[hf] == 0.f ? 1.f : 1.f / l[hf];
    }
  }

  // Rows r0 and r0 + 8 of the warpgroup's 64, every sub-head, rounded once
  // (the single step's P was normalised: inv 1 there).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= nq) continue;
    const float sc = kSingle ? 1.f : inv[hf];
    bf16* dst = p.out + (static_cast<long long>(b) * nq + row) * p.heads * p.dh +
                static_cast<long long>(h) * p.dh + c0;
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 64 * cc + 8 * j) =
            hw::pack_bf16x2(o[cc][4 * j + 2 * hf] * sc, o[cc][4 * j + 2 * hf + 1] * sc);
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[static_cast<long long>(bh) * nq + row] =
          m[hf] * kLn2 + logf(l[hf] == 0.f ? 1.f : l[hf]);
  }
}

// The wide instances' maps and sizes (q, k, v through their strides).
cudaError_t plan_wide(WideParams& p, const void* q, const void* k, const void* v, void* out,
                      void* lse, int batch, int heads, int nq, int nk, int dh,
                      const long long* st, float scale) {
  cudaError_t e =
      hw::map_strided_heads(&p.q, q, false, batch, nq, heads, dh, st[0], st[1], st[2], 64);
  if (e == cudaSuccess)
    e = hw::map_strided_heads(&p.k, k, false, batch, nk, heads, dh, st[3], st[4], st[5], 64);
  if (e == cudaSuccess)
    e = hw::map_strided_heads(&p.v, v, false, batch, nk, heads, dh, st[6], st[7], st[8], 64);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.dh = dh;
  p.nq = nq;
  p.nk = nk;
  p.scale_log2 = scale * kLog2e;
  return e;
}

template <int C, bool kSingle, bool kWindow>
cudaError_t launch_wide(const WideParams& p, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_wide_sm90<C, kSingle, kWindow>;
  constexpr int smem = fw::kFwdSmemBytes<C>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + 127) / 128, batch * p.heads);
  kernel<<<grid, fw::kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Maps and scale of a call (q, k, v through their strides); see
// sfc_flash_fwd_bf16.
cudaError_t plan(Params& p, const void* q, const void* k, const void* v, void* out, void* lse,
                 int batch, int heads, int nq, int nk, const long long* st, float scale) {
  cudaError_t e = hw::map_bnhd(&p.q, q, batch, nq, heads, st[0], st[1], st[2], BQ);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.k, k, batch, nk, heads, st[3], st[4], st[5], BK);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.v, v, batch, nk, heads, st[6], st[7], st[8], BK);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.scale_log2 = scale * kLog2e;
  return e;
}

template <bool kSingle, bool kWindow>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90<kSingle, kWindow>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + BQ - 1) / BQ, batch * p.heads);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q bf16 [batch, nq, heads, dh], k and v bf16 [batch, nk, heads, dh], each
// read through its (batch, row, head) strides in elements (unit stride
// along dh; strides multiples of 8 elements and the bases on 16 bytes, as
// TMA requires); out bf16 [batch, nq, heads, dh] contiguous; lse fp32
// [batch, heads, nq] or null.  streaming selects the one-pass form.  dh
// 64, 128 or 256.
extern "C" int sfc_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int heads, int nq, int nk, int dh,
                                  long long qsb, long long qsn, long long qsh, long long ksb,
                                  long long ksn, long long ksh, long long vsb, long long vsn,
                                  long long vsh, float scale, int streaming, void* stream) {
  if ((dh != 64 && dh != 128 && dh != 256) || nq < 1 || nk < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  if (dh != 64) {
    WideParams p{};
    cudaError_t e = plan_wide(p, q, k, v, out, lse, batch, heads, nq, nk, dh, st, scale);
    if (e != cudaSuccess) return static_cast<int>(e);
    auto s = static_cast<cudaStream_t>(stream);
    fw::with_wide(dh, [&](auto C) {
      constexpr int c = decltype(C)::value;
      e = streaming ? launch_wide<c, false, false>(p, batch, s)
                    : launch_wide<c, true, false>(p, batch, s);
    });
    return static_cast<int>(e);
  }
  Params p{};
  cudaError_t e = plan(p, q, k, v, out, lse, batch, heads, nq, nk, st, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  e = streaming ? launch<false, false>(p, batch, s) : launch<true, false>(p, batch, s);
  return static_cast<int>(e);
}

// #12: q, k, v bf16 [batch, n, heads, dh] read through their (batch, row,
// head) strides in elements (unit stride along dh; strides multiples of 8
// elements, bases on 16 bytes); out bf16 [batch, n, heads, dh]
// contiguous; lse fp32 [batch, heads, n] or null.  Query i meets the keys
// j with |i / block - j / block| <= halo: dh 64, 128 or 256, block a
// positive multiple of 64, halo >= 1.
extern "C" int sfc_local_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int heads, int n, int dh, int block,
                                  int halo, long long qsb, long long qsn, long long qsh,
                                  long long ksb, long long ksn, long long ksh, long long vsb,
                                  long long vsn, long long vsh, float scale, void* stream) {
  if ((dh != 64 && dh != 128 && dh != 256) || n < 1 || heads < 1 || batch < 0 || block < 64 ||
      block % 64 || halo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  if (dh != 64) {
    WideParams p{};
    cudaError_t e = plan_wide(p, q, k, v, out, lse, batch, heads, n, n, dh, st, scale);
    if (e != cudaSuccess) return static_cast<int>(e);
    p.block = block;
    p.halo = halo;
    fw::with_wide(dh, [&](auto C) {
      e = launch_wide<decltype(C)::value, true, true>(p, batch, static_cast<cudaStream_t>(stream));
    });
    return static_cast<int>(e);
  }
  Params p{};
  cudaError_t e = plan(p, q, k, v, out, lse, batch, heads, n, n, st, scale);
  p.block = block;
  p.halo = halo;
  if (e == cudaSuccess) e = launch<true, true>(p, batch, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the streaming (1),
// single-step (0) or windowed single-step (2, #12) kernel, into out[3].
extern "C" int sfc_flash_fwd_attrs(int form, int* out) {
  switch (form) {
    case 0: return hw::kernel_attrs(flash_fwd_sm90<true>, kSmemBytes, out);
    case 1: return hw::kernel_attrs(flash_fwd_sm90<false>, kSmemBytes, out);
    case 2: return hw::kernel_attrs(flash_fwd_sm90<true, true>, kSmemBytes, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for the instances at dh 128 and 256.
extern "C" int sfc_flash_fwd_wide_attrs(int dh, int form, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  fw::with_wide(dh, [&](auto C) {
    constexpr int c = decltype(C)::value, smem = fw::kFwdSmemBytes<c>;
    err = form == 0   ? hw::kernel_attrs(flash_fwd_wide_sm90<c, true, false>, smem, out)
          : form == 1 ? hw::kernel_attrs(flash_fwd_wide_sm90<c, false, false>, smem, out)
          : form == 2 ? hw::kernel_attrs(flash_fwd_wide_sm90<c, true, true>, smem, out)
                      : static_cast<int>(cudaErrorInvalidValue);
  });
  return err;
}
