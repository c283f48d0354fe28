// Softmax-attention backward straight off the packed QKV projection, for
// Hopper: the attention part of ViT-B's block backward (kernel #4, head
// dim 64, no dropout, up to 256 tokens) and of family A's MHA backward
// with probability dropout (kernel #6: head dim 64 up to 192 tokens, head
// dim 192 at up to 64 tokens, with the 0/1 mask and keep), and at every
// head dim Dh that is a multiple of 16 up to 192: C = ceil(Dh / 64)
// sub-heads of 64 columns, one 64-row tile from C = 2 (ATTENTION_BWD_SM90_
// LIMITS in ops/_build.py; Dh 208 to 256 would need 256 KB).  Longer rows
// and Dh 208 to 256 run on its streamed form,
// csrc/attention_bwd_stream_sm90.cu, the same formula.
//
// Replaces: the per-(image, head) loops of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel (lines
// 423-496) on the path the TPU trains with (with_acts + with_lse: the
// forward saved qkv, att and the log-sum-exp), and, with the mask, of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel (lines
// 331-378).  It reads q, k and v from qkv
// [B, N, 3*H*Dh] at columns h*Dh, (H + h)*Dh and (2H + h)*Dh, da from
// datt [B, N, H*Dh] (= bf16(gp . W_out^T)), the forward's att [B, N, H*Dh]
// and lse [B, H, N] (and the mask [B, H, N, N]), and writes dq, dk and dv
// into the packed dqkv at the same columns.
//
// The TPU kernels' rounding points.  Without dropout
// (#4): pn = bf16(exp(s * scale - lse)), keys at or past n_valid giving 0;
// dpn = da . v^T in fp32; ds = bf16(pn * (dpn - delta) * scale);
// dv = pn^T . da.  With the mask and keep (#6): pf = exp(s * scale - lse)
// stays fp32; pdf = (pf / keep) * mask; dp = ((da . v^T) / keep) * mask;
// ds = bf16(pf * (dp - delta) * scale); dv = bf16(pdf)^T . da (pf itself is
// never rounded; x / keep is the correctly rounded quotient by
// sfc::div_rn, never x times a rounded reciprocal: `x / keep` compiles to
// a subroutine with a slow-path branch, which dominated the masked forms'
// time on the H100).  In both,
// delta = rowsum(da * att_h) in fp32, dq = ds . k and dk = ds^T . q, each
// one fp32 sum over the sequence rounded once.
//
// Bound on this card: the bytes.  At ViT-B (N = 196, 12 heads, batch 256)
// the five products are 75.5 GFLOP (0.076 ms at 989 TFLOP/s) on 5 x 77 MB
// read and 231 MB written (0.18 ms at 3.35 TB/s); at the flagship (N = 64,
// 4 heads of 192, batch 512) 16 GFLOP (0.016 ms) on ~411 MB with the mask
// (0.12 ms).
// Design: one (image, head) is an item; its q, k, v and da fit one block
// as 64-row tiles of 64-column sub-heads (a head of 192 is three; every
// TMA box is 64 x 64 and 128-byte swizzled, sm90.cuh::map_heads, whose
// boxes load a ragged head's columns past Dh as zeros and store nothing
// there: the zeros add nothing to S, dP or delta, and give zero columns
// of dq, dk and dv that are never written).  A persistent grid (one block an SM, two
// warpgroups and no producer warp: 255 registers a thread) walks the
// items; thread 0 brings each tile by TMA (rows past N read as zero) and
// the item's mask by one bulk copy into a dense [N][N] byte tile (by plain
// loads where N * N is not a multiple of 16).  K and V sit in a two-item
// ring, so the next item's K and V arrive while this one computes; at one
// 64-row tile (N <= 64: the main paths of both family-A models) Q, dA and
// the mask are in the ring too, else they are refilled at each item's
// start (two items of all of them do not fit 227 KB).
//  * pass 0: delta = rowsum(da * att_h) (da from shared memory, att from
//    global memory; four threads a row at one tile), kept with
//    lse * log2(e) in shared memory.
//  * work units: dq of each query tile, then dk and dv of each key tile,
//    dealt to the two warpgroups in turn (at one tile: dq on warpgroup 0,
//    dk and dv on warpgroup 1).
//  * dq of a query tile: S = Q K_j^T and dP = dA V_j^T by wgmma (4 S k16
//    steps each) for each key tile j, pn or pf, the mask and ds in
//    registers, dq += ds . K_j with ds as the register A operand (the
//    accumulator-to-A map of sm90.cuh); at Dh 192 three 64-column
//    accumulators (96 registers), at Dh 128 two.
//  * dk and dv of a key tile: S^T = K_j Q_i^T and dP^T = V_j dA_i^T for
//    each query tile i, the mask read transposed from shared memory
//    (mask[q][key] with the key as the accumulator's row), pn^T (or
//    bf16(pdf)^T) and ds^T as register A operands: dv += them . dA_i and
//    dk += ds^T . Q_i.  At Dh 192 (one tile) the A operands are formed
//    once and dv, then dk, leave by 64-column chunk: 32 accumulators a
//    thread where all six chunks held at once would need 192.
//    The logits and dp are computed twice (once per orientation): the
//    transposed tiles of all (i, j) pairs would need more shared memory
//    than the block has, and the products are several times under the
//    byte time.
// dq, dk and dv leave once each, rounded to bf16, through a swizzled
// staging tile by TMA store (rows past N are not written): no second
// kernel, no scratch in global memory and no atomics, so the same inputs
// give the same bits.  Every wgmma wait has a fixed count.

#include <type_traits>

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBox = 64 * 128;  // a 64-row tile of one 64-column sub-head, swizzled
using hw::kLog2e;

// The longest sequences (the Python ATTENTION_BWD_SM90_MAX_N*): head dim 64
// without dropout and with it, and head dims 80 to 192 (one tile).
constexpr int kMaxN64 = 256, kMaxN64Drop = 192, kMaxN192 = 64;

// An instance: S sub-heads a head (Dh up to 64 S), DROP the mask form,
// MAXT 64-row tiles of the longest sequence it takes.
template <int S, bool DROP, int MAXT>
struct Cfg {
  static_assert(S == 1 || MAXT == 1, "head dims past 64 take one 64-row tile");
  static constexpr int kQdSlots = MAXT == 1 ? 2 : 1;  // Q, dA and mask in the ring
  static constexpr int kMaskBytes = DROP ? 64 * MAXT * 64 * MAXT : 16;
  static constexpr int kRowSplit = MAXT == 1 ? 4 : 1;  // threads a row in pass 0
  static constexpr int kRowChunks = 8 * S / kRowSplit;  // 8-column chunks a thread
};

template <int S, bool DROP, int MAXT>
struct Smem {
  using C = Cfg<S, DROP, MAXT>;
  unsigned char kv[2][2][MAXT][S][kBox];            // K and V of two items
  unsigned char qd[C::kQdSlots][2][MAXT][S][kBox];  // Q and dA
  unsigned char out[2][kBox];                       // each warpgroup's staging tile
  unsigned char mask[C::kQdSlots][C::kMaskBytes];   // [n][n] 0/1 bytes
  float lse[64 * MAXT];                             // lse * log2(e) by query row
  float delta[64 * MAXT];
  uint64_t kv_full[2], qd_full;
};
template <int S, bool DROP, int MAXT>
constexpr int kSmemBytes = sizeof(Smem<S, DROP, MAXT>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap qkv, da, out;  // map_heads: 3 H heads of qkv and of dqkv, H of datt
  const bf16* att;
  const float* lse;
  const uint8_t* mask;
  int n, heads, dh, n_valid, tiles, items, mask_bulk;
  float scale, scale_log2, keep;
};

template <int S, bool DROP, int MAXT>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_sm90(const __grid_constant__ Params p) {
  using C = Cfg<S, DROP, MAXT>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  auto& sm = hw::aligned_smem<Smem<S, DROP, MAXT>>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t = tid % 128;
  // This thread's accumulator rows r0 and r0 + 8 of a 64-row tile, and
  // columns 8 j + c0 + {0, 1}.
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (lane % 4);
  // Scalars in registers (fields of the __grid_constant__ parameter read
  // through the lambdas' references would be generic loads).
  const int H = p.heads, dh = p.dh, n = p.n, n_valid = p.n_valid, tiles = p.tiles,
            items = p.items;
  const float scale = p.scale, c = p.scale_log2, keep = p.keep, rk = __frcp_rn(keep);
  const uint8_t* const mask_g = p.mask;
  const bool mask_bulk = DROP && p.mask_bulk != 0;
  const uint32_t tensor_bytes = tiles * S * kBox;
  const uint32_t mask_bytes = mask_bulk ? n * n : 0;

  if (tid == 0) {
    hw::bar_init(&sm.kv_full[0], 1);
    hw::bar_init(&sm.kv_full[1], 1);
    hw::bar_init(&sm.qd_full, 1);
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Q and dA (and, by bulk copy, the mask) of `item` into slot q.
  auto load_qd = [&](int item, int q, uint64_t* bar) {
    const int b = item / H, h = item % H;
    for (int i = 0; i < tiles; ++i)
      for (int cc = 0; cc < S; ++cc) {
        hw::tma_load4(sm.qd[q][0][i][cc], &p.qkv, bar, 64 * cc, h, 64 * i, b);
        hw::tma_load4(sm.qd[q][1][i][cc], &p.da, bar, 64 * cc, h, 64 * i, b);
      }
    if (mask_bulk)
      hw::bulk_load(sm.mask[q], mask_g + static_cast<size_t>(item) * n * n, mask_bytes, bar);
  };
  auto load_kv = [&](int item, int slot) {
    const int b = item / H, h = item % H;
    for (int i = 0; i < tiles; ++i)
      for (int cc = 0; cc < S; ++cc) {
        hw::tma_load4(sm.kv[slot][0][i][cc], &p.qkv, &sm.kv_full[slot], 64 * cc, H + h,
                      64 * i, b);
        hw::tma_load4(sm.kv[slot][1][i][cc], &p.qkv, &sm.kv_full[slot], 64 * cc, 2 * H + h,
                      64 * i, b);
      }
  };
  if (tid == 0 && blockIdx.x < items) {
    if constexpr (C::kQdSlots == 2) {
      hw::bar_expect_tx(&sm.kv_full[0], 4 * tensor_bytes + mask_bytes);
      load_qd(blockIdx.x, 0, &sm.kv_full[0]);
    } else {
      hw::bar_expect_tx(&sm.kv_full[0], 2 * tensor_bytes);
    }
    load_kv(blockIdx.x, 0);
  }

  uint32_t qd_phase = 0;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int b = item / H, h = item % H;
    const int slot = it & 1, qs = C::kQdSlots == 2 ? slot : 0;
    // Pass 0's row (a part of it at one tile) of att and its lse, read
    // before the wait for the buffers; a ragged head's chunks past Dh are
    // zero (its dA columns there are zero too).
    const int prow = tid / C::kRowSplit, ppart = tid % C::kRowSplit;
    uint4 att_row[C::kRowChunks];
    float lse_row = 0.f;
    if (prow < n) {
      const uint4* src = reinterpret_cast<const uint4*>(
          p.att + (static_cast<size_t>(b) * n + prow) * H * dh + static_cast<size_t>(h) * dh);
#pragma unroll
      for (int k = 0; k < C::kRowChunks; ++k) {
        const int kc = ppart * C::kRowChunks + k;
        att_row[k] = 8 * kc < dh ? src[kc] : make_uint4(0u, 0u, 0u, 0u);
      }
      lse_row = p.lse[(static_cast<size_t>(b) * H + h) * n + prow];
    }
    // Every thread is done with the previous item (its buffers, lse and
    // delta); generic reads of the buffers are ordered before the TMA
    // writes that refill them.
    hw::fence_async_shared();
    hw::named_sync(1, kThreads);
    if (tid == 0) {
      const int next = item + gridDim.x;
      if constexpr (C::kQdSlots == 1) {
        hw::bar_expect_tx(&sm.qd_full, 2 * tensor_bytes + mask_bytes);
        load_qd(item, 0, &sm.qd_full);
        if (next < items) {
          hw::bar_expect_tx(&sm.kv_full[slot ^ 1], 2 * tensor_bytes);
          load_kv(next, slot ^ 1);
        }
      } else if (next < items) {
        hw::bar_expect_tx(&sm.kv_full[slot ^ 1], 4 * tensor_bytes + mask_bytes);
        load_qd(next, slot ^ 1, &sm.kv_full[slot ^ 1]);
        load_kv(next, slot ^ 1);
      }
    }
    if (DROP && !mask_bulk) {  // n * n not a multiple of 16: no bulk copy
      const uint8_t* src = mask_g + static_cast<size_t>(item) * n * n;
      for (int i = tid; i < n * n; i += kThreads) sm.mask[qs][i] = src[i];
    }
    if constexpr (C::kQdSlots == 1) {
      hw::bar_wait(&sm.qd_full, qd_phase);
      qd_phase ^= 1;
    } else {
      hw::bar_wait(&sm.kv_full[slot], (it >> 1) & 1);
    }

    // Pass 0: delta = rowsum(da * att_h) in fp32.
    float dl = 0.f;
    if (prow < n) {
#pragma unroll
      for (int k = 0; k < C::kRowChunks; ++k) {
        const int kc = ppart * C::kRowChunks + k;  // sub-head kc / 8, columns 8 (kc % 8)
        float a[8], g[8];
        sfc::unpack_bf16x8(att_row[k], a);
        sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(
                               sm.qd[qs][1][prow / 64][kc / 8] +
                               hw::sw128_bf16(prow % 64, 8 * (kc % 8))),
                           g);
#pragma unroll
        for (int e = 0; e < 8; ++e) dl += a[e] * g[e];
      }
    }
    if constexpr (C::kRowSplit > 1) {  // the row's four threads are neighbouring lanes
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    }
    if (ppart == 0 && prow < 64 * MAXT) {  // rows past n: lse and delta 0
      sm.lse[prow] = lse_row * kLog2e;
      sm.delta[prow] = dl;
    }
    hw::named_sync(1, kThreads);
    if constexpr (C::kQdSlots == 1) hw::bar_wait(&sm.kv_full[slot], (it >> 1) & 1);

    const uint8_t* const mk = sm.mask[qs];
    // Round a warpgroup's 64 x 64 accumulator into its staging tile and
    // store it as rows row0.. of head `head`'s sub-head cc (clipped at Dh).
    unsigned char* st = sm.out[wg];
    auto store = [&](const float (&acc)[32], int head, int cc, int row0) {
      if (t == 0) hw::bulk_wait_read<0>();
      hw::named_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(st + hw::sw128_bf16(r0 + 8 * hf, 8 * j + c0)) =
              hw::pack_bf16x2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      hw::fence_async_shared();
      hw::named_sync(2 + wg, 128);
      if (t == 0) {
        hw::tma_store4(&p.out, st, 64 * cc, head, row0, b);
        hw::bulk_commit();
      }
    };
    // acc (m64n64) = A . B^T over the head (4 S k16 steps), both tiles
    // K-major, A and B each S sub-head tiles.
    auto product_t = [&](float (&acc)[32], unsigned char (*a)[kBox],
                         unsigned char (*bt)[kBox]) {
#pragma unroll
      for (int cc = 0; cc < S; ++cc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hw::wgmma_ss<0, 0>(acc, hw::desc_sw128(a[cc]) + 2 * kk,
                             hw::desc_sw128(bt[cc]) + 2 * kk, cc + kk > 0 ? 1 : 0);
    };
    const int key_tiles = (n_valid + 63) / 64;  // keys past n_valid add nothing
    float s[32], dp[32];
    uint32_t fa[4][4], fb[4][4];

    // The logits and dp of a 64 x 64 pair, in either orientation.
    auto logits = [&](unsigned char (*a)[kBox], unsigned char (*bt)[kBox],
                      unsigned char (*a2)[kBox], unsigned char (*bt2)[kBox]) {
      hw::fence_regs(s);
      hw::fence_regs(dp);
      hw::wgmma_fence();
      product_t(s, a, bt);
      product_t(dp, a2, bt2);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
    };

    // dq of query tile i.
    auto dq_tile = [&](int i) {
      unsigned char(*qt)[kBox] = sm.qd[qs][0][i];
      unsigned char(*dat)[kBox] = sm.qd[qs][1][i];
      float lq[2], dlq[2];
      int qrow[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        qrow[hf] = 64 * i + r0 + 8 * hf;
        lq[hf] = sm.lse[qrow[hf]];
        dlq[hf] = sm.delta[qrow[hf]];
      }
      // At one tile the products start dq (no zeroing), so dq is live only
      // from them to its store: at Dh 192 its 96 registers are never live
      // beside the logits' 64.  Past one tile dq is zeroed and summed over
      // the key tiles.
      float dq[S][32];
      if constexpr (MAXT > 1) {
#pragma unroll
        for (int cc = 0; cc < S; ++cc)
#pragma unroll
          for (int e = 0; e < 32; ++e) dq[cc][e] = 0.f;
      }
      const int jn = MAXT == 1 ? 1 : key_tiles;
      for (int j = 0; j < jn; ++j) {
        unsigned char(*kt)[kBox] = sm.kv[slot][0][j];
        logits(qt, kt, dat, sm.kv[slot][1][j]);  // s = q . k^T, dp = da . v^T
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hf = (e / 2) % 2, key = 64 * j + 8 * (e / 4) + c0 + (e % 2);
          const bool ok = key < n_valid;
          const float pe = ok ? hw::exp2_approx(fmaf(s[e], c, -lq[hf])) : 0.f;
          if constexpr (DROP) {
            const bool kept = ok && qrow[hf] < n && mk[qrow[hf] * n + key] != 0;
            s[e] = pe * ((kept ? sfc::div_rn(dp[e], keep, rk) : 0.f) - dlq[hf]) * scale;
          } else {
            s[e] = __bfloat162float(__float2bfloat16(pe)) * (dp[e] - dlq[hf]) * scale;
          }  // ds, rounded by acc_to_a
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, fa[kk]);
#pragma unroll
        for (int cc = 0; cc < S; ++cc) hw::fence_regs(dq[cc]);
        hw::fence_frags(fa);
        hw::wgmma_fence();
#pragma unroll
        for (int cc = 0; cc < S; ++cc)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dq += ds . k (k read through the transpose bit)
            hw::wgmma_rs<1>(dq[cc], fa[kk], hw::desc_sw128(kt[cc]) + kk * (2048 >> 4),
                            MAXT > 1 || kk > 0 ? 1 : 0);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int cc = 0; cc < S; ++cc) hw::fence_regs(dq[cc]);
        hw::fence_frags(fa);
      }
#pragma unroll
      for (int cc = 0; cc < S; ++cc) store(dq[cc], h, cc, 64 * i);
    };

    // pn^T (or bf16(pdf)^T) into fa and ds^T into fb from the transposed
    // logits and dp of key tile j against query tile i.
    auto transposed_a = [&](int i, int j) {
      bool key_ok[2];
      int krow[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        krow[hf] = 64 * j + r0 + 8 * hf;
        key_ok[hf] = krow[hf] < n_valid;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hf = (e / 2) % 2, q = 64 * i + 8 * (e / 4) + c0 + (e % 2);
        const float pe = key_ok[hf] ? hw::exp2_approx(fmaf(s[e], c, -sm.lse[q])) : 0.f;
        if constexpr (DROP) {
          const bool kept = key_ok[hf] && q < n && mk[q * n + krow[hf]] != 0;
          s[e] = kept ? sfc::div_rn(pe, keep, rk) : 0.f;  // pdf^T
          dp[e] = pe * ((kept ? sfc::div_rn(dp[e], keep, rk) : 0.f) - sm.delta[q]) * scale;  // ds^T
        } else {
          const float pn = __bfloat162float(__float2bfloat16(pe));
          s[e] = pn;
          dp[e] = pn * (dp[e] - sm.delta[q]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hw::acc_to_a(s, kk, fa[kk]);
        hw::acc_to_a(dp, kk, fb[kk]);
      }
    };

    // dk and dv of key tile j.
    auto dkv_tile = [&](int j) {
      unsigned char(*kt)[kBox] = sm.kv[slot][0][j];
      unsigned char(*vt)[kBox] = sm.kv[slot][1][j];
      if constexpr (S == 1) {
        float dk[32], dv[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
        for (int i = 0; j < key_tiles && i < tiles; ++i) {
          unsigned char(*qt)[kBox] = sm.qd[qs][0][i];
          unsigned char(*dat)[kBox] = sm.qd[qs][1][i];
          logits(kt, qt, vt, dat);  // s^T = k . q^T, dp^T = v . da^T
          transposed_a(i, j);
          hw::fence_regs(dk);
          hw::fence_regs(dv);
          hw::fence_frags(fa);
          hw::fence_frags(fb);
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            hw::wgmma_rs<1>(dv, fa[kk], hw::desc_sw128(dat[0]) + kk * (2048 >> 4), 1);
            hw::wgmma_rs<1>(dk, fb[kk], hw::desc_sw128(qt[0]) + kk * (2048 >> 4), 1);
          }
          hw::wgmma_commit();
          hw::wgmma_wait<0>();
          hw::fence_regs(dk);
          hw::fence_regs(dv);
          hw::fence_frags(fa);
          hw::fence_frags(fb);
        }
        store(dk, H + h, 0, 64 * j);
        store(dv, 2 * H + h, 0, 64 * j);
      } else {  // one tile (i = j = 0): the A operands once, then dv and dk by chunk
        unsigned char(*qt)[kBox] = sm.qd[qs][0][0];
        unsigned char(*dat)[kBox] = sm.qd[qs][1][0];
        logits(kt, qt, vt, dat);
        transposed_a(0, 0);
        float acc[32] = {};
#pragma unroll
        for (int w = 0; w < 2 * S; ++w) {  // dv's S chunks, then dk's
          const bool is_v = w < S;
          const int cc = is_v ? w : w - S;
          const uint64_t db = hw::desc_sw128(is_v ? dat[cc] : qt[cc]);
          hw::fence_regs(acc);
          hw::fence_frags(fa);
          hw::fence_frags(fb);
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hw::wgmma_rs<1>(acc, is_v ? fa[kk] : fb[kk], db + kk * (2048 >> 4), kk > 0 ? 1 : 0);
          hw::wgmma_commit();
          hw::wgmma_wait<0>();
          hw::fence_regs(acc);
          store(acc, (is_v ? 2 * H : H) + h, cc, 0);
        }
      }
    };

    // Work units: dq of each query tile, then dk / dv of each key tile,
    // dealt to the warpgroups in turn.
    for (int u = wg; u < 2 * tiles; u += 2) {
      if (u < tiles) dq_tile(u);
      else dkv_tile(u - tiles);
    }
  }
  if (t == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

template <int S, bool DROP, int MAXT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = attention_bwd_sm90<S, DROP, MAXT>;
  constexpr int smem = kSmemBytes<S, DROP, MAXT>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, smem, p.items, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The longest sequence an instance takes at c sub-heads, with the mask
// or without (the Python ATTENTION_BWD_SM90_LIMITS): one 64-row tile from
// C = 2; none at C = 4 (two items' tiles need 256 KB).
constexpr int max_n(int c, bool drop) {
  return c == 1 ? (drop ? kMaxN64Drop : kMaxN64) : c < 4 ? kMaxN192 : 0;
}

// The instances by form number (sfc_attention_bwd_sm90_attrs), f(S, DROP,
// MAXT) as integral constants; false where there is none.
template <typename F>
bool with_form(int form, F&& f) {
  using std::integral_constant;
  using T = std::true_type;
  using N = std::false_type;
  using I1 = integral_constant<int, 1>;
  switch (form) {
    case 0: f(I1{}, N{}, integral_constant<int, 4>{}); return true;
    case 1: f(I1{}, T{}, I1{}); return true;
    case 2: f(I1{}, T{}, integral_constant<int, 3>{}); return true;
    case 3: f(integral_constant<int, 3>{}, N{}, I1{}); return true;
    case 4: f(integral_constant<int, 3>{}, T{}, I1{}); return true;
    case 5: f(integral_constant<int, 2>{}, N{}, I1{}); return true;
    case 6: f(integral_constant<int, 2>{}, T{}, I1{}); return true;
    default: return false;
  }
}

// The form for c sub-heads, the mask and n tokens (n within max_n).
int form_of(int c, bool drop, int n) {
  if (c == 1) return !drop ? 0 : n <= 64 ? 1 : 2;
  return c == 3 ? (drop ? 4 : 3) : (drop ? 6 : 5);
}

}  // namespace

// qkv bf16 [batch, n, 3*heads*dh], att and datt bf16 [batch, n, heads*dh],
// lse fp32 [batch, heads, n], mask uint8 0/1 [batch, heads, n, n] or null
// (no dropout; keep in (0, 1] with a mask), all contiguous and on 16
// bytes; dqkv bf16 [batch, n, 3*heads*dh] receives dq, dk and dv (every
// element is written).  Keys at or past n_valid (1 <= n_valid <= n) are
// masked.  dh a multiple of 16: up to 64, 1 <= n <= 256 without a mask,
// <= 192 with one; 80 to 192, 1 <= n <= 64.
extern "C" int sfc_attention_bwd_sm90_bf16(const void* qkv, const void* att, const void* datt,
                                           const void* lse, const void* mask, void* dqkv,
                                           int batch, int n, int heads, int dh, int n_valid,
                                           float scale, float keep, void* stream) {
  const bool drop = mask != nullptr;
  const int c = hw::subheads(dh);
  if (!hw::head_dim_ok(dh) || n < 1 || n > max_n(c, drop) || heads < 1 || n_valid < 1 ||
      n_valid > n || batch < 0 || (drop && !(keep > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long row = 3LL * heads * dh, inner = static_cast<long long>(heads) * dh;
  Params p{};
  cudaError_t e = hw::map_heads(&p.qkv, qkv, false, batch, n, 3 * heads, dh, row, 64);
  if (e == cudaSuccess) e = hw::map_heads(&p.da, datt, false, batch, n, heads, dh, inner, 64);
  if (e == cudaSuccess) e = hw::map_heads(&p.out, dqkv, false, batch, n, 3 * heads, dh, row, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.att = static_cast<const bf16*>(att);
  p.lse = static_cast<const float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_bulk = drop && (n * n) % 16 == 0;  // each item's mask on 16 bytes
  p.n = n;
  p.heads = heads;
  p.dh = dh;
  p.n_valid = n_valid;
  p.tiles = (n + 63) / 64;
  p.items = batch * heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.keep = drop ? keep : 1.f;
  auto s = static_cast<cudaStream_t>(stream);
  e = cudaErrorInvalidValue;
  with_form(form_of(c, drop, n), [&](auto S, auto D, auto T) {
    e = launch<decltype(S)::value, decltype(D)::value, decltype(T)::value>(p, s);
  });
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of instance `form` into out[3]:
// 0 head dim 64 without dropout (#4), 1 and 2 head dim 64 with the mask at
// one tile and up to three, 3 and 4 head dim 192 without and with it, 5
// and 6 head dim 128 (two sub-heads) without and with it.
extern "C" int sfc_attention_bwd_sm90_attrs(int form, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_form(form, [&](auto S, auto D, auto T) {
    constexpr int s = decltype(S)::value, t = decltype(T)::value;
    constexpr bool d = decltype(D)::value;
    err = hw::kernel_attrs(attention_bwd_sm90<s, d, t>, kSmemBytes<s, d, t>, out);
  });
  return err;
}
