// Attention straight off the packed QKV projection, for Hopper:
// out[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale, keys < n_valid) . V
// for every image b and head h, with q, k and v read from qkv bf16
// [B, N, 3*H*Dh] at columns h*Dh, inner + h*Dh and 2*inner + h*Dh (inner =
// H*Dh), and optionally lse[b, h, i] = the natural log-sum-exp of the
// scaled logits of row i over the valid keys; with a 0/1 dropout mask
// [B, H, N, N] (uint8) and keep, bf16((P / keep) * mask) takes the place
// of bf16(P).  Every head dim Dh that is a multiple of 16 up to 256, N up
// to 1,024.
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_packed_kernel (lines
// 907-940, called at :979; kernel #7, the family-A serving path), the
// attention of sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel
// (lines 153-195, with its save_lse output at :188-189; kernel #1, ViT-B's
// served forward and training forward) and, with the mask, the
// per-(image, head) loops of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (lines
// 109-139; kernel #5, family A's training forward: the flagship at Dh 192,
// 'hier' at Dh 64), which compute the same formula: fp32 logits times
// scale, keys at or past n_valid masked, m = the row max, p = exp(s - m),
// l = the row sum, P = p / l rounded to bf16 BEFORE the P.V product (JAX's
// rounding point, kept at every N), P.V summed in fp32 and rounded once;
// lse = m + log(l), taken before dropout.  With the mask, Pd = (P / keep)
// * mask in fp32, divided by keep and not multiplied by its reciprocal
// (sfc::div_rn, the correctly rounded quotient in three instructions),
// then rounded to bf16 (_torch_mha_kernel:128-133).  Masked keys get -1e30
// (never -inf: p = 0, no NaN) and add nothing to l.  Exponentials are exp2
// with log2(e) folded into the scale; lse is converted back once a row.
//
// Bound on this card: the bytes.  At ViT-B's training shape [256, 196,
// 12 x 64] with lse an (image, head) is 4 x 196 x 196 x 64 = 9.8 MFLOP on
// 75 KB of q/k/v and 25 KB of output (~100 flops a byte against the
// H100's ~295): 231 MB read, 77 MB + 2.4 MB of lse written, 0.093 ms at
// 3.35 TB/s.  The flagship's [256, 64, 2304] (4 heads of 192, ~33 flops a
// byte) and 'hier''s [B, 64 or 192, 768] are bound the same way; #5's
// masked training forward at the flagship's [512, 64, 4 x 192] reads
// 151 MB of qkv and 8.4 MB of mask and writes 50 MB and 0.5 MB of lse
// (0.063 ms).  Beside the bytes, the exponentials: one ex2 a logit at the
// SFU's 16 an SM a clock is ~0.04 ms at ViT-B, so masked key groups skip
// theirs.
// Design: a persistent grid of min(items, SMs x blocks an SM) blocks,
// where an item is one (image, head, 64-query tile) and block i walks
// items i, i + grid, ...  A block is one producer warp and one consumer
// warpgroup (160 threads).
//  * The producer's one thread keeps the next items' bytes in flight by
//    TMA: the Q tile into a two-slot buffer, K and V tiles (64 keys x Dh)
//    into a ring of slots, each 64-row tile as C = ceil(Dh / 64) boxes of
//    map_heads over the packed projection (3 H heads of Dh columns, Dh 192
//    read as three 64-column sub-heads), 128-byte swizzled; rows past n
//    read as zero, and so do a ragged head's columns past Dh (Dh 96 is two
//    sub-heads, the second half zero; 32 and 48 one): zero columns add
//    exact zeros to every logit and give zero output columns, which the
//    store, clipped at Dh by the same map, never writes.
//    With the mask, a 64 x 64 byte tile of it for each key tile, 64-byte
//    swizzled, into a ring of its own (map_mask_u8 over the [B H N, N]
//    rows; where N % 16 != 0 the rows are no TMA box and the consumers
//    copy the tile with plain loads into the same slot).
//  * The consumer warpgroup computes S = Q.K^T by wgmma from the swizzled
//    tiles (4 C k16 steps; the accumulator in registers, each thread
//    two rows), then:
//    - one pass where the whole row fits one warpgroup's accumulators
//      beside O's 32 C registers (sm90.cuh::one_pass_tiles, the Python
//      PACKED_ONE_PASS_MAX_N: n_valid to 256 keys at C = 1, 192 at C = 2,
//      64 at C = 3 and 4; with the mask 192, 128, 64 and 64,
//      PACKED_ONE_PASS_MAX_N_MASKED): an instance for each width NK of the
//      logits held, 64, 128, 192, 200 and 256 keys (the narrowest that
//      covers n_valid; 200 for ViT-B's 196 holds 100 registers where 256
//      holds 128; the masked forms 64, 128 and 192).  The item's K tiles
//      sit in consecutive ring slots, so S is one m64nNK wgmma a k16 step
//      over all of them (K read once, the logits computed once; no
//      exchange between warpgroups); the exact row max and sum across
//      each row's quad of threads; exponentials skipped for key groups of
//      8 wholly past n_valid; P = exp(s - m) / l in fp32 (with the mask:
//      its tiles read from shared memory, two bytes a row and key pair,
//      and Pd = (P / keep) * mask, skipped for the dead key groups too)
//      rounded once to bf16 as the register A operand, the logits dying as
//      P's NK / 4 registers are made; O = P.V by wgmma (Dh / 64 m64n64
//      products a k16 step, V read through the transpose bit; a last half
//      step's missing 8 keys are zero).  The ring holds the item's 2 KT
//      tiles (KT = NK / 64 rounded up), at least 4 (3 at C = 4), so the
//      next item's K tiles load while this item's P.V runs.  One consumer warpgroup
//      leaves the tensor cores idle during its exponentials, so the
//      instances to 200 keys are compiled for two blocks an SM (ten warps:
//      168 registers a thread; 163 used at 200 keys) and interleave; the
//      256-key one needs 211 and runs one block an SM (at 168 it spilled
//      112 bytes as four m64n64 products a step, 64 as one m64n256); from
//      C = 2 every instance runs one block an SM (O alone is 64 to 128
//      registers, and a 16 to 32 KB tile leaves room for one).  Each
//      k16 step's descriptors are formed inside the wgmma's asm block
//      (sm90.cuh's *_at forms), so only the bases stay live.
//    - two passes over the ring's 64-key tiles for longer rows (to 1,024;
//      Dh 192 past 64 keys): the first keeps the running max and rescaled
//      sum, the second recomputes each logits tile and adds bf16(P).V (or
//      bf16(Pd).V, its mask tile in flight with the tile's K and V).
//      The logits are computed twice, as #8's single K step does, to keep
//      the rounding point at any N.
//  * lse, where asked for, by per-thread 4-byte stores (one lane of each
//    row's quad): a row of N fp32 starts off 16 bytes when N % 4 != 0, so
//    no TMA box (ROADMAP F2).
//  * The epilogue rounds O to bf16 into a two-slot (one at C = 4)
//    128-byte-swizzled staging tile and writes it by TMA store (rows at or
//    past n, and columns past Dh, are not written), so the store overlaps
//    the next item.
// Shared memory: (2 Q + ring + 2 staging) x 64 C x 128 bytes: 197,728
// bytes at C = 3 (one block an SM), 66,656 at C = 1 to 128 keys and in two
// passes (three), 83,072 at 192 keys (two), 99,488 at 200 (two) and 256
// (one); at C = 2 132,192, 164,992 with the 192-key ring; at C = 4 (32 KB
// a tile) 2 Q + 3 ring + 1 staging, 197,712; the masked forms add a 4 KB
// mask tile a slot of a ring of two items' (or two second-pass tiles')
// tiles: 8 KB at 64 keys and in two passes, 16 KB at 128, 24 KB at 192.
// The K/V ring is laid out sub-head-major, so the one-pass forms' K tiles
// of one sub-head are one contiguous wide operand at every C.  Every
// wgmma group is waited on at once (fixed wait counts, no branch between a
// wgmma and its wait).

#include <type_traits>

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BM = 64;                  // queries an item, keys a tile
constexpr int kMaxN = 1024;             // the Python PACKED_MAX_N
constexpr int kConsumerThreads = 128;   // one warpgroup
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kBox = 64 * 128;          // one 64-row x 64-column swizzled box, bytes
constexpr int kMaskTile = BM * BM;      // a 64-query x 64-key tile of the mask, bytes
using hw::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

// K/V ring slots of the instance with C sub-heads and KT one-pass key
// tiles (0: two passes): a one-pass item's 2 KT tiles, at least 4; three
// at C = 4 (32 KB a slot; KT is 0 or 1 there).
__host__ __device__ constexpr int ring_slots(int c, int kt) {
  return c == 4 ? 3 : kt > 2 ? 2 * kt : 4;
}
static_assert(ring_slots(1, 2) == 4 && ring_slots(1, 4) == 8 && ring_slots(2, 3) == 6,
              "a one-pass item fills the ring");
// Output staging slots: two, so a store overlaps the next item; one at C = 4.
__host__ __device__ constexpr int out_slots(int c) { return c == 4 ? 1 : 2; }
// Mask ring slots: two one-pass items' KT tiles, or two second-pass tiles.
__host__ __device__ constexpr int mask_slots(int kt) { return kt > 0 ? 2 * kt : 2; }
// Blocks an SM the instance with C sub-heads and NK one-pass key columns
// is compiled for: at C = 1 three to 128 keys, two (168 registers a
// thread) to 200, one (255) at 256; the masked form at 128 keys two (its
// mask ring leaves no room for a third); one from C = 2.
__host__ __device__ constexpr int min_blocks(int c, int nk, bool drop) {
  return c > 1 || nk == 256 ? 1 : nk >= 192 || (drop && nk == 128) ? 2 : 3;
}

template <int C, int KT>
struct Smem {  // C: 64-column sub-heads a head; KT: one-pass key tiles, 0 for two passes
  static constexpr int kTile = C * kBox;  // a 64-row tile of one head
  static constexpr int kStages = ring_slots(C, KT);
  static constexpr int kOut = out_slots(C);
  unsigned char q[2][kTile];          // a tile's C sub-heads kBox apart
  unsigned char kv[C][kStages][kBox];  // sub-head-major: a sub-head's slots kBox apart
  unsigned char o[kOut][kTile];
  uint64_t q_full[2], q_empty[2];
  uint64_t kv_full[kStages], kv_empty[kStages];
};
// The masked forms' storage: the unmasked one, then the mask ring.
template <int C, int KT>
struct SmemDrop : Smem<C, KT> {
  static constexpr int kMaskStages = mask_slots(KT);
  alignas(512) unsigned char mask[kMaskStages][kMaskTile];  // 64-byte swizzled tiles
  uint64_t m_full[kMaskStages], m_empty[kMaskStages];
};
template <int C, int KT, bool DROP>
using SmemOf = std::conditional_t<DROP, SmemDrop<C, KT>, Smem<C, KT>>;
template <int C, int KT, bool DROP>
constexpr int kSmemBytes = sizeof(SmemOf<C, KT, DROP>) + 1024;  // + the 1,024-byte alignment
static_assert(kSmemBytes<4, 1, true> <= 232448 && kSmemBytes<2, 3, false> <= 232448,
              "the widest instances fit an SM");

struct Params {
  CUtensorMap qkv, out;  // map_heads: 3 H heads of qkv, H of out
  CUtensorMap mask;      // the mask's [B H n, n] rows, where mask_tma
  float* lse;            // [B, H, n] fp32, or null
  const uint8_t* mask_rows;  // the mask [B, H, n, n], for the plain copy
  int heads, n, n_valid, q_tiles, k_tiles, items, mask_tma;
  float scale_log2;  // scale * log2(e)
  float keep;
};

// C: 64-column sub-heads a head (ceil(Dh / 64)).  NK: the key columns
// the one-pass form holds (a multiple of 8, 64 per tile; 200 covers
// ViT-B's 196 keys with 100 registers where 256 takes 128), or 0 for the
// two-pass form.  DROP: the dropout mask and keep.
template <int C, int NK, bool DROP>
__global__ void __launch_bounds__(kThreads, min_blocks(C, NK, DROP))
    packed_attn_sm90(const __grid_constant__ Params p) {
  constexpr int KT = (NK + BM - 1) / BM;  // one-pass key tiles; 0: two passes
  constexpr int NS = KT > 0 ? KT : 1;     // key tiles a logits product reads
  constexpr int NC = NK > 0 ? NK : BM;    // key columns of the logits held
  constexpr int KS = (NC + 15) / 16;      // k16 steps of P . V
  static_assert(NC % 8 == 0 && NC > BM * (NS - 1) && NC <= BM * NS, "NK fits KT tiles");
  using S = SmemOf<C, KT, DROP>;
  constexpr int kTile = S::kTile, kStages = S::kStages, kOut = S::kOut;
  constexpr int kMaskStages = mask_slots(KT);
  extern __shared__ __align__(1024) unsigned char dyn[];
  S& sm = hw::aligned_smem<S>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hw::bar_init(&sm.q_full[s], 1);
      hw::bar_init(&sm.q_empty[s], kConsumerThreads / 32);
    }
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.kv_full[s], 1);
      hw::bar_init(&sm.kv_empty[s], kConsumerThreads / 32);
    }
    if constexpr (DROP) {
      for (int s = 0; s < kMaskStages; ++s) {
        hw::bar_init(&sm.m_full[s], 1);
        hw::bar_init(&sm.m_empty[s], kConsumerThreads / 32);
      }
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // producer: one thread starts every TMA load
    if (lane == 0) {
      hw::Ring<2> qr;
      hw::Ring<kStages> kr;
      hw::Ring<kMaskStages> mr;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int qt = item % p.q_tiles, bh = item / p.q_tiles;
        const int h = bh % p.heads, b = bh / p.heads;
        // A 64-row tile of head `head` (its C sub-heads, `stride` bytes
        // apart) from row row0.
        auto load = [&](unsigned char* dst, int stride, uint64_t* bar, int head, int row0) {
          hw::bar_expect_tx(bar, kTile);
#pragma unroll
          for (int c = 0; c < C; ++c)
            hw::tma_load4(dst + c * stride, &p.qkv, bar, 64 * c, head, row0, b);
        };
        hw::bar_wait(&sm.q_empty[qr.slot], qr.phase ^ 1);  // the first pass finds every slot free
        load(sm.q[qr.slot], kBox, &sm.q_full[qr.slot], h, qt * BM);
        qr.next();
        auto kv = [&](int head, int t) {
          hw::bar_wait(&sm.kv_empty[kr.slot], kr.phase ^ 1);
          load(sm.kv[0][kr.slot], kStages * kBox, &sm.kv_full[kr.slot], head, t * BM);
          kr.next();
        };
        // The mask's tile of key tile t: by TMA, or (no TMA box) an
        // arrival that hands the empty slot to the consumers' copy.
        auto mask_tile = [&](int t) {
          if constexpr (DROP) {
            hw::bar_wait(&sm.m_empty[mr.slot], mr.phase ^ 1);
            if (p.mask_tma) {
              hw::bar_expect_tx(&sm.m_full[mr.slot], kMaskTile);
              hw::tma_load2(sm.mask[mr.slot], &p.mask, &sm.m_full[mr.slot], t * BM,
                            bh * p.n + qt * BM);
            } else {
              hw::bar_arrive(&sm.m_full[mr.slot]);
            }
            mr.next();
          }
        };
        const int ksub = p.heads + h, vsub = 2 * p.heads + h;
        if constexpr (KT > 0) {  // every K tile, the mask's tiles, then every V tile
          for (int t = 0; t < KT; ++t) kv(ksub, t);
          for (int t = 0; t < KT; ++t) mask_tile(t);
          for (int t = 0; t < KT; ++t) kv(vsub, t);
        } else {
          for (int t = 0; t < p.k_tiles; ++t) kv(ksub, t);
          for (int t = 0; t < p.k_tiles; ++t) {
            kv(ksub, t);
            mask_tile(t);
            kv(vsub, t);
          }
        }
      }
    }
    return;
  }

  // Consumers: this thread holds query rows r0 and r0 + 8 of the item's
  // tile, and in the logits the keys 8 j + c0 + {0, 1} (j < 8 NS): key
  // tile t is s[32 t .. 32 t + 31].
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const float c = p.scale_log2;
  hw::Ring<2> qr;
  hw::Ring<kStages> kr;
  hw::Ring<kMaskStages> mr;
  int ob = 0;  // staging slot
  float s[NC / 2], o[C][32];
  const unsigned char* qs = nullptr;

  // The ring's next NS tiles, waited for: their shared addresses (of
  // sub-head 0; sub-head c is c kStages kBox bytes further).  A one-pass
  // item takes 2 KT slots of a 2 KT-slot ring, so its K tiles (and its V
  // tiles) are always consecutive slots: with the ring sub-head-major, each
  // sub-head of them is one contiguous operand.
  auto next_tiles = [&](const unsigned char* (&tiles)[NS]) {
    hw::Ring<kStages> r = kr;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      hw::bar_wait(&sm.kv_full[r.slot], r.phase);
      tiles[t] = sm.kv[0][r.slot];
      r.next();
    }
  };
  // Release the ring's next NS tiles.
  auto release = [&]() {
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      if (lane == 0) hw::bar_arrive(&sm.kv_empty[kr.slot]);
      kr.next();
    }
  };
  // s = Q . K^T (raw logits) for the next NS K tiles of the ring, which
  // are then released: one m64n(64 NS) product a k16 step.
  auto logits = [&]() {
    const unsigned char* ks[NS];
    next_tiles(ks);
    hw::fence_regs(s);
    hw::wgmma_fence();
    const uint64_t qd = hw::desc_sw128(qs), kd = hw::desc_sw128(ks[0]);
    // k16 step kk: 32 bytes along the rows of sub-head kk / 4 (kBox apart
    // in Q's tile, kStages kBox in the ring).
    sfc::static_for<4 * C>([&](auto step) {
      constexpr int kk = decltype(step)::value;
      constexpr int oq = (kk / 4) * (kBox >> 4) + 2 * (kk % 4);
      constexpr int ok = (kk / 4) * (kStages * kBox >> 4) + 2 * (kk % 4);
      if constexpr (NC == BM) hw::wgmma_ss_at<0, 0, oq, ok>(s, qd, kd, kk);
      else hw::wgmma_ss_n_at<NC, oq, ok>(s, qd, kd, kk);
    });
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    release();
  };
  // Keys at or past n_valid to -1e30 in the raw logits, whose first tile
  // is key tile kt.
  auto mask = [&](int kt) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i)
      if (kt * BM + 8 * (i / 4) + c0 + (i % 2) >= p.n_valid) s[i] = sfc::kNegInf;
  };
  // The dropout mask on P (normalised, in s), whose first key tile is kt:
  // the mask ring's next NS tiles waited for (copied by the consumers
  // where the mask has no TMA box), s = (s / keep) * mask for the key
  // groups of 8 that hold a key below n_valid (the others are 0
  // already), then the tiles released.
  auto drop = [&](int bh, int qt, int kt) {
    if constexpr (DROP) {
      const float keep = p.keep, rk = __frcp_rn(keep);
      unsigned char* mt[NS];
      hw::Ring<kMaskStages> r = mr;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        hw::bar_wait(&sm.m_full[r.slot], r.phase);
        mt[t] = sm.mask[r.slot];
        r.next();
      }
      if (!p.mask_tma) {  // N % 16 != 0: plain loads, zero past n
        const uint8_t* src = p.mask_rows + static_cast<size_t>(bh) * p.n * p.n;
        for (int t = 0; t < NS; ++t)
          for (int e = tid; e < kMaskTile; e += kConsumerThreads) {
            const int row = qt * BM + e / BM, key = (kt + t) * BM + e % BM;
            mt[t][hw::sw64_u8(e / BM, e % BM)] =
                row < p.n && key < p.n ? src[static_cast<size_t>(row) * p.n + key] : 0;
          }
        hw::named_sync(1, kConsumerThreads);
      }
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const bool live = KT == 0 || j < 8 * (KT - 1) || 8 * j < p.n_valid;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t two =
              live ? *reinterpret_cast<const uint16_t*>(
                         mt[j / 8] + hw::sw64_u8(r0 + 8 * hf, 8 * (j % 8) + c0))
                   : 0u;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hf + e];
            x = (two >> (8 * e)) & 0xffu ? sfc::div_rn(x, keep, rk) : 0.f;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        if (lane == 0) hw::bar_arrive(&sm.m_empty[mr.slot]);
        mr.next();
      }
    }
  };
  // O (+)= bf16(P) . V for the next NS V tiles of the ring (P in s, already
  // normalised), which are then released; O starts from zero when `fresh`.
  auto pv = [&](bool fresh) {
    uint32_t pf[KS][4];
#pragma unroll
    for (int ks = 0; ks < NC / 16; ++ks) hw::acc_to_a(s, ks, pf[ks]);
    if constexpr (NC % 16) {  // the last step's second 8 keys are past NC: P = 0
      pf[KS - 1][0] = hw::pack_bf16x2(s[NC / 2 - 4], s[NC / 2 - 3]);
      pf[KS - 1][1] = hw::pack_bf16x2(s[NC / 2 - 2], s[NC / 2 - 1]);
      pf[KS - 1][2] = pf[KS - 1][3] = 0u;
    }
    if (fresh)
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cc][i] = 0.f;
    const unsigned char* vs[NS];
    next_tiles(vs);
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
    hw::fence_frags(pf);
    hw::wgmma_fence();
    const uint64_t vd = hw::desc_sw128(vs[0]);
    // k16 step ks of the keys: 16 rows (2,048 bytes) down V; sub-head cc.
    sfc::static_for<KS>([&](auto step) {
      constexpr int ks = decltype(step)::value;
      sfc::static_for<C>([&](auto sub) {
        constexpr int cc = decltype(sub)::value;
        hw::wgmma_rs_at<1, cc * (kStages * kBox >> 4) + ks * (2048 >> 4)>(o[cc], pf[ks], vd, 1);
      });
    });
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
    hw::fence_frags(pf);
    release();
  };
  // The max over the held logits of each of this thread's two rows, across
  // its quad, in log2 units.
  auto row_max = [&](float (&mx)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = sfc::kNegInf;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
        v = fmaxf(v, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      mx[hf] = v * c;
    }
  };

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int qt = item % p.q_tiles, bh = item / p.q_tiles;
    const int h = bh % p.heads, b = bh / p.heads;
    hw::bar_wait(&sm.q_full[qr.slot], qr.phase);
    qs = sm.q[qr.slot];

    float m[2], l[2] = {0.f, 0.f};
    if constexpr (KT > 0) {
      logits();
      mask(0);
      row_max(m);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        // Key groups of 8 wholly past n_valid (in the last tile): p = 0,
        // no exponential.
        const bool live = j < 8 * (KT - 1) || 8 * j < p.n_valid;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          s[i] = live ? hw::exp2_approx(fmaf(s[i], c, -m[e / 2])) : 0.f;
          l[e / 2] += s[i];
        }
      }
    } else {
      // Pass 1: the row max m and the sum l, rescaled as m grows.
      m[0] = m[1] = sfc::kNegInf;
      for (int t = 0; t < p.k_tiles; ++t) {
        logits();
        if (t == p.k_tiles - 1) mask(t);
        float mx[2];
        row_max(mx);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float m_new = fmaxf(m[hf], mx[hf]);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sum += hw::exp2_approx(fmaf(s[4 * j + 2 * hf + e], c, -m_new));
          l[hf] = l[hf] * hw::exp2_approx(m[hf] - m_new) + sum;
          m[hf] = m_new;
        }
      }
    }
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      // One instruction each (rcp and lg2 approx): a division and logf
      // are subroutine calls, which cost the 256-key form 22 registers.
      inv[hf] = hw::rcp_approx(l[hf]);
    }
    if (p.lse != nullptr && lane % 4 == 0) {
      // lse = ln(sum of exp(s * scale)) = (m + log2(l)) ln 2, m in log2 units.
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qt * BM + r0 + 8 * hf;
        if (row < p.n)
          p.lse[static_cast<size_t>(bh) * p.n + row] = (m[hf] + hw::log2_approx(l[hf])) * kLn2;
      }
    }
    if constexpr (KT > 0) {
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) s[i] *= inv[(i / 2) % 2];
      if constexpr (DROP) drop(bh, qt, 0);
      pv(true);
    } else {
      // Pass 2: P = exp(s - m) / l (times the mask over keep) rounded to
      // bf16, then O += P . V.
      for (int t = 0; t < p.k_tiles; ++t) {
        logits();
        if (t == p.k_tiles - 1) mask(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hf = (i / 2) % 2;
          s[i] = hw::exp2_approx(fmaf(s[i], c, -m[hf])) * inv[hf];
        }
        if constexpr (DROP) drop(bh, qt, t);
        pv(t == 0);
      }
    }
    if (lane == 0) hw::bar_arrive(&sm.q_empty[qr.slot]);  // the last logits product has read Q
    qr.next();

    // Epilogue: O rounded once to bf16 into staging slot ob, then one TMA
    // store a 64-column sub-head (clipped at Dh).  The store that read this
    // slot kOut items ago must have finished reading it.
    unsigned char* st = sm.o[ob];
    if (tid == 0) hw::bulk_wait_read<kOut - 1>();
    hw::named_sync(1, kConsumerThreads);
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(st + cc * kBox + hw::sw128_bf16(r0 + 8 * hf, 8 * j + c0)) =
              hw::pack_bf16x2(o[cc][4 * j + 2 * hf], o[cc][4 * j + 2 * hf + 1]);
    hw::fence_async_shared();
    hw::named_sync(1, kConsumerThreads);
    if (tid == 0) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        hw::tma_store4(&p.out, st + cc * kBox, 64 * cc, h, qt * BM, b);
      hw::bulk_commit();
    }
    ob = (ob + 1) % kOut;
  }
  if (tid == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

template <int NK>
constexpr int kt_of = (NK + BM - 1) / BM;

template <int C, int NK, bool DROP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = packed_attn_sm90<C, NK, DROP>;
  constexpr int smem = kSmemBytes<C, kt_of<NK>, DROP>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, smem, p.items, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// qkv bf16 [batch, n, 3 * heads * dh] contiguous, on 16 bytes; out bf16
// [batch, n, heads * dh] contiguous; lse fp32 [batch, heads, n] or null;
// mask uint8 0/1 [batch, heads, n, n] contiguous on 16 bytes, or null (no
// dropout), with keep in (0, 1].  Keys at or past n_valid (1 <= n_valid
// <= n) are masked.  dh a multiple of 16 up to 256 (sm90.cuh::head_dim_ok),
// n at most 1,024.
extern "C" int sfc_packed_attention_bf16(const void* qkv, void* out, void* lse, const void* mask,
                                         int batch, int n, int heads, int dh, int n_valid,
                                         float scale, float keep, void* stream) {
  if (!hw::head_dim_ok(dh) || heads < 1 || n < 1 || n > kMaxN || n_valid < 1 || n_valid > n ||
      batch < 0 || (mask != nullptr && !(keep > 0.f && keep <= 1.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const bool drop = mask != nullptr;
  const long long row = 3LL * heads * dh, inner = static_cast<long long>(heads) * dh;
  Params p{};
  cudaError_t e = hw::map_heads(&p.qkv, qkv, false, batch, n, 3 * heads, dh, row, BM);
  if (e == cudaSuccess) e = hw::map_heads(&p.out, out, false, batch, n, heads, dh, inner, BM);
  // A TMA box of the mask's rows needs their stride on 16 bytes; a row of
  // at least one 64-key box keeps every box inside the tensor's width.
  p.mask_tma = drop && n % 16 == 0 && n >= BM;
  if (e == cudaSuccess && p.mask_tma)
    e = hw::map_mask_u8(&p.mask, mask, static_cast<long long>(batch) * heads * n, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.lse = static_cast<float*>(lse);
  p.mask_rows = static_cast<const uint8_t*>(mask);
  p.heads = heads;
  p.n = n;
  p.n_valid = n_valid;
  p.q_tiles = (n + BM - 1) / BM;
  p.k_tiles = (n_valid + BM - 1) / BM;
  p.items = batch * heads * p.q_tiles;
  p.scale_log2 = scale * kLog2e;
  p.keep = drop ? keep : 1.f;
  auto s = static_cast<cudaStream_t>(stream);
  const int c = hw::subheads(dh), nk = hw::one_pass_nk(c, n_valid, drop);
  e = cudaErrorInvalidValue;
  if (drop)
    hw::with_packed_instance<true>(c, nk, [&](auto C, auto NK) {
      e = launch<decltype(C)::value, decltype(NK)::value, true>(p, s);
    });
  else
    hw::with_packed_instance<false>(c, nk, [&](auto C, auto NK) {
      e = launch<decltype(C)::value, decltype(NK)::value, false>(p, s);
    });
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the instance for head dim
// dh (its 64-column sub-heads: 64, 128, 192 or 256 name C = 1 to 4), nk
// one-pass key columns (64, 128, 192, 200 or 256 at dh 64, to 192 at dh
// 128, 64 at dh 192 and 256; masked to 192 at dh 64 and 128 at dh 128;
// 0: the two-pass form) and the dropout mask, into out[3].
extern "C" int sfc_packed_attention_attrs(int dh, int nk, int masked, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (!hw::head_dim_ok(dh)) return err;
  auto get = [&](auto C, auto NK, auto D) {
    constexpr int c = decltype(C)::value, k = decltype(NK)::value;
    constexpr bool d = decltype(D)::value;
    err = hw::kernel_attrs(packed_attn_sm90<c, k, d>, kSmemBytes<c, kt_of<k>, d>, out);
  };
  if (masked)
    hw::with_packed_instance<true>(hw::subheads(dh), nk,
                                   [&](auto C, auto NK) { get(C, NK, std::true_type{}); });
  else
    hw::with_packed_instance<false>(hw::subheads(dh), nk,
                                    [&](auto C, auto NK) { get(C, NK, std::false_type{}); });
  return err;
}
