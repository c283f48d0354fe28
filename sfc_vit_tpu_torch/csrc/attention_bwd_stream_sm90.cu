// Softmax-attention backward straight off the packed QKV projection, for
// Hopper, in the streamed form: the bf16 attention part of ViT-B's block
// backward (kernel #4) and of family A's MHA backward with probability
// dropout (kernel #6) at every (head dim, length, dropout) past the
// resident form's limits (csrc/attention_bwd_sm90.cu, which holds a whole
// (image, head) in one block; ops/_build.py::ATTENTION_BWD_SM90_LIMITS and
// attention_bwd_route): #4 at Dh up to 64 past 256 tokens, #6 there past
// 192, both at Dh 80 to 192 past 64 tokens, and Dh 208 to 256 at every
// length.  Any length: family A and family B stop at 1,024 tokens
// (models/layers.py::TORCH_MHA_MAX_N, models/simple_vit.py::
// FUSED_BLOCK_MAX_N).
//
// Replaces: the per-(image, head) loops of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel (line
// 333, its lines 423-496) on the path the TPU trains with (with_acts +
// with_lse), and, with the mask, of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel (line
// 270, its lines 331-378).  It reads q, k and v from qkv [B, N, 3*H*Dh]
// at columns h*Dh, (H + h)*Dh and (2H + h)*Dh, da from datt [B, N, H*Dh],
// the forward's att [B, N, H*Dh] and lse [B, H, N] (and the mask
// [B, H, N, N]), and writes dq, dk and dv into the packed dqkv.
//
// The formula is the resident form's, rounding point for rounding point.
// Without dropout (#4): pn = bf16(exp(s * scale - lse)), keys at or past
// n_valid giving 0; dpn = da . v^T in fp32; ds = bf16(pn * (dpn - delta) *
// scale); dv = pn^T . da.  With the mask and keep (#6): pf = exp(s * scale
// - lse) stays fp32; pdf = (pf / keep) * mask; dp = ((da . v^T) / keep) *
// mask; ds = bf16(pf * (dp - delta) * scale); dv = bf16(pdf)^T . da, each
// quotient by keep correctly rounded by sfc::div_rn.  In both, delta =
// rowsum(da * att_h) in fp32, dq = ds . k and dk = ds^T . q, each one fp32
// sum over the sequence rounded once.
//
// Bound on this card: the bytes at family A's and 'hier''s rows with the
// mask ([512, 192, 2 x 128] reads and writes 441 MB: 0.13 ms at 3.35
// TB/s), the tensor cores from ~500 tokens at Dh 64 ([32, 1024, 4 x 64]:
// 86 nominal GFLOP, 0.087 ms at 989 TFLOP/s).
//
// Design (the structure of csrc/attention_bwd_f32.cu with bf16 wgmma and
// the building blocks of csrc/flash_wide.cuh): two kernels, each output
// with one owner, no atomics and no reduce-add, so the same inputs give
// the same bits.  A block is one warpgroup (128 threads), two to four
// blocks an SM (blocks_per_sm).  A head of Dh = 64 C columns is C
// sub-heads; a sub-block is 64 rows of one sub-head, 128-byte swizzled as
// TMA writes it (sm90.cuh::map_heads over three views of qkv, H heads
// each, and over datt: a ragged head's columns past Dh load as zeros,
// which add nothing to S, dP or delta).  The block's own rows come once
// (resident, on their own barrier); thread 0 keeps a ring of sub-blocks of
// the other side in flight by TMA, in the order the block consumes them,
// and refills the slots of the entries read once the products that read
// them are done (`release`).  The mask comes as 64 x 64 byte tiles
// (map_mask_u8 over the [B H N, N] rows, 64-byte swizzled) through slots
// of the same ring, never as a whole [N][N] tile, each tile's entry first
// among its tile's; each thread takes its 32 bits of a tile into one
// register before the logits are live.  Where N is not a multiple of 16
// (no TMA box over its rows) or under 64, the same bits come from device
// memory by plain loads.
//  (1) dq: a block owns 64 queries and a group of CO of dq's sub-heads.
//      It computes delta for its rows (the first group writes it to a
//      fp32 scratch [B, H, N] for kernel 2), then for each 64-key tile
//      below n_valid: S = Q K^T and dP = dA V^T by wgmma, the mask's
//      tile, pn or pf and ds in registers, formed straight into bf16 A
//      fragments, then dq_c += ds . K_c (K through the transpose bit).
//  (2) dk, dv: a block owns 64 keys and walks every 64-query tile: S^T =
//      K Q^T and dP^T = V dA^T, the mask's tile read transposed, pn^T (or
//      bf16(pdf)^T) and ds^T as the A fragments of dv_c += . dA_c and
//      dk_c += ds^T . Q_c.  At C = 1 one block takes dk and dv; from C = 2
//      one block takes dv (S^T and its C products) and another dk (S^T,
//      dP^T and C products), each output's C sub-heads in registers (64 C
//      a thread beside the logits), where one block for both would need
//      128 C.  Each query tile's lse and delta come into shared memory by
//      cp.async a tile ahead.
// Blocks over rows of an item recompute its logits (the dq and dk/dv
// kernels, dq's groups at C = 4 and dk/dv's two parts): a (query tile,
// key tile) pair takes 7 (C = 1), 8 C (C = 2, 3) or 10 C (C = 4) products
// of 64 x 64 x 64 where the formula has 5 C.  At C = 1 the K
// (dq) and Q and dA (dk/dv) sub-blocks of the logits serve the output
// products too; from C = 2 the output's sub-blocks come through the ring
// again (from L2), which keeps the ring's slots free for the next
// entries.

#include "flash_wide.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;
namespace fw = sfc::flash_wide;

constexpr int BM = 64;                 // rows a tile
constexpr int kMaskTile = BM * BM;     // a 64 x 64 byte tile of the mask
using hw::kLog2e;

// Blocks an SM: at C = 1 four of the dq kernel (122-124 registers a
// thread) and three of the dk/dv kernel (159), but two of the masked
// dk/dv kernel (216 registers: it spilled at 168); at C = 2 three (154-162
// registers); from C = 3 two (255).  More blocks hide each other's waits:
// at C = 1 and 2 that was faster at every streamed row than two blocks
// of each with the deepest ring that fits.  The ring's slots: as many as
// fit beside the 2 C resident sub-blocks in the block's share of an SM's
// shared memory (C = 1: 16 KB resident and four slots, 48 KB a block; C =
// 2: 32 KB and five, 72 KB).
__host__ __device__ constexpr int blocks_per_sm(int c, bool drop, bool dkv) {
  return c == 1 ? (!dkv ? 4 : drop ? 2 : 3) : c == 2 ? 3 : 2;
}
__host__ __device__ constexpr int ring_slots(int c) {
  return c == 1 ? 4 : c == 2 ? 5 : c == 3 ? 7 : 5;
}
// dq's sub-heads a block (the groups of kernel 1): all of them to C = 3
// (dq's 96 registers beside the logits' 64), two of four at C = 4.
__host__ __device__ constexpr int dq_group(int c) { return c == 4 ? 2 : c; }
// flash_wide.cuh's storage (the resident sub-blocks, the ring, the dq
// kernel's lse and delta of its rows), and the dk/dv kernel's lse and
// delta of two query tiles (the next one's copied in while this one runs).
template <int C>
struct Smem : fw::Smem<2 * C, ring_slots(C)> {
  float tile_vec[2][2][64];
};
template <int C>
constexpr int kSmemBytes = sizeof(Smem<C>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap q, k, v, da;  // map_heads over qkv's three views and datt, H heads each
  CUtensorMap mask;         // the mask's [B H N, N] rows, where mask_tma
  const bf16* att;
  const float* lse;
  const uint8_t* mask_g;    // the mask [B, H, N, N] (plain loads), null without dropout
  float* delta;             // [B, H, N]: written by (1), read by (2)
  bf16* dqkv;
  int n, heads, dh, n_valid, tiles, mask_tma;
  float scale, scale_log2, keep;
};

// A ring entry: sub-head c of rows row.. of a tensor, or the mask's tile
// at key column c and mask row `row`.
enum Kind : int { kQ = 0, kK = 1, kV = 2, kDA = 3, kMask = 4 };
struct Entry {
  int kind, c, row;
};

// Thread 0: entries up to `upto` into the slots their entries NS before
// freed; of(i) gives entry i.
template <int C, typename Of>
__device__ __forceinline__ void feed(Smem<C>& sm, fw::Cursor& cur, int upto, const Params& p,
                                     int h, int b, Of&& of) {
  constexpr int NS = ring_slots(C);
  for (; cur.issued < upto && cur.issued < cur.entries; ++cur.issued) {
    const Entry en = of(cur.issued);
    const int slot = cur.issued % NS;
    uint64_t* bar = &sm.full[slot];
    if (en.kind == kMask) {
      if (p.mask_tma) {
        hw::bar_expect_tx(bar, kMaskTile);
        hw::tma_load2(sm.ring[slot], &p.mask, bar, en.c, en.row);
      } else {
        hw::bar_arrive(bar);  // the bits come by plain loads
      }
      continue;
    }
    const CUtensorMap* map = en.kind == kQ ? &p.q : en.kind == kK ? &p.k : en.kind == kV ? &p.v
                                                                                         : &p.da;
    hw::bar_expect_tx(bar, fw::kSub);
    hw::tma_load4(sm.ring[slot], map, bar, 64 * en.c, h, en.row, b);
  }
}

// Every product issued so far is done and every thread has read the
// entries taken so far (the mask's bytes by generic loads, ordered before
// the TMA writes that refill them); thread 0 refills their slots.
template <int C, typename Of>
__device__ __forceinline__ void release(Smem<C>& sm, fw::Cursor& cur, const Params& p, int h,
                                        int b, Of&& of) {
  hw::wgmma_wait<0>();
  hw::fence_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) feed<C>(sm, cur, cur.e + ring_slots(C), p, h, b, of);
}

// Barriers set; the block's resident sub-blocks (map ma's C sub-heads into
// res[0 ..], then mb's, rows row0 ..) and the ring's first entries in
// flight.  The resident ones are waited for by the caller.
template <int C, typename Of>
__device__ __forceinline__ void start(Smem<C>& sm, fw::Cursor& cur, const Params& p,
                                      const CUtensorMap* ma, const CUtensorMap* mb, int row0,
                                      int h, int b, Of&& of) {
  if (threadIdx.x == 0) {
    hw::bar_init(&sm.res_full, 1);
    for (int s = 0; s < ring_slots(C); ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::bar_expect_tx(&sm.res_full, 2 * C * fw::kSub);
    for (int r = 0; r < 2 * C; ++r)
      hw::tma_load4(sm.res[r], r < C ? ma : mb, &sm.res_full, 64 * (r % C), h, row0, b);
    feed<C>(sm, cur, ring_slots(C), p, h, b, of);
  }
}

// The thread's 32 bits of the mask's 64 x 64 tile at query q0, key k0,
// bit i for its accumulator element i (rows r0 + 8 ((i / 2) % 2), columns
// 8 (i / 4) + c0 + (i % 2)), the rows queries (kernel 1) or keys
// (TRANSPOSED, kernel 2).  From the ring's slot (the tile [query][key] as
// TMA wrote it, 64-byte swizzled: byte (r, c) at 64 r + 16 (((c >> 4) ^
// (r >> 1)) & 3) + c % 16) where `tma`: rows past n hold the next item's
// bytes there and columns past n zeros; the callers zero every element
// whose query or key is out of range.  Else from the mask [B, H, n, n] at
// mg in device memory, 0 past n.
template <bool TRANSPOSED>
__device__ __forceinline__ uint32_t mask_bits(const unsigned char* tile, bool tma,
                                              const uint8_t* mg, int n, int bh, int q0, int k0) {
  uint32_t bits = 0;
  if (tma) {
    const int t = hw::fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), c0 = 2 * (t & 3);
    if constexpr (TRANSPOSED) {
      // Query rows 8 j + c0 + e, key columns r0 + 8 hf: one 16-byte chunk
      // a row ((r0 + 8) >> 4 == r0 >> 4 and ((8 j + c0 + e) >> 1) & 3 ==
      // c0 / 2), so every byte is an immediate offset from one base.
      const unsigned char* base = tile + 64 * c0 + 16 * (((r0 >> 4) ^ (c0 >> 1)) & 3) + (r0 & 15);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        bits |= static_cast<uint32_t>(base[512 * (i / 4) + 64 * (i % 2) + 8 * ((i / 2) % 2)] != 0)
                << i;
    } else {
      // Query rows r0 + 8 hf, key columns 8 j + c0 + {0, 1}: one 16-bit
      // read a (row, j), its chunk (j / 2) ^ ((r0 >> 1) & 3).
      const unsigned char* base = tile + 64 * r0 + c0;
      const int m = (r0 >> 1) & 3;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t two = *reinterpret_cast<const uint16_t*>(
              base + 512 * hf + 16 * ((j / 2) ^ m) + 8 * (j % 2));
          bits |= static_cast<uint32_t>((two & 0xffu) != 0) << (4 * j + 2 * hf);
          bits |= static_cast<uint32_t>((two >> 8) != 0) << (4 * j + 2 * hf + 1);
        }
    }
    return bits;
  }
  const int t = hw::fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), c0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + c0 + (i % 2);
    const int q = q0 + (TRANSPOSED ? col : row), k = k0 + (TRANSPOSED ? row : col);
    if (q < n && k < n)
      bits |= static_cast<uint32_t>(mg[(static_cast<size_t>(bh) * n + q) * n + k] != 0) << i;
  }
  return bits;
}

// Rows r0 and r0 + 8 (of rows row0 ..) of a 64 x 64 accumulator, rounded
// to bf16 pairs, into sub-head c of the head at column `col` of dqkv;
// rows at or past n and columns at or past Dh are not written.
__device__ __forceinline__ void store_sub(const Params& p, const float (&acc)[32], int b,
                                          int row0, size_t col, int c, int r0, int c0) {
  const size_t w = static_cast<size_t>(3) * p.heads * p.dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= p.n) continue;
    bf16* dst = p.dqkv + (static_cast<size_t>(b) * p.n + row) * w + col + 64 * c + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (64 * c + 8 * j + c0 < p.dh)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            hw::pack_bf16x2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// Eight values of a thread (one k16 step, in A-fragment order) rounded to
// bf16 pairs.
__device__ __forceinline__ void pack8(const float (&x)[8], uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = hw::pack_bf16x2(x[2 * e], x[2 * e + 1]);
}

// C: sub-heads a head.  DROP: the mask and keep.
template <int C, bool DROP>
__global__ void __launch_bounds__(fw::kThreads, blocks_per_sm(C, DROP, false))
    attention_bwd_stream_dq(const __grid_constant__ Params p) {
  constexpr int CO = dq_group(C), groups = C / CO;
  constexpr bool kReuse = C == 1;  // K's slot serves S and dq
  constexpr int per = 2 * C + (DROP ? 1 : 0) + (kReuse ? 0 : CO);
  constexpr int NS = ring_slots(C);
  // S's sub-blocks released before dP's are taken where the ring cannot
  // hold both and the mask's tile (C = 4).
  constexpr bool kSplit = !kReuse && 2 * C + 1 > NS;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem<C>& sm = hw::aligned_smem<Smem<C>>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int n = p.n, H = p.heads, dh = p.dh, n_valid = p.n_valid, tiles = p.tiles;
  const int g = blockIdx.x % groups, rest = blockIdx.x / groups;
  const int q0 = (rest % tiles) * BM, bh = rest / tiles, b = bh / H, h = bh % H;
  const int key_tiles = (n_valid + BM - 1) / BM;  // keys past n_valid add nothing
  fw::Cursor cur;
  cur.entries = key_tiles * per;
  // A tile's entries: the mask's tile first (its bits are taken while no
  // logits are live), K's C sub-blocks (S), V's (dP), then K's of dq's
  // group again (C > 1).
  auto of = [&](int i) SFC_INLINE_LAMBDA {
    const int t = i / per, r = i % per - (DROP ? 1 : 0);
    if (r < 0) return Entry{kMask, t * BM, bh * n + q0};
    if (r < C) return Entry{kK, r, t * BM};
    if (r < 2 * C) return Entry{kV, r - C, t * BM};
    return Entry{kK, CO * g + r - 2 * C, t * BM};
  };
  start<C>(sm, cur, p, &p.q, &p.da, q0, h, b, of);  // res: Q's sub-blocks, then dA's

  // delta of the 64 rows: two threads a row, each over half of the 64 C
  // padded columns (none past Dh), att by 16-byte loads issued before the
  // wait, dA from its resident sub-blocks; with lse into shared memory.
  {
    const int row = tid / 2, half = tid % 2, qrow = q0 + row;
    uint4 at[4 * C];
    float lse = 0.f;
    if (qrow < n) {
      const uint4* src = reinterpret_cast<const uint4*>(
          p.att + (static_cast<size_t>(b) * n + qrow) * H * dh + static_cast<size_t>(h) * dh);
#pragma unroll
      for (int k = 0; k < 4 * C; ++k) {
        const int kc = half * 4 * C + k;
        at[k] = 8 * kc < dh ? src[kc] : make_uint4(0u, 0u, 0u, 0u);
      }
      lse = p.lse[static_cast<size_t>(bh) * n + qrow];
    }
    hw::bar_wait(&sm.res_full, 0);
    float dl = 0.f;
    if (qrow < n) {
#pragma unroll
      for (int k = 0; k < 4 * C; ++k) {
        const int kc = half * 4 * C + k;  // sub-head kc / 8, columns 8 (kc % 8)
        float a[8], d[8];
        sfc::unpack_bf16x8(at[k], a);
        sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(
                               sm.res[C + kc / 8] + hw::sw128_bf16(row, 8 * (kc % 8))),
                           d);
#pragma unroll
        for (int e = 0; e < 8; ++e) dl += a[e] * d[e];
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (half == 0) {  // rows past n: lse and delta 0
      sm.vec[0][row] = lse * kLog2e;
      sm.vec[1][row] = dl;
      if (g == 0 && qrow < n) p.delta[static_cast<size_t>(bh) * n + qrow] = dl;
    }
  }
  __syncthreads();
  float lq[2], dlq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lq[hf] = sm.vec[0][r0 + 8 * hf];
    dlq[hf] = sm.vec[1][r0 + 8 * hf];
  }
  const float scale = p.scale, cl = p.scale_log2, keep = p.keep, rk = __frcp_rn(keep);
  const bool mask_tma = p.mask_tma != 0;
  const uint8_t* const mg = p.mask_g;

  float dq[CO][32], s[32], dp[32];
  uint32_t fa[4][4];
#pragma unroll
  for (int cc = 0; cc < CO; ++cc)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[cc][e] = 0.f;
  for (int t = 0; t < key_tiles; ++t) {
    uint32_t bits = 0;
    if constexpr (DROP)
      bits = mask_bits<false>(fw::take(sm, cur), mask_tma, mg, n, bh, q0, t * BM);
    uint64_t kdesc = 0;  // kReuse: K's slot
    if constexpr (kReuse) kdesc = hw::desc_sw128(sm.ring[cur.e % NS]);
    fw::logits<C>(sm, cur, s, 0);  // s = q . k^T
    if constexpr (kSplit) release<C>(sm, cur, p, h, b, of);
    fw::logits<C>(sm, cur, dp, C);  // dp = da . v^T
    if constexpr (kReuse) hw::wgmma_wait<0>();
    else release<C>(sm, cur, p, h, b, of);
    hw::fence_regs(s);
    hw::fence_regs(dp);
    // ds, a k16 step at a time, straight into its A fragment.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = 8 * kk + m, hf = (i / 2) % 2;
        const bool ok = t * BM + 8 * (i / 4) + c0 + (i % 2) < n_valid;
        const float pe = ok ? hw::exp2_approx(fmaf(s[i], cl, -lq[hf])) : 0.f;
        if constexpr (DROP) {
          const bool kept = ok && (bits >> i & 1u);
          v[m] = pe * ((kept ? sfc::div_rn(dp[i], keep, rk) : 0.f) - dlq[hf]) * scale;
        } else {
          v[m] = __bfloat162float(__float2bfloat16(pe)) * (dp[i] - dlq[hf]) * scale;
        }
      }
      pack8(v, fa[kk]);
    }
    uint64_t dk[CO];
    if constexpr (kReuse) dk[0] = kdesc;
    else fw::take_descs(sm, cur, dk);
#pragma unroll
    for (int cc = 0; cc < CO; ++cc) hw::fence_regs(dq[cc]);
    hw::fence_frags(fa);
    hw::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < CO; ++cc) fw::product_t(dq[cc], fa, dk[cc]);  // dq += ds . k
    hw::wgmma_commit();
    release<C>(sm, cur, p, h, b, of);
#pragma unroll
    for (int cc = 0; cc < CO; ++cc) hw::fence_regs(dq[cc]);
    hw::fence_frags(fa);
  }
#pragma unroll
  for (int cc = 0; cc < CO; ++cc)
    store_sub(p, dq[cc], b, q0, static_cast<size_t>(h) * dh, CO * g + cc, r0, c0);
}

// The dk/dv kernel's blocks a 64-key tile: one at C = 1, where a block
// takes dk and dv together (four products a query tile, Q's and dA's
// sub-blocks of the logits serving the output products); from C = 2 two:
// part 0 takes dv (S^T, then dv_c += p^T dA_c for every sub-head: 2 C
// products a tile) and part 1 dk (S^T, dP^T, then dk_c += ds^T Q_c: 3 C),
// each output's C sub-heads in registers (64 C per thread: 128 at C = 4).
__host__ __device__ constexpr int dkv_parts(int c) { return c == 1 ? 1 : 2; }

template <int C, bool DROP>
__global__ void __launch_bounds__(fw::kThreads, blocks_per_sm(C, DROP, true))
    attention_bwd_stream_dkv(const __grid_constant__ Params p) {
  constexpr int NS = ring_slots(C), parts = dkv_parts(C);
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem<C>& sm = hw::aligned_smem<Smem<C>>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int n = p.n, H = p.heads, dh = p.dh, n_valid = p.n_valid, tiles = p.tiles;
  const int part = blockIdx.x % parts, rest = blockIdx.x / parts;
  const int k0 = (rest % tiles) * BM, bh = rest / tiles, b = bh / H, h = bh % H;
  const size_t inner = static_cast<size_t>(H) * dh;
  const size_t kcol = inner + static_cast<size_t>(h) * dh, vcol = 2 * inner + h * dh;
  const float scale = p.scale, cl = p.scale_log2, keep = p.keep, rk = __frcp_rn(keep);
  const bool mask_tma = p.mask_tma != 0;
  const uint8_t* const mg = p.mask_g;
  bool key_ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) key_ok[hf] = k0 + r0 + 8 * hf < n_valid;

  // The walk of one part over every query tile: DK and DV, which outputs
  // it takes (both at C = 1).
  auto walk = [&](auto DKc, auto DVc) SFC_INLINE_LAMBDA {
    constexpr bool DK = decltype(DKc)::value, DV = decltype(DVc)::value;
    constexpr bool kReuse = DK && DV;  // C = 1
    constexpr int R = kReuse ? 1 : C;  // the output's sub-heads in registers
    // A tile's entries: the mask's tile first (its bits are taken while no
    // logits are live), Q's C sub-blocks (S^T), for dk dA's (dP^T), then
    // the output products' B operands: dk's Q_c, dv's dA_c (at C = 1 the
    // logits' own).
    constexpr int per = (DROP ? 1 : 0) + C + (DK ? C : 0) + (kReuse ? 0 : C);
    // S^T's entries released before the next ones are taken where the ring
    // cannot hold both (the dv part always: its products wait for nothing
    // else, and the release orders the staged lse before them).
    constexpr bool kSplit = !kReuse && (!DK || (DROP ? 1 : 0) + 2 * C > NS);
    float acc_k[DK ? R : 1][32], acc_v[DV ? R : 1][32];
#pragma unroll
    for (int c = 0; c < R; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if constexpr (DK) acc_k[c][e] = 0.f;
        if constexpr (DV) acc_v[c][e] = 0.f;
      }
    auto store = [&]() SFC_INLINE_LAMBDA {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if constexpr (DK) store_sub(p, acc_k[c], b, k0, kcol, c, r0, c0);
        if constexpr (DV) store_sub(p, acc_v[c], b, k0, vcol, c, r0, c0);
      }
    };
    if (k0 >= n_valid) {  // keys past n_valid: dk = dv = 0
      store();
      return;
    }
    fw::Cursor cur;
    cur.entries = tiles * per;
    auto of = [&](int i) SFC_INLINE_LAMBDA {
      const int t = i / per, r = i % per - (DROP ? 1 : 0);
      if (r < 0) return Entry{kMask, k0, bh * n + t * BM};
      if (r < C) return Entry{kQ, r, t * BM};
      if (DK && r < 2 * C) return Entry{kDA, r - C, t * BM};
      return Entry{DK ? kQ : kDA, r - (DK ? 2 * C : C), t * BM};
    };
    start<C>(sm, cur, p, &p.k, &p.v, k0, h, b, of);  // res: K's sub-blocks, then V's
    hw::bar_wait(&sm.res_full, 0);

    // A query tile's lse and delta, one query a thread of the first 64, by
    // cp.async into tile_vec[t % 2] a tile ahead, so the warpgroup's
    // products never wait for device memory (zeros past n).  The slot is
    // free: every thread read it two tiles ago, before the barrier that
    // ended the last tile.  Waited for at the tile's start, read after a
    // barrier below.
    auto copy_vec = [&](int t) SFC_INLINE_LAMBDA {
      const int q = t * BM + tid;
      if (tid < BM) {
        const size_t at = static_cast<size_t>(bh) * n + min(q, n - 1);
        sfc::cp_async4(&sm.tile_vec[t & 1][0][tid], p.lse + at, q < n);
        if constexpr (DK) sfc::cp_async4(&sm.tile_vec[t & 1][1][tid], p.delta + at, q < n);
      }
      sfc::cp_async_commit();
    };
    copy_vec(0);
    float st[32], dpt[DK ? 32 : 1];
    uint32_t fa[DV ? 4 : 1][4], fb[DK ? 4 : 1][4];
    for (int t = 0; t < tiles; ++t) {
      const int qa = t * BM;
      const float(*const vec)[64] = sm.tile_vec[t & 1];
      if (t + 1 < tiles) {
        copy_vec(t + 1);
        sfc::cp_async_wait<1>();  // this tile's
      } else {
        sfc::cp_async_wait<0>();
      }
      uint32_t bits = 0;
      if constexpr (DROP)
        bits = mask_bits<true>(fw::take(sm, cur), mask_tma, mg, n, bh, qa, k0);
      [[maybe_unused]] const int e0 = cur.e;  // kReuse: the entry of Q's slot, dA's the next
      fw::logits<C>(sm, cur, st, 0);  // s^T = k . q^T
      if constexpr (kSplit) release<C>(sm, cur, p, h, b, of);
      if constexpr (DK) fw::logits<C>(sm, cur, dpt, C);  // dp^T = v . da^T
      if constexpr (kReuse) {
        hw::wgmma_wait<0>();
        __syncthreads();  // the staged lse and delta
      } else if constexpr (DK) {
        release<C>(sm, cur, p, h, b, of);
      }
      hw::fence_regs(st);
      if constexpr (DK) hw::fence_regs(dpt);
      // pn^T (or bf16(pdf)^T) and ds^T, a k16 step at a time, straight
      // into their A fragments; queries at or past n give 0.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float pv[8], ds8[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int i = 8 * kk + m, hf = (i / 2) % 2, col = 8 * (i / 4) + c0 + (i % 2);
          const bool ok = key_ok[hf] && qa + col < n;
          const float pe = ok ? hw::exp2_approx(fmaf(st[i], cl, -vec[0][col] * kLog2e)) : 0.f;
          const bool kept = ok && (bits >> i & 1u);
          const float pn = __bfloat162float(__float2bfloat16(pe));
          if constexpr (DV) pv[m] = DROP ? (kept ? sfc::div_rn(pe, keep, rk) : 0.f) : pn;
          if constexpr (DK) {
            const float dl = vec[1][col];
            ds8[m] = DROP ? pe * ((kept ? sfc::div_rn(dpt[i], keep, rk) : 0.f) - dl) * scale
                          : pn * (dpt[i] - dl) * scale;
          }
        }
        if constexpr (DV) pack8(pv, fa[kk]);
        if constexpr (DK) pack8(ds8, fb[kk]);
      }
      uint64_t dx[R + (kReuse ? 1 : 0)];  // the output products' B operands
      if constexpr (kReuse) {  // Q's and dA's slots of the logits
        dx[0] = hw::desc_sw128(sm.ring[e0 % NS]);
        dx[1] = hw::desc_sw128(sm.ring[(e0 + 1) % NS]);
      } else {
        fw::take_descs(sm, cur, dx);
      }
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if constexpr (DK) hw::fence_regs(acc_k[c]);
        if constexpr (DV) hw::fence_regs(acc_v[c]);
      }
      if constexpr (DK) hw::fence_frags(fb);
      if constexpr (DV) hw::fence_frags(fa);
      hw::wgmma_fence();
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if constexpr (DK) fw::product_t(acc_k[c], fb, dx[c]);  // dk += ds^T . q
        if constexpr (DV) fw::product_t(acc_v[c], fa, dx[kReuse ? 1 : c]);  // dv += p^T . da
      }
      hw::wgmma_commit();
      release<C>(sm, cur, p, h, b, of);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if constexpr (DK) hw::fence_regs(acc_k[c]);
        if constexpr (DV) hw::fence_regs(acc_v[c]);
      }
      if constexpr (DK) hw::fence_frags(fb);
      if constexpr (DV) hw::fence_frags(fa);
    }
    store();
  };
  if constexpr (C == 1) walk(std::true_type{}, std::true_type{});
  else if (part == 0) walk(std::false_type{}, std::true_type{});
  else walk(std::true_type{}, std::false_type{});
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C, bool DROP>
cudaError_t launch(const Params& p, int batch, cudaStream_t s) {
  auto dq = attention_bwd_stream_dq<C, DROP>;
  auto dkv = attention_bwd_stream_dkv<C, DROP>;
  cudaError_t e = prepare(dq, kSmemBytes<C>);
  if (e == cudaSuccess) e = prepare(dkv, kSmemBytes<C>);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(batch) * p.heads * p.tiles;
  dq<<<static_cast<unsigned>(items * (C / dq_group(C))), fw::kThreads, kSmemBytes<C>, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv<<<static_cast<unsigned>(items * dkv_parts(C)), fw::kThreads, kSmemBytes<C>, s>>>(p);
  return cudaGetLastError();
}

// Calls f(C, DROP) (integral constants) for c sub-heads; false past 4.
template <typename F>
bool with_instance(int c, bool drop, F&& f) {
  auto go = [&](auto Cc) {
    if (drop) f(Cc, std::true_type{});
    else f(Cc, std::false_type{});
    return true;
  };
  switch (c) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    case 4: return go(std::integral_constant<int, 4>{});
    default: return false;
  }
}

}  // namespace

// qkv bf16 [batch, n, 3*heads*dh], att and datt bf16 [batch, n, heads*dh],
// lse fp32 [batch, heads, n], mask uint8 0/1 [batch, heads, n, n] or null
// (no dropout; keep in (0, 1] with a mask), delta fp32 [batch, heads, n]
// a workspace, all contiguous and on 16 bytes; dqkv bf16 [batch, n,
// 3*heads*dh] receives dq, dk and dv (every element is written).  Keys at
// or past n_valid (1 <= n_valid <= n) are masked.  dh a multiple of 16 up
// to 256, any n >= 1.
extern "C" int sfc_attention_bwd_stream_bf16(const void* qkv, const void* att, const void* datt,
                                             const void* lse, const void* mask, void* delta,
                                             void* dqkv, int batch, int n, int heads, int dh,
                                             int n_valid, float scale, float keep, void* stream) {
  const bool drop = mask != nullptr;
  if (!hw::head_dim_ok(dh) || n < 1 || heads < 1 || n_valid < 1 || n_valid > n || batch < 0 ||
      (drop && !(keep > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long inner = static_cast<long long>(heads) * dh, row = 3 * inner;
  const auto* base = static_cast<const bf16*>(qkv);
  Params p{};
  cudaError_t e = hw::map_heads(&p.q, base, false, batch, n, heads, dh, row, BM);
  if (e == cudaSuccess) e = hw::map_heads(&p.k, base + inner, false, batch, n, heads, dh, row, BM);
  if (e == cudaSuccess)
    e = hw::map_heads(&p.v, base + 2 * inner, false, batch, n, heads, dh, row, BM);
  if (e == cudaSuccess) e = hw::map_heads(&p.da, datt, false, batch, n, heads, dh, inner, BM);
  p.mask_tma = drop && n % 16 == 0 && n >= BM;  // a TMA box over the mask's rows
  if (e == cudaSuccess && p.mask_tma)
    e = hw::map_mask_u8(&p.mask, mask, static_cast<long long>(batch) * heads * n, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.att = static_cast<const bf16*>(att);
  p.lse = static_cast<const float*>(lse);
  p.mask_g = static_cast<const uint8_t*>(mask);
  p.delta = static_cast<float*>(delta);
  p.dqkv = static_cast<bf16*>(dqkv);
  p.n = n;
  p.heads = heads;
  p.dh = dh;
  p.n_valid = n_valid;
  p.tiles = (n + BM - 1) / BM;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.keep = drop ? keep : 1.f;
  auto s = static_cast<cudaStream_t>(stream);
  e = cudaErrorInvalidValue;
  with_instance(hw::subheads(dh), drop, [&](auto C, auto D) {
    e = launch<decltype(C)::value, decltype(D)::value>(p, batch, s);
  });
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the dq kernel (dkv 0) or of
// the dk/dv kernel (dkv 1) at c sub-heads (1 to 4), with the mask or
// without, into out[3].
extern "C" int sfc_attention_bwd_stream_attrs(int c, int masked, int dkv, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_instance(c, masked != 0, [&](auto C, auto D) {
    constexpr int cc = decltype(C)::value;
    constexpr bool d = decltype(D)::value;
    err = dkv ? hw::kernel_attrs(attention_bwd_stream_dkv<cc, d>, kSmemBytes<cc>, out)
              : hw::kernel_attrs(attention_bwd_stream_dq<cc, d>, kSmemBytes<cc>, out);
  });
  return err;
}
