// Flash attention backward on [B, N, H, Dh] in float32 (kernels #9, #10
// and #11's fp32 forms), for Hopper: dq [B, Nq, H, Dh] and dk, dv [B, Nk,
// H, Dh] from q, k, v, the output's cotangent g, the forward's fp32 lse
// and delta = rowsum(g * O) (both [B, H, Nq]), head dim 64, 128 or 256,
// nq != nk allowed.  Every product is three TF32 products on wgmma
// (3xTF32, csrc/attn_f32.cuh: the big part rounded to nearest, the small
// part left to the tensor cores).
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/flash_attention.py::
// _dq_kernel (line 440: #10, the dq kernels below) and _dkv_kernel (line
// 482: #11, the dk/dv kernels), which take any dtype with fp32 sums, and
// _fused_bwd_kernel (line 317: #9, the backward to 8,192 tokens).  #9's
// fp32 form is the same two kernels: the TPU kernel carries dK and dV
// across its sequential grid, which Hopper's blocks, running in no order,
// cannot; the bf16 #9 adds dQ by TMA reduce-adds whose order changes from
// run to run, and the fp32 attention backward repeats bit for bit.  So
// each output here has one owner, and #9 takes its lse and delta from the
// forward as #10 and #11 do (its TPU kernel recomputes the row sum and
// takes delta = rowsum(p * dp): fp32-ulp departures).  The windowed
// instances (WINDOW) are the curve-local backward #13 in float32:
// sfc_vit_tpu/ops/local_attention.py::_bwd_kernel (line 198), scatter as
// gather, with the same p, dp and ds: dq of a query block over the key
// tiles of its window, dk and dv of a key block over the query tiles whose
// window holds it (the window is symmetric).  block is a multiple of 64,
// so a block's 64 own rows lie in one curve block and its window is whole
// 64-row tiles (sm90.cuh::local_tile_window).
//
// Formula, the plain versions' (flash_dq_ref, flash_dkv_ref):
//   p = exp(s * scale - lse), 0 at keys at or past nk;  dp = g . v;
//   ds = p (dp - delta) scale;  dq = ds k,  dk = ds^T q,  dv = p^T g.
// Queries at or past nq add nothing to dk and dv.  Nothing is rounded to a
// narrower type; only the order of the fp32 sums differs.  Each tile's
// product is taken fresh and added to the output in fp32 registers (run
// across a long row's tiles in the wgmma accumulator, dq drifted 2.2e-4 of
// its largest |value| from the plain version at 16,384 keys on the H100),
// each output row summed by one block in tile order: the same bits on
// every call, no atomics.
//
// Bound on this card: operations over 3xTF32's 165 TFLOP/s: 6 Nq Nk Dh a
// (b, h) for dq (S, dP, dS K) and 8 for dk and dv (S, dP, P^T g, dS^T q),
// the nominal 10 of the pair with S and dP computed twice.  Both designs
// below execute exactly those 6 and 8 units.
//
// Dh 64 (C = 1 sub-head): csrc/attention_bwd_f32.cu's two kernels over
// separate q, k, v and g (flash_dq_f32_sm90, flash_dkv_f32_sm90).  A block
// is one warpgroup over 64 own rows, two blocks an SM; its own A operands
// stay resident and the other side's 64 x 64 sub-blocks stream through a
// ring of two, each split by the threads into the big and small K-major
// tiles (plainly for S and dP, transposed under the key permutation for
// the outputs' products), a __syncthreads after each split.
//
// Dh 128 and 256 (C = 2, 4: flash_bwd_f32_wide).  A block is two
// warpgroups over 64 own rows of one (b, h) (queries for dq, keys for
// dk/dv), one block an SM, no producer warp; it walks the other side's
// 64-row tiles once.  Per tile:
//  D, S  warpgroup w takes the products of the tile's 32 other rows 32 w ..
//        32 w + 31 against all 64 own rows, summed over the C sub-heads
//        (m64n32): dp from (Y, T), s from (X, H), where dq's X, Y, H, T are
//        Q, g, K, V and dk/dv's are K, V, Q, g.  A is the own sub-block,
//        split in registers; B the warpgroup's 32 rows of the other
//        sub-block, split into the warpgroup's own compact K-major pair.
//  E     p and ds of those 32 columns in fp32 registers (the formula
//        above), written to the block's exchange tiles (64 own x 64 other,
//        the columns in the key permutation), one block barrier.
//  PV    warpgroup w owns sub-heads c = w, w + 2 of the outputs: each tile's
//        product over all 64 other rows, in two 32-column halves (m64n32),
//        A the exchange tile split in registers, B the other sub-block's
//        half transposed and split; taken fresh (into s, dead by then) and
//        added to the output in fp32 registers at the next operation.  dq:
//        ds H; dk/dv: ds^T H and, in the D phase once p is known, p^T T.
// Each output stays in registers for the whole walk and is stored once
// (dq 32 C, dk + dv 64 C fp32 accumulators a thread, halved by the column
// split).  Each sub-block of the other side comes once a tile (TMA) and is
// split once per form (plain: each warpgroup its 32 rows; transposed: its
// owner, by halves).  An operation of a warpgroup splits its B into the
// next of two slots of its own while its last product runs (the one
// before, which read that slot, is done), waits for that product, loads
// and splits A's fragments of all 8 k8 steps (in the dk/dv kernel at Dh
// 256, whose dk and dv take 128 registers, two batches of 4), passes the
// warpgroup's barrier and issues the 24 products at once: no product waits
// for the split of a later operand, and no block barrier follows a
// product.  The other side's sub-blocks come through two rings, each slot
// freed by its own empty barrier once both warpgroups are done with it: H
// (held from S to PV, one tile of C slots) and a stream ring of the rest.
// The first thread of either warpgroup feeds a ring after its releases
// there, claiming each entry by an atomic, once its products are issued
// (fed before them, the feed held the warpgroup's products back).  A ring
// wait is left by a
// warp's lanes together (__all_sync): a divergent wait between products
// made ptxas serialize them at Dh 256 (C7518).  At Dh 128 the own X and Y
// (64 KB) stay resident for the whole walk; at Dh 256 they are 128 KB,
// which do not fit beside a tile of H, the split slots and the exchange
// tiles in 227 KB, so they come through the stream ring once a tile for
// the whole block.
#include <type_traits>

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
namespace af = sfc::attn_f32;

constexpr int BM = 64;      // rows a tile
constexpr int kStages = 4;  // the Dh 64 kernels' slots (sub-blocks)
using Smem = af::Smem<kStages>;
constexpr int kSmemBytes = af::kSmemBytes<kStages>;

struct Params {
  CUtensorMap q, k, v, g;  // map_strided_heads over [B, N, H, Dh], 64-row boxes
  const float* lse;        // [B, H, nq]
  const float* delta;      // [B, H, nq]
  float* dq;               // [B, nq, H, Dh] contiguous
  float* dk;               // [B, nk, H, Dh] contiguous
  float* dv;
  int heads, dh, nq, nk, q_tiles, k_tiles;
  int block, halo;  // the windowed instances' curve block and halo
  float scale;
};

// ---------------------------------------------------------------- Dh 64

// The ring's sources.
enum Src : int { kQ = 0, kK = 1, kV = 2, kG = 3 };

// The tensors of one block: its shared memory, the ring's cursor (the next
// entry e; thread 0's issued entries), the split A fragments.
struct Ctx {
  Smem& sm;
  const Params& p;
  int tid, r0, c0, b, h, bh;  // r0, c0: the accumulators' first row and column
  int e = 0, issued = 0, entries = 0;
  uint64_t db = 0, dsm = 0;
  uint32_t fb[2][4], fs[2][4];
};

// The ring's slots: two, the other two of the four holding the block's own
// A operands for the whole walk (resident: the dq kernel's Q and g, the
// dk/dv kernel's K and V), so only the B operands stream, each sub-block
// once a tile.
constexpr int kRing = 2;
constexpr int kResA = 2, kResB = 3;

__device__ __forceinline__ const CUtensorMap* map_of(const Params& p, int src) {
  return src == kQ ? &p.q : src == kK ? &p.k : src == kV ? &p.v : &p.g;
}

template <typename Entry>
__device__ __forceinline__ void feed(Ctx& x, int upto, Entry&& entry) {
  for (; x.issued < upto && x.issued < x.entries; ++x.issued) {
    int src, row;
    entry(x.issued, src, row);
    af::load_sub(x.sm, x.issued % kRing, map_of(x.p, src), x.h, 0, row, x.b);
  }
}

// acc (+)= A B: B the ring's entry eb split into the pair (plainly, K-major
// as stored, or transposed), A's values of a k8 step from a_of.  The
// pair's last product is done first; after the split's barrier the slots
// of the entries before `used` are free for refills.
template <typename Entry, typename AOf>
__device__ __forceinline__ void product(Ctx& x, float (&acc)[32], int eb, int used,
                                        bool transposed, int accumulate, AOf&& a_of,
                                        Entry&& entry) {
  af::split_entry<kRing>(x.sm, eb, transposed);
  if (x.tid == 0) feed(x, used + kRing, entry);
  af::mma3<64, 8>(acc, x.db, x.dsm, a_of, x.fb, x.fs, accumulate);
}

// acc (+)= A B^T, B the ring's entry eb as stored (K-major), A the
// sub-block `as` read a k8 step at a time: S from (Q, K) or (K, Q), dP
// from (g, V) or (V, g).
template <typename Entry>
__device__ __forceinline__ void ab(Ctx& x, float (&acc)[32], const unsigned char* as, int eb,
                                   int used, int accumulate, Entry&& entry) {
  product(
      x, acc, eb, used, false, accumulate,
      [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA { af::a_frag(as, decltype(kk)::value, v); },
      entry);
}

// acc (+)= A X, X the ring's entry eb (transposed), A the accumulator `a`
// of the previous products under the key permutation.
template <typename Entry>
__device__ __forceinline__ void at(Ctx& x, float (&acc)[32], const float (&a)[32], int eb, int used,
                                   int accumulate, Entry&& entry) {
  product(
      x, acc, eb, used, true, accumulate,
      [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA { af::a_perm(a, decltype(kk)::value, v); },
      entry);
}

// The block's resident A operands: rows row of src_a and src_b into slots
// kResA and kResB, on their own barriers.
__device__ __forceinline__ void load_resident(Ctx& x, int src_a, int src_b, int row) {
  af::load_sub(x.sm, kResA, map_of(x.p, src_a), x.h, 0, row, x.b);
  af::load_sub(x.sm, kResB, map_of(x.p, src_b), x.h, 0, row, x.b);
}

// Rows r0 and r0 + 8 of a 64-row tile's accumulators into out's rows
// row0 + ... of head h ([B, n, H, 64] contiguous); rows at or past n are
// not written.
__device__ __forceinline__ void store_sub(const Ctx& x, const float (&acc)[32], float* out, int n,
                                          int row0) {
  const Params& p = x.p;
  const size_t w = static_cast<size_t>(p.heads) * p.dh;
  const int t = af::fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), c0 = 2 * (t & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= n) continue;
    float* dst = out + (static_cast<size_t>(x.b) * n + row) * w + static_cast<size_t>(x.h) * p.dh +
                 c0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
  }
}

// acc (+)= the tile's fresh product `part` (drained first), in fp32
// registers: the sum over the tiles rounds to nearest.
__device__ __forceinline__ void add_tile(float (&acc)[32], float (&part)[32], int t) {
  af::drain(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = t > 0 ? acc[i] + part[i] : part[i];
}

// The dq kernel's ring entries, entry i's source and first row (Q and g
// resident): per key tile t, V_t then K_t, K_t taken twice (plainly for S,
// transposed for dq).
struct DqEntry {
  int t0;  // the block's first key tile
  __device__ __forceinline__ void operator()(int i, int& src, int& row) const {
    src = i & 1 ? kK : kV;
    row = (t0 + (i >> 1)) * BM;
  }
};

// The dk/dv kernel's (K and V resident): per query tile t, g_t then Q_t,
// each taken twice (plainly for dP^T and S^T, transposed for dv and dk).
struct DkvEntry {
  int t0;  // the block's first query tile
  __device__ __forceinline__ void operator()(int i, int& src, int& row) const {
    src = i & 1 ? kQ : kG;
    row = (t0 + (i >> 1)) * BM;
  }
};

__device__ __forceinline__ Ctx make_ctx(Smem& sm, const Params& p, int bh) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  return Ctx{sm, p, tid, 16 * warp + lane / 4, 2 * (lane % 4), bh / p.heads, bh % p.heads, bh};
}

__device__ __forceinline__ void init_ring(Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
}

// The tiles [t0, t0 + tiles) of the other side (n rows) that the block of
// the 64 rows from tile `own` walks: every one, or (WINDOW) its window.
template <bool WINDOW>
__device__ __forceinline__ void walk(const Params& p, int own, int n, int& t0, int& tiles) {
  t0 = 0;
  tiles = (n + BM - 1) / BM;
  if constexpr (WINDOW) {
    int hi;
    hw::local_tile_window(own, BM, n, p.block, p.halo, t0, hi);
    tiles = hi - t0;
  }
}

// WINDOW: #13's dq, over the key tiles of the block's curve-local window.
template <bool WINDOW = false>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_dq_f32_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int nq = p.nq, nk = p.nk;
  const int qt = blockIdx.x % p.q_tiles, bh = blockIdx.x / p.q_tiles, q0 = qt * BM;
  int t0, key_tiles;
  walk<WINDOW>(p, qt, nk, t0, key_tiles);
  Ctx x = make_ctx(sm, p, bh);
  x.entries = 2 * key_tiles;
  const DqEntry entry{t0};

  init_ring(sm);
  if (x.tid == 0) {
    load_resident(x, kQ, kG, q0);
    feed(x, kRing, entry);
  }
  af::pair_desc(sm, x.db, x.dsm);
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + x.r0 + 8 * hf;
    const size_t i = static_cast<size_t>(bh) * nq + min(row, nq - 1);
    lse[hf] = p.lse[i];
    delta[hf] = p.delta[i];
  }
  const float scale = p.scale;

  float dq[32], s[32], dp[32];
  hw::bar_wait(&sm.full[kResA], 0);  // the resident Q and g
  hw::bar_wait(&sm.full[kResB], 0);
  for (int t = 0; t < key_tiles; ++t) {
    // dP from V_t (then free), S from K_t (kept for dq).
    ab(x, dp, sm.ring[kResB], 2 * t, 2 * t + 1, 0, entry);
    ab(x, s, sm.ring[kResA], 2 * t + 1, 2 * t + 1, 0, entry);
    af::drain(s);
    hw::fence_regs(dp);
    // dS into dp: p (dp - delta) scale, 0 at keys at or past nk.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i / 2) % 2, key = (t0 + t) * BM + 8 * (i / 4) + x.c0 + (i % 2);
      float ds = 0.f;
      if (key < nk) {
        const float pn = expf(__fsub_rn(__fmul_rn(s[i], scale), lse[hf]));
        ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], delta[hf])), scale);
      }
      dp[i] = ds;
    }
    // The tile's dS K fresh into s, added to dq in fp32.
    at(x, s, dp, 2 * t + 1, 2 * t + 2, 0, entry);
    add_tile(dq, s, t);
  }
  store_sub(x, dq, p.dq, nq, q0);
}

// The dk/dv kernel's t-th query tile of its walk, query tile ta: S^T and
// dP^T in s and dp, rows keys k0 + r0 (+ 8), columns queries; then p into s
// and dS^T into dp.  The tile's lse and delta are staged in shared memory
// first, by plain loads; they are read after the products' barriers, and
// the last tile's were read before them.
template <typename Entry>
__device__ __forceinline__ void dkv_tile(Ctx& x, float (&s)[32], float (&dp)[32], int t, int ta,
                                         int k0, float scale, const Entry& entry) {
  const Params& p = x.p;
  const int nq = p.nq, nk = p.nk, tid = x.tid;
  Smem& sm = x.sm;
  if (tid < BM) {
    const size_t qi = static_cast<size_t>(x.bh) * nq + min(ta * BM + tid, nq - 1);
    sm.vec[0][tid] = p.lse[qi];
    sm.vec[1][tid] = p.delta[qi];
  }
  // dP^T from g_t, S^T from Q_t (both kept for dv, dk).
  ab(x, dp, sm.ring[kResB], 2 * t, 2 * t, 0, entry);
  ab(x, s, sm.ring[kResA], 2 * t + 1, 2 * t, 0, entry);
  af::drain(s);
  hw::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = x.r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + x.c0 + (i % 2);
    float pn = 0.f, ds = 0.f;
    if (k0 + r < nk && ta * BM + col < nq) {
      pn = expf(__fsub_rn(__fmul_rn(s[i], scale), sm.vec[0][col]));
      ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], sm.vec[1][col])), scale);
    }
    s[i] = pn;
    dp[i] = ds;
  }
}

// WINDOW: #13's dk and dv, over the query tiles whose curve-local window
// holds the block's keys.
template <bool WINDOW = false>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_dkv_f32_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int nk = p.nk;
  const int kt = blockIdx.x % p.k_tiles, bh = blockIdx.x / p.k_tiles, k0 = kt * BM;
  int t0, tiles;
  walk<WINDOW>(p, kt, p.nq, t0, tiles);
  Ctx x = make_ctx(sm, p, bh);
  x.entries = 2 * tiles;
  const DkvEntry entry{t0};

  init_ring(sm);
  if (x.tid == 0) {
    load_resident(x, kK, kV, k0);
    feed(x, kRing, entry);
  }
  af::pair_desc(sm, x.db, x.dsm);
  hw::bar_wait(&sm.full[kResA], 0);  // the resident K and V
  hw::bar_wait(&sm.full[kResB], 0);
  const float scale = p.scale;

  float dv[32], dk[32], s[32], dp[32], part[32];
  for (int t = 0; t < tiles; ++t) {
    dkv_tile(x, s, dp, t, t0 + t, k0, scale, entry);
    // Each tile's product fresh (dS^T Q into s, free after P^T g).
    at(x, part, s, 2 * t, 2 * t + 1, 0, entry);
    add_tile(dv, part, t);
    at(x, s, dp, 2 * t + 1, 2 * t + 2, 0, entry);
    add_tile(dk, s, t);
  }
  store_sub(x, dk, p.dk, nk, k0);
  store_sub(x, dv, p.dv, nk, k0);
}

// ---------------------------------------------------------- Dh 128, 256

namespace wide {

constexpr int kThreads = 256;          // two warpgroups a block
constexpr int kPairHalf = 32 * 128;    // a compact 32-row operand's 32-column half, bytes
constexpr int kPart = 2 * kPairHalf;   // a compact 32-row x 64-column K-major operand

// The stream ring's slots: the other side's T (Dh 128), and at Dh 256 also
// the own X and Y, which do not stay resident there.
__host__ __device__ constexpr int stream_slots(int C) { return C == 2 ? 2 : 4; }
__host__ __device__ constexpr bool own_resident(int C) { return C == 2; }
// Stream entries a tile: T_c (Dh 128); X_c, Y_c and T_c (Dh 256).
__host__ __device__ constexpr int stream_per_tile(int C) { return own_resident(C) ? C : 3 * C; }

template <int N>
struct Subs {
  unsigned char s[N][af::kSub];
};
template <>
struct Subs<0> {};

// 224 KB of tiles at either head dim, each on 1,024 bytes (the struct
// starts there and every tile is a multiple of 1,024).
template <int C>
struct Smem {
  unsigned char held[C][af::kSub];                   // H_c of the tile in hand
  unsigned char stream[stream_slots(C)][af::kSub];   // T_c (and X_c, Y_c at Dh 256)
  unsigned char split[2][2][2][kPart];               // [warpgroup][slot][big, small]
  unsigned char xch[2][af::kSub];                    // dq: ds by tile parity; dk/dv: ds, p
  Subs<own_resident(C) ? 2 * C : 0> own;             // X_c, then Y_c (Dh 128)
  float vec[2][2][BM];                               // dk/dv: lse, delta by tile parity
  uint64_t own_full, held_full[C], held_empty[C];
  uint64_t stream_full[stream_slots(C)], stream_empty[stream_slots(C)];
  int held_issued, stream_issued;  // the rings' next entries to load
};
template <int C>
constexpr int kSmemBytes = sizeof(Smem<C>) + 1024;  // + the 1,024-byte alignment

// The thread's index in its warpgroup, read afresh.
__device__ __forceinline__ int wg_tid() { return hw::fresh_tid() & 127; }

// Rows 32 w .. 32 w + 31 of the sub-block `raw` split into the compact
// big and small pair [2 halves][32 rows][32 columns] (K-major, the
// contraction along the rows' 64 columns), the warpgroup's 128 threads a
// 16-byte chunk each of four, neighbours on neighbouring chunks.
__device__ __forceinline__ void split_rows(const unsigned char* raw, int w, unsigned char* big,
                                           unsigned char* small) {
  const int t = wg_tid();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ch = t + 128 * i, hh = ch >> 8, r = (ch >> 3) & 31, pc = ch & 7;
    const float4 v = *reinterpret_cast<const float4*>(raw + hh * af::kHalf + (32 * w + r) * 128 +
                                                      pc * 16);
    uint4 hi, lo;
    hw::tf32_split(v.x, hi.x, lo.x);
    hw::tf32_split(v.y, hi.y, lo.y);
    hw::tf32_split(v.z, hi.z, lo.z);
    hw::tf32_split(v.w, hi.w, lo.w);
    const int o = hh * kPairHalf + r * 128 + pc * 16;  // the same swizzle: (32 w + r) % 8 = r % 8
    *reinterpret_cast<uint4*>(big + o) = hi;
    *reinterpret_cast<uint4*>(small + o) = lo;
  }
}

// Columns 32 hh .. 32 hh + 31 of the sub-block `raw` (rows: the
// contraction's 64 other rows) transposed and split into the compact pair
// whose row n holds column 32 hh + n of raw, its 64 columns in the key
// permutation: af::split_transposed's map of threads (one of its two
// passes, the one over raw's half hh), no bank conflicts.
__device__ __forceinline__ void split_cols(const unsigned char* raw, int hh, unsigned char* big,
                                           unsigned char* small) {
  const int u = wg_tid() + 128 * hh;
  const int q = u & 15;
  const int nc = ((u >> 6) & 1) | ((((u >> 1) ^ (u >> 4)) & 1) << 1) |
                 ((((u >> 2) ^ (u >> 5)) & 1) << 2) | (((u >> 7) & 1) << 3);
  float v[4][4];  // [i][y]: raw row 8 (q / 2) + q % 2 + 2 i, column 4 nc + y
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 8 * (q >> 1) + (q & 1) + 2 * i;
    const float4 x = *reinterpret_cast<const float4*>(raw + (nc >> 3) * af::kHalf + r * 128 +
                                                      ((((nc & 7) ^ r) & 7) << 4));
    v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
  }
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int n = 4 * (nc & 7) + y;
    const int off = (q >> 3) * kPairHalf + n * 128 + ((((q & 7) ^ n) & 7) << 4);
    uint4 hi, lo;
    hw::tf32_split(v[0][y], hi.x, lo.x);
    hw::tf32_split(v[1][y], hi.y, lo.y);
    hw::tf32_split(v[2][y], hi.z, lo.z);
    hw::tf32_split(v[3][y], hi.w, lo.w);
    *reinterpret_cast<uint4*>(big + off) = hi;
    *reinterpret_cast<uint4*>(small + off) = lo;
  }
}

}  // namespace wide

// C: 64-column sub-heads a head (2 or 4).  kDkv: the dk/dv kernel (own
// rows keys), else dq (own rows queries).  kWindow: #13's instance, over
// the other side's tiles of the block's curve-local window (nq == nk).
// See the head of the file for the walk.
template <int C, bool kDkv, bool kWindow>
__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_bwd_f32_wide(const __grid_constant__ Params p) {
  namespace wd = wide;
  using Sm = wd::Smem<C>;
  constexpr int NS = wd::stream_slots(C), H2 = C / 2, kE = wd::stream_per_tile(C);
  constexpr bool kRes = wd::own_resident(C);
  extern __shared__ __align__(1024) unsigned char dyn[];
  Sm& sm = hw::aligned_smem<Sm>(dyn);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
  const int bh = blockIdx.y, heads = p.heads, b = bh / heads, h = bh % heads;
  const int nq = p.nq, nk = p.nk, n_own = kDkv ? nk : nq, n_other = kDkv ? nq : nk;
  const int own0 = BM * blockIdx.x;
  int t0 = 0, t1 = (n_other + BM - 1) / BM;
  if constexpr (kWindow) hw::local_tile_window(blockIdx.x, BM, n_other, p.block, p.halo, t0, t1);
  const int tiles = t1 - t0;
  // dq: X, Y, H, T = Q, g, K, V;  dk/dv: K, V, Q, g.
  constexpr int kX = kDkv ? kK : kQ, kY = kDkv ? kV : kG, kH = kDkv ? kQ : kK,
                kT = kDkv ? kG : kV;
  const float scale = p.scale;

  // The stream ring's entry i: its map, sub-head and first row.  Dh 128:
  // T_c per tile.  Dh 256, dq: (Y_c, T_c, X_c) for each c; dk/dv: X_c for
  // each c, then (Y_c, T_c) for each c.
  auto stream_src = [&](int i, int& src, int& c, int& row) SFC_INLINE_LAMBDA {
    const int u = i / kE, r = i % kE, other = BM * (t0 + u);
    if constexpr (kRes) {
      src = kT, c = r, row = other;
    } else if constexpr (kDkv) {
      const int rr = r - C;
      c = r < C ? r : rr >> 1;
      src = r < C ? kX : rr & 1 ? kT : kY;
      row = r >= C && (rr & 1) ? other : own0;
    } else {
      c = r / 3;
      src = r % 3 == 0 ? kY : r % 3 == 1 ? kT : kX;
      row = r % 3 == 1 ? other : own0;
    }
  };
  auto load = [&](unsigned char* dst, uint64_t* bar, int src, int c, int row) SFC_INLINE_LAMBDA {
    const CUtensorMap* m = map_of(p, src);
    hw::bar_expect_tx(bar, af::kSub);
    hw::tma_load4(dst, m, bar, 64 * c, h, row, b);
    hw::tma_load4(dst + af::kHalf, m, bar, 64 * c + 32, h, row, b);
  };
  // One thread: load every entry of the held ring (held) and of the stream
  // ring (stream) whose slot is free, in order, claiming each by an atomic
  // (either warpgroup's first thread feeds a ring after its releases
  // there); never waits.
  auto feed = [&](bool held, bool stream) SFC_INLINE_LAMBDA {
    for (int e = held ? *reinterpret_cast<volatile int*>(&sm.held_issued) : tiles * C;
         e < tiles * C;) {
      const int slot = e % C, k = e / C;
      if (k > 0 && !hw::bar_test(&sm.held_empty[slot], (k - 1) & 1)) break;
      const int got = atomicCAS(&sm.held_issued, e, e + 1);
      if (got != e) {
        e = got;
        continue;
      }
      load(sm.held[slot], &sm.held_full[slot], kH, slot, BM * (t0 + k));
      ++e;
    }
    for (int e = stream ? *reinterpret_cast<volatile int*>(&sm.stream_issued) : tiles * kE;
         e < tiles * kE;) {
      const int slot = e % NS, k = e / NS;
      if (k > 0 && !hw::bar_test(&sm.stream_empty[slot], (k - 1) & 1)) break;
      const int got = atomicCAS(&sm.stream_issued, e, e + 1);
      if (got != e) {
        e = got;
        continue;
      }
      int src, c, row;
      stream_src(e, src, c, row);
      load(sm.stream[slot], &sm.stream_full[slot], src, c, row);
      ++e;
    }
  };

  if (tid == 0) {
    hw::bar_init(&sm.own_full, 1);
    for (int s = 0; s < C; ++s) {
      hw::bar_init(&sm.held_full[s], 1);
      hw::bar_init(&sm.held_empty[s], 2);
    }
    for (int s = 0; s < NS; ++s) {
      hw::bar_init(&sm.stream_full[s], 1);
      hw::bar_init(&sm.stream_empty[s], 2);
    }
    sm.held_issued = sm.stream_issued = 0;
    hw::fence_barrier_init();
  }
  // dk/dv: the first tile's lse and delta (rows past nq read the last).
  if (kDkv && tid < 2 * BM)
    sm.vec[0][tid / BM][tid % BM] = (tid < BM ? p.lse : p.delta)[
        static_cast<long long>(bh) * nq + min(BM * t0 + tid % BM, nq - 1)];
  __syncthreads();
  if (tid == 0) {
    if constexpr (kRes) {
      hw::bar_expect_tx(&sm.own_full, 2 * C * af::kSub);
      const CUtensorMap *mx = map_of(p, kX), *my = map_of(p, kY);
      for (int c = 0; c < C; ++c) {
        hw::tma_load4(sm.own.s[c], mx, &sm.own_full, 64 * c, h, own0, b);
        hw::tma_load4(sm.own.s[c] + af::kHalf, mx, &sm.own_full, 64 * c + 32, h, own0, b);
        hw::tma_load4(sm.own.s[C + c], my, &sm.own_full, 64 * c, h, own0, b);
        hw::tma_load4(sm.own.s[C + c] + af::kHalf, my, &sm.own_full, 64 * c + 32, h, own0, b);
      }
    }
    feed(true, true);
  }

  // dq: its rows' lse and delta (rows past nq read the last: never stored).
  float lse[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long i = static_cast<long long>(bh) * nq + min(own0 + r0 + 8 * hf, nq - 1);
      lse[hf] = p.lse[i];
      dl[hf] = p.delta[i];
    }
  }

  // o0: dq, or dk; o1: dv.  [owned sub-head cc: c = 2 cc + w][half][m64n32]
  // s: the logits, then (s dead once p is written out) each fresh product
  // of an output, added to it at the next operation.
  float o0[H2][2][16], o1[kDkv ? H2 : 1][2][16], s[16], dp[16];
#pragma unroll
  for (int cc = 0; cc < H2; ++cc)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 16; ++i) o0[cc][hh][i] = o1[kDkv ? cc : 0][hh][i] = 0.f;
  // A's fragments of kSteps k8 steps are loaded and split in registers
  // before their products issue at once (the warpgroup then goes on to its
  // next split while the tensor cores run them): all 8 (64 registers), or
  // in the dk/dv kernel at Dh 256, whose dk and dv take 128 registers, two
  // batches of 4.
  constexpr int kSteps = kDkv && C == 4 ? 4 : 8;
  uint32_t fb[kSteps][4], fs[kSteps][4];
  int nsplit = 0;      // the warpgroup's splits so far: slot nsplit % 2 is the next
  int rel_later = -1;  // kSteps 4: A's stream entry, released at the next barrier
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;

  auto wg_sync = [&]() SFC_INLINE_LAMBDA { hw::named_sync(1 + w, 128); };
  // A ring wait whose loop every lane of a warp leaves together: a
  // divergent wait between products made ptxas serialize them (C7518).
  // Like hw::bar_wait, a phase that never completes traps rather than
  // hanging the card.
  auto wait_full = [&](uint64_t* bar, uint32_t parity) SFC_INLINE_LAMBDA {
    for (uint32_t polls = 0; !__all_sync(0xffffffffu, hw::bar_test(bar, parity));)
      if (++polls == (1u << 30)) __trap();
  };
  auto held_at = [&](int u, int c) SFC_INLINE_LAMBDA {
    wait_full(&sm.held_full[c], u & 1);
    return static_cast<const unsigned char*>(sm.held[c]);
  };
  auto own_at = [&](int i) SFC_INLINE_LAMBDA {  // resident X_c (i = c), Y_c (i = C + c)
    if constexpr (kRes) return static_cast<const unsigned char*>(sm.own.s[i]);
    else return static_cast<const unsigned char*>(nullptr);
  };
  auto stream_at = [&](int i) SFC_INLINE_LAMBDA {
    wait_full(&sm.stream_full[i % NS], (i / NS) & 1);
    return static_cast<const unsigned char*>(sm.stream[i % NS]);
  };
  // After a warpgroup barrier that follows its last read: this warpgroup
  // is done with the entry (i < 0: none); the caller feeds the ring after.
  auto release_held = [&](int c) SFC_INLINE_LAMBDA {
    if (wt == 0 && c >= 0) hw::bar_arrive(&sm.held_empty[c]);
  };
  auto release_stream = [&](int i) SFC_INLINE_LAMBDA {
    if (wt == 0 && i >= 0) hw::bar_arrive(&sm.stream_empty[i % NS]);
  };
  auto release_later = [&]() SFC_INLINE_LAMBDA {  // after a block barrier
    if (rel_later >= 0) {
      release_stream(rel_later);
      if (wt == 0) feed(false, true);
    }
    rel_later = -1;
  };
  // A's fragments of k8 steps k0 .. k0 + kSteps - 1 from the sub-block a.
  auto load_frags = [&](const unsigned char* a, auto K0) SFC_INLINE_LAMBDA {
    sfc::static_for<kSteps>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value;
      float v[4];
      af::a_frag_wg(a, decltype(K0)::value + kk, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) hw::tf32_split(v[e], fb[kk][e], fs[kk][e]);
    });
    hw::fence_frags(fb);
    hw::fence_frags(fs);
  };
  // acc (+)= the loaded steps' products, 3xTF32, committed.
  auto issue = [&](float (&acc)[16], uint64_t db, uint64_t dsm, int accumulate, auto K0)
                   SFC_INLINE_LAMBDA {
    hw::fence_regs(acc);
    hw::wgmma_fence();
    sfc::static_for<kSteps>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value, step = decltype(K0)::value + kk;
      constexpr int off = (step / 4) * (wd::kPairHalf >> 4) + 2 * (step % 4);
      hw::wgmma_tf32_rs_n32_at<off>(acc, fb[kk], dsm, kk == 0 ? accumulate : 1);
      hw::wgmma_tf32_rs_n32_at<off>(acc, fs[kk], db, 1);
      hw::wgmma_tf32_rs_n32_at<off>(acc, fb[kk], db, 1);
    });
    hw::wgmma_commit();
  };
  // One operation of the warpgroup: acc (+)= A B (m64n32, 64 deep), A the
  // 64 x 64 sub-block a, B the raw sub-block's rows 32 w .. 32 w + 31 (hh
  // < 0) or its columns 32 hh .. 32 hh + 31 transposed (a product over the
  // other rows), split into the warpgroup's next slot while its last
  // product runs (the one before, which read the slot, is done).  Then
  // every product of the warpgroup is done: with `add` the fresh product
  // in s goes into pend.  The warpgroup's barrier follows its reads of raw
  // and of A's first batch: the entries rel_h (held), rel_b and, when that
  // was all of A, rel_a (stream) are released there.
  auto op = [&](const unsigned char* a, const unsigned char* raw, int hh, float (&acc)[16],
                int accumulate, float (&pend)[16], bool add, int rel_h, int rel_a, int rel_b)
                SFC_INLINE_LAMBDA {
    const int j = nsplit++ & 1;
    unsigned char* big = sm.split[w][j][0];
    unsigned char* small = sm.split[w][j][1];
    if (hh < 0)
      wd::split_rows(raw, w, big, small);
    else
      wd::split_cols(raw, hh, big, small);
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_frags(fb);
    hw::fence_frags(fs);
    if (add) {
#pragma unroll
      for (int i = 0; i < 16; ++i) pend[i] += s[i];
    }
    load_frags(a, std::integral_constant<int, 0>{});
    hw::fence_async_shared();
    wg_sync();
    const int rel_s = kSteps == 8 ? rel_a : -1;
    const bool feed_h = rel_h >= 0, feed_s = rel_b >= 0 || rel_s >= 0 || rel_later >= 0;
    release_held(rel_h);
    release_stream(rel_b);
    release_stream(rel_s);
    release_stream(rel_later);
    rel_later = kSteps == 8 ? -1 : rel_a;
    const uint64_t db = hw::desc_sw128(big), dsm = hw::desc_sw128(small);
    issue(acc, db, dsm, accumulate, std::integral_constant<int, 0>{});
    // The rings refilled while the products run.
    if (wt == 0 && (feed_h || feed_s)) feed(feed_h, feed_s);
    if constexpr (kSteps < 8) {
      hw::wgmma_wait<0>();
      load_frags(a, std::integral_constant<int, kSteps>{});
      issue(acc, db, dsm, 1, std::integral_constant<int, kSteps>{});
    }
  };
  // This thread's element i of an m64n32 accumulator: its column among the
  // tile's 64 other rows, and that column's place in the exchange tile
  // (the key permutation: physical 2 tq + e of a group of 8 is logical
  // tq + 4 e).
  // (From the thread's index read afresh: offsets held across the walk
  // would take registers beside the accumulators.)
  auto col_of = [&](int i) SFC_INLINE_LAMBDA {
    const int t = hw::fresh_tid();
    return 32 * (t >> 7) + 8 * (i / 4) + 2 * (t & 3) + (i % 2);
  };
  auto xch_at = [&](int i) SFC_INLINE_LAMBDA {
    const int t = hw::fresh_tid();
    return af::sub_at(16 * ((t >> 5) & 3) + ((t >> 2) & 7) + 8 * ((i / 2) % 2),
                      32 * (t >> 7) + 8 * (i / 4) + (t & 3) + 4 * (i % 2));
  };

  if constexpr (kRes) hw::bar_wait(&sm.own_full, 0);
  for (int u = 0; u < tiles; ++u) {
    const int other0 = BM * (t0 + u), e0 = u * kE;
    if constexpr (!kDkv) {
      // D and S of each sub-head: dp (+)= Y_c T_c^T, s (+)= X_c H_c^T (the
      // first adds the tile before's last ds K).
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        constexpr int c = decltype(Cc)::value;
        const int ey = e0 + 3 * c, et = kRes ? e0 + c : ey + 1;
        op(kRes ? own_at(C + c) : stream_at(ey), stream_at(et), -1, dp, c > 0, o0[H2 - 1][1],
           c == 0, -1, kRes ? -1 : ey, et);
        // the owner keeps H_c for dq
        op(kRes ? own_at(c) : stream_at(ey + 2), held_at(u, c), -1, s, c > 0, s, false,
           c % 2 != w ? c : -1, kRes ? -1 : ey + 2, -1);
      });
      // E: ds of this warpgroup's 32 keys into the exchange tile of the
      // tile's parity (its readers two tiles back are past the barrier of
      // the tile before).
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      unsigned char* xc = sm.xch[u & 1];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hf = (i / 2) % 2;
        float ds = 0.f;
        if (other0 + col_of(i) < nk) {
          const float pn = expf(__fsub_rn(__fmul_rn(s[i], scale), lse[hf]));
          ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], dl[hf])), scale);
        }
        *reinterpret_cast<float*>(xc + xch_at(i)) = ds;
      }
      __syncthreads();
      release_later();
      // PV: dq (+)= ds K over this warpgroup's sub-heads, each half fresh.
      sfc::static_for<H2>([&](auto CC) SFC_INLINE_LAMBDA {
        constexpr int cc = decltype(CC)::value;
        const int c = 2 * cc + w;
        op(xc, sm.held[c], 0, s, 0, o0[cc > 0 ? cc - 1 : 0][1], cc > 0, -1, -1, -1);
        op(xc, sm.held[c], 1, s, 0, o0[cc][0], true, c, -1, -1);
      });
    } else {
      // The next tile's lse and delta, loaded now, staged before E1.
      float nxt = 0.f;
      if (tid < 2 * BM && u + 1 < tiles)
        nxt = (tid < BM ? p.lse : p.delta)[static_cast<long long>(bh) * nq +
                                            min(other0 + BM + tid % BM, nq - 1)];
      const float* lq = sm.vec[u & 1][0];
      const float* dlq = sm.vec[u & 1][1];
      // S: s^T (+)= X_c H_c^T (K_c Q_t,c^T); the first adds the tile
      // before's last ds^T Q.
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        constexpr int c = decltype(Cc)::value;
        // the owner keeps H_c for dk
        op(kRes ? own_at(c) : stream_at(e0 + c), held_at(u, c), -1, s, c > 0, o0[H2 - 1][1],
           c == 0, c % 2 != w ? c : -1, kRes ? -1 : e0 + c, -1);
      });
      // E1: p of this warpgroup's 32 queries into the exchange tile P (its
      // readers, the tile before's dv products, are past E2's barrier
      // there; E2 reads this thread's own p back from it rather than hold
      // 16 registers through D); 0 at queries at or past nq.
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = col_of(i);
        *reinterpret_cast<float*>(sm.xch[1] + xch_at(i)) =
            other0 + col < nq ? expf(__fsub_rn(__fmul_rn(s[i], scale), lq[col])) : 0.f;
      }
      if (tid < 2 * BM && u + 1 < tiles) sm.vec[(u + 1) & 1][tid / BM][tid % BM] = nxt;
      __syncthreads();
      release_later();
      // D, by pairs of sub-heads (2 m, 2 m + 1): dp^T (+)= Y_c T_c^T for
      // both, then dv (+)= p^T T_c over this warpgroup's c = 2 m + w, each
      // half fresh.
      sfc::static_for<H2>([&](auto M) SFC_INLINE_LAMBDA {
        constexpr int m = decltype(M)::value;
        int et[2];
        sfc::static_for<2>([&](auto Ww) SFC_INLINE_LAMBDA {
          constexpr int ww = decltype(Ww)::value, c = 2 * m + ww;
          const int ey = kRes ? -1 : e0 + C + 2 * c;
          et[ww] = kRes ? e0 + c : ey + 1;
          // the owner keeps T_c for dv
          op(kRes ? own_at(C + c) : stream_at(ey), stream_at(et[ww]), -1, dp, c > 0,
             o1[m > 0 ? m - 1 : 0][1], m > 0 && ww == 0, -1, ey, c % 2 != w ? et[ww] : -1);
        });
        const int mine = w ? et[1] : et[0];
        const unsigned char* traw = sm.stream[mine % NS];
        op(sm.xch[1], traw, 0, s, 0, s, false, -1, -1, -1);
        op(sm.xch[1], traw, 1, s, 0, o1[m][0], true, -1, -1, mine);
      });
      // E2: ds into the exchange tile DS (its readers, the tile before's dk
      // products, are past E1's barrier); the last dv half added.
      hw::wgmma_wait<0>();
      hw::fence_regs(dp);
      hw::fence_regs(s);
#pragma unroll
      for (int i = 0; i < 16; ++i) o1[H2 - 1][1][i] += s[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = col_of(i);
        const float pn = *reinterpret_cast<const float*>(sm.xch[1] + xch_at(i));
        *reinterpret_cast<float*>(sm.xch[0] + xch_at(i)) =
            __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], dlq[col])), scale);
      }
      __syncthreads();
      release_later();
      // PV: dk (+)= ds^T Q over this warpgroup's sub-heads, each half fresh.
      sfc::static_for<H2>([&](auto CC) SFC_INLINE_LAMBDA {
        constexpr int cc = decltype(CC)::value;
        const int c = 2 * cc + w;
        op(sm.xch[0], sm.held[c], 0, s, 0, o0[cc > 0 ? cc - 1 : 0][1], cc > 0, -1, -1, -1);
        op(sm.xch[0], sm.held[c], 1, s, 0, o0[cc][0], true, c, -1, -1);
      });
    }
  }
  // The last fresh product.
  hw::wgmma_wait<0>();
  hw::fence_regs(s);
#pragma unroll
  for (int i = 0; i < 16; ++i) o0[H2 - 1][1][i] += s[i];

  // Each thread's rows r0 and r0 + 8 of its sub-heads, once.
  const int dh = p.dh;
  auto store = [&](const float (&o)[H2][2][16], float* out) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = own0 + r0 + 8 * hf;
      if (row >= n_own) continue;
      float* dst = out + (static_cast<long long>(b) * n_own + row) * heads * dh +
                   static_cast<long long>(h) * dh + 64 * w + c0;
#pragma unroll
      for (int cc = 0; cc < H2; ++cc)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(dst + 128 * cc + 32 * hh + 8 * j) =
                make_float2(o[cc][hh][4 * j + 2 * hf], o[cc][hh][4 * j + 2 * hf + 1]);
    }
  };
  if constexpr (kDkv) {
    store(o0, p.dk);
    store(o1, p.dv);
  } else {
    store(o0, p.dq);
  }
}

// Calls f(C) (an integral constant) for the sub-heads of dh: 64, 128 and
// 256 give C = 1, 2, 4; false for any other dh.
template <typename F>
bool with_subheads(int dh, F&& f) {
  switch (dh) {
    case 64: f(std::integral_constant<int, 1>{}); return true;
    case 128: f(std::integral_constant<int, 2>{}); return true;
    case 256: f(std::integral_constant<int, 4>{}); return true;
    default: return false;
  }
}

// The kernel of sub-heads C, part (0: dq, 1: dk/dv) and window, with its
// threads and dynamic shared bytes, to f(kernel, threads, smem).
template <int C, typename F>
void with_kernel(int part, bool window, F&& f) {
  if constexpr (C == 1) {
    if (part == 0)
      f(window ? flash_dq_f32_sm90<true> : flash_dq_f32_sm90<false>, af::kThreads, kSmemBytes);
    else
      f(window ? flash_dkv_f32_sm90<true> : flash_dkv_f32_sm90<false>, af::kThreads, kSmemBytes);
  } else {
    constexpr int bytes = wide::kSmemBytes<C>;
    if (part == 0)
      f(window ? flash_bwd_f32_wide<C, false, true> : flash_bwd_f32_wide<C, false, false>,
        wide::kThreads, bytes);
    else
      f(window ? flash_bwd_f32_wide<C, true, true> : flash_bwd_f32_wide<C, true, false>,
        wide::kThreads, bytes);
  }
}

// The parameters of a call; dq, dk, dv as given (null: not computed).
cudaError_t plan(Params& p, const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv, int batch,
                 int heads, int nq, int nk, int dh, const long long (&st)[12], float scale) {
  const void* bases[4] = {q, k, v, g};
  CUtensorMap* maps[4] = {&p.q, &p.k, &p.v, &p.g};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = hw::map_strided_heads(maps[i], bases[i], true, batch,
                                                i == 1 || i == 2 ? nk : nq, heads, dh,
                                                st[3 * i], st[3 * i + 1], st[3 * i + 2], BM);
    if (e != cudaSuccess) return e;
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.heads = heads;
  p.dh = dh;
  p.nq = nq;
  p.nk = nk;
  p.q_tiles = (nq + BM - 1) / BM;
  p.k_tiles = (nk + BM - 1) / BM;
  p.scale = scale;
  return cudaSuccess;
}

// dq (which 0: the dq kernel) or dk and dv (which 1: the dk/dv kernel),
// over every row of the other side (block 0) or the curve-local window of
// block and halo (#13: block a positive multiple of 64, halo >= 1, nq ==
// nk).  Dh 64: a block per 64 own rows of a (b, h), a 1-d grid; Dh 128 and
// 256: grid (own tiles, B H).
int run(int which, const void* q, const void* k, const void* v, const void* g, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int nq, int nk,
        int dh, const long long (&st)[12], float scale, int block, int halo, void* stream) {
  const bool window = block != 0;
  if (nq < 1 || nk < 1 || heads < 1 || batch < 0 ||
      (window && (block < 0 || block % 64 || halo < 1 || nq != nk)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  cudaError_t e = plan(p, q, k, v, g, lse, delta, dq, dk, dv, batch, heads, nq, nk, dh, st, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.block = block;
  p.halo = halo;
  auto s = static_cast<cudaStream_t>(stream);
  const int own_tiles = which == 0 ? p.q_tiles : p.k_tiles;
  e = cudaErrorInvalidValue;
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    with_kernel<c>(which, window, [&](auto kernel, int threads, int bytes) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return;
      const dim3 grid = c == 1 ? dim3(batch * heads * own_tiles) : dim3(own_tiles, batch * heads);
      kernel<<<grid, threads, bytes, s>>>(p);
      e = cudaGetLastError();
    });
  });
  return static_cast<int>(e);
}

}  // namespace

// #10 in float32: dq fp32 [batch, nq, heads, dh] contiguous from q, g fp32
// [batch, nq, heads, dh] and k, v fp32 [batch, nk, heads, dh], each read
// through its (batch, row, head) strides in elements (unit stride along
// dh; strides multiples of 4 elements, bases on 16 bytes),
// and lse, delta fp32 [batch, heads, nq].  dh 64, 128 or 256.  block > 0
// takes #13's windowed instance: query i meets the keys j with |i / block
// - j / block| <= halo, block a multiple of 64, halo >= 1, nq == nk;
// block 0 (#10) meets every key.
extern "C" int sfc_flash_dq_f32(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, void* dq, int batch,
                                int heads, int nq, int nk, int dh, long long qsb, long long qsn,
                                long long qsh, long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh, long long gsb,
                                long long gsn, long long gsh, float scale, int block, int halo,
                                void* stream) {
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  return run(0, q, k, v, g, lse, delta, dq, nullptr, nullptr, batch, heads, nq, nk, dh, st,
             scale, block, halo, stream);
}

// #11 in float32: dk and dv fp32 [batch, nk, heads, dh] contiguous, the
// arguments as sfc_flash_dq_f32's (block > 0: #13's windowed instance, key
// j over the queries i with |i / block - j / block| <= halo).
extern "C" int sfc_flash_dkv_f32(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int batch, int heads, int nq, int nk, int dh, long long qsb,
                                 long long qsn, long long qsh, long long ksb, long long ksn,
                                 long long ksh, long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh, float scale,
                                 int block, int halo, void* stream) {
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  return run(1, q, k, v, g, lse, delta, nullptr, dk, dv, batch, heads, nq, nk, dh, st, scale,
             block, halo, stream);
}

// Registers, local bytes and shared bytes of the dq kernel (part 0), the
// dk/dv kernel (1) or #13's windowed instances of them (2, 3) at dh (64,
// 128, 256), into out[3].
extern "C" int sfc_flash_bwd_f32_attrs(int dh, int part, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (part < 0 || part > 3) return err;
  with_subheads(dh, [&](auto C) {
    with_kernel<decltype(C)::value>(part % 2, part >= 2, [&](auto kernel, int, int bytes) {
      err = hw::kernel_attrs(kernel, bytes, out);
    });
  });
  return err;
}
