// Flash attention forward on [B, N, H, Dh] in float32 (kernel #8's fp32
// form), for Hopper: out[b, i, h] = softmax(q[b, i, h] . K[b, :, h]^T *
// scale) . V[b, :, h] for nq queries and nk keys (nq != nk allowed), head
// dim 64, 128 or 256, optionally with the fp32 log-sum-exp of every row.
// Every product is three TF32 products on wgmma (3xTF32,
// csrc/attn_f32.cuh: the big part rounded to nearest, the small part left
// to the tensor cores).
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/flash_attention.py::
// _fwd_kernel (line 114, called at :267), which takes any dtype with fp32
// logits, softmax and sums.  Its two formulas, picked by the caller from
// the key length as the TPU launcher picks them (round_up(nk, 128) <=
// 4096):
//  * single K step (SINGLE; lines 136-160): s = (q . k) * scale, the row's
//    max m and sum l over every key, then P = exp(s - m) / l (rounded to
//    nearest, sfc::div_rn) and out = P V.  A 64-row fp32 logits strip
//    over 4,096 keys (1 MB) does not fit a block, so two passes over
//    64-key tiles: the first keeps the running max and rescaled sum
//    (logits only), the second recomputes each tile's logits, forms P
//    normalised and adds P V.
//  * streaming (lines 162-218): per key tile, m' = max(m, max_tile(s)), p
//    = exp(s - m'), alpha = exp(m - m'), l = sum(p) + alpha l, acc = acc
//    alpha + p V; out = acc * (1 / l).  The tiles are 64 keys where the
//    TPU's are 1,024: in fp32 nothing is rounded to a narrower type, so the
//    width changes only the order of the fp32 sums.
// Keys at or past nk get -1e30 (p = 0, no NaN); rows at or past nq are not
// written; lse = m + log(l).  Nothing is rounded to a narrower type; only
// the order of the fp32 sums differs from the plain version
// (ops/flash_attention.py::flash_fwd_ref).
//
// The windowed instance (WINDOW, single step only) is the curve-local
// forward #12 in float32: sfc_vit_tpu/ops/local_attention.py::_kernel
// (line 82, called at :169), query i over exactly the keys j with
// |i / block - j / block| <= halo and j < n (nq == nk == n), with the
// single step's two passes over that window.  block is a multiple of 64,
// so each warpgroup's 64 queries lie in one curve block, whose window is
// the keys [max(0, (qb - halo) block), min(n, (qb + halo + 1) block))
// (ops/_build.py::local_fwd_key_range).  At Dh 256 a block walks the
// 64-key tiles of the union of its two warpgroups' windows
// (sm90.cuh::local_tile_window over 128 rows); each warpgroup gives -1e30
// to the keys outside its own window and leaves a tile wholly outside it
// out of m and l (the windows differ where a 128-query block straddles two
// curve blocks: block 64 or 192).  At Dh 64 and 128 a block of 64 queries
// walks the tiles of its own window.  lse is the window's own log-sum-exp.
//
// Bound on this card: operations, 4 Nq Nk Dh a (b, h) nominal, over
// 3xTF32's 165 TFLOP/s.  The single step executes 6 such units (its first
// pass is logits alone), the streaming form 4, at every head dim.
//
// Two designs, chosen by head dim (wide_serves): flash_fwd_f32_wide for
// #8 at Dh 128 and 256 and #12 at Dh 256; flash_fwd_f32_sm90 (below, the
// first design) for #8 at Dh 64 and #12 at Dh 64 and 128, where it measured
// faster (scripts/time_flash_f32_fwd.py): #12's walks are short (a window
// of six tiles), so the pre-pass and a one-block-an-SM prologue weigh more,
// and at Dh 64 the single step's softmax work is large beside one
// sub-head's products.
//
// flash_fwd_f32_wide.  K and V are split once in device memory by a
// pre-pass (split_kv_f32, one launch before the kernel): K into its big
// and small TF32 parts [B, Nk, H, Dh], V transposed into its parts [B, H,
// Dh, npad], each group of 8 keys in the key permutation, zeros past nk
// (npad = nk rounded up to 8), in a workspace the caller allocates
// (ops/_build.py::flash_f32_workspace: 2 (K + V) bytes, ~805 MB at [8,
// 4096, 6, 256]; the pre-pass moves 3 (K + V) bytes).  Splitting in the
// kernel instead (each warpgroup half of every sub-block into one of two
// shared pairs, or all of it into pairs of its own) measured no faster
// than the first design: the split and the waits for the other
// warpgroup's half held the warpgroups in step.  A block is two
// warpgroups (256 threads, one block an SM, no producer warp) over 128
// queries of one (b, h), 64 each; each warpgroup keeps its rows' m, l and
// O whole in registers (32 C fp32 a thread, C = Dh / 64 sub-heads, from
// zero), so both forms walk the keys once (the single step twice: m and
// l, then P V) and O is stored once.  q is read through its (batch, row,
// head) strides (sm90.cuh::map_strided_heads: contiguous, or a view of a
// packed projection), a head as C sub-heads of 64 columns.  Q's 128 rows
// stay resident, raw, for the whole walk (32 C KB); a product's A
// fragments are read from them and split in registers.  The split parts
// come as ready 64 x 64 big/small pairs, in the walk's order (per key
// tile: K_c of each sub-head, then V_c), through a TMA ring: each slot is
// brought once a tile for the block, read by both warpgroups as it
// landed, and freed through its own empty barrier once every warp's
// products on it are done.  The first thread of either warpgroup refills
// the ring after its products issue, claiming each entry by an atomic,
// and loads an entry its warpgroup is about to take if no thread has
// (waiting for its slot then).  The warpgroups share nothing else, so one
// may run up to the ring's depth ahead of the other and their products
// interleave on the tensor cores.  An operation is one m64n64 product over
// the 64-deep contraction, its A fragments split before its 3 x 8 wgmma
// issue as one group (at Dh 256, and for the single step's logits at Dh
// 128, two groups of 4 k8 steps, the second's fragments loaded once the
// first is done).  The logits accumulate over the C sub-heads in one
// accumulator and are read scaled and masked on the fly (written back
// between products, ptxas serialized them: C7515); the single step's
// first pass alternates two by tile, so each tile's max and sum run under
// the next tile's first products.  exp is ex2.approx of x log2(e) (~2^-22
// relative).  P is split once for the tile's C P V products (at Dh 256
// each thread keeps its P in shared memory and reads it back 4 k8 steps
// at a time: O's 128 registers leave no room for P's 64); each P V product
// is taken fresh into the logits' registers and added to O_c in fp32
// registers before the next (o alpha + part in the streaming form):
// accumulated across a long row's tiles in the wgmma accumulator, the
// streaming output drifted 1.2e-4 of its largest |value| from the plain
// version at 8,300 keys on the H100.  A ring wait is left by a warp's
// lanes together (__all_sync: a divergent wait between products made
// ptxas serialize them in the fp32 backward).  Shared memory: Q, then a
// ring of 32 KB pairs in what is left of 224 KB (five at Dh 128); at Dh
// 256 Q 128 KB, P 32 KB and two pairs (224 KB of the 227).
#include <type_traits>

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
namespace af = sfc::attn_f32;

constexpr int BM = 64;         // keys a tile, queries a warpgroup
constexpr int BQ = 128;        // queries a block
constexpr int kThreads = 256;  // two warpgroups

// The ring's slots, each a 64 x 64 sub-block's big and small tiles (32
// KB): what 224 KB leaves beside Q (32 C KB), and at Dh 256 beside P's
// 32 KB too.
__host__ __device__ constexpr int ring_slots(int C) { return C == 4 ? 2 : (224 - 32 * C) / 32; }

// Each thread's 32 values of P (fp32, 4,096 bytes a thread's column), at
// Dh 256 only.
template <bool kOn>
struct PSpill {
  float v[2][32][128];  // [warpgroup][element][thread]
};
template <>
struct PSpill<false> {};

// Every tile on 1,024 bytes (the struct starts there and each tile is a
// multiple of 1,024).
template <int C>
struct Smem {
  unsigned char q[2][C][af::kSub];                  // [warpgroup][sub-head]
  unsigned char ring[ring_slots(C)][2][af::kSub];   // [slot][big, small]
  PSpill<C == 4> p;
  uint64_t q_full, full[ring_slots(C)], empty[ring_slots(C)];
  int issued;  // the ring's next entry to load
};
template <int C>
constexpr int kSmemBytes = sizeof(Smem<C>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap q;       // map_strided_heads over q [B, nq, H, Dh], 64-row boxes
  CUtensorMap kb, ks;  // K's big and small parts [B, nk, H, Dh], the same boxes
  CUtensorMap vb, vs;  // V's, transposed: [B, H, Dh, npad], 32 keys x 64 rows
  CUtensorMap k, v;    // flash_fwd_f32_sm90's raw k and v, as q
  float* out;          // [B, nq, H, Dh] contiguous
  float* lse;          // [B, H, nq] or null
  int heads, dh, nq, nk;
  int block, halo;  // the windowed instance's curve block and halo
  float scale;
};

// Whether flash_fwd_f32_wide (after the pre-pass) serves sub-heads C, and
// the windowed instance: Dh 128 and 256, #12 at Dh 256 only; elsewhere
// flash_fwd_f32_sm90, faster there (ops/_build.py::flash_f32_prepass, the
// same rule).
__host__ __device__ constexpr bool wide_serves(int C, bool window) {
  return C == 4 || (C == 2 && !window);
}

// The keys of a row of V's transposed parts: nk rounded up to whole
// groups of 8 (the key permutation's groups), zeros past nk.
__host__ __device__ constexpr int key_pad(int nk) { return (nk + 7) / 8 * 8; }

// The pre-pass: K and V split once for every block that reads them.  A
// block of 256 threads takes keys 64 T .. 64 T + 63 of sub-head c of one
// (b, h): K's big and small parts elementwise into kb, ks ([B, nk, H, Dh]
// contiguous), and V's transposed into vb, vs ([B, H, Dh, npad]: row d
// holds column d of V, its keys in the key permutation of
// csrc/attn_f32.cuh within each group of 8, key 8 g + p at 8 g + 4 (p % 2)
// + p / 2), staged through shared memory; keys past nk zero.
__global__ void __launch_bounds__(256)
    split_kv_f32(const float* __restrict__ k, const float* __restrict__ v, float* kb, float* ks,
                 float* vb, float* vs, int heads, int nk, int dh, long long ksb, long long ksn,
                 long long ksh, long long vsb, long long vsn, long long vsh) {
  __shared__ float sv[64][65];
  const int tid = threadIdx.x, bh = blockIdx.z, b = bh / heads, h = bh % heads;
  const int key0 = 64 * blockIdx.x, col0 = 64 * blockIdx.y, npad = key_pad(nk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 256 * i, row = idx / 16, c4 = 4 * (idx % 16), key = key0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (key < nk) {
      x = *reinterpret_cast<const float4*>(k + b * ksb + key * ksn + h * ksh + col0 + c4);
      y = *reinterpret_cast<const float4*>(v + b * vsb + key * vsn + h * vsh + col0 + c4);
      uint4 hi, lo;
      hw::tf32_split(x.x, hi.x, lo.x);
      hw::tf32_split(x.y, hi.y, lo.y);
      hw::tf32_split(x.z, hi.z, lo.z);
      hw::tf32_split(x.w, hi.w, lo.w);
      const long long o = (static_cast<long long>(b) * nk + key) * heads * dh +
                          static_cast<long long>(h) * dh + col0 + c4;
      *reinterpret_cast<uint4*>(kb + o) = hi;
      *reinterpret_cast<uint4*>(ks + o) = lo;
    }
    sv[row][c4] = y.x;
    sv[row][c4 + 1] = y.y;
    sv[row][c4 + 2] = y.z;
    sv[row][c4 + 3] = y.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // Row d, logical keys 4 q .. 4 q + 3: keys 8 (q / 2) + q % 2 + 2 x.
    const int idx = tid + 256 * i, d = idx / 16, q = idx % 16;
    if (key0 + 4 * q >= npad) continue;
    uint4 hi, lo;
    const int r = 8 * (q / 2) + q % 2;
    hw::tf32_split(sv[r][d], hi.x, lo.x);
    hw::tf32_split(sv[r + 2][d], hi.y, lo.y);
    hw::tf32_split(sv[r + 4][d], hi.z, lo.z);
    hw::tf32_split(sv[r + 6][d], hi.w, lo.w);
    const long long o = (static_cast<long long>(bh) * dh + col0 + d) * npad + key0 + 4 * q;
    *reinterpret_cast<uint4*>(vb + o) = hi;
    *reinterpret_cast<uint4*>(vs + o) = lo;
  }
}

// ------------------------------------------- one warpgroup over 64 queries

namespace narrow {

using Smem = af::Smem<4>;  // a ring of four raw 64 x 64 sub-blocks
constexpr int kStages = 4;
constexpr int kSmemBytes = af::kSmemBytes<kStages>;

// Ring entry e of a block: which tensor (0 Q, 1 K, 2 V), its sub-head and
// key tile.  The single step's first pass: per key tile and sub-head Q
// then K.  Then (the single step's second pass, or the streaming form's
// only one), per key tile: per sub-head Q then K, then V of each sub-head.
template <int C, bool SINGLE>
__device__ __forceinline__ void entry_of(int e, int k_tiles, int& which, int& c, int& t) {
  constexpr int per = 3 * C;
  if (SINGLE && e < 2 * C * k_tiles) {
    t = e / (2 * C);
    c = (e % (2 * C)) >> 1;
    which = e & 1;
    return;
  }
  if (SINGLE) e -= 2 * C * k_tiles;
  const int r = e % per;
  t = e / per;
  c = r < 2 * C ? r >> 1 : r - 2 * C;
  which = r < 2 * C ? (r & 1) : 2;
}

}  // namespace narrow

// The first design, kept where it is faster (Dh 64; #12 at Dh 128): a
// block is one warpgroup over 64 queries of a (b, h), two blocks an SM,
// over raw q, k and v (no pre-pass).  Thread 0 keeps a ring of four 64 x
// 64 sub-blocks in flight by TMA, refilling each slot after the barrier
// that follows its last use; per key tile and sub-head Q's sub-block (the
// A operand, read into registers a k8 step at a time) and K's (split into
// the block's one big/small pair by the threads, a barrier after), then
// each V sub-block split transposed; O whole in registers (C = 1, 2), each
// tile's P V fresh and added to it in fp32.  C: sub-heads (1 or 2);
// SINGLE, WINDOW as flash_fwd_f32_wide's.
template <int C, bool SINGLE, bool WINDOW>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_fwd_f32_sm90(const __grid_constant__ Params p) {
  static_assert(C <= 2 && (SINGLE || !WINDOW), "one walk holds O at Dh 64 and 128");
  using narrow::kStages;
  extern __shared__ __align__(1024) unsigned char dyn[];
  narrow::Smem& sm = hw::aligned_smem<narrow::Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4, c0 = 2 * tq;
  const int heads = p.heads, nq = p.nq, nk = p.nk;
  const int q_tiles = (nq + BM - 1) / BM;
  const int qt = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % heads, b = bh / heads, q0 = qt * BM;
  // The key tiles [t0, t0 + k_tiles) the block walks: every one, or its
  // curve-local window (block a multiple of 64: the 64 queries lie in one
  // curve block, whose window is whole tiles).
  int t0 = 0, k_tiles = (nk + BM - 1) / BM;
  if constexpr (WINDOW) {
    int hi;
    hw::local_tile_window(qt, BM, nk, p.block, p.halo, t0, hi);
    k_tiles = hi - t0;
  }
  const int entries = ((SINGLE ? 2 * C : 0) + 3 * C) * k_tiles;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  // Thread 0 issues the ring's entries in order; `upto`: every entry
  // before it may take a slot (the slot's last entry is consumed).
  int issued = 0;
  auto feed = [&](int upto) SFC_INLINE_LAMBDA {
    for (; issued < upto && issued < entries; ++issued) {
      int which, c, t;
      narrow::entry_of<C, SINGLE>(issued, k_tiles, which, c, t);
      const CUtensorMap* map = which == 0 ? &p.q : which == 1 ? &p.k : &p.v;
      af::load_sub(sm, issued % kStages, map, h, c, which == 0 ? q0 : (t0 + t) * BM, b);
    }
  };
  if (tid == 0) feed(kStages);

  uint64_t db, dsm;
  af::pair_desc(sm, db, dsm);
  uint32_t fb[2][4], fs[2][4];  // two k8 steps' split A fragments
  int e = 0;                    // the next ring entry
  // Entry eb (a B operand, K or V) split into the pair, plainly or
  // transposed: the pair's last product is done first; after the barrier
  // the slots of the entries before `used` are free.
  auto take_b = [&](int eb, int used, bool transposed) SFC_INLINE_LAMBDA {
    af::split_entry(sm, eb, transposed);
    if (tid == 0) feed(used + kStages);
  };
  // acc (+)= Q_c K_t,c^T for the next pair of entries, Q then K; Q's slot
  // is read a k8 step at a time under the products.
  auto logits = [&](float (&acc)[32], int accumulate) SFC_INLINE_LAMBDA {
    af::wait_entry(sm, e);
    take_b(e + 1, e, false);
    const unsigned char* qs = sm.ring[e % kStages];
    af::mma3<64, 8>(
        acc, db, dsm,
        [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA {
          af::a_frag(qs, decltype(kk)::value, v);
        },
        fb, fs, accumulate);
    e += 2;
  };
  auto quad_max = [](float v) SFC_INLINE_LAMBDA {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) SFC_INLINE_LAMBDA {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  const float scale = p.scale;
  float s[32], o[C][32], m[2], l[2];
  // Key tile t's logits into s, scaled, keys at or past nk at -1e30; every
  // product issued before is done after it.
  auto tile_logits = [&](int t) SFC_INLINE_LAMBDA {
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA { logits(s, decltype(Cc)::value > 0); });
    af::drain(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = BM * (t0 + t) + 8 * (i / 4) + c0 + (i % 2);
      s[i] = key < nk ? __fmul_rn(s[i], scale) : sfc::kNegInf;
    }
  };
  // The row maxima of s (rows r0 and r0 + 8) over the quad.
  auto tile_max = [&](int hf) SFC_INLINE_LAMBDA {
    float mx = sfc::kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
    return quad_max(mx);
  };
  // O_c (+)= P V_t,c for every sub-head, V_t,c the next entries (split
  // transposed), P the A operand straight from the logits' registers (the
  // key permutation): each tile's product taken fresh into `part`, then o
  // = o alpha + part in fp32 registers (alpha 1 in the single step).
  float part[32];
  auto pv_add = [&](int t, const float (&alpha)[2]) SFC_INLINE_LAMBDA {
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      float(&oc)[32] = o[decltype(Cc)::value];
      take_b(e, e + 1, true);
      af::mma3<64, 8>(
          part, db, dsm,
          [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA {
            af::a_perm(s, decltype(kk)::value, v);
          },
          fb, fs, 0);
      ++e;
      af::drain(part);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        oc[i] = t > 0 ? __fmaf_rn(oc[i], alpha[(i / 2) % 2], part[i]) : part[i];
    });
  };
  // A streaming walk's tile: p = exp(s - m') in s, l and m moved on; alpha.
  auto online = [&](float (&alpha)[2], bool keep_p) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], tile_max(hf));
      alpha[hf] = expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& v = s[4 * j + 2 * hf + x];
          const float pe = expf(__fsub_rn(v, m_new));
          if (keep_p) v = pe;
          sum += pe;
        }
      l[hf] = quad_sum(sum) + alpha[hf] * l[hf];
      m[hf] = m_new;
    }
  };

  m[0] = m[1] = sfc::kNegInf;
  l[0] = l[1] = 0.f;
  if constexpr (SINGLE) {
    // First pass: the running max and the rescaled sum of every row.
    for (int t = 0; t < k_tiles; ++t) {
      tile_logits(t);
      float alpha[2];
      online(alpha, false);
    }
    // Second pass: P = exp(s - m) / l, then O += P V.
    float rl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) rl[hf] = __frcp_rn(l[hf]);
    const float one[2] = {1.f, 1.f};
    for (int t = 0; t < k_tiles; ++t) {
      tile_logits(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = (i / 2) % 2;
        s[i] = sfc::div_rn(expf(__fsub_rn(s[i], m[hf])), l[hf], rl[hf]);
      }
      pv_add(t, one);
    }
  } else {
    // Streaming: O rescaled by alpha each tile, divided by l at the end.
    for (int t = 0; t < k_tiles; ++t) {
      tile_logits(t);
      float alpha[2];
      online(alpha, true);
      pv_add(t, alpha);
    }
  }
  // O out, rows r0 and r0 + 8 below nq; the streaming form's acc times 1 / l.
  const size_t row_w = static_cast<size_t>(heads) * p.dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + 8 * hf;
    if (row >= nq) continue;
    const float inv = SINGLE ? 1.f : __frcp_rn(l[hf]);
    float* dst = p.out + (static_cast<size_t>(b) * nq + row) * row_w +
                 static_cast<size_t>(h) * p.dh + c0;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * j) =
            make_float2(o[c][4 * j + 2 * hf] * inv, o[c][4 * j + 2 * hf + 1] * inv);
  }
  if (p.lse != nullptr && tq == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row < nq) p.lse[static_cast<size_t>(bh) * nq + row] = m[hf] + logf(l[hf]);
    }
  }
}

// C: 64-column sub-heads a head (1, 2 or 4).  SINGLE: the single K step's
// two passes (P normalised before P V), else the streaming form.  WINDOW
// (#12, SINGLE only): over the key tiles of the block's curve-local
// windows.  See the head of the file for the walk.
template <int C, bool SINGLE, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_wide(const __grid_constant__ Params p) {
  static_assert(SINGLE || !WINDOW, "the windowed instance is the single step's");
  constexpr int NS = ring_slots(C);
  // The k8 steps of A loaded and split a group, and where P waits for
  // P V: at Dh 256, where O is 128 registers a thread, 4 and P in shared
  // memory (each thread its own values, read back 4 k8 steps at a time);
  // else P split in registers once for the tile's C products, and Q's 8
  // steps a group (4 in the single step at Dh 128, measured faster).
  constexpr int kSteps = C == 4 || (C == 2 && SINGLE) ? 4 : 8;
  constexpr bool kPSmem = C == 4;
  using Sm = Smem<C>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Sm& sm = hw::aligned_smem<Sm>(dyn);
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), c0 = 2 * (lane & 3);
  const int heads = p.heads, nq = p.nq, nk = p.nk;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = BQ * blockIdx.x, row0 = q0 + 64 * w;
  // The key tiles [t0, t1) the block walks: every one, or the union of its
  // two warpgroups' curve-local windows.
  int t0 = 0, t1 = (nk + BM - 1) / BM;
  if constexpr (WINDOW) hw::local_tile_window(q0 / BM, BQ, nk, p.block, p.halo, t0, t1);
  const int tiles = t1 - t0;
  // The ring's entries, in the order both warpgroups take them: the single
  // step's first pass (K_c of every tile), then per tile K_c and V_c.
  const int first = SINGLE ? C * tiles : 0, total = first + 2 * C * tiles;
  // A second warpgroup wholly past nq computes on the rows of the first
  // (its Q is not loaded) and stores nothing.
  const int groups = q0 + 64 < nq ? 2 : 1;

  // Entry e into its slot: the big and small parts of K or V^T for
  // sub-head c, key tile t.
  auto load = [&](int e) SFC_INLINE_LAMBDA {
    int t, c;
    bool is_v = false;
    if (SINGLE && e < first) {
      t = e / C;
      c = e % C;
    } else {
      const int i = e - first, r = i % (2 * C);
      t = i / (2 * C);
      is_v = r >= C;
      c = r % C;
    }
    const int slot = e % NS, key = BM * (t0 + t);
    uint64_t* bar = &sm.full[slot];
    hw::bar_expect_tx(bar, 2 * af::kSub);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      unsigned char* dst = sm.ring[slot][x];
      if (is_v) {
        const CUtensorMap* m = x ? &p.vs : &p.vb;
        hw::tma_load4(dst, m, bar, key, h, 64 * c, b);
        hw::tma_load4(dst + af::kHalf, m, bar, key + 32, h, 64 * c, b);
      } else {
        const CUtensorMap* m = x ? &p.ks : &p.kb;
        hw::tma_load4(dst, m, bar, 64 * c, h, key, b);
        hw::tma_load4(dst + af::kHalf, m, bar, 64 * c + 32, h, key, b);
      }
    }
  };
  // One thread (either warpgroup's first): load the ring's entries in
  // order from the next one not loaded, claiming each by an atomic.  It
  // waits for a slot to be freed only for entries up to `need` (the one
  // its warpgroup is about to take), and past that loads while slots are
  // free (need -1, after a warpgroup's products issue: only those).
  auto feed = [&](int need) SFC_INLINE_LAMBDA {
    for (int e = *reinterpret_cast<volatile int*>(&sm.issued); e < total;) {
      const int slot = e % NS, k = e / NS;
      if (k > 0) {
        if (e <= need) hw::bar_wait(&sm.empty[slot], (k - 1) & 1);
        else if (!hw::bar_test(&sm.empty[slot], (k - 1) & 1)) break;
      }
      const int got = atomicCAS(&sm.issued, e, e + 1);
      if (got != e) {
        e = got;
        continue;
      }
      load(e);
      ++e;
    }
  };

  if (tid == 0) {
    hw::bar_init(&sm.q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], 8);  // every warp, once its products on it are done
    }
    sm.issued = 0;
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hw::bar_expect_tx(&sm.q_full, groups * C * af::kSub);
    for (int g = 0; g < groups; ++g)
      for (int c = 0; c < C; ++c) {
        hw::tma_load4(sm.q[g][c], &p.q, &sm.q_full, 64 * c, h, q0 + 64 * g, b);
        hw::tma_load4(sm.q[g][c] + af::kHalf, &p.q, &sm.q_full, 64 * c + 32, h, q0 + 64 * g, b);
      }
    feed(-1);
  }

  // The keys [klo, khi) this warpgroup's rows see: every key below nk, or
  // the window of their curve block (block a multiple of 64: one block).
  int klo = 0, khi = nk;
  if constexpr (WINDOW) {
    const int qb = min(row0, nq - 1) / p.block;
    klo = max(0, (qb - p.halo) * p.block);
    khi = min(nk, (qb + p.halo + 1) * p.block);
  }
  const int qw = row0 < nq ? w : 0;  // the Q rows this warpgroup reads

  // O whole (C sub-heads), the logits s (each P V product fresh in s, dead
  // once P is in fragments or shared memory; the single step's first pass
  // alternates s and s2 by tile), the rows' m and l.
  float o[C][32], s[32], s2[SINGLE ? 32 : 1], m[2], l[2];
  float alpha[2] = {1.f, 1.f}, rl[2] = {1.f, 1.f};
  // Split A fragments: kSteps k8 steps of Q, or P's 8 (at Dh 256 kSteps of
  // them).  (Sized to what is used: a fence on a register keeps it.)
  uint32_t fb[kPSmem ? kSteps : 8][4], fs[kPSmem ? kSteps : 8][4];
  m[0] = m[1] = sfc::kNegInf;
  l[0] = l[1] = 0.f;
  // (Zeros, not the first tile's product: a select between the two kept
  // both O's beside each other and spilled at Dh 256.)
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // A ring wait whose loop every lane of a warp leaves together; a phase
  // that never completes traps rather than hanging the card.
  auto wait_all = [&](uint64_t* bar, uint32_t parity) SFC_INLINE_LAMBDA {
    for (uint32_t polls = 0; !__all_sync(0xffffffffu, hw::bar_test(bar, parity));)
      if (++polls == (1u << 30)) __trap();
  };
  // Every product this warp issued is done (acc: the accumulator they
  // wrote).
  auto drain = [&](float (&acc)[32]) SFC_INLINE_LAMBDA {
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_frags(fb);
    hw::fence_frags(fs);
  };
  // Before operation j: operation j - 1's products (into acc) are done,
  // and each warp frees its entry.
  auto retire = [&](int j, float (&acc)[32]) SFC_INLINE_LAMBDA {
    drain(acc);
    if (j >= 1 && lane == 0) hw::bar_arrive(&sm.empty[(j - 1) % NS]);
  };
  // Entry j's pair, once landed, as the big and small descriptors (loaded
  // first if no thread has yet).
  auto take = [&](int j, uint64_t& db, uint64_t& dsm) SFC_INLINE_LAMBDA {
    if (wt == 0 && *reinterpret_cast<volatile int*>(&sm.issued) <= j) feed(j);
    wait_all(&sm.full[j % NS], (j / NS) & 1);
    db = hw::desc_sw128(sm.ring[j % NS][0]);
    dsm = hw::desc_sw128(sm.ring[j % NS][1]);
  };
  // acc (+)= A B over k8 steps K0 .. K0 + N - 1 (A's fragments in fb / fs
  // from index 0; B the pair at db / dsm), as one group.
  auto issue = [&](float (&acc)[32], uint64_t db, uint64_t dsm, int accumulate, auto K0, auto N)
                   SFC_INLINE_LAMBDA {
    hw::fence_frags(fb);
    hw::fence_frags(fs);
    hw::fence_regs(acc);
    hw::wgmma_fence();
    sfc::static_for<decltype(N)::value>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value, off = af::step_off(decltype(K0)::value + kk);
      hw::wgmma_tf32_rs_n64_at<off>(acc, fb[kk], dsm, kk == 0 ? accumulate : 1);
      hw::wgmma_tf32_rs_n64_at<off>(acc, fs[kk], db, 1);
      hw::wgmma_tf32_rs_n64_at<off>(acc, fb[kk], db, 1);
    });
    hw::wgmma_commit();
  };
  using I0 = std::integral_constant<int, 0>;
  using NB = std::integral_constant<int, kSteps>;
  // A's values of k8 steps K0 .. K0 + kSteps - 1 split into fb / fs from
  // index 0: Q_c of this warpgroup's rows, or P (under the key
  // permutation) from s or from its copy in shared memory.
  auto q_frags = [&](int c, auto K0) SFC_INLINE_LAMBDA {
    const unsigned char* qs = sm.q[qw][c];
    sfc::static_for<kSteps>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value;
      float v[4];
      af::a_frag_wg(qs, decltype(K0)::value + kk, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) hw::tf32_split(v[e], fb[kk][e], fs[kk][e]);
    });
  };
  auto p_frags = [&](auto K0) SFC_INLINE_LAMBDA {
    sfc::static_for<kPSmem ? kSteps : 8>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value, g = decltype(K0)::value + kk;
      float v[4];
      if constexpr (kPSmem) {
        const float* ps = &sm.p.v[w][0][hw::fresh_tid() & 127];
        v[0] = ps[128 * (4 * g)];
        v[1] = ps[128 * (4 * g + 2)];
        v[2] = ps[128 * (4 * g + 1)];
        v[3] = ps[128 * (4 * g + 3)];
      } else {
        af::a_perm(s, g, v);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) hw::tf32_split(v[e], fb[kk][e], fs[kk][e]);
    });
  };
  auto quad_max = [](float v) SFC_INLINE_LAMBDA {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) SFC_INLINE_LAMBDA {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };
  const float scale = p.scale;
  // exp(x) as 2^(x log2 e) by ex2.approx (~2^-22 relative), one
  // instruction where expf's range reduction is several a value.
  auto ex = [](float x) SFC_INLINE_LAMBDA { return hw::exp2_approx(__fmul_rn(x, hw::kLog2e)); };
  // Element i of key tile t's logits in d, scaled; -1e30 for a key
  // outside [klo, khi).  (Read, not written back: the logits stay wgmma's
  // alone until P replaces them.)
  auto logit = [&](const float (&d)[32], int t, int i) SFC_INLINE_LAMBDA {
    const int key = BM * (t0 + t) + 8 * (i / 4) + c0 + (i % 2);
    return key >= klo && key < khi ? __fmul_rn(d[i], scale) : sfc::kNegInf;
  };
  // Tile t's m and l moved on by its logits in d (rows r0 and r0 + 8);
  // with keep_p, p = exp(s - m') into d.
  auto online = [&](float (&d)[32], int t, bool keep_p) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = sfc::kNegInf;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        mx = fmaxf(mx, fmaxf(logit(d, t, 4 * x + 2 * hf), logit(d, t, 4 * x + 2 * hf + 1)));
      const float m_new = fmaxf(m[hf], quad_max(mx));
      alpha[hf] = ex(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int i = 4 * x + 2 * hf + y;
          const float pe = ex(__fsub_rn(logit(d, t, i), m_new));
          if (keep_p) d[i] = pe;
          sum += pe;
        }
      l[hf] = quad_sum(sum) + alpha[hf] * l[hf];
      m[hf] = m_new;
    }
  };
  // The single step's first pass over tile t (logits in d): m and l,
  // unless the tile lies wholly outside this warpgroup's window (all
  // -1e30: a first such tile would set m to -1e30).
  auto stats = [&](float (&d)[32], int t) SFC_INLINE_LAMBDA {
    const int key0 = BM * (t0 + t);
    if (!WINDOW || (key0 + BM > klo && key0 < khi)) online(d, t, false);
  };
  // O_c (+)= the fresh P V product in s (o alpha + part in the streaming
  // form; O starts at zero and the first tile's alpha is 0).
  auto add_pv = [&](auto Cc) SFC_INLINE_LAMBDA {
    float(&oc)[32] = o[decltype(Cc)::value];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      oc[i] = SINGLE ? __fadd_rn(oc[i], s[i]) : __fmaf_rn(oc[i], alpha[(i / 2) % 2], s[i]);
  };
  // Operation j: acc (+)= Q_c K_t,c^T (logits, the first of a tile
  // overwriting acc), or s = P V_t,c (fresh), A's fragments kSteps k8
  // steps a group (each group's after the one before is done: they share
  // fb / fs); the ring refilled once the first group is issued.
  auto logits = [&](int j, float (&acc)[32], int c) SFC_INLINE_LAMBDA {
    uint64_t db, dsm;
    q_frags(c, I0{});
    take(j, db, dsm);
    sfc::static_for<8 / kSteps>([&](auto B) SFC_INLINE_LAMBDA {
      using K0 = std::integral_constant<int, decltype(B)::value * kSteps>;
      if constexpr (K0::value > 0) {
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        hw::fence_frags(fb);
        hw::fence_frags(fs);
        q_frags(c, K0{});
      }
      issue(acc, db, dsm, K0::value > 0 || c > 0, K0{}, NB{});
      if constexpr (K0::value == 0) {
        if (wt == 0) feed(-1);
      }
    });
  };
  auto pv = [&](int j) SFC_INLINE_LAMBDA {
    uint64_t db, dsm;
    if constexpr (kPSmem) {
      p_frags(I0{});
      take(j, db, dsm);
      sfc::static_for<8 / kSteps>([&](auto B) SFC_INLINE_LAMBDA {
        using K0 = std::integral_constant<int, decltype(B)::value * kSteps>;
        if constexpr (K0::value > 0) {
          hw::wgmma_wait<0>();
          hw::fence_regs(s);
          hw::fence_frags(fb);
          hw::fence_frags(fs);
          p_frags(K0{});
        }
        issue(s, db, dsm, K0::value > 0, K0{}, NB{});
        if constexpr (K0::value == 0) {
          if (wt == 0) feed(-1);
        }
      });
    } else {  // P's 8 k8 steps in hand
      take(j, db, dsm);
      issue(s, db, dsm, 0, I0{}, std::integral_constant<int, 8>{});
      if (wt == 0) feed(-1);
    }
  };

  hw::bar_wait(&sm.q_full, 0);
  int j = 0;  // the next operation
  if constexpr (SINGLE) {
    // First pass: the running max and the rescaled sum of every row, each
    // tile's stats taken while the next tile's first products run (the
    // logits in s and s2 by tile).
    auto tile1 = [&](int t, float (&cur)[32], float (&prev)[32]) SFC_INLINE_LAMBDA {
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        constexpr int c = decltype(Cc)::value;
        retire(j, c > 0 ? cur : prev);
        logits(j++, cur, c);
        if (c == 0 && t > 0) stats(prev, t - 1);
      });
    };
#pragma unroll 1
    for (int t = 0; t < tiles; t += 2) {
      tile1(t, s, s2);
      if (t + 1 < tiles) tile1(t + 1, s2, s);
    }
    if ((tiles - 1) & 1) {
      drain(s2);
      stats(s2, tiles - 1);
    } else {
      drain(s);
      stats(s, tiles - 1);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) rl[hf] = hw::rcp_rn(l[hf]);
  }
  // The walk with P V: per key tile the logits over the C sub-heads, then
  // P (the single step's exp(s - m) / l, the streaming form's p against
  // the running max) and P V_c for each sub-head.
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value;
      retire(j, s);
      if (c == 0 && t > 0) add_pv(std::integral_constant<int, C - 1>{});
      logits(j++, s, c);
    });
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value;
      retire(j, s);
      if constexpr (c == 0) {
        if constexpr (SINGLE) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int hf = (i / 2) % 2;
            s[i] = sfc::div_rn(ex(__fsub_rn(logit(s, t, i), m[hf])), l[hf], rl[hf]);
          }
        } else {
          online(s, t, true);
        }
        if constexpr (kPSmem) {
          float* ps = &sm.p.v[w][0][hw::fresh_tid() & 127];
#pragma unroll
          for (int i = 0; i < 32; ++i) ps[128 * i] = s[i];
        } else {
          p_frags(I0{});
        }
      } else {
        add_pv(std::integral_constant<int, c - 1>{});
      }
      pv(j++);
    });
  }
  retire(j, s);
  add_pv(std::integral_constant<int, C - 1>{});

  // Rows r0 and r0 + 8 of this warpgroup's 64, every sub-head, once; the
  // streaming form's acc times 1 / l.
  const int dh = p.dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= nq) continue;
    const float inv = SINGLE ? 1.f : hw::rcp_rn(l[hf]);
    float* dst = p.out + (static_cast<long long>(b) * nq + row) * heads * dh +
                 static_cast<long long>(h) * dh + c0;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(dst + 64 * c + 8 * jj) =
            make_float2(o[c][4 * jj + 2 * hf] * inv, o[c][4 * jj + 2 * hf + 1] * inv);
  }
  // (logf after O's stores, where O's registers are free.)
  asm volatile("" : "+f"(l[0]), "+f"(l[1])::"memory");
  if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + r0 + 8 * hf;
      if (row < nq) p.lse[static_cast<long long>(bh) * nq + row] = m[hf] + logf(l[hf]);
    }
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

template <int C, bool SINGLE, bool WINDOW = false>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (wide_serves(C, WINDOW)) {
    auto kernel = flash_fwd_f32_wide<C, SINGLE, WINDOW>;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<C>);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((p.nq + BQ - 1) / BQ, batch * p.heads), kThreads, kSmemBytes<C>, stream>>>(p);
  } else {
    auto kernel = flash_fwd_f32_sm90<C, SINGLE, WINDOW>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, narrow::kSmemBytes);
    if (e != cudaSuccess) return e;
    kernel<<<batch * p.heads * ((p.nq + BM - 1) / BM), af::kThreads, narrow::kSmemBytes,
             stream>>>(p);
  }
  return cudaGetLastError();
}

// K's and V's parts in a call's workspace (the Python
// flash_f32_workspace's layout): kb, ks [B, nk, H, Dh], then vb, vs
// [B, H, Dh, key_pad(nk)], fp32.
struct Parts {
  float *kb, *ks, *vb, *vs;
};
Parts parts_of(void* ws, int batch, int heads, int nk, int dh) {
  const long long nkv = static_cast<long long>(batch) * nk * heads * dh;
  const long long nvt = static_cast<long long>(batch) * heads * dh * key_pad(nk);
  float* f = static_cast<float*>(ws);
  return Parts{f, f + nkv, f + 2 * nkv, f + 2 * nkv + nvt};
}

// The pre-pass over k and v (through their strides) into the parts.
cudaError_t split(const void* k, const void* v, const Parts& w, int batch, int heads, int nk,
                  int dh, long long ksb, long long ksn, long long ksh, long long vsb,
                  long long vsn, long long vsh, cudaStream_t stream) {
  const dim3 grid((nk + 63) / 64, dh / 64, batch * heads);
  split_kv_f32<<<grid, 256, 0, stream>>>(static_cast<const float*>(k),
                                         static_cast<const float*>(v), w.kb, w.ks, w.vb, w.vs,
                                         heads, nk, dh, ksb, ksn, ksh, vsb, vsn, vsh);
  return cudaGetLastError();
}

// The maps and sizes of a call: q through its strides; for
// flash_fwd_f32_wide K's and V's parts in the workspace, filled by the
// pre-pass here, else k and v through their strides.
cudaError_t plan(Params& p, bool wide, const void* q, const void* k, const void* v, void* out,
                 void* lse, void* ws, int batch, int heads, int nq, int nk, int dh,
                 long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                 long long ksh, long long vsb, long long vsn, long long vsh, float scale,
                 cudaStream_t stream) {
  if (dh != 64 && dh != 128 && dh != 256) return cudaErrorInvalidValue;
  cudaError_t e = hw::map_strided_heads(&p.q, q, true, batch, nq, heads, dh, qsb, qsn, qsh, BM);
  if (wide) {
    const Parts w = parts_of(ws, batch, heads, nk, dh);
    const long long row = static_cast<long long>(heads) * dh, npad = key_pad(nk);
    float* const kparts[2] = {w.kb, w.ks};
    float* const vparts[2] = {w.vb, w.vs};
    CUtensorMap* const kmaps[2] = {&p.kb, &p.ks};
    CUtensorMap* const vmaps[2] = {&p.vb, &p.vs};
    for (int x = 0; x < 2 && e == cudaSuccess; ++x) {
      e = hw::map_strided_heads(kmaps[x], kparts[x], true, batch, nk, heads, dh, nk * row, row,
                                dh, BM);
      if (e == cudaSuccess)
        e = hw::map_strided_heads(vmaps[x], vparts[x], true, batch, dh, heads, npad,
                                  row * npad, npad, dh * npad, 64);
    }
    if (e == cudaSuccess)
      e = split(k, v, w, batch, heads, nk, dh, ksb, ksn, ksh, vsb, vsn, vsh, stream);
  } else {
    if (e == cudaSuccess)
      e = hw::map_strided_heads(&p.k, k, true, batch, nk, heads, dh, ksb, ksn, ksh, BM);
    if (e == cudaSuccess)
      e = hw::map_strided_heads(&p.v, v, true, batch, nk, heads, dh, vsb, vsn, vsh, BM);
  }
  if (e != cudaSuccess) return e;
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.dh = dh;
  p.nq = nq;
  p.nk = nk;
  p.scale = scale;
  return cudaSuccess;
}

}  // namespace

// #8 in float32: q, k, v fp32 [batch, n, heads, dh] read through their
// (batch, row, head) strides in elements (unit stride along dh; strides
// multiples of 4 elements, bases on 16 bytes); out fp32
// [batch, nq, heads, dh] contiguous; lse fp32 [batch, heads, nq] or null;
// ws fp32, where flash_fwd_f32_wide serves dh (128, 256) the workspace of
// K's and V's parts (the Python flash_f32_workspace(batch, nk, heads, dh)
// floats, on 16 bytes), which the pre-pass fills before the kernel,
// elsewhere unused.  dh 64, 128 or 256; streaming 0 takes the single K
// step's two passes.
extern "C" int sfc_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                 void* lse, void* ws, int batch, int heads, int nq, int nk,
                                 int dh, long long qsb, long long qsn, long long qsh,
                                 long long ksb, long long ksn, long long ksh, long long vsb,
                                 long long vsn, long long vsh, float scale, int streaming,
                                 void* stream) {
  if (nq < 1 || nk < 1 || heads < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  Params p{};
  cudaError_t e = plan(p, wide_serves(dh / 64, false), q, k, v, out, lse, ws, batch, heads, nq,
                       nk, dh, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaErrorInvalidValue;
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    e = streaming ? launch<c, false>(p, batch, s) : launch<c, true>(p, batch, s);
  });
  return static_cast<int>(e);
}

// #12 in float32: q, k, v fp32 [batch, n, heads, dh] read through their
// (batch, row, head) strides (as sfc_flash_fwd_f32's), out fp32 [batch, n,
// heads, dh] contiguous, lse fp32 [batch, heads, n] or null, ws as
// sfc_flash_fwd_f32's (nk = n; dh 256 only).  Query i meets the keys j
// with |i / block - j / block| <= halo: dh 64, 128 or 256, block a
// positive multiple of 64, halo >= 1.
extern "C" int sfc_local_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                 void* lse, void* ws, int batch, int heads, int n, int dh,
                                 int block, int halo, long long qsb, long long qsn,
                                 long long qsh, long long ksb, long long ksn, long long ksh,
                                 long long vsb, long long vsn, long long vsh, float scale,
                                 void* stream) {
  if (n < 1 || heads < 1 || batch < 0 || block < 64 || block % 64 || halo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  Params p{};
  cudaError_t e = plan(p, wide_serves(dh / 64, true), q, k, v, out, lse, ws, batch, heads, n, n,
                       dh, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, scale, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.block = block;
  p.halo = halo;
  e = cudaErrorInvalidValue;
  with_subheads(dh, [&](auto C) { e = launch<decltype(C)::value, true, true>(p, batch, s); });
  return static_cast<int>(e);
}

// The pre-pass alone: k and v as sfc_flash_fwd_f32's into ws's parts.
extern "C" int sfc_split_kv_f32(const void* k, const void* v, void* ws, int batch, int heads,
                                int nk, int dh, long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh, void* stream) {
  if (nk < 1 || heads < 1 || batch < 0 || (dh != 64 && dh != 128 && dh != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  return static_cast<int>(split(k, v, parts_of(ws, batch, heads, nk, dh), batch, heads, nk, dh,
                                ksb, ksn, ksh, vsb, vsn, vsh, static_cast<cudaStream_t>(stream)));
}

// Registers, local bytes and shared bytes of the instance for dh (64, 128,
// 256): the streaming form (form 1), the single step (0) or #12's windowed
// single step (2), into out[3].
extern "C" int sfc_flash_fwd_f32_attrs(int dh, int form, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (form < 0 || form > 2) return err;
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    auto attrs = [&](auto single, auto window) {
      constexpr bool kSingle = decltype(single)::value, kWindow = decltype(window)::value;
      if constexpr (wide_serves(c, kWindow))
        err = hw::kernel_attrs(flash_fwd_f32_wide<c, kSingle, kWindow>, kSmemBytes<c>, out);
      else
        err = hw::kernel_attrs(flash_fwd_f32_sm90<c, kSingle, kWindow>, narrow::kSmemBytes, out);
    };
    using T = std::true_type;
    using F = std::false_type;
    if (form == 0) attrs(T{}, F{});
    else if (form == 1) attrs(F{}, F{});
    else attrs(T{}, T{});
  });
  return err;
}
