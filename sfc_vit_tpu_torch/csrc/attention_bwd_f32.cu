// The packed dqkv of a softmax attention in float32, with or without
// probability dropout, for Hopper: from the forward's saved qkv [B, N,
// 3*H*Dh], its output att [B, N, H*Dh], the fp32 lse [B, H, N], for the
// dropout form the 0/1 mask [B, H, N, N] and keep, and the output's
// cotangent datt.  Every product is three TF32 products on wgmma (3xTF32,
// csrc/attn_f32.cuh).
//
// Replaces, for float32 compute: the attention part of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel (line
// 270; its lines 326-377; the mask form) and of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel (line
// 333; its with_lse path, no mask: #4 in float32, the ViT-B/16 and
// ViT-S/16 presets at their own dtype), which take any dtype with fp32
// sums.  (Family A's training without dropout differentiates the stored
// weights in plain PyTorch, JAX's store-weights rule.)  The bf16 forms
// stay on attention_bwd_sm90.cu.
//
// Formula, the plain version's (attention_bwd_ref with or without the mask):
//   pn = exp(s * scale - lse), 0 at keys past n_valid;
//   dp = ((da . v) / keep) * mask;  delta = rowsum(da * att);
//   pv = (pn / keep) * mask;        ds = pn (dp - delta) scale;
//   dq = ds k,  dk = ds^T q,  dv = pv^T da;
// the divisions by keep correctly rounded by sfc::div_rn.  The unmasked
// instances (MASK false) read no mask and divide by nothing: dp = da . v,
// pv = pn.  Rows at or past n_valid (the pad rows of a padded sequence)
// attend to the valid keys like any other row; their cotangent rows are
// zero in #4's chain, so they add nothing.  Rows at or past n add nothing
// to dk and dv.  Nothing is rounded to a narrower type; only the order of
// the fp32 sums differs from the plain version.
//
// Bound on this card: bytes at family A's 64 tokens (qkv, att, datt, the
// N x N mask, dqkv), operations (10 N^2 Dh a head; 14 here past one tile,
// as the dk/dv kernel recomputes the logits and da . v) over 3xTF32's 165
// TFLOP/s at ViT-B's 196 and longer rows.
//
// Design: two kernels, each output with one owner, no atomics, so the
// same inputs give the same bits.  A block is one warpgroup (128 threads),
// two blocks an SM.  Thread 0 keeps 64 x 64 sub-blocks in flight by TMA
// (sm90.cuh::map_heads over qkv's 3 H heads and datt's H; a head is C =
// ceil(Dh / 64) 64-column sub-heads, Dh 192 three, and a ragged head's
// columns past Dh load as zeros, which add exact zeros to S, dP and delta
// and give zero output columns that are never stored), refilling each
// slot after the barrier that follows its last use.  A sub-block is an A operand (read into registers a k8 step at a
// time and split there) or a B operand (split by the threads into the big
// and small K-major tiles, plainly or transposed under the key
// permutation: csrc/attn_f32.cuh).  At Dh 64 each block's own A operands
// stay resident for its whole walk and only the B operands stream, through
// a ring of two slots, each sub-block once a tile and taken twice (plainly
// and transposed); at Dh 192 (48 KB an operand) everything streams through
// a ring of four.
//  (1) dq: a block owns 64 queries of one (image, head).  It computes
//      delta for its rows (into a small fp32 buffer the second kernel
//      reads), then for each 64-key tile below n_valid: dP = dA V^T and S =
//      Q K^T (V and K as stored are the K-major B operands), dS in the
//      registers of dP, and dq += dS K with dS as the register A operand
//      under the key permutation and K^T's parts written K-major.
//  (2) dk, dv: a block owns 64 keys and walks every 64-query tile: dP^T =
//      V dA^T and S^T = K Q^T, pn (or pv with the mask, read transposed)
//      and dS^T in registers, then dv += P^T dA and dk += dS^T Q with the
//      register A operands under the same permutation (over the queries),
//      dA^T's and Q^T's parts written K-major; the tile's lse, delta and
//      mask bytes staged in shared memory by plain loads.
// With one tile (N <= 64: the flagship's and the notebook's rows) the dq
// kernel hands pv and dS, transposed, to the dk/dv kernel through dqkv's
// dk and dv rows (to_dkv / from_dq; 64 columns of each, so only from Dh
// 64: a narrower head takes the seven products), which then loads neither
// K nor V and computes neither S^T nor dP^T: five products, not seven.  At
// C = 1 the accumulators stay in registers and go out once, 8-byte
// stores.  From C = 2 an output's sub-heads (64 to 128 accumulators a
// thread) do not fit beside S and dP: each (tile, sub-head) product is
// taken fresh and added to the block's own rows of dqkv, which the same
// thread stored at the tile before (at_rows; nothing is read back at one
// tile).  The dq kernel
// reads the mask's bytes from device memory (L1-cached).

#include <type_traits>

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
namespace af = sfc::attn_f32;

constexpr int BM = 64;      // rows a tile
constexpr int kStages = 4;  // ring slots (sub-blocks)
using Smem = af::Smem<kStages>;
constexpr int kSmemBytes = af::kSmemBytes<kStages>;

struct Params {
  CUtensorMap qkv, datt;  // map_heads over qkv [B, n, 3 H Dh] and datt [B, n, H Dh]
  const float* att;       // [B, n, H Dh]
  const float* da;        // datt, for delta
  const float* lse;       // [B, H, n]
  const uint8_t* mask;    // [B, H, n, n] 0/1, null for the unmasked instances
  float* delta;           // [B, H, n]: written by (1), read by (2)
  float* dqkv;            // [B, n, 3 H Dh]
  int n, heads, dh, n_valid, tiles;
  int handoff;            // one tile and Dh >= 64: the dq kernel hands pv, dS to dk/dv
  float scale, keep;
};

// The ring's sources: the packed projection's q, k, v and the cotangent.
enum Src : int { kQ = 0, kK = 1, kV = 2, kDA = 3 };

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

// The ring's slots at C = 1: two, the other two of the four holding the
// block's own A operands for the whole walk (resident: the dq kernel's Q
// and dA, the dk/dv kernel's K and V), so only the B operands stream, each
// sub-block once a tile.  From C = 2 the A operands (32 to 64 KB each)
// stream too, through all four.
template <int C>
constexpr int kRing = C == 1 ? 2 : kStages;
constexpr int kResA = 2, kResB = 3;  // the resident slots at Dh 64

template <int C, typename Entry>
__device__ __forceinline__ void feed(Ctx& x, int upto, Entry&& entry) {
  for (; x.issued < upto && x.issued < x.entries; ++x.issued) {
    int src, c, row;
    entry(x.issued, src, c, row);
    const CUtensorMap* map = src == kDA ? &x.p.datt : &x.p.qkv;
    const int head = src == kDA ? x.h : src * x.p.heads + x.h;
    af::load_sub(x.sm, x.issued % kRing<C>, map, head, c, row, x.b);
  }
}

// acc (+)= A B: B the ring's entry eb split into the pair (plainly, K-major
// as stored, or transposed), A's values of a k8 step from a_of.  The
// pair's last product is done first; after the split's barrier the slots
// of the entries before `used` are free for refills.
template <int C, typename Entry, typename AOf>
__device__ __forceinline__ void product(Ctx& x, float (&acc)[32], int eb, int used,
                                        bool transposed, int accumulate, AOf&& a_of,
                                        Entry&& entry) {
  af::split_entry<kRing<C>>(x.sm, eb, transposed);
  if (x.tid == 0) feed<C>(x, used + kRing<C>, entry);
  af::mma3<64, 8>(acc, x.db, x.dsm, a_of, x.fb, x.fs, accumulate);
}

// acc (+)= A B^T, B the ring's entry eb as stored (K-major), A the
// sub-block `as` read a k8 step at a time: S from (Q, K) or (K, Q), dP
// from (dA, V) or (V, dA).
template <int C, typename Entry>
__device__ __forceinline__ void ab(Ctx& x, float (&acc)[32], const unsigned char* as, int eb,
                                   int used, int accumulate, Entry&& entry) {
  product<C>(x, acc, eb, used, false, accumulate,
             [&](auto kk, float (&v)[4]) { af::a_frag(as, decltype(kk)::value, v); }, entry);
}

// acc (+)= A X, X the ring's entry eb (transposed), A the accumulator `a`
// of the previous products under the key permutation.
template <int C, typename Entry>
__device__ __forceinline__ void at(Ctx& x, float (&acc)[32], const float (&a)[32], int eb, int used,
                                   int accumulate, Entry&& entry) {
  product<C>(x, acc, eb, used, true, accumulate,
             [&](auto kk, float (&v)[4]) { af::a_perm(a, decltype(kk)::value, v); }, entry);
}

// The next two streamed entries (A, then B) through ab.
template <int C, typename Entry>
__device__ __forceinline__ void ab_next(Ctx& x, float (&acc)[32], int accumulate, Entry&& entry) {
  af::wait_entry<kRing<C>>(x.sm, x.e);
  ab<C>(x, acc, x.sm.ring[x.e % kRing<C>], x.e + 1, x.e, accumulate, entry);
  x.e += 2;
}

// The next streamed entry through at.
template <int C, typename Entry>
__device__ __forceinline__ void at_next(Ctx& x, float (&acc)[32], const float (&a)[32],
                                        int accumulate, Entry&& entry) {
  at<C>(x, acc, a, x.e, x.e + 1, accumulate, entry);
  ++x.e;
}

// The block's resident A operands (C = 1): rows row of sub-head 0 of src_a
// and src_b into slots kResA and kResB, on their own barriers.
__device__ __forceinline__ void load_resident(Ctx& x, int src_a, int src_b, int row) {
  const Params& p = x.p;
  const int srcs[2] = {src_a, src_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int src = srcs[i];
    af::load_sub(x.sm, kResA + i, src == kDA ? &p.datt : &p.qkv,
                 src == kDA ? x.h : src * p.heads + x.h, 0, row, x.b);
  }
}

// Rows r0 and r0 + 8 of a 64-row tile's accumulators of sub-head c of a
// head into the packed rows row0 + ... of dqkv at the head's column col,
// with `add` plus what this thread stored there before (rows at or past n
// are neither read nor written).  LAST: c may be a ragged head's last
// sub-head, whose columns past Dh are not written; the other sub-heads of
// a head lie wholly below Dh, and store every column unpredicated (a check
// a column there slowed the Dh 192 dk/dv kernel: ptxas serialized more of
// its wgmma).
template <bool LAST>
__device__ __forceinline__ void store_sub(const Ctx& x, const float (&acc)[32], int row0,
                                          size_t col, int c, bool add = false) {
  const Params& p = x.p;
  const size_t w = static_cast<size_t>(3) * p.heads * p.dh;
  const int t = af::fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), c0 = 2 * (t & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= p.n) continue;
    float* dst = p.dqkv + (static_cast<size_t>(x.b) * p.n + row) * w + col + 64 * c + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (LAST && 64 * c + 8 * j + c0 >= p.dh) continue;
      float2 v = make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      if (add) {
        const float2 o = *reinterpret_cast<const float2*>(dst + 8 * j);
        v.x = o.x + v.x;
        v.y = o.y + v.y;
      }
      *reinterpret_cast<float2*>(dst + 8 * j) = v;
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
}

// One sub-head of an output accumulated in dqkv's rows: from C = 2 an
// output's sub-heads (64 to 128 accumulators a thread) do not fit beside S
// and dP, so each (tile, sub-head) product, `part` = A X for the next entry
// X (at, taken fresh), goes out to the block's own rows at once, after the
// first tile (`add`) added to what the same thread stored there at the
// tile before (one owner, tile order: the same bits on every call).
template <int C, int c, typename Entry>
__device__ __forceinline__ void at_rows(Ctx& x, float (&part)[32], const float (&a)[32], int row0,
                                        size_t col, bool add, Entry&& entry) {
  at_next<C>(x, part, a, 0, entry);
  af::drain(part);
  store_sub<c == C - 1>(x, part, row0, col, c, add);
}

// One tile (N <= 64: the flagship's and the notebook's tokens) and Dh at
// least 64 (Params::handoff): the dq kernel hands pv and dS to the dk/dv kernel,
// which then computes neither S^T nor dP^T.  They go transposed,
// [key][query], into the block's own rows of dqkv where dk and dv will go
// (pv in dk's first 64 columns and dS in dv's), which the dk/dv kernel
// reads before it writes dk and dv there.  Keys and queries at or past n
// are neither written nor read.  At C = 1 the handoff runs at Dh 64 only,
// whose columns are then known at compile time (a run-time Dh there, and
// the handoff's condition computed in the kernel, slowed the Dh 64
// kernels even where no handoff runs).
template <int C>
__device__ __forceinline__ float* dkv_handoff(const Params& p, int b, int h, int key, int which) {
  const size_t dh = C == 1 ? 64 : p.dh;
  const size_t inner = static_cast<size_t>(p.heads) * dh;
  return p.dqkv + (static_cast<size_t>(b) * p.n + key) * 3 * inner + inner +
         static_cast<size_t>(h) * dh + which * inner;
}

template <int C>
__device__ __forceinline__ void to_dkv(const Ctx& x, const float (&pv)[32], const float (&ds)[32]) {
  const Params& p = x.p;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int query = x.r0 + 8 * ((i / 2) % 2), key = 8 * (i / 4) + x.c0 + (i % 2);
    if (query < p.n && key < p.n) {
      dkv_handoff<C>(p, x.b, x.h, key, 0)[query] = pv[i];
      dkv_handoff<C>(p, x.b, x.h, key, 1)[query] = ds[i];
    }
  }
}

// The dk/dv kernel's side: pv^T and dS^T in its accumulators' layout (rows
// keys r0 (+ 8), columns queries), zero past n.
template <int C>
__device__ __forceinline__ void from_dq(const Ctx& x, float (&pv)[32], float (&ds)[32]) {
  const Params& p = x.p;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int key = x.r0 + 8 * ((i / 2) % 2), query = 8 * (i / 4) + x.c0;
    float2 a = make_float2(0.f, 0.f), d = a;
    if (key < p.n) {
      a = *reinterpret_cast<const float2*>(dkv_handoff<C>(p, x.b, x.h, key, 0) + query);
      d = *reinterpret_cast<const float2*>(dkv_handoff<C>(p, x.b, x.h, key, 1) + query);
    }
    pv[i] = query < p.n ? a.x : 0.f;
    pv[i + 1] = query + 1 < p.n ? a.y : 0.f;
    ds[i] = query < p.n ? d.x : 0.f;
    ds[i + 1] = query + 1 < p.n ? d.y : 0.f;
  }
}

// The dq kernel's ring entries, entry i's source, sub-head and first row.
// C = 1 (Q and dA resident): per key tile t, V_t then K_t, K_t taken twice
// (plainly for S, transposed for dq).  C > 1: per key tile, (Q_c, K_t,c)
// for each sub-head, (dA_c, V_t,c), then K_t,c again (transposed).
template <int C>
struct DqEntry {
  int q0;
  __device__ __forceinline__ void operator()(int i, int& src, int& c, int& row) const {
    if constexpr (C == 1) {
      src = i & 1 ? kK : kV;
      c = 0;
      row = (i >> 1) * BM;
      return;
    }
    const int t = i / (5 * C), r = i % (5 * C);
    if (r < 4 * C) {
      c = (r % (2 * C)) >> 1;
      src = r < 2 * C ? (r & 1 ? kK : kQ) : (r & 1 ? kV : kDA);
      row = r & 1 ? t * BM : q0;
    } else {
      c = r - 4 * C;
      src = kK;
      row = t * BM;
    }
  }
};

// The dk/dv kernel's.  C = 1 (K and V resident): per query tile t, dA_t
// then Q_t, each taken twice (plainly for dP^T and S^T, transposed for dv
// and dk; with the handoff only transposed, and K and V are not loaded).
// C > 1: per query tile, (K_c, Q_t,c) for each sub-head, (V_c, dA_t,c), then
// for each sub-head dA_t,c and Q_t,c (transposed; with one tile only
// these).
template <int C>
struct DkvEntry {
  int k0;
  bool one;  // the handoff: only the transposed dA_0,c and Q_0,c
  __device__ __forceinline__ void operator()(int i, int& src, int& c, int& row) const {
    if (C == 1 || one) {
      src = i & 1 ? kQ : kDA;
      c = i >> 1;
      row = C == 1 ? (i >> 1) * BM : 0;
      if (C == 1) c = 0;
      return;
    }
    const int t = i / (6 * C), r = i % (6 * C);
    if (r < 4 * C) {
      c = (r % (2 * C)) >> 1;
      const bool b_side = r & 1;
      src = r < 2 * C ? (b_side ? kQ : kK) : (b_side ? kDA : kV);
      row = b_side ? t * BM : k0;
    } else {
      c = (r - 4 * C) >> 1;
      src = r & 1 ? kQ : kDA;
      row = t * BM;
    }
  }
};

// C: 64-column sub-heads a head (ceil(Dh / 64)).
template <int C, bool MASK>
__global__ void __launch_bounds__(af::kThreads, 2)
    attention_bwd_f32_dq_sm90(const __grid_constant__ Params p) {
  constexpr bool kRows = C > 1;  // accumulate in dqkv's rows (at_rows)
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n, heads = p.heads, n_valid = p.n_valid;
  const int qt = blockIdx.x % p.tiles, bh = blockIdx.x / p.tiles, q0 = qt * BM;
  Ctx x{sm, p, tid, 16 * warp + lane / 4, 2 * (lane % 4), bh / heads, bh % heads, bh};
  const int key_tiles = (n_valid + BM - 1) / BM;
  x.entries = (C == 1 ? 2 : 5 * C) * key_tiles;
  const DqEntry<C> entry{q0};

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (C == 1) load_resident(x, kQ, kDA, q0);
    feed<C>(x, kRing<C>, entry);
  }
  af::pair_desc(sm, x.db, x.dsm);

  // delta of the 64 rows: two lanes a row, each over half of the padded
  // 64 C columns (none past Dh), 16-byte loads all in flight at once; with
  // lse into shared memory.
  {
    const int dh = p.dh;
    const size_t ow = static_cast<size_t>(heads) * dh;
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float sum = 0.f;
    if (row < n) {
      const size_t off = (static_cast<size_t>(x.b) * n + row) * ow + static_cast<size_t>(x.h) * dh;
      const float4* da = reinterpret_cast<const float4*>(p.da + off);
      const float4* at = reinterpret_cast<const float4*>(p.att + off);
#pragma unroll
      for (int i = 0; i < 8 * C; ++i) {  // a fixed count: predicated loads, all in flight
        const int k = half * 8 * C + i;
        if (4 * k < dh) {
          const float4 u = da[k], v = at[k];
          sum = fmaf(u.x, v.x, sum);
          sum = fmaf(u.y, v.y, sum);
          sum = fmaf(u.z, v.z, sum);
          sum = fmaf(u.w, v.w, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sm.vec[0][r] = row < n ? p.lse[static_cast<size_t>(bh) * n + row] : 0.f;
      sm.vec[1][r] = sum;
      if (row < n) p.delta[static_cast<size_t>(bh) * n + row] = sum;
    }
  }
  __syncthreads();
  float lse[2], delta[2];
  const uint8_t* mrow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lse[hf] = sm.vec[0][x.r0 + 8 * hf];
    delta[hf] = sm.vec[1][x.r0 + 8 * hf];
    const int row = min(q0 + x.r0 + 8 * hf, n - 1);
    mrow[hf] = MASK ? p.mask + (static_cast<size_t>(bh) * n + row) * n : nullptr;
  }
  const float scale = p.scale, keep = p.keep, rkeep = __frcp_rn(p.keep);

  float dq[kRows ? 1 : C][32], s[32], dp[32];
  if constexpr (C == 1) {  // the resident Q and dA
    hw::bar_wait(&sm.full[kResA], 0);
    hw::bar_wait(&sm.full[kResB], 0);
  }
  for (int t = 0; t < key_tiles; ++t) {
    if constexpr (C == 1) {  // dP from V_t (then free), S from K_t (kept for dq)
      ab<C>(x, dp, sm.ring[kResB], 2 * t, 2 * t + 1, 0, entry);
      ab<C>(x, s, sm.ring[kResA], 2 * t + 1, 2 * t + 1, 0, entry);
    } else {
      sfc::static_for<C>([&](auto Cc) { ab_next<C>(x, s, decltype(Cc)::value > 0, entry); });
      sfc::static_for<C>([&](auto Cc) { ab_next<C>(x, dp, decltype(Cc)::value > 0, entry); });
    }
    af::drain(s);
    hw::fence_regs(dp);
    // dS into dp: pn (dp - delta) scale, 0 at keys past n_valid; with one
    // tile, pv into s and both out to the dk/dv kernel (to_dkv).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i / 2) % 2, key = t * BM + 8 * (i / 4) + x.c0 + (i % 2);
      float ds = 0.f, pv = 0.f;
      if (key < n_valid) {
        const float pn = expf(__fsub_rn(__fmul_rn(s[i], scale), lse[hf]));
        float d = dp[i];
        pv = pn;
        if constexpr (MASK) {
          const bool kept = q0 + x.r0 + 8 * hf < n && mrow[hf][key] != 0;
          d = kept ? sfc::div_rn(d, keep, rkeep) : 0.f;
          pv = kept ? sfc::div_rn(pn, keep, rkeep) : 0.f;
        }
        ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(d, delta[hf])), scale);
      }
      dp[i] = ds;
      s[i] = pv;
    }
    if (p.handoff) to_dkv<C>(x, s, dp);
    sfc::static_for<C>([&](auto Cc) {
      constexpr int c = decltype(Cc)::value;
      const size_t col = static_cast<size_t>(x.h) * p.dh;
      if constexpr (kRows) {
        at_rows<C, c>(x, s, dp, q0, col, t > 0, entry);  // s: free after dS
      } else {
        at<C>(x, dq[c], dp, 2 * t + 1, 2 * t + 2, t > 0, entry);
      }
    });
  }
  if constexpr (!kRows) {
    hw::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hw::fence_regs(dq[c]);
      store_sub<true>(x, dq[c], q0, static_cast<size_t>(x.h) * p.dh, c);
    }
  }
}

// The dk/dv kernel's query tile t: S^T and dP^T in s and dp, rows keys k0
// + r0 (+ 8), columns queries; then pv (or pn) into s and dS^T into dp.
// The tile's lse, delta and (MASK) its 64 x 64 mask bytes [query][key] are
// staged in shared memory first, by plain loads; they are read after the
// products' barriers, and the last tile's were read before them.
template <int C, bool MASK, typename Entry>
__device__ __forceinline__ void dkv_tile(Ctx& x, float (&s)[32], float (&dp)[32], int t, int k0,
                                         float scale, float keep, float rkeep,
                                         const uint8_t* mcol, const Entry& entry) {
  const Params& p = x.p;
  const int n = p.n, n_valid = p.n_valid, tid = x.tid;
  Smem& sm = x.sm;
  if (tid < BM) {
    const size_t qi = static_cast<size_t>(x.bh) * n + min(t * BM + tid, n - 1);
    sm.vec[0][tid] = p.lse[qi];
    sm.vec[1][tid] = p.delta[qi];
  }
  if constexpr (MASK) {
#pragma unroll
    for (int i = tid; i < BM * BM; i += af::kThreads) {
      const int query = t * BM + i / BM, key = k0 + i % BM;
      sm.mask[i] = query < n && key < n ? mcol[static_cast<size_t>(query) * n + key] : 0;
    }
  }
  if constexpr (C == 1) {  // dP^T from dA_t, S^T from Q_t (both kept for dv, dk)
    ab<C>(x, dp, sm.ring[kResB], 2 * t, 2 * t, 0, entry);
    ab<C>(x, s, sm.ring[kResA], 2 * t + 1, 2 * t, 0, entry);
  } else {
    sfc::static_for<C>([&](auto Cc) { ab_next<C>(x, s, decltype(Cc)::value > 0, entry); });
    sfc::static_for<C>([&](auto Cc) { ab_next<C>(x, dp, decltype(Cc)::value > 0, entry); });
  }
  af::drain(s);
  hw::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = x.r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + x.c0 + (i % 2);
    float pv = 0.f, ds = 0.f;
    if (k0 + r < n_valid && t * BM + col < n) {
      const float pn = expf(__fsub_rn(__fmul_rn(s[i], scale), sm.vec[0][col]));
      pv = pn;
      float d = dp[i];
      if constexpr (MASK) {
        const bool kept = sm.mask[col * BM + r] != 0;
        pv = kept ? sfc::div_rn(pn, keep, rkeep) : 0.f;
        d = kept ? sfc::div_rn(d, keep, rkeep) : 0.f;
      }
      ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(d, sm.vec[1][col])), scale);
    }
    s[i] = pv;
    dp[i] = ds;
  }
}

template <int C, bool MASK>
__global__ void __launch_bounds__(af::kThreads, 2)
    attention_bwd_f32_dkv_sm90(const __grid_constant__ Params p) {
  constexpr bool kRows = C > 1;  // accumulate in dqkv's rows (at_rows)
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n, heads = p.heads, n_valid = p.n_valid, tiles = p.tiles;
  const int kt = blockIdx.x % tiles, bh = blockIdx.x / tiles, k0 = kt * BM;
  Ctx x{sm, p, tid, 16 * warp + lane / 4, 2 * (lane % 4), bh / heads, bh % heads, bh};
  const size_t inner = static_cast<size_t>(heads) * p.dh;
  const size_t kcol = inner + static_cast<size_t>(x.h) * p.dh, vcol = 2 * inner + x.h * p.dh;

  float dv[kRows ? 1 : C][32], dk[kRows ? 1 : C][32];
  if (k0 >= n_valid) {  // keys past n_valid: dk = dv = 0
    zero(dv[0]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      store_sub<true>(x, dv[0], k0, kcol, c);
      store_sub<true>(x, dv[0], k0, vcol, c);
    }
    return;
  }
  const bool one = p.handoff;  // pv^T and dS^T from the dq kernel (from_dq)
  x.entries = one ? 2 * C : (C == 1 ? 2 : 6 * C) * tiles;
  const DkvEntry<C> entry{k0, one};

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (C == 1 && !one) load_resident(x, kK, kV, k0);
    feed<C>(x, kRing<C>, entry);
  }
  af::pair_desc(sm, x.db, x.dsm);
  if (C == 1 && !one) {  // the resident K and V
    hw::bar_wait(&sm.full[kResA], 0);
    hw::bar_wait(&sm.full[kResB], 0);
  }
  const float scale = p.scale, keep = p.keep, rkeep = __frcp_rn(p.keep);
  const uint8_t* mcol = MASK ? p.mask + static_cast<size_t>(bh) * n * n : nullptr;

  float s[32], dp[32];
  for (int t = 0; t < tiles; ++t) {
    if (one) from_dq<C>(x, s, dp);
    else dkv_tile<C, MASK>(x, s, dp, t, k0, scale, keep, rkeep, mcol, entry);
    sfc::static_for<C>([&](auto Cc) {
      constexpr int c = decltype(Cc)::value;
      if constexpr (kRows) {
        float part[32];
        at_rows<C, c>(x, part, s, k0, vcol, t > 0, entry);
        at_rows<C, c>(x, part, dp, k0, kcol, t > 0, entry);
      } else {
        at<C>(x, dv[c], s, 2 * t, 2 * t + 1, t > 0, entry);
        at<C>(x, dk[c], dp, 2 * t + 1, 2 * t + 2, t > 0, entry);
      }
    });
  }
  if constexpr (!kRows) {
    hw::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hw::fence_regs(dk[c]);
      hw::fence_regs(dv[c]);
      store_sub<true>(x, dk[c], k0, kcol, c);
      store_sub<true>(x, dv[c], k0, vcol, c);
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C, bool MASK>
cudaError_t launch(const Params& p, int batch, cudaStream_t s) {
  cudaError_t err = prepare(attention_bwd_f32_dq_sm90<C, MASK>, kSmemBytes);
  if (err == cudaSuccess) err = prepare(attention_bwd_f32_dkv_sm90<C, MASK>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = batch * p.heads * p.tiles;
  attention_bwd_f32_dq_sm90<C, MASK><<<blocks, af::kThreads, kSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_f32_dkv_sm90<C, MASK><<<blocks, af::kThreads, kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

// Calls f(C, MASK) (integral constants) for c sub-heads; false past 4.
template <typename F>
bool with_instance(int c, bool masked, F&& f) {
  auto go = [&](auto Cc) {
    if (masked) f(Cc, std::true_type{});
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

// dqkv (fp32 [batch, n, 3 * heads * dh]) of the attention over qkv from
// att, datt (fp32 [batch, n, heads * dh]), lse (fp32 [batch, heads, n]),
// and, for the dropout form, mask (uint8 0/1 [batch, heads, n, n]) and
// keep (mask null: no dropout, keep unused); delta (fp32 [batch, heads,
// n]) is a workspace.  dh a multiple of 16 up to 256, n <= 1,024, every
// pointer 16-byte aligned.
extern "C" int sfc_attention_bwd_f32(const void* qkv, const void* att, const void* datt,
                                     const void* lse, const void* mask, void* delta,
                                     void* dqkv, int batch, int n, int heads, int dh,
                                     int n_valid, float scale, float keep, void* stream) {
  if (batch < 0 || n < 1 || n > 1024 || heads < 1 || n_valid < 1 || n_valid > n ||
      !hw::head_dim_ok(dh) || (mask != nullptr && !(keep > 0.f && keep <= 1.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  const long long inner = static_cast<long long>(heads) * dh;
  cudaError_t err = hw::map_heads(&p.qkv, qkv, true, batch, n, 3 * heads, dh, 3 * inner, BM);
  if (err == cudaSuccess) err = hw::map_heads(&p.datt, datt, true, batch, n, heads, dh, inner, BM);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.att = static_cast<const float*>(att);
  p.da = static_cast<const float*>(datt);
  p.lse = static_cast<const float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.delta = static_cast<float*>(delta);
  p.dqkv = static_cast<float*>(dqkv);
  p.n = n;
  p.heads = heads;
  p.dh = dh;
  p.n_valid = n_valid;
  p.tiles = (n + BM - 1) / BM;
  p.handoff = p.tiles == 1 && dh >= 64;
  p.scale = scale;
  p.keep = mask != nullptr ? keep : 1.f;
  auto* s = static_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;
  with_instance(hw::subheads(dh), mask != nullptr, [&](auto C, auto M) {
    err = launch<decltype(C)::value, decltype(M)::value>(p, batch, s);
  });
  return static_cast<int>(err);
}

// Registers, local bytes and shared bytes of the dq kernel (dkv 0) or of
// the dk/dv kernel (dkv 1) at dh (its 64-column sub-heads: 64, 128, 192
// and 256 name C = 1 to 4), with the mask or without.
extern "C" int sfc_attention_bwd_f32_attrs(int dh, int masked, int dkv, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (!hw::head_dim_ok(dh)) return err;
  with_instance(hw::subheads(dh), masked != 0, [&](auto C, auto M) {
    constexpr int c = decltype(C)::value;
    constexpr bool m = decltype(M)::value;
    err = dkv ? hw::kernel_attrs(attention_bwd_f32_dkv_sm90<c, m>, kSmemBytes, out)
              : hw::kernel_attrs(attention_bwd_f32_dq_sm90<c, m>, kSmemBytes, out);
  });
  return err;
}
