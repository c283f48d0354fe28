// Flash attention backward on [B, N, H, Dh] in float32 (kernels #9, #10
// and #11's fp32 forms), for Hopper: dq [B, Nq, H, Dh] and dk, dv [B, Nk,
// H, Dh] from q, k, v, the output's cotangent g, the forward's fp32 lse
// and delta = rowsum(g * O) (both [B, H, Nq]), head dim 64, 128 or 256,
// nq != nk allowed.  Every product is three TF32 products on wgmma
// (3xTF32, csrc/attn_f32.cuh).
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/flash_attention.py::
// _dq_kernel (line 440: #10, the dq kernel below) and _dkv_kernel (line
// 482: #11, the dk/dv kernel), which take any dtype with fp32 sums, and
// _fused_bwd_kernel (line 317: #9, the backward to 8,192 tokens).  #9's
// fp32 form is the same two kernels: the TPU kernel carries dK and dV
// across its sequential grid, which Hopper's blocks, running in no order,
// cannot; the bf16 #9 adds dQ by TMA reduce-adds whose order changes from
// run to run, and the fp32 attention backward repeats bit for bit.  So
// each output here has one owner, and #9 takes its lse and delta from the
// forward as #10 and #11 do (its TPU kernel recomputes the row sum and
// takes delta = rowsum(p * dp): fp32-ulp departures).
//
// Formula, the plain versions' (flash_dq_ref, flash_dkv_ref):
//   p = exp(s * scale - lse), 0 at keys at or past nk;  dp = g . v;
//   ds = p (dp - delta) scale;  dq = ds k,  dk = ds^T q,  dv = p^T g.
// Queries at or past nq add nothing to dk and dv.  Nothing is rounded to a
// narrower type; only the order of the fp32 sums differs.
//
// Bound on this card: operations over 3xTF32's 165 TFLOP/s: 6 Nq Nk Dh a
// (b, h) for dq (S, dP, dS K) and 8 for dk and dv (S, dP, P^T g, dS^T q),
// the nominal 10 of the pair with S and dP computed twice.
//
// Design: csrc/attention_bwd_f32.cu's two kernels over separate q, k, v
// and g, read through their (batch, row, head) strides
// (sm90.cuh::map_strided_heads), at any nq and nk.  A block is one
// warpgroup (128 threads), two blocks an SM.  Thread 0 keeps 64 x 64
// sub-blocks in flight by TMA, refilling each slot after the barrier that
// follows its last use.  A sub-block is an A operand (read into registers
// a k8 step at a time and split there) or a B operand (split by the
// threads into the big and small K-major tiles, plainly or transposed
// under the key permutation).  At Dh 64 each block's own A operands stay
// resident for its whole walk and only the B operands stream, through a
// ring of two slots, each sub-block once a tile and taken twice (plainly
// and transposed); at Dh 128 and 256 everything streams through a ring of
// four.
//  (1) dq: a block owns 64 queries of one (b, h), their lse and delta in
//      registers, and walks every 64-key tile: dP = g V^T and S = Q K^T,
//      dS in the registers of dP, and dq += dS K with dS as the register A
//      operand under the key permutation and K^T's parts written K-major.
//  (2) dk, dv: a block owns 64 keys and walks every 64-query tile: dP^T =
//      V g^T and S^T = K Q^T, p and dS^T in registers, then dv += P^T g and
//      dk += dS^T Q with the register A operands under the same
//      permutation (over the queries), g^T's and Q^T's parts written
//      K-major; the tile's lse and delta staged in shared memory by plain
//      loads (no TMA box: an lse row of odd length starts off 16 bytes).
// Each (tile, sub-head) product is taken fresh and added in fp32, so the
// sum over the tiles rounds to nearest: at C = 1 to the output's
// registers, which go out once, 8-byte stores; from C = 2, where an
// output's sub-heads (64 to 128 accumulators a thread) do not fit beside
// S and dP, to the block's own rows of the output, which the same thread
// stored at the tile before (at_rows).  Either way each output row is
// summed by one block in tile order: the same bits on every call.
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
  CUtensorMap q, k, v, g;  // map_strided_heads over [B, N, H, Dh], 64-row boxes
  const float* lse;        // [B, H, nq]
  const float* delta;      // [B, H, nq]
  float* dq;               // [B, nq, H, Dh] contiguous
  float* dk;               // [B, nk, H, Dh] contiguous
  float* dv;
  int heads, dh, nq, nk, q_tiles, k_tiles;
  float scale;
};

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

// The ring's slots at C = 1: two, the other two of the four holding the
// block's own A operands for the whole walk (resident: the dq kernel's Q
// and g, the dk/dv kernel's K and V), so only the B operands stream, each
// sub-block once a tile.  From C = 2 the A operands stream too.
template <int C>
constexpr int kRing = C == 1 ? 2 : kStages;
constexpr int kResA = 2, kResB = 3;  // the resident slots at Dh 64

__device__ __forceinline__ const CUtensorMap* map_of(const Params& p, int src) {
  return src == kQ ? &p.q : src == kK ? &p.k : src == kV ? &p.v : &p.g;
}

template <int C, typename Entry>
__device__ __forceinline__ void feed(Ctx& x, int upto, Entry&& entry) {
  for (; x.issued < upto && x.issued < x.entries; ++x.issued) {
    int src, c, row;
    entry(x.issued, src, c, row);
    af::load_sub(x.sm, x.issued % kRing<C>, map_of(x.p, src), x.h, c, row, x.b);
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
// from (g, V) or (V, g).
template <int C, typename Entry>
__device__ __forceinline__ void ab(Ctx& x, float (&acc)[32], const unsigned char* as, int eb,
                                   int used, int accumulate, Entry&& entry) {
  product<C>(
      x, acc, eb, used, false, accumulate,
      [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA { af::a_frag(as, decltype(kk)::value, v); },
      entry);
}

// acc (+)= A X, X the ring's entry eb (transposed), A the accumulator `a`
// of the previous products under the key permutation.
template <int C, typename Entry>
__device__ __forceinline__ void at(Ctx& x, float (&acc)[32], const float (&a)[32], int eb, int used,
                                   int accumulate, Entry&& entry) {
  product<C>(
      x, acc, eb, used, true, accumulate,
      [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA { af::a_perm(a, decltype(kk)::value, v); },
      entry);
}

// The next two streamed entries (A, then B) through ab.
template <int C, typename Entry>
__device__ __forceinline__ void ab_next(Ctx& x, float (&acc)[32], int accumulate, Entry&& entry) {
  af::wait_entry<kRing<C>>(x.sm, x.e);
  ab<C>(x, acc, x.sm.ring[x.e % kRing<C>], x.e + 1, x.e, accumulate, entry);
  x.e += 2;
}

// The block's resident A operands (C = 1): rows row of src_a and src_b
// into slots kResA and kResB, on their own barriers.
__device__ __forceinline__ void load_resident(Ctx& x, int src_a, int src_b, int row) {
  af::load_sub(x.sm, kResA, map_of(x.p, src_a), x.h, 0, row, x.b);
  af::load_sub(x.sm, kResB, map_of(x.p, src_b), x.h, 0, row, x.b);
}

// Rows r0 and r0 + 8 of a 64-row tile's accumulators of sub-head c into
// out's rows row0 + ... of head h ([B, n, H, Dh] contiguous), with `add`
// plus what this thread stored there before; rows at or past n are
// neither read nor written.
__device__ __forceinline__ void store_sub(const Ctx& x, const float (&acc)[32], float* out, int n,
                                          int row0, int c, bool add = false) {
  const Params& p = x.p;
  const size_t w = static_cast<size_t>(p.heads) * p.dh;
  const int t = af::fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), c0 = 2 * (t & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= n) continue;
    float* dst = out + (static_cast<size_t>(x.b) * n + row) * w +
                 static_cast<size_t>(x.h) * p.dh + 64 * c + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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

// acc (+)= the tile's fresh product `part` (drained first), in fp32
// registers: the sum over the tiles rounds to nearest.  (Accumulated
// across a long row's tiles in the tensor cores' accumulator, dq drifted
// 2.2e-4 of its largest |value| from the plain version at 16,384 keys on
// the H100.)
__device__ __forceinline__ void add_tile(float (&acc)[32], float (&part)[32], int t) {
  af::drain(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = t > 0 ? acc[i] + part[i] : part[i];
}

// One sub-head of an output accumulated in its rows: from C = 2 an
// output's sub-heads do not fit beside S and dP, so each (tile, sub-head)
// product, `part` = A X for the next entry X (at, taken fresh), goes out
// to the block's own rows at once, after the first tile (`add`) added to
// what the same thread stored there at the tile before (one owner, tile
// order: the same bits on every call).
template <int C, typename Entry>
__device__ __forceinline__ void at_rows(Ctx& x, float (&part)[32], const float (&a)[32],
                                        float* out, int n, int row0, int c, bool add,
                                        Entry&& entry) {
  at<C>(x, part, a, x.e, x.e + 1, 0, entry);
  ++x.e;
  af::drain(part);
  store_sub(x, part, out, n, row0, c, add);
}

// The dq kernel's ring entries, entry i's source, sub-head and first row.
// C = 1 (Q and g resident): per key tile t, V_t then K_t, K_t taken twice
// (plainly for S, transposed for dq).  C > 1: per key tile, (Q_c, K_t,c)
// for each sub-head, (g_c, V_t,c), then K_t,c again (transposed).
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
      src = r < 2 * C ? (r & 1 ? kK : kQ) : (r & 1 ? kV : kG);
      row = r & 1 ? t * BM : q0;
    } else {
      c = r - 4 * C;
      src = kK;
      row = t * BM;
    }
  }
};

// The dk/dv kernel's.  C = 1 (K and V resident): per query tile t, g_t
// then Q_t, each taken twice (plainly for dP^T and S^T, transposed for dv
// and dk).  C > 1: per query tile, (K_c, Q_t,c) for each sub-head, (V_c,
// g_t,c), then for each sub-head g_t,c and Q_t,c (transposed).
template <int C>
struct DkvEntry {
  int k0;
  __device__ __forceinline__ void operator()(int i, int& src, int& c, int& row) const {
    if constexpr (C == 1) {
      src = i & 1 ? kQ : kG;
      c = 0;
      row = (i >> 1) * BM;
      return;
    }
    const int t = i / (6 * C), r = i % (6 * C);
    if (r < 4 * C) {
      c = (r % (2 * C)) >> 1;
      const bool b_side = r & 1;
      src = r < 2 * C ? (b_side ? kQ : kK) : (b_side ? kG : kV);
      row = b_side ? t * BM : k0;
    } else {
      c = (r - 4 * C) >> 1;
      src = r & 1 ? kQ : kG;
      row = t * BM;
    }
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

// C: 64-column sub-heads a head (1, 2 or 4).
template <int C>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_dq_f32_sm90(const __grid_constant__ Params p) {
  constexpr bool kRows = C > 1;  // accumulate in dq's rows (at_rows)
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int nq = p.nq, nk = p.nk, key_tiles = p.k_tiles;
  const int qt = blockIdx.x % p.q_tiles, bh = blockIdx.x / p.q_tiles, q0 = qt * BM;
  Ctx x = make_ctx(sm, p, bh);
  x.entries = (C == 1 ? 2 : 5 * C) * key_tiles;
  const DqEntry<C> entry{q0};

  init_ring(sm);
  if (x.tid == 0) {
    if constexpr (C == 1) load_resident(x, kQ, kG, q0);
    feed<C>(x, kRing<C>, entry);
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
  if constexpr (C == 1) {  // the resident Q and g
    hw::bar_wait(&sm.full[kResA], 0);
    hw::bar_wait(&sm.full[kResB], 0);
  }
  for (int t = 0; t < key_tiles; ++t) {
    if constexpr (C == 1) {  // dP from V_t (then free), S from K_t (kept for dq)
      ab<C>(x, dp, sm.ring[kResB], 2 * t, 2 * t + 1, 0, entry);
      ab<C>(x, s, sm.ring[kResA], 2 * t + 1, 2 * t + 1, 0, entry);
    } else {
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        ab_next<C>(x, s, decltype(Cc)::value > 0, entry);
      });
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        ab_next<C>(x, dp, decltype(Cc)::value > 0, entry);
      });
    }
    af::drain(s);
    hw::fence_regs(dp);
    // dS into dp: p (dp - delta) scale, 0 at keys at or past nk.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i / 2) % 2, key = t * BM + 8 * (i / 4) + x.c0 + (i % 2);
      float ds = 0.f;
      if (key < nk) {
        const float pn = expf(__fsub_rn(__fmul_rn(s[i], scale), lse[hf]));
        ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], delta[hf])), scale);
      }
      dp[i] = ds;
    }
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value;
      if constexpr (kRows) {
        at_rows<C>(x, s, dp, p.dq, nq, q0, c, t > 0, entry);  // s: free after dS
      } else {  // the tile's dS K fresh into s, added to dq in fp32
        at<C>(x, s, dp, 2 * t + 1, 2 * t + 2, 0, entry);
        add_tile(dq, s, t);
      }
    });
  }
  if constexpr (!kRows) store_sub(x, dq, p.dq, nq, q0, 0);
}

// The dk/dv kernel's query tile t: S^T and dP^T in s and dp, rows keys k0
// + r0 (+ 8), columns queries; then p into s and dS^T into dp.  The
// tile's lse and delta are staged in shared memory first, by plain loads;
// they are read after the products' barriers, and the last tile's were
// read before them.
template <int C, typename Entry>
__device__ __forceinline__ void dkv_tile(Ctx& x, float (&s)[32], float (&dp)[32], int t, int k0,
                                         float scale, const Entry& entry) {
  const Params& p = x.p;
  const int nq = p.nq, nk = p.nk, tid = x.tid;
  Smem& sm = x.sm;
  if (tid < BM) {
    const size_t qi = static_cast<size_t>(x.bh) * nq + min(t * BM + tid, nq - 1);
    sm.vec[0][tid] = p.lse[qi];
    sm.vec[1][tid] = p.delta[qi];
  }
  if constexpr (C == 1) {  // dP^T from g_t, S^T from Q_t (both kept for dv, dk)
    ab<C>(x, dp, sm.ring[kResB], 2 * t, 2 * t, 0, entry);
    ab<C>(x, s, sm.ring[kResA], 2 * t + 1, 2 * t, 0, entry);
  } else {
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      ab_next<C>(x, s, decltype(Cc)::value > 0, entry);
    });
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      ab_next<C>(x, dp, decltype(Cc)::value > 0, entry);
    });
  }
  af::drain(s);
  hw::fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = x.r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + x.c0 + (i % 2);
    float pn = 0.f, ds = 0.f;
    if (k0 + r < nk && t * BM + col < nq) {
      pn = expf(__fsub_rn(__fmul_rn(s[i], scale), sm.vec[0][col]));
      ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp[i], sm.vec[1][col])), scale);
    }
    s[i] = pn;
    dp[i] = ds;
  }
}

template <int C>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_dkv_f32_sm90(const __grid_constant__ Params p) {
  constexpr bool kRows = C > 1;  // accumulate in dk's and dv's rows (at_rows)
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int nk = p.nk, tiles = p.q_tiles;
  const int kt = blockIdx.x % p.k_tiles, bh = blockIdx.x / p.k_tiles, k0 = kt * BM;
  Ctx x = make_ctx(sm, p, bh);
  x.entries = (C == 1 ? 2 : 6 * C) * tiles;
  const DkvEntry<C> entry{k0};

  init_ring(sm);
  if (x.tid == 0) {
    if constexpr (C == 1) load_resident(x, kK, kV, k0);
    feed<C>(x, kRing<C>, entry);
  }
  af::pair_desc(sm, x.db, x.dsm);
  if constexpr (C == 1) {  // the resident K and V
    hw::bar_wait(&sm.full[kResA], 0);
    hw::bar_wait(&sm.full[kResB], 0);
  }
  const float scale = p.scale;

  float dv[32], dk[32], s[32], dp[32], part[32];
  for (int t = 0; t < tiles; ++t) {
    dkv_tile<C>(x, s, dp, t, k0, scale, entry);
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value;
      if constexpr (kRows) {
        at_rows<C>(x, part, s, p.dv, nk, k0, c, t > 0, entry);
        at_rows<C>(x, part, dp, p.dk, nk, k0, c, t > 0, entry);
      } else {  // each tile's product fresh (dS^T Q into s, free after P^T g)
        at<C>(x, part, s, 2 * t, 2 * t + 1, 0, entry);
        add_tile(dv, part, t);
        at<C>(x, s, dp, 2 * t + 1, 2 * t + 2, 0, entry);
        add_tile(dk, s, t);
      }
    });
  }
  if constexpr (!kRows) {
    store_sub(x, dk, p.dk, nk, k0, 0);
    store_sub(x, dv, p.dv, nk, k0, 0);
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

template <typename K>
cudaError_t launch(K kernel, int blocks, const Params& p, cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, af::kThreads, kSmemBytes, s>>>(p);
  return cudaGetLastError();
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

// dq (which 0: the dq kernel) or dk and dv (which 1: the dk/dv kernel).
int run(int which, const void* q, const void* k, const void* v, const void* g, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int nq, int nk,
        int dh, const long long (&st)[12], float scale, void* stream) {
  if (nq < 1 || nk < 1 || heads < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  cudaError_t e = plan(p, q, k, v, g, lse, delta, dq, dk, dv, batch, heads, nq, nk, dh, st, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  e = cudaErrorInvalidValue;
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    e = which == 0 ? launch(flash_dq_f32_sm90<c>, batch * heads * p.q_tiles, p, s)
                   : launch(flash_dkv_f32_sm90<c>, batch * heads * p.k_tiles, p, s);
  });
  return static_cast<int>(e);
}

}  // namespace

// #10 in float32: dq fp32 [batch, nq, heads, dh] contiguous from q, g fp32
// [batch, nq, heads, dh] and k, v fp32 [batch, nk, heads, dh], each read
// through its (batch, row, head) strides in elements (unit stride along
// dh; strides multiples of 4 elements, bases on 16 bytes),
// and lse, delta fp32 [batch, heads, nq].  dh 64, 128 or 256.
extern "C" int sfc_flash_dq_f32(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, void* dq, int batch,
                                int heads, int nq, int nk, int dh, long long qsb, long long qsn,
                                long long qsh, long long ksb, long long ksn, long long ksh,
                                long long vsb, long long vsn, long long vsh, long long gsb,
                                long long gsn, long long gsh, float scale, void* stream) {
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  return run(0, q, k, v, g, lse, delta, dq, nullptr, nullptr, batch, heads, nq, nk, dh, st,
             scale, stream);
}

// #11 in float32: dk and dv fp32 [batch, nk, heads, dh] contiguous, the
// arguments as sfc_flash_dq_f32's.
extern "C" int sfc_flash_dkv_f32(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int batch, int heads, int nq, int nk, int dh, long long qsb,
                                 long long qsn, long long qsh, long long ksb, long long ksn,
                                 long long ksh, long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh, float scale,
                                 void* stream) {
  const long long st[12] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh};
  return run(1, q, k, v, g, lse, delta, nullptr, dk, dv, batch, heads, nq, nk, dh, st, scale,
             stream);
}

// Registers, local bytes and shared bytes of the dq kernel (dkv 0) or of
// the dk/dv kernel (dkv 1) at dh (64, 128, 256), into out[3].
extern "C" int sfc_flash_bwd_f32_attrs(int dh, int dkv, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    err = dkv ? hw::kernel_attrs(flash_dkv_f32_sm90<c>, kSmemBytes, out)
              : hw::kernel_attrs(flash_dq_f32_sm90<c>, kSmemBytes, out);
  });
  return err;
}
