// Flash attention forward on [B, N, H, Dh] in float32 (kernel #8's fp32
// form), for Hopper: out[b, i, h] = softmax(q[b, i, h] . K[b, :, h]^T *
// scale) . V[b, :, h] for nq queries and nk keys (nq != nk allowed), head
// dim 64, 128 or 256, optionally with the fp32 log-sum-exp of every row.
// Every product is three TF32 products on wgmma (3xTF32,
// csrc/attn_f32.cuh).
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/flash_attention.py::
// _fwd_kernel (line 114), which takes any dtype with fp32 logits, softmax
// and sums.  Its two formulas, picked by the caller from the key length as
// the TPU launcher picks them (round_up(nk, 128) <= 4096):
//  * single K step (kSingle; lines 136-160): s = (q . k) * scale, the row's
//    max m and sum l over every key, then P = exp(s - m) / l and out = P V.
//    A 64-row fp32 logits strip over 4,096 keys (1 MB) does not fit a
//    block, so two passes over 64-key tiles: the first keeps the running
//    max and rescaled sum (logits only, no V), the second recomputes each
//    tile's logits, forms P normalised and adds P V: 1.5x the nominal
//    4 x Nq x Nk x Dh operations.
//  * streaming (lines 162-218): per key tile, m' = max(m, max_tile(s)), p
//    = exp(s - m'), alpha = exp(m - m'), l = sum(p) + alpha l, acc = acc
//    alpha + p V; out = acc / l.  The tiles are 64 keys where the TPU's are
//    1,024: in fp32 nothing is rounded to a narrower type, so the width
//    changes only the order of the fp32 sums.
// Keys at or past nk get -1e30 (p = 0, no NaN); lse = m + log(l).  Nothing
// is rounded to a narrower type; only the order of the fp32 sums differs
// from the plain version (ops/flash_attention.py::flash_fwd_ref).
//
// Bound on this card: operations, 4 Nq Nk Dh a (b, h), over 3xTF32's 165
// TFLOP/s (CurveViT-S/12's 4,096 tokens: 0.41 TFLOP on 50 MB of q, k, v
// and out at batch 16).
//
// Design: csrc/packed_attn_f32.cu's block over separate q, k and v.  A
// block is one warpgroup (128 threads) and owns 64 queries of one (b, h);
// two blocks an SM.  q, k and v are read through their (batch, row, head)
// strides (sm90.cuh::map_strided_heads: contiguous tensors, or the views
// of a packed projection whose rows are 3 H Dh apart, with no copy), a
// head as C = Dh / 64 sub-heads of 64 columns.  Thread 0 keeps a ring of
// four 64 x 64 sub-blocks in flight by TMA, refilling each slot after the
// barrier that follows its last use.  For each key tile the ring brings,
// per sub-head, Q's sub-block (the A operand, read into registers and
// split a k8 step at a time) and K's (split into the big and small
// K-major B tiles), and S += Q K^T runs as m64n64 wgmma; then per
// sub-head V's sub-block, whose transpose the threads write K-major under
// the key permutation, and P V_c takes P straight from the logits'
// registers as the A operand, into a fresh accumulator that is added to
// O_c in fp32 (the streaming form's o alpha + P V).  O's sub-heads (32
// registers a thread each) stay in registers for the whole walk and go out
// once, 8-byte stores, rows at or past nq not written: all of them at Dh
// 64 and 128; at Dh 256 two walks over the keys, each for two of O's four
// sub-heads, recompute the logits (1.5x the products; O's four beside the
// rest spilled).
#include <type_traits>

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
namespace af = sfc::attn_f32;

constexpr int BM = 64;      // queries a block, keys a tile
constexpr int kStages = 4;  // ring slots (sub-blocks)
using Smem = af::Smem<kStages>;
constexpr int kSmemBytes = af::kSmemBytes<kStages>;

struct Params {
  CUtensorMap q, k, v;  // map_strided_heads over [B, N, H, Dh], 64-row boxes
  float* out;           // [B, nq, H, Dh] contiguous
  float* lse;           // [B, H, nq] or null
  int heads, dh, nq, nk, q_tiles, k_tiles;
  float scale;
};

// O's sub-heads a walk over the keys holds (32 registers each, beside the
// logits and a fresh P V product): all of them at C = 1 and 2; at C = 4
// two walks of two each (O's 128 registers beside the rest spilled).
template <int C>
constexpr int kHeld = C < 4 ? C : 2;

// Ring entry e of a block: which tensor (0 Q, 1 K, 2 V), its sub-head and
// key tile.  The single step's first pass: per key tile and sub-head Q
// then K.  Then (the single step's second pass, or the streaming form's
// only one), for each group of kHeld of O's sub-heads, per key tile: per
// sub-head Q then K, then V of the group's sub-heads.
template <int C, bool SINGLE>
__device__ __forceinline__ void entry_of(int e, int k_tiles, int& which, int& c, int& t) {
  constexpr int CO = kHeld<C>, per = 2 * C + CO;
  if (SINGLE && e < 2 * C * k_tiles) {
    t = e / (2 * C);
    c = (e % (2 * C)) >> 1;
    which = e & 1;
    return;
  }
  if (SINGLE) e -= 2 * C * k_tiles;
  const int unit = e / per, r = e % per;
  t = unit % k_tiles;
  c = r < 2 * C ? r >> 1 : (unit / k_tiles) * CO + r - 2 * C;
  which = r < 2 * C ? (r & 1) : 2;
}

// C: 64-column sub-heads a head (1, 2 or 4).  SINGLE: the single K step's
// two passes (P normalised before P V), else the streaming form.
template <int C, bool SINGLE>
__global__ void __launch_bounds__(af::kThreads, 2)
    flash_fwd_f32_sm90(const __grid_constant__ Params p) {
  constexpr int CO = kHeld<C>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4, c0 = 2 * tq;
  const int heads = p.heads, nq = p.nq, nk = p.nk, k_tiles = p.k_tiles;
  const int qt = blockIdx.x % p.q_tiles, bh = blockIdx.x / p.q_tiles;
  const int h = bh % heads, b = bh / heads, q0 = qt * BM;
  const int entries = ((SINGLE ? 2 * C : 0) + (C / CO) * (2 * C + CO)) * k_tiles;

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
      entry_of<C, SINGLE>(issued, k_tiles, which, c, t);
      const CUtensorMap* map = which == 0 ? &p.q : which == 1 ? &p.k : &p.v;
      af::load_sub(sm, issued % kStages, map, h, c, which == 0 ? q0 : t * BM, b);
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
  float s[32], o[CO][32], m[2], l[2];
  // Key tile t's logits into s, scaled, keys at or past nk at -1e30; every
  // product issued before is done after it.
  auto tile_logits = [&](int t) SFC_INLINE_LAMBDA {
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA { logits(s, decltype(Cc)::value > 0); });
    af::drain(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = BM * t + 8 * (i / 4) + c0 + (i % 2);
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
  // O_c (+)= P V_t,c for the group's sub-heads, V_t,c the next entries
  // (split transposed), P the A operand straight from the logits'
  // registers (the key permutation): each tile's product taken fresh into
  // `part`, then o = o alpha + part in fp32 registers (alpha 1 in the
  // single step), so the sum over the key tiles rounds to nearest.
  // (Accumulated across a long row's tiles in the tensor cores'
  // accumulator, the streaming output drifted 1.2e-4 of its largest
  // |value| from the plain version at 8,300 keys on the H100.)
  float part[32];
  auto pv_add = [&](int t, const float (&alpha)[2]) SFC_INLINE_LAMBDA {
    sfc::static_for<CO>([&](auto Cc) SFC_INLINE_LAMBDA {
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
  // O's group g (sub-heads CO g ..) out, rows r0 and r0 + 8 below nq; the
  // streaming form's acc times 1 / l.
  const size_t row_w = static_cast<size_t>(heads) * p.dh;
  auto store_o = [&](int g) SFC_INLINE_LAMBDA {
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) inv[hf] = SINGLE ? 1.f : __frcp_rn(l[hf]);
#pragma unroll
    for (int c = 0; c < CO; ++c)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + r0 + 8 * hf;
        if (row >= nq) continue;
        float* dst = p.out + (static_cast<size_t>(b) * nq + row) * row_w +
                     static_cast<size_t>(h) * p.dh + 64 * (CO * g + c) + c0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(o[c][4 * j + 2 * hf] * inv[hf], o[c][4 * j + 2 * hf + 1] * inv[hf]);
      }
  };

  if constexpr (SINGLE) {
    // First pass: the running max and the rescaled sum of every row.
    m[0] = m[1] = sfc::kNegInf;
    l[0] = l[1] = 0.f;
    for (int t = 0; t < k_tiles; ++t) {
      tile_logits(t);
      float alpha[2];
      online(alpha, false);
    }
    // Second pass, for each group of O's sub-heads: P = exp(s - m) / l,
    // then O += P V.
    float rl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) rl[hf] = __frcp_rn(l[hf]);
    const float one[2] = {1.f, 1.f};
    for (int g = 0; g < C / CO; ++g) {
      for (int t = 0; t < k_tiles; ++t) {
        tile_logits(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hf = (i / 2) % 2;
          s[i] = sfc::div_rn(expf(__fsub_rn(s[i], m[hf])), l[hf], rl[hf]);
        }
        pv_add(t, one);
      }
      store_o(g);
    }
  } else {
    // Streaming, for each group of O's sub-heads (the same m and l each
    // time): O rescaled by alpha each tile, divided by l at the end.
    for (int g = 0; g < C / CO; ++g) {
      m[0] = m[1] = sfc::kNegInf;
      l[0] = l[1] = 0.f;
      for (int t = 0; t < k_tiles; ++t) {
        tile_logits(t);
        float alpha[2];
        online(alpha, true);
        pv_add(t, alpha);
      }
      store_o(g);
    }
  }
  if (p.lse != nullptr && tq == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row < nq) p.lse[static_cast<size_t>(bh) * nq + row] = m[hf] + logf(l[hf]);
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

template <int C, bool SINGLE>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_sm90<C, SINGLE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, af::kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// #8 in float32: q, k, v fp32 [batch, n, heads, dh] read through their
// (batch, row, head) strides in elements (unit stride along dh; strides
// multiples of 4 elements, bases on 16 bytes); out fp32
// [batch, nq, heads, dh] contiguous; lse fp32 [batch, heads, nq] or null.
// dh 64, 128 or 256; streaming 0 takes the single K step's two passes.
extern "C" int sfc_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int batch, int heads, int nq, int nk, int dh,
                                 long long qsb, long long qsn, long long qsh, long long ksb,
                                 long long ksn, long long ksh, long long vsb, long long vsn,
                                 long long vsh, float scale, int streaming, void* stream) {
  if (nq < 1 || nk < 1 || heads < 1 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  cudaError_t e =
      hw::map_strided_heads(&p.q, q, true, batch, nq, heads, dh, qsb, qsn, qsh, BM);
  if (e == cudaSuccess)
    e = hw::map_strided_heads(&p.k, k, true, batch, nk, heads, dh, ksb, ksn, ksh, BM);
  if (e == cudaSuccess)
    e = hw::map_strided_heads(&p.v, v, true, batch, nk, heads, dh, vsb, vsn, vsh, BM);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.dh = dh;
  p.nq = nq;
  p.nk = nk;
  p.q_tiles = (nq + BM - 1) / BM;
  p.k_tiles = (nk + BM - 1) / BM;
  p.scale = scale;
  const int blocks = batch * heads * p.q_tiles;
  auto s = static_cast<cudaStream_t>(stream);
  e = cudaErrorInvalidValue;
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    e = streaming ? launch<c, false>(p, blocks, s) : launch<c, true>(p, blocks, s);
  });
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the instance for dh (64, 128,
// 256), streaming (1) or the single step (0), into out[3].
extern "C" int sfc_flash_fwd_f32_attrs(int dh, int streaming, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_subheads(dh, [&](auto C) {
    constexpr int c = decltype(C)::value;
    err = streaming ? hw::kernel_attrs(flash_fwd_f32_sm90<c, false>, kSmemBytes, out)
                    : hw::kernel_attrs(flash_fwd_f32_sm90<c, true>, kSmemBytes, out);
  });
  return err;
}
