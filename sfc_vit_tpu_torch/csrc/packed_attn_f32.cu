// Attention straight off the packed projection in float32, for Hopper: qkv
// [B, N, 3*H*Dh] -> out [B, N, H*Dh], with the fp32 log-sum-exp of each
// softmax row on request, and optionally the family-A dropout mask.  Every
// product is three TF32 products on wgmma (3xTF32, csrc/attn_f32.cuh).
//
// Replaces, for float32 compute: the attention of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (line 82:
// with the 0/1 mask and keep, and the lse its backward recomputes from)
// and sfc_vit_tpu/ops/flash_attention.py::_packed_kernel (line 907: no
// mask, no lse), and the attention of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (line 104:
// no mask; with the lse in training; ViT-B's 196 tokens at Dh 64, keys at
// or past n_actual masked), which take any dtype and keep logits, softmax
// and sums in fp32.  The bf16 forms stay on packed_attn_sm90.cu.
//
// Formula, the plain versions' (attention_fwd_ref, _packed_xla_ref):
// s = (q . k) * scale in fp32, keys at or past n_valid excluded, P = p / l
// with p = exp(s - m), then with the mask pd = (P / keep) * mask, the two
// divisions correctly rounded by sfc::div_rn; out = sum_j pd_j v_j; lse =
// m + log(l), taken before the mask.  Nothing is rounded to a narrower
// type: each product is a_big b_small + a_small b_big + a_big b_big of
// the split x = big + small (csrc/gemm_f32.cu's header: within 1.25 x
// 2^-20 of |a| |b| before the fp32 sums), so only the order of the fp32
// sums differs from the plain versions.
//
// Bound on this card: bytes at short rows (qkv, out, the N x N mask),
// operations (4 N^2 Dh a head) over 3xTF32's 165 TFLOP/s at long ones.
//
// Design: a block is one warpgroup (128 threads) and owns 64 queries of
// one (image, head); two blocks an SM.  Thread 0 keeps a ring of four
// 64 x 64 sub-blocks in flight by TMA (sm90.cuh::map_heads over the packed
// projection's 3 H heads; a head is C = ceil(Dh / 64) 64-column sub-heads,
// Dh 192 three, and a ragged head's columns past Dh load as zeros, which
// add exact zeros to every product: 3xTF32 splits a zero into zeros),
// refilling each slot
// after the barrier that follows its last use.  For each key tile and
// sub-head the ring brings Q's sub-block (the A operand, read into
// registers and split a k8 step at a time) and K's (split elementwise
// into the big and small K-major B tiles), and S += Q K^T runs as m64n64
// wgmma (m64n8 for the last 8 of ViT-B's 196 keys, held as 200 columns).
//  * One pass where the whole row of logits fits the accumulators beside
//    O's 32 C registers (sm90.cuh::one_pass_nk, as packed_attn_sm90.cu):
//    64, 128, 192, 200 and 256 keys at C = 1, to 192 at C = 2, 64 at C =
//    3 and 4 (the narrowest instance that covers n_valid).  S is computed once; the exact row max
//    and sum meet over each row's quad of threads; P = p / l (and the
//    mask) in registers; then for each key tile and sub-head the ring
//    brings V's sub-block, the threads write V^T's big and small parts
//    K-major under the key permutation, and O += P V takes P straight from
//    the logits' registers as the A operand.
//  * Two passes for longer rows (to N = 1,024): the first keeps the row's
//    running max and rescaled sum over 64-key tiles, the second recomputes
//    each tile's logits, forms P and adds P V.  The logits are computed
//    twice so that P is normalised before its product with V at any N.
// With the mask, its 64 x 64 tile for each key tile comes by TMA
// (map_mask_u8, 64-byte swizzled; by the threads' plain loads into the same
// slot where N % 16 != 0) into one slot, each tile issued once the last
// P V has passed its barrier, and divides P by keep tile by tile just
// before P V.  O goes out once, 8-byte stores of the accumulators, rows at
// or past n and columns past Dh not written; lse for the rows below n.

#include <type_traits>

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
namespace af = sfc::attn_f32;

constexpr int BM = 64;      // queries an item, keys a tile
constexpr int kStages = 4;  // ring slots (sub-blocks)
constexpr int kMaxN = 1024;

struct Params {
  CUtensorMap qkv;   // map_heads over qkv [B, n, 3 H Dh] (3 H heads), 64-row boxes
  CUtensorMap mask_map;  // the mask's [B H n, n] rows, where mask_tma
  float* out;        // [B, n, H Dh]
  float* lse;        // [B, H, n] or null
  const uint8_t* mask;  // [B, H, n, n] 0/1, or null
  int heads, dh, n, n_valid, q_tiles, k_tiles, mask_tma;
  float scale, keep;
};

// Ring entry e of an item: which tensor (0 Q, 1 K, 2 V), its sub-head and
// key tile.  One pass (KT key tiles): per tile and sub-head Q then K, then
// per tile and sub-head V.  Two passes (k_tiles): the first pass's Q, K
// pairs, then for each output sub-head co and each tile the pairs and
// V's sub-block co.
template <int C, int KT>
__device__ __forceinline__ void entry_of(int e, int k_tiles, int& which, int& c, int& t) {
  const int tiles = KT > 0 ? KT : k_tiles;
  if (e < 2 * C * tiles) {
    t = e / (2 * C);
    c = (e % (2 * C)) >> 1;
    which = e & 1;
    return;
  }
  e -= 2 * C * tiles;
  if constexpr (KT > 0) {
    t = e / C;
    c = e % C;
    which = 2;
  } else {
    const int unit = e / (2 * C + 1), r = e % (2 * C + 1);
    t = unit % tiles;
    c = r < 2 * C ? r >> 1 : unit / tiles;
    which = r < 2 * C ? (r & 1) : 2;
  }
}

// C: 64-column sub-heads a head (ceil(Dh / 64)).  NK: the key columns
// the one-pass form holds (64, 128, 192, 200, 256), 0 for two passes.
// MASK: the dropout mask and keep.
template <int C, int NK, bool MASK>
__global__ void __launch_bounds__(af::kThreads, 2)
    packed_attn_f32_sm90(const __grid_constant__ Params p) {
  constexpr int KT = (NK + BM - 1) / BM;  // one-pass key tiles; 0: two passes
  constexpr bool kTail = NK % BM != 0;    // 200: three tiles and 8 columns of a fourth
  constexpr int KF = kTail ? KT - 1 : (KT > 0 ? KT : 1);  // whole 64-key tiles of logits held
  using S = af::Smem<kStages>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  S& sm = hw::aligned_smem<S>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4, c0 = 2 * tq;
  const int n = p.n, heads = p.heads, n_valid = p.n_valid, k_tiles = p.k_tiles;
  const int qt = blockIdx.x % p.q_tiles, bh = blockIdx.x / p.q_tiles;
  const int h = bh % heads, b = bh / heads, q0 = qt * BM;
  const int entries = KT > 0 ? 3 * C * KT : (2 * C + C * (2 * C + 1)) * k_tiles;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::bar_init(&sm.mask_full, 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  // Thread 0 issues the ring's entries in order; `upto`: every entry
  // before it may take a slot (the slot's last entry is consumed).
  int issued = 0;
  auto feed = [&](int upto) SFC_INLINE_LAMBDA {
    for (; issued < upto && issued < entries; ++issued) {
      int which, c, t;
      entry_of<C, KT>(issued, k_tiles, which, c, t);
      af::load_sub(sm, issued % kStages, &p.qkv, which * heads + h, c,
                   which == 0 ? q0 : t * BM, b);
    }
  };
  // The mask's tile of key tile t into its slot by TMA (thread 0).
  auto issue_mask = [&](int t) SFC_INLINE_LAMBDA {
    hw::bar_expect_tx(&sm.mask_full, BM * BM);
    hw::tma_load2(sm.mask, &p.mask_map, &sm.mask_full, t * BM, bh * n + q0);
  };
  if (tid == 0) {
    feed(kStages);
    if (MASK && p.mask_tma) issue_mask(0);
  }

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
  // acc (+)= Q_c K_t,c^T (N columns) for the next pair of entries, Q then
  // K; Q's slot is read a k8 step at a time under the products.
  auto logits = [&](auto& acc, auto N, int accumulate) SFC_INLINE_LAMBDA {
    af::wait_entry(sm, e);
    take_b(e + 1, e, false);
    const unsigned char* qs = sm.ring[e % kStages];
    af::mma3<decltype(N)::value, 8>(
        acc, db, dsm,
        [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA {
          af::a_frag(qs, decltype(kk)::value, v);
        },
        fb, fs, accumulate);
    e += 2;
  };
  // oc (+)= P V_t,c for the next entry (V) over STEPS k8 steps, P's key
  // group `step` in the logits registers pt (the key permutation).
  auto pv = [&](auto& oc, const auto& pt, auto STEPS, int accumulate) SFC_INLINE_LAMBDA {
    take_b(e, e + 1, true);
    af::mma3<64, decltype(STEPS)::value>(
        oc, db, dsm,
        [&](auto kk, float (&v)[4]) SFC_INLINE_LAMBDA {
          af::a_perm(pt, decltype(kk)::value, v);
        },
        fb, fs, accumulate);
    ++e;
  };
  const float scale = p.scale, keep = p.keep, rkeep = __frcp_rn(p.keep);
  // P of key tile t (normalised, in pt) times the mask over keep: the
  // tile's mask waited for (load ml of the slot; by plain loads where it
  // has no TMA box, zero past n), then, once the P V that follows has
  // passed its barrier, the slot handed to key tile t_next (< 0: none).
  int ml = 0;
  auto dropout = [&](float (&pt)[32], int t) SFC_INLINE_LAMBDA {
    if (p.mask_tma) {
      hw::bar_wait(&sm.mask_full, ml & 1);
    } else {
      const uint8_t* src = p.mask + static_cast<size_t>(bh) * n * n;
#pragma unroll 8
      for (int i = tid; i < BM * BM; i += af::kThreads) {
        const int row = q0 + i / BM, key = t * BM + i % BM;
        sm.mask[hw::sw64_u8(i / BM, i % BM)] =
            row < n && key < n ? src[static_cast<size_t>(row) * n + key] : 0;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + c0 + (i % 2);
      const bool kept = q0 + r < n && sm.mask[hw::sw64_u8(r, col)] != 0;
      pt[i] = kept ? sfc::div_rn(pt[i], keep, rkeep) : 0.f;
    }
  };
  auto mask_next = [&](int t_next) SFC_INLINE_LAMBDA {
    ++ml;
    if (tid == 0 && p.mask_tma && t_next >= 0) issue_mask(t_next);
  };
  auto quad_max = [](float v) SFC_INLINE_LAMBDA {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) SFC_INLINE_LAMBDA {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  float m[2], l[2], rl[2];
  // O's 64-column sub-head c, rows r0 and r0 + 8 (rows at or past n and
  // columns past Dh not written); after the lse, which the first rows' m
  // and l give.
  const int dh = p.dh;
  const size_t ow = static_cast<size_t>(heads) * dh;
  auto store_o = [&](const float (&oc)[32], int c) SFC_INLINE_LAMBDA {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + 8 * hf;
      if (row >= n) continue;
      float* dst = p.out + (static_cast<size_t>(b) * n + row) * ow +
                   static_cast<size_t>(h) * dh + 64 * c + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * c + 8 * j + c0 < dh)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(oc[4 * j + 2 * hf], oc[4 * j + 2 * hf + 1]);
    }
  };
  auto store_lse = [&]() SFC_INLINE_LAMBDA {
    if (p.lse != nullptr && tq == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + r0 + 8 * hf;
        if (row < n) p.lse[static_cast<size_t>(bh) * n + row] = m[hf] + logf(l[hf]);
      }
    }
  };

  if constexpr (KT > 0) {
    // One pass: the whole row's logits, tile t in s[t] (and the tail).
    float s[KF][32], tail[4], o[C][32];
    sfc::static_for<KF>([&](auto T) SFC_INLINE_LAMBDA {
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        logits(s[decltype(T)::value], std::integral_constant<int, 64>{}, decltype(Cc)::value > 0);
      });
    });
    if constexpr (kTail)
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        logits(tail, std::integral_constant<int, 8>{}, decltype(Cc)::value > 0);
      });
    hw::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < KF; ++t) hw::fence_regs(s[t]);
    if constexpr (kTail) hw::fence_regs(tail);
    // Scaled, keys at or past n_valid excluded; the exact row max and sum.
    auto each = [&](auto&& f) SFC_INLINE_LAMBDA {
#pragma unroll
      for (int t = 0; t < KF; ++t)
#pragma unroll
        for (int i = 0; i < 32; ++i) f(s[t][i], (i / 2) % 2, 64 * t + 8 * (i / 4) + c0 + (i % 2));
      if constexpr (kTail)
#pragma unroll
        for (int i = 0; i < 4; ++i) f(tail[i], (i / 2) % 2, 64 * KF + c0 + (i % 2));
    };
    m[0] = m[1] = sfc::kNegInf;
    each([&](float& x, int hf, int key) SFC_INLINE_LAMBDA {
      x = key < n_valid ? __fmul_rn(x, scale) : sfc::kNegInf;
      m[hf] = fmaxf(m[hf], x);
    });
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) m[hf] = quad_max(m[hf]);
    each([&](float& x, int hf, int) SFC_INLINE_LAMBDA {
      x = expf(__fsub_rn(x, m[hf]));
      l[hf] += x;
    });
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] = quad_sum(l[hf]);
      rl[hf] = __frcp_rn(l[hf]);
    }
    each([&](float& x, int hf, int) SFC_INLINE_LAMBDA { x = sfc::div_rn(x, l[hf], rl[hf]); });
    store_lse();
    // O = P V over the key tiles, P as the A operand from the registers.
    sfc::static_for<KF>([&](auto T) SFC_INLINE_LAMBDA {
      constexpr int t = decltype(T)::value;
      if constexpr (MASK) dropout(s[t], t);
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        pv(o[decltype(Cc)::value], s[t], std::integral_constant<int, 8>{}, t > 0);
      });
      if constexpr (MASK) mask_next(t + 1 < KF ? t + 1 : -1);
    });
    if constexpr (kTail)
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        pv(o[decltype(Cc)::value], tail, std::integral_constant<int, 1>{}, 1);
      });
    hw::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hw::fence_regs(o[c]);
      store_o(o[c], c);
    }
  } else {
    // Two passes over 64-key tiles; the second once for each of O's
    // sub-heads (its logits recomputed for each), so only one sub-head's
    // accumulators are held.
    float s[32], o[32];
    auto tile_logits = [&](int t) SFC_INLINE_LAMBDA {
      sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
        logits(s, std::integral_constant<int, 64>{}, decltype(Cc)::value > 0);
      });
      af::drain(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = 64 * t + 8 * (i / 4) + c0 + (i % 2);
        s[i] = key < n_valid ? __fmul_rn(s[i], scale) : sfc::kNegInf;
      }
    };
    m[0] = m[1] = sfc::kNegInf;
    l[0] = l[1] = 0.f;
    for (int t = 0; t < k_tiles; ++t) {
      tile_logits(t);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = sfc::kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        const float m_new = fmaxf(m[hf], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) sum += expf(__fsub_rn(s[4 * j + 2 * hf + x], m_new));
        l[hf] = l[hf] * expf(m[hf] - m_new) + quad_sum(sum);
        m[hf] = m_new;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) rl[hf] = __frcp_rn(l[hf]);
    store_lse();
    for (int co = 0; co < C; ++co) {
      for (int t = 0; t < k_tiles; ++t) {
        tile_logits(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hf = (i / 2) % 2;
          s[i] = sfc::div_rn(expf(__fsub_rn(s[i], m[hf])), l[hf], rl[hf]);
        }
        if constexpr (MASK) dropout(s, t);
        pv(o, s, std::integral_constant<int, 8>{}, t > 0);
        if constexpr (MASK) mask_next(t + 1 < k_tiles ? t + 1 : co + 1 < C ? 0 : -1);
      }
      af::drain(o);
      store_o(o, co);
    }
  }
}

template <int C, int NK, bool MASK>
cudaError_t launch(const Params& p, int items, cudaStream_t stream) {
  auto kernel = packed_attn_f32_sm90<C, NK, MASK>;
  constexpr int smem = af::kSmemBytes<kStages>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<items, af::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run(const void* qkv, void* out, void* lse, const void* mask, int batch, int n,
                int heads, int dh, int n_valid, float scale, float keep, int nk, void* stream) {
  if (batch < 0 || n < 1 || n > kMaxN || heads < 1 || n_valid < 1 || n_valid > n ||
      !hw::head_dim_ok(dh) || (mask != nullptr && !(keep > 0.f && keep <= 1.f)) ||
      (nk > 0 && nk < n_valid))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  Params p{};
  cudaError_t e =
      hw::map_heads(&p.qkv, qkv, true, batch, n, 3 * heads, dh, 3LL * heads * dh, BM);
  if (e != cudaSuccess) return e;
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  // A TMA box of the mask's rows needs their stride on 16 bytes; a row of
  // at least one 64-key box keeps every box inside the tensor's width.
  p.mask_tma = mask != nullptr && n % 16 == 0 && n >= BM;
  if (p.mask_tma) {
    e = hw::map_mask_u8(&p.mask_map, mask, static_cast<long long>(batch) * heads * n, n);
    if (e != cudaSuccess) return e;
  }
  p.heads = heads;
  p.dh = dh;
  p.n = n;
  p.n_valid = n_valid;
  p.q_tiles = (n + BM - 1) / BM;
  p.k_tiles = (n_valid + BM - 1) / BM;
  p.scale = scale;
  p.keep = mask != nullptr ? keep : 1.f;
  const int items = batch * heads * p.q_tiles;
  auto s = static_cast<cudaStream_t>(stream);
  e = cudaErrorInvalidValue;
  if (mask != nullptr)
    hw::with_packed_instance<true>(hw::subheads(dh), nk, [&](auto C, auto K) {
      e = launch<decltype(C)::value, decltype(K)::value, true>(p, items, s);
    });
  else
    hw::with_packed_instance<false>(hw::subheads(dh), nk, [&](auto C, auto K) {
      e = launch<decltype(C)::value, decltype(K)::value, false>(p, items, s);
    });
  return e;
}

}  // namespace

// out (fp32 [batch, n, heads * dh]) = attention over the packed qkv (fp32
// [batch, n, 3 * heads * dh], 16-byte aligned), keys at or past n_valid
// excluded; lse (fp32 [batch, heads, n]) written when not null; mask
// (uint8 0/1 [batch, heads, n, n]) with keep in (0, 1] applied when not
// null.  dh a multiple of 16 up to 256, n <= 1,024.
extern "C" int sfc_packed_attention_f32(const void* qkv, void* out, void* lse,
                                        const void* mask, int batch, int n, int heads,
                                        int dh, int n_valid, float scale, float keep,
                                        void* stream) {
  const int nk =
      n_valid >= 1 ? hw::one_pass_nk(hw::subheads(dh), n_valid, mask != nullptr) : 0;
  return static_cast<int>(
      run(qkv, out, lse, mask, batch, n, heads, dh, n_valid, scale, keep, nk, stream));
}

// The same in the form nk names (the one-pass key columns, 0 for two
// passes; nk >= n_valid): a timing instrument for where the one-pass form
// should give way to two passes.
extern "C" int sfc_packed_attention_f32_form(const void* qkv, void* out, void* lse,
                                             const void* mask, int batch, int n, int heads,
                                             int dh, int n_valid, float scale, float keep,
                                             int nk, void* stream) {
  return static_cast<int>(
      run(qkv, out, lse, mask, batch, n, heads, dh, n_valid, scale, keep, nk, stream));
}

// Registers, local bytes and shared bytes of the instance for dh (its
// 64-column sub-heads: 64, 128, 192 and 256 name C = 1 to 4), nk one-pass
// key columns (sm90.cuh::with_packed_instance's; 0: two passes), masked
// or not.
extern "C" int sfc_packed_attention_f32_attrs(int dh, int nk, int masked, int* out) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (!hw::head_dim_ok(dh)) return err;
  auto get = [&](auto C, auto K, auto M) {
    constexpr int c = decltype(C)::value, k = decltype(K)::value;
    constexpr bool m = decltype(M)::value;
    err = hw::kernel_attrs(packed_attn_f32_sm90<c, k, m>, af::kSmemBytes<kStages>, out);
  };
  if (masked)
    hw::with_packed_instance<true>(hw::subheads(dh), nk,
                                   [&](auto C, auto K) { get(C, K, std::true_type{}); });
  else
    hw::with_packed_instance<false>(hw::subheads(dh), nk,
                                    [&](auto C, auto K) { get(C, K, std::false_type{}); });
  return err;
}
