// Attention straight off the packed QKV projection (kernel #7), for
// Hopper: out[b, i, h*Dh:(h+1)*Dh] = softmax(q_i . K^T * scale, keys <
// n_valid) . V for every image b and head h, with q, k and v read from
// qkv bf16 [B, N, 3*H*Dh] at columns h*Dh, inner + h*Dh and 2*inner +
// h*Dh (inner = H*Dh).  Head dims 64 and 192, N up to 1,024.
//
// Replaces: sfc_vit_tpu/ops/flash_attention.py::_packed_kernel (lines
// 907-940, called at :979).  Its arithmetic: fp32 logits times scale,
// keys at or past n_valid masked, m = the row max, p = exp(s - m), l = the
// row sum, P = p / l rounded to bf16 BEFORE the P.V product (JAX's
// rounding point, kept at every N), P.V summed in fp32 and rounded once.
// Masked keys get -1e30 (never -inf: p = 0, no NaN) and add nothing to l.
// Exponentials are exp2 with log2(e) folded into the scale.
//
// Bound on this card: at the flagship's [256, 64, 2304] (4 heads of 192)
// one (image, head) is 4 x 64 x 64 x 192 = 3.1 MFLOP on 72 KB of q/k/v
// and 24 KB of output, ~33 flops a byte against the H100's ~295: the
// bytes bound the call (75.5 MB read, 25.2 MB written, 0.030 ms at
// 3.35 TB/s).  'hier''s [B, 64, 768] (4 heads of 64) is bound the same way.
// Design: a persistent grid of min(items, SMs x blocks an SM) blocks,
// where an item is one (image, head, 64-query tile) and block i walks
// items i, i + grid, ...  A block is one producer warp and one consumer
// warpgroup (160 threads).
//  * The producer's one thread keeps the next items' bytes in flight by
//    TMA: the Q tile into a two-slot buffer, K and V tiles (64 keys x Dh)
//    into a ring of kStages slots, each 64-row tile as Dh / 64 boxes of
//    map_bnhd over the packed projection (row stride 3*H*Dh, Dh 192 read
//    as three 64-column sub-heads), 128-byte swizzled; rows past n read
//    as zero.  Two Q slots and four K/V slots hold item i + 1's tiles
//    (72 KB at Dh 192) while item i computes and stores.
//  * The consumer warpgroup computes S = Q.K^T by wgmma from the swizzled
//    tiles (Dh / 16 k16 steps; the accumulator in registers, each thread
//    two rows), then:
//    - one pass where the row is one 64-key tile (n_valid <= 64: the
//      flagship and 'hier''s level layers, at both head dims): mask, the
//      row max and sum across each row's quad of threads, P = exp(s - m)
//      / l in fp32 rounded once to bf16 as the register A operand, and
//      O = P.V by wgmma (Dh / 64 m64n64 products a k16 step, V read
//      through the transpose bit).  K is read once.
//    - two passes over the same ring's 64-key tiles for longer rows (to
//      1,024; 'hier''s fusion layers at 192): the first keeps the running
//      max and rescaled sum, the second recomputes each logits tile and
//      adds bf16(P).V.  The logits are computed twice, as #8's single K
//      step does, to keep the rounding point at any N.
//    Rows longer than 64 keys do not stay in registers: at Dh 192, O is
//    96 registers a thread and S 32; a 128-key row would add 32 more.
//  * The epilogue rounds O to bf16 into a two-slot 128-byte-swizzled
//    staging tile and writes it by TMA store (rows at or past n are not
//    written), so the store overlaps the next item.
// Shared memory: (2 Q + kStages K/V + 2 staging) x Dh x 128 bytes: 197,728
// bytes at Dh 192 (one block an SM), 66,656 at Dh 64 (three).  Every
// wgmma group is waited on at once (fixed wait counts, no branch between
// a wgmma and its wait).

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BM = 64;                  // queries an item, keys a tile
constexpr int kMaxN = 1024;             // the Python PACKED_MAX_N
constexpr int kStages = 4;              // K/V ring slots
constexpr int kConsumerThreads = 128;   // one warpgroup
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kBox = 64 * 128;          // one 64-row x 64-column swizzled box, bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int kTile = DH / 64 * kBox;  // a 64-row tile of one head
  unsigned char q[2][kTile];
  unsigned char kv[kStages][kTile];
  unsigned char o[2][kTile];
  uint64_t q_full[2], q_empty[2];
  uint64_t kv_full[kStages], kv_empty[kStages];
};
template <int DH>
constexpr int kSmemBytes = sizeof(Smem<DH>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap qkv, out;  // 64-column sub-heads: 3 H Dh / 64 of qkv, H Dh / 64 of out
  int heads, n_valid, q_tiles, k_tiles, items;
  float scale_log2;  // scale * log2(e)
};

template <int DH, bool kOnePass>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 3 : 1)
    packed_attn_sm90(const __grid_constant__ Params p) {
  constexpr int C = DH / 64;
  constexpr int kTile = Smem<DH>::kTile;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem<DH>& sm = hw::aligned_smem<Smem<DH>>(dyn);
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
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // producer: one thread starts every TMA load
    if (lane == 0) {
      hw::Ring<2> qr;
      hw::Ring<kStages> kr;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int qt = item % p.q_tiles, bh = item / p.q_tiles;
        const int h = bh % p.heads, b = bh / p.heads;
        // A 64-row tile of sub-heads sub0 .. sub0 + C - 1 from row row0.
        auto load = [&](unsigned char* dst, uint64_t* bar, int sub0, int row0) {
          hw::bar_expect_tx(bar, kTile);
#pragma unroll
          for (int c = 0; c < C; ++c)
            hw::tma_load4(dst + c * kBox, &p.qkv, bar, 0, sub0 + c, row0, b);
        };
        hw::bar_wait(&sm.q_empty[qr.slot], qr.phase ^ 1);  // the first pass finds every slot free
        load(sm.q[qr.slot], &sm.q_full[qr.slot], h * C, qt * BM);
        qr.next();
        auto kv = [&](int sub0, int t) {
          hw::bar_wait(&sm.kv_empty[kr.slot], kr.phase ^ 1);
          load(sm.kv[kr.slot], &sm.kv_full[kr.slot], sub0, t * BM);
          kr.next();
        };
        const int ksub = (p.heads + h) * C, vsub = (2 * p.heads + h) * C;
        if constexpr (!kOnePass)
          for (int t = 0; t < p.k_tiles; ++t) kv(ksub, t);
        for (int t = 0; t < p.k_tiles; ++t) {
          kv(ksub, t);
          kv(vsub, t);
        }
      }
    }
    return;
  }

  // Consumers: this thread holds query rows r0 and r0 + 8 of the item's
  // tile, and in S the keys 8 j + c0 + {0, 1} of the key tile.
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const float c = p.scale_log2;
  hw::Ring<2> qr;
  hw::Ring<kStages> kr;
  int ob = 0;  // staging slot
  float s[32], o[C][32];
  uint32_t pf[4][4];
  const unsigned char* qs = nullptr;

  // S = Q . K^T (raw logits) for the K tile in the ring's current slot,
  // which is then released.
  auto logits = [&]() {
    hw::bar_wait(&sm.kv_full[kr.slot], kr.phase);
    const unsigned char* ks = sm.kv[kr.slot];
    hw::fence_regs(s);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hw::wgmma_ss<0, 0>(s, hw::desc_sw128(qs + (kk / 4) * kBox) + 2 * (kk % 4),
                         hw::desc_sw128(ks + (kk / 4) * kBox) + 2 * (kk % 4), kk);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    if (lane == 0) hw::bar_arrive(&sm.kv_empty[kr.slot]);
    kr.next();
  };
  // Keys at or past n_valid to -1e30 (raw logits of key tile t).
  auto mask = [&](int t) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (t * BM + 8 * (i / 4) + c0 + (i % 2) >= p.n_valid) s[i] = sfc::kNegInf;
  };
  // O += bf16(P) . V for the V tile in the ring's current slot (P in s),
  // which is then released.
  auto pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, pf[kk]);
    hw::bar_wait(&sm.kv_full[kr.slot], kr.phase);
    const unsigned char* vs = sm.kv[kr.slot];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
    hw::fence_frags(pf);
    hw::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::wgmma_rs<1>(o[cc], pf[kk], hw::desc_sw128(vs + cc * kBox) + kk * (2048 >> 4), 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
#pragma unroll
    for (int cc = 0; cc < C; ++cc) hw::fence_regs(o[cc]);
    hw::fence_frags(pf);
    if (lane == 0) hw::bar_arrive(&sm.kv_empty[kr.slot]);
    kr.next();
  };
  // The max of each of this thread's two rows over its quad, in log2 units.
  auto row_max = [&](float (&mx)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = sfc::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) v = fmaxf(v, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      mx[hf] = v * c;
    }
  };

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int qt = item % p.q_tiles, bh = item / p.q_tiles;
    const int h = bh % p.heads, b = bh / p.heads;
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cc][i] = 0.f;
    hw::bar_wait(&sm.q_full[qr.slot], qr.phase);
    qs = sm.q[qr.slot];

    float m[2], l[2] = {0.f, 0.f};
    if constexpr (kOnePass) {
      logits();
      mask(0);
      row_max(m);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = hw::exp2_approx(fmaf(s[i], c, -m[(i / 2) % 2]));
        l[(i / 2) % 2] += s[i];
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
      inv[hf] = 1.f / l[hf];
    }
    if constexpr (kOnePass) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= inv[(i / 2) % 2];
      pv();
    } else {
      // Pass 2: P = exp(s - m) / l rounded to bf16, then O += P . V.
      for (int t = 0; t < p.k_tiles; ++t) {
        logits();
        if (t == p.k_tiles - 1) mask(t);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hf = (i / 2) % 2;
          s[i] = hw::exp2_approx(fmaf(s[i], c, -m[hf])) * inv[hf];
        }
        pv();
      }
    }
    if (lane == 0) hw::bar_arrive(&sm.q_empty[qr.slot]);  // the last logits product has read Q
    qr.next();

    // Epilogue: O rounded once to bf16 into staging slot ob, then one TMA
    // store a 64-column sub-head.  The store that read this slot two items
    // ago must have finished reading it.
    unsigned char* st = sm.o[ob];
    if (tid == 0) hw::bulk_wait_read<1>();
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
        hw::tma_store4(&p.out, st + cc * kBox, 0, h * C + cc, qt * BM, b);
      hw::bulk_commit();
    }
    ob ^= 1;
  }
  if (tid == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

template <int DH, bool kOnePass>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = packed_attn_sm90<DH, kOnePass>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, kSmemBytes<DH>, p.items, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, kSmemBytes<DH>, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// qkv bf16 [batch, n, 3 * heads * dh] contiguous, on 16 bytes; out bf16
// [batch, n, heads * dh] contiguous.  Keys at or past n_valid (1 <=
// n_valid <= n) are masked.  dh must be 64 or 192, n at most 1,024.
extern "C" int sfc_packed_attention_bf16(const void* qkv, void* out, int batch, int n, int heads,
                                         int dh, int n_valid, float scale, void* stream) {
  if ((dh != 64 && dh != 192) || heads < 1 || n < 1 || n > kMaxN || n_valid < 1 || n_valid > n ||
      batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int subs = heads * dh / 64;
  const long long row = 3LL * heads * dh;
  Params p{};
  cudaError_t e = hw::map_bnhd(&p.qkv, qkv, batch, n, 3 * subs, row * n, row, 64, BM);
  if (e == cudaSuccess)
    e = hw::map_bnhd(&p.out, out, batch, n, subs, static_cast<long long>(n) * heads * dh,
                     static_cast<long long>(heads) * dh, 64, BM);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.heads = heads;
  p.n_valid = n_valid;
  p.q_tiles = (n + BM - 1) / BM;
  p.k_tiles = (n_valid + BM - 1) / BM;
  p.items = batch * heads * p.q_tiles;
  p.scale_log2 = scale * kLog2e;
  const bool one = p.k_tiles == 1;
  auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64) e = one ? launch<64, true>(p, s) : launch<64, false>(p, s);
  else e = one ? launch<192, true>(p, s) : launch<192, false>(p, s);
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the instance for head dim
// dh (64 or 192) and the one-pass (1) or two-pass (0) form, into out[3].
extern "C" int sfc_packed_attention_attrs(int dh, int one_pass, int* out) {
  if (dh == 64)
    return one_pass ? hw::kernel_attrs(packed_attn_sm90<64, true>, kSmemBytes<64>, out)
                    : hw::kernel_attrs(packed_attn_sm90<64, false>, kSmemBytes<64>, out);
  if (dh == 192)
    return one_pass ? hw::kernel_attrs(packed_attn_sm90<192, true>, kSmemBytes<192>, out)
                    : hw::kernel_attrs(packed_attn_sm90<192, false>, kSmemBytes<192>, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
