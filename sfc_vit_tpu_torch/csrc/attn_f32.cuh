// Building blocks of the fp32 attention kernels for Hopper
// (csrc/packed_attn_f32.cu: the forward of #1, #5 and #7;
// csrc/attention_bwd_f32.cu: the backward of #4 and #6;
// csrc/flash_fwd_f32.cu and flash_bwd_f32.cu: #8-#13, whose two-warpgroup
// blocks read A fragments by a_frag_wg) and of the probe's
// permuted form (csrc/wgmma_probe.cu): every fp32 product as three TF32
// products on wgmma (3xTF32, csrc/gemm_f32.cu's split: a_big b_small +
// a_small b_big + a_big b_big, in that order in every k8 step), from 64 x
// 64 sub-blocks that a TMA ring brings.
//
// A sub-block is 64 rows x 64 fp32 columns of one (image, head): a 64-row
// tile of a 64-column sub-head (the head at Dh 64, a third of it at Dh
// 192, columns past a ragged head's Dh zero), landed by two boxes of
// map_heads as two 128-byte-swizzled [64 rows][32] halves 8 KB apart.
// Rows past n land as zero.  In that
// layout a sub-block is
//  * an A operand read from shared memory into registers (a_frag): thread
//    t's k8 step kk is rows r0, r0 + 8 at columns 8 kk + t % 4 and + 4, and
//    the eight rows of a quarter warp fall on eight distinct 16-byte chunks;
//  * once split elementwise (split_kmajor), the big and small K-major B
//    operands of a product that contracts along its rows' 64 columns (S =
//    Q K^T with B = K, dP = dA V^T with B = V), 32-bit wgmma taking B only
//    K-major;
//  * once transposed and split (split_transposed), the K-major B operands
//    of a product that contracts over its 64 rows (P V with B = V^T, dq =
//    dS K with B = K^T, dv = P^T dA, dk = dS^T Q).
//
// The key permutation.  The A operand of P V (and of dS K, P^T dA, dS^T Q)
// is an m64nN accumulator of the previous product, held in registers.
// Thread t holds accumulator columns 8 j + 2 (t % 4) + {0, 1}, but a TF32 A
// fragment of a k8 step holds columns t % 4 and t % 4 + 4 (sm90.cuh).  So
// rather than shuffle, the contraction runs over each group of 8 keys in
// a permuted order: logical column c < 4 is key 2 c, c >= 4 is key 2 (c -
// 4) + 1.  The fragment of group j is then (d[4 j], d[4 j + 2], d[4 j + 1],
// d[4 j + 3]) (a_perm), and split_transposed writes the rows of B^T in the
// same order.  A sum over keys is the same sum in another fp32 order.
#pragma once

#include "sm90.cuh"

namespace sfc {
namespace attn_f32 {

namespace hw = sfc::sm90;

constexpr int kThreads = 128;     // one warpgroup a block
constexpr int kHalf = 64 * 128;   // one 32-column half of a sub-block, bytes
constexpr int kSub = 2 * kHalf;   // a 64 x 64 fp32 sub-block, bytes

// A block's shared memory: a ring of NS sub-blocks, the split pair (big
// and small, one product's B operand), two 64-row fp32 vectors (the
// backward's lse and delta) and a 64 x 64 tile of the mask (on 512 bytes,
// 64-byte swizzled: sm90.cuh::sw64_u8), with its own barrier.
template <int NS>
struct Smem {
  unsigned char ring[NS][kSub];
  unsigned char big[kSub];
  unsigned char small[kSub];
  float vec[2][64];
  alignas(512) unsigned char mask[64 * 64];
  uint64_t full[NS];
  uint64_t mask_full;
};
template <int NS>
constexpr int kSmemBytes = sizeof(Smem<NS>) + 1024;  // + the 1,024-byte alignment

using hw::fresh_tid;

// Byte offset of element (row, col) of a sub-block (col < 64).
__device__ __forceinline__ int sub_at(int row, int col) {
  return (col >> 5) * kHalf + hw::sw128_f32(row, col & 31);
}

// Descriptor offset, in 16-byte units, of k8 step kk (< 8) of a K-major
// operand in sub-block layout: 32 bytes along the rows, then the next half.
__host__ __device__ constexpr int step_off(int kk) {
  return (kk / 4) * (kHalf >> 4) + 2 * (kk % 4);
}

// Sub-block entry e of a ring of the first RING slots (all NS by
// default): its slot and the parity of its fill.
template <int RING = 0, int NS>
__device__ __forceinline__ void wait_entry(Smem<NS>& sm, int e) {
  constexpr int R = RING > 0 ? RING : NS;
  hw::bar_wait(&sm.full[e % R], (e / R) & 1);
}

// TMA: the sub-block of an fp32 map_heads `map` at head `head`, 64-column
// sub-head c (the boxes at columns 64 c and 64 c + 32; zeros past the
// head's dh), rows row .. row + 63 of image b, into ring slot `slot`.
template <int NS>
__device__ __forceinline__ void load_sub(Smem<NS>& sm, int slot, const CUtensorMap* map, int head,
                                         int c, int row, int b) {
  uint64_t* bar = &sm.full[slot];
  hw::bar_expect_tx(bar, kSub);
  hw::tma_load4(sm.ring[slot], map, bar, 64 * c, head, row, b);
  hw::tma_load4(sm.ring[slot] + kHalf, map, bar, 64 * c + 32, head, row, b);
}

// This thread's A values of k8 step kk from a sub-block in shared memory,
// in fragment order: (r0, 8 kk + tq), (r0 + 8, ...), (r0, 8 kk + tq + 4),
// (r0 + 8, ...) with r0 = 16 (t / 32) + (t % 32) / 4 and tq = t % 4.
__device__ __forceinline__ void a_frag(const unsigned char* sb, int kk, float (&v)[4]) {
  const int t = fresh_tid(), r0 = 16 * (t >> 5) + ((t >> 2) & 7), tq = t & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = *reinterpret_cast<const float*>(
        sb + sub_at(r0 + 8 * (e & 1), 8 * kk + tq + 4 * (e >> 1)));
}

// a_frag for thread t % 128 of a block of warpgroups, each over its own
// 64-row sub-block.
__device__ __forceinline__ void a_frag_wg(const unsigned char* sb, int kk, float (&v)[4]) {
  const int t = fresh_tid() & 127, r0 = 16 * (t >> 5) + ((t >> 2) & 7), tq = t & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = *reinterpret_cast<const float*>(
        sb + sub_at(r0 + 8 * (e & 1), 8 * kk + tq + 4 * (e >> 1)));
}

// The A values of key group j (logical k8 step j) from an m64nN
// accumulator under the key permutation.
template <int R>
__device__ __forceinline__ void a_perm(const float (&d)[R], int j, float (&v)[4]) {
  v[0] = d[4 * j];
  v[1] = d[4 * j + 2];
  v[2] = d[4 * j + 1];
  v[3] = d[4 * j + 3];
}

// The sub-block `raw` split elementwise into big and small (the same
// layout: K-major operands whose contraction runs along the rows), the
// thread's eight 16-byte chunks of the 1,024.
__device__ __forceinline__ void split_kmajor(const unsigned char* raw, unsigned char* big,
                                             unsigned char* small) {
  const int t = fresh_tid();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = t + kThreads * i;
    const float4 v = reinterpret_cast<const float4*>(raw)[c];
    uint4 hi, lo;
    hw::tf32_split(v.x, hi.x, lo.x);
    hw::tf32_split(v.y, hi.y, lo.y);
    hw::tf32_split(v.z, hi.z, lo.z);
    hw::tf32_split(v.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(big)[c] = hi;
    reinterpret_cast<uint4*>(small)[c] = lo;
  }
}

// The sub-block `raw` (rows: the contraction index, 64 keys or queries;
// columns: the product's 64 output columns) transposed and split into big
// and small K-major tiles whose row n holds column n of raw, its 64
// logical columns in the key permutation (logical column 4 q + i, chunk q,
// holds raw row 8 (q / 2) + q % 2 + 2 i).  A thread moves 4 rows x 4
// columns at a time, 16-byte loads and stores; the map of thread bits to
// (chunk q, column chunk nc) puts each quarter warp's eight loads and its
// eight stores on eight distinct 16-byte chunks of a row (no bank
// conflicts): q's low three bits are the lane's, nc's second and third are
// the lane's second and third xor higher bits.
__device__ __forceinline__ void split_transposed(const unsigned char* raw, unsigned char* big,
                                                 unsigned char* small) {
  const int t = fresh_tid();
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int u = t + kThreads * it;
    const int q = u & 15;
    const int nc = ((u >> 6) & 1) | ((((u >> 1) ^ (u >> 4)) & 1) << 1) |
                   ((((u >> 2) ^ (u >> 5)) & 1) << 2) | (((u >> 7) & 1) << 3);
    float v[4][4];  // [i][y]: raw row 8 (q / 2) + q % 2 + 2 i, column 4 nc + y
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * (q >> 1) + (q & 1) + 2 * i;
      const float4 x = *reinterpret_cast<const float4*>(raw + (nc >> 3) * kHalf + r * 128 +
                                                        ((((nc & 7) ^ r) & 7) << 4));
      v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int n = 4 * nc + y;
      const int off = (q >> 3) * kHalf + n * 128 + ((((q & 7) ^ n) & 7) << 4);
      uint4 hi, lo;
      hw::tf32_split(v[0][y], hi.x, lo.x);
      hw::tf32_split(v[1][y], hi.y, lo.y);
      hw::tf32_split(v[2][y], hi.z, lo.z);
      hw::tf32_split(v[3][y], hi.w, lo.w);
      *reinterpret_cast<uint4*>(big + off) = hi;
      *reinterpret_cast<uint4*>(small + off) = lo;
    }
  }
}

// Ring entry eb (a B operand) split into the pair, plainly or transposed,
// once the pair's last product is done (the ring is its first RING slots,
// all NS by default); after the barrier every thread is done with the
// entry's slot.
template <int RING = 0, int NS>
__device__ __forceinline__ void split_entry(Smem<NS>& sm, int eb, bool transposed) {
  constexpr int R = RING > 0 ? RING : NS;
  wait_entry<R>(sm, eb);
  hw::wgmma_wait<0>();
  const unsigned char* raw = sm.ring[eb % R];
  if (transposed) split_transposed(raw, sm.big, sm.small);
  else split_kmajor(raw, sm.big, sm.small);
  hw::fence_async_shared();
  __syncthreads();
}

// acc (m64nN, N = 64 or 8) = A . B (+ acc when accumulate) over k8 steps
// 0 .. STEPS - 1 of a 64-deep contraction, B the split pair (K-major: big
// at db, small at dsm).  a_of(step, v) gives this thread's A values of a
// step (a std::integral_constant step), split here into one of two
// fragment buffers; a step first waits until the group two back, which
// read that buffer, is done.  Each step's three products, a_big b_small +
// a_small b_big + a_big b_big, are one commit group; without accumulate
// the first of step 0 overwrites acc, so no thread instruction zeroes an
// accumulator that products of another may still be writing.
template <int N, int STEPS, typename AOf>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], uint64_t db, uint64_t dsm, AOf&& a_of,
                                     uint32_t (&big)[2][4], uint32_t (&small)[2][4],
                                     int accumulate) {
  static_assert(N == 64 || N == 8, "an m64n64 or m64n8 product");
  sfc::static_for<STEPS>([&](auto K) SFC_INLINE_LAMBDA {
    constexpr int kk = decltype(K)::value, f = kk % 2, off = step_off(kk);
    hw::wgmma_wait<1>();
    hw::fence_regs(acc);
    hw::fence_frags(big);
    hw::fence_frags(small);
    float v[4];
    a_of(K, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) hw::tf32_split(v[e], big[f][e], small[f][e]);
    hw::wgmma_fence();
    const int first = kk == 0 ? accumulate : 1;
    if constexpr (N == 64) {
      hw::wgmma_tf32_rs_n64_at<off>(acc, big[f], dsm, first);
      hw::wgmma_tf32_rs_n64_at<off>(acc, small[f], db, 1);
      hw::wgmma_tf32_rs_n64_at<off>(acc, big[f], db, 1);
    } else {
      hw::wgmma_tf32_rs_n8_at<off>(acc, big[f], dsm, first);
      hw::wgmma_tf32_rs_n8_at<off>(acc, small[f], db, 1);
      hw::wgmma_tf32_rs_n8_at<off>(acc, big[f], db, 1);
    }
    hw::wgmma_commit();
  });
}

// Every product issued so far is done, and its accumulators are readable.
template <int R>
__device__ __forceinline__ void drain(float (&acc)[R]) {
  hw::wgmma_wait<0>();
  hw::fence_regs(acc);
}

// The split pair's descriptors, big and small.
template <int NS>
__device__ __forceinline__ void pair_desc(const Smem<NS>& sm, uint64_t& db, uint64_t& dsm) {
  db = hw::desc_sw128(sm.big);
  dsm = hw::desc_sw128(sm.small);
}

}  // namespace attn_f32
}  // namespace sfc
