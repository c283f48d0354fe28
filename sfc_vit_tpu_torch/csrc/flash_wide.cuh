// Building blocks of the bf16 flash kernels at head dims 128 and 256
// (#8, #10, #11 and the curve-local #12/#13 in bfloat16: the wide
// instances of csrc/flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu; #9 at those head dims is the dq and dk/dv
// kernels).
//
// A head of Dh = 64 C columns is C sub-heads of 64.  A sub-block is 64
// rows x one sub-head of one (batch, head), bf16, 128-byte swizzled as TMA
// writes it (sm90.cuh::map_strided_heads with 64-row boxes): 8 KB, the
// layout of a Dh 64 tile, so every product is the Dh 64 kernels' m64n64k16
// wgmma on it, K-major or through the transpose bit.  A block is one
// warpgroup (128 threads) over 64 rows of one (b, h), two blocks an SM
// (255 registers a thread; the Dh 64 kernels' nine warps cap a thread at
// 168, where a 128- or 256-column output beside the logits does not fit).
// The rows a block owns come once (`res`, resident sub-blocks, on their
// own barrier); thread 0 keeps a ring of NS sub-blocks of the other side
// in flight by TMA, entries in the order the block consumes them.  After
// the products that read a group of entries are done (wgmma_wait), the
// block's barrier frees their slots and thread 0 refills them.  An output
// of C sub-heads is held CO at a time beside the logits: a kernel walks
// its tiles C / CO times, recomputing the logits each walk.
#pragma once

#include "sm90.cuh"

namespace sfc {
namespace flash_wide {

namespace hw = sfc::sm90;

constexpr int kThreads = 128;     // one warpgroup a block
constexpr int kSub = 64 * 128;    // one 64 x 64 bf16 sub-block, bytes
constexpr int kStepBytes = 2048;  // a k16 step of an MN-major sub-block (16 rows)

// R resident sub-blocks, a ring of NS, two 64-row fp32 vectors (the dk/dv
// kernel's lse and delta of a query tile) and the barriers.
template <int R, int NS>
struct Smem {
  unsigned char res[R][kSub];
  unsigned char ring[NS][kSub];
  float vec[2][64];
  uint64_t res_full;
  uint64_t full[NS];
};
template <int R, int NS>
constexpr int kSmemBytes = sizeof(Smem<R, NS>) + 1024;  // + the 1,024-byte alignment

// One ring entry: a sub-block of a map at sub-head c, rows row .. row + 63.
struct Entry {
  const CUtensorMap* map;
  int c, row;
};

// The ring's cursors: e, the next entry the block consumes; issued (thread
// 0's), the next entry to load; entries, how many the walk has.
struct Cursor {
  int e = 0, issued = 0, entries = 0;
};

// Thread 0: load entries up to `upto` (each into the slot its entry NS
// before freed), of head h, image b; `of(i)` gives entry i.
template <int R, int NS, typename Of>
__device__ __forceinline__ void feed(Smem<R, NS>& sm, Cursor& cur, int upto, int h, int b,
                                     Of&& of) {
  for (; cur.issued < upto && cur.issued < cur.entries; ++cur.issued) {
    const Entry en = of(cur.issued);
    const int slot = cur.issued % NS;
    hw::bar_expect_tx(&sm.full[slot], kSub);
    hw::tma_load4(sm.ring[slot], en.map, &sm.full[slot], 64 * en.c, h, en.row, b);
  }
}

// The slot of the next entry once it has landed; the cursor moves on.
template <int R, int NS>
__device__ __forceinline__ const unsigned char* take(Smem<R, NS>& sm, Cursor& cur) {
  const int e = cur.e++;
  hw::bar_wait(&sm.full[e % NS], (e / NS) & 1);
  return sm.ring[e % NS];
}

// Every product issued so far is done; the slots of the entries consumed
// so far are free, and thread 0 refills them.
template <int R, int NS, typename Of>
__device__ __forceinline__ void release(Smem<R, NS>& sm, Cursor& cur, int h, int b, Of&& of) {
  hw::wgmma_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0) feed(sm, cur, cur.e + NS, h, b, of);
}

// Barriers set, the block's resident sub-blocks (map `ma` sub-heads 0 ..
// RA - 1 into res[0 ..], then map `mb`'s into the rest, rows row0 ..) and
// the ring's first entries in flight.
template <int RA, int R, int NS, typename Of>
__device__ __forceinline__ void start(Smem<R, NS>& sm, Cursor& cur, const CUtensorMap* ma,
                                      const CUtensorMap* mb, int row0, int h, int b, Of&& of) {
  if (threadIdx.x == 0) {
    hw::bar_init(&sm.res_full, 1);
    for (int s = 0; s < NS; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::bar_expect_tx(&sm.res_full, R * kSub);
    for (int r = 0; r < R; ++r)
      hw::tma_load4(sm.res[r], r < RA ? ma : mb, &sm.res_full, 64 * (r < RA ? r : r - RA), h,
                    row0, b);
    feed(sm, cur, NS, h, b, of);
  }
  hw::bar_wait(&sm.res_full, 0);
}

// The descriptors of the ring's next N entries, each waited for: taken
// before a group's wgmma_fence, so no wait and no register a product reads
// is defined between its products (ptxas then injects no warpgroup
// arrive or wait).
template <int N, int R, int NS>
__device__ __forceinline__ void take_descs(Smem<R, NS>& sm, Cursor& cur, uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = hw::desc_sw128(take(sm, cur));
}

// acc (+)= A_c B_c^T summed over sub-heads c < C, both K-major sub-blocks:
// A the resident res[a0 + c], B the ring's next C entries.  Issued and
// committed, not waited for.
template <int C, int R, int NS>
__device__ __forceinline__ void logits(Smem<R, NS>& sm, Cursor& cur, float (&acc)[32], int a0) {
  uint64_t db[C];
  take_descs(sm, cur, db);
  const uint64_t da = hw::desc_sw128(sm.res[a0]);  // res[a0 + c] is kSub c bytes on
  hw::wgmma_fence();
  sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
    constexpr int c = decltype(Cc)::value;
    sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value;
      hw::wgmma_ss_at<0, 0, c * (kSub >> 4) + 2 * kk, 2 * kk>(acc, da, db[c], c > 0 || kk > 0);
    });
  });
  hw::wgmma_commit();
}

// acc (m64n64 over 64 columns of a sub-head) += A X, A the bf16 fragments
// of four k16 steps in registers (the rows of X's 64), X an MN-major
// sub-block at descriptor dx.  Not committed.
__device__ __forceinline__ void product_t(float (&acc)[32], const uint32_t (&a)[4][4],
                                          uint64_t dx) {
  sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
    constexpr int kk = decltype(K)::value;
    hw::wgmma_rs_at<1, kk * (kStepBytes >> 4)>(acc, a[kk], dx, 1);
  });
}

// x = hi + lo as bf16 pairs: one k16 step's A fragment (sm90.cuh::split_a
// of eight values a thread holds, in fragment order).
__device__ __forceinline__ void split8(const float (&x)[8], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h);
    lo[e] = hw::pack_bf16x2(x[2 * e] - hf.x, x[2 * e + 1] - hf.y);
  }
}

// The backward kernels' maps of q, k, v, g (bf16 [B, N, H, dh] through
// their (batch, row, head) strides st, k and v over nk rows, q and g over
// nq), 64-row boxes.
inline cudaError_t map_qkvg(CUtensorMap* q, CUtensorMap* k, CUtensorMap* v, CUtensorMap* g,
                            const void* const (&bases)[4], int batch, int heads, int nq,
                            int nk, int dh, const long long (&st)[12]) {
  CUtensorMap* maps[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e =
        hw::map_strided_heads(maps[i], bases[i], false, batch, i == 1 || i == 2 ? nk : nq,
                              heads, dh, st[3 * i], st[3 * i + 1], st[3 * i + 2], 64);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Calls f(C) (an integral constant) for the sub-heads of the wide head
// dims: 128 and 256 give C = 2, 4; false for any other dh.
template <typename F>
bool with_wide(int dh, F&& f) {
  switch (dh) {
    case 128: f(std::integral_constant<int, 2>{}); return true;
    case 256: f(std::integral_constant<int, 4>{}); return true;
    default: return false;
  }
}

}  // namespace flash_wide
}  // namespace sfc
