// Building blocks of the bf16 flash kernels at head dims 128 and 256
// (#8, #10, #11 and the curve-local #12/#13 in bfloat16: the wide
// instances of csrc/flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and
// flash_bwd_dkv_sm90.cu; #9 at those head dims is the dq and dk/dv
// kernels).
//
// A head of Dh = 64 C columns is C sub-heads of 64.  A sub-block is 64
// rows x one sub-head of one (batch, head), bf16, 128-byte swizzled as TMA
// writes it (sm90.cuh::map_strided_heads with 64-row boxes): 8 KB, the
// layout of a Dh 64 tile, so every product is a wgmma on it, K-major or
// through the transpose bit.
//
// The streamed attention backward (csrc/attention_bwd_stream_sm90.cu)
// builds on Smem .. product_t below: R resident 64-row sub-blocks, a ring
// of NS sub-blocks through TMA, the logits of a 64 x 64 tile summed over
// the sub-heads, and P V with A from registers.
//
// The forward (kFwdThreads .. pv_tile below, the wide instances of #8 and
// #12 in csrc/flash_fwd_sm90.cu): a block is two warpgroups over 128
// queries of one (b, h), one block an SM (255 registers a thread, no
// producer warp).  Q's 2 C sub-blocks stay resident; a ring of entries of
// K or V, each fwd_keys(C) keys of all C sub-heads on one full barrier
// (one expect_tx), is kept in flight by TMA in the order the block
// consumes it.  Each slot also has an empty barrier on which every warp
// arrives once its own wgmma_wait has retired the products that read the
// slot: no block-wide barrier in the walk.  See csrc/flash_fwd_sm90.cu for
// the walk itself.
//
// The backward (BwdSmem .. bwd_wide below, the dq kernel #10 and the dk/dv
// kernel #11 and their windowed instances, #13): one walk over the other
// side's 64-row tiles at every head dim, each tile's operands read once;
// see bwd_wide.
#pragma once

#include "sm90.cuh"

namespace sfc {
namespace flash_wide {

namespace hw = sfc::sm90;

constexpr int kThreads = 128;     // one warpgroup a block
constexpr int kSub = 64 * 128;    // one 64 x 64 bf16 sub-block, bytes
constexpr int kStepBytes = 2048;  // a k16 step of an MN-major sub-block (16 rows)

// R resident sub-blocks, a ring of NS, two 64-row fp32 vectors (the
// streamed attention backward's lse and delta of a tile) and the barriers.
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

// The ring's cursors: e, the next entry the block consumes; issued (thread
// 0's), the next entry to load; entries, how many the walk has.
struct Cursor {
  int e = 0, issued = 0, entries = 0;
};

// The slot of the next entry once it has landed; the cursor moves on.
template <int R, int NS>
__device__ __forceinline__ const unsigned char* take(Smem<R, NS>& sm, Cursor& cur) {
  const int e = cur.e++;
  hw::bar_wait(&sm.full[e % NS], (e / NS) & 1);
  return sm.ring[e % NS];
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

// ------------------------------------------------------------- forward

constexpr int kFwdThreads = 256;  // two warpgroups a block
// Keys a ring entry of the forward holds: 128 at Dh 128 (the logits then
// one m64n128 product a k16 step), 64 at Dh 256; an entry is 32 KB either
// way (C sub-heads of fwd_keys(C) rows, each sub-head's rows contiguous).
__host__ __device__ constexpr int fwd_keys(int C) { return C == 2 ? 128 : 64; }
// Slots of the forward's ring beside Q's 2 C sub-blocks in the block's
// 227 KB.
__host__ __device__ constexpr int fwd_slots(int C) { return C == 2 ? 6 : 5; }

template <int C>
struct FwdSmem {
  unsigned char q[2][C][kSub];  // warpgroup w's 64 queries, sub-heads 0 .. C - 1
  unsigned char ring[fwd_slots(C)][C * fwd_keys(C) * 128];  // fwd_keys(C) keys of K or V
  uint64_t q_full, full[fwd_slots(C)], empty[fwd_slots(C)];
  int issued;  // the ring's next entry to load, claimed by either warpgroup
};
template <int C>
constexpr int kFwdSmemBytes = sizeof(FwdSmem<C>) + 1024;  // + the 1,024-byte alignment

using hw::bar_test;

// o (m64n(64 C), fp32; o[c] the columns 64 c ..) += A . X: A's k16 step
// from registers, X MN-major (the transpose bit) at the descriptor dx +
// OB, its C 64-column swizzle atoms the descriptor's leading byte offset
// apart.
template <int OB>
__device__ __forceinline__ void pv_n128_at(float (&o)[2][32], const uint32_t (&a)[4], uint64_t dx) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %70, 0;\n"
      " add.s64 b, %68, %69;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, b, p, 1, 1, 1;\n}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]), "+f"(o[0][4]),
        "+f"(o[0][5]), "+f"(o[0][6]), "+f"(o[0][7]), "+f"(o[0][8]), "+f"(o[0][9]),
        "+f"(o[0][10]), "+f"(o[0][11]), "+f"(o[0][12]), "+f"(o[0][13]), "+f"(o[0][14]),
        "+f"(o[0][15]), "+f"(o[0][16]), "+f"(o[0][17]), "+f"(o[0][18]), "+f"(o[0][19]),
        "+f"(o[0][20]), "+f"(o[0][21]), "+f"(o[0][22]), "+f"(o[0][23]), "+f"(o[0][24]),
        "+f"(o[0][25]), "+f"(o[0][26]), "+f"(o[0][27]), "+f"(o[0][28]), "+f"(o[0][29]),
        "+f"(o[0][30]), "+f"(o[0][31]), "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]),
        "+f"(o[1][3]), "+f"(o[1][4]), "+f"(o[1][5]), "+f"(o[1][6]), "+f"(o[1][7]),
        "+f"(o[1][8]), "+f"(o[1][9]), "+f"(o[1][10]), "+f"(o[1][11]), "+f"(o[1][12]),
        "+f"(o[1][13]), "+f"(o[1][14]), "+f"(o[1][15]), "+f"(o[1][16]), "+f"(o[1][17]),
        "+f"(o[1][18]), "+f"(o[1][19]), "+f"(o[1][20]), "+f"(o[1][21]), "+f"(o[1][22]),
        "+f"(o[1][23]), "+f"(o[1][24]), "+f"(o[1][25]), "+f"(o[1][26]), "+f"(o[1][27]),
        "+f"(o[1][28]), "+f"(o[1][29]), "+f"(o[1][30]), "+f"(o[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dx), "n"(OB), "r"(1));
}

template <int OB>
__device__ __forceinline__ void pv_n256_at(float (&o)[4][32], const uint32_t (&a)[4], uint64_t dx) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %134, 0;\n"
      " add.s64 b, %132, %133;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, b, p, 1, 1, 1;\n}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]), "+f"(o[0][4]),
        "+f"(o[0][5]), "+f"(o[0][6]), "+f"(o[0][7]), "+f"(o[0][8]), "+f"(o[0][9]),
        "+f"(o[0][10]), "+f"(o[0][11]), "+f"(o[0][12]), "+f"(o[0][13]), "+f"(o[0][14]),
        "+f"(o[0][15]), "+f"(o[0][16]), "+f"(o[0][17]), "+f"(o[0][18]), "+f"(o[0][19]),
        "+f"(o[0][20]), "+f"(o[0][21]), "+f"(o[0][22]), "+f"(o[0][23]), "+f"(o[0][24]),
        "+f"(o[0][25]), "+f"(o[0][26]), "+f"(o[0][27]), "+f"(o[0][28]), "+f"(o[0][29]),
        "+f"(o[0][30]), "+f"(o[0][31]), "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]),
        "+f"(o[1][3]), "+f"(o[1][4]), "+f"(o[1][5]), "+f"(o[1][6]), "+f"(o[1][7]),
        "+f"(o[1][8]), "+f"(o[1][9]), "+f"(o[1][10]), "+f"(o[1][11]), "+f"(o[1][12]),
        "+f"(o[1][13]), "+f"(o[1][14]), "+f"(o[1][15]), "+f"(o[1][16]), "+f"(o[1][17]),
        "+f"(o[1][18]), "+f"(o[1][19]), "+f"(o[1][20]), "+f"(o[1][21]), "+f"(o[1][22]),
        "+f"(o[1][23]), "+f"(o[1][24]), "+f"(o[1][25]), "+f"(o[1][26]), "+f"(o[1][27]),
        "+f"(o[1][28]), "+f"(o[1][29]), "+f"(o[1][30]), "+f"(o[1][31]), "+f"(o[2][0]),
        "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]), "+f"(o[2][4]), "+f"(o[2][5]),
        "+f"(o[2][6]), "+f"(o[2][7]), "+f"(o[2][8]), "+f"(o[2][9]), "+f"(o[2][10]),
        "+f"(o[2][11]), "+f"(o[2][12]), "+f"(o[2][13]), "+f"(o[2][14]), "+f"(o[2][15]),
        "+f"(o[2][16]), "+f"(o[2][17]), "+f"(o[2][18]), "+f"(o[2][19]), "+f"(o[2][20]),
        "+f"(o[2][21]), "+f"(o[2][22]), "+f"(o[2][23]), "+f"(o[2][24]), "+f"(o[2][25]),
        "+f"(o[2][26]), "+f"(o[2][27]), "+f"(o[2][28]), "+f"(o[2][29]), "+f"(o[2][30]),
        "+f"(o[2][31]), "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[3][4]), "+f"(o[3][5]), "+f"(o[3][6]), "+f"(o[3][7]), "+f"(o[3][8]),
        "+f"(o[3][9]), "+f"(o[3][10]), "+f"(o[3][11]), "+f"(o[3][12]), "+f"(o[3][13]),
        "+f"(o[3][14]), "+f"(o[3][15]), "+f"(o[3][16]), "+f"(o[3][17]), "+f"(o[3][18]),
        "+f"(o[3][19]), "+f"(o[3][20]), "+f"(o[3][21]), "+f"(o[3][22]), "+f"(o[3][23]),
        "+f"(o[3][24]), "+f"(o[3][25]), "+f"(o[3][26]), "+f"(o[3][27]), "+f"(o[3][28]),
        "+f"(o[3][29]), "+f"(o[3][30]), "+f"(o[3][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dx), "n"(OB), "r"(1));
}

// acc (m64nKT) = A B^T summed over sub-heads c < C: A K-major sub-blocks
// at descriptor da (a warpgroup's Q, 8 KB apart), B a ring entry of K (KT
// keys a sub-head, KT x 128 bytes apart) at descriptor db.  Not committed.
// (A's sub-heads from registers instead, 16 registers each, was no faster
// once the ring fed both warpgroups, and in a walk that issued the logits
// alone gave wrong results: the registers an asynchronous product reads
// are not held for it.)
template <int C, int KT>
__device__ __forceinline__ void logits_tile(float (&acc)[KT / 2], uint64_t da, uint64_t db) {
  sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
    constexpr int c = decltype(Cc)::value;
    sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
      constexpr int kk = decltype(K)::value, oa = c * (kSub >> 4) + 2 * kk,
                    ob = c * (KT * 128 >> 4) + 2 * kk;
      if constexpr (KT == 64)
        hw::wgmma_ss_at<0, 0, oa, ob>(acc, da, db, c > 0 || kk > 0);
      else
        hw::wgmma_ss_n128_at<oa, ob>(acc, da, db, c > 0 || kk > 0);
    });
  });
}

// o (m64n(64 C), o[c] the columns 64 c ..) += A X over a ring entry of V
// (dv its desc_sw128 descriptor): one product over all C sub-heads a k16
// step, A the bf16 fragments of the KT / 16 k16 steps in registers (P of
// the entry's keys), X MN-major through the transpose bit, its C 64-column
// swizzle atoms KT x 128 bytes apart.  Not committed.
template <int C, int KT>
__device__ __forceinline__ void pv_tile(float (&o)[C][32], const uint32_t (&a)[KT / 16][4],
                                        uint64_t dv) {
  // The leading byte offset (bits 16-29): the distance between the atoms.
  const uint64_t dx = (dv & ~(uint64_t(0x3FFF) << 16)) | (uint64_t(KT * 128 >> 4) << 16);
  sfc::static_for<KT / 16>([&](auto K) SFC_INLINE_LAMBDA {
    constexpr int kk = decltype(K)::value, off = kk * (kStepBytes >> 4);
    if constexpr (C == 2)
      pv_n128_at<off>(o, a[kk], dx);
    else
      pv_n256_at<off>(o, a[kk], dx);
  });
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

// ------------------------------------------------------------- backward
//
// The dq kernel (#10) and the dk/dv kernel (#11) at Dh 128 and 256, and
// their windowed instances (#13), are one device function, bwd_wide.  A
// block is two warpgroups (256 threads, one block an SM, 255 registers a
// thread) over 64 rows of one (b, h), its "own" rows: queries for dq,
// keys for dk/dv.  Its own X and Y come once (res: dq's Q and G, dk/dv's
// K and V, C sub-blocks each); the other side's 64-row tiles (dq's K and
// V, dk/dv's Q and G with their lse and delta rows) come whole, one tile
// a stage, through a ring of bwd_stages(C) stages that thread 0 keeps in
// flight by TMA.  For each tile, once:
//  SD  warpgroup w computes the logits and the cotangent's products of the
//      other side's 32 rows 32 w .. 32 w + 31 of the tile against all 64
//      own rows, summed over the C sub-heads (m64n32 wgmma, both operands
//      K-major from shared memory): s and dp for dq, s^T and dp^T for
//      dk/dv.  Each (own row, other row) pair's s and dp is computed once.
//  E   p = exp2(s scale log2e - lse log2e) and ds = p (dp - delta) scale
//      in fp32, other rows at or past their end giving p = 0, each split
//      into bf16 hi + lo (the formula's two-term split), packed in
//      registers.
//  X   the packed values into the block's exchange tiles (64 own rows x 64
//      other rows, K-major, 128-byte swizzled: ds hi, ds lo, and for
//      dk/dv p hi, p lo), the two warpgroups writing one half each.
//  PV  warpgroup w adds the tile's products into its half of each output's
//      columns, sub-heads C/2 w .. C/2 w + C/2 - 1: dq += ds K, or dk +=
//      ds^T Q and dv += p^T G (A the exchange tiles, B the ring's
//      sub-blocks through the transpose bit; m64n64 per sub-head, hi then
//      lo into one fp32 accumulator).
// Executed work per (own row, other row, column): SD 4 operations, PV 4
// (dq) or 8 (dk/dv): the formula's 8 and 12 units at every head dim.
// Overlap: a warpgroup issues the next tile's SD and this tile's PV
// together; its E runs while PV is on the tensor cores (with at least
// three stages, SD first, so E waits for SD only); with two stages (Dh
// 256, where a stage is 64 KB) PV goes first and the wait for the next
// tile's loads runs beside it.  Two block barriers a tile: A after both
// warpgroups' PV of the previous tile is done (the exchange tiles and that
// tile's stage are free: thread 0 refills the stage with the tile
// bwd_stages(C) on), B after both halves of the exchange tiles are written
// (fence.proxy.async first: generic writes read by wgmma).  Each output
// row and column has one owner and one fp32 sum in a fixed order: the
// same bits on every call, no atomics, no reduce-add.  (Issuing the next
// tile's SD before barrier A with two sets of exchange tiles, so that the
// barriers run beside it, made ptxas crash (a segfault), or with wgmma_wait<0>
// before the barrier serialize the wgmma, C7514.)

using hw::kRowBox;
using hw::kRowSlot;
constexpr int kBwdThreads = 256;
// Stages of the ring: at Dh 256 a stage is 64 KB, and two fill the block's
// 227 KB beside the resident rows and the exchange tiles.
__host__ __device__ constexpr int bwd_stages(int C) { return C == 2 ? 4 : 2; }

template <int C, bool kDkv>
struct BwdSmem {
  unsigned char res[2 * C][kSub];                  // own rows: X's sub-heads, then Y's
  unsigned char ring[bwd_stages(C)][2 * C][kSub];  // a tile of the other side: X, then Y
  unsigned char x[kDkv ? 4 : 2][kSub];             // ds hi, ds lo (, p hi, p lo)
  float vec[kDkv ? bwd_stages(C) : 1][2][kRowSlot];  // dk/dv: each stage's lse and delta
  uint64_t res_full, full[bwd_stages(C)];
};
template <int C, bool kDkv>
constexpr int kBwdSmemBytes = sizeof(BwdSmem<C, kDkv>) + 1024;  // + the 1,024-byte alignment

struct BwdParams {
  CUtensorMap q, k, v, g;            // map_strided_heads over [B, N, H, Dh], 64-row boxes
  CUtensorMap lse_rows, delta_rows;  // dk/dv: lse and delta as [B H Nq] rows, kRowBox boxes
  const float *lse, *delta;          // [B, H, Nq]; dq reads its own rows' plainly
  bf16 *o0, *o1;                     // dq; or dk, dv: [B, N, H, Dh] contiguous
  int heads, dh, nq, nk;
  int block, halo;                   // the windowed instance's curve block and halo
  float scale, scale_log2;
};

// d (m64n32, fp32) = A . B (+ d when accumulate), both K-major from shared
// memory at the descriptors da + OA and db + OB (16-byte units).
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n32_at(float (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %18, 0;\n"
      " add.s64 a, %16, %19;\n add.s64 b, %17, %20;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", a, b, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

// x0, x1 = hi + lo, each a bf16 pair (the two-term split of fp32 p and ds).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hw::pack_bf16x2(x0 - hf.x, x1 - hf.y);
}

// C: sub-heads (2 or 4).  kDkv: the dk/dv kernel (own rows keys), else dq
// (own rows queries).  kWindow: #13's instance, over the other side's
// tiles of the block's curve-local window (nq == nk).
template <int C, bool kDkv, bool kWindow>
__device__ __forceinline__ void bwd_wide(const BwdParams& p) {
  constexpr int S = bwd_stages(C), H2 = C / 2, NX = kDkv ? 4 : 2;
  constexpr bool kSdFirst = S >= 3;
  constexpr int kSubU = kSub >> 4;  // a sub-block in descriptor units
  using Sm = BwdSmem<C, kDkv>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  Sm& sm = hw::aligned_smem<Sm>(dyn);
  const int tid = threadIdx.x, w = tid / 128, lane = tid % 32;
  const int r0 = 16 * ((tid / 32) % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int bh = blockIdx.y, heads = p.heads, b = bh / heads, h = bh % heads;
  const int nq = p.nq, nk = p.nk, n_own = kDkv ? nk : nq, n_other = kDkv ? nq : nk;
  const int row0 = blockIdx.x * 64;
  const float scale = p.scale, scale_log2 = p.scale_log2;
  int t0 = 0, t1 = (n_other + 63) / 64;
  if constexpr (kWindow) hw::local_tile_window(blockIdx.x, 64, n_other, p.block, p.halo, t0, t1);
  const int tiles = t1 - t0;
  // dk/dv: the first lse / delta row of the (b, h)'s boxes, and query 0's
  // offset in them (tiles start on 64 rows).
  const int rbase = kDkv ? hw::rows_start(bh * nq) : 0, roff = bh * nq - rbase;

  // Thread 0: tile t0 + u of the other side (X's C sub-blocks, Y's, and
  // for dk/dv its lse and delta rows) into stage u % S.
  auto load = [&](int u) SFC_INLINE_LAMBDA {
    const int st = u % S, row = 64 * (t0 + u);
    uint64_t* bar = &sm.full[st];
    hw::bar_expect_tx(bar, 2 * C * kSub + (kDkv ? 2 * kRowBox * 4 : 0));
    for (int c = 0; c < C; ++c) {
      hw::tma_load4(sm.ring[st][c], kDkv ? &p.q : &p.k, bar, 64 * c, h, row, b);
      hw::tma_load4(sm.ring[st][C + c], kDkv ? &p.g : &p.v, bar, 64 * c, h, row, b);
    }
    if constexpr (kDkv) {
      hw::tma_load1(sm.vec[st][0], &p.lse_rows, bar, rbase + row);
      hw::tma_load1(sm.vec[st][1], &p.delta_rows, bar, rbase + row);
    }
  };
  if (tid == 0) {
    hw::bar_init(&sm.res_full, 1);
    for (int s = 0; s < S; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hw::bar_expect_tx(&sm.res_full, 2 * C * kSub);
    for (int c = 0; c < C; ++c) {
      hw::tma_load4(sm.res[c], kDkv ? &p.k : &p.q, &sm.res_full, 64 * c, h, row0, b);
      hw::tma_load4(sm.res[C + c], kDkv ? &p.v : &p.g, &sm.res_full, 64 * c, h, row0, b);
    }
    for (int u = 0; u < S && u < tiles; ++u) load(u);
  }

  // dq: its rows' lse (log2 units) and delta, read once; rows past nq read
  // 0 (their s and dp are 0: their ds is 0, and they are never stored).
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + r0 + 8 * hf;
      if (row < nq) {
        const long long at = static_cast<long long>(bh) * nq + row;
        lse2[hf] = p.lse[at] * hw::kLog2e;
        dl[hf] = p.delta[at];
      }
    }
  }

  float o0[H2][32], o1[kDkv ? H2 : 1][32], s[16], dp[16];
  uint32_t pk[NX][8];  // E's packed words: ds hi, ds lo (, p hi, p lo); (jj, hf) at 2 jj + hf
#pragma unroll
  for (int cc = 0; cc < H2; ++cc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o0[cc][i] = o1[kDkv ? cc : 0][i] = 0.f;
  const uint64_t d_res = hw::desc_sw128(sm.res[0]), d_x = hw::desc_sw128(sm.x[0]);

  // SD of the tile in stage st: s (s^T) and dp (dp^T) of this warpgroup's
  // 32 other rows, committed.
  auto sd = [&](int st) SFC_INLINE_LAMBDA {
    const uint64_t db = hw::desc_sw128(sm.ring[st][0]) + (64 * 32 * 2 >> 4) * w;
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value;
      sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
        constexpr int kk = decltype(K)::value;
        wgmma_ss_n32_at<c * kSubU + 2 * kk, c * kSubU + 2 * kk>(s, d_res, db, c > 0 || kk > 0);
      });
    });
    sfc::static_for<C>([&](auto Cc) SFC_INLINE_LAMBDA {
      constexpr int c = decltype(Cc)::value + C;
      sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
        constexpr int kk = decltype(K)::value;
        wgmma_ss_n32_at<c * kSubU + 2 * kk, c * kSubU + 2 * kk>(dp, d_res, db,
                                                                c > C || kk > 0);
      });
    });
    hw::wgmma_commit();
  };
  // PV of the tile in stage st, from the exchange tiles: this warpgroup's
  // sub-heads of dq (dk, and dv), committed.
  auto pv = [&](int st) SFC_INLINE_LAMBDA {
    const uint64_t db = hw::desc_sw128(sm.ring[st][0]) + H2 * kSubU * w;
    sfc::static_for<H2>([&](auto CC) SFC_INLINE_LAMBDA {
      constexpr int cc = decltype(CC)::value;
      sfc::static_for<4>([&](auto K) SFC_INLINE_LAMBDA {
        constexpr int kk = decltype(K)::value, ob = cc * kSubU + kk * (kStepBytes >> 4);
        hw::wgmma_ss_at<0, 1, 2 * kk, ob>(o0[cc], d_x, db, 1);
        hw::wgmma_ss_at<0, 1, kSubU + 2 * kk, ob>(o0[cc], d_x, db, 1);
        if constexpr (kDkv) {
          hw::wgmma_ss_at<0, 1, 2 * kSubU + 2 * kk, ob + C * kSubU>(o1[cc], d_x, db, 1);
          hw::wgmma_ss_at<0, 1, 3 * kSubU + 2 * kk, ob + C * kSubU>(o1[cc], d_x, db, 1);
        }
      });
    });
    hw::wgmma_commit();
  };
  // Every register the two chains below write, fenced once before one
  // wgmma_fence: an operand fence between two chains in flight made ptxas
  // serialize the wgmma (C7515).
  auto fence_all = [&]() SFC_INLINE_LAMBDA {
#pragma unroll
    for (int cc = 0; cc < H2; ++cc) {
      hw::fence_regs(o0[cc]);
      if constexpr (kDkv) hw::fence_regs(o1[cc]);
    }
    hw::fence_regs(s);
    hw::fence_regs(dp);
    hw::wgmma_fence();
  };
  // E of tile t0 + u in stage st: p and ds of this thread's 16 elements,
  // split and packed into pk.
  auto elementwise = [&](int u, int st) SFC_INLINE_LAMBDA {
    hw::fence_regs(s);
    hw::fence_regs(dp);
    const int other0 = 64 * (t0 + u) + 32 * w;  // the warpgroup's first other row
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float l2[2], dd[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jj + c0 + e;
        ok[e] = other0 + col < n_other;
        if constexpr (kDkv) {
          l2[e] = sm.vec[st][0][roff + 32 * w + col] * hw::kLog2e;
          dd[e] = sm.vec[st][1][roff + 32 * w + col];
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float pe[2], dse[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hf + e;
          const float lg = kDkv ? l2[e] : lse2[hf], de = kDkv ? dd[e] : dl[hf];
          pe[e] = ok[e] ? hw::exp2_approx(s[i] * scale_log2 - lg) : 0.f;
          dse[e] = pe[e] * (dp[i] - de) * scale;
        }
        split2(dse[0], dse[1], pk[0][2 * jj + hf], pk[1][2 * jj + hf]);
        if constexpr (kDkv) split2(pe[0], pe[1], pk[2][2 * jj + hf], pk[3][2 * jj + hf]);
      }
    }
  };

  hw::bar_wait(&sm.res_full, 0);
  hw::bar_wait(&sm.full[0], 0);
  fence_all();  // the outputs' zeros too: defined before the first chain
  sd(0);
  for (int u = 0; u < tiles; ++u) {
    const int st = u % S;
    if (kSdFirst && u > 0)
      hw::wgmma_wait<1>();  // SD(u) done; PV(u - 1) may still run beside E
    else
      hw::wgmma_wait<0>();
    elementwise(u, st);
    hw::wgmma_wait<0>();  // this warpgroup's PV(u - 1) done
    hw::fence_async_shared();
    __syncthreads();  // A: both warpgroups' PV(u - 1) done
    if (tid == 0 && u > 0 && u - 1 + S < tiles) load(u - 1 + S);  // into u - 1's stage
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(sm.x[x] +
                                       hw::sw128_bf16(r0 + 8 * hf, 32 * w + 8 * jj + c0)) =
              pk[x][2 * jj + hf];
    hw::fence_async_shared();
    __syncthreads();  // B: the exchange tiles written
    // The next tile's SD, or on the last tile a repeat of this one's (its
    // stage has landed; the result is never read), so the commit groups
    // keep one order and no branch sits between the chains.
    const bool more = u + 1 < tiles;
    const int nst = more ? (u + 1) % S : st;
    const uint32_t nph = ((more ? u + 1 : u) / S) & 1;
    if constexpr (kSdFirst) {
      hw::bar_wait(&sm.full[nst], nph);
      fence_all();
      sd(nst);
      pv(st);
    } else {  // the wait for the next tile's loads beside this tile's PV
      fence_all();
      pv(st);
      hw::bar_wait(&sm.full[nst], nph);
      hw::wgmma_fence();
      sd(nst);
    }
  }
  hw::wgmma_wait<0>();
#pragma unroll
  for (int cc = 0; cc < H2; ++cc) {
    hw::fence_regs(o0[cc]);
    if constexpr (kDkv) hw::fence_regs(o1[cc]);
  }

  // Each thread's rows r0 and r0 + 8 of its sub-heads, rounded once.
  const int dh = p.dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + r0 + 8 * hf;
    if (row >= n_own) continue;
#pragma unroll
    for (int cc = 0; cc < H2; ++cc) {
      const long long off = (static_cast<long long>(b) * n_own + row) * heads * dh +
                            static_cast<long long>(h) * dh + 64 * (H2 * w + cc) + c0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        *reinterpret_cast<uint32_t*>(p.o0 + off + 8 * jj) =
            hw::pack_bf16x2(o0[cc][4 * jj + 2 * hf], o0[cc][4 * jj + 2 * hf + 1]);
        if constexpr (kDkv)
          *reinterpret_cast<uint32_t*>(p.o1 + off + 8 * jj) =
              hw::pack_bf16x2(o1[cc][4 * jj + 2 * hf], o1[cc][4 * jj + 2 * hf + 1]);
      }
    }
  }
}

// The launch of a wide backward kernel: grid (own row tiles, B H), two
// warpgroups a block.
template <typename Kernel>
inline cudaError_t launch_bwd(Kernel kernel, int smem, const BwdParams& p, int batch,
                              cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_own = p.o1 ? p.nk : p.nq;
  const dim3 grid((n_own + 63) / 64, batch * p.heads);
  kernel<<<grid, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The backward parameters (dh 128 or 256): maps of q, k, v, g through
// their (batch, row, head) element strides st, and for dk/dv (o1 not
// null) lse's and delta's row boxes.
inline cudaError_t bwd_params(BwdParams* p, const void* q, const void* k, const void* v,
                              const void* g, const void* lse, const void* delta, void* o0,
                              void* o1, int batch, int heads, int nq, int nk, int dh,
                              const long long (&st)[12], float scale, int block, int halo) {
  cudaError_t e = map_qkvg(&p->q, &p->k, &p->v, &p->g, {q, k, v, g}, batch, heads, nq, nk, dh, st);
  if (e == cudaSuccess && o1) {
    const long long rows = static_cast<long long>(batch) * heads * nq;
    e = hw::map_f32_rows(&p->lse_rows, lse, rows, kRowBox);
    if (e == cudaSuccess) e = hw::map_f32_rows(&p->delta_rows, delta, rows, kRowBox);
  }
  if (e != cudaSuccess) return e;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->o0 = static_cast<bf16*>(o0);
  p->o1 = static_cast<bf16*>(o1);
  p->heads = heads;
  p->dh = dh;
  p->nq = nq;
  p->nk = nk;
  p->block = block;
  p->halo = halo;
  p->scale = scale;
  p->scale_log2 = scale * hw::kLog2e;
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
