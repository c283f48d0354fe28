// C = epilogue(op(A) @ op(B)) in float32, the products on the tensor cores
// as three TF32 products (3xTF32): the matrix products of the fused blocks
// (#1-#4) and of the family-A attention chains (#5, #6) when a model
// computes in float32 (the ViT-B/16 and ViT-S/16 presets at their own
// dtype=None, the reference notebook's VisionTransformer, and the flagship
// at its own dtype=None).
//
// Replaces, for float32 compute: the products inside
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (line 104:
// the QKV projection, and the output projection + the residual) and
// ::_attn_block_bwd_kernel (line 333: datt = g W_out^T and dxn = dqkv
// W_qkv^T, the NT forms; dW_out and dW_qkv, the TN forms),
// sfc_vit_tpu/ops/fused_mlp.py::_mlp_kernel (line 104: fc1 + b1 + GELU
// with z saved, fc2 + b2 + the residual) and ::_mlp_bwd_kernel (line 237:
// dz = (g W2^T) GELU'(z) with db1 = colsum(dz), dxn = dz W1^T; dW2, dW1),
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (line 82:
// the packed QKV projection and the output projection, each with its bias
// added to the fp32 sum) and ::_torch_mha_bwd_kernel (line 270: datt =
// g W_out^T and dx = dqkv W_in^T, the NT forms; dW_out = att^T g and
// dW_in = x^T dqkv summed over every row, the TN forms).  The TPU kernels
// take any dtype and accumulate in fp32 (preferred_element_type).
//
// The epilogue, per element of the fp32 sum, in this order: + bias[n];
// the pre-activation written to z_out; then either x act'(z_in) (the
// backward's dz) or act (exact-erf GELU or ReLU); the column sums of that
// value; + residual (fp32 [M, N]).  The column sums have one owner each
// and a fixed order, no atomics: each 128-row tile sums its own rows in a
// fixed order into a partial row of a workspace (after a split-K sum, each
// row is its own stripe), and a third kernel adds the stripes' partials in
// stripe order, so a second call gives the same bits.
//
// The split and its error.  The tensor cores take an fp32 operand as TF32
// (its top 19 bits: 10 mantissa bits, about three decimal digits; the 13
// below are dropped, not rounded: the probe in csrc/wgmma_probe.cu), and
// the port holds fp32 compute to the JAX package's fp32 to 1e-4 of the
// largest |value|.  So each operand x is written x = big + small, big =
// x rounded to TF32 (to nearest, ties away) and small = x - big (exact in
// fp32; the tensor cores truncate it to TF32), and a . b is summed as
// a_big b_small + a_small b_big + a_big b_big into one fp32 accumulator,
// in that order for every k8 step, so the bits repeat.  What is dropped,
// relative to |a b|: a_small b_small (|small| <= 2^-11 |x|: 2^-22) and
// the truncation of each small part (2^-10 of it: 2^-21 each), 1.25 x
// 2^-20 in all (tests/test_torch_tf32_split.py holds the plain twin
// ops/kernel_utils.py::matmul_3xtf32 to it against fp64).  The tensor
// cores' fp32 sums add more.  Against fp64 at ViT-B/16's shapes (H100,
// chip_smoke.py's GEMM lines, PERF.md section 6) the kernel's products err
// 3.3-6.4e-5 in the forward (K 768, 3,072) where torch.matmul fp32's err
// 4.8-8.6e-6, 2.0e-5 to 2.7e-4 in the NT backward (K 768-3,072) where
// torch's err 3.7e-6 to 3.3e-5, and 0.034-0.039 in the weight gradients
// (K 50,176, |values| to ~970) where torch's err 0.0013-0.0021: within
// the 1e-4 gate, not fp32's own rounding.
//
// Bound on this card: operations.  3xTF32 runs three TF32 products for
// each fp32 one: 495 / 3 = 165 TFLOP/s of fp32-accurate product on the
// H100 SXM, against 67 of fp32 FFMA outside the tensor cores.
//
// Design: a persistent grid, one block an SM, walks 128 x 128 output tiles
// (and, split over K, (split, tile) units), as csrc/gemm_bf16.cu does.  A
// ring of kStages stages holds 32-deep K slices of op(A) and op(B) as
// stored (TMA, 128-byte swizzled fp32 rows of 32 values: boxes of 64 rows
// x 32 k where the operand is K-major, of 32 k x 32 rows where it is
// MN-major), each guarded by a full mbarrier.  Two warpgroups own 64 rows
// of the tile each (m64n128k8 wgmma, 64 fp32 accumulators a thread):
//  * A from registers: each thread reads its k8 fragments from the staged
//    slice in either stored layout and splits them in registers (8 values
//    a k8 step, two steps held), step j + 1's while step j's three
//    products run;
//  * B from shared memory, K-major, as wgmma takes 32-bit operands: the
//    256 threads write the slice's b_big and b_small into two K-major
//    swizzled tiles (NN's and TN's B, stored [K, N], transposed through
//    registers 4 x 4 at a time; NT's, stored [N, K], in place), fence the
//    async proxy, and meet at a named barrier.  The split of slice s + 1
//    runs while slice s's products are in flight, into the third of three
//    buffers (slice s - 1's products may still be running on the second);
//    one barrier a slice, and no wait for the products but the one before
//    each k8 step for the step two back.
// There is no producer warp: the two warpgroups meet at a barrier after
// every slice anyway, so the slot of a slice is free after it, and thread
// 0 sends the TMA loads of the slice kStages on into it under the next
// slice's products (across tiles, so the next tile's first slices land
// during this one's epilogue).  With 256 threads
// a thread may hold 255 registers; a producer warp (288 threads) capped it
// at 168, and the transposing split spilled there (H100, CUDA 12.9).
// The epilogue stages the accumulators in the idle split buffers and each
// thread finishes 8 neighbouring columns of rows (16-byte accesses where
// N % 4 == 0, else one element at a time); the kernel is instantiated per
// layout and activation kind (none, act, act'), so no instance carries
// another's code.  Where an operand's rows are not a multiple of 16 bytes
// (TMA's stride rule: K or N not a multiple of 4), every thread fills the
// same swizzled tiles by plain loads, zero past the edges; TMA reads past
// the edges as zero.
//
// A product with too few output tiles to fill the card (the weight
// gradients, TN, summed over every row of the batch; the notebook's
// 2,048-row products) is split into contiguous K ranges
// (ops/_build.py::gemm_f32_split): each unit writes its partial tile to
// a workspace, and a second kernel sums the partials in split order and
// applies the whole epilogue to the sum, never to a partial, so the same
// inputs give the same bits.

#include <algorithm>

#include "sm90.cuh"

namespace {

namespace hw = sfc::sm90;

constexpr int BM = 128, BN = 128, BK = 32;  // BK: one 128-byte swizzled row of fp32
constexpr int kStages = 4;
constexpr int kThreads = 2 * 128;    // two warpgroups, 64 rows of the tile each
constexpr int kSlice = BM * BK * 4;  // 16 KB: one operand's K slice
// Named barriers: kBothBar both warpgroups, 2 + wg one's epilogue,
// kCsumBar the column sums.
constexpr int kBothBar = 1, kCsumBar = 4;

// What follows the sum, per element (the order of the file's header).
struct Epilogue {
  const float* bias;      // [N] or null
  const float* residual;  // [M, N] or null: added last
  const float* z_in;      // [M, N] or null: the value times act'(z_in) in place of act
  float* z_out;           // [M, N] or null: the pre-activation (the sum + bias)
  float* col;             // [stripes, N] or null: each row stripe's column sums
  int act;                // sfc::Act
};

// The shape of the call; the kernel copies it (and the Epilogue) out of
// the __grid_constant__ parameter into registers once.
struct Shape {
  int M, N, K, n_tiles, tiles, kblocks, per, units;
};

struct Params {
  CUtensorMap a, b;        // the operands as stored (unused with plain)
  const float* a_ptr;      // the same for plain loads
  const float* b_ptr;
  float* c;                // C fp32 [M, N]
  float* ws;               // split-K: fp32 [splits, M, N] raw sums; no epilogue here
  Shape sh;
  Epilogue ep;
  int plain;               // the stages are filled by plain loads
};

struct Smem {
  unsigned char a[kStages][kSlice];  // op(A)'s slice as stored
  unsigned char b[kStages][kSlice];  // op(B)'s slice as stored
  // Three buffers of op(B)'s slice split, K-major: big, then small.  After
  // a tile's products, buffer wg stages warpgroup wg's accumulators and
  // buffer 2 holds the column sums' warp partials.
  unsigned char split[3][2 * kSlice];
  uint64_t full[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

// Byte offset of element (r, k) of a 128-row slice as the ring stages it:
// K-major (the operand stored with K along its rows) as 128 rows of 32 k;
// MN-major as four boxes of 32 k-rows x 32 r.
template <bool KMAJOR>
__device__ __forceinline__ int slice_at(int r, int k) {
  return KMAJOR ? hw::sw128_f32(r, k) : (r >> 5) * 4096 + hw::sw128_f32(k, r & 31);
}

// Element (row, col) of a warpgroup's fp32 staging tile: rows of 128, the
// 8-column groups of row r permuted by r % 8 against bank conflicts.
__device__ __forceinline__ int stage_at(int row, int col) {
  return row * BN + (col ^ ((row & 7) << 3));
}

// One work unit: the output tile at (m0, n0) over K blocks [kb0, kb1).
struct Unit {
  int m0, n0, kb0, kb1, split;
};

__device__ __forceinline__ Unit unit_of(const Shape& sh, int u) {
  Unit w;
  w.split = u / sh.tiles;
  const int t = u % sh.tiles;
  w.m0 = (t / sh.n_tiles) * BM;
  w.n0 = (t % sh.n_tiles) * BN;
  w.kb0 = w.split * sh.per;
  w.kb1 = min(sh.kblocks, w.kb0 + sh.per);
  return w;
}

// Thread ct's part (of 256) of one slice of op(B), as stored, into its
// K-major big and small tiles (128 rows n of 32 k, 128-byte swizzled).
template <bool TB>
__device__ __forceinline__ void split_b(const unsigned char* raw, unsigned char* big,
                                        unsigned char* small, int ct) {
  if constexpr (TB) {  // stored [N, K]: already K-major, 16-byte chunks in place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ct + 256 * i;
      const float4 v = reinterpret_cast<const float4*>(raw)[c];
      uint4 hi, lo;
      hw::tf32_split(v.x, hi.x, lo.x);
      hw::tf32_split(v.y, hi.y, lo.y);
      hw::tf32_split(v.z, hi.z, lo.z);
      hw::tf32_split(v.w, hi.w, lo.w);
      reinterpret_cast<uint4*>(big)[c] = hi;
      reinterpret_cast<uint4*>(small)[c] = lo;
    }
  } else {
    // Stored [K, N] (four boxes of 32 k-rows x 32 n): a 4 x 4 block a thread,
    // k = 4 kq .. 4 kq + 3 by n = 32 q + 4 nc .. + 3, read as four 16-byte
    // rows along n and written as four 16-byte rows along k (a transpose in
    // registers).  The map of thread bits to (nc, kq) puts each quarter
    // warp's eight 16-byte loads, and its eight stores, on eight distinct
    // chunks of a 128-byte row (no bank conflicts): nc's low bits and kq's
    // lowest are the lane's three, kq's second is lane bits 0 ^ 1 ^ bit 3.
    const int l = ct % 8;
    const int nc = (l & 3) | (((ct >> 4) & 1) << 2);
    const int kq = (l >> 2) | (((((l ^ (l >> 1)) & 1) ^ ((ct >> 3) & 1))) << 1) |
                   (((ct >> 5) & 1) << 2);
    const int q = ct / 64;
    float v[4][4];  // [k - 4 kq][n - 32 q - 4 nc]
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int k = 4 * kq + x;
      const float4 r = *reinterpret_cast<const float4*>(raw + q * 4096 + k * 128 +
                                                        (((nc ^ k) & 7) << 4));
      v[x][0] = r.x, v[x][1] = r.y, v[x][2] = r.z, v[x][3] = r.w;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int n = 32 * q + 4 * nc + y, off = n * 128 + (((kq ^ n) & 7) << 4);
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

// What the epilogue applies between the bias and the column sums: the
// kernel is instantiated for each.
enum ActKind : int { kLinear = 0, kActFwd = 1, kActGrad = 2 };

__host__ __device__ constexpr int act_kind(bool z_in, int act) {
  return z_in ? kActGrad : act != sfc::kNone ? kActFwd : kLinear;
}

// Up to 8 neighbouring fp32 values at p (n of them; vec: all 8, on 16 bytes).
__device__ __forceinline__ void load8(float (&v)[8], const float* p, int n, bool vec) {
  if (vec) {
    const float4 x = reinterpret_cast<const float4*>(p)[0], y = reinterpret_cast<const float4*>(p)[1];
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8], int n, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) p[e] = v[e];
  }
}

// The epilogue's inputs at 8 neighbouring columns of one row.
struct In8 {
  float z[8], r[8];
};

__device__ __forceinline__ void load_in8(In8& in, size_t off, int n, bool vec,
                                         const Epilogue& ep) {
  if (ep.z_in != nullptr) load8(in.z, ep.z_in + off, n, vec);
  if (ep.residual != nullptr) load8(in.r, ep.residual + off, n, vec);
}

// The epilogue of the n (<= 8; 0 outside C) columns at offset off of C:
// + bias (b), z_out, act (kActFwd) or act'(z_in) (kActGrad), the column
// sums into cs, + residual, then C.  vec: 16-byte accesses.
template <int KIND>
__device__ __forceinline__ void finish8(float (&v)[8], size_t off, int n, bool vec,
                                        const float (&b)[8], const Epilogue& ep, const In8& in,
                                        float* C, float (&cs)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] += b[e];
  if (ep.z_out != nullptr) store8(ep.z_out + off, v, n, vec);
  if constexpr (KIND == kActGrad) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= sfc::act_grad(in.z[e], ep.act);
  } else if constexpr (KIND == kActFwd) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sfc::act_fwd(v[e], ep.act);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] += e < n ? v[e] : 0.f;
  if (ep.residual != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += in.r[e];
  }
  store8(C + off, v, n, vec);
}

// The bias at columns gc .. gc + n - 1 (zeros elsewhere and without one).
__device__ __forceinline__ void bias8(float (&b)[8], int gc, int n, const Epilogue& ep) {
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = ep.bias != nullptr && e < n ? ep.bias[gc + e] : 0.f;
}

// The ring's loads: the next (unit, K block) to bring in, kStages slices
// ahead of the products, across units.  Every thread keeps the same cursor.
struct Loader {
  int u, kb, kb1, m0, n0;
  hw::Ring<kStages> ring;

  __device__ void set(const Shape& sh) {
    if (u >= sh.units) return;
    const Unit w = unit_of(sh, u);
    kb = w.kb0;
    kb1 = w.kb1;
    m0 = w.m0;
    n0 = w.n0;
  }

  // The next slice into its ring slot (none once every unit is loaded): by
  // TMA from thread 0, or (plain) by every thread's loads, element by
  // element, zero past the edges.
  template <bool TA, bool TB>
  __device__ void next(const Params& p, const Shape& sh, Smem& sm, bool plain, int tid) {
    while (u < sh.units && kb >= kb1) {  // a unit is done (or has no K blocks)
      u += gridDim.x;
      set(sh);
    }
    if (u >= sh.units) return;
    unsigned char* a = sm.a[ring.slot];
    unsigned char* b = sm.b[ring.slot];
    const int k0 = kb * BK;
    if (!plain) {
      if (tid == 0) {
        uint64_t* bar = &sm.full[ring.slot];
        hw::bar_expect_tx(bar, 2 * kSlice);
        // Box coordinates are (inner, outer) of the operand as stored.
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (TA) hw::tma_load2(a + q * 4096, &p.a, bar, m0 + 32 * q, k0);
          else if (q < 2) hw::tma_load2(a + q * 8192, &p.a, bar, k0, m0 + 64 * q);
          if (TB) {
            if (q < 2) hw::tma_load2(b + q * 8192, &p.b, bar, k0, n0 + 64 * q);
          } else {
            hw::tma_load2(b + q * 4096, &p.b, bar, n0 + 32 * q, k0);
          }
        }
      }
    } else {
      const float* A = p.a_ptr;
      const float* B = p.b_ptr;
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK, gk = k0 + e % BK, gm = m0 + r, gn = n0 + r;
        float va = 0.f, vb = 0.f;
        if (gm < sh.M && gk < sh.K)
          va = TA ? A[static_cast<size_t>(gk) * sh.M + gm] : A[static_cast<size_t>(gm) * sh.K + gk];
        if (gn < sh.N && gk < sh.K)
          vb = TB ? B[static_cast<size_t>(gn) * sh.K + gk] : B[static_cast<size_t>(gk) * sh.N + gn];
        *reinterpret_cast<float*>(a + slice_at<!TA>(r, e % BK)) = va;
        *reinterpret_cast<float*>(b + slice_at<TB>(r, e % BK)) = vb;
      }
    }
    ring.next();
    ++kb;
  }
};

template <bool TA, bool TB, int KIND>
__global__ void __launch_bounds__(kThreads, 1) gemm_f32_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Shape sh = p.sh;
  const bool plain = p.plain != 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::bar_init(&sm.full[s], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  // The ring starts full; after each slice's products, the slot it held
  // takes the slice kStages on.  Plain loads land at least one barrier
  // before they are read.
  Loader ld{static_cast<int>(blockIdx.x), 0, 0, 0, 0, {}};
  ld.set(sh);
  for (int s = 0; s < kStages; ++s) ld.next<TA, TB>(p, sh, sm, plain, tid);

  // Warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile; this thread's
  // A rows ra and ra + 8, its accumulator rows r0 and r0 + 8 of the
  // warpgroup's, columns 8 j + c0 + {0, 1}.
  const int t = tid % 128, wg = warp / 4;
  const int tq = lane % 4, r0 = 16 * (t / 32) + lane / 4, c0 = 2 * tq;
  const int ra = 64 * wg + r0;
  const int M = sh.M, N = sh.N;
  float* const C = p.c;
  float* const ws = p.ws;
  hw::Ring<kStages> ring;
  float acc[64];
  uint32_t big[2][4], small[2][4];  // two k8 steps' A fragments, split
  // This thread's A fragment element e of k8 step j in a staged slice.
  auto a_at = [&](const unsigned char* a, int j, int e) {
    return *reinterpret_cast<const float*>(
        a + slice_at<!TA>(ra + 8 * (e & 1), 8 * j + tq + 4 * (e >> 1)));
  };

  for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
    const Unit w = unit_of(sh, u);
    const int nkb = w.kb1 - w.kb0;
    hw::named_sync(kBothBar, kThreads);  // the last tile's staging (the split buffers) is read
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float a0[4];  // step 0's A values of the next slice, read ahead
    if (nkb > 0) {
      if (!plain) hw::bar_wait(&sm.full[ring.slot], ring.phase);
      split_b<TB>(sm.b[ring.slot], sm.split[0], sm.split[0] + kSlice, tid);
      hw::fence_async_shared();
#pragma unroll
      for (int e = 0; e < 4; ++e) a0[e] = a_at(sm.a[ring.slot], 0, e);
    }
    hw::named_sync(kBothBar, kThreads);
    int sb = 0;         // the split buffer of slice i
    bool load = false;  // a slot was read at the last barrier: it takes the slice kStages on
    for (int i = 0; i < nkb; ++i) {
      const unsigned char* a = sm.a[ring.slot];
      const uint64_t db = hw::desc_sw128(sm.split[sb]);
      const uint64_t ds = hw::desc_sw128(sm.split[sb] + kSlice);
      // Two k8 steps' fragments in registers, one commit group a step: before
      // step j, the step two back (which read the registers of step j) is
      // done, and step j's A is read and split while step j - 1's three
      // products run, across slices (the tensor cores never drain inside a
      // tile).
      hw::fence_regs(acc);
      sfc::static_for<4>([&](auto J) {
        constexpr int j = decltype(J)::value, f = j % 2;
        hw::wgmma_wait<1>();
        hw::fence_regs(acc);
        hw::fence_frags(big);
        hw::fence_frags(small);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hw::tf32_split(j == 0 ? a0[e] : a_at(a, j, e), big[f][e], small[f][e]);
        hw::wgmma_fence();  // the small terms first, then big . big
        hw::wgmma_tf32_rs_n128_at<2 * j>(acc, big[f], ds);
        hw::wgmma_tf32_rs_n128_at<2 * j>(acc, small[f], db);
        hw::wgmma_tf32_rs_n128_at<2 * j>(acc, big[f], db);
        hw::wgmma_commit();
      });
      ring.next();
      sb = sb == 2 ? 0 : sb + 1;
      // Under these products: the last slice's slot refilled, and the next
      // slice's B split (into the buffer of slice i - 2, whose products both
      // warpgroups finished before the last barrier) and step 0's A read.
      if (load) ld.next<TA, TB>(p, sh, sm, plain, tid);
      if (i + 1 < nkb) {
        if (!plain) hw::bar_wait(&sm.full[ring.slot], ring.phase);
        split_b<TB>(sm.b[ring.slot], sm.split[sb], sm.split[sb] + kSlice, tid);
        hw::fence_async_shared();
#pragma unroll
        for (int e = 0; e < 4; ++e) a0[e] = a_at(sm.a[ring.slot], 0, e);
      }
      // Both halves of slice i + 1's split are written, and slice i's raw
      // tiles are read (A into registers, B split before).
      hw::named_sync(kBothBar, kThreads);
      load = true;
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_frags(big);
    hw::fence_frags(small);
    hw::named_sync(kBothBar, kThreads);  // both warpgroups' products are done
    if (load) ld.next<TA, TB>(p, sh, sm, plain, tid);

    const int row0 = w.m0 + 64 * wg;
    if (ws != nullptr) {  // split-K: the raw fp32 sum of this K range
      float* part = ws + static_cast<size_t>(w.split) * M * N;
      const bool pair = N % 2 == 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gr = row0 + r0 + 8 * hf, gc = w.n0 + 8 * j + c0;
          if (gr >= M) continue;
          float* dst = part + static_cast<size_t>(gr) * N + gc;
          const float x = acc[4 * j + 2 * hf], y = acc[4 * j + 2 * hf + 1];
          if (pair && gc + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(x, y);
          } else {
            if (gc < N) dst[0] = x;
            if (gc + 1 < N) dst[1] = y;
          }
        }
      continue;
    }

    // The accumulators into this warpgroup's staging tile (a split buffer,
    // free after the barrier above); then each thread finishes 8
    // neighbouring columns of rows t / 16, t / 16 + 8, ...
    float* stage = reinterpret_cast<float*>(sm.split[wg]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(stage + stage_at(r0 + 8 * hf, 8 * j + c0)) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    hw::named_sync(2 + wg, 128);
    const Epilogue ep = p.ep;
    const int cc = t % 16, gc = w.n0 + 8 * cc;
    const int ncols = gc < N ? min(8, N - gc) : 0;
    const bool vec = N % 4 == 0 && ncols == 8;
    float cs[8] = {}, b[8];
    bias8(b, gc, ncols, ep);
    auto cols = [&](int rr) { return row0 + rr < M ? ncols : 0; };
    auto offset = [&](int rr) { return static_cast<size_t>(row0 + rr) * N + gc; };
    In8 next = {};
    if (cols(t / 16) > 0) load_in8(next, offset(t / 16), ncols, vec, ep);
    constexpr int kRowUnroll = KIND == kActGrad ? 2 : 4;  // rows interleaved
#pragma unroll kRowUnroll
    for (int rr = t / 16; rr < 64; rr += 8) {
      const In8 in = next;
      if (rr + 8 < 64 && cols(rr + 8) > 0) load_in8(next, offset(rr + 8), ncols, vec, ep);
      const float4* src = reinterpret_cast<const float4*>(stage + stage_at(rr, 8 * cc));
      const float4 x = src[0], y = src[1];
      float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      const int n = cols(rr);
      finish8<KIND>(v, offset(rr), n, vec && n == 8, b, ep, in, C, cs);
    }
    if (ep.col != nullptr) {  // the tile's column sums: rows in order, then the 8 warps in order
#pragma unroll
      for (int e = 0; e < 8; ++e) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
      float (*csum)[BN] = reinterpret_cast<float (*)[BN]>(sm.split[2]);  // [8 warps][BN]
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < 8; ++e) csum[warp][8 * cc + e] = cs[e];
      }
      hw::named_sync(kCsumBar, kThreads);
      if (tid < BN && w.n0 + tid < N) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 2 * 4; ++q) sum += csum[q][tid];
        ep.col[static_cast<size_t>(w.m0 / BM) * N + w.n0 + tid] = sum;
      }
    }
  }
}

// c = the sum over s of ws[s], in split order, through the whole epilogue,
// 8 neighbouring columns of a row a thread (grid-stride); with the column
// sums, e.col (a stripe a row) takes each value before the residual.
template <int KIND>
__global__ void __launch_bounds__(256)
    gemm_f32_sum_kernel(const float* __restrict__ ws, const Epilogue e, float* __restrict__ c,
                        int splits, int M, int N) {
  const Epilogue ep = e;
  const int chunks = (N + 7) / 8;
  const size_t mn = static_cast<size_t>(M) * N, total = static_cast<size_t>(M) * chunks;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(i / chunks), gc = static_cast<int>(i % chunks) * 8;
    const int n = min(8, N - gc);
    const bool vec = N % 4 == 0 && n == 8;
    const size_t off = static_cast<size_t>(m) * N + gc;
    float v[8] = {}, x[8];
    for (int z = 0; z < splits; ++z) {
      load8(x, ws + z * mn + off, n, vec);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += x[k];
    }
    In8 in = {};
    load_in8(in, off, n, vec, ep);
    float b[8], cs[8] = {};
    bias8(b, gc, n, ep);
    finish8<KIND>(v, off, n, vec, b, ep, in, c, cs);
    if (ep.col != nullptr) store8(ep.col + off, cs, n, vec);
  }
}

// out[n] = the sum over the stripes s < stripes of col[s][n], in a fixed
// order: warp w sums stripes w, w + 32, ... in turn, then warp 0 adds the
// 32 warp sums in warp order.  A block covers 32 consecutive columns.
__global__ void __launch_bounds__(1024)
    gemm_f32_colsum_kernel(const float* __restrict__ col, float* __restrict__ out, int stripes,
                           int N) {
  __shared__ float part[32][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (n < N)
    for (int r = w; r < stripes; r += 32) s += col[static_cast<size_t>(r) * N + n];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && n < N) {
    float total = part[0][lane];
#pragma unroll
    for (int k = 1; k < 32; ++k) total += part[k][lane];
    out[n] = total;
  }
}

// h = act(z) over n4 float4s, grid-stride.
__global__ void __launch_bounds__(256)
    act_f32_kernel(const float4* __restrict__ z, float4* __restrict__ h, size_t n4, int act) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = z[i];
    h[i] = make_float4(sfc::act_fwd(v.x, act), sfc::act_fwd(v.y, act), sfc::act_fwd(v.z, act),
                       sfc::act_fwd(v.w, act));
  }
}

template <bool TA, bool TB, int KIND>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = gemm_f32_sm90<TA, TB, KIND>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, kSmemBytes, p.sh.units, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_layout(const Params& p, bool trans_a, bool trans_b, cudaStream_t stream) {
  if (trans_a) return launch<true, false, KIND>(p, stream);
  if (trans_b) return launch<false, true, KIND>(p, stream);
  return launch<false, false, KIND>(p, stream);
}

// Kernel `form` of sfc_gemm_f32_attrs: layout (NN, NT, TN) x 3 + the act kind.
template <int F>
auto kernel_of() {
  return gemm_f32_sm90<F / 3 == 2, F / 3 == 1, F % 3>;
}

}  // namespace

// c (fp32 [M, N]) = the epilogue of op(a) @ op(b), a and b fp32: op(a) is
// a [M, K] or, with trans_a, a stored [K, M]; op(b) is b [K, N] or, with
// trans_b, b stored [N, K].  The epilogue (every pointer fp32, each may be
// null): + bias [N]; z_out [M, N] receives that pre-activation; x act'(z_in
// [M, N]) when z_in is given, else act (0 none, 1 exact-erf GELU, 2 ReLU);
// colsum [N] the column sums of that value (col, fp32 [stripes, N], their
// partials: stripes = ceil(M / 128) unsplit, M split); + residual [M, N].
// K is summed in ranges of `per` 32-deep blocks; more than one range needs
// ws (fp32, one [M, N] partial a range), and the epilogue then follows
// their sum.  trans_a and trans_b together are not instantiated.  Every
// pointer on 16 bytes (the Python wrapper checks).
extern "C" int sfc_gemm_f32(const void* a, const void* b, const void* bias,
                            const void* residual, const void* z_in, void* z_out, void* col,
                            void* colsum, void* c, void* ws, int M, int N, int K, int trans_a,
                            int trans_b, int per, int act, void* stream) {
  if (M < 0 || N < 0 || K < 0 || per < 1 || (trans_a && trans_b) ||
      (colsum != nullptr && col == nullptr) || (z_in != nullptr && act == sfc::kNone))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  Params p{};
  Shape& sh = p.sh;
  sh.M = M;
  sh.N = N;
  sh.K = K;
  sh.n_tiles = (N + BN - 1) / BN;
  sh.tiles = ((M + BM - 1) / BM) * sh.n_tiles;
  sh.kblocks = (K + BK - 1) / BK;
  sh.per = per;
  const int splits = sh.kblocks > per ? (sh.kblocks + per - 1) / per : 1;
  if (splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  sh.units = sh.tiles * splits;
  const Epilogue e{static_cast<const float*>(bias), static_cast<const float*>(residual),
                   static_cast<const float*>(z_in), static_cast<float*>(z_out),
                   colsum != nullptr ? static_cast<float*>(col) : nullptr, act};
  p.a_ptr = static_cast<const float*>(a);
  p.b_ptr = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  if (splits > 1) p.ws = static_cast<float*>(ws);
  else p.ep = e;
  // TMA needs rows (the strides) on 16 bytes: K-major operands' K, MN-major
  // ones' M or N a multiple of 4.
  const bool a_rows = trans_a ? M % 4 == 0 : K % 4 == 0;
  const bool b_rows = trans_b ? K % 4 == 0 : N % 4 == 0;
  p.plain = !(a_rows && b_rows);
  cudaError_t err = cudaSuccess;
  if (K > 0 && !p.plain) {
    err = trans_a ? hw::map_2d_f32(&p.a, a, M, K, 32) : hw::map_2d_f32(&p.a, a, K, M, 64);
    if (err == cudaSuccess)
      err = trans_b ? hw::map_2d_f32(&p.b, b, K, N, 64) : hw::map_2d_f32(&p.b, b, N, K, 32);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* s = static_cast<cudaStream_t>(stream);
  const int kind = act_kind(z_in != nullptr, act);
  if (splits > 1) err = launch_layout<kLinear>(p, trans_a, trans_b, s);  // raw partial sums
  else if (kind == kActGrad) err = launch_layout<kActGrad>(p, trans_a, trans_b, s);
  else if (kind == kActFwd) err = launch_layout<kActFwd>(p, trans_a, trans_b, s);
  else err = launch_layout<kLinear>(p, trans_a, trans_b, s);
  int stripes = (M + BM - 1) / BM;
  if (err == cudaSuccess && splits > 1) {
    stripes = M;
    const size_t work = static_cast<size_t>(M) * ((N + 7) / 8);
    const int blocks = static_cast<int>(std::min<size_t>((work + 255) / 256, 132 * 16));
    auto* W = static_cast<const float*>(ws);
    if (kind == kActGrad)
      gemm_f32_sum_kernel<kActGrad><<<blocks, 256, 0, s>>>(W, e, p.c, splits, M, N);
    else if (kind == kActFwd)
      gemm_f32_sum_kernel<kActFwd><<<blocks, 256, 0, s>>>(W, e, p.c, splits, M, N);
    else
      gemm_f32_sum_kernel<kLinear><<<blocks, 256, 0, s>>>(W, e, p.c, splits, M, N);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && colsum != nullptr) {
    gemm_f32_colsum_kernel<<<(N + 31) / 32, 1024, 0, s>>>(e.col, static_cast<float*>(colsum),
                                                         stripes, N);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// h (fp32) = act(z) elementwise over n fp32 values (n % 4 == 0, 16-byte
// aligned): the backward's GELU of the saved pre-activation.
extern "C" int sfc_act_f32(const void* z, void* h, long long n, int act, void* stream) {
  if (n < 0 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t n4 = static_cast<size_t>(n) / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  act_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(z), static_cast<float4*>(h), n4, act);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of form f into out[3]: f in 0..8
// the tile kernel of layout f / 3 (NN, NT, TN) and act kind f % 3 (none,
// act, act'), 9 the column sums' stripe sum.
extern "C" int sfc_gemm_f32_attrs(int form, int* out) {
  switch (form) {
    case 0: return hw::kernel_attrs(kernel_of<0>(), kSmemBytes, out);
    case 1: return hw::kernel_attrs(kernel_of<1>(), kSmemBytes, out);
    case 2: return hw::kernel_attrs(kernel_of<2>(), kSmemBytes, out);
    case 3: return hw::kernel_attrs(kernel_of<3>(), kSmemBytes, out);
    case 4: return hw::kernel_attrs(kernel_of<4>(), kSmemBytes, out);
    case 5: return hw::kernel_attrs(kernel_of<5>(), kSmemBytes, out);
    case 6: return hw::kernel_attrs(kernel_of<6>(), kSmemBytes, out);
    case 7: return hw::kernel_attrs(kernel_of<7>(), kSmemBytes, out);
    case 8: return hw::kernel_attrs(kernel_of<8>(), kSmemBytes, out);
    case 9: return hw::kernel_attrs(gemm_f32_colsum_kernel, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
