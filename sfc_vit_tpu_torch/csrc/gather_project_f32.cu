// The curve gather + projection of the fused tokenizers in float32 (#14):
// out[b, i] = concat_p x[b, lut[i * group + p]] @ w + bias, the product on
// the tensor cores as three TF32 products (3xTF32), the bias added to the
// fp32 sum.
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/gather_project.py::_kernel
// (line 57, called at :131), which takes any dtype with fp32 accumulation:
// the 2-D tokenizer's fused form (K = 48 = 4 x 4 x 3, group 1), the 1-D
// tokenizer's (K = 3, group 4) and the hierarchical tokenizer's levels.
// The bf16 form is gather_project.cu, whose structure this kernel follows.
// Its backward is plain PyTorch, as JAX's _gp_bwd is plain XLA.
//
// Bound on this card: bytes, almost all of them the fp32 output.  At the
// flagship's fp32 levels (batch 512, 64 tokens of D = 256 an image) it is
// 33.5 MB a level, ~10 us at 3.35 TB/s; the 805 MFLOP of a level would
// take 12 us as fp32 FFMA at 67 TFLOP/s, 5 us as 3xTF32 at 165.
//
// The split is csrc/gemm_f32.cu's: each operand x = big + small, big = x
// rounded to TF32, small = x - big (the tensor cores truncate it), and
// a . w summed as a_big w_small + a_small w_big + a_big w_big into one fp32
// accumulator, in that order for every k8 step, so the bits repeat and
// each product is within 2^-19 of |a| @ |w| of the exact one
// (tests/test_torch_gather_project_3xtf32.py).
//
// Design: a persistent grid of one-warpgroup blocks (two an SM with 64
// columns an item, three with 32) over items (64-token tile, image,
// TN-column slice of D), the slice fastest; the host sizes TN (64, or 32
// where 64 would give fewer items than SMs: the notebook's 32 images) and
// takes a grid that is a multiple of the slices, so each block keeps one
// slice and stages its W once.
//  * Staging, when a block first meets a slice (and per chunk where
//    group * K is over a chunk): its W rows, every load in flight before
//    the first store, split into big and small parts and written K-major
//    (32-bit wgmma has no transpose bit) in the logical order below, 128-
//    byte-swizzled tiles of TN rows x 32 features; the fp32 bias; and, with
//    the first, the LUT (up to kLutCap entries; past that it is read from
//    global memory).
//  * kSmemX (the image's x is at most kXBytes, its size a multiple of 16
//    bytes): at the start of each item thread 0 starts the bulk copy of
//    the next item's whole image into the other slot of a two-slot buffer,
//    so it is in flight while this item computes, and the gather reads
//    shared memory.  Otherwise the same code gathers from global memory
//    (the host picks the instance by size and alignment).
//  * A from registers: each thread's k8 fragment elements (rows r and
//    r + 8 of the tile, logical columns tq and tq + 4 of each step) come
//    straight from the image through the LUT, which is read once per token
//    and slot, and are split in registers.  Where every chunk is full
//    (group * K a multiple of 48: the 2-D tokenizer and the flagship's
//    levels), the contraction runs in a permuted order (logical_k) that
//    makes a thread's 12 features of a chunk neighbours: one LUT read a row
//    and three 16-byte reads where K is a multiple of 12 (the 2-D
//    tokenizer, the flagship's levels 1 and 2), one LUT read a slot where it
//    is not (level 0's K = 3).  The gather was the largest share of an
//    item's time before (clock64 stamps on scratch builds).
//  * The product: chunks of 6 k8 steps (48 features; longer rows run chunk
//    after chunk), or of 2 where group * K is at most 16 (the 1-D
//    tokenizer's 12: no step multiplies only zeros), every step's fragments
//    split first, then the 3 wgmma m64nTNk8 of each step in one commit
//    group.
//  * The epilogue adds the bias in fp32, stages the tile in shared memory
//    in the swizzle (boxes of 32 columns) and writes it by TMA store (rows
//    past M and columns past D are not written), which overlaps the next
//    item.  Where D is not a multiple of 4 (no tensor map) each thread
//    stores its own elements.
// Shared memory at TN = 64 and 6 steps: 32 KB W, 16 KB staging, 24 KB x,
// 8 KB LUT, 256 bytes bias.  Tried on scratch builds and not kept: the x copy two
// items ahead, a second staging buffer, stores straight from registers at
// three blocks an SM, x gathered from global memory, 32 columns an item at
// the flagship's levels, two accumulators, two warpgroups a block sharing
// each image; none made a level faster.

#include "sm90.cuh"

namespace {

namespace hw = sfc::sm90;

constexpr int TM = 64;          // output tokens an item
constexpr int kThreads = 128;   // one warpgroup
constexpr int kXBytes = 12288;  // an image's x in shared memory, at most
constexpr int kLutCap = 2048;   // LUT entries held in shared memory, at most
constexpr int kBox = TM * 128;  // one staged output box: 64 rows x 32 fp32

template <bool kSmemX, int TN, int KS>
struct Smem {
  unsigned char wb[(KS + 3) / 4][TN * 128];  // W's big parts, K-major: logical k 0-31, 32-..
  unsigned char ws[(KS + 3) / 4][TN * 128];  // and the small parts
  unsigned char o[TN / 32][kBox];  // output staging
  unsigned char x[kSmemX ? 2 : 1][kSmemX ? kXBytes : 16];
  int lut[kLutCap];
  float bias[TN];
  uint64_t x_full[2];
};
template <bool kSmemX, int TN, int KS>
constexpr int kSmemBytes = sizeof(Smem<kSmemX, TN, KS>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap out;  // [B, M, D], box 32 columns x 64 rows (use_tma)
  const float* x;
  const int* lut;
  const float* w;
  const float* bias;
  float* out_ptr;
  int batch, n, k, m, group, d, gk, m_tiles, slices, items, k_chunks, x_bytes;
  int lut_in_smem, use_tma, contig;
};

// The logical contraction index 8 s + c (k8 step s, fragment column c) of
// a chunk's feature f, a chunk being 8 KS features and a thread's share of
// it kQ = 2 KS.  Contiguous (every chunk full): thread tq's columns tq and
// tq + 4 of every step are its kQ neighbouring features kQ tq .. kQ tq +
// kQ - 1 (f = kQ c + 2 s for c < 4, kQ (c - 4) + 2 s + 1 above), one run to
// gather; otherwise f itself, the thread's features tq + 4 q spread over
// the chunk as far as gk reaches.
template <int KS>
__device__ __forceinline__ int logical_k(int f, bool contig) {
  constexpr int kQ = 2 * KS;
  const int c = f / kQ, r = f % kQ;
  return contig ? 8 * (r / 2) + c + 4 * (r % 2) : f;
}

template <bool kSmemX, int TN, int KS>
__global__ void __launch_bounds__(kThreads, kSmemX ? (TN == 64 ? 2 : 3) : 1)
    gather_project_f32_sm90(const __grid_constant__ Params p) {
  constexpr int KC = 8 * KS, kQ = 2 * KS;  // features a chunk; a thread's (and row's) of them
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem<kSmemX, TN, KS>& sm = hw::aligned_smem<Smem<kSmemX, TN, KS>>(dyn);
  // threadIdx.x % kThreads (== threadIdx.x): with it ptxas gave the kernel
  // fewer registers, and every shape ran faster on scratch builds.
  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int n = p.n, k = p.k, m = p.m, group = p.group, d = p.d, gk = p.gk;
  const int m_tiles = p.m_tiles, slices = p.slices, items = p.items;
  // The bulk copy of item's image into x slot s (thread 0).
  auto load_x = [&](int item, int s) {
    const int b = item / slices / m_tiles;
    hw::bar_expect_tx(&sm.x_full[s], p.x_bytes);
    hw::bulk_load(sm.x[s], p.x + static_cast<long long>(b) * n * k, p.x_bytes, &sm.x_full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) hw::bar_init(&sm.x_full[s], 1);
    hw::fence_barrier_init();
    if (kSmemX) load_x(blockIdx.x, 0);
  }
  __syncthreads();
  const int* lut = p.lut_in_smem ? sm.lut : p.lut;  // staged beside the first W rows

  // In the accumulator this thread holds tokens r0 and r0 + 8 of the tile,
  // columns 8 j + c0 + {0, 1}; its A fragment elements are those rows at
  // logical columns tq and tq + 4 of each k8 step (logical_k).
  const int tq = lane % 4, r0 = 16 * warp + lane / 4, c0 = 2 * tq;
  const uint64_t db[2] = {hw::desc_sw128(sm.wb[0]), hw::desc_sw128(sm.wb[(KS + 3) / 4 - 1])};
  const uint64_t ds[2] = {hw::desc_sw128(sm.ws[0]), hw::desc_sw128(sm.ws[(KS + 3) / 4 - 1])};
  // Contiguous with K a multiple of kQ: each thread's kQ features lie in
  // one slot, on 16 bytes: kQ / 4 16-byte reads a row.
  const bool contig = p.contig != 0, vec = contig && k % kQ == 0;
  const int fstep = contig ? 1 : 4;
  hw::Ring<2> xr;
  int w_key = -1;  // slice * k_chunks + chunk of the W rows in sm.wb / sm.ws
  float acc[TN / 2];
  // This thread's features of a chunk: slot << 16 | kk of feature f0 + kQ
  // tq + q (contiguous) or f0 + tq + 4 q, or -1 past gk.
  int dec[kQ];
  auto decode = [&](int f0) {
    int f = f0 + (contig ? kQ * tq : tq), slot = f / k, kk = f - slot * k;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      dec[q] = f < gk ? (slot << 16) | kk : -1;
      f += fstep;
      kk += fstep;
      while (kk >= k) {
        kk -= k;
        ++slot;
      }
    }
  };
  decode(0);

  for (int item = blockIdx.x; item < items; item += gridDim.x, xr.next()) {
    const int slice = item % slices, rest = item / slices;
    const int t0 = (rest % m_tiles) * TM, b = rest / m_tiles;
    const int n0 = slice * TN;
    const float* xb = kSmemX ? reinterpret_cast<const float*>(sm.x[xr.slot])
                             : p.x + static_cast<long long>(b) * n * k;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    hw::fence_regs(acc);

    for (int kc = 0; kc < p.k_chunks; ++kc) {
      const int f0 = kc * KC;
      const int key = slice * p.k_chunks + kc;
      if (key != w_key) {
        // W rows f0 .. f0 + KC - 1, columns n0 .. n0 + TN - 1 (zero past gk
        // and d), split, K-major in the logical order, and the slice's bias,
        // once every thread is past its last product; with the first, the
        // LUT.
        __syncthreads();
        constexpr int kPer = KC * TN / kThreads;
        float wv[kPer];  // every load in flight before the first store
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int u = tid + i * kThreads, f = u / TN, col = u % TN;
          wv[i] = f0 + f < gk && n0 + col < d ? __ldg(p.w + (f0 + f) * d + n0 + col) : 0.f;
        }
        if (w_key < 0 && p.lut_in_smem)
          for (int i = tid; i < m * group; i += kThreads) sm.lut[i] = p.lut[i];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int u = tid + i * kThreads, f = u / TN, col = u % TN, lk = logical_k<KS>(f, contig);
          uint32_t big, small;
          hw::tf32_split(wv[i], big, small);
          const int off = hw::sw128_f32(col, lk % 32);
          *reinterpret_cast<uint32_t*>(sm.wb[lk / 32] + off) = big;
          *reinterpret_cast<uint32_t*>(sm.ws[lk / 32] + off) = small;
        }
        if (kc == 0)
          for (int col = tid; col < TN; col += kThreads)
            sm.bias[col] = p.bias != nullptr && n0 + col < d ? p.bias[n0 + col] : 0.f;
        hw::fence_async_shared();
        __syncthreads();
        w_key = key;
      }
      if (kSmemX && kc == 0) {
        // The next item's image into the other slot, which the item before
        // this one has read (every thread passed its epilogue's barrier).
        if (tid == 0 && item + gridDim.x < items) load_x(item + gridDim.x, xr.slot ^ 1);
        hw::bar_wait(&sm.x_full[xr.slot], xr.phase);
      }
      if (p.k_chunks > 1) decode(f0);

      // The gather: feature f of tokens t0 + r0 (+ 8) is x[lut[token * group
      // + f / K] * K + f % K], zero past gk and M; the LUT is read once per
      // token and slot.
      float av[kQ][2];
      {
        const int i0 = t0 + r0, i1 = i0 + 8;
        const int* l0 = lut + i0 * group;
        const int* l1 = lut + i1 * group;
        if (vec) {
          const bool ok = dec[0] >= 0, ok0 = ok && i0 < m, ok1 = ok && i1 < m;
          const int slot = dec[0] >> 16, kk = dec[0] & 0xFFFF;
          const float4* s0 = reinterpret_cast<const float4*>(xb + (ok0 ? l0[slot] * k + kk : 0));
          const float4* s1 = reinterpret_cast<const float4*>(xb + (ok1 ? l1[slot] * k + kk : 0));
#pragma unroll
          for (int v = 0; v < kQ / 4; ++v) {
            const float4 a = ok0 ? s0[v] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 c = ok1 ? s1[v] : make_float4(0.f, 0.f, 0.f, 0.f);
            av[4 * v][0] = a.x, av[4 * v + 1][0] = a.y, av[4 * v + 2][0] = a.z,
            av[4 * v + 3][0] = a.w;
            av[4 * v][1] = c.x, av[4 * v + 1][1] = c.y, av[4 * v + 2][1] = c.z,
            av[4 * v + 3][1] = c.w;
          }
        } else {
          int last = -1, src0 = 0, src1 = 0;
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const bool ok = dec[q] >= 0;
            const int slot = dec[q] >> 16, kk = dec[q] & 0xFFFF;
            if (ok && slot != last) {
              src0 = i0 < m ? l0[slot] * k : 0;
              src1 = i1 < m ? l1[slot] * k : 0;
              last = slot;
            }
            av[q][0] = ok && i0 < m ? xb[src0 + kk] : 0.f;
            av[q][1] = ok && i1 < m ? xb[src1 + kk] : 0.f;
          }
        }
      }

      // 3xTF32: every k8 step's fragment (logical columns tq and tq + 4)
      // split in registers, then the 18
      // products in one commit group, the small terms of a step first, then
      // big . big.
      uint32_t big[KS][4], small[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hw::tf32_split(av[2 * s + (e >> 1)][e & 1], big[s][e], small[s][e]);
      hw::fence_regs(acc);
      hw::fence_frags(big);
      hw::fence_frags(small);
      hw::wgmma_fence();
      sfc::static_for<KS>([&](auto S) {
        constexpr int s = decltype(S)::value, tile = s / 4, ob = 2 * (s % 4);
        if constexpr (TN == 64) {
          hw::wgmma_tf32_rs_n64_at<ob>(acc, big[s], ds[tile], 1);
          hw::wgmma_tf32_rs_n64_at<ob>(acc, small[s], db[tile], 1);
          hw::wgmma_tf32_rs_n64_at<ob>(acc, big[s], db[tile], 1);
        } else {
          hw::wgmma_tf32_rs_n32_at<ob>(acc, big[s], ds[tile], 1);
          hw::wgmma_tf32_rs_n32_at<ob>(acc, small[s], db[tile], 1);
          hw::wgmma_tf32_rs_n32_at<ob>(acc, big[s], db[tile], 1);
        }
      });
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      hw::fence_frags(big);
      hw::fence_frags(small);
    }

    if (p.use_tma) {
      // Stage the tile once the previous item's store has read the staging
      // (thread 0 started it), then one store a 32-column box.
      if (tid == 0) hw::bulk_wait_read<0>();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(&sm.bias[8 * j + c0]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(sm.o[j / 4] + hw::sw128_f32(r0 + 8 * hf, (8 * j + c0) % 32)) =
              make_float2(acc[4 * j + 2 * hf] + bias.x, acc[4 * j + 2 * hf + 1] + bias.y);
      }
      hw::fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        for (int c = 0; c < TN / 32 && n0 + 32 * c < d; ++c)
          hw::tma_store3(&p.out, sm.o[c], n0 + 32 * c, t0, b);
        hw::bulk_commit();
      }
    } else {
      const bool pair = d % 2 == 0;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = t0 + r0 + 8 * hf, col = 8 * j + c0;
          if (row >= m) continue;
          float* dst = p.out_ptr + (static_cast<long long>(b) * m + row) * d + n0 + col;
          const float v0 = acc[4 * j + 2 * hf] + sm.bias[col];
          const float v1 = acc[4 * j + 2 * hf + 1] + sm.bias[col + 1];
          if (pair && n0 + col + 1 < d) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n0 + col < d) dst[0] = v0;
            if (n0 + col + 1 < d) dst[1] = v1;
          }
        }
      __syncthreads();  // this item's x slot and sm.bias are read before they are refilled
    }
  }
  if (tid == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

template <bool kSmemX, int TN, int KS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = gather_project_f32_sm90<kSmemX, TN, KS>;
  constexpr int smem = kSmemBytes<kSmemX, TN, KS>;
  cudaError_t e;
  int grid = hw::persistent_grid(kernel, kThreads, smem, p.items, cache, &e);
  if (e != cudaSuccess) return e;
  if (grid < p.items && grid >= p.slices) grid -= grid % p.slices;  // one slice a block
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instance for the gather's source (shared or global x), the item's
// columns and the chunk's k8 steps.
template <int KS>
cudaError_t launch_ks(const Params& p, bool smem_x, bool tn64, cudaStream_t s) {
  if (smem_x) return tn64 ? launch<true, 64, KS>(p, s) : launch<true, 32, KS>(p, s);
  return tn64 ? launch<false, 64, KS>(p, s) : launch<false, 32, KS>(p, s);
}

template <int KS>
int attrs_ks(int smem_x, int tn64, int* out) {
  if (smem_x)
    return tn64 ? hw::kernel_attrs(gather_project_f32_sm90<true, 64, KS>,
                                   kSmemBytes<true, 64, KS>, out)
                : hw::kernel_attrs(gather_project_f32_sm90<true, 32, KS>,
                                   kSmemBytes<true, 32, KS>, out);
  return tn64 ? hw::kernel_attrs(gather_project_f32_sm90<false, 64, KS>,
                                 kSmemBytes<false, 64, KS>, out)
              : hw::kernel_attrs(gather_project_f32_sm90<false, 32, KS>,
                                 kSmemBytes<false, 32, KS>, out);
}

}  // namespace

// x fp32 [batch, n, k] contiguous, on 16 bytes; lut int32 [m * group],
// each entry in [0, n) (not checked); w fp32 [group * k, d] contiguous;
// bias fp32 [d] or null; out fp32 [batch, m, d] contiguous, on 16 bytes.
// An image of x, w and m * group index in 32 bits.
extern "C" int sfc_gather_project_f32(const void* x, const void* lut, const void* w,
                                      const void* bias, void* out, int batch, int n, int k,
                                      int m, int group, int d, void* stream) {
  constexpr long long kMax32 = 1LL << 31;
  if (n < 1 || k < 1 || m < 1 || group < 1 || d < 1 || batch < 0 || k >= 65536 ||
      group >= 32768 || static_cast<long long>(n) * k >= kMax32 ||
      static_cast<long long>(group) * k * d >= kMax32 ||
      static_cast<long long>(m) * group >= kMax32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.lut = static_cast<const int*>(lut);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out_ptr = static_cast<float*>(out);
  p.batch = batch;
  p.n = n;
  p.k = k;
  p.m = m;
  p.group = group;
  p.d = d;
  p.gk = group * k;
  p.m_tiles = (m + TM - 1) / TM;
  // Chunks of 48 features (6 k8 steps), or of 16 where the rows are no
  // wider (the 1-D tokenizer's 12): no step multiplies only zeros.
  const int ks = p.gk <= 16 ? 2 : 6;
  p.k_chunks = (p.gk + 8 * ks - 1) / (8 * ks);
  p.contig = p.gk % (8 * ks) == 0;
  // 64 columns an item unless that leaves SMs without one.
  const long long tiles = static_cast<long long>(p.m_tiles) * batch;
  const bool tn64 = tiles * ((d + 63) / 64) >= sms;
  p.slices = tn64 ? (d + 63) / 64 : (d + 31) / 32;
  if (tiles * p.slices >= kMax32) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(tiles * p.slices);
  const long long x_bytes = 4LL * n * k;
  p.x_bytes = static_cast<int>(x_bytes <= kXBytes ? x_bytes : 0);
  p.lut_in_smem = m * group <= kLutCap;
  p.use_tma = d % 4 == 0;
  if (p.use_tma) {
    e = hw::map_rows_f32(&p.out, out, batch, m, d, TM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool smem_x = x_bytes <= kXBytes && x_bytes % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  e = ks == 2 ? launch_ks<2>(p, smem_x, tn64, s) : launch_ks<6>(p, smem_x, tn64, s);
  return static_cast<int>(e);
}

// Registers, local bytes and shared bytes of the instance that gathers
// from shared (smem_x 1) or global memory (0), with 64 (tn64 1) or 32
// columns an item and chunks of `steps` (2 or 6) k8 steps, into out[3].
extern "C" int sfc_gather_project_f32_attrs(int smem_x, int tn64, int steps, int* out) {
  if (steps != 2 && steps != 6) return static_cast<int>(cudaErrorInvalidValue);
  return steps == 2 ? attrs_ks<2>(smem_x, tn64, out) : attrs_ks<6>(smem_x, tn64, out);
}
