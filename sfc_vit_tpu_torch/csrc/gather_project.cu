// Fused curve gather + projection (kernel #14), for Hopper:
// out[b, i, :] = concat_p x[b, lut[i * group + p], :] . W + bias
// over x bf16 [B, N, K], lut int32 [M * group], W bf16 [group * K, D] and
// an optional bf16 bias [D] -> out bf16 [B, M, D].
//
// Replaces: sfc_vit_tpu/ops/gather_project.py::_kernel (lines 57-78,
// called at :131).  Its arithmetic: the group curve-consecutive rows of
// each output token are concatenated slot-major (feature p * K + kk
// multiplies W[p * K + kk]), the product sums in fp32, the bias is added
// in fp32 and the sum is rounded once.  The TPU kernel gathers with a
// one-hot matmul only because Mosaic rejects unaligned dynamic row
// indexing; here each gathered element is an indexed read.  The LUT's
// entries are read unchecked: each must lie in [0, N).
//
// Bound on this card: at the family-A flagship's three tokenizer levels
// (x [B, 1024, 3] in groups of 16, [B, 256, 12] in groups of 4, [B, 64,
// 48]; D = 256, group * K = 48, 64 output tokens an image) the kernel does
// 48 multiply-adds per output element and must move x (6 KB an image), the
// LUT and W once and the bf16 output (32 KB an image): ~1.5 flops a byte,
// far under the H100's ~295, so the bytes bound it, almost all of them
// the output.
// Design: a persistent grid of min(items, SMs x blocks an SM) blocks over
// items (64-token tile, image, 256-column slice of D), the column slice
// slowest, so a block meets a new slice at most once a slice.  A block is
// two warpgroups (256 threads), two blocks an SM where x is gathered from
// shared memory (16 warps: at most 128 registers a thread), one where it
// is gathered from global memory (that instance spilled at 128).  One
// warpgroup holding all 256 fp32 columns (128 registers) beside a
// producer warp spilled at nine warps' cap of 168; with two warpgroups and
// a producer warp, one block an SM took 0.0468 ms over the flagship's
// three levels (NVIDIA H100 80GB HBM3, 700 W), two blocks without it 0.0356.
//  * Each block stages once (and again only when its slice changes) the
//    slice's W rows as the wgmma B operand, four 64-column tiles of 64
//    rows in the 128-byte swizzle read through the transpose bit, the fp32
//    bias, and the LUT (up to kLutCap entries; past that it is read from
//    global memory).  Where group * K is over 64 features, the product
//    runs in 64-feature chunks and each chunk's W rows are staged anew.
//  * kSmemX (the image's x is at most kXBytes, its size a multiple of 16
//    bytes): at the start of each item thread 0 starts the bulk copy of
//    the next item's whole image into the other slot of a two-slot buffer
//    (the item before this one has read it), so the next item's x is in
//    flight while this one computes, and the gather reads shared memory.
//    Otherwise the same code gathers from global memory (the host picks
//    the instance by size and alignment).
//  * The gather writes the A tile [64 tokens][64 features] in the
//    128-byte swizzle, 16 bytes a thread: where K is a multiple of 8 the
//    eight features lie in one row of x and come by one 16-byte read,
//    otherwise by eight 2-byte reads through the LUT.
//  * The product: wgmma, ceil(group * K / 16) k16 steps per chunk (3 at
//    the flagship's 48); warpgroup wg runs the two m64n64 products of
//    columns 128 wg .. 128 wg + 127 a step and keeps that 64 x 128 fp32
//    accumulator in registers (64 a thread).  The steps past the first
//    hang on a uniform branch, so ptxas serializes them (its C7520): each
//    chunk's product is waited on at once anyway.
//  * The epilogue adds the bias in fp32, rounds once, stages each
//    warpgroup's half tile in shared memory in the swizzle and writes it
//    by TMA store (rows past M and columns past D are not written), which
//    overlaps the next item's gather.  Where D is not a multiple of 8 (no
//    tensor map) each thread stores its own elements.
// Shared memory: 32 KB W, 8 KB A, 32 KB staging, 24 KB x, 8 KB LUT, 1 KB
// bias: 108,560 bytes with kSmemX.

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int TM = 64;                 // output tokens an item
constexpr int TN = 256;                // output columns an item
constexpr int KC = 64;                 // features a chunk
constexpr int kN64 = TN / 64;          // m64n64 products a k16 step
constexpr int kWgN64 = kN64 / 2;       // of them a consumer warpgroup's
constexpr int kThreads = 256;          // two warpgroups
constexpr int kBox = 64 * 128;         // one 64-row x 64-column swizzled bf16 tile
constexpr int kXBytes = 12288;         // an image's x in shared memory, at most
constexpr int kLutCap = 2048;          // LUT entries held in shared memory, at most

template <bool kSmemX>
struct Smem {
  unsigned char w[kN64][kBox];  // W rows f0 .. f0 + 63, columns 64 c .. of the slice
  unsigned char a[kBox];        // the gathered [64 tokens][64 features]
  unsigned char o[kN64][kBox];  // output staging
  unsigned char x[kSmemX ? 2 : 1][kSmemX ? kXBytes : 16];
  int lut[kLutCap];
  float bias[TN];
  uint64_t x_full[2];
};
template <bool kSmemX>
constexpr int kSmemBytes = sizeof(Smem<kSmemX>) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap out;  // [B, M, D], box 64 columns x 64 rows (use_tma)
  const bf16* x;
  const int* lut;
  const bf16* w;
  const bf16* bias;
  bf16* out_ptr;
  int batch, n, k, m, group, d, gk, m_tiles, items, k_chunks, x_bytes;
  int lut_in_smem, use_tma;
};

template <bool kSmemX>
__global__ void __launch_bounds__(kThreads, kSmemX ? 2 : 1)
    gather_project_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem<kSmemX>& sm = hw::aligned_smem<Smem<kSmemX>>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // The bulk copy of item's image into x slot s (thread 0).
  auto load_x = [&](int item, int s) {
    const int b = (item / p.m_tiles) % p.batch;
    hw::bar_expect_tx(&sm.x_full[s], p.x_bytes);
    hw::bulk_load(sm.x[s], p.x + static_cast<long long>(b) * p.n * p.k, p.x_bytes, &sm.x_full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) hw::bar_init(&sm.x_full[s], 1);
    hw::fence_barrier_init();
    if (kSmemX) load_x(blockIdx.x, 0);
  }
  __syncthreads();

  // In the accumulator this thread holds tokens r0 and r0 + 8 of the tile,
  // columns 64 (2 wg + c) + 8 j + c0 + {0, 1}.
  const int wg = warp / 4, wtid = tid % 128;
  const int r0 = (warp % 4) * 16 + lane / 4, c0 = 2 * (lane % 4);
  const int lut_n = p.m * p.group;
  if (p.lut_in_smem)
    for (int i = tid; i < lut_n; i += kThreads) sm.lut[i] = p.lut[i];
  const int* lut = p.lut_in_smem ? sm.lut : p.lut;  // visible after the first W staging's barrier
  const bool vec_w = p.d % 8 == 0, vec_x = p.k % 8 == 0;
  hw::Ring<2> xr;
  int w_key = -1;  // slice * k_chunks + chunk of the W rows in sm.w
  float acc[kWgN64][32];

  for (int item = blockIdx.x; item < p.items; item += gridDim.x, xr.next()) {
    const int mt = item % p.m_tiles, rest = item / p.m_tiles;
    const int b = rest % p.batch, slice = rest / p.batch;
    const int t0 = mt * TM, n0 = slice * TN;
    const bf16* xb = kSmemX ? reinterpret_cast<const bf16*>(sm.x[xr.slot])
                            : p.x + static_cast<long long>(b) * p.n * p.k;
#pragma unroll
    for (int c = 0; c < kWgN64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

    for (int kc = 0; kc < p.k_chunks; ++kc) {
      const int f0 = kc * KC;
      const int key = slice * p.k_chunks + kc;
      if (key != w_key) {
        // W rows f0 .. f0 + 63, columns n0 .. n0 + 255, zero past gk and d,
        // and the slice's bias, once every thread is past its last product
        // and its last epilogue (and, in a block's first item, the LUT is
        // in place).
        __syncthreads();
        if (vec_w) {
#pragma unroll 1
          for (int u = tid; u < KC * TN / 8; u += kThreads) {
            const int r = u / (TN / 8), col = (u % (TN / 8)) * 8;
            const bool ok = f0 + r < p.gk && n0 + col < p.d;
            sfc::cp_async16(sm.w[col / 64] + hw::sw128_bf16(r, col % 64),
                            ok ? p.w + (f0 + r) * p.d + n0 + col : p.w, ok);
          }
          sfc::cp_async_commit();
        } else {
          for (int u = tid; u < KC * TN; u += kThreads) {
            const int r = u / TN, col = u % TN;
            const bool ok = f0 + r < p.gk && n0 + col < p.d;
            *reinterpret_cast<bf16*>(sm.w[col / 64] + hw::sw128_bf16(r, col % 64)) =
                ok ? p.w[(f0 + r) * p.d + n0 + col] : __float2bfloat16(0.f);
          }
        }
        if (kc == 0)
          for (int col = tid; col < TN; col += kThreads)
            sm.bias[col] = p.bias != nullptr && n0 + col < p.d ? __bfloat162float(p.bias[n0 + col])
                                                               : 0.f;
        w_key = key;
      }
      if (kSmemX && kc == 0) {
        // The next item's image into the other slot, which the item before
        // this one has read (every thread passed its last barrier).
        if (tid == 0 && item + gridDim.x < p.items) load_x(item + gridDim.x, xr.slot ^ 1);
        hw::bar_wait(&sm.x_full[xr.slot], xr.phase);
      }

      // The gather, by both warpgroups: unit u is token u / 8 of the tile,
      // features f0 + 8 (u % 8) .. + 7, one 16-byte store into the
      // swizzled A tile (a warp fills four whole rows: no bank conflict on
      // the stores).
#pragma unroll 1
      for (int i = 0; i < TM * KC / 8 / kThreads; ++i) {
        const int u = tid + i * kThreads, r = u / 8, fb = f0 + 8 * (u % 8);
        const int row = t0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < p.m && fb < p.gk) {
          int slot = fb / p.k, kk = fb - slot * p.k;
          const int* lr = lut + row * p.group;
          if (vec_x) {  // the eight features in one row of x, on 16 bytes
            v = *reinterpret_cast<const uint4*>(xb + lr[slot] * p.k + kk);
          } else {
            const uint16_t* xh = reinterpret_cast<const uint16_t*>(xb);
            uint32_t h[4] = {0u, 0u, 0u, 0u};
            int src = lr[slot] * p.k;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (fb + e < p.gk) h[e / 2] |= static_cast<uint32_t>(xh[src + kk]) << (16 * (e % 2));
              if (++kk == p.k && fb + e + 1 < p.gk) {
                kk = 0;
                src = lr[++slot] * p.k;
              }
            }
            v = make_uint4(h[0], h[1], h[2], h[3]);
          }
        }
        *reinterpret_cast<uint4*>(sm.a + hw::sw128_bf16(r, 8 * (u % 8))) = v;
      }
      sfc::cp_async_wait<0>();
      hw::fence_async_shared();
      __syncthreads();

      const int ks = min(4, (p.gk - f0 + 15) / 16);
      const uint64_t adesc = hw::desc_sw128(sm.a);
#pragma unroll
      for (int c = 0; c < kWgN64; ++c) hw::fence_regs(acc[c]);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ks) {
#pragma unroll
          for (int c = 0; c < kWgN64; ++c)
            hw::wgmma_ss<0, 1>(acc[c], adesc + 2 * kk,
                               hw::desc_sw128(sm.w[kWgN64 * wg + c]) + kk * (2048 >> 4), 1);
        }
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kWgN64; ++c) hw::fence_regs(acc[c]);
      __syncthreads();  // sm.a and sm.w are free again
    }

    if (p.use_tma) {
      // Each warpgroup stages and stores its own two 64-column tiles, once
      // its previous store has read them (its thread wtid 0 starts both).
      if (wtid == 0) hw::bulk_wait_read<0>();
      hw::named_sync(2 + wg, 128);
#pragma unroll
      for (int c = 0; c < kWgN64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bias =
              *reinterpret_cast<const float2*>(&sm.bias[64 * (kWgN64 * wg + c) + 8 * j + c0]);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<uint32_t*>(sm.o[kWgN64 * wg + c] +
                                         hw::sw128_bf16(r0 + 8 * hf, 8 * j + c0)) =
                hw::pack_bf16x2(acc[c][4 * j + 2 * hf] + bias.x,
                                acc[c][4 * j + 2 * hf + 1] + bias.y);
        }
      hw::fence_async_shared();
      hw::named_sync(2 + wg, 128);
      if (wtid == 0) {
        for (int c = kWgN64 * wg; c < kWgN64 * (wg + 1) && n0 + 64 * c < p.d; ++c)
          hw::tma_store3(&p.out, sm.o[c], n0 + 64 * c, t0, b);
        hw::bulk_commit();
      }
    } else {
#pragma unroll
      for (int c = 0; c < kWgN64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = t0 + r0 + 8 * hf, col = 64 * (kWgN64 * wg + c) + 8 * j + c0 + e;
              if (row < p.m && n0 + col < p.d)
                p.out_ptr[(static_cast<long long>(b) * p.m + row) * p.d + n0 + col] =
                    __float2bfloat16(acc[c][4 * j + 2 * hf + e] + sm.bias[col]);
            }
    }
  }
  if (wtid == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

template <bool kSmemX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = gather_project_sm90<kSmemX>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, kSmemBytes<kSmemX>, p.items, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, kSmemBytes<kSmemX>, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [batch, n, k] contiguous, on 16 bytes; lut int32 [m * group],
// each entry in [0, n) (not checked); w bf16 [group * k, d] contiguous, on
// 16 bytes; bias bf16 [d] or null; out bf16 [batch, m, d] contiguous, on
// 16 bytes.  An image of x, w and m * group index in 32 bits.
extern "C" int sfc_gather_project_bf16(const void* x, const void* lut, const void* w,
                                       const void* bias, void* out, int batch, int n, int k,
                                       int m, int group, int d, void* stream) {
  constexpr long long kMax32 = 1LL << 31;
  if (n < 1 || k < 1 || m < 1 || group < 1 || d < 1 || batch < 0 ||
      static_cast<long long>(n) * k >= kMax32 || static_cast<long long>(group) * k * d >= kMax32 ||
      static_cast<long long>(m) * group >= kMax32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.lut = static_cast<const int*>(lut);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.out_ptr = static_cast<bf16*>(out);
  p.batch = batch;
  p.n = n;
  p.k = k;
  p.m = m;
  p.group = group;
  p.d = d;
  p.gk = group * k;
  p.m_tiles = (m + TM - 1) / TM;
  p.items = p.m_tiles * batch * ((d + TN - 1) / TN);
  p.k_chunks = (p.gk + KC - 1) / KC;
  const long long x_bytes = 2LL * n * k;
  p.x_bytes = static_cast<int>(x_bytes <= kXBytes ? x_bytes : 0);
  p.lut_in_smem = m * group <= kLutCap;
  p.use_tma = d % 8 == 0;
  if (p.use_tma) {
    const cudaError_t e = hw::map_rows_bf16(&p.out, out, batch, m, d, TM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool smem_x = x_bytes <= kXBytes && x_bytes % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(smem_x ? launch<true>(p, s) : launch<false>(p, s));
}

// Registers, local bytes and shared bytes of the instance that gathers
// from shared (smem_x 1) or global memory (0), into out[3].
extern "C" int sfc_gather_project_attrs(int smem_x, int* out) {
  return smem_x ? hw::kernel_attrs(gather_project_sm90<true>, kSmemBytes<true>, out)
                : hw::kernel_attrs(gather_project_sm90<false>, kSmemBytes<false>, out);
}
