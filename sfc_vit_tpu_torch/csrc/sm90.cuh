// Hopper (sm_90a) building blocks of the redesigned kernels (#1's, #5's
// and #7's attention, #8-#11, #13, #14, the GEMM under #1-#6, #15 and #16, and
// the attention backward of #4 and #6, in bf16 and, through attn_f32.cuh,
// in fp32): TMA tensor maps built on the host,
// TMA loads, stores and reduce-adds, plain bulk copies, mbarriers, the
// grid of a persistent kernel, warpgroup matrix multiplies (wgmma) on
// 128-byte-swizzled shared tiles, and thread-block clusters (distributed
// shared memory and mbarriers across blocks, #15's LayerNorm).
//
// Shared tiles are bf16 rows of 64 elements (128 bytes), as TMA writes
// them with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8), and every tile starts on 1,024 bytes.  Such a
// tile is both operand layouts wgmma reads:
//  * K-major (the contraction runs along the row): a k16 step is 32 bytes
//    further along the row, 8-row groups 1,024 bytes apart;
//  * MN-major (the transpose bit; the contraction runs down the rows): a
//    k16 step is 16 rows = 2,048 bytes further, the two 8-row groups of the
//    step 1,024 bytes apart, and the 64 row elements are one swizzle atom.
// Accumulators of m64nN follow PTX's layout: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 and that + 8, columns
// 8 j + 2 (t % 4) + {0, 1} for j < N / 8, as d[4 j + {0, 1}] (first row)
// and d[4 j + {2, 3}] (second row).  The A fragment of one k16 step from
// registers is the same map over 16 columns, so an m64nN accumulator
// rounded to bf16 pairs is the A operand of the next product.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace sfc {
namespace sm90 {

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, N, H, 64] bf16 tensor read through its (batch, row, head) element
// strides, as a 4-d map (dh, head, row, batch) whose box is `rows` rows of
// one (batch, head), 128-byte swizzled.  Rows past n read as zero.
inline cudaError_t map_bnhd(CUtensorMap* m, const void* base, int batch, int n, int heads,
                            long long sb, long long sn, long long sh, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {64, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous fp32 [B, N, H, 64] tensor as a 4-d map whose box is `rows`
// rows x 32 columns of one (batch, head), 128-byte swizzled: the target of
// a reduce-add (two boxes per 64 columns).  Rows past n are not written.
inline cudaError_t map_bnhd_f32(CUtensorMap* m, void* base, int batch, int n, int heads,
                                int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {64, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t row = 64 * 4;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * n};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// map_heads' map (below) over a [B, N, H, Dh] tensor read through its (batch, row,
// head) element strides, unit stride along Dh (the fp32 flash kernels' q,
// k, v and cotangent: contiguous, or views of a packed projection).  Every
// stride a multiple of 16 bytes, the base on 16 bytes.
inline cudaError_t map_strided_heads(CUtensorMap* m, const void* base, bool f32, int batch,
                                     int n, int heads, int dh, long long sb, long long sn,
                                     long long sh, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)sn * es, (cuuint64_t)sb * es};
  const cuuint32_t box[4] = {f32 ? 32u : 64u, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major tensor whose rows hold `heads` heads of dh columns each
// (the packed projection [B, N, 3 H Dh] as 3 H heads, att, its cotangent
// and the output [B, N, H Dh] as H), `row` elements a row, as a 4-d map
// (dh, head, row, batch) whose box is `rows` rows of one (batch, head) and
// one 128-byte row wide: 64 bf16 columns, or 32 fp32 columns (two boxes a
// 64-column sub-head, see sw128_f32), 128-byte swizzled.  Sub-head c of a
// head starts at column 64 c.  A box reaching past dh (a ragged last
// sub-head: Dh 96 as two 64-column sub-heads, 32 and 48 as one) loads
// zeros there and stores nothing there, so a head never reads or writes
// its neighbour's columns; rows past n likewise (a tile never reads the
// next image's rows).  dh * the element size must be a multiple of 16
// bytes, and the base on 16 bytes.
inline cudaError_t map_heads(CUtensorMap* m, const void* base, bool f32, int batch, int n,
                             int heads, int dh, long long row, int rows) {
  return map_strided_heads(m, base, f32, batch, n, heads, dh, row * n, row, dh, rows);
}

// The attention kernels' head dims (ops/_build.py::attention_head_dim_ok
// and attention_subheads, the same rule): a multiple of 16 up to 256,
// walked as ceil(dh / 64) sub-heads of 64 columns.
constexpr int kMaxHeadDim = 256;
__host__ __device__ constexpr bool head_dim_ok(int dh) {
  return dh >= 16 && dh <= kMaxHeadDim && dh % 16 == 0;
}
__host__ __device__ constexpr int subheads(int dh) { return (dh + 63) / 64; }

// The packed attention forwards' one-pass limit in 64-key tiles by
// sub-heads a head (the Python PACKED_ONE_PASS_MAX_N and its masked
// table): the whole row of logits beside O's 32 C registers a thread.
__host__ __device__ constexpr int one_pass_tiles(int c, bool masked) {
  return c == 1 ? (masked ? 3 : 4) : c == 2 ? (masked ? 2 : 3) : 1;
}
// The one-pass instance's key columns for n_valid keys (0: two passes):
// 64 a tile, 200 for ViT-B's 196 (100 registers where 256 takes 128).
__host__ __device__ constexpr int one_pass_nk(int c, int n_valid, bool masked) {
  const int tiles = (n_valid + 63) / 64;
  return tiles > one_pass_tiles(c, masked) ? 0 : tiles == 4 && n_valid <= 200 ? 200 : 64 * tiles;
}

// Calls f(C, NK) (integral constants) for the packed attention forwards'
// instance of c sub-heads and nk one-pass key columns (0: two passes),
// with the mask (MASKED) or without; false where there is none.
template <bool MASKED, typename F>
inline bool with_packed_instance(int c, int nk, F&& f) {
  using std::integral_constant;
  auto at = [&](auto Cc) {
    constexpr int T = one_pass_tiles(decltype(Cc)::value, MASKED);
    switch (nk) {
      case 0: f(Cc, integral_constant<int, 0>{}); return true;
      case 64: f(Cc, integral_constant<int, 64>{}); return true;
      case 128: if constexpr (T >= 2) { f(Cc, integral_constant<int, 128>{}); return true; } break;
      case 192: if constexpr (T >= 3) { f(Cc, integral_constant<int, 192>{}); return true; } break;
      case 200: if constexpr (T >= 4) { f(Cc, integral_constant<int, 200>{}); return true; } break;
      case 256: if constexpr (T >= 4) { f(Cc, integral_constant<int, 256>{}); return true; } break;
      default: break;
    }
    return false;
  };
  switch (c) {
    case 1: return at(integral_constant<int, 1>{});
    case 2: return at(integral_constant<int, 2>{});
    case 3: return at(integral_constant<int, 3>{});
    case 4: return at(integral_constant<int, 4>{});
    default: return false;
  }
}

// A flat fp32 vector of `count` elements whose box is `rows` elements (the
// lse and delta rows [B, H, N]); elements past count read as zero.  Start a
// box on 16 bytes (rows_start): a kernel whose boxes started elsewhere
// failed on the H100 with an illegal-instruction error.
inline cudaError_t map_f32_rows(CUtensorMap* m, const void* base, long long count, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)count};
  const cuuint64_t strides[1] = {(cuuint64_t)count * 4};  // rank 1: none is read
  const cuuint32_t box[1] = {(cuuint32_t)rows};
  const cuuint32_t unit[1] = {1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous bf16 [batch, rows, cols] tensor as a 3-d map whose box is
// 64 columns x box_rows rows of one batch entry, 128-byte swizzled (cols
// a multiple of 8).  Rows and columns past the tensor are not written by
// a store.
inline cudaError_t map_rows_bf16(CUtensorMap* m, void* base, int batch, int rows, int cols,
                                 int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same for a contiguous fp32 [batch, rows, cols] tensor: a box of 32
// columns (one 128-byte row, see sw128_f32) x box_rows rows of one batch
// entry, 128-byte swizzled (cols a multiple of 4).
inline cudaError_t map_rows_f32(CUtensorMap* m, void* base, int batch, int rows, int cols,
                                int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)cols * rows * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major bf16 matrix [outer, inner] (inner a multiple of 8, base on
// 16 bytes) as a 2-d map whose box is 64 inner x 64 outer elements,
// 128-byte swizzled.  Loads read past either edge as zero.
inline cudaError_t map_2d_bf16(CUtensorMap* m, const void* base, long long inner,
                               long long outer) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major fp32 matrix [outer, inner] (inner a multiple of 4, base on
// 16 bytes) as a 2-d map whose box is 32 inner (one 128-byte row) x
// box_outer elements, 128-byte swizzled (see sw128_f32).  Loads read past
// either edge as zero.
inline cudaError_t map_2d_f32(CUtensorMap* m, const void* base, long long inner,
                              long long outer, int box_outer) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major uint8 matrix [rows, cols] (cols a multiple of 16, base on
// 16 bytes: a dropout mask [B, H, N, N] as B H N rows of N keys) as a
// 2-d map whose box is 64 columns x 64 rows, 64-byte swizzled (see
// sw64_u8).  Loads read past either edge as zero.
inline cudaError_t map_mask_u8(CUtensorMap* m, const void* base, long long rows, long long cols) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks of a persistent kernel: min(items, SMs x the blocks of `kernel`
// an SM holds at `threads` threads and `smem` dynamic bytes), from the
// current device.  Sets the kernel's dynamic shared memory limit first.
// Both are read once a device and kernel (the caller passes one static
// cache per kernel), so a launch inside a CUDA graph capture queries
// nothing.  Returns 0 and sets *err on failure.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, int smem, long long items, int (&cache)[64],
                           cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err == cudaSuccess)
      *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cache[dev] = sms * per_sm;
  }
  return static_cast<int>(items < cache[dev] ? items : cache[dev]);
}

// A box of fp32 rows holding element i starts at rows_start(i), on 16
// bytes; one of n + kRowsPad elements holds i .. i + n - 1 from offset
// i - rows_start(i).
constexpr int kRowsPad = 4;
__host__ __device__ constexpr int rows_start(int i) { return i & ~(kRowsPad - 1); }
// A 64-row tile's lse / delta rows: a box from its first row rounded down
// (rows_start), into a shared-memory slot of whole 128-byte lines.
constexpr int kRowBox = 64 + kRowsPad;
constexpr int kRowSlot = 96;
static_assert(kRowSlot >= kRowBox && kRowSlot % 32 == 0, "lse / delta slot");

constexpr float kLog2e = 1.4426950408889634f;

// What the compiler gave a kernel: out[0] registers a thread, out[1]
// local memory a thread (spills and stack), out[2] shared memory a block
// (the dynamic `dyn_smem` and any static).
template <typename Kernel>
inline int kernel_attrs(Kernel kernel, int dyn_smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = dyn_smem + static_cast<int>(a.sharedSizeBytes);
  return 0;
}

// -------------------------------------------------------------- device

// The kernel's shared storage S at the first 1,024-byte boundary of its
// dynamic shared memory (the 128-byte swizzle repeats every 1,024 bytes):
// a launch asks for sizeof(S) + 1,024 bytes.
template <typename S>
__device__ __forceinline__ S& aligned_smem(unsigned char* dyn) {
  const uint32_t pad = (1024 - (smem_addr(dyn) & 1023)) & 1023;
  return *reinterpret_cast<S*>(dyn + pad);
}

// The curve-local window (ops/_build.py::local_tile_window, the same
// arithmetic): the 64-row tiles [lo, hi) of the other side (n rows) that
// rows [64 tile0, min(n, 64 tile0 + rows)) meet, each row i meeting the
// rows j with |i / block - j / block| <= halo (block a multiple of 64).
// Rows from tile0 must start before n.
__device__ __forceinline__ void local_tile_window(int tile0, int rows, int n, int block,
                                                  int halo, int& lo, int& hi) {
  const int bt = block / 64, tiles = (n + 63) / 64;
  const int end = 64 * tile0 + rows < n ? 64 * tile0 + rows : n;
  const int first_block = tile0 / bt, last_block = (end - 1) / block;
  lo = first_block > halo ? (first_block - halo) * bt : 0;
  hi = (last_block + halo + 1) * bt < tiles ? (last_block + halo + 1) * bt : tiles;
}

// A ring of kStages slots: the slot and the parity of its current phase.
template <int kStages>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase with this parity has completed.  A phase
// that never completes (a fault in the kernel) traps after ~2^30 polls
// rather than hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Whether the barrier's phase with this parity has completed (no wait).
__device__ __forceinline__ bool bar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// TMA: the box at (c0, c1, c2, c3) of a 4-d map into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load1(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// TMA: add the shared box to the global box at (c0, c1, c2, c3), fp32,
// as one bulk operation of the current bulk group.
__device__ __forceinline__ void tma_reduce_add4(const CUtensorMap* map, const void* src, int c0,
                                                int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: the shared box to the global box at (c0, c1, c2, c3) of a 4-d map
// (c0, c1, c2 of a 3-d one), as one bulk operation of the current bulk
// group.  Elements outside the map's bounds are not written.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map, const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes from global to shared memory by one bulk copy
// (no tensor map), completing `bar`'s transaction bytes.  Both addresses
// on 16 bytes, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk groups are still reading shared
// memory (the sources of the others may be overwritten).
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, TMA sources).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over `threads` threads with its own id (1..15; 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `p` (see the header):
// stride between 8-row groups 1,024 bytes, the leading offset unused by a
// single swizzle atom.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// The same for an MN-major operand wider than one swizzle atom: 64-column
// atoms `atom_bytes` apart (the leading byte offset, bits 16-29).
__device__ __forceinline__ uint64_t desc_sw128_atoms(const void* p, uint32_t atom_bytes) {
  return (desc_sw128(p) & ~(uint64_t(0x3FFF) << 16)) | (uint64_t(atom_bytes >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's uses of accumulator registers around wgmma's
// asynchronous writes (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments held in registers (k16 steps of four bf16
// pairs), which wgmma reads asynchronously too.
template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define SFC_WGMMA_D32                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SFC_WGMMA_REGS32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (m64n64, fp32) = A . B (+ d when accumulate): both operands from shared
// memory; kTransA / kTransB read them MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFC_WGMMA_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SFC_WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (m64n64, fp32) += A . B with A's k16 slice from registers (four bf16
// pairs in the accumulator's layout) and B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFC_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SFC_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTransB));
}

// wgmma_ss with the descriptors da + OA and db + OB (16-byte units, an
// operand's k16 step or sub-tile) formed inside the instruction's own asm
// block: the compiler keeps only the two bases live, not a descriptor for
// every step beside a wide accumulator.
template <int kTransA, int kTransB, int OA, int OB>
__device__ __forceinline__ void wgmma_ss_at(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %34, 0;\n"
      " add.s64 a, %32, %35;\n add.s64 b, %33, %36;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFC_WGMMA_REGS32
      ", a, b, p, 1, 1, %37, %38;\n}\n"
      : SFC_WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB), "n"(kTransA), "n"(kTransB));
}

// wgmma_rs with B's descriptor db + OB formed inside the asm block.
template <int kTransB, int OB>
__device__ __forceinline__ void wgmma_rs_at(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 b;\n setp.ne.b32 p, %37, 0;\n"
      " add.s64 b, %36, %38;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFC_WGMMA_REGS32
      ", {%32, %33, %34, %35}, b, p, 1, 1, %39;\n}\n"
      : SFC_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(OB),
        "n"(kTransB));
}

// d (m64nN, fp32, N = 128, 192, 200, 256) = A . B (+ d when accumulate), both
// K-major from shared memory, with the descriptors da + OA and db + OB
// formed inside the asm block (see wgmma_ss_at): one product over a whole
// row of N keys, B being N consecutive swizzled rows (8-row groups 1,024
// bytes apart across tiles).
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n128_at(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %66, 0;\n"
      " add.s64 a, %64, %67;\n add.s64 b, %65, %68;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", a, b, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n192_at(float (&d)[96], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %98, 0;\n"
      " add.s64 a, %96, %99;\n add.s64 b, %97, %100;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95} "
      ", a, b, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n256_at(float (&d)[128], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %130, 0;\n"
      " add.s64 a, %128, %131;\n add.s64 b, %129, %132;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127} "
      ", a, b, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n200_at(float (&d)[100], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 a, b;\n setp.ne.b32 p, %102, 0;\n"
      " add.s64 a, %100, %103;\n add.s64 b, %101, %104;\n"
      " wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99} "
      ", a, b, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
      "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OA), "n"(OB));
}

// wgmma_ss_n<N>: the m64nN form above for an accumulator of N / 2
// registers a thread.
template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n_at(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128_at<OA, OB>(d, da, db, accumulate);
  else if constexpr (N == 192) wgmma_ss_n192_at<OA, OB>(d, da, db, accumulate);
  else if constexpr (N == 200) wgmma_ss_n200_at<OA, OB>(d, da, db, accumulate);
  else wgmma_ss_n256_at<OA, OB>(d, da, db, accumulate);
}

#define SFC_WGMMA_D64                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63])

// d (m64n128, fp32) = A . B (+ d when accumulate): both operands from
// shared memory.  An MN-major B of 128 columns spans two 64-column
// swizzle atoms: see desc_sw128_atoms.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SFC_WGMMA_D64
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// TF32 (fp32 operands on the tensor cores, 10 mantissa bits each): both
// operands K-major, as wgmma takes 32-bit types (no transpose bit).  A
// k8 step of a 128-byte-swizzled fp32 tile (32 values a row) is 32 bytes
// along the row, as a bf16 k16 step is.  The A fragment of one k8 step
// from registers: thread t of the warpgroup holds row 16 (t / 32) +
// (t % 32) / 4 (a[0] at column t % 4, a[2] at t % 4 + 4) and that row + 8
// (a[1], a[3]): the accumulator's map in 32-bit columns.

// d (m64n128, fp32) += A . B, A's k8 slice from registers (fp32 bit
// patterns; tests/test_torch_kernels.py's probe shows what the tensor
// cores take of the 13 bits below TF32's mantissa), B K-major from shared
// memory at the descriptor db + OB (16-byte units) formed inside the asm.
template <int OB>
__device__ __forceinline__ void wgmma_tf32_rs_n128_at(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %70, 0;\n"
      " add.s64 b, %68, %69;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, b, p, 1, 1;\n}\n"
      : SFC_WGMMA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(1));
}

// d (m64n64, fp32) = A . B (+ d when accumulate), tf32: A from registers
// (as above) or, in the _ss form, K-major from shared memory.  The probe's
// forms (csrc/wgmma_probe.cu).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SFC_WGMMA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SFC_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SFC_WGMMA_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : SFC_WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64, fp32) = A . B (+ d when accumulate), tf32, A's k8 slice from
// registers (as above), B K-major at the descriptor db + OB formed inside
// the asm: the fp32 attention's products (csrc/attn_f32.cuh), 64 columns
// of a logits tile or of a 64-column sub-head of the output.  A first
// product that overwrites d (accumulate 0) leaves no instruction of the
// thread's own defining the accumulators between products.
template <int OB>
__device__ __forceinline__ void wgmma_tf32_rs_n64_at(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %38, 0;\n"
      " add.s64 b, %36, %37;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SFC_WGMMA_REGS32
      ", {%32, %33, %34, %35}, b, p, 1, 1;\n}\n"
      : SFC_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(accumulate));
}

// The same over 32 columns (m64n32: #14's fp32 items of 32 columns).
template <int OB>
__device__ __forceinline__ void wgmma_tf32_rs_n32_at(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %22, 0;\n"
      " add.s64 b, %20, %21;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, b, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(accumulate));
}

// The same over 8 columns (m64n8: ViT-B's 196 keys held as 200 columns,
// the last 8 of a fourth key tile).
template <int OB>
__device__ __forceinline__ void wgmma_tf32_rs_n8_at(float (&d)[4], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .b64 b;\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " add.s64 b, %8, %9;\n"
      " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, b, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(OB), "r"(accumulate));
}

#undef SFC_WGMMA_D64
#undef SFC_WGMMA_D32
#undef SFC_WGMMA_REGS32

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
// as an fp32 bit pattern whose low 13 bits are zero (cvt.rna.tf32.f32: on
// the H100 inf and NaN have those bits cleared, not rounded;
// ops/kernel_utils.py::tf32_round is the same rounding in PyTorch).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// The split x = big + small by which an fp32 operand enters the tensor
// cores three times (see csrc/gemm_f32.cu): big = x rounded to TF32 by
// two integer operations (half a unit of the 13 dropped bits added to the
// magnitude, then cleared: tf32_rna's bits for every finite x and inf),
// small = x - big, exact in fp32, left unrounded: the tensor cores drop
// its 13 low bits themselves.  A NaN x gives a NaN small.  tf32_rna in
// place of the integer rounding, for both parts, made gemm_f32 slower on
// the H100: the conversions sit on its critical path.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of k16 step kk from an m64nN fp32 accumulator rounded to
// bf16 (the columns 16 kk .. 16 kk + 15 of the accumulator's rows).
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
}

// x = hi + lo as bf16 pairs in A-fragment order (see acc_to_a): the
// two-term split by which an fp32 operand (p, ds) enters a bf16 product.
__device__ __forceinline__ void split_a(const float (&d)[32], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x0 = d[8 * kk + 2 * e], x1 = d[8 * kk + 2 * e + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h);
    lo[e] = pack_bf16x2(x0 - hf.x, x1 - hf.y);
  }
}

// ------------------------------------------------------------ clusters
//
// A thread-block cluster's blocks read and write each other's shared
// memory (distributed shared memory) through shared::cluster addresses;
// an mbarrier of one block can count arrivals from the others.

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for the
// others (release / acquire at cluster scope): e.g. each block's mbarriers
// are initialised before a peer arrives on them.  All threads of a warp
// call it together.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (in this block's shared memory) in
// the block of rank `rank`.
__device__ __forceinline__ uint32_t map_to_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Four floats to a shared::cluster address (16 bytes, e.g. another
// block's shared memory).
__device__ __forceinline__ void st_cluster_f32x4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Arrive on the mbarrier at a shared::cluster address, releasing this
// thread's earlier writes (to any block of the cluster) at cluster scope.
__device__ __forceinline__ void bar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// bar_wait for a barrier whose arrivals come from other blocks of the
// cluster: acquires their writes at cluster scope.
__device__ __forceinline__ void bar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The thread's index, read afresh at each use: the addresses derived from
// it are then recomputed where they are needed, not held in registers
// beside the accumulators across a kernel's loops.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// 2^x (ex2.approx: ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x (rcp.approx: ~1 ulp, one instruction; the correctly rounded
// forms branch to a subroutine for special cases).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// RN(1 / x) for a normal x with a normal reciprocal (a softmax's row sum,
// l >= 1): rcp.approx in fp64 refined by three Newton steps (fma), rounded
// to fp32 once (1 / x is never nearer than 2^-47 of itself to a rounding
// midpoint of fp32).  No call: `__frcp_rn`'s slow path is a subroutine,
// and registers live across it spill.
__device__ __forceinline__ float rcp_rn(float x) {
  const double d = x;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(d));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-d, r, 1.0), r);
  return __double2float_rn(r);
}

// log2(x) (lg2.approx: one instruction).
__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (row, col) of a bf16 tile of 64-element rows,
// 128-byte swizzled (the layout TMA writes).
__device__ __forceinline__ int sw128_bf16(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Byte offset of element (row, col) of a uint8 tile of 64-byte rows,
// 64-byte swizzled (map_mask_u8's boxes): the 16-byte chunk c of row r
// sits at chunk c ^ ((r / 2) % 4), so the eight rows a warp's accumulator
// lanes hold fall in distinct banks.  The tile starts on 512 bytes.
__device__ __forceinline__ int sw64_u8(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// Byte offset of element (row, col) of an fp32 tile of 32-element rows,
// 128-byte swizzled.
__device__ __forceinline__ int sw128_f32(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

}  // namespace sm90
}  // namespace sfc
