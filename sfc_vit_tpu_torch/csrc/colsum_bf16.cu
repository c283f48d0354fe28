// out[c] = sum over rows of x[r, c] in fp32, x bf16 or fp32 [rows, cols]:
// the bias gradients of the torch-MHA backward.
//
// Replaces: the two column sums inside
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel,
// db_out = sum(gp) (lines 316-318) and db_in = sum of the bf16-rounded
// dqkv (lines 380-382), which the TPU kernel accumulated in fp32 output
// blocks across its sequential grid, so in a fixed order; the fp32
// instance serves the same sums when the model computes in float32.
//
// Bound on this card: bytes.  At the flagship's batch 512 dqkv is
// 32,768 x 2,304 bf16 = 151 MB, about 45 us at 3.35 TB/s; at the
// notebook's 2,048 x 256 fp32, 2 MB, under a microsecond.  The adds are
// free.
//
// Design (the plan, ops/_build.py::colsum_plan, is a pure function of
// rows, cols and the SM count, so a second call gives the same bits):
//  * A block is 8 warps over a chunk of 8 * lanes columns and a slice of
//    rows.  Lane l of a warp is column lane l % lanes (8 neighbouring
//    columns: one 16-byte load a row in bf16, two in fp32) and row lane
//    l / lanes; the block's L = 256 / lanes row lanes each sum rows
//    j, j + L, j + 2 L, ... of the slice in that order, four loads in
//    flight.  The plan takes as many slices as fill the card (a few blocks
//    an SM) where the rows allow: the notebook's 2,048 rows are 256
//    blocks, not the 8 of a 256-row walk a thread.
//  * The block's partial: a butterfly across each warp's row lanes (every
//    lane ends with the same bits), then the 8 warps in warp order.
//  * A second launch sums the slices: each block writes its partial row to
//    a workspace [slices, cols], and common.cuh's slice_sum_kernel (the
//    one ln_rows_bwd.cu's column sums launch) adds them: warp w of 32
//    takes slices w, w + 32, ... in turn, then the 32 warp sums in warp
//    order.  It is a programmatic dependent launch: launched as the first
//    one's blocks finish, it waits for their partials, which hides most of
//    a launch at the notebook's microsecond sizes.  (A one-launch form, the
//    8 slices of a chunk as one thread-block cluster summed through
//    distributed shared memory, was timed against it on an H100: 0.5 us
//    faster at the notebook's [2,048, 768], slower at every other shape,
//    since 8 slices cannot fill the card at the flagship's; see PERF.md.)
// No atomics: ops/kernel_utils.py::colsum_fixed_order is the same order
// in PyTorch, and the card's sums equal it bit for bit.

#include "sm90.cuh"

namespace {

using sfc::bf16;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kUnroll = 4;      // rows a thread has in flight
constexpr int kSumWarps = 32;   // the slice sum's warps
constexpr int kMaxChunk = 256;  // columns a block, at most (32 lanes x 8)

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Block (chunk, slice) writes the partial column sums of its chunk and
// slice to ws[slice, chunk's columns].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    colsum_partial_kernel(const T* __restrict__ x, float* __restrict__ ws, int rows, int cols,
                          int lanes, int rows_per_slice) {
  __shared__ __align__(16) float red[kWarps][kMaxChunk];
  const int chunk = blockIdx.x, slice = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = 32 / lanes, L = kWarps * rw;
  const int j = warp * rw + lane / lanes;  // row lane
  const int cc = 8 * (lane % lanes);       // column offset in the chunk
  const int c = chunk * 8 * lanes + cc;
  const int r1 = min(rows, (slice + 1) * rows_per_slice);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < cols) {
    int r = slice * rows_per_slice + j;
    for (; r + (kUnroll - 1) * L < r1; r += kUnroll * L) {
      float v[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load8(x + static_cast<size_t>(r + u * L) * cols + c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += v[u][e];
    }
    for (; r < r1; r += L) {
      float v[8];
      load8(x + static_cast<size_t>(r) * cols + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
  }
  // The warp's row lanes: lanes of one column lane differ in the bits at
  // and above `lanes`.
  for (int o = 16; o >= lanes; o >>= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < lanes) {
    reinterpret_cast<float4*>(&red[warp][cc])[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(&red[warp][cc])[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  // The 8 warps in warp order, a thread a column of the chunk.
  const int col = chunk * 8 * lanes + tid;
  if (tid < 8 * lanes && col < cols) {
    float s = red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][tid];
    ws[static_cast<size_t>(slice) * cols + col] = s;
  }
  // The slice sum may start launching once every block is here.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T>
int launch(const void* x, void* out, void* ws, int rows, int cols, int lanes, int slices,
           int rows_per_slice, void* stream) {
  if (cols % 8 || cols < 8 || rows < 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      slices < 1 || slices > 65535 || rows_per_slice < 1 ||
      static_cast<long long>(slices) * rows_per_slice < rows || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = (cols + 8 * lanes - 1) / (8 * lanes);
  float* w = static_cast<float*>(ws);
  colsum_partial_kernel<T><<<dim3(chunks, slices), kThreads, 0, s>>>(
      static_cast<const T*>(x), w, rows, cols, lanes, rows_per_slice);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((cols + 31) / 32);
  cfg.blockDim = dim3(kSumWarps * 32);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, sfc::slice_sum_kernel<kSumWarps>,
                                             static_cast<const float*>(w),
                                             static_cast<float*>(out), slices, cols));
}

}  // namespace

// out (fp32 [cols], written, not accumulated) = the column sums of x
// (bf16 [rows, cols], 16-byte aligned; cols % 8 == 0) under the plan
// (lanes, slices, rows_per_slice) of ops/_build.py::colsum_plan; ws: fp32
// [slices, cols], the slices' partials.
extern "C" int sfc_colsum_bf16(const void* x, void* out, void* ws, int rows, int cols,
                               int lanes, int slices, int rows_per_slice, void* stream) {
  return launch<bf16>(x, out, ws, rows, cols, lanes, slices, rows_per_slice, stream);
}

// The same over fp32 rows (16-byte aligned).
extern "C" int sfc_colsum_f32(const void* x, void* out, void* ws, int rows, int cols, int lanes,
                              int slices, int rows_per_slice, void* stream) {
  return launch<float>(x, out, ws, rows, cols, lanes, slices, rows_per_slice, stream);
}
