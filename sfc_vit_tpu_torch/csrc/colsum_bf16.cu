// out[c] += sum over rows of x[r, c], x bf16 or fp32 [rows, cols], out
// fp32: the bias gradients of the torch-MHA backward.
//
// Replaces: the two column sums inside
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel,
// db_out = sum(gp) (lines 316-318) and db_in = sum of the bf16-rounded
// dqkv (lines 380-382), which the TPU kernel accumulated in fp32 output
// blocks across its sequential grid; the fp32 instance serves the same
// sums when the model computes in float32.
//
// Bound on this card: bytes.  At the flagship's batch 512 dqkv is
// 32,768 x 2,304 bf16 = 151 MB, about 45 us at 3.35 TB/s; the adds are
// free.  Design: each thread owns 8 neighbouring columns (one 16-byte
// load a row for bf16, two for fp32) and walks a slice of 256 rows,
// summing in fp32; one fp32 atomic per column and slice meets the slices,
// so the order of that last sum varies run to run.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kThreads = 128;
constexpr int kRowsPerSlice = 256;

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    colsum_kernel(const T* __restrict__ x, float* __restrict__ out, int rows, int cols) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kRowsPerSlice;
  const int r1 = min(rows, r0 + kRowsPerSlice);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < r1; ++r) {
    float v[8];
    load8(x + static_cast<size_t>(r) * cols + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += v[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) atomicAdd(&out[c + e], acc[e]);
}

template <typename T>
int launch(const void* x, void* out, int rows, int cols, void* stream) {
  if (cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid((cols / 8 + kThreads - 1) / kThreads,
                  (rows + kRowsPerSlice - 1) / kRowsPerSlice);
  colsum_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (fp32 [cols], zeroed by the caller) += column sums of x (bf16
// [rows, cols], 16-byte aligned); cols % 8 == 0.
extern "C" int sfc_colsum_bf16(const void* x, void* out, int rows, int cols,
                               void* stream) {
  return launch<bf16>(x, out, rows, cols, stream);
}

// The same over fp32 rows (16-byte aligned).
extern "C" int sfc_colsum_f32(const void* x, void* out, int rows, int cols, void* stream) {
  return launch<float>(x, out, rows, cols, stream);
}
