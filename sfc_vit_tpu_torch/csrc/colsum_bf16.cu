// out[c] += sum over rows of x[r, c], x bf16 [rows, cols], out fp32:
// the bias gradients of the torch-MHA backward.
//
// Replaces: the two column sums inside
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel,
// db_out = sum(gp) (lines 316-318) and db_in = sum of the bf16-rounded
// dqkv (lines 380-382), which the TPU kernel accumulated in fp32 output
// blocks across its sequential grid.
//
// Bound on this card: bytes.  At the flagship's batch 512 dqkv is
// 32,768 x 2,304 bf16 = 151 MB, about 45 us at 3.35 TB/s; the adds are
// free.  Design: each thread owns 8 neighbouring columns (one 16-byte
// load a row, a warp reads 512 contiguous bytes) and walks a slice of
// 256 rows, summing in fp32; one fp32 atomic per column and slice meets
// the slices, so the order of that last sum varies run to run.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kThreads = 128;
constexpr int kRowsPerSlice = 256;

__global__ void __launch_bounds__(kThreads)
    colsum_bf16_kernel(const bf16* __restrict__ x, float* __restrict__ out, int rows,
                       int cols) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kRowsPerSlice;
  const int r1 = min(rows, r0 + kRowsPerSlice);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < r1; ++r) {
    float v[8];
    sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * cols + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += v[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) atomicAdd(&out[c + e], acc[e]);
}

}  // namespace

// out (fp32 [cols], zeroed by the caller) += column sums of x (bf16
// [rows, cols], 16-byte aligned); cols % 8 == 0.
extern "C" int sfc_colsum_bf16(const void* x, void* out, int rows, int cols,
                               void* stream) {
  if (cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid((cols / 8 + kThreads - 1) / kThreads,
                  (rows + kRowsPerSlice - 1) / kRowsPerSlice);
  colsum_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
