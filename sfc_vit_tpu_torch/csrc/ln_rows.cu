// Row LayerNorm over [R, D] bf16: the prologue of both fused blocks.
//
// Replaces: the LayerNorm at the head of sfc_vit_tpu/ops/fused_mlp.py
// (_mlp_kernel, lines 110-121) and sfc_vit_tpu/ops/fused_attention_block.py
// (_attn_block_kernel, lines 126-135).  Same arithmetic: fp32 mean and
// E[x^2], variance E[x^2] - E[x]^2 clamped at 0, rsqrt(var + eps), scale
// and bias in fp32, one round to bf16.
//
// Bound on this card: memory.  Per row it reads D bf16 and writes D bf16
// with ~5 flops per element, far below the H100's ~295 flops/byte ridge.
// Design: one warp per row, 16-byte vector loads (D % 8 == 0), two passes
// over the row (the second pass hits L1), no shared memory, so any D runs
// and many rows are in flight per SM.  On the TPU the normalised rows
// stayed in VMEM for the following GEMM; here they pass through L2/HBM
// once (2 * R * D bytes), which a later PR can remove by fusing this into
// the GEMM's A-tile load.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, bf16* __restrict__ y,
                   int rows, int d, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const int chunks = d / 8;

  float s = 0.f, ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    sfc::unpack_bf16x8(xr[c], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[e];
      ss += v[e] * v[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mean = s / d;
  const float var = fmaxf(ss / d - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);

  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    sfc::unpack_bf16x8(xr[c], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 8 + e;
      v[e] = (v[e] - mean) * inv * scale[i] + bias[i];
    }
    yr[c] = sfc::pack_bf16x8(v);
  }
}

}  // namespace

extern "C" int sfc_ln_rows_bf16(const void* x, const void* scale,
                                const void* bias, void* y, int rows, int d,
                                float eps, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_rows_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
