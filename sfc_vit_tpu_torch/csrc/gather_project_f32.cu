// The curve gather + projection of the fused tokenizers in float32:
// out[b, i] = concat_p x[b, lut[i * group + p]] @ w + bias, SIMT FFMA with
// an fp32 sum and the bias added to it.
//
// Replaces, for float32 compute: sfc_vit_tpu/ops/gather_project.py::_kernel
// (line 57), which takes any dtype with fp32 accumulation: the 2-D
// tokenizer's fused form (K = 48 = 4 x 4 x 3, group 1), the 1-D
// tokenizer's (K = 3, group 4) and the hierarchical tokenizer's levels.
// The bf16 form stays on the wgmma kernel gather_project.cu.  Its backward
// is plain PyTorch, as JAX's _gp_bwd is plain XLA.
//
// Bound on this card: bytes (x, the LUT, w and the output; group * K is
// 48 on every main path, so 96 flops an output element against its 4
// bytes written).
//
// Design: a block of 256 threads owns 64 output tokens of one image and
// 128 of the D columns, and walks the grouped features group * K in
// chunks of 32: each chunk's gathered rows come through the LUT straight
// from device memory (rows of 12 or 48 bytes are not 16-byte aligned, so
// one float a thread, neighbouring threads on neighbouring features) and
// are stored feature-major into shared memory beside the chunk of w.
// Thread (ty, tx) owns tokens 4 ty .. 4 ty + 3 and columns 4 tx + {0..3}
// and 64 + 4 tx + {0..3}: per feature a float4 of the gathered rows (a
// broadcast within each quarter warp) and two of w (128 contiguous bytes a
// quarter warp) feed 32 FFMA.  Ragged tokens, features and columns are
// zero-filled on load and masked on store.

#include "common.cuh"

namespace {

constexpr int kTokens = 64, kCols = 128, kChunk = 32, kThreads = 256, kPad = 4;

__global__ void __launch_bounds__(kThreads)
    gather_project_f32_kernel(const float* __restrict__ x, const int* __restrict__ lut,
                              const float* __restrict__ w, const float* __restrict__ bias,
                              float* __restrict__ out, int n, int k, int m, int group,
                              int d) {
  __shared__ __align__(16) float as[kChunk][kTokens + kPad];
  __shared__ __align__(16) float ws[kChunk][kCols + kPad];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int i0 = blockIdx.x * kTokens, b = blockIdx.y, c0 = blockIdx.z * kCols;
  const int gk = group * k;
  const float* xb = x + static_cast<size_t>(b) * n * k;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < gk; f0 += kChunk) {
    __syncthreads();
#pragma unroll
    for (int e = t; e < kTokens * kChunk; e += kThreads) {
      const int f = e % kChunk, tok = e / kChunk;
      const int gf = f0 + f, i = i0 + tok;
      float v = 0.f;
      if (gf < gk && i < m) {
        const int p = gf / k, kk = gf - p * k;
        v = xb[static_cast<size_t>(lut[i * group + p]) * k + kk];
      }
      as[f][tok] = v;
    }
#pragma unroll
    for (int e = t; e < kChunk * kCols; e += kThreads) {
      const int col = e % kCols, f = e / kCols;
      const int gf = f0 + f, gc = c0 + col;
      ws[f][col] = (gf < gk && gc < d) ? w[static_cast<size_t>(gf) * d + gc] : 0.f;
    }
    __syncthreads();
    const int len = min(kChunk, gk - f0);
    for (int f = 0; f < len; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(&as[f][4 * ty]);
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[f][4 * tx]);
      const float4 w1 = *reinterpret_cast<const float4*>(&ws[f][64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }

  const bool vec = (d % 4) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tok = i0 + 4 * ty + i;
    if (tok >= m) continue;
    float* row = out + (static_cast<size_t>(b) * m + tok) * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = c0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * h + e];
        if (bias != nullptr && gc + e < d) v[e] += bias[gc + e];
      }
      if (vec && gc + 3 < d) {
        *reinterpret_cast<float4*>(row + gc) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < d) row[gc + e] = v[e];
      }
    }
  }
}

}  // namespace

// out (fp32 [batch, m, d]) = the gathered, grouped rows of x (fp32 [batch,
// n, k]) through lut (int32 [m * group], each in [0, n), not checked)
// times w (fp32 [group * k, d]) + bias (fp32 [d], or null).
extern "C" int sfc_gather_project_f32(const void* x, const void* lut, const void* w,
                                      const void* bias, void* out, int batch, int n, int k,
                                      int m, int group, int d, void* stream) {
  if (batch < 0 || n < 1 || k < 1 || m < 0 || group < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTokens - 1) / kTokens, batch, (d + kCols - 1) / kCols);
  gather_project_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lut),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), n, k, m, group, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sfc_gather_project_f32_attrs(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gather_project_f32_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
