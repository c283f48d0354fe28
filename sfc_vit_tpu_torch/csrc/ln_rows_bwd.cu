// Row LayerNorm backward over [R, D]: the epilogue of both backward
// blocks.
//
// Replaces: the LayerNorm backward at the tail of
// sfc_vit_tpu/ops/fused_mlp.py::_mlp_bwd_kernel (lines 319-327, with
// db2 = colsum(g) of line 297) and
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel
// (lines 514-520).  Same arithmetic: mean, E[x^2] - E[x]^2 clamped at 0
// and inv = rsqrt(var + eps) recomputed from the saved bf16 x, xhat =
// (x - mean) * inv; dxh = dxn * scale;
// dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) (+ g) in fp32
// with one rounding; dln_scale += colsum(dxn * xhat), dln_bias +=
// colsum(dxn), and optionally g_sum += colsum(g).
//
// Bound on this card: memory.  Per row it reads D bf16 of x, D fp32 of
// dxn and D bf16 of g and writes D bf16, ~15 flops per element.  Design:
// one warp per row (16-byte vector loads, D % 8 == 0), rows grid-strided
// over a fixed grid of 4-warp blocks.  The column sums, which the TPU
// carried across its sequential row grid in fp32 VMEM, accumulate per
// warp in shared memory (each lane owns its columns: no atomics), then
// per block, then across blocks with one fp32 atomic per column and
// block into outputs the wrapper zeroes (their order varies run to run).

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
                       const float* __restrict__ scale, const bf16* __restrict__ g,
                       bf16* __restrict__ dx, float* __restrict__ dscale,
                       float* __restrict__ dbias, float* __restrict__ gsum,
                       int rows, int d, float eps, int add_g) {
  extern __shared__ float part[];  // [kWarps][nsum][d]
  const int nsum = gsum != nullptr ? 3 : 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = d / 8;
  float* mine = part + static_cast<size_t>(warp) * nsum * d;
  for (int i = lane; i < nsum * d; i += 32) mine[i] = 0.f;
  __syncwarp();

  for (long row = static_cast<long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long>(gridDim.x) * kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const float4* dr = reinterpret_cast<const float4*>(dxn + row * d);
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

    // Pass 2: the two row means and the column sums.
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float v[8], dv[8];
      sfc::unpack_bf16x8(xr[c], v);
      const float4 d0 = dr[2 * c], d1 = dr[2 * c + 1];
      dv[0] = d0.x; dv[1] = d0.y; dv[2] = d0.z; dv[3] = d0.w;
      dv[4] = d1.x; dv[5] = d1.y; dv[6] = d1.z; dv[7] = d1.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = c * 8 + e;
        const float xhat = (v[e] - mean) * inv;
        const float dxh = dv[e] * scale[i];
        m1 += dxh;
        m2 += dxh * xhat;
        mine[i] += dv[e] * xhat;
        mine[d + i] += dv[e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= d;
    m2 /= d;

    // Pass 3: dx (x and dxn rows are in L1 from the passes above).
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
    for (int c = lane; c < chunks; c += 32) {
      float v[8], dv[8], gv[8];
      sfc::unpack_bf16x8(xr[c], v);
      sfc::unpack_bf16x8(gr[c], gv);
      const float4 d0 = dr[2 * c], d1 = dr[2 * c + 1];
      dv[0] = d0.x; dv[1] = d0.y; dv[2] = d0.z; dv[3] = d0.w;
      dv[4] = d1.x; dv[5] = d1.y; dv[6] = d1.z; dv[7] = d1.w;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = c * 8 + e;
        const float xhat = (v[e] - mean) * inv;
        const float dxh = dv[e] * scale[i];
        float r = inv * (dxh - m1 - xhat * m2);
        if (add_g) r += gv[e];
        if (gsum != nullptr) mine[2 * d + i] += gv[e];
        v[e] = r;
      }
      out[c] = sfc::pack_bf16x8(v);
    }
  }

  __syncthreads();
  float* outs[3] = {dscale, dbias, gsum};
  for (int i = threadIdx.x; i < nsum * d; i += kWarps * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[static_cast<size_t>(w) * nsum * d + i];
    atomicAdd(&outs[i / d][i % d], t);
  }
}

}  // namespace

// x bf16 [rows, d], dxn fp32 [rows, d], scale fp32 [d], g bf16 [rows, d];
// dx bf16 [rows, d]; dscale, dbias (and gsum, which may be null) fp32 [d],
// zeroed by the caller, receive the column sums.  add_g adds g to dx
// (the residual's cotangent).  Requires d % 8 == 0 and 16-byte aligned
// pointers.
extern "C" int sfc_ln_rows_bwd_bf16(const void* x, const void* dxn,
                                    const void* scale, const void* g, void* dx,
                                    void* dscale, void* dbias, void* gsum,
                                    int rows, int d, float eps, int add_g,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (d % 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * (gsum != nullptr ? 3 : 2) * d * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int need = (rows + kWarps - 1) / kWarps;
  const int blocks = need < 132 * 4 ? need : 132 * 4;
  ln_rows_bwd_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dxn),
      static_cast<const float*>(scale), static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), static_cast<float*>(dscale),
      static_cast<float*>(dbias), static_cast<float*>(gsum), rows, d, eps, add_g);
  return static_cast<int>(cudaGetLastError());
}
