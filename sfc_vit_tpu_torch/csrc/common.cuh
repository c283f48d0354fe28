// Shared device helpers for the port's Hopper kernels: 16-byte cp.async
// copies with a zero-fill predicate (every kernel masks its own ragged
// edges this way), bf16 packing for 16-byte stores and the two-term bf16
// split of an fp32 value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sfc {

using bf16 = __nv_bfloat16;

// -1e30, never -inf: a fully masked row then gives exp(-1e30 - m) = 0,
// not NaN (the NEG_INF of ops/kernel_utils.py).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without staging in registers.  With
// pred false nothing is read and the 16 shared bytes are zero-filled;
// src must still be a valid address, so callers pass the tensor base.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight fp32 values rounded to bf16 and packed for one 16-byte store.
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// x = hi + lo to about 16 bits of mantissa: an fp32 operand of a tensor-
// core product taken as two bf16 products summed in fp32.
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

// 64 rows r0.. of a row-strided bf16 matrix (columns 0..DH-1) into a
// [64][DH + 8] shared tile, by THREADS threads; rows at or past n are
// zero-filled.  Rows must start on 16 bytes.
template <int DH, int THREADS>
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* base,
                                            long long row_stride, int r0, int n) {
  constexpr int LDH = DH + 8;
  for (int c = threadIdx.x; c < 64 * DH / 8; c += THREADS) {
    const int r = c / (DH / 8), cc = (c % (DH / 8)) * 8;
    const bool ok = r0 + r < n;
    cp_async16(&dst[r * LDH + cc], ok ? base + (r0 + r) * row_stride + cc : base, ok);
  }
}

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The MLP activations and their derivatives in fp32 (act codes of the
// Python launchers: 1 exact-erf GELU, 2 ReLU, anything else identity).
enum Act : int { kNone = 0, kGelu = 1, kRelu = 2 };

__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == kGelu) return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
  if (act == kRelu) return fmaxf(z, 0.f);
  return z;
}

// gelu'(z) = Phi(z) + z * phi(z); relu'(z) = [z > 0].
__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == kGelu)
    return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
           z * expf(-0.5f * z * z) * 0.3989422804014327f;
  if (act == kRelu) return z > 0.f ? 1.f : 0.f;
  return 1.f;
}

}  // namespace sfc
