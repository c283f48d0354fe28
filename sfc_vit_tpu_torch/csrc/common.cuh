// Shared device helpers for the port's Hopper kernels: 16-byte cp.async
// copies with a zero-fill predicate (every kernel masks its own ragged
// edges this way) and bf16 packing for 16-byte stores.
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

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

}  // namespace sfc
