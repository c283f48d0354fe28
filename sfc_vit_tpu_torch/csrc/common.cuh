// Shared device helpers for the port's Hopper kernels: 16-byte cp.async
// copies with a zero-fill predicate (every kernel masks its own ragged
// edges this way) and bf16 packing for 16-byte stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

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

// The same for 4 bytes (the .ca form: 4 and 8 bytes may not bypass L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A device lambda the compiler must inline, as __forceinline__ makes a
// function: a kernel that calls one lambda many times (an fp32 attention
// at four sub-heads) otherwise gets it as a real call, its register arrays
// then passed through a stack frame in local memory.
#define SFC_INLINE_LAMBDA __attribute__((always_inline))

// f(std::integral_constant<int, i>{}) for i = 0 .. N - 1: a loop whose
// index is a compile-time constant in the body (a template argument).
template <typename F, int... I>
__device__ __forceinline__ void static_for_seq(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_seq(f, std::make_integer_sequence<int, N>{});
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

// One LayerNorm output, (v - mean) * inv * scale + bias, in the one
// rounding order every LayerNorm kernel here uses (a product, then one
// fma): a kernel that rebuilds another's output from its saved mean and
// inv gets the same bits.
__device__ __forceinline__ float ln_apply(float v, float mean, float inv, float scale,
                                          float bias) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(v, mean), inv), scale, bias);
}

// x / d, correctly rounded, from rd = RN(1 / d): q = RN(x rd), then one
// correction q + (x - q d) rd by fma (Markstein), which is the IEEE
// quotient wherever x and x / d are normal
// (tests/test_torch_kernels.py::test_div_rn_is_the_correctly_rounded_quotient).
// Three instructions where `x / d` is a subroutine with a slow-path branch.
__device__ __forceinline__ float div_rn(float x, float d, float rd) {
  const float q = __fmul_rn(x, rd);
  return __fmaf_rn(__fmaf_rn(-q, d, x), rd, q);
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

// out[i] = the sum of ws[b, i] over b < blocks, for i < total, in a fixed
// order: warp w of kWarps sums rows w, w + kWarps, ... of ws in turn
// (eight loads in flight), then warp 0 adds the warp sums in warp order.
// A block of kWarps * 32 threads covers 32 consecutive i.  The column
// sums of ln_rows_bwd.cu and colsum_bf16.cu add their blocks' partials so
// (ops/kernel_utils.py::colsum_fixed_order is this order in PyTorch).  It
// may be launched as a programmatic dependent of the kernel that writes
// ws: griddepcontrol.wait holds it until that grid's writes are visible,
// and returns at once in an ordinary launch.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    slice_sum_kernel(const float* __restrict__ ws, float* __restrict__ out, int blocks,
                     int total) {
  __shared__ float part[kWarps][33];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (i < total) {
    int b = w;
    for (; b + 7 * kWarps < blocks; b += 8 * kWarps) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = ws[static_cast<size_t>(b + k * kWarps) * total + i];
#pragma unroll
      for (int k = 0; k < 8; ++k) t += v[k];
    }
    for (; b < blocks; b += kWarps) t += ws[static_cast<size_t>(b) * total + i];
  }
  part[w][lane] = t;
  __syncthreads();
  if (w == 0 && i < total) {
    float s = part[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += part[k][lane];
    out[i] = s;
  }
}

}  // namespace sfc
