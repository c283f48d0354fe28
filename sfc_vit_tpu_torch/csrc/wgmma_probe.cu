// One m64n64 wgmma product over a depth of 64 (four k16 steps) through
// each operand form the flash kernels #8 and #9 use, for the GPU tests: a
// descriptor or swizzle mistake then fails in a 64 x 64 product, not
// inside a softmax.  Not on any model's path.
//
// d fp32 [64][64] = A . B with A [M = 64][K = 64] and B [K = 64][N = 64]
// given as bf16 matrices stored as the form reads them:
//  form 0: A row-major [M][K] in a swizzled tile (K-major), B as [N][K]
//          (K-major, the layout of s = q . k^T);
//  form 1: A from registers (the accumulator-shaped fragments of p . v),
//          B as [N][K];
//  form 2: A K-major, B as [K][N] through the transpose bit (v, g, q);
//  form 3: A from registers, B as [K][N] through the transpose bit;
//  form 4: A as [K][M] through the transpose bit (#9's ds^T read as ds),
//          B as [K][N] through the transpose bit.
// B arrives by TMA (128-byte swizzle, mbarrier), A is written by the
// threads with sfc::sm90::sw128_bf16, the layout #9 writes ds^T in.
//
// The TF32 forms (csrc/gemm_f32.cu's operands): d fp32 [64][64] = A . B
// over a depth of 32 (four k8 steps) from fp32 A [M = 64][K = 32] and B
// stored [N = 64][K = 32] (K-major, as wgmma takes 32-bit types), B by
// TMA into a 128-byte-swizzled fp32 tile:
//  form 0: A from registers, the fp32 bits as given (what the tensor
//          cores take of the 13 bits below TF32's mantissa shows here);
//  form 1: A K-major from shared memory, as given;
//  form 2: the 3xTF32 split of both (A split in registers, B's big and
//          small tiles written by the threads): gemm_f32.cu's arithmetic;
//  form 3: the fp32 attention's P V (csrc/attn_f32.cuh), over a depth of 64
//          (eight k8 steps): A [64 m][64 k] held as an m64n64 accumulator
//          and taken as the A operand under the key permutation (a_perm),
//          B stored [K = 64][N = 64] (as V is, [key][Dh]) brought by
//          map_heads and written transposed into K-major big and small
//          tiles (split_transposed), the three products by attn_f32::mma3.
// sfc_tf32_round applies the device's cvt.rna.tf32.f32 and gemm_f32.cu's
// split elementwise.

#include "attn_f32.cuh"

namespace {

namespace hw = sfc::sm90;
using sfc::bf16;

struct alignas(1024) ProbeSmem {
  unsigned char a[64 * 128];
  unsigned char b[64 * 128];
  uint64_t bar;
};

__global__ void __launch_bounds__(128) wgmma_probe(const __grid_constant__ CUtensorMap bmap,
                                                   const bf16* __restrict__ a,
                                                   float* __restrict__ d, int form) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  ProbeSmem& sm = hw::aligned_smem<ProbeSmem>(dyn);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (t == 0) {
    hw::bar_init(&sm.bar, 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    hw::bar_expect_tx(&sm.bar, 64 * 128);
    hw::tma_load4(sm.b, &bmap, &sm.bar, 0, 0, 0, 0);
  }
  for (int i = t; i < 64 * 64; i += 128) {  // a as stored: 64 rows of 64
    const int row = i / 64, col = i % 64;
    *reinterpret_cast<bf16*>(sm.a + hw::sw128_bf16(row, col)) = a[i];
  }
  hw::fence_async_shared();
  __syncthreads();
  hw::bar_wait(&sm.bar, 0);

  const int r = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const uint64_t da = hw::desc_sw128(sm.a), db = hw::desc_sw128(sm.b);
  const bool trans_b = form >= 2;
  float acc[32];
  uint32_t frag[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e % 2), col = 16 * kk + c0 + 8 * (e / 2);
      frag[kk][e] = *reinterpret_cast<const uint32_t*>(a + row * 64 + col);
    }
  hw::fence_regs(acc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // K-major operands step 32 bytes along the row, MN-major ones 16 rows.
    const uint64_t bk = db + (trans_b ? kk * (2048 >> 4) : 2 * kk);
    if (form == 0) hw::wgmma_ss<0, 0>(acc, da + 2 * kk, bk, kk);
    if (form == 1) hw::wgmma_rs<0>(acc, frag[kk], bk, kk);
    if (form == 2) hw::wgmma_ss<0, 1>(acc, da + 2 * kk, bk, kk);
    if (form == 3) hw::wgmma_rs<1>(acc, frag[kk], bk, kk);
    if (form == 4) hw::wgmma_ss<1, 1>(acc, da + kk * (2048 >> 4), bk, kk);
  }
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
  hw::fence_regs(acc);
  hw::fence_frags(frag);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(r + 8 * hf) * 64 + 8 * j + c0 + e] = acc[4 * j + 2 * hf + e];
}

struct alignas(1024) ProbeTf32Smem {
  unsigned char a[64 * 128];      // A [64 m][32 k], 128-byte swizzled
  unsigned char b[64 * 128];      // B [64 n][32 k] as TMA lands it
  unsigned char big[64 * 128];    // form 2: B's split, the same layout
  unsigned char small[64 * 128];
  uint64_t bar;
};

__global__ void __launch_bounds__(128) wgmma_probe_tf32(const __grid_constant__ CUtensorMap bmap,
                                                        const float* __restrict__ a,
                                                        float* __restrict__ d, int form) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  ProbeTf32Smem& sm = hw::aligned_smem<ProbeTf32Smem>(dyn);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (t == 0) {
    hw::bar_init(&sm.bar, 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    hw::bar_expect_tx(&sm.bar, 64 * 128);
    hw::tma_load2(sm.b, &bmap, &sm.bar, 0, 0);
  }
  for (int i = t; i < 64 * 32; i += 128)
    *reinterpret_cast<float*>(sm.a + hw::sw128_f32(i / 32, i % 32)) = a[i];
  hw::bar_wait(&sm.bar, 0);
  for (int i = t; i < 64 * 32; i += 128) {
    const int off = hw::sw128_f32(i / 32, i % 32);
    uint32_t hi, lo;
    hw::tf32_split(*reinterpret_cast<const float*>(sm.b + off), hi, lo);
    *reinterpret_cast<uint32_t*>(sm.big + off) = hi;
    *reinterpret_cast<uint32_t*>(sm.small + off) = lo;
  }
  hw::fence_async_shared();
  __syncthreads();

  const int r = warp * 16 + lane / 4, tq = lane % 4;
  uint32_t raw[4][4], big[4][4], small[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = a[(r + 8 * (e & 1)) * 32 + 8 * kk + tq + 4 * (e >> 1)];
      raw[kk][e] = __float_as_uint(x);
      hw::tf32_split(x, big[kk][e], small[kk][e]);
    }
  const uint64_t da = hw::desc_sw128(sm.a), db = hw::desc_sw128(sm.b);
  const uint64_t dbig = hw::desc_sw128(sm.big), dsmall = hw::desc_sw128(sm.small);
  float acc[32];
  hw::fence_regs(acc);
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // a k8 step is 32 bytes along the rows
    if (form == 0) hw::wgmma_tf32_rs(acc, raw[kk], db + 2 * kk, kk);
    if (form == 1) hw::wgmma_tf32_ss(acc, da + 2 * kk, db + 2 * kk, kk);
    if (form == 2) {
      hw::wgmma_tf32_rs(acc, big[kk], dsmall + 2 * kk, kk);
      hw::wgmma_tf32_rs(acc, small[kk], dbig + 2 * kk, 1);
      hw::wgmma_tf32_rs(acc, big[kk], dbig + 2 * kk, 1);
    }
  }
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
  hw::fence_regs(acc);
  hw::fence_frags(raw);
  hw::fence_frags(big);
  hw::fence_frags(small);
  const int c0 = 2 * tq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(r + 8 * hf) * 64 + 8 * j + c0 + e] = acc[4 * j + 2 * hf + e];
}

__global__ void __launch_bounds__(128) wgmma_probe_perm(const __grid_constant__ CUtensorMap bmap,
                                                        const float* __restrict__ a,
                                                        float* __restrict__ d) {
  namespace af = sfc::attn_f32;
  using S = af::Smem<1>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  S& sm = hw::aligned_smem<S>(dyn);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (t == 0) {
    hw::bar_init(&sm.full[0], 1);
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) af::load_sub(sm, 0, &bmap, 0, 0, 0, 0);
  af::split_entry(sm, 0, true);

  const int r = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float x[32], acc[32];  // A in the accumulator's layout
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) x[4 * j + 2 * hf + e] = a[(r + 8 * hf) * 64 + 8 * j + c0 + e];
  uint64_t db, dsm;
  af::pair_desc(sm, db, dsm);
  uint32_t fb[2][4], fs[2][4];
  af::mma3<64, 8>(
      acc, db, dsm, [&](auto kk, float (&v)[4]) { af::a_perm(x, decltype(kk)::value, v); }, fb,
      fs, 0);
  af::drain(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(r + 8 * hf) * 64 + 8 * j + c0 + e] = acc[4 * j + 2 * hf + e];
}

__global__ void tf32_round_kernel(const float* __restrict__ x, float* __restrict__ y,
                                  float* __restrict__ big, float* __restrict__ small, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (y != nullptr) y[i] = __uint_as_float(hw::tf32_rna(x[i]));
  if (big != nullptr) {
    uint32_t hi, lo;
    hw::tf32_split(x[i], hi, lo);
    big[i] = __uint_as_float(hi);
    small[i] = __uint_as_float(lo);
  }
}

}  // namespace

// a fp32 [64][32] (M, K) and b fp32 [64][32] (N, K) contiguous, d fp32
// [64][64]; form in 0..2 (see above).  Form 3: a fp32 [64][64] (M, K) and
// b fp32 [64][64] (K, N).
extern "C" int sfc_wgmma_probe_tf32(const void* a, const void* b, void* d, int form,
                                    void* stream) {
  if (form < 0 || form > 3) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap bmap;
  if (form == 3) {
    namespace af = sfc::attn_f32;
    cudaError_t e = hw::map_heads(&bmap, b, true, 1, 64, 1, 64, 64, 64);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int smem = af::kSmemBytes<1>;
    e = cudaFuncSetAttribute(wgmma_probe_perm, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    wgmma_probe_perm<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        bmap, static_cast<const float*>(a), static_cast<float*>(d));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = hw::map_2d_f32(&bmap, b, 32, 64, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = static_cast<int>(sizeof(ProbeTf32Smem)) + 1024;
  e = cudaFuncSetAttribute(wgmma_probe_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe_tf32<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      bmap, static_cast<const float*>(a), static_cast<float*>(d), form);
  return static_cast<int>(cudaGetLastError());
}

// For i < n: y[i] = x[i] rounded to TF32 by cvt.rna.tf32.f32 (fp32 bits,
// the low 13 zero), and (big[i], small[i]) = gemm_f32.cu's split of x[i]
// (sfc::sm90::tf32_split); each output may be null (big and small
// together).
extern "C" int sfc_tf32_round(const void* x, void* y, void* big, void* small, int n,
                              void* stream) {
  if (n < 0 || (big == nullptr) != (small == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  tf32_round_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(big),
      static_cast<float*>(small), n);
  return static_cast<int>(cudaGetLastError());
}

// a bf16 [64][64] and b bf16 [64][64] contiguous, as the form reads them
// (see above); d fp32 [64][64].  form in 0..4.
extern "C" int sfc_wgmma_probe_bf16(const void* a, const void* b, void* d, int form,
                                    void* stream) {
  if (form < 0 || form > 4) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap bmap;
  cudaError_t e = hw::map_bnhd(&bmap, b, 1, 64, 1, 64 * 64, 64, 64, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = static_cast<int>(sizeof(ProbeSmem)) + 1024;
  e = cudaFuncSetAttribute(wgmma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      bmap, static_cast<const bf16*>(a), static_cast<float*>(d), form);
  return static_cast<int>(cudaGetLastError());
}
