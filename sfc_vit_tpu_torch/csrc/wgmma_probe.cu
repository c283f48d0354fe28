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

#include "sm90.cuh"

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
  const uint32_t pad = (1024 - (sfc::smem_addr(dyn) & 1023)) & 1023;
  ProbeSmem& sm = *reinterpret_cast<ProbeSmem*>(dyn + pad);
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

}  // namespace

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
