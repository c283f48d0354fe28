// C[R, N] = epilogue(A[R, K] . B[K, N]) in bf16 with fp32 accumulators:
// every projection of both fused blocks.
//
// Replaces: the GEMMs inside sfc_vit_tpu/ops/fused_mlp.py::_mlp_kernel
// (fc1 with +b1 and exact-erf GELU, fc2 with +b2 and the residual) and
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (the QKV
// projection, rounded to bf16 like qkv_s, and the output projection with
// the residual of x added in fp32).  The epilogue adds each optional term
// in fp32 and rounds to bf16 once, which is where the TPU kernel rounds.
//
// Bound on this card: tensor-core throughput.  At ViT-B batch 64 the
// shapes are R = 12,544 rows by (K, N) in {(768, 2304), (768, 768),
// (768, 3072), (3072, 768)}: 2*R*K*N flops over ~2*(R*K + K*N + R*N)
// bytes is several hundred flops per byte, above the H100's ridge.
// Design: 128x128 output tiles per 256-thread block, 32-deep K steps
// staged in shared memory by a two-stage cp.async pipeline, bf16 WMMA
// (mma.sync) fragments with fp32 accumulators, eight warps each owning a
// 32x64 sub-tile.  The weight is read [K, N] as stored.  Ragged rows
// (12,544 and N = 196 are multiples of no tile) are zero-filled on load
// and skipped on store, so no operand is padded in memory.  The TPU kept
// the MLP hidden [R, F] in VMEM between fc1 and fc2; here it passes
// through L2/HBM (two GEMMs), and keeping it on chip, like moving to
// wgmma and TMA, is later work.

#include <mma.h>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;  // 80-byte rows: 16-byte copy slots, 32-byte fragment starts
constexpr int LDB = BN + 8;  // 272-byte rows
constexpr int kThreads = 256;
constexpr int kStages = 2;

struct Smem {
  bf16 a[kStages][BM * LDA];
  bf16 b[kStages][BK * LDB];
};

enum Act : int { kNone = 0, kGelu = 1, kRelu = 2 };

__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ residual, bf16* __restrict__ C,
                     int R, int N, int K, int act) {
  __shared__ __align__(128) unsigned char raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2;  // 4 warp rows of 32
  const int wn = warp % 2;  // 2 warp columns of 64
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < R && gk < K;
      sfc::cp_async16(&sm.a[stage][r * LDA + kc],
                      ok ? A + static_cast<size_t>(gr) * K + gk : A, ok);
    }
    for (int c = tid; c < BK * BN / 8; c += kThreads) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      sfc::cp_async16(&sm.b[stage][r * LDB + nc],
                      ok ? B + static_cast<size_t>(gk) * N + gn : B, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  sfc::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile((kt + 1) % kStages, kt + 1);
    sfc::cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    sfc::cp_async_wait<1>();
    __syncthreads();
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &sm.a[st][(wm * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], &sm.b[st][kk * LDB + wn * 64 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  sfc::cp_async_wait<0>();
  __syncthreads();

  // Epilogue: each warp stages one 16x16 fp32 fragment at a time in the
  // (now idle) pipeline buffer; each lane then finishes 8 contiguous
  // columns of one row and writes them as one 16-byte store.
  float* stage = reinterpret_cast<float*>(raw) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c0;
      if (gr < R && gn < N) {  // N % 8 == 0: a chunk is all in or all out
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = stage[r * 16 + c0 + e];
        if (bias != nullptr) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bias[gn + e];
        }
        if (act == kGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
        } else if (act == kRelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        }
        const size_t off = static_cast<size_t>(gr) * N + gn;
        if (residual != nullptr) {
          float x[8];
          sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(residual + off), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += x[e];
        }
        *reinterpret_cast<uint4*>(C + off) = sfc::pack_bf16x8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// bias (fp32 [N]) and residual (bf16 [R, N]) may be null.  act: 0 none,
// 1 exact-erf GELU, 2 ReLU, applied after the bias and before the
// residual.  Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned
// pointers; the Python wrapper checks these.
extern "C" int sfc_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* residual, void* c, int R, int N,
                             int K, int act, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual),
      static_cast<bf16*>(c), R, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
