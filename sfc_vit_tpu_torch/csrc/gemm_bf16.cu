// C[M, N] = epilogue(op(A) . op(B)) in bf16 with fp32 accumulators:
// every projection of both fused blocks, forward and backward.
//
// Replaces: the GEMMs inside sfc_vit_tpu/ops/fused_mlp.py::_mlp_kernel
// (fc1 with +b1 and exact-erf GELU, the training forward's saved z, fc2
// with +b2 and the residual), ::_mlp_bwd_kernel (lines 298-318: h^T.g,
// g.W2^T times act'(z) with db1 = colsum(dz), xn^T.dz, dz.W1^T) and
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (the QKV
// projection, rounded to bf16 like qkv_s, and the output projection with
// the residual of x added in fp32) and ::_attn_block_bwd_kernel (lines
// 415-419 and 501-513: gp.W_out^T, att^T.gp, dqkv.W_qkv^T, xn^T.dqkv).
// The epilogue adds each optional term in fp32 and rounds once, which is
// where the TPU kernels round; dxn leaves in fp32 for the LayerNorm
// backward, as the TPU kernel keeps it.
//
// Layouts.  op(A) is A [M, K] as stored, or (trans_a) A stored [K, M]
// and read transposed: the weight gradients, whose contraction runs over
// the R = B*N rows in ONE fp32 sum per output, rounded once at the end
// (the TPU's fp32 accumulator blocks carried that sum across its
// sequential row grid).  op(B) is B [K, N] (a Dense kernel as stored),
// or (trans_b) B stored [N, K]: products with W^T.  No operand is
// transposed by a copy: a transposed tile lands in shared memory as
// stored and the WMMA fragment loads it col_major.
//
// Bound on this card: tensor-core throughput.  At ViT-B batch 256 the
// shapes are R = 50,176 rows by widths of 768..3072: hundreds of flops
// per byte, above the H100's ridge.  Design: 128x128 output tiles per
// 256-thread block, 32-deep K steps staged in shared memory by a
// two-stage cp.async pipeline, bf16 WMMA (mma.sync) fragments with fp32
// accumulators, eight warps each owning a 32x64 sub-tile.  Ragged rows
// (12,544, 50,176 and N = 196 are multiples of no tile) are zero-filled
// on load and skipped on store, so no operand is padded in memory.  The
// weight gradients are [D, F]-sized outputs with a 50,176-deep
// contraction: few tiles (36 for dW_out on 132 SMs), each a long serial
// loop; split-K, wgmma and TMA are later work.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using sfc::bf16;
using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kPad = 8;  // bf16 elements: 16-byte copy slots, 32-byte fragment starts

// Shared tile of op(A) (BM x BK) and op(B) (BK x BN), each as stored:
// A [BM][BK] or, transposed, [BK][BM]; B [BK][BN] or, transposed, [BN][BK].
template <bool TA, bool TB>
struct Tiles {
  static constexpr int kARows = TA ? BK : BM, kALd = (TA ? BM : BK) + kPad;
  static constexpr int kBRows = TB ? BN : BK, kBLd = (TB ? BK : BN) + kPad;
  bf16 a[kStages][kARows * kALd];
  bf16 b[kStages][kBRows * kBLd];
};

struct Epilogue {
  const float* bias;      // fp32 [N], added first
  const bf16* z_in;       // bf16 [M, N]: multiply by act'(z) instead of act()
  bf16* z_out;            // bf16 [M, N]: the pre-activation, rounded
  float* colsum;          // fp32 [N]: += column sums of the fp32 result
  const bf16* residual;   // bf16 [M, N], added last
  int act;
  bool c_fp32;            // C is fp32 [M, N] instead of bf16
};

template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     void* __restrict__ C, int M, int N, int K, Epilogue ep) {
  using T = Tiles<TA, TB>;
  __shared__ __align__(128) unsigned char raw[sizeof(T)];
  T& sm = *reinterpret_cast<T*>(raw);
  static_assert(sizeof(T) >= (kThreads * 8 + BN) * sizeof(float),
                "epilogue staging must fit in the pipeline buffers");

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2;  // 4 warp rows of 32
  const int wn = warp % 2;  // 2 warp columns of 64
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    constexpr int kACols = TA ? BM : BK;
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (kACols / 8), cc = (c % (kACols / 8)) * 8;
      // row r, columns cc..cc+7 of A's tile as stored
      const int gm = TA ? m0 + cc : m0 + r, gk = TA ? k0 + r : k0 + cc;
      const bool ok = gm < M && gk < K;
      const size_t off = TA ? static_cast<size_t>(gk) * M + gm
                            : static_cast<size_t>(gm) * K + gk;
      sfc::cp_async16(&sm.a[stage][r * T::kALd + cc], ok ? A + off : A, ok);
    }
    constexpr int kBCols = TB ? BK : BN;
    for (int c = tid; c < BK * BN / 8; c += kThreads) {
      const int r = c / (kBCols / 8), cc = (c % (kBCols / 8)) * 8;
      const int gn = TB ? n0 + r : n0 + cc, gk = TB ? k0 + cc : k0 + r;
      const bool ok = gk < K && gn < N;
      const size_t off = TB ? static_cast<size_t>(gn) * K + gk
                            : static_cast<size_t>(gk) * N + gn;
      sfc::cp_async16(&sm.b[stage][r * T::kBLd + cc], ok ? B + off : B, ok);
    }
  };

  using ALayout = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16;
        wmma::load_matrix_sync(
            af[i], &sm.a[st][TA ? kk * T::kALd + m : m * T::kALd + kk], T::kALd);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 64 + j * 16;
        wmma::load_matrix_sync(
            bfr[j], &sm.b[st][TB ? n * T::kBLd + kk : kk * T::kBLd + n], T::kBLd);
      }
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
  // columns of one row.  Column sums reduce over the fragment's 16 rows
  // by shuffles, over the block in shared memory, and over blocks with
  // one fp32 atomic per column and block (their order varies run to run).
  float* stage = reinterpret_cast<float*>(raw) + warp * 256;
  float* csum = reinterpret_cast<float*>(raw) + kThreads * 8;
  if (ep.colsum != nullptr) {
    for (int t = tid; t < BN; t += kThreads) csum[t] = 0.f;
    __syncthreads();
  }
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + r;
      const int gn = n0 + wn * 64 + j * 16 + c0;
      const bool in = gr < M && gn < N;  // N % 8 == 0: a chunk is all in or all out
      const size_t off = static_cast<size_t>(gr) * N + gn;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = stage[r * 16 + c0 + e];
      if (in) {
        if (ep.bias != nullptr) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += ep.bias[gn + e];
        }
        if (ep.z_out != nullptr)
          *reinterpret_cast<uint4*>(ep.z_out + off) = sfc::pack_bf16x8(v);
        if (ep.z_in != nullptr) {
          float z[8];
          sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(ep.z_in + off), z);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] *= sfc::act_grad(z[e], ep.act);
        } else if (ep.act != sfc::kNone) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = sfc::act_fwd(v[e], ep.act);
        }
      }
      if (ep.colsum != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float s = in ? v[e] : 0.f;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane < 2) atomicAdd(&csum[wn * 64 + j * 16 + c0 + e], s);
        }
      }
      if (in) {
        if (ep.residual != nullptr) {
          float x[8];
          sfc::unpack_bf16x8(*reinterpret_cast<const uint4*>(ep.residual + off), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += x[e];
        }
        if (ep.c_fp32) {
          float4* dst = reinterpret_cast<float4*>(static_cast<float*>(C) + off);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + off) = sfc::pack_bf16x8(v);
        }
      }
      __syncwarp();
    }
  }
  if (ep.colsum != nullptr) {
    __syncthreads();
    for (int t = tid; t < BN; t += kThreads)
      if (n0 + t < N) atomicAdd(&ep.colsum[n0 + t], csum[t]);
  }
}

template <bool TA, bool TB>
void launch(const dim3& grid, cudaStream_t stream, const bf16* a, const bf16* b,
            void* c, int M, int N, int K, const Epilogue& ep) {
  gemm_bf16_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(a, b, c, M, N, K, ep);
}

}  // namespace

// C [M, N] = op(A) . op(B) with the epilogue, in this order: + bias (fp32
// [N]); z_out = bf16(sum); times act'(z_in) when z_in is given, else
// act(); colsum += the fp32 column sums; + residual (bf16 [M, N]); one
// rounding into C (bf16, or fp32 when c_fp32).  Every pointer but a, b
// and c may be null.  act: 0 none, 1 exact-erf GELU, 2 ReLU.  trans_a:
// A is stored [K, M]; trans_b: B is stored [N, K].  Requires N % 8 == 0,
// M % 8 == 0 when trans_a, K % 8 == 0 unless (trans_a and not trans_b),
// and 16-byte aligned pointers; the Python wrapper checks these.
extern "C" int sfc_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* residual, const void* z_in,
                             void* z_out, void* colsum, void* c, int c_fp32,
                             int M, int N, int K, int trans_a, int trans_b,
                             int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const Epilogue ep{static_cast<const float*>(bias), static_cast<const bf16*>(z_in),
                    static_cast<bf16*>(z_out), static_cast<float*>(colsum),
                    static_cast<const bf16*>(residual), act, c_fp32 != 0};
  const auto* A = static_cast<const bf16*>(a);
  const auto* B = static_cast<const bf16*>(b);
  auto s = static_cast<cudaStream_t>(stream);
  if (trans_a && trans_b) return static_cast<int>(cudaErrorInvalidValue);
  if (trans_a) launch<true, false>(grid, s, A, B, c, M, N, K, ep);
  else if (trans_b) launch<false, true>(grid, s, A, B, c, M, N, K, ep);
  else launch<false, false>(grid, s, A, B, c, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

// h = bf16(act(z)) elementwise over n bf16 values (n % 8 == 0): the
// backward's recomputed MLP hidden, the A operand of dW2 = h^T . g.
namespace {
__global__ void act_bf16_kernel(const bf16* __restrict__ z, bf16* __restrict__ h,
                                size_t chunks, int act) {
  for (size_t c = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       c < chunks; c += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[8];
    sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(z)[c], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sfc::act_fwd(v[e], act);
    reinterpret_cast<uint4*>(h)[c] = sfc::pack_bf16x8(v);
  }
}
}  // namespace

extern "C" int sfc_act_bf16(const void* z, void* h, long long n, int act,
                            void* stream) {
  if (n <= 0) return 0;
  const size_t chunks = static_cast<size_t>(n) / 8;
  const int threads = 256;
  const size_t want = (chunks + threads - 1) / threads;  // grid-stride past 16 blocks per SM
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  act_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), static_cast<bf16*>(h), chunks, act);
  return static_cast<int>(cudaGetLastError());
}
