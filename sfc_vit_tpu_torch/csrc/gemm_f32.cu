// C = op(A) @ op(B) (+ bias) in float32, summed in float32 by plain FFMA:
// the matrix products of the family-A attention chains (#5, #6) when a
// model computes in float32 (the reference notebook's VisionTransformer,
// and the flagship at its own dtype=None).
//
// Replaces, for float32 compute: the products inside
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (line 82:
// the packed QKV projection and the output projection, each with its bias
// added to the fp32 sum) and ::_torch_mha_bwd_kernel (line 270: datt =
// g W_out^T and dx = dqkv W_in^T, the NT forms; dW_out = att^T g and
// dW_in = x^T dqkv summed over every row, the TN forms).  The TPU kernels
// take any dtype and accumulate in fp32 (preferred_element_type).
//
// Not TF32: the tensor cores' 32-bit path keeps 10 mantissa bits of each
// operand (about three decimal digits), and the port holds fp32 compute to
// the JAX package's fp32 to 1e-4.  wgmma on 32-bit types also needs both
// operands K-major, which the NT and TN forms are not.
//
// Bound on this card: operations, at the H100 SXM's 67 TFLOP/s of fp32
// FFMA outside the tensor cores (2 M N K flops), unless the product is so
// thin that its bytes dominate.
//
// Design (the classic SIMT tile): a block of 256 threads owns a 128 x 128
// tile of C and walks K sixteen deep at a time (against eight: 5-8 %
// faster at the flagship's shapes, the same registers, no spills; two
// blocks an SM by launch bounds spilled at this depth and were slower).
// Each k-slice of op(A) [128 x 16] and op(B) [16 x 128] is read from
// device memory into registers (eight elements a thread, neighbouring
// threads on neighbouring addresses in each layout), stored K-major into
// one of two shared buffers while the other is multiplied, so one
// __syncthreads a slice suffices.  A thread
// owns an 8 x 8 block of C as rows {4ty..4ty+3, 64+4ty..} and columns
// {4tx..4tx+3, 64+4tx..}: per k it reads two float4 of A (a broadcast
// within each quarter warp) and two of B (128 contiguous bytes a quarter
// warp, no bank conflict) for 64 FFMA.  The rows of the shared buffers
// are padded by 4 floats, so the transposing stores of the NN and NT
// loads spread over every bank.  Ragged M, N and K are zero-filled on
// load and masked on store.
//
// A product with too few output tiles to fill the card (the weight
// gradients, TN, summed over every row of the batch; the notebook's
// 2,048-row products) is split into contiguous K ranges: each block writes
// its partial tile to a workspace, and a second kernel sums the partials
// in split order and adds the bias, so the same inputs give the same bits.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;
constexpr int kPad = 4;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of each operand a thread loads

// Thread t's kLoads elements of a k-slice of op(A) [kBM x kBK] (row m, depth
// k): a stored [M, K] (TA false: neighbours along K) or [K, M] (TA true:
// neighbours along M).
template <bool TA>
__device__ __forceinline__ void a_coords(int e, int& m, int& k) {
  if (TA) {
    m = e % kBM;
    k = e / kBM;
  } else {
    k = e % kBK;
    m = e / kBK;
  }
}

// The same for op(B) [kBK x kBN] (depth k, column n): b stored [K, N] (TB
// false: neighbours along N) or [N, K] (TB true: neighbours along K).
template <bool TB>
__device__ __forceinline__ void b_coords(int e, int& k, int& n) {
  if (TB) {
    k = e % kBK;
    n = e / kBK;
  } else {
    n = e % kBN;
    k = e / kBN;
  }
}

template <bool TA, bool TB>
__device__ __forceinline__ void load_slice(const float* __restrict__ a,
                                           const float* __restrict__ b, int M, int N,
                                           int K, int m0, int n0, int k0, int t,
                                           float (&ra)[kLoads], float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    int m, k;
    a_coords<TA>(t + kThreads * i, m, k);
    const int gm = m0 + m, gk = k0 + k;
    ra[i] = (gm < M && gk < K)
                ? (TA ? a[static_cast<size_t>(gk) * M + gm] : a[static_cast<size_t>(gm) * K + gk])
                : 0.f;
    int n;
    b_coords<TB>(t + kThreads * i, k, n);
    const int gn = n0 + n, gk2 = k0 + k;
    rb[i] = (gn < N && gk2 < K)
                ? (TB ? b[static_cast<size_t>(gn) * K + gk2] : b[static_cast<size_t>(gk2) * N + gn])
                : 0.f;
  }
}

template <bool TA, bool TB>
__device__ __forceinline__ void store_slice(float (*as)[kBM + kPad], float (*bs)[kBN + kPad],
                                            int t, const float (&ra)[kLoads],
                                            const float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    int m, k, n;
    a_coords<TA>(t + kThreads * i, m, k);
    as[k][m] = ra[i];
    b_coords<TB>(t + kThreads * i, k, n);
    bs[k][n] = rb[i];
  }
}

// C (or, with splits, the split's partial tile in ws) = op(A) op(B) over
// the 16-deep K blocks [z * per, min(kblocks, (z + 1) * per)) of this
// block's split z, plus bias (fp32 [N], may be null) when unsplit.
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ c,
                    float* __restrict__ ws, int M, int N, int K, int per) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPad];
  __shared__ __align__(16) float bs[2][kBK][kBN + kPad];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kblocks = (K + kBK - 1) / kBK;
  const int kb0 = blockIdx.z * per, kb1 = min(kblocks, kb0 + per);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[kLoads], rb[kLoads];
  if (kb0 < kb1) {
    load_slice<TA, TB>(a, b, M, N, K, m0, n0, kb0 * kBK, t, ra, rb);
    store_slice<TA, TB>(as[0], bs[0], t, ra, rb);
  }
  __syncthreads();
  for (int kb = kb0; kb < kb1; ++kb) {
    const int cur = (kb - kb0) & 1;
    const bool more = kb + 1 < kb1;
    if (more) load_slice<TA, TB>(a, b, M, N, K, m0, n0, (kb + 1) * kBK, t, ra, rb);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_slice<TA, TB>(as[cur ^ 1], bs[cur ^ 1], t, ra, rb);
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
  float* dst = split ? ws + static_cast<size_t>(blockIdx.z) * M * N : c;
  const bool vec = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * h + e];
        if (!split && bias != nullptr && gn + e < N) v[e] += bias[gn + e];
      }
      float* row = dst + static_cast<size_t>(gm) * N;
      if (vec && gn + 3 < N) {
        *reinterpret_cast<float4*>(row + gn) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) row[gn + e] = v[e];
      }
    }
  }
}

// c[i] = sum over s of ws[s][i], in split order, + bias[i % N].
__global__ void __launch_bounds__(256)
    gemm_f32_sum_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                        float* __restrict__ c, int splits, size_t mn, int N) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    if (bias != nullptr) s += bias[i % N];
    c[i] = s;
  }
}

template <bool TA, bool TB>
cudaError_t launch(const float* a, const float* b, const float* bias, float* c, float* ws,
                   int M, int N, int K, int per, cudaStream_t stream) {
  const int kblocks = (K + kBK - 1) / kBK;
  const int splits = kblocks > 0 ? (kblocks + per - 1) / per : 1;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gemm_f32_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(a, b, bias, c, ws, M, N, K, per);
  if (splits > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 132 * 16));
    gemm_f32_sum_kernel<<<blocks, 256, 0, stream>>>(ws, bias, c, splits, mn, N);
  }
  return cudaGetLastError();
}

}  // namespace

// c (fp32 [M, N]) = op(a) @ op(b) + bias, a and b fp32: op(a) is a [M, K]
// or, with trans_a, a stored [K, M]; op(b) is b [K, N] or, with trans_b,
// b stored [N, K]; bias fp32 [N] or null.  K is summed in ranges of `per`
// 16-deep blocks; more than one range needs ws (fp32, one [M, N] partial a
// range).  trans_a and trans_b together are not instantiated.
extern "C" int sfc_gemm_f32(const void* a, const void* b, const void* bias, void* c,
                            void* ws, int M, int N, int K, int trans_a, int trans_b,
                            int per, void* stream) {
  if (M < 0 || N < 0 || K < 0 || per < 1 || (trans_a && trans_b))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int kblocks = (K + kBK - 1) / kBK;
  if (kblocks > per && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  const auto* bi = static_cast<const float*>(bias);
  auto* C = static_cast<float*>(c);
  auto* W = static_cast<float*>(ws);
  cudaError_t err;
  if (trans_a)
    err = launch<true, false>(A, B, bi, C, W, M, N, K, per, s);
  else if (trans_b)
    err = launch<false, true>(A, B, bi, C, W, M, N, K, per, s);
  else
    err = launch<false, false>(A, B, bi, C, W, M, N, K, per, s);
  return static_cast<int>(err);
}

// Registers, local bytes and shared bytes of form 0 (NN), 1 (NT), 2 (TN).
extern "C" int sfc_gemm_f32_attrs(int form, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (form == 0)
    err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, false>);
  else if (form == 1)
    err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, true>);
  else
    err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<true, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + attr.maxDynamicSharedSizeBytes);
  return 0;
}
