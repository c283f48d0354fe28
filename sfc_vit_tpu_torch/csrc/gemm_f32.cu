// C = epilogue(op(A) @ op(B)) in float32, summed in float32 by plain FFMA:
// the matrix products of the fused blocks (#1-#4) and of the family-A
// attention chains (#5, #6) when a model computes in float32 (the ViT-B/16
// and ViT-S/16 presets at their own dtype=None, the reference notebook's
// VisionTransformer, and the flagship at its own dtype=None).
//
// Replaces, for float32 compute: the products inside
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (line 104:
// the QKV projection, and the output projection + the residual) and
// ::_attn_block_bwd_kernel (line 333: datt = g W_out^T and dxn = dqkv
// W_qkv^T, the NT forms; dW_out and dW_qkv, the TN forms),
// sfc_vit_tpu/ops/fused_mlp.py::_mlp_kernel (line 104: fc1 + b1 + GELU
// with z saved, fc2 + b2 + the residual) and ::_mlp_bwd_kernel (line 237:
// dz = (g W2^T) GELU'(z) with db1 = colsum(dz), dxn = dz W1^T; dW2, dW1),
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (line 82:
// the packed QKV projection and the output projection, each with its bias
// added to the fp32 sum) and ::_torch_mha_bwd_kernel (line 270: datt =
// g W_out^T and dx = dqkv W_in^T, the NT forms; dW_out = att^T g and
// dW_in = x^T dqkv summed over every row, the TN forms).  The TPU kernels
// take any dtype and accumulate in fp32 (preferred_element_type).
//
// The epilogue, per element of the fp32 sum, in this order: + bias[n];
// the pre-activation written to z_out; then either x act'(z_in) (the
// backward's dz) or act (exact-erf GELU or ReLU); the column sums of that
// value; + residual (fp32 [M, N]).  The column sums have one owner each
// and a fixed order, no atomics: each block's 128-row stripe sums its own
// rows in a fixed order into a partial row of a workspace (after a split-K
// sum, each row is its own stripe), and a third kernel adds the stripes'
// partials in stripe order, so a second call gives the same bits.  The
// bias-only products (the projections of #5, the plain products) run an
// instance (and a split-K sum) without the epilogue's code, which slowed
// them when they shared it (the flagship's fp32 QKV projection: 30 TFLOP/s
// against 38, H100).
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
// in split order and applies the whole epilogue to the sum, never to a
// partial, so the same inputs give the same bits.

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

// What follows the sum, per element (the order of the file's header).
struct Epilogue {
  const float* bias;      // [N] or null
  const float* residual;  // [M, N] or null: added last
  const float* z_in;      // [M, N] or null: the value times act'(z_in) in place of act
  float* z_out;           // [M, N] or null: the pre-activation (the sum + bias)
  float* col;             // [stripes, N] or null: each row stripe's column sums
  int act;                // sfc::Act
};

// Row m, columns n .. n + 3 (those below nlim) of the fp32 sum v through
// the epilogue, in place, over rows of N; cs[k] += column n + k's value
// before the residual.  vec: N % 4 == 0 and all four columns below nlim
// (16-byte accesses).
__device__ __forceinline__ void finish4(float (&v)[4], const Epilogue e, int m, int n, int N,
                                        int nlim, bool vec, float* cs) {
  const size_t i0 = static_cast<size_t>(m) * N + n;
  float zi[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    if (e.z_in != nullptr) {
      const float4 t = *reinterpret_cast<const float4*>(e.z_in + i0);
      zi[0] = t.x, zi[1] = t.y, zi[2] = t.z, zi[3] = t.w;
    }
    if (e.residual != nullptr) {
      const float4 t = *reinterpret_cast<const float4*>(e.residual + i0);
      r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (n + k >= nlim) continue;
      if (e.z_in != nullptr) zi[k] = e.z_in[i0 + k];
      if (e.residual != nullptr) r[k] = e.residual[i0 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e.bias != nullptr && n + k < nlim) v[k] += e.bias[n + k];
  if (e.z_out != nullptr) {
    if (vec) {
      *reinterpret_cast<float4*>(e.z_out + i0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n + k < nlim) e.z_out[i0 + k] = v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = e.z_in != nullptr ? v[k] * sfc::act_grad(zi[k], e.act) : sfc::act_fwd(v[k], e.act);
    if (n + k < nlim) cs[k] += v[k];
    v[k] += r[k];
  }
}

// C (or, with splits, the split's partial tile in ws) = op(A) op(B) over
// the 16-deep K blocks [z * per, min(kblocks, (z + 1) * per)) of this
// block's split z, then, when unsplit, + e.bias (EPI false: the bias-only
// products, whose code stays free of the epilogue's registers) or the
// whole epilogue (EPI true).
template <bool TA, bool TB, bool EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const Epilogue e, float* __restrict__ c, float* __restrict__ ws, int M,
                    int N, int K, int per) {
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
  if constexpr (!EPI) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (gm >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + 64 * h + 4 * tx;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = acc[i][4 * h + k];
          if (!split && e.bias != nullptr && gn + k < N) v[k] += e.bias[gn + k];
        }
        float* row = dst + static_cast<size_t>(gm) * N;
        if (vec && gn + 3 < N) {
          *reinterpret_cast<float4*>(row + gn) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (gn + k < N) row[gn + k] = v[k];
        }
      }
    }
  } else {
    float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (gm >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + 64 * h + 4 * tx;
        if (gn >= N) continue;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = acc[i][4 * h + k];
        if (!split) finish4(v, e, gm, gn, N, N, vec && gn + 3 < N, cs + 4 * h);
        float* row = dst + static_cast<size_t>(gm) * N;
        if (vec && gn + 3 < N) {
          *reinterpret_cast<float4*>(row + gn) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (gn + k < N) row[gn + k] = v[k];
        }
      }
    }
    if (split || e.col == nullptr) return;
    // The tile's column sums: each thread's eight rows in order (above),
    // then the 16 row groups in ty order, through the idle A buffers (the
    // K loop ended on a barrier).
    float* red = &as[0][0][0];  // [16][128]
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty * kBN + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4)] = cs[j];
    __syncthreads();
    if (t < kBN && n0 + t < N) {
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) sum += red[y * kBN + t];
      e.col[static_cast<size_t>(blockIdx.y) * N + n0 + t] = sum;
    }
  }
}

// c[i] = the sum over s of ws[s][i], in split order, + e.bias (EPI false)
// or through the whole epilogue (EPI true), a thread an element
// (grid-stride); with the column sums, e.col[i] takes the element's value
// before the residual (a stripe of one row).
template <bool EPI>
__global__ void __launch_bounds__(256)
    gemm_f32_sum_kernel(const float* __restrict__ ws, const Epilogue e, float* __restrict__ c,
                        int splits, int M, int N) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < splits; ++z) v[0] += ws[z * mn + i];
    if constexpr (EPI) {
      const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
      float cs[4] = {0.f, 0.f, 0.f, 0.f};
      finish4(v, e, m, n, N, n + 1, false, cs);  // column n alone
      if (e.col != nullptr) e.col[i] = cs[0];
    } else if (e.bias != nullptr) {
      v[0] += e.bias[i % N];
    }
    c[i] = v[0];
  }
}

// out[n] = the sum over the stripes s < stripes of col[s][n], in a fixed
// order: warp w sums stripes w, w + 32, ... in turn, then warp 0 adds the
// 32 warp sums in warp order.  A block covers 32 consecutive columns.
__global__ void __launch_bounds__(1024)
    gemm_f32_colsum_kernel(const float* __restrict__ col, float* __restrict__ out, int stripes,
                           int N) {
  __shared__ float part[32][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (n < N)
    for (int r = w; r < stripes; r += 32) s += col[static_cast<size_t>(r) * N + n];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && n < N) {
    float total = part[0][lane];
#pragma unroll
    for (int k = 1; k < 32; ++k) total += part[k][lane];
    out[n] = total;
  }
}

// h = act(z) over n4 float4s, grid-stride.
__global__ void __launch_bounds__(256)
    act_f32_kernel(const float4* __restrict__ z, float4* __restrict__ h, size_t n4, int act) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = z[i];
    h[i] = make_float4(sfc::act_fwd(v.x, act), sfc::act_fwd(v.y, act), sfc::act_fwd(v.z, act),
                       sfc::act_fwd(v.w, act));
  }
}

template <bool TA, bool TB>
cudaError_t launch(const float* a, const float* b, const Epilogue& e, float* colsum, float* c,
                   float* ws, int M, int N, int K, int per, cudaStream_t stream) {
  const int kblocks = (K + kBK - 1) / kBK;
  const int splits = kblocks > 0 ? (kblocks + per - 1) / per : 1;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const bool epi = e.residual != nullptr || e.z_in != nullptr || e.z_out != nullptr ||
                   e.col != nullptr || e.act != sfc::kNone;
  if (epi)
    gemm_f32_kernel<TA, TB, true><<<grid, kThreads, 0, stream>>>(a, b, e, c, ws, M, N, K, per);
  else
    gemm_f32_kernel<TA, TB, false><<<grid, kThreads, 0, stream>>>(a, b, e, c, ws, M, N, K, per);
  cudaError_t err = cudaGetLastError();
  int stripes = grid.y;
  if (err == cudaSuccess && splits > 1) {
    stripes = M;
    const size_t mn = static_cast<size_t>(M) * N;
    const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 132 * 16));
    if (epi)
      gemm_f32_sum_kernel<true><<<blocks, 256, 0, stream>>>(ws, e, c, splits, M, N);
    else
      gemm_f32_sum_kernel<false><<<blocks, 256, 0, stream>>>(ws, e, c, splits, M, N);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && colsum != nullptr) {
    gemm_f32_colsum_kernel<<<(N + 31) / 32, 1024, 0, stream>>>(e.col, colsum, stripes, N);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// c (fp32 [M, N]) = the epilogue of op(a) @ op(b), a and b fp32: op(a) is
// a [M, K] or, with trans_a, a stored [K, M]; op(b) is b [K, N] or, with
// trans_b, b stored [N, K].  The epilogue (every pointer fp32, each may be
// null): + bias [N]; z_out [M, N] receives that pre-activation; x act'(z_in
// [M, N]) when z_in is given, else act (0 none, 1 exact-erf GELU, 2 ReLU);
// colsum [N] the column sums of that value (col, fp32 [stripes, N], their
// partials: stripes = ceil(M / 128) unsplit, M split); +
// residual [M, N].  K is summed in ranges of `per` 16-deep blocks; more
// than one range needs ws (fp32, one [M, N] partial a range), and the
// epilogue then follows their sum.  trans_a and trans_b together are not
// instantiated.
extern "C" int sfc_gemm_f32(const void* a, const void* b, const void* bias,
                            const void* residual, const void* z_in, void* z_out, void* col,
                            void* colsum, void* c, void* ws, int M, int N, int K, int trans_a,
                            int trans_b, int per, int act, void* stream) {
  if (M < 0 || N < 0 || K < 0 || per < 1 || (trans_a && trans_b) ||
      (colsum != nullptr && col == nullptr) || (z_in != nullptr && act == sfc::kNone))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int kblocks = (K + kBK - 1) / kBK;
  if (kblocks > per && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  const Epilogue e{static_cast<const float*>(bias), static_cast<const float*>(residual),
                   static_cast<const float*>(z_in), static_cast<float*>(z_out),
                   colsum != nullptr ? static_cast<float*>(col) : nullptr, act};
  auto* cs = static_cast<float*>(colsum);
  auto* C = static_cast<float*>(c);
  auto* W = static_cast<float*>(ws);
  cudaError_t err;
  if (trans_a)
    err = launch<true, false>(A, B, e, cs, C, W, M, N, K, per, s);
  else if (trans_b)
    err = launch<false, true>(A, B, e, cs, C, W, M, N, K, per, s);
  else
    err = launch<false, false>(A, B, e, cs, C, W, M, N, K, per, s);
  return static_cast<int>(err);
}

// h (fp32) = act(z) elementwise over n fp32 values (n % 4 == 0, 16-byte
// aligned): the backward's GELU of the saved pre-activation.
extern "C" int sfc_act_f32(const void* z, void* h, long long n, int act, void* stream) {
  if (n < 0 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const size_t n4 = static_cast<size_t>(n) / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  act_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(z), static_cast<float4*>(h), n4, act);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of form 0 (NN), 1 (NT), 2 (TN),
// the same with the epilogue 3 (NN), 4 (NT), 5 (TN), or 6 (the column
// sums' stripe sum).
extern "C" int sfc_gemm_f32_attrs(int form, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (form) {
    case 0: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, false, false>); break;
    case 1: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, true, false>); break;
    case 2: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<true, false, false>); break;
    case 3: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, false, true>); break;
    case 4: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<false, true, true>); break;
    case 5: err = cudaFuncGetAttributes(&attr, gemm_f32_kernel<true, false, true>); break;
    default: err = cudaFuncGetAttributes(&attr, gemm_f32_colsum_kernel);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);  // no dynamic shared memory
  return 0;
}
