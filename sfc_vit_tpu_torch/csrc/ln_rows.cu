// Row LayerNorm over [R, D]: the prologue of both fused blocks and the two
// LayerNorms of the post-norm tail.
//
// Replaces: the LayerNorm at the head of sfc_vit_tpu/ops/fused_mlp.py
// (_mlp_kernel, lines 110-121) and sfc_vit_tpu/ops/fused_attention_block.py
// (_attn_block_kernel, lines 126-135), and both LayerNorms of
// sfc_vit_tpu/ops/fused_mlp.py::_postnorm_tail_kernel: LN1 of the fp32 sum
// x + attn (lines 553-564), whose unrounded output x2f the tail keeps beside
// its bf16 rounding x2, and LN2 of the fp32 pre-LN2 sum s2 (lines 584-592),
// whose bf16 rounding the training form saves.  LN2 runs here only where
// the tail's width is not whole 128-column tiles or needs a cluster of
// more than 8 (ops/fused_mlp.py::tail_fc2_route); at the models' widths
// (768, 256) csrc/gemm_bf16.cu's LayerNorm form finishes it inside fc2 and
// s2 never reaches device memory in fp32.  Same arithmetic: fp32
// mean and E[x^2], variance E[x^2] - E[x]^2 clamped at 0, rsqrt(var + eps),
// scale and bias in fp32, one round to bf16.
//
// A row is read as bf16, as fp32, or as the fp32 sum of two bf16 rows
// (template argument IN).  Optional outputs: the normalised row in fp32
// (y32), the input row rounded to bf16 (xr), and the row's mean and
// rsqrt(var + eps) (stats), from which csrc/gemm_bf16.cu's LayerNorm form
// rebuilds the fp32 output bit for bit (sfc::ln_apply) instead of reading
// y32.
//
// Bound on this card: memory.  Per row it reads D bf16 (or 2 D bf16, or D
// fp32) and writes D bf16 (plus D fp32 for y32) with ~5 flops per element,
// far below the H100's ~295 flops/byte ridge.  Design: one warp per row,
// 16-byte vector loads (D % 8 == 0), two passes over the row (the second
// pass hits L1), no shared memory, so any D runs and many rows are in
// flight per SM.  On the TPU the normalised rows stayed in VMEM for the
// following GEMM; here they pass through L2/HBM once, which a later PR can
// remove by fusing this into the GEMM's A-tile load.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kWarps = 8;

enum In : int { kBf16 = 0, kSum2 = 1, kF32 = 2 };

// Eight neighbouring values (chunk c) of row `row` as fp32.
template <int IN>
__device__ __forceinline__ void load8(const void* x, const bf16* xb, long row, int d,
                                      int c, float* v) {
  if constexpr (IN == kF32) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + row * d);
    const float4 a = p[2 * c], b = p[2 * c + 1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + row * d)[c], v);
    if constexpr (IN == kSum2) {
      float w[8];
      sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(xb + row * d)[c], w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += w[e];
    }
  }
}

template <int IN>
__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_kernel(const void* __restrict__ x, const bf16* __restrict__ xb,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ y, float* __restrict__ y32, bf16* __restrict__ xr,
                   float2* __restrict__ stats, int rows, int d, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const int chunks = d / 8;

  float s = 0.f, ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    load8<IN>(x, xb, row, d, c, v);
    if (xr != nullptr) reinterpret_cast<uint4*>(xr + row * d)[c] = sfc::pack_bf16x8(v);
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
  if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, inv);

  for (int c = lane; c < chunks; c += 32) {
    float v[8];
    load8<IN>(x, xb, row, d, c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = c * 8 + e;
      v[e] = sfc::ln_apply(v[e], mean, inv, scale[i], bias[i]);
    }
    if (y32 != nullptr) {
      float4* dst = reinterpret_cast<float4*>(y32 + row * d) + 2 * c;
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    yr[c] = sfc::pack_bf16x8(v);
  }
}

}  // namespace

// y bf16 [rows, d] = LN(row) with fp32 scale and bias [d].  The row is x
// (bf16 [rows, d]), x as fp32 (x_f32), or the fp32 sum x + x_b of two bf16
// rows (x_b not null).  y32 (fp32 [rows, d], may be null) receives the
// normalised row before its rounding; xr (bf16 [rows, d], may be null) the
// input row rounded to bf16; stats (fp32 [rows, 2], may be null) the
// row's mean and rsqrt(var + eps).  Requires d % 8 == 0 and 16-byte
// aligned pointers; the Python wrapper checks these.
extern "C" int sfc_ln_rows_bf16(const void* x, const void* x_b, int x_f32,
                                const void* scale, const void* bias, void* y,
                                void* y32, void* xr, void* stats, int rows, int d, float eps,
                                void* stream) {
  if (rows <= 0) return 0;
  if (x_f32 && x_b != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x_b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* yo = static_cast<bf16*>(y);
  auto* y32o = static_cast<float*>(y32);
  auto* xro = static_cast<bf16*>(xr);
  auto* st = static_cast<float2*>(stats);
  if (x_f32)
    ln_rows_kernel<kF32><<<blocks, kWarps * 32, 0, s>>>(x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  else if (xb != nullptr)
    ln_rows_kernel<kSum2><<<blocks, kWarps * 32, 0, s>>>(x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  else
    ln_rows_kernel<kBf16><<<blocks, kWarps * 32, 0, s>>>(x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
