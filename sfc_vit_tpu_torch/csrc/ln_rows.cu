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
// A row is read as bf16, as fp32, as the fp32 sum of two bf16 rows, or
// as the sum of two fp32 rows (template argument IN).  Its fp32 forms, fp32
// rows in and fp32 rows out with no rounding, are the LayerNorm of #1 and
// #2 (and of #3's and #4's recomputed xn), and over x + attn LN1 of #15
// (and #16's recomputed x2), when the model computes in float32; #15's LN2
// in float32 is the one-row fp32 form over s2.  Optional outputs: the normalised row in fp32
// (y32), the input row rounded to bf16 (xr), and the row's mean and
// rsqrt(var + eps) (stats), from which csrc/gemm_bf16.cu's LayerNorm form
// rebuilds the fp32 output bit for bit (sfc::ln_apply) instead of reading
// y32.
//
// Bound on this card: memory.  Per row it reads D bf16 (or 2 D bf16, D
// fp32 or 2 D fp32) and writes D bf16 or fp32 (plus D fp32 for y32) with
// ~5 flops per element, far below the H100's ~295 flops/byte ridge.
// Design: one warp per row,
// 16-byte vector loads (D % 8 == 0), no shared memory, so many rows are in
// flight per SM.  A row of up to 1,024 (kRegChunks 16-byte chunks a lane)
// stays in registers from its statistics to its output, read from memory
// once, and scale and bias come as 16-byte loads (PERF.md section 6 has
// the times at #2's shapes beside the byte bound).  Longer rows read
// the row twice (the second pass mostly from L1).  On the TPU the
// normalised rows stayed in VMEM for the following GEMM; here they pass
// through L2/HBM once, which a later PR can remove by fusing this into the
// GEMM's A-tile load.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kWarps = 8;
constexpr int kRegChunks = 4;  // rows of up to 4 x 32 x 8 = 1,024 stay in registers

enum In : int { kBf16 = 0, kSum2 = 1, kF32 = 2, kSum2F32 = 3 };

// Chunk c (eight fp32 values) of the fp32 row at p.
__device__ __forceinline__ void load_f32x8(const void* p, int c, float* v) {
  const float4* q = static_cast<const float4*>(p);
  const float4 a = q[2 * c], b = q[2 * c + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight neighbouring values (chunk c) of row `row` as fp32: x's, or x's +
// xb's in fp32 (kSum2, kSum2F32).
template <int IN>
__device__ __forceinline__ void load8(const void* x, const void* xb, long row, int d,
                                      int c, float* v) {
  if constexpr (IN == kF32 || IN == kSum2F32) {
    load_f32x8(static_cast<const float*>(x) + row * d, c, v);
    if constexpr (IN == kSum2F32) {
      float w[8];
      load_f32x8(static_cast<const float*>(xb) + row * d, c, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += w[e];
    }
  } else {
    sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + row * d)[c], v);
    if constexpr (IN == kSum2) {
      float w[8];
      sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(static_cast<const bf16*>(xb) + row * d)[c],
                         w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += w[e];
    }
  }
}

// The sums of one chunk's values and squares (in element order), and its
// rounding into xr.
__device__ __forceinline__ void sum8(const float* v, bf16* xr, long row, int d, int c, float& s,
                                     float& ss) {
  if (xr != nullptr) reinterpret_cast<uint4*>(xr + row * d)[c] = sfc::pack_bf16x8(v);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s += v[e];
    ss += v[e] * v[e];
  }
}

// The normalised chunk c (v, in place) into y (and y32).
__device__ __forceinline__ void out8(float* v, const float* scale, const float* bias, float mean,
                                     float inv, bf16* y, float* y32, long row, int d, int c) {
  const float4* sc = reinterpret_cast<const float4*>(scale) + 2 * c;
  const float4* bi = reinterpret_cast<const float4*>(bias) + 2 * c;
  const float4 s0 = sc[0], s1 = sc[1], b0 = bi[0], b1 = bi[1];
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = sfc::ln_apply(v[e], mean, inv, sv[e], bv[e]);
  if (y32 != nullptr) {
    float4* dst = reinterpret_cast<float4*>(y32 + row * d) + 2 * c;
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (y != nullptr) reinterpret_cast<uint4*>(y + row * d)[c] = sfc::pack_bf16x8(v);
}

// kInRegs: d <= 32 x 8 x kRegChunks, the row kept in registers.
template <int IN, bool kInRegs>
__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_kernel(const void* __restrict__ x, const void* __restrict__ xb,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   bf16* __restrict__ y, float* __restrict__ y32, bf16* __restrict__ xr,
                   float2* __restrict__ stats, int rows, int d, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const int chunks = d / 8;

  // The row's sums, each lane over chunks lane, lane + 32, ... in order.
  float s = 0.f, ss = 0.f;
  float v[kInRegs ? kRegChunks : 1][8];
  if constexpr (kInRegs) {
#pragma unroll
    for (int k = 0; k < kRegChunks; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        load8<IN>(x, xb, row, d, c, v[k]);
        sum8(v[k], xr, row, d, c, s, ss);
      }
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      load8<IN>(x, xb, row, d, c, v[0]);
      sum8(v[0], xr, row, d, c, s, ss);
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

  if constexpr (kInRegs) {
#pragma unroll
    for (int k = 0; k < kRegChunks; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) out8(v[k], scale, bias, mean, inv, y, y32, row, d, c);
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      load8<IN>(x, xb, row, d, c, v[0]);
      out8(v[0], scale, bias, mean, inv, y, y32, row, d, c);
    }
  }
}

template <int IN>
void launch(int blocks, cudaStream_t s, const void* x, const void* xb, const float* sc,
            const float* bi, bf16* y, float* y32, bf16* xr, float2* st, int rows, int d,
            float eps) {
  if (d <= 32 * 8 * kRegChunks)
    ln_rows_kernel<IN, true><<<blocks, kWarps * 32, 0, s>>>(x, xb, sc, bi, y, y32, xr, st, rows,
                                                            d, eps);
  else
    ln_rows_kernel<IN, false><<<blocks, kWarps * 32, 0, s>>>(x, xb, sc, bi, y, y32, xr, st,
                                                             rows, d, eps);
}

}  // namespace

// y bf16 [rows, d] = LN(row) with fp32 scale and bias [d].  The row is x
// (bf16 [rows, d]), x as fp32 (x_f32), or the fp32 sum x + x_b of two bf16
// rows (x_b not null), or of two fp32 rows (x_f32 and x_b, both fp32
// [rows, d]).  y32 (fp32 [rows, d], may be null) receives the
// normalised row before its rounding; y may be null where y32 is not (the
// fp32 form: fp32 rows in, fp32 rows out, nothing rounded); xr (bf16
// [rows, d], may be null) the input row rounded to bf16; stats (fp32 [rows, 2], may be null) the
// row's mean and rsqrt(var + eps).  Requires d % 8 == 0 and 16-byte
// aligned pointers; the Python wrapper checks these.
extern "C" int sfc_ln_rows_bf16(const void* x, const void* x_b, int x_f32,
                                const void* scale, const void* bias, void* y,
                                void* y32, void* xr, void* stats, int rows, int d, float eps,
                                void* stream) {
  if (rows <= 0) return 0;
  if (y == nullptr && y32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  auto s = static_cast<cudaStream_t>(stream);
  const void* xb = x_b;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* yo = static_cast<bf16*>(y);
  auto* y32o = static_cast<float*>(y32);
  auto* xro = static_cast<bf16*>(xr);
  auto* st = static_cast<float2*>(stats);
  if (x_f32 && xb != nullptr)
    launch<kSum2F32>(blocks, s, x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  else if (x_f32)
    launch<kF32>(blocks, s, x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  else if (xb != nullptr)
    launch<kSum2>(blocks, s, x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  else
    launch<kBf16>(blocks, s, x, xb, sc, bi, yo, y32o, xro, st, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
