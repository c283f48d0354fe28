// Row LayerNorm backward over [R, D]: the epilogue of both backward
// blocks and the two LayerNorm backwards of the post-norm tail.
//
// Replaces: the LayerNorm backward at the tail of
// sfc_vit_tpu/ops/fused_mlp.py::_mlp_bwd_kernel (lines 319-327, with
// db2 = colsum(g) of line 297),
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel
// (lines 514-520) and both LayerNorm backwards of
// sfc_vit_tpu/ops/fused_mlp.py::_postnorm_tail_bwd_kernel: LN2's from the
// saved bf16 s2 and the bf16 cotangent g, giving the fp32 ds2, its bf16
// rounding and db2 = colsum(ds2) (lines 705-722), and LN1's from the sum
// x + attn and the fp32 dx2, giving the shared cotangent ds (lines
// 691-698, 747-753).  Same arithmetic: mean, E[x^2] - E[x]^2 clamped at 0
// and inv = rsqrt(var + eps) recomputed from the saved row, xhat =
// (x - mean) * inv; dxh = dxn * scale;
// dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) (+ g) in fp32
// with one rounding; dln_scale += colsum(dxn * xhat), dln_bias +=
// colsum(dxn), and optionally g_sum += colsum(g) and dx_sum += colsum of
// the fp32 dx.
//
// The row is bf16 or the fp32 sum of two bf16 rows (template argument
// SUM2); the cotangent dxn is fp32 or bf16 (DXN_BF16).
//
// Bound on this card: memory.  Per row it reads D bf16 of x, D fp32 of
// dxn and D bf16 of g and writes D bf16, ~15 flops per element.  Design:
// one warp per row (16-byte vector loads, D % 8 == 0), rows grid-strided
// over a fixed grid of 4-warp blocks.  The column sums, which the TPU
// carried across its sequential row grid in fp32 VMEM, accumulate per
// warp in shared memory (each lane owns its columns: no atomics), then
// per block, then across blocks with one fp32 atomic per column and
// block into outputs the wrapper zeroes (their order varies run to run).

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kWarps = 4;

template <bool SUM2>
__device__ __forceinline__ void load_x8(const bf16* x, const bf16* xb, long row, int d,
                                        int c, float* v) {
  sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(x + row * d)[c], v);
  if constexpr (SUM2) {
    float w[8];
    sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(xb + row * d)[c], w);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += w[e];
  }
}

template <bool DXN_BF16>
__device__ __forceinline__ void load_dxn8(const void* dxn, long row, int d, int c,
                                          float* dv) {
  if constexpr (DXN_BF16) {
    sfc::unpack_bf16x8(
        reinterpret_cast<const uint4*>(static_cast<const bf16*>(dxn) + row * d)[c], dv);
  } else {
    const float4* dr = reinterpret_cast<const float4*>(static_cast<const float*>(dxn) + row * d);
    const float4 d0 = dr[2 * c], d1 = dr[2 * c + 1];
    dv[0] = d0.x; dv[1] = d0.y; dv[2] = d0.z; dv[3] = d0.w;
    dv[4] = d1.x; dv[5] = d1.y; dv[6] = d1.z; dv[7] = d1.w;
  }
}

template <bool SUM2, bool DXN_BF16>
__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ xb,
                       const void* __restrict__ dxn, const float* __restrict__ scale,
                       const bf16* __restrict__ g, bf16* __restrict__ dx,
                       float* __restrict__ dx32, float* __restrict__ dscale,
                       float* __restrict__ dbias, float* __restrict__ gsum,
                       float* __restrict__ dxsum, int rows, int d, float eps, int add_g) {
  extern __shared__ float part[];  // [kWarps][nsum][d]
  // Column-sum slots: dscale, dbias, then gsum and dxsum where asked for.
  const int gslot = 2, dslot = gsum != nullptr ? 3 : 2;
  const int nsum = dslot + (dxsum != nullptr ? 1 : 0);
  const bool read_g = add_g || gsum != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = d / 8;
  float* mine = part + static_cast<size_t>(warp) * nsum * d;
  for (int i = lane; i < nsum * d; i += 32) mine[i] = 0.f;
  __syncwarp();

  for (long row = static_cast<long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long>(gridDim.x) * kWarps) {
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float v[8];
      load_x8<SUM2>(x, xb, row, d, c, v);
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

    // Pass 2: the two row means and the column sums.
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float v[8], dv[8];
      load_x8<SUM2>(x, xb, row, d, c, v);
      load_dxn8<DXN_BF16>(dxn, row, d, c, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = c * 8 + e;
        const float xhat = (v[e] - mean) * inv;
        const float dxh = dv[e] * scale[i];
        m1 += dxh;
        m2 += dxh * xhat;
        mine[i] += dv[e] * xhat;
        mine[d + i] += dv[e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= d;
    m2 /= d;

    // Pass 3: dx (x and dxn rows are in L1 from the passes above).
    uint4* out = reinterpret_cast<uint4*>(dx + row * d);
    for (int c = lane; c < chunks; c += 32) {
      float v[8], dv[8], gv[8];
      load_x8<SUM2>(x, xb, row, d, c, v);
      load_dxn8<DXN_BF16>(dxn, row, d, c, dv);
      if (read_g) sfc::unpack_bf16x8(reinterpret_cast<const uint4*>(g + row * d)[c], gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = c * 8 + e;
        const float xhat = (v[e] - mean) * inv;
        const float dxh = dv[e] * scale[i];
        float r = inv * (dxh - m1 - xhat * m2);
        if (add_g) r += gv[e];
        if (gsum != nullptr) mine[gslot * d + i] += gv[e];
        if (dxsum != nullptr) mine[dslot * d + i] += r;
        v[e] = r;
      }
      if (dx32 != nullptr) {
        float4* dst = reinterpret_cast<float4*>(dx32 + row * d) + 2 * c;
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      out[c] = sfc::pack_bf16x8(v);
    }
  }

  __syncthreads();
  float* outs[4] = {dscale, dbias, gsum != nullptr ? gsum : dxsum, dxsum};
  for (int i = threadIdx.x; i < nsum * d; i += kWarps * 32) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[static_cast<size_t>(w) * nsum * d + i];
    atomicAdd(&outs[i / d][i % d], t);
  }
}

template <bool SUM2, bool DXN_BF16>
int launch(const bf16* x, const bf16* xb, const void* dxn, const float* scale,
           const bf16* g, bf16* dx, float* dx32, float* dscale, float* dbias,
           float* gsum, float* dxsum, int rows, int d, float eps, int add_g,
           cudaStream_t stream) {
  const int nsum = 2 + (gsum != nullptr) + (dxsum != nullptr);
  const size_t smem = static_cast<size_t>(kWarps) * nsum * d * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_rows_bwd_kernel<SUM2, DXN_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int need = (rows + kWarps - 1) / kWarps;
  const int blocks = need < 132 * 4 ? need : 132 * 4;
  ln_rows_bwd_kernel<SUM2, DXN_BF16><<<blocks, kWarps * 32, smem, stream>>>(
      x, xb, dxn, scale, g, dx, dx32, dscale, dbias, gsum, dxsum, rows, d, eps, add_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [rows, d] (the row is x + x_b in fp32 when x_b is not null),
// dxn fp32 [rows, d] (bf16 when dxn_bf16), scale fp32 [d], g bf16
// [rows, d] (read only for add_g or gsum; may be null otherwise); dx bf16
// [rows, d], and dx32 (fp32 [rows, d], may be null) the same dx before its
// rounding; dscale, dbias (and gsum, dxsum, which may be null) fp32 [d],
// zeroed by the caller, receive the column sums of dxn * xhat, dxn, g and
// the fp32 dx.  add_g adds g to dx (the residual's cotangent).  Requires
// d % 8 == 0 and 16-byte aligned pointers; x_b and dxn_bf16 together are
// not instantiated.
extern "C" int sfc_ln_rows_bwd_bf16(const void* x, const void* x_b, const void* dxn,
                                    int dxn_bf16, const void* scale, const void* g,
                                    void* dx, void* dx32, void* dscale, void* dbias,
                                    void* gsum, void* dxsum, int rows, int d, float eps,
                                    int add_g, void* stream) {
  if (rows <= 0) return 0;
  if (d % 8 || (x_b != nullptr && dxn_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* xb = static_cast<const bf16*>(x_b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* gp = static_cast<const bf16*>(g);
  auto* dxp = static_cast<bf16*>(dx);
  auto* d32 = static_cast<float*>(dx32);
  auto* ds = static_cast<float*>(dscale);
  auto* db = static_cast<float*>(dbias);
  auto* gs = static_cast<float*>(gsum);
  auto* dxs = static_cast<float*>(dxsum);
  auto s = static_cast<cudaStream_t>(stream);
  if (xb != nullptr)
    return launch<true, false>(xp, xb, dxn, sc, gp, dxp, d32, ds, db, gs, dxs, rows, d,
                               eps, add_g, s);
  if (dxn_bf16)
    return launch<false, true>(xp, xb, dxn, sc, gp, dxp, d32, ds, db, gs, dxs, rows, d,
                               eps, add_g, s);
  return launch<false, false>(xp, xb, dxn, sc, gp, dxp, d32, ds, db, gs, dxs, rows, d, eps,
                              add_g, s);
}
