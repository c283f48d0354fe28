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
// 691-698, 747-753), in bf16 or in float32.  Same arithmetic: mean, E[x^2] - E[x]^2 clamped at 0
// and inv = rsqrt(var + eps) recomputed from the saved row, xhat =
// (x - mean) * inv; dxh = dxn * scale;
// dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) (+ g) in fp32
// with one rounding; dscale = colsum(dxn * xhat), dbias = colsum(dxn),
// and optionally colsum(g) and the column sums of the fp32 dx.
//
// The row is bf16 or the fp32 sum of two bf16 rows (template argument
// SUM2); the cotangent dxn is fp32 or bf16 (DXN_BF16).  Five forms run on
// the models' paths: (a) x bf16, dxn fp32, + g (#3, #4; #3 also colsum(g));
// (b) x bf16, dxn bf16, also the fp32 dx and its column sums (#16's LN2);
// (c) x + x_b, dxn fp32 (#16's LN1); (d) form (a) in float32 throughout
// (F32: x, g and dx fp32, nothing rounded; #3 and #4 when the model
// computes in float32; with the column sums of dx and no g, #16's LN2 in
// float32); (e) form (c) in float32 (x, x_b and dx fp32: #16's LN1 in
// float32).  (a)-(c) move 10 bytes an element, (d) 16, (e) 16.
//
// Bound on this card: memory.  ~15 flops an element against 10 bytes,
// far under the H100's ~295 flops a byte: 385 MB at ViT-B's [50,176, 768]
// (0.115 ms at 3.35 TB/s), 252 MB at the flagship's [32,768, 768].
// Design (one pass, no atomics, no shared-memory read-modify-write):
//  * A block owns whole rows and each thread one 16-byte chunk of the row:
//    thread c holds columns 8c .. 8c + 7 of every row the block walks
//    (blockDim = D / 8 rounded up to a warp, D <= 3,072).  So each input
//    element is read from device memory once, into registers, and the
//    column partials of dscale, dbias, colsum(g) and colsum(dx) stay in the
//    owning thread's registers across all the block's rows: no shared
//    memory holds them and no bank is shared.  scale's chunk is read once.
//  * A block takes kRows rows at once and issues all their 16-byte loads
//    (x, x_b, dxn, g: up to 4 x kRows independent loads a thread) before
//    any arithmetic (form (e) reads dxn after the row sums, as (d) reads g:
//    fp32 x, x_b and dxn together would hold 96 registers of loads); with several blocks an SM (the occupancy query, 5 at
//    D 768) that keeps ~100 KB an SM in flight, past the ~25 KB the memory
//    rate times its latency needs.  A software pipeline (the next rows'
//    loads before this row's arithmetic) or a TMA ring would double the
//    row registers for no more bytes in flight, so neither is used.
//  * The two row reductions (sum and sum of squares; mean(dxh) and
//    mean(dxh * xhat)) of the kRows rows are one warp butterfly each and,
//    past one warp, one exchange through 2 x kRows floats a warp in shared
//    memory: two barriers for kRows rows.
//  * Column sums in a fixed order: each block writes its partials to an
//    fp32 workspace [blocks, nsum, D] (the wrapper's torch.empty), and a
//    second launch (common.cuh's slice_sum_kernel) sums them over the
//    blocks in block order (32 strided ranges of blocks, then those 32
//    sums in order).  Every row's block and every sum's order depend only
//    on the shape and the card, so a second call gives the same bits.
//    The outputs need no zeroing.

#include "common.cuh"

namespace {

using sfc::bf16;

constexpr int kRows = 4;                     // the Python LN_BWD_ROWS
constexpr int kMaxD = 3072;                  // the Python LN_BWD_MAX_D
constexpr int kMaxThreads = kMaxD / 8;       // a thread a 16-byte chunk
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSumWarps = 32;                // the block-order sum's threads / 32

struct Args {
  const void* x;       // [rows, d], bf16 (fp32 in form (d))
  const void* xb;      // [rows, d] like x, or null: the row is x + xb in fp32
  const void* dxn;     // [rows, d], fp32 or bf16
  const float* scale;  // [d]
  const void* g;       // [rows, d] like x, or null unless add_g or g_sum
  void* dx;            // [rows, d] like x
  float* dx32;         // [rows, d] or null
  float* ws;           // [gridDim.x, nsum, d]: each block's column partials
  int rows, d, add_g, g_sum, dx_sum;
  float eps;
};

__device__ __forceinline__ void unpack_f32x8(float4 a, float4 b, float* v) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Each of v's K values summed over the block in a fixed order: a
// butterfly across the warp (every lane ends with the same bits), then,
// past one warp, the warps' sums in warp order through `red`.  Every
// thread of the block calls it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[K], int warps) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (warps == 1) return;
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[threadIdx.x / 32][k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = red[0][k];
    for (int w = 1; w < warps; ++w) t += red[w][k];
    v[k] = t;
  }
}

template <bool SUM2, bool DXN_BF16, bool F32>
__global__ void __launch_bounds__(kMaxThreads)
    ln_rows_bwd_kernel(const __grid_constant__ Args a) {
  constexpr bool kLateDxn = SUM2 && F32;  // form (e): dxn read after the row sums
  // One array for each reduction of a round: the second barrier of a round
  // orders its reads of the first before the next round's writes, and the
  // next round's first barrier does the same for the second.
  __shared__ float red_stats[kMaxWarps][2 * kRows], red_means[kMaxWarps][2 * kRows];
  const int d = a.d, rows = a.rows, warps = blockDim.x / 32;
  const int c = threadIdx.x;  // this thread's chunk: columns 8c .. 8c + 7
  const bool own = c < d / 8;
  const bool read_g = a.add_g || a.g_sum;
  const float fd = static_cast<float>(d);

  float sc[8], pscale[8], pbias[8], pg[8], pdx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = pscale[e] = pbias[e] = pg[e] = pdx[e] = 0.f;
  if (own) {
    const float4* s4 = reinterpret_cast<const float4*>(a.scale) + 2 * c;
    unpack_f32x8(s4[0], s4[1], sc);
  }

  for (long r0 = static_cast<long>(blockIdx.x) * kRows; r0 < rows;
       r0 += static_cast<long>(gridDim.x) * kRows) {
    // Every load of the kRows rows first.
    // (Form (d) reads g after the row sums: fp32 g beside fp32 x and dxn
    // would hold 96 registers of loads across them.)
    uint4 xr[kRows], xbr[kRows], dr[kRows], gr[kRows];
    float4 df[kRows][2], xf[kRows][2], xbf[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      xr[i] = xbr[i] = dr[i] = gr[i] = zero;
      df[i][0] = df[i][1] = xf[i][0] = xf[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      xbf[i][0] = xbf[i][1] = df[i][0];
      if (own && r0 + i < rows) {
        const size_t off = static_cast<size_t>(r0 + i) * d + 8 * c;
        if constexpr (F32) {
          const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + off);
          xf[i][0] = __ldg(p);
          xf[i][1] = __ldg(p + 1);
        } else {
          xr[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.x) + off));
        }
        if constexpr (SUM2 && F32) {
          const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.xb) + off);
          xbf[i][0] = __ldg(p);
          xbf[i][1] = __ldg(p + 1);
        } else if constexpr (SUM2) {
          xbr[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.xb) + off));
        }
        if constexpr (DXN_BF16) {
          dr[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dxn) + off));
        } else if constexpr (!kLateDxn) {
          const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.dxn) + off);
          df[i][0] = __ldg(p);
          df[i][1] = __ldg(p + 1);
        }
        if (!F32 && read_g)
          gr[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.g) + off));
      }
    }

    float xv[kRows][8], dv[kRows][8], st[2 * kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if constexpr (F32) unpack_f32x8(xf[i][0], xf[i][1], xv[i]);
      else sfc::unpack_bf16x8(xr[i], xv[i]);
      if constexpr (SUM2) {
        float w[8];
        if constexpr (F32) unpack_f32x8(xbf[i][0], xbf[i][1], w);
        else sfc::unpack_bf16x8(xbr[i], w);
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[i][e] += w[e];
      }
      if constexpr (DXN_BF16) sfc::unpack_bf16x8(dr[i], dv[i]);
      else if constexpr (!kLateDxn) unpack_f32x8(df[i][0], df[i][1], dv[i]);
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += xv[i][e];
        ss += xv[i][e] * xv[i][e];
      }
      st[2 * i] = s;
      st[2 * i + 1] = ss;
    }
    block_sum(st, red_stats, warps);
    if constexpr (kLateDxn) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float4 d0 = make_float4(0.f, 0.f, 0.f, 0.f), d1 = d0;
        if (own && r0 + i < rows) {
          const float4* p = reinterpret_cast<const float4*>(
              static_cast<const float*>(a.dxn) + static_cast<size_t>(r0 + i) * d + 8 * c);
          d0 = __ldg(p);
          d1 = __ldg(p + 1);
        }
        unpack_f32x8(d0, d1, dv[i]);
      }
    }

    // xhat in place of x; the two row means' sums.
    float inv[kRows], mt[2 * kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float mean = st[2 * i] / fd;
      const float var = fmaxf(st[2 * i + 1] / fd - mean * mean, 0.f);
      inv[i] = rsqrtf(var + a.eps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xv[i][e] - mean) * inv[i];
        const float dxh = dv[i][e] * sc[e];
        xv[i][e] = xhat;
        m1 += dxh;
        m2 += dxh * xhat;
      }
      mt[2 * i] = m1;
      mt[2 * i + 1] = m2;
    }
    block_sum(mt, red_means, warps);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long row = r0 + i;
      if (!own || row >= rows) continue;
      const float m1 = mt[2 * i] / fd, m2 = mt[2 * i + 1] / fd;
      const size_t off = static_cast<size_t>(row) * d + 8 * c;
      float gv[8], r[8];
      if constexpr (F32) {
        float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
        if (read_g) {
          const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.g) + off);
          g0 = __ldg(p);
          g1 = __ldg(p + 1);
        }
        unpack_f32x8(g0, g1, gv);
      } else {
        sfc::unpack_bf16x8(gr[i], gv);  // zeros unless g is read
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = xv[i][e];
        const float dxh = dv[i][e] * sc[e];
        r[e] = inv[i] * (dxh - m1 - xhat * m2);
        if (a.add_g) r[e] += gv[e];
        pscale[e] += dv[i][e] * xhat;
        pbias[e] += dv[i][e];
        if (a.g_sum) pg[e] += gv[e];
        if (a.dx_sum) pdx[e] += r[e];
      }
      if (a.dx32 != nullptr) {
        float4* dst = reinterpret_cast<float4*>(a.dx32 + off);
        dst[0] = make_float4(r[0], r[1], r[2], r[3]);
        dst[1] = make_float4(r[4], r[5], r[6], r[7]);
      }
      if constexpr (F32) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.dx) + off);
        dst[0] = make_float4(r[0], r[1], r[2], r[3]);
        dst[1] = make_float4(r[4], r[5], r[6], r[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dx) + off) = sfc::pack_bf16x8(r);
      }
    }
  }

  if (!own) return;
  // This block's partials, slot by slot: dscale, dbias, then colsum(g)
  // and colsum(dx) where asked for.
  const int nsum = 2 + a.g_sum + a.dx_sum;
  float* w = a.ws + static_cast<size_t>(blockIdx.x) * nsum * d + 8 * c;
  auto put = [&](int slot, const float* v) {
    float4* dst = reinterpret_cast<float4*>(w + static_cast<size_t>(slot) * d);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  };
  put(0, pscale);
  put(1, pbias);
  if (a.g_sum) put(2, pg);
  if (a.dx_sum) put(2 + a.g_sum, pdx);
}

int threads_for(int d) { return (d / 8 + 31) / 32 * 32; }

template <bool SUM2, bool DXN_BF16, bool F32 = false>
auto kernel_of() { return ln_rows_bwd_kernel<SUM2, DXN_BF16, F32>; }

// The kernel of form 0 (a), 1 (b), 2 (c), 3 (d) or 4 (e); null for another.
using KernelPtr = void (*)(Args);
KernelPtr kernel_of_form(int form) {
  if (form == 0) return kernel_of<false, false>();
  if (form == 1) return kernel_of<false, true>();
  if (form == 2) return kernel_of<true, false>();
  if (form == 3) return kernel_of<false, false, true>();
  if (form == 4) return kernel_of<true, false, true>();
  return nullptr;
}

template <bool SUM2, bool DXN_BF16, bool F32 = false>
int launch(const Args& a, int blocks, float* sums, cudaStream_t stream) {
  if (blocks > 0) {
    ln_rows_bwd_kernel<SUM2, DXN_BF16, F32><<<blocks, threads_for(a.d), 0, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int total = (2 + a.g_sum + a.dx_sum) * a.d;
  sfc::slice_sum_kernel<kSumWarps><<<(total + 31) / 32, kSumWarps * 32, 0, stream>>>(
      a.ws, sums, blocks, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x bf16 [rows, d] (the row is x + x_b in fp32 when x_b is not null),
// dxn fp32 [rows, d] (bf16 when dxn_bf16), scale fp32 [d], g bf16
// [rows, d] (read only for add_g or g_sum; may be null otherwise); dx bf16
// [rows, d], and dx32 (fp32 [rows, d], may be null) the same dx before its
// rounding.  With x_f32 (forms (d) and (e)) x, x_b, g and dx are fp32 and
// dxn fp32, and neither dxn_bf16 nor dx32 is taken.  sums fp32 [2 + g_sum +
// dx_sum, d] receives the column sums of dxn * xhat, dxn, then g (g_sum)
// and the fp32 dx (dx_sum); ws is an fp32 workspace of blocks * (2 + g_sum
// + dx_sum) * d elements, blocks from the Python ln_rows_bwd_plan (0 when
// rows is 0; at most one a kRows rows).  add_g adds g to dx (the
// residual's cotangent).  Requires d % 8 == 0, 8 <= d <= 3,072 and
// 16-byte aligned pointers; x_b and dxn_bf16 together are not
// instantiated.
extern "C" int sfc_ln_rows_bwd_bf16(const void* x, const void* x_b, const void* dxn,
                                    int dxn_bf16, int x_f32, const void* scale, const void* g,
                                    void* dx, void* dx32, void* sums, void* ws, int blocks,
                                    int g_sum, int dx_sum, int rows, int d, float eps, int add_g,
                                    void* stream) {
  const long long need = (static_cast<long long>(rows) + kRows - 1) / kRows;
  if (d % 8 || d < 8 || d > kMaxD || rows < 0 || blocks < 0 || blocks > need ||
      (rows > 0 && blocks == 0) || (x_b != nullptr && dxn_bf16) ||
      ((add_g || g_sum) && g == nullptr) ||
      (x_f32 && (dxn_bf16 || dx32 != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.xb = x_b;
  a.dxn = dxn;
  a.scale = static_cast<const float*>(scale);
  a.g = g;
  a.dx = dx;
  a.dx32 = static_cast<float*>(dx32);
  a.ws = static_cast<float*>(ws);
  a.rows = rows;
  a.d = d;
  a.add_g = add_g != 0;
  a.g_sum = g_sum != 0;
  a.dx_sum = dx_sum != 0;
  a.eps = eps;
  auto* out = static_cast<float*>(sums);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_f32 && x_b != nullptr) return launch<true, false, true>(a, blocks, out, s);
  if (x_f32) return launch<false, false, true>(a, blocks, out, s);
  if (x_b != nullptr) return launch<true, false>(a, blocks, out, s);
  if (dxn_bf16) return launch<false, true>(a, blocks, out, s);
  return launch<false, false>(a, blocks, out, s);
}

// Blocks of the instance of form 0 (a), 1 (b), 2 (c), 3 (d) or 4 (e) an SM holds
// at width d (the occupancy query), into *out.
extern "C" int sfc_ln_rows_bwd_blocks_per_sm(int d, int form, int* out) {
  const KernelPtr k = kernel_of_form(form);
  if (d % 8 || d < 8 || d > kMaxD || k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, threads_for(d), 0));
}

// Registers, local bytes and shared bytes of the instance of form 0 (x
// bf16, dxn fp32), 1 (dxn bf16), 2 (x + x_b), 3 (fp32 throughout) or 4
// (x + x_b in fp32), into out[3].
extern "C" int sfc_ln_rows_bwd_attrs(int form, int* out) {
  const KernelPtr k = kernel_of_form(form);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes f;
  const cudaError_t e = cudaFuncGetAttributes(&f, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.localSizeBytes);
  out[2] = static_cast<int>(f.sharedSizeBytes);
  return 0;
}
