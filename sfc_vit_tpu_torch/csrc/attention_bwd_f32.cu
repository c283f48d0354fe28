// The packed dqkv of the family-A attention with probability dropout in
// float32: from the forward's saved qkv [B, N, 3*H*Dh], its output att
// [B, N, H*Dh], the fp32 lse [B, H, N], the 0/1 mask [B, H, N, N] and
// keep, and the output's cotangent datt.  SIMT FFMA, fp32 throughout.
// (Training without dropout differentiates the stored weights in plain
// PyTorch, JAX's store-weights rule, so no unmasked form is needed.)
//
// Replaces, for float32 compute: the attention part of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_bwd_kernel (line
// 270; its lines 326-377), which takes any dtype with fp32 sums.  The bf16
// form stays on the wgmma kernel attention_bwd_sm90.cu.
//
// Formula, the plain version's (attention_bwd_ref with the mask):
//   pn = exp(s * scale - lse), 0 at keys past n_valid;
//   dp = ((da . v) / keep) * mask;  delta = rowsum(da * att);
//   pv = (pn / keep) * mask;        ds = pn (dp - delta) scale;
//   dq = ds k,  dk = ds^T q,  dv = pv^T da;
// the divisions by keep correctly rounded by sfc::div_rn.
//
// Bound on this card: bytes at the main paths' 64 tokens (qkv, att, datt,
// the N x N mask, dqkv), operations (10 N^2 Dh a head, x 1.4 here: each
// of the two kernels below recomputes the logits and da . v) over the 67
// TFLOP/s of fp32 FFMA at long rows.
//
// Design: two kernels, each output with one owner, no atomics, so the
// same inputs give the same bits.  (1) dq: a block of 256 threads per 64
// queries of one (image, head) computes delta for its rows (into a small
// fp32 buffer the second kernel reads), then walks the 64-key tiles of
// [0, n_valid), holding K and V of the tile, forming ds in shared memory
// and adding ds K into dq in registers.  (2) dk, dv: a block per 64 keys
// walks every 64-query tile, forms pv and then ds in shared memory, and
// adds pv^T da and ds^T q into dk, dv in registers.  Thread (ty, tx) owns
// the tile's entries of rows ty + 16 i and columns tx + 16 j (i, j < 4),
// read as float4 along Dh from rows padded by 4 floats, and output rows
// ty + 16 i at columns 4 tx + 64 c.  Up to 1,024 tokens at Dh 64 or 192:
// four 64-row tiles of Dh 192 and the ds tile take 218 KB of shared memory.

#include "common.cuh"

namespace {

constexpr int kTile = 64, kThreads = 256, kPad = 4;
constexpr int kPStride = kTile + kPad;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTile * (DH + kPad) + kTile * kPStride + 2 * kTile);
}

// rows [r0, r0 + 64) of a [rows, stride] matrix's DH columns from base into
// sm (row stride DH + kPad); rows at or past n read as zero.
template <int DH>
__device__ __forceinline__ void load_rows(float* sm, const float* __restrict__ base,
                                          size_t row_stride, int r0, int n, int t) {
  constexpr int kVec = DH / 4;
#pragma unroll 4
  for (int e = t; e < kTile * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = *reinterpret_cast<const float4*>(base + (r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(sm + r * (DH + kPad) + c) = v;
  }
}

// s[i][j] = a_{ty+16i} . b_{tx+16j} over 64-row tiles in shared memory
// (the logits from q and k, or da . v).
template <int DH>
__device__ __forceinline__ void tile_dots(const float* as, const float* bs, int tx, int ty,
                                          float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < DH; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * (DH + kPad) + k);
      b[i] = *reinterpret_cast<const float4*>(bs + (tx + 16 * i) * (DH + kPad) + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// For the tile entry of query row `row` and key `key`: pn and ds (and pv,
// returned) from the logit s and dpn = da . v.
__device__ __forceinline__ float entry(float s, float dpn, int row, int key, int n,
                                       int n_valid, float lse, float delta, float scale,
                                       float keep, float rkeep, const uint8_t* mrow,
                                       float& ds) {
  if (row >= n || key >= n_valid) {
    ds = 0.f;
    return 0.f;
  }
  const float pn = expf(__fsub_rn(__fmul_rn(s, scale), lse));
  const bool kept = mrow[key] != 0;
  const float dp = kept ? sfc::div_rn(dpn, keep, rkeep) : 0.f;
  ds = __fmul_rn(__fmul_rn(pn, __fsub_rn(dp, delta)), scale);
  return kept ? sfc::div_rn(pn, keep, rkeep) : 0.f;
}

// acc[i][4c..4c+3] += sum_j P(row, j) * X[j][4 tx + 64 c] over the j < len
// rows of a tile X in shared memory, with P(row, j) = ps[ty + 16 i][j]
// (trans false) or ps[j][ty + 16 i] (trans true).
template <int DH, bool TRANS>
__device__ __forceinline__ void tile_product(const float* ps, const float* xs, int len,
                                             int tx, int ty, float (&acc)[4][DH / 16]) {
  for (int j = 0; j < len; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? ps[j * kPStride + ty + 16 * i] : ps[(ty + 16 * i) * kPStride + j];
#pragma unroll
    for (int c = 0; c < DH / 64; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(xs + j * (DH + kPad) + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * c] = fmaf(p[i], v.x, acc[i][4 * c]);
        acc[i][4 * c + 1] = fmaf(p[i], v.y, acc[i][4 * c + 1]);
        acc[i][4 * c + 2] = fmaf(p[i], v.z, acc[i][4 * c + 2]);
        acc[i][4 * c + 3] = fmaf(p[i], v.w, acc[i][4 * c + 3]);
      }
    }
  }
}

// Rows ty + 16 i of a [64, DH] accumulator into dst rows r0 + ... (row
// stride `stride`), rows at or past n skipped.
template <int DH>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, size_t stride, int r0,
                                           int n, int tx, int ty,
                                           const float (&acc)[4][DH / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      *reinterpret_cast<float4*>(dst + row * stride + 4 * tx + 64 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
  }
}

struct Args {
  const float* qkv;
  const float* att;
  const float* datt;
  const float* lse;
  const uint8_t* mask;
  float* delta;
  float* dqkv;
  int n, heads, n_valid;
  float scale, keep;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) attention_bwd_f32_dq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* das = qs + kTile * (DH + kPad);
  float* ks = das + kTile * (DH + kPad);
  float* vs = ks + kTile * (DH + kPad);
  float* ps = vs + kTile * (DH + kPad);
  float* lse_s = ps + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  const int n = a.n, heads = a.heads, n_valid = a.n_valid;
  const float scale = a.scale, keep = a.keep, rkeep = 1.f / a.keep;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t w = static_cast<size_t>(3) * heads * DH, ow = static_cast<size_t>(heads) * DH;
  const float* img = a.qkv + static_cast<size_t>(b) * n * w + static_cast<size_t>(h) * DH;
  const float* da_img = a.datt + static_cast<size_t>(b) * n * ow + static_cast<size_t>(h) * DH;
  const float* att_img = a.att + static_cast<size_t>(b) * n * ow + static_cast<size_t>(h) * DH;

  load_rows<DH>(qs, img, w, q0, n, t);
  load_rows<DH>(das, da_img, ow, q0, n, t);
  // delta of the 64 rows: four lanes a row, each over a quarter of Dh.
  {
    const int r = t / 4, part = t % 4, row = q0 + r;
    float sum = 0.f;
    if (row < n) {
      const float* da = da_img + row * ow;
      const float* at = att_img + row * ow;
      for (int d = part; d < DH; d += 4) sum = fmaf(da[d], at[d], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      lse_s[r] = row < n ? a.lse[static_cast<size_t>(bh) * n + row] : 0.f;
      if (row < n) a.delta[static_cast<size_t>(bh) * n + row] = sum;
    }
  }

  float acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[i][c] = 0.f;
  const int tiles = (n_valid + kTile - 1) / kTile;
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(ks, img + ow, w, k0, n, t);
    load_rows<DH>(vs, img + 2 * ow, w, k0, n, t);
    __syncthreads();
    float s[4][4], dpn[4][4];
    tile_dots<DH>(qs, ks, tx, ty, s);
    tile_dots<DH>(das, vs, tx, ty, dpn);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const uint8_t* mrow = a.mask + (static_cast<size_t>(bh) * n + min(row, n - 1)) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds;
        entry(s[i][j], dpn[i][j], row, k0 + tx + 16 * j, n, n_valid, lse_s[r],
                    delta_s[r], scale, keep, rkeep, mrow, ds);
        ps[r * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_product<DH, false>(ps, ks, min(kTile, n_valid - k0), tx, ty, acc);
  }
  store_rows<DH>(a.dqkv + static_cast<size_t>(b) * n * w + static_cast<size_t>(h) * DH, w, q0,
                 n, tx, ty, acc);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) attention_bwd_f32_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (DH + kPad);
  float* qs = vs + kTile * (DH + kPad);
  float* das = qs + kTile * (DH + kPad);
  float* ps = das + kTile * (DH + kPad);
  float* lse_s = ps + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  const int n = a.n, heads = a.heads, n_valid = a.n_valid;
  const float scale = a.scale, keep = a.keep, rkeep = 1.f / a.keep;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kTile;
  const size_t w = static_cast<size_t>(3) * heads * DH, ow = static_cast<size_t>(heads) * DH;
  const float* img = a.qkv + static_cast<size_t>(b) * n * w + static_cast<size_t>(h) * DH;
  const float* da_img = a.datt + static_cast<size_t>(b) * n * ow + static_cast<size_t>(h) * DH;

  load_rows<DH>(ks, img + ow, w, k0, n, t);
  load_rows<DH>(vs, img + 2 * ow, w, k0, n, t);
  float dk[4][DH / 16], dv[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int len = max(0, min(kTile, n_valid - k0));  // this tile's valid keys
  const int tiles = (n + kTile - 1) / kTile;
  for (int qt = 0; qt < tiles && len > 0; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_rows<DH>(qs, img, w, q0, n, t);
    load_rows<DH>(das, da_img, ow, q0, n, t);
    if (t < kTile) {
      const int row = q0 + t;
      lse_s[t] = row < n ? a.lse[static_cast<size_t>(bh) * n + row] : 0.f;
      delta_s[t] = row < n ? a.delta[static_cast<size_t>(bh) * n + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpn[4][4];
    tile_dots<DH>(qs, ks, tx, ty, s);
    tile_dots<DH>(das, vs, tx, ty, dpn);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const uint8_t* mrow = a.mask + (static_cast<size_t>(bh) * n + min(row, n - 1)) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[r * kPStride + tx + 16 * j] =
            entry(s[i][j], dpn[i][j], row, k0 + tx + 16 * j, n, n_valid, lse_s[r],
                        delta_s[r], scale, keep, rkeep, mrow, ds[i][j]);
    }
    __syncthreads();
    const int rows = min(kTile, n - q0);
    tile_product<DH, true>(ps, das, rows, tx, ty, dv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPStride + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_product<DH, true>(ps, qs, rows, tx, ty, dk);
  }
  float* out = a.dqkv + static_cast<size_t>(b) * n * w + static_cast<size_t>(h) * DH;
  store_rows<DH>(out + ow, w, k0, n, tx, ty, dk);
  store_rows<DH>(out + 2 * ow, w, k0, n, tx, ty, dv);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DH>
cudaError_t launch(const Args& a, int batch, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = prepare(attention_bwd_f32_dq_kernel<DH>, smem);
  if (err == cudaSuccess) err = prepare(attention_bwd_f32_dkv_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kTile - 1) / kTile, batch * a.heads);
  attention_bwd_f32_dq_kernel<DH><<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_f32_dkv_kernel<DH><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dqkv (fp32 [batch, n, 3 * heads * dh]) of the attention over qkv from
// att, datt (fp32 [batch, n, heads * dh]), lse (fp32 [batch, heads, n]),
// mask (uint8 0/1 [batch, heads, n, n]) and keep; delta (fp32 [batch,
// heads, n]) is a workspace.  dh 64 or 192, n <= 1,024, every pointer
// 16-byte aligned.
extern "C" int sfc_attention_bwd_f32(const void* qkv, const void* att, const void* datt,
                                     const void* lse, const void* mask, void* delta,
                                     void* dqkv, int batch, int n, int heads, int dh,
                                     int n_valid, float scale, float keep, void* stream) {
  if (batch < 0 || n < 1 || n > 1024 || heads < 1 || n_valid < 1 || n_valid > n ||
      mask == nullptr || !(keep > 0.f && keep <= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Args a{static_cast<const float*>(qkv),  static_cast<const float*>(att),
               static_cast<const float*>(datt), static_cast<const float*>(lse),
               static_cast<const uint8_t*>(mask), static_cast<float*>(delta),
               static_cast<float*>(dqkv),        n,
               heads,                            n_valid,
               scale,                            keep};
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh == 64)
    err = launch<64>(a, batch, s);
  else if (dh == 192)
    err = launch<192>(a, batch, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Registers, local bytes and shared bytes of the dq kernel (dkv 0) or of
// the dk/dv kernel (dkv 1) at dh 64 or 192.
extern "C" int sfc_attention_bwd_f32_attrs(int dh, int dkv, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (dh == 192)
    err = dkv ? cudaFuncGetAttributes(&attr, attention_bwd_f32_dkv_kernel<192>)
              : cudaFuncGetAttributes(&attr, attention_bwd_f32_dq_kernel<192>);
  else
    err = dkv ? cudaFuncGetAttributes(&attr, attention_bwd_f32_dkv_kernel<64>)
              : cudaFuncGetAttributes(&attr, attention_bwd_f32_dq_kernel<64>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes +
                            (dh == 192 ? smem_bytes<192>() : smem_bytes<64>()));
  return 0;
}
