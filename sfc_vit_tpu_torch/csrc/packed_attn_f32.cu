// Attention straight off the packed projection in float32: qkv [B, N,
// 3*H*Dh] -> out [B, N, H*Dh], with the fp32 log-sum-exp of each softmax
// row on request, and optionally the family-A dropout mask.  SIMT FFMA,
// fp32 throughout.
//
// Replaces, for float32 compute: the attention of
// sfc_vit_tpu/ops/fused_torch_attention.py::_torch_mha_kernel (line 82:
// with the 0/1 mask and keep, and the lse its backward recomputes from)
// and sfc_vit_tpu/ops/flash_attention.py::_packed_kernel (line 907: no
// mask, no lse), and the attention of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (line 104:
// no mask; with the lse in training; ViT-B's 196 tokens at Dh 64, keys at
// or past n_actual masked), which take any dtype and keep logits, softmax
// and sums in fp32.  The bf16 forms stay on the wgmma kernel
// packed_attn_sm90.cu.
//
// Formula, the plain versions' (attention_fwd_ref, _packed_xla_ref):
// s = (q . k) * scale in fp32, keys at or past n_valid excluded, P = p / l
// with p = exp(s - m), then with the mask pd = (P / keep) * mask, the two
// divisions correctly rounded by sfc::div_rn; out = sum_j pd_j v_j; lse =
// m + log(l), taken before the mask.
//
// Bound on this card: bytes at short rows (qkv, out, the N x N mask),
// operations (4 N^2 Dh a head, x 1.5 here: the logits are computed twice)
// over the 67 TFLOP/s of fp32 FFMA at long ones.
//
// Design: a block of 256 threads owns 64 queries of one (image, head) and
// makes two passes over the 64-key tiles of [0, n_valid): the first keeps
// each row's running max and sum, the second recomputes the logits, forms
// P (normalised, then the mask) in shared memory and adds P V into the
// output it holds in registers.  P is normalised before its product with
// V, as the plain versions do, which is why the logits are computed twice
// rather than the output rescaled.  K and V of a tile share one buffer.
// Thread (ty, tx) of the 16 x 16 grid owns logits of queries ty + 16 i and
// keys tx + 16 j (i, j < 4), read as float4 along Dh from rows padded by 4
// floats (a quarter warp's eight K rows start on eight bank groups), and
// output rows ty + 16 i at columns 4 tx + 64 c; a row's max and sum meet
// over its 16 lanes by shuffles.  Up to 1,024 keys (N <= PACKED_MAX_N):
// K and V stream a tile at a time, so one fp32 K of 1,024 x 192 (768 KB)
// never needs to fit.

#include "common.cuh"

namespace {

constexpr int kTile = 64, kThreads = 256, kPad = 4;
constexpr int kPStride = kTile + kPad;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (DH + kPad) + kTile * kPStride);
}

// rows [r0, r0 + 64) of one head's slot (q, k or v) of the packed qkv into
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

// s[i][j] = (q_{ty+16i} . k_{tx+16j}) over the tiles in shared memory.
template <int DH>
__device__ __forceinline__ void tile_dots(const float* qs, const float* ks, int tx, int ty,
                                          float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * (DH + kPad) + d);
      k[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * (DH + kPad) + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH, bool MASK>
__global__ void __launch_bounds__(kThreads)
    packed_attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                           float* __restrict__ lse, const uint8_t* __restrict__ mask,
                           int n, int heads, int n_valid, float scale, float keep) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kv = qs + kTile * (DH + kPad);
  float* ps = kv + kTile * (DH + kPad);
  constexpr int kCols = DH / 64;  // output float4 columns a thread
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const size_t w = static_cast<size_t>(3) * heads * DH;
  const float* img = qkv + static_cast<size_t>(b) * n * w + static_cast<size_t>(h) * DH;
  const int tiles = (n_valid + kTile - 1) / kTile;

  load_rows<DH>(qs, img, w, q0, n, t);

  // Pass 1: each row's max and sum over the valid keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = sfc::kNegInf, l[i] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();
    load_rows<DH>(kv, img + heads * DH, w, kt * kTile, n, t);
    __syncthreads();
    float s[4][4];
    tile_dots<DH>(qs, kv, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = sfc::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kt * kTile + tx + 16 * j < n_valid ? __fmul_rn(s[i][j], scale) : sfc::kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max16(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(__fsub_rn(s[i][j], mnew));
      l[i] = l[i] * expf(m[i] - mnew) + row_sum16(sum);
      m[i] = mnew;
    }
  }
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < n) lse[static_cast<size_t>(bh) * n + row] = m[i] + logf(l[i]);
    }
  }

  // Pass 2: P normalised (and masked) into shared memory, then P V.
  float rl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rl[i] = 1.f / l[i];
  const float rkeep = 1.f / keep;
  float acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_rows<DH>(kv, img + heads * DH, w, k0, n, t);
    __syncthreads();
    float s[4][4];
    tile_dots<DH>(qs, kv, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = 0.f;
        if (key < n_valid) {
          p = sfc::div_rn(expf(__fsub_rn(__fmul_rn(s[i][j], scale), m[i])), l[i], rl[i]);
          if (MASK) {
            const bool kept =
                row < n && mask[(static_cast<size_t>(bh) * n + row) * n + key] != 0;
            p = kept ? sfc::div_rn(p, keep, rkeep) : 0.f;
          }
        }
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    load_rows<DH>(kv, img + 2 * heads * DH, w, k0, n, t);
    __syncthreads();
    const int kend = min(kTile, n_valid - k0);
    for (int j = 0; j < kend; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(kv + j * (DH + kPad) + 4 * tx + 64 * c);
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

  const size_t ow = static_cast<size_t>(heads) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* dst = out + (static_cast<size_t>(b) * n + row) * ow + static_cast<size_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      *reinterpret_cast<float4*>(dst + 4 * tx + 64 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
  }
}

template <int DH, bool MASK>
cudaError_t launch(const float* qkv, float* out, float* lse, const uint8_t* mask, int batch,
                   int n, int heads, int n_valid, float scale, float keep, cudaStream_t s) {
  auto* kernel = packed_attn_f32_kernel<DH, MASK>;
  constexpr size_t smem = smem_bytes<DH>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, smem, s>>>(qkv, out, lse, mask, n, heads, n_valid, scale, keep);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const float* qkv, float* out, float* lse, const uint8_t* mask,
                      int batch, int n, int heads, int n_valid, float scale, float keep,
                      cudaStream_t s) {
  return mask != nullptr
             ? launch<DH, true>(qkv, out, lse, mask, batch, n, heads, n_valid, scale, keep, s)
             : launch<DH, false>(qkv, out, lse, mask, batch, n, heads, n_valid, scale, keep, s);
}

}  // namespace

// out (fp32 [batch, n, heads * dh]) = attention over the packed qkv (fp32
// [batch, n, 3 * heads * dh], 16-byte aligned), keys at or past n_valid
// excluded; lse (fp32 [batch, heads, n]) written when not null; mask
// (uint8 0/1 [batch, heads, n, n]) with keep in (0, 1] applied when not
// null.  dh 64 or 192, n <= 1,024.
extern "C" int sfc_packed_attention_f32(const void* qkv, void* out, void* lse,
                                        const void* mask, int batch, int n, int heads,
                                        int dh, int n_valid, float scale, float keep,
                                        void* stream) {
  if (batch < 0 || n < 1 || n > 1024 || heads < 1 || n_valid < 1 || n_valid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const auto* q = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(out);
  auto* ls = static_cast<float*>(lse);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh == 64)
    err = launch_dh<64>(q, o, ls, mk, batch, n, heads, n_valid, scale, keep, s);
  else if (dh == 192)
    err = launch_dh<192>(q, o, ls, mk, batch, n, heads, n_valid, scale, keep, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Registers, local bytes and shared bytes of the instance for dh (64 or
// 192), masked or not.
extern "C" int sfc_packed_attention_f32_attrs(int dh, int masked, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  size_t smem;
  if (dh == 64) {
    smem = smem_bytes<64>();
    err = masked ? cudaFuncGetAttributes(&attr, packed_attn_f32_kernel<64, true>)
                 : cudaFuncGetAttributes(&attr, packed_attn_f32_kernel<64, false>);
  } else {
    smem = smem_bytes<192>();
    err = masked ? cudaFuncGetAttributes(&attr, packed_attn_f32_kernel<192, true>)
                 : cudaFuncGetAttributes(&attr, packed_attn_f32_kernel<192, false>);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  return 0;
}
