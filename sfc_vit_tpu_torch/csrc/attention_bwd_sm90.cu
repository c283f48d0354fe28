// Softmax-attention backward straight off the packed QKV projection, for
// Hopper, at head dim 64 without dropout and up to kMaxN tokens: the
// attention part of ViT-B's block backward (kernel #4).
//
// Replaces: the per-(image, head) loop of
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_bwd_kernel (lines
// 423-496) on the path the TPU trains with (with_acts + with_lse: the
// forward saved qkv, att and the log-sum-exp), where csrc/attention_bwd.cu
// ran it as two WMMA kernels with a delta scratch in global memory.  It
// reads q, k and v from qkv [B, N, 3*H*64] at columns h*64, (H + h)*64
// and (2H + h)*64, da from datt [B, N, H*64] (= bf16(gp . W_out^T)), the
// forward's att [B, N, H*64] and lse [B, H, N], and writes dq, dk and dv
// into the packed dqkv at the same columns.
//
// The TPU kernel's rounding points (attention_bwd.cu's without dropout):
// pn = bf16(exp(s * scale - lse)), keys at or past n_valid giving 0;
// dpn = da . v^T in fp32; delta = rowsum(da * att_h) in fp32;
// ds = bf16(pn * (dpn - delta) * scale); dv = pn^T . da, dq = ds . k and
// dk = ds^T . q, each one fp32 sum over the sequence rounded once.
//
// Bound on this card: at ViT-B (N = 196, 12 heads, batch 256) the five
// products are 5 x 2 x 196^2 x 64 x 3,072 = 75.5 GFLOP (0.076 ms at 989
// TFLOP/s) on 5 x 77 MB read (q, k, v, att, da) and 231 MB written (0.18
// ms at 3.35 TB/s): the bytes bound the call.
// Design: one (image, head) is an item; its q, k, v and da fit one block
// (4 tiles of 64 rows each at N <= 256, 32 KB a tensor).  A persistent
// grid (one block an SM, two warpgroups) walks the items; thread 0 brings
// each tile by TMA (128-byte swizzled, rows past N read as zero): K and V
// into a two-item ring, so the next item's K and V arrive while this one
// computes, Q and dA into one buffer refilled at each item's start (two
// items of all four do not fit 227 KB).
//  * pass 0: thread i computes row i's delta (da from shared memory, att
//    from global memory) and keeps it and lse * log2(e) in shared memory.
//  * pass 1, a warpgroup a query tile: S = Q K_j^T and dP = dA V_j^T by
//    wgmma for each key tile j, pn and ds in registers, dq += ds . K_j with
//    ds as the register A operand (the accumulator-to-A map of sm90.cuh).
//  * pass 2, a warpgroup a key tile: S^T = K_j Q_i^T and dP^T = V_j dA_i^T
//    for each query tile i, pn^T and ds^T in registers, dv += pn^T . dA_i
//    and dk += ds^T . Q_i, both A operands from registers.  The logits and
//    dp are computed twice (seven products where five would do): the
//    transposed pn and ds tiles of all (i, j) pairs would need 256 KB of
//    shared memory, and dk, dv and dq held at once 96 more registers.
// dq, dk and dv leave once each, rounded to bf16, through a swizzled
// staging tile by TMA store (rows past N are not written): no second
// kernel, no scratch in global memory and no atomics, so the same inputs
// give the same bits.  Every wgmma wait has a fixed count.

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int kMaxN = 256;  // the Python ATTENTION_BWD_SM90_MAX_N
constexpr int kMaxTiles = kMaxN / 64;
constexpr int kThreads = 256;  // two warpgroups; thread i also owns row i in pass 0
constexpr int kBox = 64 * 128;  // a 64-row tile of one head, swizzled
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  unsigned char kv[2][2][kMaxTiles][kBox];  // K and V of two items
  unsigned char qd[2][kMaxTiles][kBox];     // Q and dA of this item
  unsigned char out[2][kBox];               // each warpgroup's staging tile
  float lse[kMaxN];                         // lse * log2(e) by query row
  float delta[kMaxN];
  uint64_t kv_full[2], qd_full;
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

struct Params {
  CUtensorMap qkv, da, out;  // 64-column sub-heads: 3H of qkv and of dqkv, H of datt
  const bf16* att;
  const float* lse;
  int n, heads, n_valid, tiles, items;
  float scale, scale_log2;
};

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t = tid % 128;
  // This thread's accumulator rows r0 and r0 + 8 of a 64-row tile, and
  // columns 8 j + c0 + {0, 1}.
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (lane % 4);
  // Scalars in registers (fields of the __grid_constant__ parameter read
  // through the lambdas' references would be generic loads).
  const int H = p.heads, n = p.n, n_valid = p.n_valid, tiles = p.tiles, items = p.items;
  const float scale = p.scale, c = p.scale_log2;
  const uint32_t tensor_bytes = tiles * kBox;

  if (tid == 0) {
    hw::bar_init(&sm.kv_full[0], 1);
    hw::bar_init(&sm.kv_full[1], 1);
    hw::bar_init(&sm.qd_full, 1);
    hw::fence_barrier_init();
  }
  __syncthreads();

  auto load_kv = [&](int item, int slot) {
    const int b = item / H, h = item % H;
    hw::bar_expect_tx(&sm.kv_full[slot], 2 * tensor_bytes);
    for (int i = 0; i < tiles; ++i) {
      hw::tma_load4(sm.kv[slot][0][i], &p.qkv, &sm.kv_full[slot], 0, H + h, 64 * i, b);
      hw::tma_load4(sm.kv[slot][1][i], &p.qkv, &sm.kv_full[slot], 0, 2 * H + h, 64 * i, b);
    }
  };
  if (tid == 0 && blockIdx.x < items) load_kv(blockIdx.x, 0);

  uint32_t qd_phase = 0;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int b = item / H, h = item % H;
    const int slot = it & 1;
    // Row tid's att and lse, read before the wait for the buffers.
    uint4 att_row[8];
    float lse_row = 0.f;
    if (tid < n) {
      const uint4* src = reinterpret_cast<const uint4*>(
          p.att + ((static_cast<size_t>(b) * n + tid) * H + h) * 64);
#pragma unroll
      for (int k = 0; k < 8; ++k) att_row[k] = src[k];
      lse_row = p.lse[(static_cast<size_t>(b) * H + h) * n + tid];
    }
    // Every thread is done with the previous item (its Q / dA buffer, the
    // other K / V slot, lse and delta); generic reads of the buffers are
    // ordered before the TMA writes that refill them.
    hw::fence_async_shared();
    hw::named_sync(1, kThreads);
    if (tid == 0) {
      hw::bar_expect_tx(&sm.qd_full, 2 * tensor_bytes);
      for (int i = 0; i < tiles; ++i) {
        hw::tma_load4(sm.qd[0][i], &p.qkv, &sm.qd_full, 0, h, 64 * i, b);
        hw::tma_load4(sm.qd[1][i], &p.da, &sm.qd_full, 0, h, 64 * i, b);
      }
      if (item + static_cast<int>(gridDim.x) < items) load_kv(item + gridDim.x, slot ^ 1);
    }
    hw::bar_wait(&sm.qd_full, qd_phase);
    qd_phase ^= 1;

    // Pass 0: delta = rowsum(da * att_h) in fp32 for row tid.
    float dl = 0.f;
    if (tid < n) {
      const unsigned char* da_t = sm.qd[1][tid / 64];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float a[8], g[8];
        sfc::unpack_bf16x8(att_row[k], a);
        sfc::unpack_bf16x8(
            *reinterpret_cast<const uint4*>(da_t + hw::sw128_bf16(tid % 64, 8 * k)), g);
#pragma unroll
        for (int e = 0; e < 8; ++e) dl += a[e] * g[e];
      }
    }
    sm.lse[tid] = lse_row * kLog2e;
    sm.delta[tid] = dl;
    hw::named_sync(1, kThreads);
    hw::bar_wait(&sm.kv_full[slot], (it >> 1) & 1);

    // Round a warpgroup's 64 x 64 accumulator into its staging tile and
    // store it as rows row0.. of sub-head `sub`.
    unsigned char* st = sm.out[wg];
    auto store = [&](const float (&acc)[32], int sub, int row0) {
      if (t == 0) hw::bulk_wait_read<0>();
      hw::named_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(st + hw::sw128_bf16(r0 + 8 * hf, 8 * j + c0)) =
              hw::pack_bf16x2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      hw::fence_async_shared();
      hw::named_sync(2 + wg, 128);
      if (t == 0) {
        hw::tma_store4(&p.out, st, 0, sub, row0, b);
        hw::bulk_commit();
      }
    };
    // acc (m64n64) = A . B^T over Dh = 64, both tiles K-major.
    auto product_t = [&](float (&acc)[32], const unsigned char* a, const unsigned char* bt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hw::wgmma_ss<0, 0>(acc, hw::desc_sw128(a) + 2 * kk, hw::desc_sw128(bt) + 2 * kk, kk);
    };
    const int key_tiles = (n_valid + 63) / 64;  // keys past n_valid add nothing
    float s[32], dp[32];
    uint32_t fa[4][4], fb[4][4];

    // Pass 1: dq of query tiles wg, wg + 2.
    for (int i = wg; i < tiles; i += 2) {
      const unsigned char* qs = sm.qd[0][i];
      const unsigned char* das = sm.qd[1][i];
      float lq[2], dq_delta[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        lq[hf] = sm.lse[64 * i + r0 + 8 * hf];
        dq_delta[hf] = sm.delta[64 * i + r0 + 8 * hf];
      }
      float dq[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[e] = 0.f;
      for (int j = 0; j < key_tiles; ++j) {
        const unsigned char* ks = sm.kv[slot][0][j];
        hw::fence_regs(s);
        hw::fence_regs(dp);
        hw::wgmma_fence();
        product_t(s, qs, ks);                  // s = q . k^T
        product_t(dp, das, sm.kv[slot][1][j]);  // dp = da . v^T
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(s);
        hw::fence_regs(dp);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hf = (e / 2) % 2, key = 64 * j + 8 * (e / 4) + c0 + (e % 2);
          const float pn = __bfloat162float(__float2bfloat16(
              key < n_valid ? hw::exp2_approx(fmaf(s[e], c, -lq[hf])) : 0.f));
          s[e] = pn * (dp[e] - dq_delta[hf]) * scale;  // ds, rounded by acc_to_a
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hw::acc_to_a(s, kk, fa[kk]);
        hw::fence_regs(dq);
        hw::fence_frags(fa);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dq += ds . k (k read through the transpose bit)
          hw::wgmma_rs<1>(dq, fa[kk], hw::desc_sw128(ks) + kk * (2048 >> 4), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dq);
        hw::fence_frags(fa);
      }
      store(dq, h, 64 * i);
    }

    // Pass 2: dk and dv of key tiles wg, wg + 2.
    for (int j = wg; j < tiles; j += 2) {
      const unsigned char* ks = sm.kv[slot][0][j];
      const unsigned char* vs = sm.kv[slot][1][j];
      bool key_ok[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) key_ok[hf] = 64 * j + r0 + 8 * hf < n_valid;
      float dk[32], dv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
      for (int i = 0; j < key_tiles && i < tiles; ++i) {
        const unsigned char* qs = sm.qd[0][i];
        const unsigned char* das = sm.qd[1][i];
        hw::fence_regs(s);
        hw::fence_regs(dp);
        hw::wgmma_fence();
        product_t(s, ks, qs);    // s^T = k . q^T
        product_t(dp, vs, das);  // dp^T = v . da^T
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(s);
        hw::fence_regs(dp);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hf = (e / 2) % 2, q = 64 * i + 8 * (e / 4) + c0 + (e % 2);
          const float pn = __bfloat162float(__float2bfloat16(
              key_ok[hf] ? hw::exp2_approx(fmaf(s[e], c, -sm.lse[q])) : 0.f));
          s[e] = pn;
          dp[e] = pn * (dp[e] - sm.delta[q]) * scale;  // ds^T, rounded by acc_to_a
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hw::acc_to_a(s, kk, fa[kk]);
          hw::acc_to_a(dp, kk, fb[kk]);
        }
        hw::fence_regs(dk);
        hw::fence_regs(dv);
        hw::fence_frags(fa);
        hw::fence_frags(fb);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hw::wgmma_rs<1>(dv, fa[kk], hw::desc_sw128(das) + kk * (2048 >> 4), 1);  // pn^T . da
          hw::wgmma_rs<1>(dk, fb[kk], hw::desc_sw128(qs) + kk * (2048 >> 4), 1);   // ds^T . q
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dk);
        hw::fence_regs(dv);
        hw::fence_frags(fa);
        hw::fence_frags(fb);
      }
      store(dk, H + h, 64 * j);
      store(dv, 2 * H + h, 64 * j);
    }
  }
  if (t == 0) hw::bulk_wait_all();  // the stores have written before the block leaves
}

}  // namespace

// qkv bf16 [batch, n, 3*heads*64], att and datt bf16 [batch, n, heads*64],
// lse fp32 [batch, heads, n], all contiguous and on 16 bytes; dqkv bf16
// [batch, n, 3*heads*64] receives dq, dk and dv (every element is
// written).  Keys at or past n_valid (1 <= n_valid <= n) are masked;
// 1 <= n <= 256.
extern "C" int sfc_attention_bwd_sm90_bf16(const void* qkv, const void* att, const void* datt,
                                           const void* lse, void* dqkv, int batch, int n,
                                           int heads, int n_valid, float scale, void* stream) {
  if (n < 1 || n > kMaxN || heads < 1 || n_valid < 1 || n_valid > n || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long row = 3LL * heads * 64, inner = 64LL * heads;
  Params p{};
  cudaError_t e = hw::map_bnhd(&p.qkv, qkv, batch, n, 3 * heads, row * n, row, 64, 64);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.da, datt, batch, n, heads, inner * n, inner, 64, 64);
  if (e == cudaSuccess) e = hw::map_bnhd(&p.out, dqkv, batch, n, 3 * heads, row * n, row, 64, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.att = static_cast<const bf16*>(att);
  p.lse = static_cast<const float*>(lse);
  p.n = n;
  p.heads = heads;
  p.n_valid = n_valid;
  p.tiles = (n + 63) / 64;
  p.items = batch * heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  static int cache[64] = {};
  const int grid =
      hw::persistent_grid(attention_bwd_sm90, kThreads, kSmemBytes, p.items, cache, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_sm90<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of the kernel, into out[3].
extern "C" int sfc_attention_bwd_sm90_attrs(int* out) {
  return hw::kernel_attrs(attention_bwd_sm90, kSmemBytes, out);
}
