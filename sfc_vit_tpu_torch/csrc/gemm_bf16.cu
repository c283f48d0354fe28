// C[M, N] = epilogue(op(A) . op(B)) in bf16 with fp32 accumulators:
// every projection of both fused blocks, forward and backward, for Hopper.
//
// Replaces: the GEMMs inside sfc_vit_tpu/ops/fused_mlp.py::_mlp_kernel
// (fc1 with +b1 and exact-erf GELU, the training forward's saved z, fc2
// with +b2 and the residual), ::_mlp_bwd_kernel (lines 296-318: h^T.g,
// g.W2^T times act'(z) with db1 = colsum(dz), xn^T.dz, dz.W1^T) and
// sfc_vit_tpu/ops/fused_attention_block.py::_attn_block_kernel (the QKV
// projection, rounded to bf16 like qkv_s, and the output projection with
// the residual of x added in fp32) and ::_attn_block_bwd_kernel (lines
// 415-419 and 501-513: gp.W_out^T, att^T.gp, dqkv.W_qkv^T, xn^T.dqkv), and
// the four GEMMs of sfc_vit_tpu/ops/fused_mlp.py::_postnorm_tail_kernel and
// ::_postnorm_tail_bwd_kernel (fc2 plus b2 plus the unrounded LN1 output x2f
// into the fp32 pre-LN2 sum s2; dx2 = dz.W1^T + ds2 in fp32).
// The epilogue adds each optional term in fp32 and rounds once, which is
// where the TPU kernels round; dxn leaves in fp32 for the LayerNorm
// backward, as the TPU kernel keeps it.
//
// Layouts.  op(A) is A [M, K] as stored, or (trans_a) A stored [K, M]
// and read transposed: the weight gradients, whose contraction runs over
// the R = B*N rows.  op(B) is B [K, N] (a Dense kernel as stored), or
// (trans_b) B stored [N, K]: products with W^T.  No operand is transposed
// or padded by a copy: TMA brings 64 x 64 boxes as stored, 128-byte
// swizzled, and wgmma reads each either K-major or, through its transpose
// bit, MN-major (NN: A K-major, B MN-major; NT: both K-major; TN: both
// MN-major).  Ragged edges (R = 50,176, 12,544 or 196 b rows; N a multiple
// of 8 only) read as zero past the tensor (TMA's out-of-bounds fill) and
// are masked on store.
//
// Bound on this card: tensor-core throughput.  At ViT-B batch 256 the
// shapes are R = 50,176 rows by widths of 768..3072: hundreds of flops
// per byte, above the H100's ridge (~295).  Design: a persistent grid
// (one block an SM) walks 128 x 128 output tiles.  A block is a producer
// warp and two consumer warpgroups (288 threads): the producer's one
// thread keeps a ring of kStages stages in flight, each a 64-deep K slice
// of op(A) and op(B) (4 boxes, 32 KB) guarded by a full and an empty
// mbarrier; each consumer warpgroup issues m64n128k16 wgmma on its 64
// rows with fp32 accumulators in registers (64 a thread), one stage's
// products in flight while the next stage is waited for.  The epilogue
// stages the accumulators in shared memory (fp32, 8-column groups
// permuted by row against bank conflicts), then each thread finishes 8
// neighbouring columns of rows in a loop that is not unrolled (bias, z,
// act or act'(z), column sums, residuals, C: 16-byte loads and stores, a
// row's 128 columns by 16 threads), and the producer fills the next
// tile's stages meanwhile.  The kernel is instantiated per activation
// kind (none, act, act'(z)), so no instance carries another's code.
// Each row's z_in and residuals are loaded a row ahead.  On the H100
// (chip_smoke.py's GEMM lines) the same epilogue run on the accumulator
// fragments in registers, fully unrolled with every optional term, held
// datt (K = 768) to 183 TFLOP/s; staged and rolled, 380.  Ping-pong
// consumers (a whole tile each, in turn) need 128 accumulator registers a
// thread and spilled at nine warps' cap of 168; running a row of the last
// tile's epilogue after each K slice's products spilled too and ran
// slower.
//
// Split-K (the weight gradients: 36-144 output tiles for 132 SMs at
// ViT-B, 4-12 on 'hier' at d = 256, each a 12,544-50,176-deep sum): the
// Python launcher picks `splits` (ops/_build.py::gemm_splits) and gives an
// fp32 workspace [splits, M, N].  A work unit is (split, tile); each
// writes its raw fp32 partial sum over its contiguous K range, and a
// second kernel adds the partials in split order and applies the
// epilogue.  Every output is then one fp32 sum in a fixed order, rounded
// once: the same inputs give the same bits.  The column sums (colsum) are
// taken in a fixed order inside a block and meet across blocks by one
// fp32 atomic per column and block, whose order varies run to run.
//
// Every wgmma wait has a fixed count (no branch decides it), so ptxas
// does not serialize the products.

#include "sm90.cuh"

namespace {

using sfc::bf16;
namespace hw = sfc::sm90;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows of the tile each
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kBox = 64 * 128;         // one 64 x 64 bf16 box, 128-byte swizzled
constexpr int kStageBytes = 4 * kBox;  // two boxes of op(A), two of op(B)
// Named barriers: 1 + wg a warpgroup's epilogue, kCsumBar both's column sums.
constexpr int kCsumBar = 3;

struct Epilogue {
  const float* bias;      // fp32 [N], added first
  const bf16* z_in;       // bf16 [M, N]: multiply by act'(z) instead of act()
  bf16* z_out;            // bf16 [M, N]: the pre-activation, rounded
  float* colsum;          // fp32 [N]: += column sums of the fp32 result
  const bf16* residual;   // bf16 [M, N], added after the column sums
  const float* residual_f32;  // fp32 [M, N], added last
  int act;
  bool c_fp32;            // C is fp32 [M, N] instead of bf16
};

// The shape of the call; the kernel copies it (and the Epilogue) out of the
// __grid_constant__ parameter into registers once, never through a
// reference into parameter space.
struct Shape {
  int M, N, n_tiles, tiles, kblocks, kb_per_split, units;
};

struct Params {
  CUtensorMap a, b;     // 64 x 64 boxes of A and B as stored
  void* c_ptr;          // C, bf16 or fp32 [M, N]
  float* partial;       // split-K: fp32 [splits, M, N] raw sums; no epilogue here
  Shape sh;
  Epilogue ep;
};

struct Smem {
  unsigned char a[kStages][2 * kBox];  // op(A) rows 0-63 and 64-127 of the tile
  unsigned char b[kStages][2 * kBox];  // op(B) columns 0-63 and 64-127
  float stage[kConsumers][64 * BN];    // fp32 C staging, a warpgroup's 64 rows (see stage_at)
  uint64_t full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + the 1,024-byte alignment

// Element (row, col) of a staging tile: rows of 128 fp32, the 8-column
// groups of row r permuted by r % 8, so the warp's float2 writes of
// accumulator fragments (8 rows a group) land on distinct banks.
__device__ __forceinline__ int stage_at(int row, int col) {
  return row * BN + (col ^ ((row & 7) << 3));
}

// One work unit: the output tile at (m0, n0) over K blocks [kb0, kb1).
struct Unit {
  int m0, n0, kb0, kb1, split;
};

__device__ __forceinline__ Unit unit_of(const Shape sh, int u) {
  Unit w;
  w.split = u / sh.tiles;
  const int t = u % sh.tiles;
  w.m0 = (t / sh.n_tiles) * BM;
  w.n0 = (t % sh.n_tiles) * BN;
  w.kb0 = w.split * sh.kb_per_split;
  w.kb1 = min(sh.kblocks, w.kb0 + sh.kb_per_split);
  return w;
}

// The epilogue's inputs at 8 neighbouring columns of one row.
struct In8 {
  uint4 z, r;       // z_in, residual (bf16)
  float4 f0, f1;    // residual_f32
};

__device__ __forceinline__ void load8(In8& in, size_t off, const Epilogue& ep) {
  if (ep.z_in != nullptr) in.z = *reinterpret_cast<const uint4*>(ep.z_in + off);
  if (ep.residual != nullptr) in.r = *reinterpret_cast<const uint4*>(ep.residual + off);
  if (ep.residual_f32 != nullptr) {
    const float4* src = reinterpret_cast<const float4*>(ep.residual_f32 + off);
    in.f0 = src[0];
    in.f1 = src[1];
  }
}

// What the epilogue applies between the bias and the column sums: the
// kernel is instantiated for each, so none carries the others' code.
enum ActKind : int { kLinear = 0, kActFwd = 1, kActGrad = 2 };

__host__ __device__ constexpr int act_kind(bool z_in, int act) {
  return z_in ? kActGrad : act != sfc::kNone ? kActFwd : kLinear;
}

// The epilogue of 8 neighbouring columns (gc .. gc + 7 of row `off / N`):
// + bias, z_out, act (kActFwd) or act'(z_in) (kActGrad), column sums into
// cs, + residual, + residual_f32, then C.
template <int KIND>
__device__ __forceinline__ void finish8(float (&v)[8], size_t off, int gc, const Epilogue& ep,
                                        const In8& in, void* C, float (&cs)[8]) {
  if (ep.bias != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += ep.bias[gc + e];
  }
  if (ep.z_out != nullptr) *reinterpret_cast<uint4*>(ep.z_out + off) = sfc::pack_bf16x8(v);
  if constexpr (KIND == kActGrad) {
    float z[8];
    sfc::unpack_bf16x8(in.z, z);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] *= sfc::act_grad(z[e], ep.act);
  } else if constexpr (KIND == kActFwd) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sfc::act_fwd(v[e], ep.act);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] += v[e];
  if (ep.residual != nullptr) {
    float x[8];
    sfc::unpack_bf16x8(in.r, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += x[e];
  }
  if (ep.residual_f32 != nullptr) {
    v[0] += in.f0.x; v[1] += in.f0.y; v[2] += in.f0.z; v[3] += in.f0.w;
    v[4] += in.f1.x; v[5] += in.f1.y; v[6] += in.f1.z; v[7] += in.f1.w;
  }
  if (ep.c_fp32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(C) + off);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + off) = sfc::pack_bf16x8(v);
  }
}

template <bool TA, bool TB, int KIND>
__global__ void __launch_bounds__(kThreads, 1) gemm_bf16_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  Smem& sm = hw::aligned_smem<Smem>(dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t = tid % 128;
  const Shape sh = p.sh;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::bar_init(&sm.full[s], 1);
      hw::bar_init(&sm.empty[s], 2 * 4);  // the consumer warps
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer: one thread starts every TMA load
    if (lane == 0) {
      hw::Ring<kStages> ring;
      for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
        const Unit w = unit_of(sh, u);
        for (int kb = w.kb0; kb < w.kb1; ++kb) {
          // The first pass finds every slot free.
          hw::bar_wait(&sm.empty[ring.slot], ring.phase ^ 1);
          uint64_t* bar = &sm.full[ring.slot];
          hw::bar_expect_tx(bar, kStageBytes);
          const int k0 = kb * BK;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // Box coordinates are (inner, outer) of the operand as stored.
            unsigned char* a = sm.a[ring.slot] + c * kBox;
            unsigned char* b = sm.b[ring.slot] + c * kBox;
            if (TA) hw::tma_load2(a, &p.a, bar, w.m0 + 64 * c, k0);
            else hw::tma_load2(a, &p.a, bar, k0, w.m0 + 64 * c);
            if (TB) hw::tma_load2(b, &p.b, bar, k0, w.n0 + 64 * c);
            else hw::tma_load2(b, &p.b, bar, w.n0 + 64 * c, k0);
          }
          ring.next();
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile;
  // this thread rows r0 and r0 + 8 of those, columns 8 j + c0 + {0, 1}.
  const int r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (lane % 4);
  const int M = sh.M, N = sh.N;
  float* const partial = p.partial;
  void* const C = p.c_ptr;
  float* stage = sm.stage[wg];
  hw::Ring<kStages> ring;
  float acc[64];

  for (int u = blockIdx.x; u < sh.units; u += gridDim.x) {
    const Unit w = unit_of(sh, u);
    const int nkb = w.kb1 - w.kb0;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int i = 0; i < nkb; ++i) {
      hw::bar_wait(&sm.full[ring.slot], ring.phase);
      // A: this warpgroup's box, K-major (a k16 step 32 bytes along the
      // row) or MN-major (16 rows = 2,048 bytes down).  B: 128 K-major
      // rows, or two MN-major 64-column atoms one box apart.
      const uint64_t da = hw::desc_sw128(sm.a[ring.slot] + wg * kBox);
      const uint64_t db = TB ? hw::desc_sw128(sm.b[ring.slot])
                             : hw::desc_sw128_atoms(sm.b[ring.slot], kBox);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hw::wgmma_ss128<TA ? 1 : 0, TB ? 0 : 1>(acc, da + (TA ? kk * (2048 >> 4) : 2 * kk),
                                                 db + (TB ? 2 * kk : kk * (2048 >> 4)), 1);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();  // the previous stage's products are done
      hw::fence_regs(acc);
      if (i > 0 && lane == 0) hw::bar_arrive(&sm.empty[prev]);
      prev = ring.slot;
      ring.next();
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    if (nkb > 0 && lane == 0) hw::bar_arrive(&sm.empty[prev]);

    const int row0 = w.m0 + 64 * wg;
    if (partial != nullptr) {  // split-K: the raw fp32 sum of this K range
      float* part = partial + static_cast<size_t>(w.split) * M * N;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gr = row0 + r0 + 8 * hf, gc = w.n0 + 8 * j + c0;
          if (gr < M && gc < N)
            *reinterpret_cast<float2*>(part + static_cast<size_t>(gr) * N + gc) =
                make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
      continue;
    }

    // The accumulators into this warpgroup's fp32 staging tile, once its
    // last epilogue has read it; then each thread finishes 8 neighbouring
    // columns of rows t / 16, t / 16 + 8, ... (16-byte loads and stores, a
    // row's 128 columns by 16 threads) in a loop that is not unrolled.
    hw::named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(stage + stage_at(r0 + 8 * hf, 8 * j + c0)) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    hw::named_sync(1 + wg, 128);
    const Epilogue ep = p.ep;
    const int cc = t % 16, gc = w.n0 + 8 * cc;
    float cs[8] = {};
    // Each row's inputs (z_in, residuals) are loaded one row ahead.
    auto in_tile = [&](int rr) { return row0 + rr < M && gc < N; };  // N % 8 == 0
    auto offset = [&](int rr) { return static_cast<size_t>(row0 + rr) * N + gc; };
    In8 next = {};
    if (in_tile(t / 16)) load8(next, offset(t / 16), ep);
#pragma unroll 1
    for (int rr = t / 16; rr < 64; rr += 8) {
      const In8 in = next;
      if (rr + 8 < 64 && in_tile(rr + 8)) load8(next, offset(rr + 8), ep);
      if (in_tile(rr)) {
        const float4* src = reinterpret_cast<const float4*>(stage + stage_at(rr, 8 * cc));
        const float4 x = src[0], y = src[1];
        float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
        finish8<KIND>(v, offset(rr), gc, ep, in, C, cs);
      }
    }
    if (ep.colsum != nullptr) {  // over the tile's rows in a fixed order, one atomic a column
#pragma unroll
      for (int e = 0; e < 8; ++e) cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
      hw::named_sync(kCsumBar, 2 * 128);  // both staging tiles are read: they take the warps' sums
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sm.stage[0][warp * BN + 8 * cc + e] = cs[e];
      }
      hw::named_sync(kCsumBar, 2 * 128);
      if (tid < BN && w.n0 + tid < N) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 2 * 4; ++q) sum += sm.stage[0][q * BN + tid];
        atomicAdd(&ep.colsum[w.n0 + tid], sum);  // warpgroup 0 reads before it stages again
      }
    }
  }
}

// C = epilogue(partial[0] + partial[1] + ... ) in split order: 256
// threads a block, 8 of 8 columns each across 64 columns, 32 rows.
template <int KIND>
__global__ void __launch_bounds__(256)
    gemm_splitk_sum(const float* __restrict__ part, int splits, void* __restrict__ C, int M,
                    int N, const Epilogue epilogue) {
  const Epilogue ep = epilogue;  // in registers (a reference to the parameter would be local)
  __shared__ float csum[32][64];
  const int cx = threadIdx.x % 8, ry = threadIdx.x / 8;
  const int gc = blockIdx.x * 64 + cx * 8, gr = blockIdx.y * 32 + ry;
  float cs[8] = {};
  if (gc < N && gr < M) {
    const size_t off = static_cast<size_t>(gr) * N + gc, plane = static_cast<size_t>(M) * N;
    float v[8] = {};
    for (int s = 0; s < splits; ++s) {
      const float4* src = reinterpret_cast<const float4*>(part + s * plane + off);
      const float4 x = src[0], y = src[1];
      v[0] += x.x; v[1] += x.y; v[2] += x.z; v[3] += x.w;
      v[4] += y.x; v[5] += y.y; v[6] += y.z; v[7] += y.w;
    }
    In8 in;
    load8(in, off, ep);
    finish8<KIND>(v, off, gc, ep, in, C, cs);
  }
  if (ep.colsum != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) csum[ry][cx * 8 + e] = cs[e];
    __syncthreads();
    const int col = blockIdx.x * 64 + threadIdx.x;
    if (threadIdx.x < 64 && col < N) {
      float s = 0.f;
      for (int r = 0; r < 32; ++r) s += csum[r][threadIdx.x];
      atomicAdd(&ep.colsum[col], s);
    }
  }
}

template <bool TA, bool TB, int KIND>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int cache[64] = {};
  auto kernel = gemm_bf16_sm90<TA, TB, KIND>;
  cudaError_t e;
  const int grid = hw::persistent_grid(kernel, kThreads, kSmemBytes, p.sh.units, cache, &e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_layout(const Params& p, bool trans_a, bool trans_b, cudaStream_t stream) {
  if (trans_a) return launch<true, false, KIND>(p, stream);
  if (trans_b) return launch<false, true, KIND>(p, stream);
  return launch<false, false, KIND>(p, stream);
}

// Kernel `form` of sfc_gemm_attrs: layout (NN, NT, TN) x 3 + the act kind.
template <int F>
auto kernel_of() {
  return gemm_bf16_sm90<F / 3 == 2, F / 3 == 1, F % 3>;
}

}  // namespace

// C [M, N] = op(A) . op(B) with the epilogue, in this order: + bias (fp32
// [N]); z_out = bf16(sum); times act'(z_in) when z_in is given, else
// act(); colsum += the fp32 column sums; + residual (bf16 [M, N]);
// + residual_f32 (fp32 [M, N]); one rounding into C (bf16, or fp32 when
// c_fp32).  Every pointer but a, b, c and workspace may be null.  act: 0
// none, 1 exact-erf GELU, 2 ReLU.  trans_a: A is stored [K, M]; trans_b: B
// is stored [N, K].  splits > 1 (trans_a only) sums the contraction in
// that many contiguous ranges of ceil(ceil(K / 64) / splits) 64-row blocks
// (none empty) into workspace, fp32 [splits, M, N], then adds them in
// order.  Requires N % 8 == 0, M % 8 == 0 when trans_a, K % 8 == 0 unless
// (trans_a and not trans_b), and 16-byte aligned pointers; the Python
// wrapper checks these.
extern "C" int sfc_gemm_bf16(const void* a, const void* b, const void* bias,
                             const void* residual, const void* residual_f32,
                             const void* z_in, void* z_out, void* colsum, void* c,
                             void* workspace, int c_fp32, int M, int N, int K, int trans_a,
                             int trans_b, int act, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((trans_a && trans_b) || K < 0 || splits < 1 || (splits > 1 && !trans_a) ||
      (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  const Epilogue ep{static_cast<const float*>(bias), static_cast<const bf16*>(z_in),
                    static_cast<bf16*>(z_out), static_cast<float*>(colsum),
                    static_cast<const bf16*>(residual),
                    static_cast<const float*>(residual_f32), act, c_fp32 != 0};
  Shape& sh = p.sh;
  sh.M = M;
  sh.N = N;
  sh.n_tiles = (N + BN - 1) / BN;
  sh.tiles = ((M + BM - 1) / BM) * sh.n_tiles;
  sh.kblocks = (K + BK - 1) / BK;
  sh.kb_per_split = (sh.kblocks + splits - 1) / splits;
  if (splits > 1 && (splits - 1) * sh.kb_per_split >= sh.kblocks)
    return static_cast<int>(cudaErrorInvalidValue);  // a split would be empty
  sh.units = sh.tiles * splits;
  cudaError_t e = cudaSuccess;
  if (K > 0) {  // K = 0: no loads; the epilogue of zero sums
    e = trans_a ? hw::map_2d_bf16(&p.a, a, M, K) : hw::map_2d_bf16(&p.a, a, K, M);
    if (e == cudaSuccess)
      e = trans_b ? hw::map_2d_bf16(&p.b, b, K, N) : hw::map_2d_bf16(&p.b, b, N, K);
  }
  if (splits > 1) {
    p.partial = static_cast<float*>(workspace);
  } else {
    p.ep = ep;
    p.c_ptr = c;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  const int kind = act_kind(z_in != nullptr, act);
  if (splits > 1) e = launch_layout<kLinear>(p, trans_a, trans_b, s);  // raw partial sums
  else if (kind == kActGrad) e = launch_layout<kActGrad>(p, trans_a, trans_b, s);
  else if (kind == kActFwd) e = launch_layout<kActFwd>(p, trans_a, trans_b, s);
  else e = launch_layout<kLinear>(p, trans_a, trans_b, s);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const dim3 grid((N + 63) / 64, (M + 31) / 32);
  if (kind == kActGrad)
    gemm_splitk_sum<kActGrad><<<grid, 256, 0, s>>>(p.partial, splits, c, M, N, ep);
  else if (kind == kActFwd)
    gemm_splitk_sum<kActFwd><<<grid, 256, 0, s>>>(p.partial, splits, c, M, N, ep);
  else
    gemm_splitk_sum<kLinear><<<grid, 256, 0, s>>>(p.partial, splits, c, M, N, ep);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes and shared bytes of form f into out[3]: f in
// 0..8 the tile kernel of layout f / 3 (NN, NT, TN) and act kind f % 3
// (none, act, act'), 9 the split-K sum (its act'(z) instance).
extern "C" int sfc_gemm_attrs(int form, int* out) {
  switch (form) {
    case 0: return hw::kernel_attrs(kernel_of<0>(), kSmemBytes, out);
    case 1: return hw::kernel_attrs(kernel_of<1>(), kSmemBytes, out);
    case 2: return hw::kernel_attrs(kernel_of<2>(), kSmemBytes, out);
    case 3: return hw::kernel_attrs(kernel_of<3>(), kSmemBytes, out);
    case 4: return hw::kernel_attrs(kernel_of<4>(), kSmemBytes, out);
    case 5: return hw::kernel_attrs(kernel_of<5>(), kSmemBytes, out);
    case 6: return hw::kernel_attrs(kernel_of<6>(), kSmemBytes, out);
    case 7: return hw::kernel_attrs(kernel_of<7>(), kSmemBytes, out);
    case 8: return hw::kernel_attrs(kernel_of<8>(), kSmemBytes, out);
    case 9: return hw::kernel_attrs(gemm_splitk_sum<kActGrad>, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
