// Device code shared by K1 (trunk_train_fwd.cu) and K2 (trunk_train_bwd.cu):
// the training trunk of T-NeRF with ghost BatchNorm, layer-major.
//
// The TPU kernels (season_nerf_tpu/ops/pallas_train.py) keep every weight
// and a whole 2048-row tile in VMEM.  A 2048 x 512 tile is 2 MB and an SM
// has 227 KB, and the ghost statistics need every row of the tile's z
// before any row can be normalised.  So the Hopper version runs the trunk
// one layer at a time over the whole batch:
//   1. a GEMM writes z = h . W + b in f32 to scratch (gemm_wgmma: TMA and
//      wgmma bf16 -> f32 when both operands are bf16; gemm_f32: FFMA
//      otherwise); the skip layer is two GEMMs into the same z, [h | PE]
//      never built;
//   2. bn_sine_fwd, one CTA per (tile, 32 columns): the tile's mean, then
//      the two-pass biased variance mean((z - mu)^2) as _fwd_tile does,
//      per-tile statistics to scratch, and sin(gamma * zh + beta) cast to
//      the activation type (K0 or sinf).
// Sums over tiles go through per-tile scratch and a fixed-order reduction
// (sum_tiles), so every result is deterministic.  A reduction over the
// batch (dW) is split-K with an f32 workspace and a fixed-order reduce.
//
// What bounds the GEMMs (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s).  A
// forward layer at width 512 over 393,216 rows does 0.21 ms of operations
// and moves 0.36 ms of bytes, most of them its f32 z (805 MB): it is bound
// by its bytes, and so is an input gradient (f32 da, the same shape).  A
// weight gradient (512 x 512 over the 393,216 rows) reads two 402 MB
// operands and writes 1 MB: 0.24 ms of bytes against 0.21 ms of operations,
// nearly balanced.  gemm_wgmma keeps the tensor cores fed
// from a ring of TMA loads in flight, so that the operations hide under the
// bytes, and runs two CTAs an SM, so that one tile's f32 store overlaps the
// other's main loop.  What it leaves: the z round trips (each layer's f32 z
// to HBM and back for the tile statistics) and the BN passes, which only a
// design that keeps a tile on chip removes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_sin.cuh"
#include "hopper.cuh"

namespace tt {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr float kEps = 1e-5f;
constexpr int kSms = 132;
constexpr int kMaxSplits = 64;

// Layer table (int64, kFields per layer, built by the host wrapper,
// season_nerf_torch/ops/fused_train.py::_layer_table).
constexpr int kFields = 16;
enum Field {
  F_W = 0,      // packed weight, bf16 [K, N] row-major (omega folded in)
  F_B,          // bias, f32 [N]
  F_GAMMA,      // BN scale, f32 [N], 0 when the layer has no BN
  F_BETA,       // BN shift, f32 [N]
  F_K,          // input width (pe_dim, width[l-1], or width[l-1] + pe_dim)
  F_N,          // output width
  F_KIND,       // input: 0 = PE, 1 = h of layer l-1, 2 = [h of l-1 | PE]
  F_ACT,        // output activation, act dtype [rows, N]
  F_Z,          // f32 [rows, N]: z from the GEMM; zh when F_SAVE_ZH
  F_MU,         // f32 [n_tiles, N] per-tile mean (BN layers)
  F_VAR,        // f32 [n_tiles, N] per-tile biased variance
  F_SAVE_ZH,    // 1: overwrite z with the normalised zh (K2's residual)
  F_DW,         // K2: f32 [K, N] weight gradient
  F_DB,         // K2: f32 [N]
  F_DGAMMA,     // K2: f32 [N]
  F_DBETA,      // K2: f32 [N]
};

struct Trunk {
  const long long* layers;   // host table
  int n_layers;
  const bf16* pe;            // [rows, pe_dim] bf16
  int pe_dim, rows, tile, n_tiles;
  int act_bf16, fast_sine;
  cudaStream_t stream;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// --- GEMM: C[M, N] (+)= A(m, k) B(k, n) (+ bias[n]) ------------------------
// A(m, k) = A_KC ? A[m * lda + k] : A[k * lda + m]
// B(k, n) = B_KC ? B[n * ldb + k] : B[k * ldb + n]
struct Gemm {
  const void* A;
  long long lda;
  const void* B;
  long long ldb;
  float* C;
  long long ldc;
  const float* bias;
  int M, N, K;
  int accumulate;   // C = C_old + A.B (+ bias)
  int k_chunk;      // K range of one grid.z slice
  float* ws;        // split-K workspace [gridDim.z][M][N], or null
};

__device__ __forceinline__ void gemm_store(const Gemm& p, int r, int c,
                                           float v) {
  if (r >= p.M || c >= p.N) return;
  if (p.ws) {
    p.ws[((size_t)blockIdx.z * p.M + r) * p.N + c] = v;
    return;
  }
  float* o = p.C + (size_t)r * p.ldc + c;
  if (p.accumulate) v = *o + v;
  if (p.bias) v = v + p.bias[c];
  *o = v;
}

// Two adjacent columns (c, c + 1) of one row of gemm_wgmma's output,
// already C_old + A.B + bias: one 8-byte store where both lie in range and
// the address allows it.
__device__ __forceinline__ void gemm_store2(const Gemm& p, int r, int c,
                                            float v0, float v1) {
  if (r >= p.M || c >= p.N) return;
  const bool two = c + 1 < p.N;
  float* o = p.ws ? p.ws + ((size_t)blockIdx.z * p.M + r) * p.N + c
                  : p.C + (size_t)r * p.ldc + c;
  if (two && !(reinterpret_cast<uintptr_t>(o) & 7)) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (two) o[1] = v1;
  }
}

// --- bf16 x bf16 -> f32 on the tensor cores: TMA + wgmma --------------------
// One CTA per 128 x 128 output tile (blockIdx.x = tile, N tiles fastest, so
// that the CTAs in flight together share A's rows through L2; blockIdx.z =
// split of K), 288 threads:
//   warps 0-7, two consumer warpgroups, 64 rows x 128 columns each:
//     wgmma.m64n128k16 from shared memory into f32 registers;
//   warp 8, the producer: one thread issues the TMA loads.
// A ring of kStages stages of BK = 64 (A 16 KB + B 16 KB), each with a full
// and an empty mbarrier; TMA writes them with the 128-byte swizzle that the
// wgmma descriptors name.  Each operand keeps its layout in device memory
// and the wgmma transpose bit reads it as it lies:
//   K-major ([rows][K]: A of the forward and the input gradient, B = W of
//     the input gradient): one box of 64 K x 128 rows, 128-byte rows;
//   MN-major ([K][rows]: W of the forward, both operands of the weight
//     gradient): two boxes of 64 rows x 64 K, 64 K-rows of 128 bytes each.
// TMA fills what lies past M, N or K with zeros, so only the store masks.
// No setmaxnreg: ptxas gives the kernel 96 registers a thread with no
// spills (64 of them the accumulators), under the 112 that two CTAs an SM
// allow, and a consumer's setmaxnreg.inc above that would wait for ever on
// registers that the one producer warp cannot free (it hung on the card).
constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kOpBytes = 128 * kBK * 2;        // one operand of one stage
constexpr int kStageBytes = 2 * kOpBytes;
constexpr int kGemmThreads = 288;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;   // + 1 KB to align

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const Gemm p) {
  extern __shared__ uint8_t gemm_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];   // full, then empty
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.N + kBN - 1) / kBN;
  const int m0 = (int)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * kBN;
  const int kb = blockIdx.z * p.k_chunk;
  const int nk = (min(p.K, kb + p.k_chunk) - kb + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sa = base + s * kStageBytes, sb = sa + kOpBytes;
        const int k0 = kb + i * kBK;
        mbar_expect_tx(full, kStageBytes);
        if (A_KC) {
          tma_load(sa, &map_a, full, k0, m0);
        } else {
          tma_load(sa, &map_a, full, m0, k0);
          tma_load(sa + kOpBytes / 2, &map_a, full, m0 + 64, k0);
        }
        if (B_KC) {
          tma_load(sb, &map_b, full, k0, n0);
        } else {
          tma_load(sb, &map_b, full, n0, k0);
          tma_load(sb + kOpBytes / 2, &map_b, full, n0 + 64, k0);
        }
      }
    }
  } else {
    const int wg = warp >> 2;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      // this warpgroup's 64 rows of A: rows wg*64.. (K-major) or the wg-th
      // 64-row box (MN-major), 8 KB in either case
      const uint32_t sa = base + s * kStageBytes + wg * (kOpBytes / 2);
      const uint32_t sb = base + s * kStageBytes + kOpBytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a step of 16 K: 32 bytes along a K-major row, 16 rows of 128
        // bytes down an MN-major box
        const uint64_t da = A_KC ? wgmma_desc(sa + kk * 32, 16, 1024)
                                 : wgmma_desc(sa + kk * 2048, 8192, 1024);
        const uint64_t db = B_KC ? wgmma_desc(sb + kk * 32, 16, 1024)
                                 : wgmma_desc(sb + kk * 2048, 8192, 1024);
        wgmma_bf16<A_KC ? 0 : 1, B_KC ? 0 : 1>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: free its buffers
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // accumulator i of 64: row (lane / 4) + 8 ((i / 2) % 2) of the warp's
    // 16, column 8 (i / 4) + 2 (lane % 4) + i % 2
    const int r = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c = n0 + 2 * (lane & 3);
    if (!p.ws && (p.accumulate || p.bias)) {
      // gemm_store's C_old + v + bias, every load before the first store, so
      // that the loads overlap instead of each waiting behind a store
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int rr = r + 8 * ((i >> 1) & 1), cc = c + 8 * (i >> 2) + (i & 1);
        if (rr < p.M && cc < p.N) {
          if (p.accumulate) acc[i] = p.C[(size_t)rr * p.ldc + cc] + acc[i];
          if (p.bias) acc[i] = acc[i] + p.bias[cc];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      gemm_store2(p, r, c + 8 * j, acc[4 * j], acc[4 * j + 1]);
      gemm_store2(p, r + 8, c + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// The shared-memory limit is set on every launch, not once behind a
// function-local static: such a static is one symbol for the whole process,
// so K2's library would skip setting it on its own copy of the kernel once
// K1's had.
template <bool A_KC, bool B_KC>
cudaError_t launch_gemm_wgmma(const CUtensorMap& ma, const CUtensorMap& mb,
                              const Gemm& p, dim3 grid, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      (const void*)gemm_wgmma<A_KC, B_KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return attr;
  gemm_wgmma<A_KC, B_KC><<<grid, kGemmThreads, kGemmSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

// Any operand types, f32 FFMA: 64 x 64 tile per CTA, 4 x 4 outputs per
// thread (rows ty + 16 i, columns tx + 16 j), K steps of 16.  Products of
// bf16 values are exact in f32, so this is the f32 matmul of the JAX
// package's f32 mode (TF32 is never used).
template <typename TA, typename TB, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(256) gemm_f32(const Gemm p) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float sA[BK][BM + 4];
  __shared__ float sB[BK][BN + 4];
  const TA* A = static_cast<const TA*>(p.A);
  const TB* B = static_cast<const TB*>(p.B);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * p.k_chunk;
  const int ke = min(p.K, kb + p.k_chunk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = A_KC ? i / BK : i % BM;
      const int c = A_KC ? i % BK : i / BM;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < p.M && gk < ke)
        v = A_KC ? ld(A, (size_t)gm * p.lda + gk)
                 : ld(A, (size_t)gk * p.lda + gm);
      sA[c][r] = v;
    }
    for (int i = tid; i < BN * BK; i += 256) {
      const int n = B_KC ? i / BK : i % BN;
      const int c = B_KC ? i % BK : i / BN;
      const int gn = n0 + n, gk = k0 + c;
      float v = 0.f;
      if (gn < p.N && gk < ke)
        v = B_KC ? ld(B, (size_t)gn * p.ldb + gk)
                 : ld(B, (size_t)gk * p.ldb + gn);
      sB[c][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gemm_store(p, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

// C = (accumulate ? C : 0) + sum over the splits, in split order (+ bias).
__global__ void splitk_reduce(const float* ws, int splits, float* C,
                              long long ldc, const float* bias, int M, int N,
                              int accumulate) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + i];
    const int r = (int)(i / N), c = (int)(i % N);
    float* o = C + (size_t)r * ldc + c;
    if (accumulate) s = *o + s;
    if (bias) s = s + bias[c];
    *o = s;
  }
}

template <bool A_KC, bool B_KC>
void launch_gemm_f32(const Gemm& p, int a_bf16, int b_bf16, dim3 grid,
                     cudaStream_t s) {
  if (a_bf16 && b_bf16)
    gemm_f32<bf16, bf16, A_KC, B_KC><<<grid, 256, 0, s>>>(p);
  else if (a_bf16)
    gemm_f32<bf16, float, A_KC, B_KC><<<grid, 256, 0, s>>>(p);
  else if (b_bf16)
    gemm_f32<float, bf16, A_KC, B_KC><<<grid, 256, 0, s>>>(p);
  else
    gemm_f32<float, float, A_KC, B_KC><<<grid, 256, 0, s>>>(p);
}

// The one GEMM entry.  Layouts used: (A_KC, !B_KC) forward, (A_KC, B_KC)
// the input gradient h . W^T, (!A_KC, !B_KC) the weight gradient A^T . B.
// bf16 x bf16 goes to gemm_wgmma (lda and ldb multiples of 8, 16-byte
// aligned operands, or cudaErrorInvalidValue), any other pair to gemm_f32.
// `split`: split K over CTAs (a reduction over the batch) through `ws`;
// the split depends on the shape alone, so equal calls give equal bits.
inline cudaError_t gemm(const void* A, int a_bf16, bool a_kc, long long lda,
                        const void* B, int b_bf16, bool b_kc, long long ldb,
                        float* C, long long ldc, const float* bias, int M,
                        int N, int K, int accumulate, bool split, float* ws,
                        long long ws_floats, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (!a_kc && b_kc) return cudaErrorInvalidValue;
  const bool mma = a_bf16 && b_bf16;
  const int BM = mma ? kBM : 64, BN = mma ? kBN : 64, BK = mma ? kBK : 16;
  const long long m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  Gemm p;
  p.A = A; p.lda = lda; p.B = B; p.ldb = ldb; p.C = C; p.ldc = ldc;
  p.bias = bias; p.M = M; p.N = N; p.K = K; p.accumulate = accumulate;
  p.k_chunk = K; p.ws = nullptr;
  int splits = 1;
  if (split && ws) {
    // enough CTAs for every SM: gemm_wgmma runs two an SM, gemm_f32 four
    const long long tiles = m_tiles * n_tiles;
    long long want = ((mma ? 2LL : 4LL) * kSms + tiles - 1) / tiles;
    want = want < 1 ? 1 : (want > kMaxSplits ? kMaxSplits : want);
    const long long kblocks = (K + BK - 1) / BK;
    if (want > kblocks) want = kblocks;
    while (want > 1 && want * M * N > ws_floats) --want;
    const long long chunk = ((K + want - 1) / want + BK - 1) / BK * BK;
    p.k_chunk = (int)chunk;
    splits = (int)((K + chunk - 1) / chunk);
  }
  if (splits > 1) p.ws = ws;
  cudaError_t err;
  if (mma) {
    // A: [M][K] (K-major) or [K][M]; B: [N][K] (K-major) or [K][N]
    CUtensorMap ma, mb;
    if (!(a_kc ? bf16_map(&ma, A, K, M, lda, kBM)
               : bf16_map(&ma, A, M, K, lda, kBK)) ||
        !(b_kc ? bf16_map(&mb, B, K, N, ldb, kBN)
               : bf16_map(&mb, B, N, K, ldb, kBK)))
      return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(m_tiles * n_tiles), 1, splits);
    if (a_kc && !b_kc) err = launch_gemm_wgmma<true, false>(ma, mb, p, grid, s);
    else if (a_kc) err = launch_gemm_wgmma<true, true>(ma, mb, p, grid, s);
    else err = launch_gemm_wgmma<false, false>(ma, mb, p, grid, s);
  } else {
    const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, splits);
    if (a_kc && !b_kc) launch_gemm_f32<true, false>(p, a_bf16, b_bf16, grid, s);
    else if (a_kc) launch_gemm_f32<true, true>(p, a_bf16, b_bf16, grid, s);
    else launch_gemm_f32<false, false>(p, a_bf16, b_bf16, grid, s);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
    splitk_reduce<<<blocks, 256, 0, s>>>(ws, splits, C, ldc, bias, M, N,
                                         accumulate);
    err = cudaGetLastError();
  }
  return err;
}

// --- ghost BatchNorm + sine, forward ----------------------------------------
// grid (n_tiles, ceil(W / 32)), 256 threads = 32 columns x 8 row groups.
// Without BN (gamma == null): h = sin(z).
template <typename TO>
__global__ void __launch_bounds__(256) bn_sine_fwd(
    float* z, TO* out, int W, int tile, const float* gamma,
    const float* beta, float* tile_mu, float* tile_var, int save_zh,
    int fast) {
  __shared__ float red[8][33];
  __shared__ float stat[32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + tx;
  const int T = blockIdx.x;
  const size_t r0 = (size_t)T * tile;
  const bool ok = c < W;
  const bool bn = gamma != nullptr;
  float mu = 0.f, rs = 1.f, g = 1.f, b = 0.f;
  if (bn) {
    float s = 0.f;
    if (ok)
      for (int r = ty; r < tile; r += 8) s += z[(r0 + r) * W + c];
    red[ty][tx] = s;
    __syncthreads();
    if (ty == 0) {
      float a = 0.f;
      for (int j = 0; j < 8; ++j) a += red[j][tx];
      stat[tx] = a / (float)tile;
    }
    __syncthreads();
    mu = stat[tx];
    s = 0.f;
    if (ok)
      for (int r = ty; r < tile; r += 8) {
        const float d = z[(r0 + r) * W + c] - mu;
        s += d * d;
      }
    red[ty][tx] = s;
    __syncthreads();
    if (ty == 0) {
      float a = 0.f;
      for (int j = 0; j < 8; ++j) a += red[j][tx];
      const float var = a / (float)tile;
      if (ok) {
        tile_mu[(size_t)T * W + c] = mu;
        tile_var[(size_t)T * W + c] = var;
      }
      stat[tx] = var;
    }
    __syncthreads();
    rs = rsqrtf(stat[tx] + kEps);
    if (ok) {
      g = gamma[c];
      b = beta[c];
    }
  }
  if (!ok) return;
  for (int r = ty; r < tile; r += 8) {
    const size_t i = (r0 + r) * W + c;
    const float v = z[i];
    float y = v;
    if (bn) {
      const float zh = (v - mu) * rs;
      if (save_zh) z[i] = zh;
      y = g * zh + b;
    }
    st(out, i, fast ? fast_sin(y) : sinf(y));
  }
}

// sum over tiles in tile order: out[c] = sum_t part[t][c] for c < W, and 0
// for W <= c < out_w (the zero padding of the stats rows)
__global__ void sum_tiles(const float* part, int n_tiles, int W, float* out,
                          int out_w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= out_w) return;
  float s = 0.f;
  if (c < W)
    for (int t = 0; t < n_tiles; ++t) s += part[(size_t)t * W + c];
  out[c] = s;
}

inline cudaError_t launch_sum_tiles(const float* part, int n_tiles, int W,
                                    float* out, int out_w, cudaStream_t s) {
  sum_tiles<<<(out_w + 255) / 256, 256, 0, s>>>(part, n_tiles, W, out,
                                                 out_w);
  return cudaGetLastError();
}

// --- ghost BatchNorm + sine, backward ---------------------------------------
// The math of pallas_train.py::_bwd_kernel for one layer and one tile, one
// CTA per (tile, 32 columns) as bn_sine_fwd.  In: zh (the normalised
// pre-activation K2's recompute kept, or z for a layer without BN), da =
// dL/d(activation) in f32, the tile's biased variance.  Out: dz in the
// gradient type, and per tile the sums of dy * zh (d_gamma), dy (d_beta)
// and dz (d_b).
//   dy  = da * cos(y),  y = gamma * zh + beta
//   dzh = dy * gamma,   m1 = mean(dzh),  m2 = mean(dzh * zh)
//   dz  = rsqrt(var + eps) * (dzh - m1 - zh * m2)
template <typename TG>
__global__ void __launch_bounds__(256) bn_sine_bwd(
    const float* zh, const float* da, int W, int tile, const float* gamma,
    const float* beta, const float* tile_var, TG* dz, float* part_dgamma,
    float* part_dbeta, float* part_db, int fast) {
  __shared__ float red[3][8][33];
  __shared__ float stat[3][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + tx;
  const int T = blockIdx.x;
  const size_t r0 = (size_t)T * tile;
  const bool ok = c < W;
  const bool bn = gamma != nullptr;
  float g = 1.f, b = 0.f, rs = 1.f, m1 = 0.f, m2 = 0.f;
  if (bn) {
    float s_dy = 0.f, s_dyzh = 0.f, s_m1 = 0.f, s_m2 = 0.f;
    if (ok) {
      g = gamma[c];
      b = beta[c];
      for (int r = ty; r < tile; r += 8) {
        const size_t i = (r0 + r) * W + c;
        const float v = zh[i];
        const float y = g * v + b;
        const float dy = da[i] * (fast ? fast_cos(y) : cosf(y));
        const float dzh = dy * g;
        s_dy += dy;
        s_dyzh += dy * v;
        s_m1 += dzh;
        s_m2 += dzh * v;
      }
    }
    red[0][ty][tx] = s_dyzh;
    red[1][ty][tx] = s_dy;
    red[2][ty][tx] = s_m1;
    __syncthreads();
    if (ty == 0) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int j = 0; j < 8; ++j) {
        a0 += red[0][j][tx];
        a1 += red[1][j][tx];
        a2 += red[2][j][tx];
      }
      if (ok) {
        part_dgamma[(size_t)T * W + c] = a0;
        part_dbeta[(size_t)T * W + c] = a1;
      }
      stat[0][tx] = a2 / (float)tile;
    }
    __syncthreads();
    red[0][ty][tx] = s_m2;
    __syncthreads();
    if (ty == 0) {
      float a = 0.f;
      for (int j = 0; j < 8; ++j) a += red[0][j][tx];
      stat[1][tx] = a / (float)tile;
    }
    __syncthreads();
    m1 = stat[0][tx];
    m2 = stat[1][tx];
    if (ok) rs = rsqrtf(tile_var[(size_t)T * W + c] + kEps);
  }
  float s_db = 0.f;
  if (ok)
    for (int r = ty; r < tile; r += 8) {
      const size_t i = (r0 + r) * W + c;
      const float v = zh[i];
      float d;
      if (bn) {
        const float y = g * v + b;
        const float dzh = da[i] * (fast ? fast_cos(y) : cosf(y)) * g;
        d = rs * (dzh - m1 - v * m2);
      } else {
        d = da[i] * (fast ? fast_cos(v) : cosf(v));
      }
      s_db += d;
      st(dz, i, d);
    }
  __syncthreads();
  red[2][ty][tx] = s_db;
  __syncthreads();
  if (ty == 0 && ok) {
    float a = 0.f;
    for (int j = 0; j < 8; ++j) a += red[2][j][tx];
    part_db[(size_t)T * W + c] = a;
  }
}

// per tile, the sum over its rows of each column of x [rows, W] f32
__global__ void __launch_bounds__(256) col_sum_tiles(const float* x, int W,
                                                     int tile, float* part) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + tx;
  const size_t r0 = (size_t)blockIdx.x * tile;
  float s = 0.f;
  if (c < W)
    for (int r = ty; r < tile; r += 8) s += x[(r0 + r) * W + c];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < W) {
    float a = 0.f;
    for (int j = 0; j < 8; ++j) a += red[j][tx];
    part[(size_t)blockIdx.x * W + c] = a;
  }
}

// out = float(in) (in bf16 or f32), or out = bf16(in) for f32 in
template <typename TI, typename TO>
__global__ void convert(const TI* in, TO* out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    st(out, i, ld(in, i));
}

template <typename TI, typename TO>
inline cudaError_t launch_convert(const TI* in, TO* out, size_t n,
                                  cudaStream_t s) {
  const size_t blocks = (n + 255) / 256;
  convert<TI, TO><<<(int)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      in, out, n);
  return cudaGetLastError();
}

// ---- the forward over all layers (K1's body; K2 recomputes with it) --------
inline long long fld(const Trunk& tr, int l, int f) {
  return tr.layers[(size_t)l * kFields + f];
}

template <typename T>
inline T* ptr(const Trunk& tr, int l, int f) {
  return reinterpret_cast<T*>(fld(tr, l, f));
}

inline cudaError_t bn_fwd(const Trunk& tr, int l) {
  const int W = (int)fld(tr, l, F_N);
  const dim3 grid(tr.n_tiles, (W + 31) / 32);
  float* z = ptr<float>(tr, l, F_Z);
  const float* gamma = ptr<const float>(tr, l, F_GAMMA);
  const float* beta = ptr<const float>(tr, l, F_BETA);
  float* mu = ptr<float>(tr, l, F_MU);
  float* var = ptr<float>(tr, l, F_VAR);
  const int save = (int)fld(tr, l, F_SAVE_ZH);
  if (tr.act_bf16)
    bn_sine_fwd<bf16><<<grid, 256, 0, tr.stream>>>(
        z, ptr<bf16>(tr, l, F_ACT), W, tr.tile, gamma, beta, mu, var, save,
        tr.fast_sine);
  else
    bn_sine_fwd<float><<<grid, 256, 0, tr.stream>>>(
        z, ptr<float>(tr, l, F_ACT), W, tr.tile, gamma, beta, mu, var, save,
        tr.fast_sine);
  return cudaGetLastError();
}

// Every layer: z = input . W + b (two GEMMs for [h | PE]), then the ghost
// BN and sine.
inline cudaError_t run_forward(const Trunk& tr) {
  cudaError_t err = cudaSuccess;
  for (int l = 0; l < tr.n_layers && err == cudaSuccess; ++l) {
    const int K = (int)fld(tr, l, F_K), N = (int)fld(tr, l, F_N);
    const int kind = (int)fld(tr, l, F_KIND);
    const bf16* W = ptr<const bf16>(tr, l, F_W);
    const float* b = ptr<const float>(tr, l, F_B);
    float* z = ptr<float>(tr, l, F_Z);
    if (kind == 0) {
      err = gemm(tr.pe, 1, true, tr.pe_dim, W, 1, false, N, z, N, b, tr.rows,
                 N, tr.pe_dim, 0, false, nullptr, 0, tr.stream);
    } else {
      const void* h = reinterpret_cast<const void*>(fld(tr, l - 1, F_ACT));
      const int lw = (int)fld(tr, l - 1, F_N);
      err = gemm(h, tr.act_bf16, true, lw, W, 1, false, N, z, N,
                 kind == 2 ? nullptr : b, tr.rows, N, lw, 0, false, nullptr,
                 0, tr.stream);
      if (err == cudaSuccess && kind == 2)
        err = gemm(tr.pe, 1, true, tr.pe_dim, W + (size_t)lw * N, 1, false,
                   N, z, N, b, tr.rows, N, K - lw, 1, false, nullptr, 0,
                   tr.stream);
    }
    if (err == cudaSuccess) err = bn_fwd(tr, l);
  }
  return err;
}

inline bool valid_trunk(const Trunk& tr) {
  if (tr.n_layers < 1 || tr.rows < 1 || tr.tile < 1 ||
      tr.rows % tr.tile != 0 || tr.pe_dim < 1)
    return false;
  for (int l = 0; l < tr.n_layers; ++l) {
    const int kind = (int)fld(tr, l, F_KIND);
    const long long K = fld(tr, l, F_K);
    if (fld(tr, l, F_N) < 1 || (l == 0) != (kind == 0)) return false;
    if (kind == 0 && K != tr.pe_dim) return false;
    if (kind == 1 && K != fld(tr, l - 1, F_N)) return false;
    if (kind == 2 && K != fld(tr, l - 1, F_N) + tr.pe_dim) return false;
  }
  return true;
}

}  // namespace tt
