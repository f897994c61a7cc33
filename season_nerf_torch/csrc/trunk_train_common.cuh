// Device code shared by K1 (trunk_train_fwd.cu) and K2 (trunk_train_bwd.cu):
// the training trunk of T-NeRF with ghost BatchNorm, layer-major.
//
// The TPU kernels (season_nerf_tpu/ops/pallas_train.py) keep every weight
// and a whole 2048-row tile in VMEM.  A 2048 x 512 tile is 2 MB and an SM
// has 227 KB, and the ghost statistics need every row of the tile's z
// before any row can be normalised.  So the Hopper version runs the trunk
// one layer at a time over the whole batch:
//   1. a GEMM writes z = h . W + b in f32 to scratch (gemm_mma: mma.sync
//      bf16 -> f32 when both operands are bf16; gemm_f32: FFMA otherwise);
//      the skip layer is two GEMMs into the same z, [h | PE] never built;
//   2. bn_sine_fwd, one CTA per (tile, 32 columns): the tile's mean, then
//      the two-pass biased variance mean((z - mu)^2) as _fwd_tile does,
//      per-tile statistics to scratch, and sin(gamma * zh + beta) cast to
//      the activation type (K0 or sinf).
// Sums over tiles go through per-tile scratch and a fixed-order reduction
// (sum_tiles), so every result is deterministic.  A reduction over the
// batch (dW) is split-K with an f32 workspace and a fixed-order reduce.
// wgmma, TMA and clusters that keep a tile on chip are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_sin.cuh"

namespace tt {

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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 x bf16 -> f32 on the tensor cores: 128 x 128 tile per CTA, 8 warps
// of 64 x 32, K steps of 32 through shared memory ([m][k] and [n][k], so
// that both mma fragments are 32-bit loads).  Out-of-range rows, columns
// and K are zero-filled.
template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(256) gemm_mma(const Gemm p) {
  constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8;
  __shared__ __align__(16) bf16 sA[BM * LDS];
  __shared__ __align__(16) bf16 sB[BN * LDS];
  const bf16* A = static_cast<const bf16*>(p.A);
  const bf16* B = static_cast<const bf16*>(p.B);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * p.k_chunk;
  const int ke = min(p.K, kb + p.k_chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const bf16 zero = __float2bfloat16(0.f);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = A_KC ? i / BK : i % BM;
      const int c = A_KC ? i % BK : i / BM;
      const int gm = m0 + r, gk = k0 + c;
      bf16 v = zero;
      if (gm < p.M && gk < ke)
        v = A_KC ? A[(size_t)gm * p.lda + gk] : A[(size_t)gk * p.lda + gm];
      sA[r * LDS + c] = v;
    }
    for (int i = tid; i < BN * BK; i += 256) {
      const int n = B_KC ? i / BK : i % BN;
      const int c = B_KC ? i % BK : i / BN;
      const int gn = n0 + n, gk = k0 + c;
      bf16 v = zero;
      if (gn < p.N && gk < ke)
        v = B_KC ? B[(size_t)gn * p.ldb + gk] : B[(size_t)gk * p.ldb + gn];
      sB[n * LDS + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* s = sA + (wm + mt * 16 + g) * LDS + kk + 2 * t;
        a[mt][0] = lds32(s);
        a[mt][1] = lds32(s + 8 * LDS);
        a[mt][2] = lds32(s + 8);
        a[mt][3] = lds32(s + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* s = sB + (wn + nt * 8 + g) * LDS + kk + 2 * t;
        const uint32_t b0 = lds32(s), b1 = lds32(s + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        const int c = n0 + wn + nt * 8 + 2 * t;
        gemm_store(p, r, c, acc[mt][nt][2 * half]);
        gemm_store(p, r, c + 1, acc[mt][nt][2 * half + 1]);
      }
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
// `split`: split K over CTAs (a reduction over the batch) through `ws`.
inline cudaError_t gemm(const void* A, int a_bf16, bool a_kc, long long lda,
                        const void* B, int b_bf16, bool b_kc, long long ldb,
                        float* C, long long ldc, const float* bias, int M,
                        int N, int K, int accumulate, bool split, float* ws,
                        long long ws_floats, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const bool mma = a_bf16 && b_bf16;
  const int BM = mma ? 128 : 64, BN = mma ? 128 : 64, BK = mma ? 32 : 16;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, 1);
  Gemm p;
  p.A = A; p.lda = lda; p.B = B; p.ldb = ldb; p.C = C; p.ldc = ldc;
  p.bias = bias; p.M = M; p.N = N; p.K = K; p.accumulate = accumulate;
  p.k_chunk = K; p.ws = nullptr;
  int splits = 1;
  if (split && ws) {
    const long long tiles = (long long)grid.x * grid.y;
    long long want = (4LL * kSms + tiles - 1) / tiles;
    want = want < 1 ? 1 : (want > kMaxSplits ? kMaxSplits : want);
    const long long kblocks = (K + BK - 1) / BK;
    if (want > kblocks) want = kblocks;
    while (want > 1 && want * M * N > ws_floats) --want;
    const long long chunk = ((K + want - 1) / want + BK - 1) / BK * BK;
    p.k_chunk = (int)chunk;
    splits = (int)((K + chunk - 1) / chunk);
  }
  grid.z = splits;
  if (splits > 1) p.ws = ws;
  if (mma) {
    if (a_kc && !b_kc) gemm_mma<true, false><<<grid, 256, 0, s>>>(p);
    else if (a_kc && b_kc) gemm_mma<true, true><<<grid, 256, 0, s>>>(p);
    else if (!a_kc && !b_kc) gemm_mma<false, false><<<grid, 256, 0, s>>>(p);
    else return cudaErrorInvalidValue;
  } else {
    if (a_kc && !b_kc) launch_gemm_f32<true, false>(p, a_bf16, b_bf16, grid, s);
    else if (a_kc && b_kc) launch_gemm_f32<true, true>(p, a_bf16, b_bf16, grid, s);
    else if (!a_kc && !b_kc) launch_gemm_f32<false, false>(p, a_bf16, b_bf16, grid, s);
    else return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
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
