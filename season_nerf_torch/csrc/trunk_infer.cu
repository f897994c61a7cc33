// K3: the inference trunk of T-NeRF, fc1 .. fcN + fc9, fused in one kernel.
//
// Replaces season_nerf_tpu/ops/pallas_mlp.py::_trunk_kernel (trunk_apply).
// Each layer computes sin(h . W' + b') with omega and the BatchNorm running
// statistics folded into W' and b' on the host (ops/fused_trunk.py
// fold_trunk).  The input of every layer is cast to W's type (the f32 PE
// too, at fc1 and in the skip layer's [h | PE]); products accumulate in
// f32, b' is added in f32, then sin (sinf, or K0 fast_sin); the last layer
// writes f32.  The plain version is fused_trunk.trunk_apply_reference.
//
// Bound (H100 SXM): compute.  At width 512 a point costs 2.03 M multiply-
// adds and reads 256 B of PE and writes 1 KB of x_enc, so a 491,520-point
// render chunk is 2.0 TFLOP against 0.63 GB: 2.0 ms at 989 TFLOP/s bf16
// (30 ms at 67 TFLOP/s f32) against 0.19 ms at 3.35 TB/s.
//
// Design (simple first): one CTA of 256 threads per row tile.  The tile's
// activations never leave shared memory: buffer A holds [h | PE] so that
// the skip layer reads its concatenation in place, buffer B holds h, and
// the layers ping-pong between them (the plan comes from the host).  The
// folded weights, [n, k] row-major (about 4 MB in bf16 at width 512),
// stream from global memory and stay resident in the 50 MB L2.
//  - bf16: 64-row tiles; mma.sync m16n8k16 bf16 -> f32; each warp owns
//    32-column strips of the output (4 x 4 mma tiles of 16 x 8).
//  - f32: 32-row tiles; plain FFMA in full f32 (the reference's f32 path
//    is not TF32); each thread owns 4 rows x 8 columns.
// Rows past the end of the input are computed on zeros and never stored.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_sin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsBf16 = 64;
constexpr int kRowsF32 = 32;
constexpr int kPadBf16 = 8;   // row padding in elements: conflict-free reads
constexpr int kPadF32 = 4;
constexpr int kTableStride = 8;   // int64 fields per layer in the table
constexpr int kMaxSmem = 232448;

// Layer table (int64, kTableStride per layer, built by the host):
//   [0] W' pointer, [n, k] row-major     [1] b' pointer, [n] f32
//   [2] k   [3] n   (both padded: k % 16 == 0, n % 32 == 0)
//   [4] input buffer (0 = A, 1 = B)  [5] input column offset
//   [6] output buffer (0 = A, 1 = B; unused by the last layer)
struct Params {
  const long long* table;
  int n_layers;
  const float* pe;   // [rows, pe_cols] f32
  float* out;        // [rows, out_cols] f32
  int rows, pe_cols, out_cols;
  int a_cols, b_cols;   // widths of buffers A ([h | PE]) and B (h)
  int fast_sine;
};

__device__ __forceinline__ float activate(float z, int fast) {
  return fast ? fast_sin(z) : sinf(z);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1) trunk_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = p.a_cols + kPadBf16, ldb = p.b_cols + kPadBf16;
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf_b = buf_a + kRowsBf16 * lda;
  const int row0 = blockIdx.x * kRowsBf16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread-in-group

  const int pe_off = p.a_cols - p.pe_cols;
  for (int i = tid; i < kRowsBf16 * p.pe_cols; i += kThreads) {
    const int r = i / p.pe_cols, c = i % p.pe_cols;
    const float v = (row0 + r < p.rows)
        ? p.pe[(size_t)(row0 + r) * p.pe_cols + c] : 0.f;
    buf_a[r * lda + pe_off + c] = __float2bfloat16(v);
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const long long* T = p.table + kTableStride * l;
    const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(T[0]);
    const float* bias = reinterpret_cast<const float*>(T[1]);
    const int K = (int)T[2], N = (int)T[3];
    const __nv_bfloat16* in = (T[4] ? buf_b : buf_a) + T[5];
    const int ldi = T[4] ? ldb : lda;
    __nv_bfloat16* dst = T[6] ? buf_b : buf_a;
    const int ldo = T[6] ? ldb : lda;
    const bool last = (l == p.n_layers - 1);

    for (int nb = warp * 32; nb < N; nb += 8 * 32) {
      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* s = in + (mt * 16 + g) * ldi + k0 + 2 * t;
          a[mt][0] = lds32(s);
          a[mt][1] = lds32(s + 8 * ldi);
          a[mt][2] = lds32(s + 8);
          a[mt][3] = lds32(s + 8 * ldi + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* w = W + (size_t)(nb + nt * 8 + g) * K + k0
                                   + 2 * t;
          const uint32_t b0 = ldg32(w), b1 = ldg32(w + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }

#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = nb + nt * 8 + 2 * t;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + g + 8 * half;
            const float v0 = activate(acc[mt][nt][2 * half] + b0, p.fast_sine);
            const float v1 = activate(acc[mt][nt][2 * half + 1] + b1,
                                      p.fast_sine);
            if (last) {
              const int gr = row0 + r;
              if (gr < p.rows) {
                float* o = p.out + (size_t)gr * p.out_cols;
                if (col < p.out_cols) o[col] = v0;
                if (col + 1 < p.out_cols) o[col + 1] = v1;
              }
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dst + r * ldo + col) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) trunk_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = p.a_cols + kPadF32, ldb = p.b_cols + kPadF32;
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + kRowsF32 * lda;
  const int row0 = blockIdx.x * kRowsF32;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;

  const int pe_off = p.a_cols - p.pe_cols;
  for (int i = tid; i < kRowsF32 * p.pe_cols; i += kThreads) {
    const int r = i / p.pe_cols, c = i % p.pe_cols;
    buf_a[r * lda + pe_off + c] = (row0 + r < p.rows)
        ? p.pe[(size_t)(row0 + r) * p.pe_cols + c] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const long long* T = p.table + kTableStride * l;
    const float* W = reinterpret_cast<const float*>(T[0]);
    const float* bias = reinterpret_cast<const float*>(T[1]);
    const int K = (int)T[2], N = (int)T[3];
    const float* in = (T[4] ? buf_b : buf_a) + T[5];
    const int ldi = T[4] ? ldb : lda;
    float* dst = T[6] ? buf_b : buf_a;
    const int ldo = T[6] ? ldb : lda;
    const bool last = (l == p.n_layers - 1);

    // thread (ty, tx): rows 4*ty .. 4*ty+3, columns nb + tx + 32*j
    for (int nb = 0; nb < N; nb += 8 * 32) {
      const int nj = min(8, (N - nb) / 32);   // warp-uniform
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(in + (4 * ty + i) * ldi
                                                  + k0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nj) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(
                W + (size_t)(nb + tx + 32 * j) * K + k0));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] = fmaf(a[i].x, w.x, acc[i][j]);
              acc[i][j] = fmaf(a[i].y, w.y, acc[i][j]);
              acc[i][j] = fmaf(a[i].z, w.z, acc[i][j]);
              acc[i][j] = fmaf(a[i].w, w.w, acc[i][j]);
            }
          }
        }
      }

#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) continue;
        const int col = nb + tx + 32 * j;
        const float b = bias[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * ty + i;
          const float v = activate(acc[i][j] + b, p.fast_sine);
          if (last) {
            const int gr = row0 + r;
            if (gr < p.rows && col < p.out_cols)
              p.out[(size_t)gr * p.out_cols + col] = v;
          } else {
            dst[r * ldo + col] = v;
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA; > kMaxSmem means the widths are too
// large for this kernel.
size_t trunk_infer_smem_bytes(int a_cols, int b_cols, int is_bf16) {
  return is_bf16
      ? (size_t)kRowsBf16 * (a_cols + kPadBf16 + b_cols + kPadBf16) * 2
      : (size_t)kRowsF32 * (a_cols + kPadF32 + b_cols + kPadF32) * 4;
}

const char* trunk_infer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int trunk_infer_launch(const long long* table, int n_layers,
                       const float* pe, float* out, int rows, int pe_cols,
                       int out_cols, int a_cols, int b_cols, int is_bf16,
                       int fast_sine, void* stream) {
  const size_t smem = trunk_infer_smem_bytes(a_cols, b_cols, is_bf16);
  if (n_layers < 1 || rows < 1 || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.table = table;
  p.n_layers = n_layers;
  p.pe = pe;
  p.out = out;
  p.rows = rows;
  p.pe_cols = pe_cols;
  p.out_cols = out_cols;
  p.a_cols = a_cols;
  p.b_cols = b_cols;
  p.fast_sine = fast_sine;
  const int tile = is_bf16 ? kRowsBf16 : kRowsF32;
  const dim3 grid((rows + tile - 1) / tile);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(trunk_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    trunk_bf16<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(trunk_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    trunk_f32<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
