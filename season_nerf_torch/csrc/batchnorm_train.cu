// The full-batch BatchNorm of a training SineLayer in bf16, around the
// sine's folded launches of csrc/fast_sine.cu (ops/batchnorm_train.py):
//
//   forward   bn_stats_launch: one row-tiled pass over z (bf16) that writes
//             the float32 z the sine reads and each block's column sums of
//             z and z^2 (columns.cuh), then the merge, which finishes each
//             column: mean, the fast variance max(0, E[z^2] - E[z]^2),
//             rstd, mul = rstd * scale, and the running statistics (flax's
//             momentum, the biased variance).  Under a mesh the merge
//             writes the sums instead (double), the caller all-reduces
//             them, and bn_finish_launch finishes.
//   backward  bn_dz_launch: after the sine's folded backward (du, and the
//             column sums a = sum du, b = sum du * xhat), one elementwise
//             pass dz = mul * (du - a / N - xhat * b / N) in bf16, the
//             variance's term dropped in a column whose variance was
//             clamped (the gradient of the clamp).
//
// No TPU kernel: the JAX package leaves the full-batch BatchNorm of its
// SIREN layers to XLA's fusion (its K1/K2 normalise ghost batches).  Bound:
// device-memory bytes.  The column sums read z (2 B an element) and write
// the float32 z (4 B); dz reads z and du (4 + 4 B) and writes dz (2 B).
// Before: some ten float32 passes each way (two means, the square, the
// difference, the product and the sum forward; autograd's replay of them
// backward).  The sums are the same from run to run: no float atomics, the
// partial rows merged in a fixed order in double.  dz is stored with
// __float2bfloat16_rn, the rounding of torch's cast of the float32 z's
// gradient to bf16.
//
// stats is float32 [5][C]: mean, rstd, mul, rstd where the variance was not
// clamped (0 where it was), and 1 / N, N the global batch's rows.  Any C:
// where it is a multiple of 8 (every pointer then 16-byte aligned) each
// thread takes 8 consecutive columns with vector loads, else one column
// with scalar loads (columns.cuh).  The plain C interface (ctypes), each
// launch returning a cudaError_t: bn_stats_blocks, bn_stats_launch,
// bn_finish_launch, bn_dz_launch, batchnorm_train_error_string.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "columns.cuh"

namespace {

using cols::kThreads;
using cols::kVec;
using cols::load;
using cols::store;

// z (bf16) -> the float32 z, and each block's column sums of z and z^2;
// four rows a lane in flight.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_column_sums(const __nv_bfloat16* __restrict__ z,
                   float* __restrict__ zf, float* __restrict__ part,
                   int64_t rows, int C) {
  __shared__ cols::Partial<V> sh;
  const cols::Tile t = cols::tile<V>(C, rows);
  float s[V] = {}, q[V] = {};
  if (t.lane < t.lanes) {
    const int c = t.c0 + t.group * V;
    const int64_t step = t.stride * C;
    auto add = [&](const float (&v)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    };
    int64_t row = t.row0;
    for (; row + 3 * t.stride < t.row1; row += 4 * t.stride) {
      const int64_t o = row * C + c;
      float v[4][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) load<V>(z + o + k * step, v[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        store<V>(zf + o + k * step, v[k]);
        add(v[k]);
      }
    }
    for (; row < t.row1; row += t.stride) {
      const int64_t o = row * C + c;
      float v[V];
      load<V>(z + o, v);
      store<V>(zf + o, v);
      add(v);
    }
  }
  cols::store_partial<V>(t, C, s, q, sh, part);
}

// What the forward needs of column j, from its sums over n rows, and the
// running statistics' update: running = momentum * running + (1 -
// momentum) * batch, with the biased variance.
struct Finish {
  const float* scale;
  float* running_mean;
  float* running_var;
  float* stats;
  int C;
  float momentum, rest, eps;    // rest = 1 - momentum, rounded by the caller

  __device__ void column(int j, double s, double q, double n) const {
    const double mean = s / n;
    const double d = q / n - mean * mean;
    const double var = d > 0.0 ? d : 0.0;
    const float rstd = float(1.0 / sqrt(var + double(eps)));
    const float m = float(mean), v = float(var);
    stats[j] = m;
    stats[C + j] = rstd;
    stats[2 * C + j] = __fmul_rn(rstd, scale[j]);
    stats[3 * C + j] = d >= 0.0 ? rstd : 0.0f;
    stats[4 * C + j] = float(1.0 / n);
    running_mean[j] = __fadd_rn(__fmul_rn(momentum, running_mean[j]),
                                __fmul_rn(rest, m));
    running_var[j] = __fadd_rn(__fmul_rn(momentum, running_var[j]),
                               __fmul_rn(rest, v));
  }
};

// the merge's epilogue: finish (sums null), or write the sums and the rows
// for the mesh's all-reduce: sums = [sum z; sum z^2; rows] in double
struct FinishOrSums {
  Finish fin;
  double* sums;
  double rows;

  __device__ void operator()(int j, double s, double q) const {
    if (sums == nullptr) {
      fin.column(j, s, q, rows);
      return;
    }
    sums[j] = s;
    sums[fin.C + j] = q;
    if (j == 0) sums[2 * fin.C] = rows;
  }
};

__global__ void bn_finish(const double* __restrict__ sums, Finish fin) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < fin.C) fin.column(j, sums[j], sums[fin.C + j], sums[2 * fin.C]);
}

// dz = mul * (du - a / N - (x - mean) * rstd_v * b / N) in bf16, one group
// of V a thread as fast_sine.cu's blocks; ab = [a; b].
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_dz(const float* __restrict__ x, const float* __restrict__ du,
          __nv_bfloat16* __restrict__ dz, const float* __restrict__ stats,
          const float* __restrict__ ab, int64_t units, int C) {
  const int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= units) return;
  const int c = int(u * V % C);
  const float inv_n = stats[4 * C];
  float v[V], d[V], m[V], k[V], r[V], a[V], b[V];
  load<V>(x + u * V, v);
  load<V>(du + u * V, d);
  load<V>(stats + c, m);
  load<V>(stats + 2 * C + c, k);
  load<V>(stats + 3 * C + c, r);
  load<V>(ab + c, a);
  load<V>(ab + C + c, b);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xh = (v[i] - m[i]) * r[i];
    v[i] = k[i] * (d[i] - a[i] * inv_n - xh * (b[i] * inv_n));
  }
  store<V>(dz + u * V, v);
}

// 8 columns a thread where C allows it (the pointers then 16-byte aligned)
bool wide(int C) { return C % kVec == 0; }

bool takes(int C, long long n) {
  return cols::takes_width<1>(C) && n > 0 && n % C == 0;
}

Finish finish_of(const void* scale, void* running_mean, void* running_var,
                 void* stats, int C, float momentum, float rest, float eps) {
  return Finish{static_cast<const float*>(scale),
                static_cast<float*>(running_mean),
                static_cast<float*>(running_var), static_cast<float*>(stats),
                C, momentum, rest, eps};
}

}  // namespace

extern "C" {

// The partial rows (part's first dimension) bn_stats_launch takes for n =
// rows * C elements on the current card; -1 for a width it does not take.
int bn_stats_blocks(long long n, int C) {
  if (!takes(C, n)) return -1;
  return wide(C)
             ? cols::row_tiled_blocks<kVec>(bn_column_sums<kVec>, n / C, C)
             : cols::row_tiled_blocks<1>(bn_column_sums<1>, n / C, C);
}

// z (bf16, rows x C) -> zf (float32), and either (sums null) stats and the
// running statistics updated in place, or sums = [sum z; sum z^2; rows]
// (double, 2C + 1) for an all-reduce and bn_finish_launch.  part is
// float32 [blocks][2][C], blocks from bn_stats_blocks.
int bn_stats_launch(const void* z, void* zf, void* part, void* sums,
                    void* stats, const void* scale, void* running_mean,
                    void* running_var, long long n, int C, int blocks,
                    float momentum, float rest, float eps, void* stream) {
  const bool vec = wide(C);
  if (!takes(C, n) || blocks <= 0 ||
      (vec && !(cols::aligned16(z) && cols::aligned16(zf))))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  float* out = static_cast<float*>(zf);
  float* p = static_cast<float*>(part);
  if (vec)
    bn_column_sums<kVec><<<dim3(blocks, cols::slabs<kVec>(C)), kThreads, 0,
                           s>>>(zb, out, p, n / C, C);
  else
    bn_column_sums<1><<<dim3(blocks, cols::slabs<1>(C)), kThreads, 0, s>>>(
        zb, out, p, n / C, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const FinishOrSums ep{finish_of(scale, running_mean, running_var, stats, C,
                                  momentum, rest, eps),
                        static_cast<double*>(sums), double(n / C)};
  return int(cols::merge(static_cast<const float*>(part), blocks, C, ep, s));
}

// stats and the running statistics from the all-reduced sums (double,
// [sum z; sum z^2; rows] of the global batch).
int bn_finish_launch(const void* sums, void* stats, const void* scale,
                     void* running_mean, void* running_var, int C,
                     float momentum, float rest, float eps, void* stream) {
  if (!cols::takes_width<1>(C)) return int(cudaErrorInvalidValue);
  bn_finish<<<(C + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(sums),
      finish_of(scale, running_mean, running_var, stats, C, momentum, rest,
                eps));
  return int(cudaGetLastError());
}

// dz (bf16) from the float32 z, du, stats and ab = [sum du; sum du * xhat]
// of the global batch.
int bn_dz_launch(const void* zf, const void* du, void* dz, const void* stats,
                 const void* ab, long long n, int C, void* stream) {
  const bool vec = wide(C);
  if (!takes(C, n) ||
      (vec && !(cols::aligned16(zf) && cols::aligned16(du) &&
                cols::aligned16(dz) && cols::aligned16(stats) &&
                cols::aligned16(ab))))
    return int(cudaErrorInvalidValue);
  const int64_t units = vec ? n / kVec : n;
  const unsigned grid = unsigned((units + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(zf);
  const auto* d = static_cast<const float*>(du);
  auto* out = static_cast<__nv_bfloat16*>(dz);
  const auto* st = static_cast<const float*>(stats);
  const auto* sums = static_cast<const float*>(ab);
  if (vec)
    bn_dz<kVec><<<grid, kThreads, 0, s>>>(x, d, out, st, sums, units, C);
  else
    bn_dz<1><<<grid, kThreads, 0, s>>>(x, d, out, st, sums, units, C);
  return int(cudaGetLastError());
}

const char* batchnorm_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
