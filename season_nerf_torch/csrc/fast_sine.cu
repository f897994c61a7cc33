// K0 launched on its own: the polynomial sine (or cosine) of every element
// of a float32 tensor, and its gradient; one launch per direction.
//
// Replaces the chain of plain PyTorch passes of ops/fast_math.py (_sin,
// _cos, and the gradient g * _cos(x)): 16 launches forward and 18 backward
// over every [rows, width] activation of a SineLayer with fast_sine.  No
// TPU kernel: the JAX package leaves the elementwise sine of its SIREN
// layers to XLA's fusion.  The value is K0's device function
// (fast_sin.cuh), so the same bits as inside K1/K2/K3, at the degree the
// build's -DFAST_SIN_DEGREE selects.
//
// Bound: device-memory bytes.  The forward reads x (4 B an element) and
// writes y (4 B, or 2 B in bf16); the backward reads x and g (4 or 2 B) and
// writes dx (4 B).  About a dozen f32 instructions an element, far below
// the card's operations-per-byte line.
//
// Design: each thread takes one group of 8 consecutive elements: two
// 16-byte loads of x (and of an f32 g, one of a bf16 g), two 16-byte stores
// of an f32 result or one of a bf16 result.  The grid is sized to the work,
// one short-lived block of 256 threads a 2,048 elements, so that every SM
// keeps its full 2,048 threads' loads in flight as blocks retire.  On an
// H100 at 393,216 x 512 this read 88-92 % of the bytes' bound against 70-86
// % for a grid of the card's SMs times 8 blocks looping over the groups,
// and against 82-84 % with 2 or 4 groups a thread (f32 forward).  The last
// n % 8 elements, and every element of a tensor whose pointers are not
// 16-byte aligned, take the scalar path.  The cast to bf16 is
// __float2bfloat16_rn, the round-to-nearest-even of torch's
// .to(torch.bfloat16).
//
// The folded variants (fast_sine_fwd_bn, fast_sine_bwd_bn) serve a training
// SineLayer with BatchNorm in bf16 (ops/batchnorm_train.py): the same
// device functions and store, the BatchNorm's per-column normalisation
// before the polynomial, and the same bytes a launch as the plain variants
// (float32 x and bf16 y; float32 x, bf16 g and float32 dx).  The backward
// also takes the BatchNorm backward's two column sums, so it is row-tiled
// (columns.cuh) and its partial sums are merged by a second, small kernel
// of the same call.  The plain variants above are not touched by them.
//
// The plain C interface (ctypes, ops/fast_math.py): fast_sine_fwd_launch,
// fast_sine_bwd_launch, fast_sine_fwd_bn_launch, fast_sine_bwd_bn_launch,
// each returning a cudaError_t, and fast_sine_bwd_bn_blocks; the caller of
// the plain variants checks n below 2^31 (the folded ones index in 64
// bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "columns.cuh"
#include "fast_sin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

// the vector blocks of `units` groups of 8, one group a thread
__host__ __device__ __forceinline__ int64_t vector_blocks(int64_t units) {
  return (units + kThreads - 1) / kThreads;
}

// d fast_sin = fast_cos, d fast_cos = -fast_sin
template <bool kCos>
__device__ __forceinline__ float value(float x) {
  return kCos ? fast_cos(x) : fast_sin(x);
}

template <bool kCos>
__device__ __forceinline__ float slope(float x) {
  return kCos ? -fast_sin(x) : fast_cos(x);
}

using cols::load8;
using cols::store8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// y = fast_sin(x) (or fast_cos) in Out.  The first vector_blocks(units)
// blocks take a group of 8 a thread; the rest an element a thread, from
// 8 * units on.
template <bool kCos, typename Out>
__global__ void __launch_bounds__(kThreads)
    fast_sine_fwd(const float* __restrict__ x, Out* __restrict__ y,
                  int64_t n, int64_t units) {
  const int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (u < vector_blocks(units) * kThreads) {
    if (u >= units) return;
    float v[kVec];
    load8(x + u * kVec, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = value<kCos>(v[i]);
    store8(y + u * kVec, v);
    return;
  }
  const int64_t i = units * kVec + u - vector_blocks(units) * kThreads;
  if (i < n) put(y + i, value<kCos>(x[i]));
}

// dx = g * fast_cos(x) (or -g * fast_sin(x)) in float32, g in G; blocks
// as the forward's.
template <bool kCos, typename G>
__global__ void __launch_bounds__(kThreads)
    fast_sine_bwd(const float* __restrict__ x, const G* __restrict__ g,
                  float* __restrict__ dx, int64_t n, int64_t units) {
  const int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (u < vector_blocks(units) * kThreads) {
    if (u >= units) return;
    float v[kVec], w[kVec];
    load8(x + u * kVec, v);
    load8(g + u * kVec, w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = w[i] * slope<kCos>(v[i]);
    store8(dx + u * kVec, v);
    return;
  }
  const int64_t i = units * kVec + u - vector_blocks(units) * kThreads;
  if (i < n) dx[i] = to_float(g[i]) * slope<kCos>(x[i]);
}

// The folded variants, for a training SineLayer with BatchNorm in bf16
// (ops/batchnorm_train.py): the sine takes the BatchNorm's output
// (x - mean) * mul + beta of each element's column, in flax's order and
// rounded after each step as the plain passes round it (no contraction into
// an FMA), so that the sine's argument is theirs.  stats is [5][C]: the
// columns' mean, rstd, mul = rstd * scale, ... (csrc/batchnorm_train.cu).
// x is the float32 z.  V = 8 consecutive elements a thread where C is a
// multiple of 8 (every pointer then 16-byte aligned), else V = 1
// (columns.cuh).
__device__ __forceinline__ float normalised(float x, float mean, float mul,
                                            float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta);
}

// y = fast_sin(normalised(x)) in bf16; blocks as fast_sine_fwd's vector
// blocks, the column's mean, mul and beta read through the cache.
template <int V>
__global__ void __launch_bounds__(kThreads)
    fast_sine_fwd_bn(const float* __restrict__ x,
                     __nv_bfloat16* __restrict__ y,
                     const float* __restrict__ stats,
                     const float* __restrict__ beta, int64_t units, int C) {
  const int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= units) return;
  const int c = int(u * V % C);
  float v[V], m[V], k[V], b[V];
  cols::load<V>(x + u * V, v);
  cols::load<V>(stats + c, m);
  cols::load<V>(stats + 2 * C + c, k);
  cols::load<V>(beta + c, b);
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = fast_sin(normalised(v[i], m[i], k[i], b[i]));
  cols::store<V>(y + u * V, v);
}

// du = g * fast_cos(normalised(x)) in float32 (g bf16), and the BatchNorm
// backward's column sums a = sum du and b = sum du * xhat, xhat = (x -
// mean) * rstd, as rstd * sum du * (x - mean): a row-tiled pass
// (columns.cuh), two rows a lane in flight, each block's partial sums into
// part[block][2][C].
template <int V>
__global__ void __launch_bounds__(cols::kThreads)
    fast_sine_bwd_bn(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ part,
                     const float* __restrict__ stats,
                     const float* __restrict__ beta, int64_t rows, int C) {
  __shared__ cols::Partial<V> sh;
  const cols::Tile t = cols::tile<V>(C, rows);
  float a[V] = {}, b[V] = {};
  if (t.lane < t.lanes) {
    const int c = t.c0 + t.group * V;
    float m[V], k[V], be[V];
    cols::load<V>(stats + c, m);
    cols::load<V>(stats + 2 * C + c, k);
    cols::load<V>(beta + c, be);
    auto step = [&](float (&v)[V], const float (&w)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = __fsub_rn(v[i], m[i]);
        const float du =
            w[i] * fast_cos(__fadd_rn(__fmul_rn(d, k[i]), be[i]));
        a[i] += du;
        b[i] = fmaf(du, d, b[i]);
        v[i] = du;
      }
    };
    int64_t row = t.row0;
    for (; row + t.stride < t.row1; row += 2 * t.stride) {
      const int64_t o0 = row * C + c, o1 = o0 + t.stride * C;
      float v0[V], w0[V], v1[V], w1[V];
      cols::load<V>(x + o0, v0);
      cols::load<V>(g + o0, w0);
      cols::load<V>(x + o1, v1);
      cols::load<V>(g + o1, w1);
      step(v0, w0);
      cols::store<V>(dx + o0, v0);
      step(v1, w1);
      cols::store<V>(dx + o1, v1);
    }
    if (row < t.row1) {
      const int64_t o = row * C + c;
      float v[V], w[V];
      cols::load<V>(x + o, v);
      cols::load<V>(g + o, w);
      step(v, w);
      cols::store<V>(dx + o, v);
    }
    float r[V];
    cols::load<V>(stats + C + c, r);
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] *= r[i];
  }
  cols::store_partial<V>(t, C, a, b, sh, part);
}

// the merged sums, a then b, in float32
struct WriteSums {
  float* out;
  int C;
  __device__ void operator()(int j, double a, double b) const {
    out[j] = float(a);
    out[C + j] = float(b);
  }
};

// the folded launches' checks: n = rows * C elements, and where C is a
// multiple of 8 (8 columns a thread) every pointer 16-byte aligned
bool takes_bn(long long n, int C) {
  return n > 0 && cols::takes_width<1>(C) && n % C == 0;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the vector blocks, then the scalar blocks of the last n - 8 * units
dim3 grid_for(int64_t n, int64_t units) {
  return dim3(unsigned(vector_blocks(units)
                       + (n - units * kVec + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

// y[i] = fast_sin(x[i]) (cosine: fast_cos), y float32 or (out_bf16) bf16;
// on the caller's current card
int fast_sine_fwd_launch(const void* x, void* y, long long n, int cosine,
                         int out_bf16, void* stream) {
  if (n <= 0) return 0;
  const int64_t units = aligned(x) && aligned(y) ? n / kVec : 0;
  const dim3 grid = grid_for(n, units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (out_bf16) {
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    if (cosine)
      fast_sine_fwd<true><<<grid, kThreads, 0, s>>>(xf, yb, n, units);
    else
      fast_sine_fwd<false><<<grid, kThreads, 0, s>>>(xf, yb, n, units);
  } else {
    float* yf = static_cast<float*>(y);
    if (cosine)
      fast_sine_fwd<true><<<grid, kThreads, 0, s>>>(xf, yf, n, units);
    else
      fast_sine_fwd<false><<<grid, kThreads, 0, s>>>(xf, yf, n, units);
  }
  return int(cudaGetLastError());
}

// dx[i] = g[i] * fast_cos(x[i]) (cosine: -g[i] * fast_sin(x[i])), g float32
// or (g_bf16) bf16, dx float32; on the caller's current card
int fast_sine_bwd_launch(const void* x, const void* g, void* dx,
                         long long n, int cosine, int g_bf16, void* stream) {
  if (n <= 0) return 0;
  const int64_t units =
      aligned(x) && aligned(g) && aligned(dx) ? n / kVec : 0;
  const dim3 grid = grid_for(n, units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* d = static_cast<float*>(dx);
  if (g_bf16) {
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
    if (cosine)
      fast_sine_bwd<true><<<grid, kThreads, 0, s>>>(xf, gb, d, n, units);
    else
      fast_sine_bwd<false><<<grid, kThreads, 0, s>>>(xf, gb, d, n, units);
  } else {
    const float* gf = static_cast<const float*>(g);
    if (cosine)
      fast_sine_bwd<true><<<grid, kThreads, 0, s>>>(xf, gf, d, n, units);
    else
      fast_sine_bwd<false><<<grid, kThreads, 0, s>>>(xf, gf, d, n, units);
  }
  return int(cudaGetLastError());
}

// The folded forward: y[r][c] = fast_sin((x[r][c] - mean[c]) * mul[c] +
// beta[c]) in bf16, n = rows * C elements.
int fast_sine_fwd_bn_launch(const void* x, void* y, const void* stats,
                            const void* beta, long long n, int C,
                            void* stream) {
  if (n <= 0) return 0;
  const bool vec = C % kVec == 0;
  if (!takes_bn(n, C) || (vec && !(aligned(x) && aligned(y) &&
                                   aligned(stats) && aligned(beta))))
    return int(cudaErrorInvalidValue);
  const int64_t units = vec ? n / kVec : n;
  const unsigned grid = unsigned(vector_blocks(units));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* st = static_cast<const float*>(stats);
  const auto* be = static_cast<const float*>(beta);
  if (vec)
    fast_sine_fwd_bn<kVec><<<grid, kThreads, 0, s>>>(xf, yb, st, be, units,
                                                     C);
  else
    fast_sine_fwd_bn<1><<<grid, kThreads, 0, s>>>(xf, yb, st, be, units, C);
  return int(cudaGetLastError());
}

// The partial rows the folded backward leaves for n = rows * C elements
// on the current card (the rows of its `part`); -1 for a shape it does
// not take.
int fast_sine_bwd_bn_blocks(long long n, int C) {
  if (!takes_bn(n, C)) return -1;
  return C % kVec == 0
             ? cols::row_tiled_blocks<kVec>(fast_sine_bwd_bn<kVec>, n / C, C)
             : cols::row_tiled_blocks<1>(fast_sine_bwd_bn<1>, n / C, C);
}

// The folded backward: dx = g * fast_cos(the forward's argument) in
// float32 (g bf16), then ab = [sum dx; sum dx * xhat] of each column
// (float32 [2][C]), merged from part ([blocks][2][C], blocks from
// fast_sine_bwd_bn_blocks) in a fixed order.
int fast_sine_bwd_bn_launch(const void* x, const void* g, void* dx,
                            void* part, void* ab, const void* stats,
                            const void* beta, long long n, int C,
                            int blocks, void* stream) {
  if (n <= 0) return 0;
  const bool vec = C % kVec == 0;
  if (!takes_bn(n, C) || blocks <= 0 ||
      (vec && !(aligned(x) && aligned(g) && aligned(dx) && aligned(stats) &&
                aligned(beta))))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* d = static_cast<float*>(dx);
  auto* p = static_cast<float*>(part);
  const auto* st = static_cast<const float*>(stats);
  const auto* be = static_cast<const float*>(beta);
  if (vec)
    fast_sine_bwd_bn<kVec><<<dim3(blocks, cols::slabs<kVec>(C)),
                             cols::kThreads, 0, s>>>(xf, gb, d, p, st, be,
                                                     n / C, C);
  else
    fast_sine_bwd_bn<1><<<dim3(blocks, cols::slabs<1>(C)), cols::kThreads,
                          0, s>>>(xf, gb, d, p, st, be, n / C, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(cols::merge(p, blocks, C, WriteSums{static_cast<float*>(ab), C},
                         s));
}

const char* fast_sine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
