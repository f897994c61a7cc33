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
// The plain C interface (ctypes, ops/fast_math.py): fast_sine_fwd_launch,
// fast_sine_bwd_launch, each returning a cudaError_t; the caller checks n
// below 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

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

const char* fast_sine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
