// Passes over the columns of a [rows, C] activation: V-wide loads and
// stores, and two sums of every column without float atomics, so that
// they are the same from run to run.
//
// V = 8 where C is a multiple of 8 (16-byte vector loads and stores: one of
// bf16, two of float32; every row 16-byte aligned), else V = 1 (one
// element a load, any C).  A row-tiled pass: each thread holds V
// consecutive columns of one lane, a block's lanes are adjacent rows, and
// block b takes the row groups b, b + grid, b + 2 grid, ..., so that the
// blocks' loads advance through memory together; each thread sums its
// columns in registers.  A slab of at most kThreads * V columns a block
// (grid.y the slabs: one up to 2,048 columns at V = 8, 256 at V = 1).  The
// block adds its lanes in lane order and leaves its slab of one partial
// row part[block][2][C]; column_sums_merge then adds the partial rows in a
// fixed order, in double.  The grid is one wave of the card's resident
// blocks (row_tiled_blocks), so that the partial rows stay few: a few
// hundred, 1-2 MB at C = 512, against the 1.2 GB a pass moves.  On an H100
// at 393,216 x 512 the interleaved rows read 72 % (column sums) and 86 %
// (the sine's backward) of the bytes' bound, against 62 % and 73-76 % for a
// contiguous range of rows a block, one wave or two.
//
// Used by csrc/fast_sine.cu (sum du and sum du * xhat, the BatchNorm
// backward's column sums; its vector loads and stores) and
// csrc/batchnorm_train.cu (sum z and sum z^2, the forward's statistics).
// No TPU kernel: the JAX package leaves the full-batch BatchNorm of its
// SIREN layers to XLA's fusion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cols {

constexpr int kThreads = 256;       // a row-tiled block
constexpr int kVec = 8;             // consecutive elements a thread
constexpr int kMergeCols = 32;      // columns a merge block
constexpr int kMergeSlices = 32;    // its warps, each a slice of the rows

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

// round to nearest even, as torch's .to(torch.bfloat16)
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
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// V consecutive elements: load8 / store8 at V = kVec, one at a time else
template <int V, class T>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == kVec) {
    load8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_float(p[i]);
  }
}

template <int V, class T>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == kVec) {
    store8(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) store1(p + i, v[i]);
  }
}

// the columns a row-tiled block takes, and the slabs (grid.y) of C
template <int V>
constexpr int kSlab = kThreads * V;

template <int V>
__host__ __device__ __forceinline__ int slabs(int C) {
  return (C + kSlab<V> - 1) / kSlab<V>;
}

// Widths a V-wide pass takes: a multiple of V, in at most 65,535 slabs.
template <int V>
__host__ __device__ __forceinline__ bool takes_width(int C) {
  return C > 0 && C % V == 0 && slabs<V>(C) <= 65535;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The thread's place in a row-tiled block: its slab's columns c0 ... c0 +
// width, its own columns c0 + V * group ..., its lane (lanes >= `lanes`
// idle), and its rows: row0, row0 + stride, ... below row1, its lane's row
// in the block's row groups.
struct Tile {
  int c0, width, group, lane, lanes;
  int64_t row0, row1, stride;
};

template <int V>
__device__ __forceinline__ Tile tile(int C, int64_t rows) {
  Tile t;
  t.c0 = int(blockIdx.y) * kSlab<V>;
  t.width = min(C - t.c0, kSlab<V>);
  const int groups = t.width / V;
  t.lanes = kThreads / groups;
  t.group = threadIdx.x % groups;
  t.lane = threadIdx.x / groups;
  t.row0 = int64_t(blockIdx.x) * t.lanes + t.lane;
  t.row1 = rows;
  t.stride = int64_t(gridDim.x) * t.lanes;
  return t;
}

// every lane's two sums of its columns: kThreads * V * 2 floats
template <int V>
struct Partial {
  float v[kThreads * V * 2];
};

// The block's two sums of each column of its slab, this thread's s and q
// of its columns added over the lanes in lane order, into
// part[blockIdx.x][2][C].
template <int V>
__device__ __forceinline__ void store_partial(const Tile& t, int C,
                                              const float (&s)[V],
                                              const float (&q)[V],
                                              Partial<V>& sh, float* part) {
  const int w = t.width;
  if (t.lane < t.lanes) {
    float* row = sh.v + t.lane * 2 * w + t.group * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      row[i] = s[i];
      row[w + i] = q[i];
    }
  }
  __syncthreads();
  float* out = part + int64_t(blockIdx.x) * 2 * C + t.c0;
  for (int j = threadIdx.x; j < 2 * w; j += kThreads) {
    float acc = sh.v[j];
    for (int l = 1; l < t.lanes; ++l) acc += sh.v[l * 2 * w + j];
    out[j < w ? j : C + j - w] = acc;
  }
}

// Column j's two sums over the P partial rows of part[P][2][C], in double
// and in a fixed order (each warp a slice of the rows, then the slices in
// order), handed to ep(j, first sum, second sum).  Block (kMergeCols,
// kMergeSlices), grid ceil(C / kMergeCols).
template <class Epilogue>
__global__ void __launch_bounds__(kMergeCols * kMergeSlices)
    column_sums_merge(const float* __restrict__ part, int P, int C,
                      Epilogue ep) {
  __shared__ double red[2][kMergeSlices][kMergeCols];
  const int x = threadIdx.x, y = threadIdx.y;
  const int j = blockIdx.x * kMergeCols + x;
  double s = 0.0, q = 0.0;
  if (j < C) {
    for (int p = y; p < P; p += kMergeSlices) {
      s += part[int64_t(p) * 2 * C + j];
      q += part[int64_t(p) * 2 * C + C + j];
    }
  }
  red[0][y][x] = s;
  red[1][y][x] = q;
  __syncthreads();
  if (y == 0 && j < C) {
    for (int k = 1; k < kMergeSlices; ++k) {
      s += red[0][k][x];
      q += red[1][k][x];
    }
    ep(j, s, q);
  }
}

template <class Epilogue>
cudaError_t merge(const float* part, int P, int C, Epilogue ep,
                  cudaStream_t stream) {
  column_sums_merge<<<(C + kMergeCols - 1) / kMergeCols,
                      dim3(kMergeCols, kMergeSlices), 0, stream>>>(
      part, P, C, ep);
  return cudaGetLastError();
}

// The blocks (grid.x) of a V-wide row-tiled pass of `kernel` on the
// current card: one wave of its resident blocks shared by the slabs, and
// no more than one row a lane of the widest slab needs; -1 if the card
// cannot say.
template <int V, class Kernel>
int row_tiled_blocks(Kernel kernel, int64_t rows, int C) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return -1;
  const int width = C < kSlab<V> ? C : kSlab<V>;
  const int64_t lanes = kThreads / (width / V);
  const int64_t need = (rows + lanes - 1) / lanes;
  int64_t wave = int64_t(sms) * (per_sm > 0 ? per_sm : 1) / slabs<V>(C);
  if (wave < 1) wave = 1;
  return int(need < wave ? need : wave);
}

}  // namespace cols
