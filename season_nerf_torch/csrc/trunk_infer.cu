// K3: the inference trunk of T-NeRF, fc1 .. fcN + fc9, fused in one kernel.
//
// Replaces season_nerf_tpu/ops/pallas_mlp.py::_trunk_kernel (:106, called
// through trunk_apply, :162).  Each layer computes sin(h . W' + b') with
// omega and the BatchNorm running statistics folded into W' and b' on the
// host (ops/fused_trunk.py fold_trunk).  The input of every layer is cast
// to W's type (the f32 PE too, at fc1 and in the skip layer's [h | PE]);
// products accumulate in f32, b' is added in f32, then sin (sinf, or K0
// fast_sin); the last layer writes f32.  The plain version is
// fused_trunk.trunk_apply_reference.
//
// Bound (H100 SXM): operations.  At width 512 a point costs 2.03 M
// multiply-adds and reads 256 B of PE and writes 1 KB of x_enc, so a
// 491,520-point render chunk is 2.0 TFLOP against 0.63 GB: 2.018 ms at
// 989 TFLOP/s bf16 (30 ms at 67 TFLOP/s f32) against 0.19 ms at 3.35 TB/s.
//
// bf16 (trunk_bf16), TMA-fed wgmma:
//  - A thread-block cluster of kCluster = 2 CTAs, one 64-row tile each,
//    288 threads: warps 0-7 are two consumer warpgroups, warp 8 the
//    producer.  The grid is rounded up to whole clusters; a CTA past the
//    last row computes on zeros and stores nothing.
//  - The tile's activations never leave the SM.  h (up to 512 wide, eight
//    64-wide K chunks) and the PE (one chunk: PE_PAD = 64) live in shared
//    memory in the K-major 128-byte-swizzled layout that a wgmma A
//    descriptor reads, 8 KB a chunk, 73,728 B in all.  A layer's A
//    operand is its K chunks in order; the skip layer's is h's chunks and
//    then the PE chunk, read in place.  The PE arrives as f32, so the
//    consumers load, convert and store it (256 B a point).
//  - The folded weights W' ([n, k] row-major: K-major for B, no
//    transpose) stream by TMA with the 128-byte swizzle into a ring of
//    kSlots = 9 slots of 64 K x 128 W' rows (16 KB each), with a full and
//    an empty mbarrier per slot.  Each CTA's producer loads its half of a
//    slot's rows and multicasts it to both CTAs, so each weight byte read
//    from L2 serves 128 rows: 4.06 MB of weights per 128 rows, 15.6 GB a
//    flagship chunk (a 64-row tile alone would pull 31.2 GB).  A slot is
//    free when the consumers of both CTAs have released it: its empty
//    barrier counts 4 warps x kCluster arrivals, local and remote.  The
//    producer runs ahead across layer boundaries, so the next layer's
//    first slots land during this layer's epilogue.  The tensor maps are
//    encoded once per folded trunk on the host and reach the kernel as
//    __grid_constant__ parameters.
//  - Why small slots: each SM takes in 64 KB of weights per 0.53 us of
//    products (64 rows per weight byte), and a slot comes back only a
//    round trip (release, producer, TMA, land) after it is freed, so the
//    stream is bound by the bytes in flight.  Two 64 KB stages kept one
//    load in flight; nine 16 KB slots, each freed as soon as its own
//    products are done, keep about seven, and the stream alone (no
//    products, no sines) ran faster.  A 128-row tile split by columns
//    over the cluster's two CTAs halves each SM's bytes but leaves room
//    for only five slots; it was slower.
//  - Warpgroup w owns the slots w and w + 2 of each K chunk (output
//    columns 128 w and 128 (w + 2) on), one wgmma.m64n128k16 accumulator
//    set of 64 f32 registers for each, started at b' (so the epilogue
//    reads no bias).  Writing a layer's output over its input needs every
//    product of the layer done first: wgmma wait, a named barrier over
//    both warpgroups, then the epilogue (sine, bf16 into the swizzled
//    layout), a proxy fence and the barrier again before the next layer's
//    wgmma.
//  - The epilogue is paid serially: ~2.14 G sines a flagship chunk
//    (491,520 x (8 x 512 + 256)), about a third of the kernel's time,
//    while the tensor cores wait; only the weights' prefetch overlaps it.
//    Its code is straight-line and unrolled (128 sines a thread a layer),
//    so its size is its speed: the sine and the last layer's f32 stores
//    are template parameters, each instance holding one path (both sines
//    in one instance made the kernel several times slower).
//  - Shared memory: 73,728 (activations) + 147,456 (ring) + 1,024 (to
//    align the swizzle atoms) = 222,208 B of the 232,448 an SM gives, so
//    one CTA an SM.  Widths up to 512 after padding to 128 (one slot),
//    up to kMaxLayers = 9 layers (the model's deepest trunk).
//  - No setmaxnreg: ptxas gives the kernel about 165 registers, no spills
//    (PERF.md).  The shared-memory limit is set on every launch; a wait
//    that polls too long traps.
//
// f32 (trunk_f32): 32-row tiles, plain FFMA in full f32 (the reference's
// f32 path is not TF32); each thread owns 4 rows x 8 columns.  Buffer A
// holds [h | PE] so that the skip layer reads its concatenation in place,
// buffer B holds h, and the layers ping-pong between them (the plan comes
// from the host); the weights stream from global memory through L2.
// Rows past the end of the input are computed on zeros and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fast_sin.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ float activate(float z, int fast) {
  return fast ? fast_sin(z) : sinf(z);
}

// --- bf16: TMA + wgmma ------------------------------------------------------
constexpr int kCluster = 2;
constexpr int kRows = 64;                      // rows of a tile
constexpr int kMaxWidth = 512;                 // widest padded layer
constexpr int kChunkBytes = kRows * 128;       // 64 rows x 64 K bf16
constexpr int kPeSlot = kMaxWidth / 64;        // the PE chunk, after h's 8
constexpr int kActBytes = (kPeSlot + 1) * kChunkBytes;
constexpr int kSlotRows = 128;                 // W' rows (output columns)
constexpr int kSlotBytes = kSlotRows * 128;    // 64 K x 128 rows bf16
constexpr int kBoxRows = kSlotRows / kCluster; // each CTA's share of a slot
constexpr int kSlots = 9;
constexpr int kSmemBf16 = kActBytes + kSlots * kSlotBytes + 1024;
constexpr int kThreadsBf16 = 288;
constexpr int kConsumers = 256;
constexpr int kMaxLayers = 9;                  // fc1 .. fc8 + fc9
// launch plan (int64, kPlanFields per layer, built by the host:
// fused_trunk.FoldedTrunk.launch_plan)
constexpr int kPlanFields = 8;
enum PlanField {
  P_W = 0,     // W' pointer, bf16 [n, k] row-major
  P_B,         // b' pointer, f32 [n]
  P_K,         // k, a multiple of 64
  P_N,         // n, a multiple of kSlotRows, <= kMaxWidth
  P_BOX_K,     // the box's K: 64
  P_BOX_N,     // the box's rows: kBoxRows
  P_STRIDE,    // bytes between rows of W': 2 k
  P_PE_CHUNK,  // the K chunk that reads the PE, or -1
};

struct Layer {
  const float* bias;
  int k_chunks, n, pe_chunk;
};

struct Bf16Params {
  CUtensorMap maps[kMaxLayers];
  Layer layers[kMaxLayers];
  int n_layers;
  const float* pe;   // [rows, 64] f32
  float* out;        // [rows, out_cols] f32
  int rows, out_cols;
};

template <bool FAST>
__device__ __forceinline__ float sine(float z) {
  return FAST ? fast_sin(z) : sinf(z);
}

// byte offset of (row r, column c) in a 64-row x 64-K chunk with the
// 128-byte swizzle: 16-byte unit c / 8 of row r lies at unit (c / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// Shared-memory addresses of the kernel's buffers and barriers.
struct Smem {
  uint32_t act, ring, full0, empty0;
  uint8_t* act_ptr;
};

// the kCluster producers may refill slot s: one arrive per consumer warp
// on each CTA's empty barrier
__device__ __forceinline__ void release(const Smem& sm, int s, int lane) {
  if (lane < kCluster) mbar_arrive_cluster(sm.empty0 + 8 * s, lane);
}

// acc (64 rows x 128 columns of this warpgroup) += the tile's K chunk at
// `a` . the ring's slot of the slot sequence's element q, then frees the
// slot.  Waiting for these products before the next slot's costs nothing
// while the weights' stream sets the pace, and frees each slot at once.
__device__ __forceinline__ void mma_slot(float (&acc)[64], const Smem& sm,
                                         int q, uint32_t a, int lane) {
  const int s = q % kSlots;
  mbar_wait(sm.full0 + 8 * s, (q / kSlots) & 1);
  const uint32_t b = sm.ring + s * kSlotBytes;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16<0, 0>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                     wgmma_desc(b + kk * 32, 16, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  release(sm, s, lane);
}

// Accumulator 4 j + 2 h + e of a set: row (warp % 4) 16 + lane / 4 + 8 h
// of the warpgroup's 64, column c0 + 8 j + 2 (lane % 4) + e.

// acc = b' of its columns (64 rows x 128 columns from c0), so that the
// products accumulate onto it and the epilogue reads no bias: all 16 loads
// issued together, ahead of the layer's first wait (one at a time in the
// epilogue, behind its shared-memory stores, each waited out its latency)
__device__ __forceinline__ void init_acc(float (&acc)[64], const float* bias,
                                         int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(
        bias + c0 + 8 * j + 2 * (lane & 3)));
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
}

// The sine of acc (b' and the products: this warpgroup's 64 rows x 128
// columns from c0): bf16 into the swizzled h, or, LAST, f32 to the output.
template <bool FAST, bool LAST>
__device__ __forceinline__ void epilogue(const float (&acc)[64],
                                         const Bf16Params& p, int c0,
                                         const Smem& sm, int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float v0 = sine<FAST>(acc[4 * j + 2 * h]);
      const float v1 = sine<FAST>(acc[4 * j + 2 * h + 1]);
      if (LAST) {
        const int gr = row0 + r;
        if (gr < p.rows && col < p.out_cols) {
          float* o = p.out + (size_t)gr * p.out_cols + col;
          if (col + 1 < p.out_cols && !(p.out_cols & 1)) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (col + 1 < p.out_cols) o[1] = v1;
          }
        }
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            sm.act_ptr + (col >> 6) * kChunkBytes + swz(r, col & 63)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The ring's slot sequence, the same in the producer and the consumers:
// layer by layer, K chunk by K chunk, the layer's n / kSlotRows slots of
// 128 W' rows each.  Warpgroup w takes slots w and w + 2 of every K chunk
// (columns 128 w and 128 (w + 2) on): two accumulator sets at width 512,
// one at 256 or 384, and warpgroup 1 none at 128.
template <bool FAST>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreadsBf16, 1)
    trunk_bf16(const __grid_constant__ Bf16Params p) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kSlots];   // full, then empty
  Smem sm;
  const uint32_t raw = smem_u32(smem);
  sm.act = (raw + 1023) & ~1023u;
  sm.ring = sm.act + kActBytes;
  sm.act_ptr = smem + (sm.act - raw);
  sm.full0 = smem_u32(bars);
  sm.empty0 = sm.full0 + 8 * kSlots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(sm.full0 + 8 * s, 1);
      mbar_init(sm.empty0 + 8 * s, 4 * kCluster);   // one warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's barriers exist before any multicast or remote arrive
  __syncwarp();
  cluster_sync();

  if (warp == 8) {
    if (lane == 0) {
      const uint32_t rank = cluster_ctarank();
      int q = 0;
      for (int l = 0; l < p.n_layers; ++l) {
        const int slots = p.layers[l].n / kSlotRows;
        for (int kc = 0; kc < p.layers[l].k_chunks; ++kc)
          for (int j = 0; j < slots; ++j, ++q) {
            const int s = q % kSlots;
            mbar_wait(sm.empty0 + 8 * s, ((q / kSlots) & 1) ^ 1);
            const uint32_t full = sm.full0 + 8 * s;
            mbar_expect_tx(full, kSlotBytes);
            tma_load_multicast(sm.ring + s * kSlotBytes + rank * kBoxRows * 128,
                               &p.maps[l], full, kc * 64,
                               j * kSlotRows + rank * kBoxRows,
                               (1 << kCluster) - 1);
          }
      }
    }
  } else {
    // the PE: f32 [rows, 64] -> bf16 in the PE chunk, zeros past the end
    for (int i = threadIdx.x; i < kRows * 16; i += kConsumers) {
      const int r = i >> 4, c = 4 * (i & 15);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < p.rows)
        v = __ldg(reinterpret_cast<const float4*>(
            p.pe + (size_t)(row0 + r) * 64 + c));
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo);
      w.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(sm.act_ptr + kPeSlot * kChunkBytes +
                                swz(r, c)) = w;
    }
    fence_proxy_async();
    bar_sync(1, kConsumers);
    const int wg = warp >> 2;
    int q = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const Layer L = p.layers[l];
      const int slots = L.n / kSlotRows;
      const bool last = l == p.n_layers - 1;
      // Both sets start at b' unconditionally (a set this warpgroup does
      // not use reads another of the layer's slots): initialised in a
      // branch, they made ptxas serialize every wgmma (C7515).
      float a0[64], a1[64];
      init_acc(a0, L.bias, (wg % slots) * kSlotRows);
      init_acc(a1, L.bias, ((wg + 2) % slots) * kSlotRows);
      fence_acc(a0);
      fence_acc(a1);
      for (int kc = 0; kc < L.k_chunks; ++kc, q += slots) {
        const uint32_t a =
            sm.act + (kc == L.pe_chunk ? kPeSlot : kc) * kChunkBytes;
        if (wg < slots) mma_slot(a0, sm, q + wg, a, lane);
        if (wg + 2 < slots) mma_slot(a1, sm, q + wg + 2, a, lane);
      }
      // both warpgroups have read this layer's input: it may be overwritten
      bar_sync(1, kConsumers);
      const int c0 = wg * kSlotRows, c1 = (wg + 2) * kSlotRows;
      if (last) {
        if (wg < slots) epilogue<FAST, true>(a0, p, c0, sm, row0);
        if (wg + 2 < slots) epilogue<FAST, true>(a1, p, c1, sm, row0);
      } else {
        if (wg < slots) epilogue<FAST, false>(a0, p, c0, sm, row0);
        if (wg + 2 < slots) epilogue<FAST, false>(a1, p, c1, sm, row0);
      }
      if (!last) {
        fence_proxy_async();
        bar_sync(1, kConsumers);
      }
    }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// --- f32: FFMA ---------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kRowsF32 = 32;
constexpr int kPadF32 = 4;    // row padding in elements: conflict-free reads
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

// The launch plan of a bf16 trunk is one the kernel serves: fc1 reads the
// PE chunk alone, every later layer reads all of the previous layer's
// output chunks and, the skip layer, the PE chunk after them.
bool valid_plan(const long long* plan, int n_layers, int out_cols) {
  if (n_layers < 1 || n_layers > kMaxLayers || out_cols < 1) return false;
  long long prev_n = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kPlanFields;
    const long long K = f[P_K], N = f[P_N], pe = f[P_PE_CHUNK];
    if (K < 64 || K % 64 || N < kSlotRows || N % kSlotRows ||
        N > kMaxWidth || f[P_BOX_K] != 64 || f[P_BOX_N] != kBoxRows ||
        f[P_STRIDE] != 2 * K || !f[P_W] || !f[P_B])
      return false;
    const long long h_chunks = K / 64 - (pe >= 0 ? 1 : 0);
    if (l == 0 ? (K != 64 || pe != 0)
               : (h_chunks != prev_n / 64 || (pe >= 0 && pe != h_chunks)))
      return false;
    prev_n = N;
  }
  return out_cols <= prev_n;
}

}  // namespace

extern "C" {

const char* trunk_infer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Encodes the tensor map of each layer's W' (`plan`: kPlanFields int64 a
// layer) into `maps`, n_layers x 128 bytes of host memory.  Returns 0, or
// cudaErrorInvalidValue for a plan the kernel does not serve.
int trunk_bf16_encode(const long long* plan, int n_layers, int out_cols,
                      void* maps) {
  if (!valid_plan(plan, n_layers, out_cols))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kPlanFields;
    CUtensorMap m;   // 64-byte aligned, as the encoder wants
    if (!bf16_map(&m, reinterpret_cast<const void*>(f[P_W]), f[P_K], f[P_N],
                  f[P_STRIDE] / 2, (int)f[P_BOX_N]))
      return (int)cudaErrorInvalidValue;
    memcpy(static_cast<char*>(maps) + l * sizeof(CUtensorMap), &m,
           sizeof(CUtensorMap));
  }
  return 0;
}

// Launches the bf16 kernel on `stream` with the maps trunk_bf16_encode
// wrote for `plan`; returns cudaGetLastError() (0 = launched).
int trunk_bf16_launch(const long long* plan, int n_layers, const void* maps,
                      const float* pe, float* out, int rows, int out_cols,
                      int fast_sine, void* stream) {
  void (*kernel)(Bf16Params) = fast_sine ? trunk_bf16<true>
                                         : trunk_bf16<false>;
  if (rows < 1 || !valid_plan(plan, n_layers, out_cols))
    return (int)cudaErrorInvalidValue;
  Bf16Params p;
  memset(&p, 0, sizeof(p));
  memcpy(p.maps, maps, n_layers * sizeof(CUtensorMap));
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kPlanFields;
    p.layers[l].bias = reinterpret_cast<const float*>(f[P_B]);
    p.layers[l].k_chunks = (int)(f[P_K] / 64);
    p.layers[l].n = (int)f[P_N];
    p.layers[l].pe_chunk = (int)f[P_PE_CHUNK];
  }
  p.n_layers = n_layers;
  p.pe = pe;
  p.out = out;
  p.rows = rows;
  p.out_cols = out_cols;
  const int tiles = (rows + kRows - 1) / kRows;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster);
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBf16);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreadsBf16, kSmemBf16, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches the f32 kernel on `stream` and returns cudaGetLastError() (0 =
// launched); cudaErrorInvalidValue where the widths exceed shared memory.
int trunk_f32_launch(const long long* table, int n_layers, const float* pe,
                     float* out, int rows, int pe_cols, int out_cols,
                     int a_cols, int b_cols, int fast_sine, void* stream) {
  const size_t smem =
      (size_t)kRowsF32 * (a_cols + kPadF32 + b_cols + kPadF32) * 4;
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
  const dim3 grid((rows + kRowsF32 - 1) / kRowsF32);
  const cudaError_t err = cudaFuncSetAttribute(
      trunk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  trunk_f32<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
