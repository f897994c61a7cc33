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
//    up to kMaxLayers = 17 layers (fc_layers <= 16; the model builds 8 at
//    most, its fc9 names the half-width layer).
//  - Padded widths 640 .. 1024 take trunk_bf16_wide: the cluster's two
//    CTAs share one 64-row tile and split each layer's columns, each CTA
//    holding the whole [h | PE] and writing its half of every layer's sine
//    into both through distributed shared memory (its note below).  wgmma's
//    64-row M keeps the tile at 64 rows, and two accumulator sets a
//    warpgroup (128 columns each, ~165 registers) are all a thread holds,
//    so a CTA cannot take more than 512 columns of a layer.
//  - No setmaxnreg: ptxas gives the kernel about 165 registers, no spills
//    (PERF.md).  The shared-memory limit is set on every launch; a wait
//    that polls too long traps.
//
// f32 (trunk_f32), FFMA in full f32 (the reference's f32 path is not TF32,
// nor 3xTF32: both round the products otherwise).  At 67 TFLOP/s a flagship
// chunk's 2.0 TFLOP take 29.79 ms, so the kernel is bound by FFMA issue and
// the design keeps the FFMA pipes fed:
//  - A CTA holds one tile of 64 rows (32 above a padded width of 512), 288
//    threads: warps 0-7 consume, warp 8 is the producer.  The tile's
//    activations never leave the SM: h and, after it, the PE live in shared
//    memory as f32, K-major (act[k][row], rows padded by kPadRows): (width +
//    64) x 68 x 4 = 156,672 B at width 512.  fc1 reads the PE rows of act,
//    the skip layer reads [h | PE] in place: its K runs on from h's rows
//    into the PE's.
//  - The weights stream through a ring of kSlotsF32 = 4 slots, each kKs = 8
//    rows of W'^T [k, n] (16 KB at n = 512).  fold_trunk keeps an f32 copy
//    of every W' as W'^T, the layers one after the other (FoldedTrunk.
//    ring_weights), so each slot of the stream is one contiguous block: the
//    producer's lane 0 copies it with one cp.async.bulk onto the slot's full
//    mbarrier, and each consumer warp frees a slot on its empty mbarrier as
//    soon as its products of that slot are done; three slots (48 KB) are in
//    flight while one is read, and the producer runs ahead across layers.
//    Each weight byte read from L2 serves the tile's rows: 8.1 MB a 64-row
//    tile, 62 GB a flagship chunk, ~1.3 TB/s at 46 ms, well inside L2's
//    rate, so no cluster multicast.
//  - The micro-kernel: each consumer thread owns 8 rows x 16 columns (128
//    f32 accumulators, started at b'); a warp covers 32 rows x 128 columns,
//    the 8 warps 64 x 512 (or 32 x 1024).  A k step is 2 LDS.128 of act (the
//    8 rows: 4 + 4; a quarter-warp's lanes read the same 16 B) and 4 of the
//    slot (16 columns: 4 + 4 + 4 + 4, 32 apart; a quarter-warp reads 128
//    contiguous bytes) for 128 FFMAs.  Each output sums its products in k
//    order onto b', one fmaf at a time: no split-K, no atomics, so two
//    launches give the same bytes.  ptxas gives 168 registers, no spills:
//    9 warps put 3 on one SM sub-partition, whose 16 K registers then cap a
//    thread at 168.  (Slower on the card, PERF.md: the producer's work
//    moved into consumer warp 0, for 255 registers; a per-layer choice of
//    the columns a thread owns, so that fc9's 256 keep all 8 warps busy.)
//  - Writing a layer over its input: once the layer's products are done, a
//    named barrier over the consumers, then the sine into act in place (a
//    float4 store is 4 rows of one column; the row padding spreads a warp's
//    stores over every bank), and the barrier again before the next layer
//    reads.  fast_sin runs straight-line from the registers; sinf, a branch
//    around its reduction for |z| > 105615 in every call, runs as a loop
//    over act after z is stored there (f32_sinf_pass).  The last layer
//    writes f32 x_enc.
//  - Rows past the end of the input are computed on zeros and never
//    stored.  Widths up to 1024 after padding to 128 (32-row tiles above
//    512), up to kMaxLayers layers.  Above 768 a ring slot holds kKsWide =
//    4 rows of W'^T: at 1024 the tile (1,088 x 36 x 4 = 156,672 B) and four
//    slots of 16 KB (65,536 B) fit in 222,208 B, with the same k-order sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fast_sin.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

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
constexpr int kMaxLayers = 17;                 // fc1 .. fc16 + fc9
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

// --- bf16 above a padded width of 512: the cluster shares one tile -----------
constexpr int kMaxWidthWide = 1024;                    // widest padded layer
constexpr int kPeSlotWide = kMaxWidthWide / 64;        // the PE chunk
constexpr int kActBytesWide = (kPeSlotWide + 1) * kChunkBytes;
constexpr int kSlotsWide = 5;
constexpr int kSmemWide = kActBytesWide + kSlotsWide * kSlotBytes + 1024;

// The slots of a layer of n output columns that CTA `rank` computes: the
// layer's 128-column slots j = 2 i + rank, i < wide_slots(n, rank).
__device__ __forceinline__ int wide_slots(int n, int rank) {
  return (n / kSlotRows + 1 - rank) / 2;
}

// acc += the tile's K chunk at `a` . the ring's slot of the sequence's
// element q, then frees the slot for this CTA's producer (one arrive per
// warp of the warpgroup).
__device__ __forceinline__ void mma_slot_wide(float (&acc)[64],
                                              const Smem& sm, int q,
                                              uint32_t a, int lane) {
  const int s = q % kSlotsWide;
  mbar_wait(sm.full0 + 8 * s, (q / kSlotsWide) & 1);
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
  if (lane == 0) mbar_arrive(sm.empty0 + 8 * s);
}

// The sine of acc (64 rows x 128 columns from c0) as bf16 into the
// swizzled h of this CTA and, at the same offsets, of its peer (`peer`:
// the peer's act, through mapa).
template <bool FAST>
__device__ __forceinline__ void epilogue_shared(const float (&acc)[64],
                                                int c0, const Smem& sm,
                                                uint32_t peer) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          sine<FAST>(acc[4 * j + 2 * h]), sine<FAST>(acc[4 * j + 2 * h + 1]));
      const uint32_t off = (col >> 6) * kChunkBytes + swz(r, col & 63);
      *reinterpret_cast<__nv_bfloat162*>(sm.act_ptr + off) = v;
      st_cluster_u32(peer + off, *reinterpret_cast<const uint32_t*>(&v));
    }
  }
}

// Padded widths 640 .. 1024.  The cluster's two CTAs share one 64-row tile
// and split every layer's output columns by 128-wide slots: CTA r computes
// the slots j = 2 i + r, i < wide_slots (at most 4, so each warpgroup keeps
// the two accumulator sets of trunk_bf16).  Each CTA holds the tile's whole
// [h | PE] (17 chunks, 139,264 B at 1024) and streams only its own slots of
// W', a slot as two TMA boxes of the launch plan's 64 rows (no multicast),
// through a ring of kSlotsWide = 5 slots of 16 KB: 139,264 + 81,920 + 1,024
// = 222,208 B.  A layer's sine goes into both CTAs' h, so a layer is
// written over its input only when every consumer warp of the cluster has
// read it: each warp arrives on both CTAs' read barrier and waits on its
// own; then it stores its columns here and, through distributed shared
// memory, in the peer, fences the generic stores against wgmma's async
// proxy, arrives on both CTAs' write barrier (release, cluster scope) and
// waits on its own (acquire) before the next layer's products.  The last
// layer writes its own columns of the f32 output.
template <bool FAST>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreadsBf16, 1)
    trunk_bf16_wide(const __grid_constant__ Bf16Params p) {
  extern __shared__ uint8_t smem[];
  // full, empty, then the read and the write barrier
  __shared__ __align__(8) uint64_t bars[2 * kSlotsWide + 2];
  Smem sm;
  const uint32_t raw = smem_u32(smem);
  sm.act = (raw + 1023) & ~1023u;
  sm.ring = sm.act + kActBytesWide;
  sm.act_ptr = smem + (sm.act - raw);
  sm.full0 = smem_u32(bars);
  sm.empty0 = sm.full0 + 8 * kSlotsWide;
  const uint32_t read_bar = sm.empty0 + 8 * kSlotsWide;
  const uint32_t write_bar = read_bar + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = (int)cluster_ctarank();
  const int row0 = blockIdx.x / kCluster * kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlotsWide; ++s) {
      mbar_init(sm.full0 + 8 * s, 1);
      mbar_init(sm.empty0 + 8 * s, 4);          // the warpgroup's warps
    }
    mbar_init(read_bar, 8 * kCluster);          // every consumer warp
    mbar_init(write_bar, 8 * kCluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's barriers exist before any remote arrive
  __syncwarp();
  cluster_sync();

  if (warp == 8) {
    if (lane == 0) {
      int q = 0;
      for (int l = 0; l < p.n_layers; ++l) {
        const int m = wide_slots(p.layers[l].n, rank);
        for (int kc = 0; kc < p.layers[l].k_chunks; ++kc)
          for (int i = 0; i < m; ++i, ++q) {
            const int s = q % kSlotsWide;
            mbar_wait(sm.empty0 + 8 * s, ((q / kSlotsWide) & 1) ^ 1);
            const uint32_t full = sm.full0 + 8 * s;
            const uint32_t dst = sm.ring + s * kSlotBytes;
            const int n0 = (2 * i + rank) * kSlotRows;
            mbar_expect_tx(full, kSlotBytes);
            tma_load(dst, &p.maps[l], full, kc * 64, n0);
            tma_load(dst + kBoxRows * 128, &p.maps[l], full, kc * 64,
                     n0 + kBoxRows);
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
      *reinterpret_cast<uint2*>(sm.act_ptr + kPeSlotWide * kChunkBytes +
                                swz(r, c)) = w;
    }
    fence_proxy_async();
    bar_sync(1, kConsumers);
    const uint32_t peer = mapa(sm.act, rank ^ 1);
    const int wg = warp >> 2;
    int q = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const Layer L = p.layers[l];
      const int m = wide_slots(L.n, rank);
      const bool last = l == p.n_layers - 1;
      // as in trunk_bf16: both sets start at b' unconditionally
      float a0[64], a1[64];
      init_acc(a0, L.bias, m ? (2 * (wg % m) + rank) * kSlotRows : 0);
      init_acc(a1, L.bias, m ? (2 * ((wg + 2) % m) + rank) * kSlotRows : 0);
      fence_acc(a0);
      fence_acc(a1);
      for (int kc = 0; kc < L.k_chunks; ++kc, q += m) {
        const uint32_t a =
            sm.act + (kc == L.pe_chunk ? kPeSlotWide : kc) * kChunkBytes;
        if (wg < m) mma_slot_wide(a0, sm, q + wg, a, lane);
        if (wg + 2 < m) mma_slot_wide(a1, sm, q + wg + 2, a, lane);
      }
      const int c0 = (2 * wg + rank) * kSlotRows;
      const int c1 = (2 * (wg + 2) + rank) * kSlotRows;
      if (last) {
        if (wg < m) epilogue<FAST, true>(a0, p, c0, sm, row0);
        if (wg + 2 < m) epilogue<FAST, true>(a1, p, c1, sm, row0);
      } else {
        // every consumer warp of the cluster has read this layer's input:
        // it may be overwritten, here and in the peer
        __syncwarp();
        if (lane < kCluster) mbar_arrive_cluster_release(read_bar, lane);
        mbar_wait_cluster(read_bar, l & 1);
        if (wg < m) epilogue_shared<FAST>(a0, c0, sm, peer);
        if (wg + 2 < m) epilogue_shared<FAST>(a1, c1, sm, peer);
        // both CTAs' h is whole before the next layer's wgmma reads it
        fence_proxy_async_all();
        asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
        __syncwarp();
        if (lane < kCluster) mbar_arrive_cluster_release(write_bar, lane);
        mbar_wait_cluster(write_bar, l & 1);
        fence_proxy_async();
      }
    }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// --- f32: FFMA, a producer warp and a weight ring -----------------------------
constexpr int kKs = 8;              // rows of W'^T [k, n] a ring slot holds
constexpr int kKsWide = 4;          // the same above kMaxWidthF32Ks8
constexpr int kSlotsF32 = 4;
constexpr int kConsumersF32 = 256;  // warps 0-7; warp 8 is the producer
constexpr int kThreadsF32 = kConsumersF32 + 32;
constexpr int kPadRows = 4;         // act's row padding: conflict-free stores
constexpr int kMaxWidthF32 = 1024;  // widest padded layer
constexpr int kWideRows = 512;      // above this padded width: 32-row tiles
constexpr int kMaxWidthF32Ks8 = 768;   // above it: kKsWide rows a slot
constexpr int kSmemMax = 232448 - 1024;   // dynamic; the rest: barriers
// launch plan (int64, kF32Fields per layer, built by the host:
// fused_trunk.FoldedTrunk.f32_plan)
constexpr int kF32Fields = 6;
enum F32Field {
  F_B = 0,   // b' pointer, f32 [n]
  F_K,       // k, a multiple of kKs
  F_N,       // n, a multiple of 128, <= the padded width
  F_IN,      // the act row (k) where the layer's input starts
  F_W,       // offset of the layer's W'^T [k, n] in ring_weights (floats)
  F_PE,      // the input's k where the PE starts, or -1
};

struct F32Layer {
  const float* bias;
  const float* w;    // W'^T [k, n]
  int k, n, in_k;
};

struct F32Params {
  F32Layer layers[kMaxLayers];
  int n_layers;
  const float* pe;   // [rows, 64] f32
  float* out;        // [rows, out_cols] f32
  int rows, out_cols;
  int width;         // padded width: the PE's first act row
  int slot_floats;   // a ring slot's capacity
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst (shared) <- `bytes` contiguous bytes at src (global), completing on
// the mbarrier `bar` (cp.async.bulk; 16-byte aligned, bytes % 16 == 0)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Accumulator [i][c] of a consumer thread: row ra + 16 (i / 4) + i % 4 of
// the tile, column cb + 32 (c / 4) + c % 4.
// fast_sin of acc, straight-line from the registers: in place into act
// (column c is act row c), or, LAST, f32 to the output.
template <int ROWS, bool LAST>
__device__ __forceinline__ void f32_fast_epilogue(const float (&acc)[8][16],
                                                  const F32Params& p,
                                                  float* act, int ra, int cb,
                                                  int row0) {
  constexpr int LDA = ROWS + kPadRows;
  if (LAST) {
    const bool vec = !(p.out_cols & 3);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = row0 + ra + 16 * (i >> 2) + (i & 3);
      if (gr >= p.rows) continue;
      float* o = p.out + (size_t)gr * p.out_cols;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + 32 * j;
        if (c >= p.out_cols) continue;
        const float4 v = make_float4(
            fast_sin(acc[i][4 * j]), fast_sin(acc[i][4 * j + 1]),
            fast_sin(acc[i][4 * j + 2]), fast_sin(acc[i][4 * j + 3]));
        if (vec) {
          *reinterpret_cast<float4*>(o + c) = v;
        } else {
          o[c] = v.x;
          if (c + 1 < p.out_cols) o[c + 1] = v.y;
          if (c + 2 < p.out_cols) o[c + 2] = v.z;
          if (c + 3 < p.out_cols) o[c + 3] = v.w;
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float* d = act + (cb + 32 * (c >> 2) + (c & 3)) * LDA + ra;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(d + 16 * h) = make_float4(
            fast_sin(acc[4 * h][c]), fast_sin(acc[4 * h + 1][c]),
            fast_sin(acc[4 * h + 2][c]), fast_sin(acc[4 * h + 3][c]));
    }
  }
}

// acc (b' and the products) as it is, into act, for f32_sinf_pass
template <int ROWS>
__device__ __forceinline__ void f32_store_z(const float (&acc)[8][16],
                                            float* act, int ra, int cb) {
  constexpr int LDA = ROWS + kPadRows;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    float* d = act + (cb + 32 * (c >> 2) + (c & 3)) * LDA + ra;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(d + 16 * h) = make_float4(
          acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c],
          acc[4 * h + 3][c]);
  }
}

// sinf of act rows 0 .. n - 1 (z, as f32_store_z left them), by every
// consumer in a loop: in place, or, last, f32 to the output.  sinf's
// out-of-line reduction for |z| > 105615 makes each call a branch, and 128
// calls inlined into the straight-line epilogue were slower (PERF.md).
template <int ROWS>
__device__ __forceinline__ void f32_sinf_pass(float* act, int n, bool last,
                                              const F32Params& p, int row0) {
  constexpr int LDA = ROWS + kPadRows, Q = ROWS / 4;   // float4s an act row
  if (!last) {
    for (int i = threadIdx.x; i < n * Q; i += kConsumersF32) {
      float* d = act + (i / Q) * LDA + 4 * (i % Q);
      const float4 z = lds4(d);
      *reinterpret_cast<float4*>(d) =
          make_float4(sinf(z.x), sinf(z.y), sinf(z.z), sinf(z.w));
    }
  } else {
    const int rows = min(ROWS, p.rows - row0);
    for (int i = threadIdx.x; i < rows * p.out_cols; i += kConsumersF32) {
      const int r = i / p.out_cols, c = i - r * p.out_cols;
      p.out[(size_t)(row0 + r) * p.out_cols + c] = sinf(act[c * LDA + r]);
    }
  }
}

// The ring's slot sequence, the same in the producer and the consumers:
// layer by layer, kKs rows of W'^T at a time (slot q holds the layer's
// rows kKs kc .. kKs kc + kKs - 1, all n columns).  Every consumer warp
// waits for every slot and frees it, also a warp with no columns in a
// layer narrower than its 8 warps cover.
template <int ROWS, bool FAST, int KS>
__global__ void __launch_bounds__(kThreadsF32, 1)
    trunk_f32(const __grid_constant__ F32Params p) {
  constexpr int LDA = ROWS + kPadRows;
  constexpr int WC = 8 / (ROWS / 32);   // warp columns, 128 columns each
  extern __shared__ __align__(128) uint8_t smem_f32[];
  __shared__ __align__(8) uint64_t bars[2 * kSlotsF32];  // full, then empty
  float* act = reinterpret_cast<float*>(smem_f32);
  float* ring = act + (((p.width + 64) * LDA + 31) & ~31);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kSlotsF32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlotsF32; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      int q = 0;
      for (int l = 0; l < p.n_layers; ++l) {
        const F32Layer& L = p.layers[l];
        const uint32_t bytes = KS * L.n * 4;
        for (int kc = 0; kc < L.k / KS; ++kc, ++q) {
          const int s = q % kSlotsF32;
          mbar_wait(empty0 + 8 * s, ((q / kSlotsF32) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, bytes);
          bulk_load(smem_u32(ring + s * p.slot_floats),
                    L.w + (size_t)kc * KS * L.n, bytes, full0 + 8 * s);
        }
      }
    }
    return;
  }

  // the PE: f32 [rows, 64] -> act rows width .. width + 63, zeros past the
  // end of the input
  for (int i = threadIdx.x; i < ROWS * 16; i += kConsumersF32) {
    const int r = i >> 4, c = 4 * (i & 15);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < p.rows)
      v = __ldg(reinterpret_cast<const float4*>(
          p.pe + (size_t)(row0 + r) * 64 + c));
    float* d = act + (p.width + c) * LDA + r;
    d[0] = v.x;
    d[LDA] = v.y;
    d[2 * LDA] = v.z;
    d[3 * LDA] = v.w;
  }
  bar_sync(1, kConsumersF32);
  const int wr = warp / WC, wc = warp % WC;
  const int ra = wr * 32 + 4 * (lane >> 3);    // rows ra + 16 h + e
  const int cb = wc * 128 + 4 * (lane & 7);    // columns cb + 32 j + e
  int q = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const F32Layer L = p.layers[l];
    const bool active = wc * 128 < L.n;
    const bool last = l == p.n_layers - 1;
    float acc[8][16];
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(
            L.bias + cb + 32 * j));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * j] = b.x;
          acc[i][4 * j + 1] = b.y;
          acc[i][4 * j + 2] = b.z;
          acc[i][4 * j + 3] = b.w;
        }
      }
    }
    const float* a = act + L.in_k * LDA + ra;
    for (int kc = 0; kc < L.k / KS; ++kc, ++q) {
      const int s = q % kSlotsF32;
      mbar_wait(full0 + 8 * s, (q / kSlotsF32) & 1);
      if (active) {
        const float* b = ring + s * p.slot_floats + cb;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float* ak = a + (kc * KS + kk) * LDA;
          const float* bk = b + kk * L.n;
          const float4 a0 = lds4(ak), a1 = lds4(ak + 16);
          const float4 b0 = lds4(bk), b1 = lds4(bk + 32), b2 = lds4(bk + 64),
                       b3 = lds4(bk + 96);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[16] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w,
                                b2.x, b2.y, b2.z, b2.w, b3.x, b3.y, b3.z, b3.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 16; ++c)
              acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // every warp has read this layer's input: it may be overwritten
    bar_sync(1, kConsumersF32);
    if (FAST) {
      if (active) {
        if (last)
          f32_fast_epilogue<ROWS, true>(acc, p, act, ra, cb, row0);
        else
          f32_fast_epilogue<ROWS, false>(acc, p, act, ra, cb, row0);
      }
    } else {
      if (active) f32_store_z<ROWS>(acc, act, ra, cb);
      bar_sync(1, kConsumersF32);
      f32_sinf_pass<ROWS>(act, L.n, last, p, row0);
    }
    if (!last) bar_sync(1, kConsumersF32);
  }
}

// The launch plan of an f32 trunk is one the kernel serves: fc1 reads the
// 64 PE rows of act alone, every later layer reads the previous layer's
// output and, the skip layer, the PE rows after it; the weights lie one
// layer after the other in the ring copy.
bool valid_f32_plan(const long long* plan, int n_layers, int out_cols,
                    int width) {
  if (n_layers < 1 || n_layers > kMaxLayers || out_cols < 1 || width < 128 ||
      width % 128 || width > kMaxWidthF32)
    return false;
  long long prev_n = 0, w_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kF32Fields;
    const long long K = f[F_K], N = f[F_N], pe = f[F_PE];
    if (K < kKs || K % kKs || N < 128 || N % 128 || N > width || !f[F_B] ||
        f[F_W] != w_off)
      return false;
    if (l == 0 ? (K != 64 || f[F_IN] != width || pe != 0)
               : (f[F_IN] != 0 || (pe < 0 ? K != prev_n
                                          : (pe != width || prev_n != width ||
                                             K != width + 64))))
      return false;
    prev_n = N;
    w_off += K * N;
  }
  return out_cols <= prev_n;
}

template <int ROWS, int KS>
int launch_f32(F32Params p, int max_n, int fast_sine, cudaStream_t stream) {
  void (*kernel)(F32Params) = fast_sine ? trunk_f32<ROWS, true, KS>
                                        : trunk_f32<ROWS, false, KS>;
  p.slot_floats = KS * max_n;
  const int act = (((p.width + 64) * (ROWS + kPadRows) + 31) & ~31) * 4;
  const int smem = act + kSlotsF32 * p.slot_floats * 4;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.rows + ROWS - 1) / ROWS, kThreadsF32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The launch plan of a bf16 trunk is one the kernel serves: fc1 reads the
// PE chunk alone, every later layer reads all of the previous layer's
// output chunks and, the skip layer, the PE chunk after them.
// Its widest layer selects the instance: trunk_bf16 up to kMaxWidth,
// trunk_bf16_wide up to kMaxWidthWide.
int plan_width(const long long* plan, int n_layers) {
  long long w = 0;
  for (int l = 0; l < n_layers; ++l)
    w = w > plan[(size_t)l * kPlanFields + P_N]
            ? w : plan[(size_t)l * kPlanFields + P_N];
  return (int)w;
}

bool valid_plan(const long long* plan, int n_layers, int out_cols) {
  if (n_layers < 1 || n_layers > kMaxLayers || out_cols < 1) return false;
  long long prev_n = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kPlanFields;
    const long long K = f[P_K], N = f[P_N], pe = f[P_PE_CHUNK];
    if (K < 64 || K % 64 || N < kSlotRows || N % kSlotRows ||
        N > kMaxWidthWide || f[P_BOX_K] != 64 || f[P_BOX_N] != kBoxRows ||
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
  if (rows < 1 || !valid_plan(plan, n_layers, out_cols))
    return (int)cudaErrorInvalidValue;
  const bool wide = plan_width(plan, n_layers) > kMaxWidth;
  void (*kernel)(Bf16Params) =
      wide ? (fast_sine ? trunk_bf16_wide<true> : trunk_bf16_wide<false>)
           : (fast_sine ? trunk_bf16<true> : trunk_bf16<false>);
  const int smem = wide ? kSmemWide : kSmemBf16;
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
  // one tile a CTA (wide: a cluster), the grid in whole clusters
  const int tiles = (rows + kRows - 1) / kRows;
  const dim3 grid(wide ? tiles * kCluster
                       : (tiles + kCluster - 1) / kCluster * kCluster);
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreadsBf16, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches the f32 kernel on `stream` over the weights' ring copy `ring`
// with the plan FoldedTrunk.f32_plan built (kF32Fields int64 a layer);
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// plan the kernel does not serve.
int trunk_f32_launch(const long long* plan, int n_layers, const float* ring,
                     const float* pe, float* out, int rows, int out_cols,
                     int width, int fast_sine, void* stream) {
  if (rows < 1 || !ring || !valid_f32_plan(plan, n_layers, out_cols, width))
    return (int)cudaErrorInvalidValue;
  F32Params p;
  memset(&p, 0, sizeof(p));
  int max_n = 0;
  for (int l = 0; l < n_layers; ++l) {
    const long long* f = plan + (size_t)l * kF32Fields;
    p.layers[l].bias = reinterpret_cast<const float*>(f[F_B]);
    p.layers[l].w = ring + f[F_W];
    p.layers[l].k = (int)f[F_K];
    p.layers[l].n = (int)f[F_N];
    p.layers[l].in_k = (int)f[F_IN];
    max_n = max_n > (int)f[F_N] ? max_n : (int)f[F_N];
  }
  p.n_layers = n_layers;
  p.pe = pe;
  p.out = out;
  p.rows = rows;
  p.out_cols = out_cols;
  p.width = width;
  const cudaStream_t st = (cudaStream_t)stream;
  if (width <= kWideRows) return launch_f32<64, kKs>(p, max_n, fast_sine, st);
  if (width <= kMaxWidthF32Ks8)
    return launch_f32<32, kKs>(p, max_n, fast_sine, st);
  return launch_f32<32, kKsWide>(p, max_n, fast_sine, st);
}

}  // extern "C"
