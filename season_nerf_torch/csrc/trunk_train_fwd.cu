// K1: the training forward of T-NeRF's trunk with ghost BatchNorm.
//
// Replaces season_nerf_tpu/ops/pallas_train.py::_fwd_kernel (trunk_fwd):
// fc1 .. fcN + fc9 with omega folded into the packed bf16 weights, the
// skip layer's split matmul over [h | PE], BatchNorm on every layer but
// the first with the mean and biased variance of each `tile` rows, sine
// (K0 or sinf), then the packed [enc, 8] sigma/color heads in f32, and the
// sums over tiles of the per-tile means and variances.  The plain version
// is season_nerf_torch/ops/fused_train.py::trunk_fwd_reference.
//
// Bound (H100 SXM): compute.  At width 512 a point costs 2.03 M
// multiply-adds; at the flagship's 393,216 points that is 1.60 TFLOP, 1.62
// ms at 989 TFLOP/s bf16, against 0.08 ms for its own HBM bytes (PE 50 MB,
// x_enc 201 MB, heads 13 MB).  The layer-major design sets its own floor:
// each layer's f32 z goes to HBM and back (about 2.4 GB a layer with the
// activations, about 6.5 ms a pass at 3.35 TB/s).  So each layer's GEMM is
// bound by its bytes, the f32 z write (0.36 ms against 0.21 ms of
// operations at width 512); gemm_wgmma (TMA + wgmma, trunk_train_common.cuh)
// keeps its operations under those bytes.  The z round trips and the BN
// passes remain: a design that keeps a tile on chip (a CTA cluster sharing
// the tile's statistics) removes them.
//
// Design: trunk_train_common.cuh (one GEMM and one BN-sine kernel per
// layer, f32 z in scratch, deterministic sums).

#include "trunk_train_common.cuh"

using namespace tt;

extern "C" {

const char* trunk_train_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// layers: host int64 table (kFields per layer).  Writes each layer's act
// (the last one is x_enc), heads [rows, 8] f32 and stats [2 n_bn,
// stat_width] f32.  Launches on `stream`; returns 0 or a cudaError_t.
int trunk_train_fwd_launch(const long long* layers, int n_layers,
                           const void* pe, int pe_dim, int rows, int tile,
                           const void* wh, const float* bh, int head_w,
                           float* heads, float* stats, int stat_width,
                           int act_bf16, int fast_sine, void* stream) {
  Trunk tr;
  tr.layers = layers;
  tr.n_layers = n_layers;
  tr.pe = static_cast<const bf16*>(pe);
  tr.pe_dim = pe_dim;
  tr.rows = rows;
  tr.tile = tile;
  tr.n_tiles = tile > 0 ? rows / tile : 0;
  tr.act_bf16 = act_bf16;
  tr.fast_sine = fast_sine;
  tr.stream = static_cast<cudaStream_t>(stream);
  if (!valid_trunk(tr) || head_w < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = run_forward(tr);
  if (err != cudaSuccess) return (int)err;

  const int L = n_layers - 1;
  const int enc = (int)fld(tr, L, F_N);
  err = gemm(reinterpret_cast<const void*>(fld(tr, L, F_ACT)), act_bf16,
             true, enc, wh, 1, false, head_w, heads, head_w, bh, rows,
             head_w, enc, 0, false, nullptr, 0, tr.stream);
  if (err != cudaSuccess) return (int)err;

  int n_bn = 0;
  for (int l = 0; l < n_layers; ++l) n_bn += fld(tr, l, F_GAMMA) != 0;
  for (int l = 0, k = 0; l < n_layers; ++l) {
    if (!fld(tr, l, F_GAMMA)) continue;
    const int W = (int)fld(tr, l, F_N);
    const int blocks = (stat_width + 255) / 256;
    sum_tiles<<<blocks, 256, 0, tr.stream>>>(
        ptr<const float>(tr, l, F_MU), tr.n_tiles, W,
        stats + (size_t)k * stat_width, stat_width);
    sum_tiles<<<blocks, 256, 0, tr.stream>>>(
        ptr<const float>(tr, l, F_VAR), tr.n_tiles, W,
        stats + (size_t)(n_bn + k) * stat_width, stat_width);
    ++k;
  }
  return (int)cudaGetLastError();
}

// The bf16 GEMM of K1 and K2 alone, for tests and measurements (the main
// path runs it inside trunk_train_fwd_launch and trunk_train_bwd_launch):
// C[M, N] (+)= A . B (+ bias), A(m, k) = a_kc ? A[m lda + k] : A[k lda + m],
// B(k, n) = b_kc ? B[n ldb + k] : B[k ldb + n], both bf16, C f32; `split`
// splits K through ws (ws_floats long).  Returns 0 or a cudaError_t.
int trunk_train_gemm_launch(const void* A, int a_kc, long long lda,
                            const void* B, int b_kc, long long ldb, float* C,
                            long long ldc, const float* bias, int M, int N,
                            int K, int accumulate, int split, float* ws,
                            long long ws_floats, void* stream) {
  return (int)gemm(A, 1, a_kc != 0, lda, B, 1, b_kc != 0, ldb, C, ldc, bias,
                   M, N, K, accumulate, split != 0, ws, ws_floats,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
