// K2: the training backward of T-NeRF's trunk with ghost BatchNorm.
//
// Replaces season_nerf_tpu/ops/pallas_train.py::_bwd_kernel (trunk_bwd).
// It recomputes K1's forward with K1's own device code (run_forward in
// trunk_train_common.cuh), so the forward it differentiates is K1's bit for
// bit, keeping each layer's input and its f32 normalised pre-activation zh.
// Then, from the top down:
//   - the packed heads: d_wh = x_enc^T . d_heads, d_bh = sum d_heads,
//     da = f32(d_xenc) + g(d_heads) . wh^T   (g = the gradient type);
//   - each layer: bn_sine_bwd (dy = da cos y; d_gamma, d_beta; the ghost-BN
//     input gradient dz per tile; d_b), dz cast to the gradient type;
//     dW = a_in^T . dz, a reduction over the batch, split-K with an f32
//     workspace; da = dz . W^T for the layer below (the skip layer's h
//     rows only).
// Every sum over rows goes through per-tile (or per-split) partials and a
// fixed-order reduction, so the gradients are deterministic.  The plain
// version is season_nerf_torch/ops/fused_train.py::trunk_bwd_reference.
//
// Bound (H100 SXM): compute.  The recompute, dW and da are three times
// K1's 1.60 TFLOP at the flagship's 393,216 points: about 4.9 ms at 989
// TFLOP/s bf16.  Of its GEMMs (gemm_wgmma, TMA + wgmma), the recompute's and
// the input gradients' are bound by their f32 outputs (z, da); the weight
// gradients, split-K over the batch, read two bf16 operands of the batch's
// size for 1 MB of output and are nearly balanced.  The design keeps
// every layer's input and f32 zh in device memory (about 10 GB at the
// flagship) and moves each layer's f32 da and zh several times; the z round
// trips and the BN passes remain, and keeping a tile on chip is later work.

#include "trunk_train_common.cuh"

using namespace tt;

namespace {

template <typename TG>
cudaError_t bn_bwd(const Trunk& tr, int l, const float* da, TG* dz,
                   float* part, int part_w) {
  const int W = (int)fld(tr, l, F_N);
  const dim3 grid(tr.n_tiles, (W + 31) / 32);
  float* p_dgamma = part;
  float* p_dbeta = part + (size_t)tr.n_tiles * part_w;
  float* p_db = part + 2 * (size_t)tr.n_tiles * part_w;
  bn_sine_bwd<TG><<<grid, 256, 0, tr.stream>>>(
      ptr<const float>(tr, l, F_Z), da, W, tr.tile,
      ptr<const float>(tr, l, F_GAMMA), ptr<const float>(tr, l, F_BETA),
      ptr<const float>(tr, l, F_VAR), dz, p_dgamma, p_dbeta, p_db,
      tr.fast_sine);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_sum_tiles(p_db, tr.n_tiles, W, ptr<float>(tr, l, F_DB), W,
                         tr.stream);
  if (err == cudaSuccess && fld(tr, l, F_GAMMA)) {
    err = launch_sum_tiles(p_dgamma, tr.n_tiles, W,
                           ptr<float>(tr, l, F_DGAMMA), W, tr.stream);
    if (err == cudaSuccess)
      err = launch_sum_tiles(p_dbeta, tr.n_tiles, W,
                             ptr<float>(tr, l, F_DBETA), W, tr.stream);
  }
  return err;
}

}  // namespace

extern "C" {

const char* trunk_train_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// layers: host int64 table (kFields per layer) with F_SAVE_ZH = 1, one Z
// and one ACT buffer per layer, and the gradient outputs F_DW .. F_DBETA.
// d_xenc [rows, enc] in the gradient type, d_heads [rows, head_w] f32.
// Scratch: da f32 [rows, max width], dz [rows, max width] and dheads_g
// [rows, head_w] in the gradient type, part f32 [3, n_tiles, part_w], ws
// f32 (split-K workspace, ws_floats long).  Returns 0 or a cudaError_t.
int trunk_train_bwd_launch(const long long* layers, int n_layers,
                           const void* pe, int pe_dim, int rows, int tile,
                           const void* wh, int head_w, const void* d_xenc,
                           const float* d_heads, float* d_wh, float* d_bh,
                           int act_bf16, int grad_bf16, int fast_sine,
                           float* da, void* dz, void* dheads_g, float* part,
                           int part_w, float* ws, long long ws_floats,
                           void* stream) {
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
  if (!valid_trunk(tr) || head_w < 1 || part_w < head_w)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l)
    if (!fld(tr, l, F_SAVE_ZH) || fld(tr, l, F_N) > part_w)
      return (int)cudaErrorInvalidValue;
  const cudaStream_t s = tr.stream;
  cudaError_t err = run_forward(tr);
  if (err != cudaSuccess) return (int)err;

  // heads
  const int L = n_layers - 1;
  const int enc = (int)fld(tr, L, F_N);
  const void* xenc = reinterpret_cast<const void*>(fld(tr, L, F_ACT));
  err = gemm(xenc, act_bf16, false, enc, d_heads, 0, false, head_w, d_wh,
             head_w, nullptr, enc, head_w, rows, 0, true, ws, ws_floats, s);
  if (err != cudaSuccess) return (int)err;
  col_sum_tiles<<<dim3(tr.n_tiles, (head_w + 31) / 32), 256, 0, s>>>(
      d_heads, head_w, tile, part);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sum_tiles(part, tr.n_tiles, head_w, d_bh, head_w, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n_enc = (size_t)rows * enc;
  err = grad_bf16 ? launch_convert(static_cast<const bf16*>(d_xenc), da,
                                   n_enc, s)
                  : launch_convert(static_cast<const float*>(d_xenc), da,
                                   n_enc, s);
  if (err != cudaSuccess) return (int)err;
  const void* dh = d_heads;
  if (grad_bf16) {
    err = launch_convert(d_heads, static_cast<bf16*>(dheads_g),
                         (size_t)rows * head_w, s);
    if (err != cudaSuccess) return (int)err;
    dh = dheads_g;
  }
  err = gemm(dh, grad_bf16, true, head_w, wh, 1, true, head_w, da, enc,
             nullptr, rows, enc, head_w, 1, false, nullptr, 0, s);
  if (err != cudaSuccess) return (int)err;

  // the layers, top down
  for (int l = L; l >= 0; --l) {
    const int N = (int)fld(tr, l, F_N);
    const int kind = (int)fld(tr, l, F_KIND);
    err = grad_bf16 ? bn_bwd(tr, l, da, static_cast<bf16*>(dz), part, part_w)
                    : bn_bwd(tr, l, da, static_cast<float*>(dz), part,
                             part_w);
    if (err != cudaSuccess) return (int)err;
    float* dW = ptr<float>(tr, l, F_DW);
    if (kind == 0) {
      err = gemm(pe, 1, false, pe_dim, dz, grad_bf16, false, N, dW, N,
                 nullptr, pe_dim, N, rows, 0, true, ws, ws_floats, s);
      if (err != cudaSuccess) return (int)err;
      continue;
    }
    const void* h = reinterpret_cast<const void*>(fld(tr, l - 1, F_ACT));
    const int lw = (int)fld(tr, l - 1, F_N);
    err = gemm(h, act_bf16, false, lw, dz, grad_bf16, false, N, dW, N,
               nullptr, lw, N, rows, 0, true, ws, ws_floats, s);
    if (err == cudaSuccess && kind == 2)
      err = gemm(pe, 1, false, pe_dim, dz, grad_bf16, false, N,
                 dW + (size_t)lw * N, N, nullptr, pe_dim, N, rows, 0, true,
                 ws, ws_floats, s);
    if (err == cudaSuccess)
      err = gemm(dz, grad_bf16, true, N, ptr<const bf16>(tr, l, F_W), 1,
                 true, N, da, lw, nullptr, rows, lw, N, 0, false, nullptr, 0,
                 s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
