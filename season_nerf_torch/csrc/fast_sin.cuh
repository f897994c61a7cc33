// K0: the degree-11 polynomial sine and cosine, device functions.
//
// Replaces season_nerf_tpu/ops/fast_math.py::_poly_sin(_reduced(x)) (the
// TPU kernels inline it) and the cosine of pallas_train.py::_cos.  One
// round-to-nearest reduction by 2*pi, then y * P5(y^2) with the
// coefficients of season_nerf_torch/ops/fast_math.py; the cosine is the
// sine a quarter period on.  The reduction is written with _rn intrinsics
// so that nvcc cannot contract it into an FMA: it then rounds like the
// plain PyTorch version (for |x| ~ 1e3 the unrounded product would move y
// by up to 3e-5).
#pragma once

__device__ __forceinline__ float fast_sin(float x) {
  const float kTwoPi = 6.283185307179586f;
  const float kInvTwoPi = 0.15915494309189535f;
  const float k = rintf(__fmul_rn(x, kInvTwoPi));
  const float y = __fsub_rn(x, __fmul_rn(kTwoPi, k));
  const float t = __fmul_rn(y, y);
  float p = -2.069411010213876e-08f;
  p = fmaf(p, t, 2.7087317655524043e-06f);
  p = fmaf(p, t, -0.00019817545051422297f);
  p = fmaf(p, t, 0.008332788468806916f);
  p = fmaf(p, t, -0.1666662073313615f);
  p = fmaf(p, t, 0.9999999370777358f);
  return y * p;
}

__device__ __forceinline__ float fast_cos(float x) {
  return fast_sin(__fadd_rn(x, 1.5707963267948966f));
}
