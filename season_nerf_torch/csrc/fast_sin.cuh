// K0: the polynomial sine and cosine, device functions.
//
// Replaces season_nerf_tpu/ops/fast_math.py::_poly_sin(_reduced(x)) (the
// TPU kernels inline it) and the cosine of pallas_train.py::_cos.  One
// round-to-nearest reduction by 2*pi, then y * P(y^2) in Horner form with
// the coefficients of season_nerf_torch/ops/fast_math.py::POLYS; the cosine
// is the sine a quarter period on.  The reduction is written with _rn
// intrinsics so that nvcc cannot contract it into an FMA: it then rounds
// like the plain PyTorch version (for |x| ~ 1e3 the unrounded product would
// move y by up to 3e-5).
//
// FAST_SIN_DEGREE (11, 9 or 7; 11 unless the build defines it, see
// ops/cuda_build.py) selects the odd polynomial at compile time, as the
// environment variable of the same name does for the JAX package and the
// plain versions.  Each degree is its own Horner chain: a lower degree is
// fewer FMAs, not the degree-11 chain with zero coefficients.
#pragma once

#ifndef FAST_SIN_DEGREE
#define FAST_SIN_DEGREE 11
#endif

__device__ __forceinline__ float fast_sin(float x) {
  const float kTwoPi = 6.283185307179586f;
  const float kInvTwoPi = 0.15915494309189535f;
  const float k = rintf(__fmul_rn(x, kInvTwoPi));
  const float y = __fsub_rn(x, __fmul_rn(kTwoPi, k));
  const float t = __fmul_rn(y, y);
#if FAST_SIN_DEGREE == 11
  float p = -2.069411010213876e-08f;
  p = fmaf(p, t, 2.7087317655524043e-06f);
  p = fmaf(p, t, -0.00019817545051422297f);
  p = fmaf(p, t, 0.008332788468806916f);
  p = fmaf(p, t, -0.1666662073313615f);
  p = fmaf(p, t, 0.9999999370777358f);
#elif FAST_SIN_DEGREE == 9
  float p = 2.1981251565810912e-06f;
  p = fmaf(p, t, -0.00019376590195087698f);
  p = fmaf(p, t, 0.008317245437921708f);
  p = fmaf(p, t, -0.16664703189391347f);
  p = fmaf(p, t, 0.9999961520005721f);
#elif FAST_SIN_DEGREE == 7
  float p = -0.00015037665051068376f;
  p = fmaf(p, t, 0.008049598721057115f);
  p = fmaf(p, t, -0.16611871845097342f);
  p = fmaf(p, t, 0.999833206854273f);
#else
#error "FAST_SIN_DEGREE must be 11, 9 or 7"
#endif
  return y * p;
}

__device__ __forceinline__ float fast_cos(float x) {
  return fast_sin(__fadd_rn(x, 1.5707963267948966f));
}
