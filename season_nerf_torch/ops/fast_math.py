"""The polynomial sine and cosine (K0), plain PyTorch.

One round-to-nearest reduction by 2*pi, then an odd polynomial:

  fast_sin(x) = y * P(y^2),  y = x - 2*pi * rint(x / (2*pi))
  fast_cos(x) = fast_sin(x + pi/2)

``POLYS`` holds the odd polynomials of degree 11, 9 and 7 of
``season_nerf_tpu/ops/fast_math.py`` (max abs error against sin on
[-pi, pi]: 1.9e-7, 1.2e-5, 5.0e-4); the reduction adds about
|k| * 2.8e-7 for |x| ~ k * 2*pi.  ``FAST_SIN_DEGREE`` in the environment
selects one when this module is imported, as in the JAX package; degree 11
is the default.  The same arithmetic runs inside the CUDA trunk kernels
(``csrc/fast_sin.cuh``), built at the selected degree
(``ops/cuda_build``).

As in the JAX package, the derivative of one is the other, not the autograd
of the polynomial: d fast_sin = fast_cos, d fast_cos = -fast_sin
(:class:`FastSin`, :class:`FastCos`).  Each backward is the span
``siren.sine`` (``utils/trace``), as the forward is in ``SineLayer``.
"""

from __future__ import annotations

import os

import torch

from season_nerf_torch.utils import trace

TWO_PI = 6.283185307179586
INV_TWO_PI = 0.15915494309189535
HALF_PI = 1.5707963267948966

# highest power first: P(t) = ((c0 t + c1) t + ...) t + c_last
POLYS = {
    11: (
        -2.069411010213876e-08,
        2.7087317655524043e-06,
        -0.00019817545051422297,
        0.008332788468806916,
        -0.1666662073313615,
        0.9999999370777358,
    ),
    9: (
        2.1981251565810912e-06,
        -0.00019376590195087698,
        0.008317245437921708,
        -0.16664703189391347,
        0.9999961520005721,
    ),
    7: (
        -0.00015037665051068376,
        0.008049598721057115,
        -0.16611871845097342,
        0.999833206854273,
    ),
}
_DEGREE = os.environ.get("FAST_SIN_DEGREE", "11")
if _DEGREE not in {str(d) for d in POLYS}:
    raise ValueError(
        f"FAST_SIN_DEGREE={_DEGREE!r}: valid degrees are {sorted(POLYS)}")
DEGREE = int(_DEGREE)
POLY = POLYS[DEGREE]


def reduce_two_pi(x: torch.Tensor) -> torch.Tensor:
    return x - TWO_PI * torch.round(x * INV_TWO_PI)


def poly_sin(y: torch.Tensor) -> torch.Tensor:
    t = y * y
    p = torch.full_like(t, POLY[0])
    for c in POLY[1:]:
        p.mul_(t).add_(c)               # in place: p is this call's own
    return y * p


def _sin(x):
    return poly_sin(reduce_two_pi(x))


def _cos(x):
    return poly_sin(reduce_two_pi(x + HALF_PI))


class FastSin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sin(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with trace.span("siren.sine"):
            return FastCos.apply(x) * g


class FastCos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _cos(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with trace.span("siren.sine"):
            return -FastSin.apply(x) * g


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) to f32 accuracy for |x| up to ~1e3 (one-round reduction) at
    degree 11; to the selected polynomial's accuracy at 9 or 7."""
    return FastSin.apply(x)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) as the same polynomial a quarter period on."""
    return FastCos.apply(x)
