"""The polynomial sine and cosine (K0): the plain version, and the
operators that launch it alone on a card.

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

:func:`fast_sin` and :func:`fast_cos` call the operators
``season_nerf::fast_sine`` and, for the gradient,
``season_nerf::fast_sine_grad`` (:func:`sine_op`, :func:`sine_grad_op`):
for a CPU tensor the plain version (``reduce_two_pi`` and ``poly_sin``, a
chain of elementwise passes); for a CUDA tensor one launch of
``csrc/fast_sine.cu`` a direction, or an error.  On the card the value is
K0's, the FMA Horner chain of K1/K2/K3: within about an ulp of the plain
chain, which rounds after every product and sum.  A bf16 result is cast in
the same launch, the same round-to-nearest-even as ``.to(torch.bfloat16)``.
``launches`` counts the kernel's launches (``utils/trace`` reads it as
``fast_sine.launches``).  The plain versions of K1/K2/K3, the references
the card's checks hold those kernels to, call :func:`plain_sin` and
:func:`plain_cos` on every device: they share no code with K0 on the card.

As in the JAX package, the derivative of one is the other, not the autograd
of the polynomial: d fast_sin = fast_cos, d fast_cos = -fast_sin, to any
order.  Each backward is the span ``siren.sine`` (``utils/trace``), as the
forward is in ``SineLayer``.

:func:`sine_bn_fwd` and :func:`sine_bn_bwd` are the folded variant, for a
training ``SineLayer`` with BatchNorm in bf16 on a card
(``ops/batchnorm_train``, which holds their plain version): the kernel's
own launches with each column's ``(x - mean) * mul + shift`` taken before
the polynomial, the backward also summing ``du`` and ``du * xhat`` by
column.  They move the plain variants' bytes (float32 x, bf16 y; float32
x, bf16 g, float32 dx), count in ``launches``, and are no operators: the
exported programs and the plain versions keep ``season_nerf::fast_sine``
and ``fast_sine_grad``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

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


def plain_sin(x):
    """The plain version of fast_sin: a chain of elementwise passes on any
    device, with no autograd of its own (the plain K1/K2/K3 call it)."""
    return poly_sin(reduce_two_pi(x))


def plain_cos(x):
    return poly_sin(reduce_two_pi(x + HALF_PI))


# The operators every fast sine goes through: SineLayer and an exported
# render program (tools/export_render.py) record and call the same two.  ``sine_op`` is fast_sin(x), or fast_cos(x)
# when ``cosine``, cast to bf16 when ``bf16``; ``sine_grad_op`` is its
# gradient g * fast_cos(x), or -g * fast_sin(x), in x's dtype.  The CPU
# implementations are the plain version above; the CUDA ones launch
# ``csrc/fast_sine.cu`` or raise; the fake ones give shape and dtype.
@torch.library.custom_op("season_nerf::fast_sine", mutates_args=())
def sine_op(x: torch.Tensor, cosine: bool, bf16: bool) -> torch.Tensor:
    y = plain_cos(x) if cosine else plain_sin(x)
    return (y.to(torch.bfloat16) if bf16 else y).contiguous()


@sine_op.register_fake
def _sine_op_fake(x, cosine, bf16):
    return x.new_empty(x.shape, dtype=torch.bfloat16 if bf16 else x.dtype)


@torch.library.custom_op("season_nerf::fast_sine_grad", mutates_args=())
def sine_grad_op(x: torch.Tensor, g: torch.Tensor,
                 cosine: bool) -> torch.Tensor:
    slope = -plain_sin(x) if cosine else plain_cos(x)
    return (slope * g).to(x.dtype).contiguous()


@sine_grad_op.register_fake
def _sine_grad_op_fake(x, g, cosine):
    return x.new_empty(x.shape)


def _save_x(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])
    ctx.cosine = inputs[1]


def _sine_backward(ctx, g):
    (x,) = ctx.saved_tensors
    with trace.span("siren.sine"):
        return sine_grad_op(x, g, ctx.cosine), None, None


def _save_x_g(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], inputs[1])
    ctx.cosine = inputs[2]


def _sine_grad_backward(ctx, gg):
    """Of g * D(x) (D = fast_cos, or -fast_sin): gg * D(x) for g, and
    gg * g * D'(x) = -(gg * g) * fast_sin(x) (or fast_cos(x)) for x."""
    x, g = ctx.saved_tensors
    return (-(gg * g) * sine_op(x, ctx.cosine, False),
            sine_grad_op(x, gg, ctx.cosine).to(g.dtype), None)


sine_op.register_autograd(_sine_backward, setup_context=_save_x)
sine_grad_op.register_autograd(_sine_grad_backward, setup_context=_save_x_g)

launches = 0            # of csrc/fast_sine.cu, both directions
_lock = threading.Lock()
KERNEL = "fast_sine"


def _library():
    from season_nerf_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL)
    if lib.fast_sine_fwd_launch.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fast_sine_fwd_launch.argtypes = [P, P, L, I, I, P]
        lib.fast_sine_bwd_launch.argtypes = [P, P, P, L, I, I, P]
        lib.fast_sine_fwd_launch.restype = I
        lib.fast_sine_bwd_launch.restype = I
        lib.fast_sine_fwd_bn_launch.argtypes = [P, P, P, P, L, I, P]
        lib.fast_sine_bwd_bn_launch.argtypes = [P, P, P, P, P, P, P, L, I, I,
                                                P]
        lib.fast_sine_bwd_bn_blocks.argtypes = [L, I]
        for fn in (lib.fast_sine_fwd_bn_launch, lib.fast_sine_bwd_bn_launch,
                   lib.fast_sine_bwd_bn_blocks):
            fn.restype = I
        lib.fast_sine_error_string.argtypes = [I]
        lib.fast_sine_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, x, *tensors, flags):
    """One launch of ``fast_sine_<name>_launch`` over the n elements of the
    contiguous ``x`` on its card's current stream: x's pointer, then those
    of ``tensors``, n, ``flags`` and the stream."""
    lib = _library()
    with torch.cuda.device(x.device):   # launch on the tensors' card
        err = getattr(lib, f"fast_sine_{name}_launch")(
            x.data_ptr(), *(t.data_ptr() for t in tensors), x.numel(),
            *flags, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_sine {name} launch failed: "
                           f"{lib.fast_sine_error_string(err).decode()}")
    global launches
    with _lock:                         # frames in flight on threads
        launches += 1


def _check(x, g=None):
    """Raise unless the kernel takes ``x`` (and the gradient ``g``)."""
    if x.dtype != torch.float32:
        raise ValueError(f"the fast sine kernel takes a float32 x, got "
                         f"{x.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the fast sine kernel takes fewer than 2^31 "
                         f"elements, got {x.numel()}")
    if g is not None and (g.dtype not in (torch.float32, torch.bfloat16)
                          or g.shape != x.shape or g.device != x.device):
        raise ValueError(f"the fast sine kernel takes a float32 or bf16 "
                         f"gradient of x's shape {tuple(x.shape)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


@sine_op.register_kernel("cuda")
def _sine_op_cuda(x, cosine, bf16):
    _check(x)
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=torch.bfloat16 if bf16 else x.dtype,
                    device=x.device)
    if x.numel():
        _launch("fwd", x, y, flags=(int(cosine), int(bf16)))
    return y


@sine_grad_op.register_kernel("cuda")
def _sine_grad_op_cuda(x, g, cosine):
    _check(x, g)
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        _launch("bwd", x, g, dx,
                flags=(int(cosine), int(g.dtype == torch.bfloat16)))
    return dx


# The folded launches of a training SineLayer's BatchNorm
# (ops/batchnorm_train.py holds their plain version and their checks): x
# the float32 z [rows, C], stats its columns' statistics ([5, C]: mean,
# rstd, mul, ...), beta the BatchNorm's shift.
def sine_bn_fwd(x, stats, beta):
    """bf16 fast_sin((x - mean) * mul + beta), column by column: one
    launch."""
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    _launch("fwd_bn", x, y, stats, beta, flags=(x.shape[1],))
    return y


def sine_bn_bwd(x, g, stats, beta):
    """-> (du, ab): du = g * fast_cos((x - mean) * mul + beta) in float32
    (g bf16), and ab = [sum du; sum du * xhat] of each column, xhat = (x -
    mean) * rstd, merged in a fixed order: one launch (a pass and the
    merge of its partial sums)."""
    rows, c = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        blocks = lib.fast_sine_bwd_bn_blocks(x.numel(), c)
    if blocks <= 0:
        raise RuntimeError(f"fast_sine bwd_bn: no grid for {rows} x {c}")
    du = torch.empty_like(x)
    part = x.new_empty((blocks, 2, c))
    ab = x.new_empty((2, c))
    _launch("bwd_bn", x, dense(g), du, part, ab, stats, beta,
            flags=(c, blocks))
    return du, ab


def dense(t):
    """``t``, or a copy of it, contiguous and 16-byte aligned, as the
    folded launches' vector loads take it."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def fast_sin(x: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """sin(x) to f32 accuracy for |x| up to ~1e3 (one-round reduction) at
    degree 11; to the selected polynomial's accuracy at 9 or 7.  ``dtype``
    casts the result, in the same launch where it is bf16."""
    y = sine_op(x, False, dtype == torch.bfloat16)
    return y if dtype is None or y.dtype == dtype else y.to(dtype)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) as the same polynomial a quarter period on."""
    return sine_op(x, True, False)
