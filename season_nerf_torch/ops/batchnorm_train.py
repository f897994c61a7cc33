"""The full-batch BatchNorm of a training ``SineLayer`` in bf16, with its
sine: one ``torch.autograd.Function`` whose forward and backward are
hand-written CUDA (``csrc/batchnorm_train.cu`` and the folded launches of
``csrc/fast_sine.cu``), and its plain version.

The layer's function is ``models/siren.py``'s ``bn_train`` followed by the
polynomial sine and the cast to bf16: flax's batch statistics (the mean and
the fast variance ``max(0, E[z^2] - E[z]^2)``, eps 1e-5), the running
statistics updated in place with momentum 0.99 and the biased variance,
and ``(z - mean) * mul + shift`` in flax's order, ``mul = rsqrt(var + eps)
* scale``.  On a card, a step of the layer is

- forward: one pass over the bf16 z that writes the float32 z and the
  column sums of z and z^2, merged in a fixed order, which also finishes
  the statistics (span ``siren.batchnorm``); then one launch of the sine
  with the normalisation folded in (span ``siren.sine``);
- backward: one launch of the sine's backward that also takes the column
  sums ``a = sum du`` and ``b = sum du * xhat`` (span ``siren.sine``); then
  one pass for ``dz = mul * (du - a / N - xhat * b / N)`` in bf16, the
  variance's term dropped in a column whose fast variance was clamped, as
  the clamp's gradient drops it (span ``siren.batchnorm_bwd``).

The folded launches (:func:`sine_bn_fwd`, :func:`sine_bn_bwd`) are the
sine's kernel's own, with each column's ``(x - mean) * mul + shift`` taken
before the polynomial: they move the plain variants' bytes (float32 x,
bf16 y; float32 x, bf16 g, float32 dx) and are no operators, so that the
exported programs and the plain versions keep ``season_nerf::fast_sine``
and ``fast_sine_grad``.  The columns' statistics they take are this
module's ``[5, C]`` layout (see ``_plain_stats``).

It saves the float32 z and the columns' statistics (autograd of
``bn_train`` also saves ``z - mean`` and the sine's float32 input).

:func:`batch_stats` is flax's batch statistics, the one copy that both
``models/siren.py``'s ``bn_train`` and the plain version take.  Under a
training mesh the statistics are the global batch's: one all-reduce of
``[sum z, sum z^2, rows]`` forward (``parallel/mesh.py``), then the
finish; one of ``[a, b]`` backward.  The gradients returned for the scale
and shift are the rank's own ``b`` and ``a``:
``parallel.mesh.all_reduce_grads`` sums them over the ranks afterwards, as
it does autograd's.

The kernels take every bf16 [rows, C] z on a card, any C (8 columns a
thread where C is a multiple of 8, one elsewhere); ``models/siren.py``
sends every such training layer here, and every float32 or CPU one through
``bn_train``.  ``plain=True`` runs the plain version (``_plain_stats``,
``_plain_sine``, ``_plain_sine_grad``, ``_plain_dz``), the same arithmetic
in PyTorch passes on any device: the tests hold the kernels to it on the
card and it to autograd of ``bn_train`` on the CPU.
The column-sum and dz launches count as ``batchnorm.launches``
(``utils/trace``): 16 and 8 in a default training step; the folded sine's
as ``fast_sine.launches``, with the sine's own (16 forward and 8 backward
in a default step).
"""

from __future__ import annotations

import ctypes

import torch

from season_nerf_torch.ops import fast_math as fm
from season_nerf_torch.ops.cuda_build import Library
from season_nerf_torch.parallel.mesh import all_reduce_sum
from season_nerf_torch.utils import trace

BN_EPS = 1e-5
BN_MOMENTUM = 0.99      # flax's; torch's BatchNorm1d momentum 0.01
MAX_WIDTH = 65535 * 256     # csrc/columns.cuh: 65,535 slabs of 256 columns

KERNEL = "batchnorm_train"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
LIB = Library(KERNEL, {
    "bn_stats_blocks": (_L, _I),
    "bn_stats_launch": (_P,) * 8 + (_L, _I, _I, _F, _F, _F, _P),
    "bn_finish_launch": (_P,) * 5 + (_I, _F, _F, _F, _P),
    "bn_dz_launch": (_P,) * 5 + (_L, _I, _P)})
# the sine's folded launches, in csrc/fast_sine.cu beside its own
SINE_LIB = Library(fm.KERNEL, {
    "fast_sine_bwd_bn_blocks": (_L, _I),
    "fast_sine_fwd_bn_launch": (_P,) * 4 + (_L, _I, _P),
    "fast_sine_bwd_bn_launch": (_P,) * 7 + (_L, _I, _I, _P)})


def _check(z, *params):
    """Raise unless the kernels take ``z`` and the float32 [C] ``params``
    on its card."""
    if not (z.is_cuda and z.dtype == torch.bfloat16 and z.dim() == 2
            and z.shape[0] > 0 and 0 < z.shape[1] <= MAX_WIDTH):
        raise ValueError(f"the BatchNorm kernels take a bf16 CUDA [rows, C] "
                         f"z, rows and C above 0, C up to {MAX_WIDTH}, got "
                         f"{z.dtype} {tuple(z.shape)} on {z.device}")
    for p in params:
        if (p.dtype != torch.float32 or p.shape != (z.shape[1],)
                or p.device != z.device or not p.is_contiguous()):
            raise ValueError(f"the BatchNorm kernels take float32 contiguous "
                             f"[{z.shape[1]}] parameters and statistics on "
                             f"{z.device}, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")


def update_running(running_mean, running_var, mean, var):
    """running = 0.99 running + 0.01 batch, in place (flax's momentum;
    ``var`` the biased variance)."""
    with torch.no_grad():
        keep = BN_MOMENTUM
        running_mean.copy_(keep * running_mean + (1 - keep) * mean)
        running_var.copy_(keep * running_var + (1 - keep) * var)


def batch_stats(z, mesh):
    """-> (mean, E[z^2] - E[z]^2, N) of the [rows, C] ``z`` over the global
    batch of N rows, differentiable: flax's statistics before the fast
    variance's clamp at 0, which the caller takes.  Without a mesh N is
    this process's rows, an int."""
    if mesh is None:
        n = z.shape[0]
        mean = z.mean(0)
        sq = torch.mean(z * z, 0)
    else:
        c = z.shape[1]
        sums = all_reduce_sum(torch.cat(
            [z.sum(0), (z * z).sum(0), z.new_full((1,), z.shape[0])]), mesh)
        n = sums[-1]
        mean, sq = sums[:c] / n, sums[c:2 * c] / n
    return mean, sq - mean * mean, n


# --- the plain version ------------------------------------------------------
# stats is [5, C]: mean, rstd, mul, rstd where the fast variance was not
# clamped (else 0), and 1 / N, N the global batch's rows
def _plain_stats(z, scale, running_mean, running_var, mesh):
    """-> (the float32 z, stats), ``bn_train``'s arithmetic; the running
    statistics updated."""
    zf = z.float()
    mean, d, n = batch_stats(zf, mesh)
    var = torch.clamp(d, min=0.0)
    update_running(running_mean, running_var, mean, var)
    rstd = torch.rsqrt(var + BN_EPS)
    inv_n = 1 / torch.as_tensor(n, dtype=zf.dtype, device=zf.device)
    return zf, torch.stack([mean, rstd, rstd * scale,
                            torch.where(d >= 0, rstd, 0.0),
                            inv_n.expand_as(mean)])


def _plain_sine(zf, stats, shift):
    """bf16 fast_sin((z - mean) * mul + shift)."""
    return fm.plain_sin((zf - stats[0]) * stats[2] + shift).to(torch.bfloat16)


def _plain_sine_grad(zf, g, stats, shift):
    """-> (du = g * fast_cos(the sine's argument), [sum du; sum du *
    xhat])."""
    mean, rstd, mul = stats[:3]
    t = zf - mean
    du = fm.plain_cos(t * mul + shift) * g.float()
    return du, torch.stack([du.sum(0), (du * (t * rstd)).sum(0)])


def _plain_dz(zf, du, stats, ab):
    mean, _, mul, rstd_v, inv_n = stats
    a, b = ab
    dz = mul * (du - a * inv_n - ((zf - mean) * rstd_v) * (b * inv_n))
    return dz.to(torch.bfloat16)


# --- the kernels ------------------------------------------------------------
def dense(t):
    """``t``, or a copy of it, contiguous and 16-byte aligned, as the
    kernels' vector loads take it."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _blocks(lib, fn, x):
    """The partial rows of the column sums of the [rows, C] ``x``."""
    with torch.cuda.device(x.device):   # the grid fills x's card
        blocks = lib.call(fn, x.numel(), x.shape[1])
    if blocks <= 0:
        raise RuntimeError(f"{fn}: no grid for {x.shape[0]} x {x.shape[1]}")
    return blocks


def _kernel_stats(z, scale, running_mean, running_var, mesh):
    z = dense(z)
    c = z.shape[1]
    dev = z.device
    blocks = _blocks(LIB, "bn_stats_blocks", z)
    zf = torch.empty(z.shape, dtype=torch.float32, device=dev)
    part = zf.new_empty((blocks, 2, c))
    stats = zf.new_empty((5, c))
    consts = (BN_MOMENTUM, 1 - BN_MOMENTUM, BN_EPS)
    sums = None if mesh is None else zf.new_empty(2 * c + 1,
                                                  dtype=torch.float64)
    LIB.launch("bn_stats_launch", dev, z, zf, part, sums, stats, scale,
               running_mean, running_var, z.numel(), c, blocks, *consts,
               counter="batchnorm.launches")
    if mesh is not None:
        LIB.launch("bn_finish_launch", dev, all_reduce_sum(sums, mesh),
                   stats, scale, running_mean, running_var, c, *consts)
    return zf, stats


def sine_bn_fwd(x, stats, beta):
    """bf16 fast_sin((x - mean) * mul + beta), column by column, of the
    float32 [rows, C] ``x``: one launch."""
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    SINE_LIB.launch("fast_sine_fwd_bn_launch", x.device, x, y, stats, beta,
                    x.numel(), x.shape[1], counter="fast_sine.launches")
    return y


def sine_bn_bwd(x, g, stats, beta):
    """-> (du, ab): du = g * fast_cos((x - mean) * mul + beta) in float32
    (g bf16), and ab = [sum du; sum du * xhat] of each column, xhat = (x -
    mean) * rstd, merged in a fixed order: one launch (a pass and the
    merge of its partial sums)."""
    c = x.shape[1]
    blocks = _blocks(SINE_LIB, "fast_sine_bwd_bn_blocks", x)
    du = torch.empty_like(x)
    part = x.new_empty((blocks, 2, c))
    ab = x.new_empty((2, c))
    SINE_LIB.launch("fast_sine_bwd_bn_launch", x.device, x, dense(g), du,
                    part, ab, stats, beta, x.numel(), c, blocks,
                    counter="fast_sine.launches")
    return du, ab


def _kernel_sine_grad(zf, g, stats, shift):
    if g.dtype != torch.bfloat16 or g.shape != zf.shape:
        raise ValueError(f"the BatchNorm kernels take a bf16 gradient of "
                         f"shape {tuple(zf.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    return sine_bn_bwd(zf, g, stats, shift)


def _kernel_dz(zf, du, stats, ab):
    dz = torch.empty(zf.shape, dtype=torch.bfloat16, device=zf.device)
    LIB.launch("bn_dz_launch", zf.device, zf, du, dz, stats, ab, zf.numel(),
               zf.shape[1], counter="batchnorm.launches")
    return dz


_PLAIN = (_plain_stats, _plain_sine, _plain_sine_grad, _plain_dz)
_KERNELS = (_kernel_stats, sine_bn_fwd, _kernel_sine_grad, _kernel_dz)


class BatchNormSine(torch.autograd.Function):
    """bf16 sin(BatchNorm(z)) of a training layer from its bf16 z [rows,
    C], the norm's scale and shift, its running statistics (updated in
    place), the mesh (None: this process's rows are the batch), and
    ``plain`` (the plain version in place of the kernels)."""

    @staticmethod
    def forward(ctx, z, scale, shift, running_mean, running_var, mesh,
                plain):
        if not plain:
            _check(z, scale, shift, running_mean, running_var)
        stats_of, sine = (_PLAIN if plain else _KERNELS)[:2]
        with trace.span("siren.batchnorm"):
            zf, stats = stats_of(z, scale, running_mean, running_var, mesh)
        with trace.span("siren.sine"):
            y = sine(zf, stats, shift)
        ctx.save_for_backward(zf, stats, shift)
        ctx.mesh, ctx.plain = mesh, plain
        return y

    @staticmethod
    def backward(ctx, g):
        zf, stats, shift = ctx.saved_tensors
        sine_grad, dz_of = (_PLAIN if ctx.plain else _KERNELS)[2:]
        with trace.span("siren.sine"):
            du, local = sine_grad(zf, g, stats, shift)
        dz = None
        if ctx.needs_input_grad[0]:
            with trace.span("siren.batchnorm_bwd"):
                dz = dz_of(zf, du, stats, all_reduce_sum(local, ctx.mesh))
        # this rank's sums: all_reduce_grads adds the ranks' afterwards
        return dz, local[1], local[0], None, None, None, None


def batchnorm_sine(z: torch.Tensor, norm: torch.nn.BatchNorm1d, mesh=None,
                   plain: bool = False) -> torch.Tensor:
    """The layer's bf16 activation from its bf16 z, in training mode: the
    kernels, or (``plain``) the plain version."""
    return BatchNormSine.apply(z, norm.weight, norm.bias, norm.running_mean,
                               norm.running_var, mesh, plain)
