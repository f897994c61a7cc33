"""SIREN layers: sin(BN(omega * (W x + b))).

The math and the cast points of ``season_nerf_tpu/models/siren.py``:

- ``dtype`` is the matmul dtype.  Under bfloat16 the input, weight and bias
  are cast to bf16, the product and the bias add are bf16, and
  ``z = omega * (...)`` is stored in bf16;
- BatchNorm (eps 1e-5) and sin run in float32, in flax's order:
  ``(z - mean) * (rsqrt(var + eps) * scale) + bias``;
- the activation is cast back to ``dtype``.

In training mode BatchNorm normalises with the batch statistics as flax
computes them: the mean, and the *fast* variance ``max(0, E[z^2] -
E[z]^2)``.  The running statistics are updated by hand with that biased
variance and flax's momentum 0.99 (``running = 0.99 running + 0.01
batch``); ``BatchNorm1d``'s own update, which uses the unbiased variance,
never runs.  The sine's gradient is the cosine (``ops/fast_math``: one
kernel launch a direction on a card, the cast to bf16 inside it).

A training layer with BatchNorm and the polynomial sine whose z is bf16
on a card, of any width, runs BatchNorm and sine as ``ops/batchnorm_train``'s
Function: hand-written kernels both ways, the normalisation folded into the
sine's launches.  Every other layer, and every CPU tensor, takes :meth:`SineLayer.bn_train` or
:meth:`SineLayer.bn_eval` and then the sine, with autograd's backward.

Spans (``utils/trace``): the BatchNorm forward is ``siren.batchnorm``, the
sine ``siren.sine`` both ways; the kernels' dz pass is
``siren.batchnorm_bwd``, and autograd's backward of ``bn_train`` lies under
no span.

Under a training mesh (``parallel/mesh.py``; the trainer sets the layer's
``mesh``) the statistics are those of the global batch, as GSPMD computes
them for the JAX package: one all-reduce of ``[sum z, sum z^2, rows]``,
then the same fast variance and the same running update, so the running
statistics stay identical on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from season_nerf_torch.ops import batchnorm_train
from season_nerf_torch.ops.batchnorm_train import BN_EPS, update_running
from season_nerf_torch.ops.fast_math import fast_sin
from season_nerf_torch.parallel.mesh import all_reduce_sum
from season_nerf_torch.utils import trace


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: promote everything to ``dtype``
    (float32 when None), then ``x @ W + b`` with a rounding after each op."""
    dt = dtype or torch.float32
    return x.to(dt) @ weight.to(dt).t() + bias.to(dt)


class SplitDense(nn.Linear):
    """``nn.Linear`` over ``[x, extra]`` without building the concatenation:
    ``x @ W[:, :in_x]^T + extra @ W[:, in_x:]^T + b`` (flax ``SplitDense``)."""

    def forward(self, x, extra=None, dtype=None):
        if extra is None:
            return dense(x, self.weight, self.bias, dtype)
        dt = dtype or torch.float32
        in_x = x.shape[-1]
        w = self.weight.to(dt)
        return (x.to(dt) @ w[:, :in_x].t() + extra.to(dt) @ w[:, in_x:].t()
                + self.bias.to(dt))


class Dense(nn.Linear):
    """A plain head layer computed in the network's ``dtype``."""

    def __init__(self, in_features, out_features, dtype=None):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.dtype)


class SineLayer(nn.Module):
    """sin(norm(omega_0 * (W x + b))).  ``norm`` is a ``BatchNorm1d``
    (momentum 0.01, the reference's) when ``use_norm``, used as the holder
    of its scale, shift and running statistics; its forward never runs."""

    def __init__(self, in_features, out_features, use_norm=False,
                 omega_0=30.0, dtype=None, fast_sine=False):
        super().__init__()
        self.omega_0 = omega_0
        self.dtype = dtype
        self.fast_sine = fast_sine
        self.linear = SplitDense(in_features, out_features)
        self.norm = (nn.BatchNorm1d(out_features, eps=BN_EPS, momentum=0.01)
                     if use_norm else None)
        self.mesh = None        # the training ranks' Mesh: global statistics

    def bn_eval(self, z: torch.Tensor) -> torch.Tensor:
        n = self.norm
        mul = torch.rsqrt(n.running_var.float() + BN_EPS) * n.weight.float()
        return (z - n.running_mean.float()) * mul + n.bias.float()

    def bn_train(self, z: torch.Tensor) -> torch.Tensor:
        """Batch statistics (flax's fast variance) of the global batch,
        and the running update in place."""
        n = self.norm
        if self.mesh is None:
            mean = z.mean(0)
            sq = torch.mean(z * z, 0)
        else:
            c = z.shape[1]
            sums = all_reduce_sum(torch.cat(
                [z.sum(0), (z * z).sum(0), z.new_full((1,), z.shape[0])]),
                self.mesh)
            mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(sq - mean * mean, min=0.0)
        update_running(n.running_mean, n.running_var, mean, var)
        mul = torch.rsqrt(var + BN_EPS) * n.weight.float()
        return (z - mean) * mul + n.bias.float()

    def forward(self, x, extra=None):
        z = self.omega_0 * self.linear(x, extra, self.dtype)
        if (self.training and self.norm is not None and self.fast_sine
                and z.is_cuda and z.dtype == torch.bfloat16):
            return batchnorm_train.batchnorm_sine(z, self.norm, self.mesh)
        z = z.float()
        if self.norm is not None:
            with trace.span("siren.batchnorm"):
                z = self.bn_train(z) if self.training else self.bn_eval(z)
        with trace.span("siren.sine"):
            if self.fast_sine:
                return fast_sin(z, self.dtype)     # the cast in its launch
            y = torch.sin(z)
        return y.to(self.dtype) if self.dtype is not None else y
