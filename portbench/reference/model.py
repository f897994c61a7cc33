"""The plain reference of the Season-NeRF network (T-NeRF), in float32.

Written from the published architecture (EnterpriseCV-6/Season-NeRF
``opt2.py``, arXiv 2308.01262) and the port's state-dict names, with no
kernel, fold, cache or batching, so that it shares nothing with the
program under test but the layout of its weights:

  trunk:   PE(x; 10 freqs, extended -> 63) -> fc1..fc8 (width 512, SIREN,
           omega 30) with the PE concatenated back in at fc5, BatchNorm on
           fc2..fc9 -> fc9 (width 256) = x_enc
  heads:   sigma = softplus(fc10Sigma(x_enc)), col_raw = fc10Col(x_enc)
  solar:   [x_enc, PE(sun; 4 -> 27)] -> fc_solar_1..3 -> fc_solar_4
  sky:     PE(sun) -> fc_sky_color_1 -> fc_sky_color_2
  time:    PE(t[0:2]; 2 -> 10) -> time_layer_1, 2 -> get_class_layer
  adjust:  x_enc -> adjust_layer_1..3 -> adjust_col (classes x 3)

BatchNorm in training normalises with the batch's mean and biased
variance, either over the whole batch or per ``tile`` consecutive rows
("ghost" BatchNorm), and moves the running statistics by momentum 0.99;
in eval mode it uses the running statistics.

``precision`` selects how every product is computed: ``"f32"`` (TF32 must
be off: :func:`strict_f32`); the others serve only as controls:
``"tf32"`` (the caller turns TF32 on) and ``"fp8"``, a bfloat16
configuration's cast points one precision lower: both operands and the
result (``x W^T + b``) rounded to float8 e4m3 under a per-tensor scale,
and in the backward pass the gradients at the same points, as fp8
training runs its products both ways.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

OMEGA = 30.0
BN_EPS = 1e-5
MOMENTUM = 0.99
PE_POSE, PE_SOLAR, PE_TIME = 10, 4, 2
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32(tf32: bool = False):
    """Products in full float32 (or in TF32 with ``tf32``) for the block."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in f32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    """Rounds the value to fp8 going forward and its gradient to fp8 going
    backward: a bfloat16 program's cast points, both ways, one precision
    lower."""

    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def positional(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[N, D] -> [N, D (1 + 2 n)]: x, then per dimension cos(k_j x) for
    j < n, then sin(k_j x), with k_j = 2^j pi / 2."""
    k = (2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                             device=x.device)) * (math.pi / 2)
    ang = x[:, :, None] * k
    enc = torch.cat([torch.cos(ang), torch.sin(ang)], -1)
    return torch.cat([x, enc.reshape(x.shape[0], -1)], -1)


class Net:
    """The network as a function of a flat state dict ``p`` (name ->
    float32 tensor; the learned ones may require gradients)."""

    def __init__(self, p: Dict[str, torch.Tensor], n_layers: int = 8,
                 precision: str = "f32", bn: str = "full", tile: int = 2048):
        self.p, self.n_layers = p, n_layers
        self.skip = n_layers // 2 + 1
        self.precision, self.bn, self.tile = precision, bn, tile
        self.training = True

    # -- building blocks --------------------------------------------------
    def dense(self, name: str, *inputs: torch.Tensor) -> torch.Tensor:
        """``[inputs...] @ W^T + b``, the weight's columns split over the
        inputs (no concatenation is built)."""
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        out, col = b, 0
        for x in inputs:
            wx = w[:, col:col + x.shape[1]]
            if self.precision == "fp8":
                x, wx = _Fp8.apply(x), _Fp8.apply(wx)
            out = out + x @ wx.t()
            col += x.shape[1]
        return _Fp8.apply(out) if self.precision == "fp8" else out

    def batchnorm(self, name: str, z: torch.Tensor) -> torch.Tensor:
        g, beta = self.p[name + ".weight"], self.p[name + ".bias"]
        rm, rv = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        if not self.training:
            return (z - rm) / torch.sqrt(rv + BN_EPS) * g + beta
        if self.bn == "ghost":
            zt = z.reshape(-1, self.tile, z.shape[1])
            mean = zt.mean(1, keepdim=True)
            var = ((zt - mean) ** 2).mean(1, keepdim=True)
            zh = ((zt - mean) / torch.sqrt(var + BN_EPS)).reshape(z.shape)
            mean, var = mean.mean(0)[0], var.mean(0)[0]
        else:
            mean = z.mean(0)
            var = ((z - mean) ** 2).mean(0)
            zh = (z - mean) / torch.sqrt(var + BN_EPS)
        with torch.no_grad():
            rm.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean.detach())
            rv.mul_(MOMENTUM).add_((1 - MOMENTUM) * var.detach())
        return zh * g + beta

    def sine(self, name: str, *inputs, norm: bool = False):
        z = OMEGA * self.dense(name + ".linear", *inputs)
        if norm:
            z = self.batchnorm(name + ".norm", z)
        return torch.sin(z)

    # -- branches -----------------------------------------------------------
    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        pe = positional(x, PE_POSE)
        h = self.sine("G_NeRF_net.fc1", pe)
        for i in range(2, self.n_layers + 1):
            ins = (h, pe) if i == self.skip else (h,)
            h = self.sine(f"G_NeRF_net.fc{i}", *ins, norm=True)
        return self.sine("G_NeRF_net.fc9", h, norm=True)

    def sigma(self, x_enc):
        return F.softplus(self.dense("G_NeRF_net.fc10Sigma", x_enc))

    def solar_vis(self, x_enc, sun_pe):
        a = self.sine("G_NeRF_net.fc_solar_1", x_enc, sun_pe)
        a = self.sine("G_NeRF_net.fc_solar_3",
                      self.sine("G_NeRF_net.fc_solar_2", a))
        return torch.sigmoid(self.dense("G_NeRF_net.fc_solar_4", a))

    def sky(self, sun_pe):
        return torch.sigmoid(self.dense(
            "G_NeRF_net.fc_sky_color_2",
            self.sine("G_NeRF_net.fc_sky_color_1", sun_pe)))

    def class_probs(self, t4):
        h = self.sine("time_layer_2",
                      self.sine("time_layer_1", positional(t4[:, :2],
                                                           PE_TIME)))
        return torch.softmax(self.dense("get_class_layer", h), -1)

    def adjust(self, x_enc):
        y = self.sine("adjust_layer_1", x_enc)
        y = self.sine("adjust_layer_3", self.sine("adjust_layer_2", y))
        a = self.dense("adjust_col", y)
        return a.reshape(x_enc.shape[0], -1, 3)

    def points(self, x, sun_pe_r, sky_r, probs_r, per):
        """Every output of the camera pass at the points ``x`` [R per, 3]
        of R rays; the ray constants repeat over their ``per`` samples."""
        rep = lambda a: a.repeat_interleave(per, 0)
        x_enc = self.trunk(x)
        col_raw = self.dense("G_NeRF_net.fc10Col", x_enc)
        adj = (self.adjust(x_enc) * rep(probs_r)[:, :, None]).sum(1)
        return {"rho": self.sigma(x_enc),
                "col": torch.sigmoid(col_raw + adj),
                "vis": self.solar_vis(x_enc, rep(sun_pe_r)),
                "sky": rep(sky_r)}

    def solar_points(self, x, sun_pe_r, per):
        """The solar-correction pass: density without gradient into the
        trunk (its BatchNorm statistics still move), visibility with."""
        with torch.no_grad():
            x_enc = self.trunk(x)
            rho = self.sigma(x_enc)
        vis = self.solar_vis(x_enc, sun_pe_r.repeat_interleave(per, 0))
        return rho, vis


def state_from(model_state: Dict[str, torch.Tensor], device=None,
               learned: Optional[set] = None) -> Dict[str, torch.Tensor]:
    """A float32 copy of a state dict on ``device``; the names in
    ``learned`` require gradients."""
    out = {}
    for k, v in model_state.items():
        t = v.detach().to(device=device, dtype=torch.float32).clone()
        if learned is not None and k in learned:
            t.requires_grad_(True)
        out[k] = t
    return out
