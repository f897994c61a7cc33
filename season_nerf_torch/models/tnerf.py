"""The Season-NeRF network (T-NeRF) in PyTorch.

The architecture and forward modes of ``season_nerf_tpu/models/tnerf.py``,
with the reference ``T_NeRF`` state-dict names (``G_NeRF_net.fc1``,
``time_layer_1``, ``get_class_layer``, ...):

  trunk:   PE(x; 10 freqs -> 63) -> fc1..fcN (width) with the PE
           concatenated back in at fc(N//2+1) -> fc9 (width/2) = x_enc
  heads:   sigma = softplus(fc10Sigma(x_enc)), col_raw = fc10Col(x_enc)
  solar:   [x_enc, PE(sun; 4 -> 27)] -> fc_solar_1..3 -> fc_solar_4 (vis)
  sky:     PE(sun) -> fc_sky_color_1 -> fc_sky_color_2 (3)
  time:    PE(t2; 2 -> 10) -> time_layer_1,2 -> get_class_layer (classes)
  adjust:  x_enc -> adjust_layer_1..3 -> adjust_col (classes x 3)

The module's mode is the JAX package's ``train`` argument.  At eval the
trunk runs through the fused inference kernel (``ops/fused_trunk``, K3),
folded once per set of weights; under bfloat16 its float32 output is cast
to bf16 before the heads, where flax's bf16 trunk emits bf16.  In training
mode the trunk is plain PyTorch with full-batch BatchNorm (the JAX XLA
path); the training step may instead run it through K1/K2 with ghost
BatchNorm (``ops/fused_train``).  Every other branch is plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from season_nerf_torch.models.encodings import encoded_size, positional_encode
from season_nerf_torch.models.siren import Dense, SineLayer


def _siren_init_(layer: SineLayer, is_first: bool):
    """SIREN weight init: U(+-1/fan_in) for a first layer, else
    U(+-sqrt(6/fan_in)/omega); the bias keeps Linear's U(+-1/sqrt(fan_in))."""
    fan_in = layer.linear.in_features
    bound = (1.0 / fan_in if is_first
             else (6.0 / fan_in) ** 0.5 / layer.omega_0)
    nn.init.uniform_(layer.linear.weight, -bound, bound)
    return layer


class GNeRF(nn.Module):
    """Position trunk + sigma/color/solar-visibility/sky heads."""

    def __init__(self, layer_width=512, n_layers=8, pe_pose=10, pe_solar=4,
                 n_channels=3, extended=True, use_norm=True, dtype=None,
                 fast_sine=False):
        super().__init__()
        if not 1 <= n_layers <= 8:
            raise ValueError(f"trunk depth {n_layers}: fc1..fcN and fc9 "
                             "must not collide (1 <= n_layers <= 8)")
        lw, lw2, lw4 = layer_width, max(layer_width // 2, 1), \
            max(layer_width // 4, 1)
        self.n_layers, self.pe_pose, self.pe_solar = n_layers, pe_pose, \
            pe_solar
        self.extended, self.dtype, self.fast_sine = extended, dtype, fast_sine
        skip = n_layers // 2 + 1
        self.skip = skip if skip > 1 else None
        in_pose = encoded_size(3, pe_pose, extended)
        in_solar = encoded_size(3, pe_solar, extended)

        def sine(fan_in, out, is_first=False, use_norm=False):
            return _siren_init_(SineLayer(fan_in, out, use_norm=use_norm,
                                          dtype=dtype, fast_sine=fast_sine),
                                is_first)

        for i in range(1, n_layers + 1):
            fan_in = in_pose if i == 1 else lw + (in_pose if i == self.skip
                                                  else 0)
            setattr(self, f"fc{i}", sine(fan_in, lw, is_first=(i == 1),
                                         use_norm=use_norm and i > 1))
        self.fc9 = sine(lw, lw2, use_norm=use_norm)
        self.fc10Col = Dense(lw2, n_channels, dtype)
        self.fc10Sigma = Dense(lw2, 1, dtype)
        self.fc_solar_1 = sine(lw2 + in_solar, lw2, is_first=True)
        self.fc_solar_2 = sine(lw2, lw2)
        self.fc_solar_3 = sine(lw2, lw2)
        self.fc_solar_4 = Dense(lw2, 1, dtype)
        self.fc_sky_color_1 = sine(in_solar, lw4, is_first=True)
        self.fc_sky_color_2 = Dense(lw4, 3, dtype)
        self._fused = None

    # the folded trunk follows the weights: dropped on a device/dtype move,
    # on load_state_dict and on every train()/eval() (an optimizer updates
    # the weights in place between two evaluations), rebuilt on the next
    # eval forward
    def train(self, mode: bool = True):
        self._fused = None
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._fused = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._fused = None
        return super()._load_from_state_dict(*args, **kwargs)

    def fused(self):
        """The trunk folded for inference (K3): needs the running
        statistics, so eval mode only."""
        from season_nerf_torch.ops.fused_trunk import FusedTrunk
        if self.training:
            raise RuntimeError("the folded inference trunk needs eval mode: "
                               "training normalises with batch statistics")
        if self._fused is None:
            self._fused = FusedTrunk(self)
        return self._fused

    def encode_x(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> x_enc [N, width/2] in the compute dtype: the fused
        inference trunk at eval, the layers one by one in training mode."""
        if self.training:
            pe = positional_encode(x, self.pe_pose, self.extended)
            h = pe
            for i in range(1, self.n_layers + 1):
                layer = getattr(self, f"fc{i}")
                h = layer(h, extra=pe) if i == self.skip else layer(h)
            return self.fc9(h)
        enc = self.fused().x_enc(x)
        return enc.to(self.dtype) if self.dtype is not None else enc

    def position(self, x):
        """-> (x_enc, rho_raw, col_raw)"""
        x_enc = self.encode_x(x)
        return (x_enc, self.fc10Sigma(x_enc).float(),
                self.fc10Col(x_enc).float())

    def solar_ray_consts(self, sun_dir):
        """Per-ray solar constants -> (sun_pe [R, pe], sky_raw [R, 3])."""
        sun_pe = positional_encode(sun_dir, self.pe_solar, self.extended)
        sky_raw = self.fc_sky_color_2(self.fc_sky_color_1(sun_pe)).float()
        return sun_pe, sky_raw

    def solar(self, x_enc, sun_dir, sun_pe=None, sky_raw=None):
        """-> (vis_raw, sky_raw); ``sun_pe``/``sky_raw`` may be given
        precomputed per point (see ``TNeRF.ray_consts``)."""
        if sun_pe is None:
            sun_pe = positional_encode(sun_dir, self.pe_solar, self.extended)
        a = self.fc_solar_1(x_enc, extra=sun_pe)
        a = self.fc_solar_3(self.fc_solar_2(a))
        vis_raw = self.fc_solar_4(a).float()
        if sky_raw is None:
            sky_raw = self.fc_sky_color_2(self.fc_sky_color_1(sun_pe)).float()
        return vis_raw, sky_raw


class TNeRF(nn.Module):
    """Season-NeRF: GNeRF + seasonal class head + per-class albedo adjust."""

    def __init__(self, layer_width=512, n_layers=8, n_classes=4, pe_pose=10,
                 pe_solar=4, pe_time=2, n_channels=3, extended=True,
                 use_norm=True, dtype: Optional[torch.dtype] = None,
                 fast_sine=False):
        super().__init__()
        lw, lw2 = layer_width, max(layer_width // 2, 1)
        self.n_classes, self.pe_time, self.extended = n_classes, pe_time, \
            extended
        self.dtype = dtype
        self.G_NeRF_net = GNeRF(lw, n_layers, pe_pose, pe_solar, n_channels,
                                extended, use_norm, dtype, fast_sine)

        def sine(fan_in, out, is_first=False):
            return _siren_init_(SineLayer(fan_in, out, dtype=dtype,
                                          fast_sine=fast_sine), is_first)

        self.time_layer_1 = sine(encoded_size(2, pe_time, extended), lw,
                                 is_first=True)
        self.time_layer_2 = sine(lw, lw)
        self.get_class_layer = Dense(lw, n_classes, dtype)
        self.adjust_layer_1 = sine(lw2, lw)
        self.adjust_layer_2 = sine(lw, lw)
        self.adjust_layer_3 = sine(lw, lw)
        self.adjust_col = Dense(lw, n_classes * 3, dtype)
        # heads the reference defines and never calls, kept so that
        # reference state dicts map one to one
        self.adjust_rho = Dense(lw, n_classes)
        self.adjust_solar_vis = Dense(lw, n_classes)
        self.adjust_sky_col = Dense(lw, n_classes * 3)

    UNUSED_HEADS = ("adjust_rho", "adjust_solar_vis", "adjust_sky_col")

    # -- branch helpers -----------------------------------------------------
    def class_probs(self, t4):
        """Seasonal class softmax from the year-fraction pair of t4."""
        te = positional_encode(t4[..., 0:2], self.pe_time, self.extended)
        h = self.time_layer_2(self.time_layer_1(te))
        return torch.softmax(self.get_class_layer(h).float(), dim=-1)

    def adjust_from_enc(self, x_enc):
        """Per-class albedo adjust [N, n_classes, 3]."""
        y = self.adjust_layer_3(self.adjust_layer_2(
            self.adjust_layer_1(x_enc)))
        return self.adjust_col(y).float().reshape(
            x_enc.shape[0], self.n_classes, 3)

    # -- forward modes ------------------------------------------------------
    def ray_consts(self, sun_dir, t4):
        """Ray-constant branch outputs from per-ray inputs:
        -> (class_probs [R, C] or None, sun_pe [R, pe], sky_raw [R, 3]).
        None of these branches has BatchNorm, so evaluating them once per
        ray and broadcasting equals the per-point forward."""
        probs = self.class_probs(t4) if t4 is not None else None
        sun_pe, sky_raw = self.G_NeRF_net.solar_ray_consts(sun_dir)
        return probs, sun_pe, sky_raw

    def forward(self, x, sun_dir, t4, probs=None, sun_pe=None, sky_raw=None):
        """Full forward: rho [N,1], col [N,3] (season-adjusted, sigmoided),
        vis [N,1], sky [N,3], class_probs [N,C], adjust [N,3]."""
        g = self.G_NeRF_net
        x_enc, rho_raw, col_raw = g.position(x)
        vis_raw, sky_raw = g.solar(x_enc, sun_dir, sun_pe, sky_raw)
        probs = self.class_probs(t4) if probs is None else probs
        adj = self.adjust_from_enc(x_enc)
        adjust_mixed = torch.sum(adj * probs[:, :, None], dim=1)
        return {
            "rho": F.softplus(rho_raw),
            "col": torch.sigmoid(col_raw + adjust_mixed),
            "vis": torch.sigmoid(vis_raw),
            "sky": torch.sigmoid(sky_raw),
            "class_probs": probs,
            "adjust": adjust_mixed,
        }

    def forward_separate(self, x, sun_dir, t4, probs=None, sun_pe=None,
                         sky_raw=None):
        """Forward without class mixing: raw color + per-class adjusts."""
        g = self.G_NeRF_net
        x_enc, rho_raw, col_raw = g.position(x)
        vis_raw, sky_raw = g.solar(x_enc, sun_dir, sun_pe, sky_raw)
        probs = self.class_probs(t4) if probs is None else probs
        return {
            "rho": F.softplus(rho_raw),
            "col_raw": col_raw,
            "vis": torch.sigmoid(vis_raw),
            "sky": torch.sigmoid(sky_raw),
            "class_probs": probs,
            "adjust_per_class": self.adjust_from_enc(x_enc),
        }

    def forward_solar(self, x, sun_dir, sun_pe=None, sky_raw=None):
        """The solar-correction forward: no gradient reaches the position
        trunk (the reference runs it under no_grad); the trunk's running
        statistics still update in training mode."""
        g = self.G_NeRF_net
        with torch.no_grad():
            x_enc, rho_raw, _ = g.position(x)
        vis_raw, sky_raw = g.solar(x_enc, sun_dir, sun_pe, sky_raw)
        return {"rho": F.softplus(rho_raw), "vis": torch.sigmoid(vis_raw),
                "sky_raw": sky_raw}

    def sigma_only(self, x):
        """Density only (exact-shadow secondary rays), in the compute dtype
        like the JAX package's."""
        g = self.G_NeRF_net
        return F.softplus(g.fc10Sigma(g.encode_x(x)))

    def class_only(self, t4):
        return self.class_probs(t4)

    def load_weights(self, state_dict):
        """Load a state dict from the weight bridge.  Strict, except that
        the unused reference heads may be absent (a flax-trained model has
        none); they then keep their init."""
        res = self.load_state_dict(state_dict, strict=False)
        missing = [k for k in res.missing_keys
                   if k.split(".")[0] not in self.UNUSED_HEADS]
        if missing or res.unexpected_keys:
            raise KeyError(f"state dict does not fit the model: missing "
                           f"{missing}, unexpected {res.unexpected_keys}")
        return self


def supervised_sigma(hm: torch.Tensor, world_pts: torch.Tensor,
                     delta: torch.Tensor, eps: float = 0.99) -> torch.Tensor:
    """DSM-prior density: occupancy below the prior height map as the sigma
    that gives hit probability ``min(occupied, eps)`` over a step ``delta``.

    hm: [H, W] in [-1, 1], NaN = no data (empty); world_pts: [N, 3];
    delta: [N, 1].  A plain gather; NaN cells become the sentinel -4.0,
    below any z in the cube, as in the JAX package."""
    H, W = hm.shape
    hm = hm.float()
    hm = torch.where(torch.isnan(hm), torch.full_like(hm, -4.0), hm)
    shape = torch.tensor([H - 1, W - 1], dtype=torch.float32,
                         device=world_pts.device)
    xy = ((world_pts[:, 0:2] + 1.0) / 2.0 * shape).to(torch.int64)
    r = torch.clamp(xy[:, 0], 0, H - 1)
    c = torch.clamp(xy[:, 1], 0, W - 1)
    p_exist = (hm[r, c] >= world_pts[:, 2]).float()
    p_exist = torch.clamp(p_exist, max=eps)
    return -torch.log(1.0 - p_exist[:, None]) / delta


def model_from_config(cfg) -> TNeRF:
    """The one place a Config becomes a network (width, depth, class count,
    compute dtype, sine), in eval mode (``.train()`` for training)."""
    dtype = (torch.bfloat16 if getattr(cfg, "compute_dtype", "float32")
             == "bfloat16" else None)
    return TNeRF(layer_width=cfg.fc_units, n_layers=cfg.fc_layers,
                 n_classes=cfg.number_low_frequency_cases, dtype=dtype,
                 fast_sine=getattr(cfg, "fast_sine", False)).eval()
