"""The training engine: phases, the training step, checkpoints, the artifact.

The counterpart of ``season_nerf_tpu/train/engine.py``'s ``Trainer``:

- a phase machine (``train/phases``): at each phase entry the Barron alpha
  and scale carry over into fresh latents, and both Adam optimizers start
  again with a OneCycle over the phase;
- the step: gather a batch from the device-resident ray table, the
  Season-NeRF loss (``train/losses``), backward, both updates;
- ``pallas_trunk`` runs the trunk through the hand-written kernels K1/K2
  (ghost BatchNorm, ``ops/fused_train``) where ``spec_for_model`` accepts
  the model; where it does not, :func:`fused_trunk_spec` raises on the card
  and, on the CPU, warns and keeps the default trunk as the JAX package
  does;
- full-state checkpoints at the save points, ``resume``, and ``finalize``
  writing ``Final_Model.nn``.

Randomness: every draw of a step comes from ``draws(step)``.  The default,
:class:`StepDraws`, keys a generator by ``(seed, step)``, so how the steps
are dispatched never changes the draws (the JAX package's draws depend on
its ``scan_chunk``); a test passes its own source to replay another
stream.

With ``weight_training_samples`` the batch is drawn by inverse-CDF sampling
over the rows' sample weights (:func:`weighted_indices`), as the JAX
package's step does; the draws then hold the uniform ``u`` in place of the
indices.

Not ported yet: validation losses and renders at the save points, the
``best_geometry`` selections, hierarchical sampling.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from season_nerf_torch.config import Config
from season_nerf_torch.data.dataset import DeviceRayDataset
from season_nerf_torch.data.rays import RayTable
from season_nerf_torch.models.tnerf import TNeRF, model_from_config
from season_nerf_torch.ops import robust_loss
from season_nerf_torch.ops.robust_loss import AdaptiveCfg
from season_nerf_torch.train import phases as phase_lib
from season_nerf_torch.train import state as state_lib
from season_nerf_torch.train.losses import LossStatics, season_nerf_loss
from season_nerf_torch.utils import heartbeat
from season_nerf_torch.utils.logging import MetricWriter


def _color_cfg(init_alpha=2.0, init_scale=0.03):
    return AdaptiveCfg(n_channels=3, alpha_lo=0.001, alpha_hi=2.99,
                       alpha_init=init_alpha, scale_lo=0.01,
                       scale_init=init_scale)


def _alpha_cfg():
    return AdaptiveCfg(n_channels=1, alpha_lo=0.001, alpha_hi=2.99,
                       alpha_init=2.0, scale_lo=0.05, scale_init=0.5)


def weight_cdf(weights: np.ndarray) -> Optional[np.ndarray]:
    """The float32 CDF of the rows' sample weights (negative ones count as
    0), or None where the weights are all equal and the draw stays
    uniform."""
    w = np.asarray(weights, np.float64)
    if np.ptp(w) <= 1e-9:
        return None
    cdf = np.cumsum(np.maximum(w, 0.0))
    return (cdf / cdf[-1]).astype(np.float32)


def weighted_indices(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row indices of the uniform draws ``u`` by the inverse CDF: the
    left-side ``searchsorted``, clipped to the last row."""
    return torch.searchsorted(cdf, u).clamp_(0, cdf.shape[0] - 1)


class StepDraws:
    """Every random number of one training step from a generator on
    ``device`` seeded by ``(seed, step)``: the batch indices (or, with
    ``weighted``, the uniform ``u`` of the inverse-CDF draw), the camera
    and solar jitter [R, S] and the solar rays' angles, starts and times
    (the names ``train/losses`` reads)."""

    def __init__(self, seed: int, n_rows: int, batch_size: int,
                 n_samples: int, device="cuda", weighted: bool = False):
        self.seed, self.n_rows = seed, n_rows
        self.R, self.S = batch_size, n_samples
        self.device = torch.device(device)
        self.weighted = weighted

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        key = np.random.SeedSequence([self.seed, step]).generate_state(
            1, np.uint64)[0]
        g = torch.Generator(device=self.device)
        g.manual_seed(int(key))
        R, S, dev = self.R, self.S, self.device
        u = lambda *shape: torch.rand(shape, generator=g, device=dev)
        lo, hi = math.radians(1.0), math.radians(90.0)
        batch = ({"u": u(R)} if self.weighted else
                 {"idx": torch.randint(0, self.n_rows, (R,), generator=g,
                                       device=dev)})
        return {**batch,
                "jitter": u(R, S),
                "solar_az": (u(R) * 2.0 - 1.0) * math.pi,
                "solar_el": lo + u(R) * (hi - lo),
                "solar_xy": u(R, 2) * 2.0 - 1.0,
                "solar_t": u(R, 2) * (2.0 * math.pi),
                "solar_jitter": u(R, S)}


def fused_trunk_spec(model, rows: int, device):
    """The ``TrunkSpec`` that ``pallas_trunk`` trains ``model``'s trunk
    with over ``rows`` points a pass, or None for the default trunk.  Where
    ``spec_for_model`` refuses the model: on a CUDA device a ValueError
    with its reason, since the default trunk (full-batch BatchNorm) is
    another function and would hide K1/K2; on the CPU a warning and None,
    as the JAX package falls back."""
    from season_nerf_torch.ops.fused_train import spec_for_model
    spec, why = spec_for_model(model, rows)
    if spec is None:
        if torch.device(device).type == "cuda":
            raise ValueError(f"pallas_trunk requested but unsupported: {why}")
        warnings.warn(f"pallas_trunk requested but unsupported ({why}): "
                      f"falling back to the default trunk", stacklevel=3)
    return spec


class Trainer:
    def __init__(self, cfg: Config, train_table: RayTable,
                 prior_hm: Optional[np.ndarray] = None,
                 sun_frame: Optional[np.ndarray] = None,
                 writer: Optional[MetricWriter] = None, device="cuda",
                 draws: Optional[Callable[[int], Dict]] = None):
        if cfg.n_importance > 0:
            raise NotImplementedError("hierarchical sampling (n_importance "
                                      "> 0) is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.writer = writer or MetricWriter(cfg.logs_dir)
        if cfg.logs_dir:
            heartbeat.set_path(os.path.join(cfg.logs_dir, "heartbeat"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model: TNeRF = model_from_config(cfg)
        self.model.to(self.device).train()
        self.train_ds = DeviceRayDataset(train_table, device=self.device)
        as_dev = lambda a: (None if a is None else torch.as_tensor(
            np.asarray(a), dtype=torch.float32, device=self.device))
        self.prior_hm = as_dev(prior_hm)
        self.sun_frame = as_dev(sun_frame)
        self.weight_cdf = as_dev(weight_cdf(train_table.rows[:, 18])
                                 if cfg.weight_training_samples else None)
        self.draws = draws or StepDraws(cfg.seed, self.train_ds.n,
                                        cfg.batch_size, cfg.n_samples,
                                        self.device,
                                        weighted=self.weight_cdf is not None)
        jump = cfg.jump_start and prior_hm is not None
        self.phases = phase_lib.build_phases(cfg.max_train_steps, jump)
        self.save_steps = set(phase_lib.save_points(
            self.phases, cfg.n_saves, cfg.max_train_steps))
        self.step = 0
        self._phase: Optional[phase_lib.Phase] = None
        self.statics: Optional[LossStatics] = None
        self._carry_alpha, self._carry_scale = 2.0, 0.03
        self.ada_params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.optimizers: Optional[state_lib.Optimizers] = None

    # --- phases -----------------------------------------------------------
    def _statics_for(self, phase) -> LossStatics:
        cfg = self.cfg
        use_prior = phase.use_prior and self.prior_hm is not None
        keepalive = (cfg.phase4_prior_keepalive
                     if (not use_prior and self.prior_hm is not None
                         and cfg.jump_start) else 0.0)
        color_cfg = alpha_cfg = None
        if not cfg.Use_MSE_loss:
            color_cfg = (_color_cfg() if phase.index == 1 else
                         _color_cfg(self._carry_alpha, self._carry_scale))
            if use_prior or (keepalive > 0 and cfg.phase4_keepalive_barron):
                alpha_cfg = _alpha_cfg()
        spec = None
        if cfg.pallas_trunk:
            spec = fused_trunk_spec(self.model,
                                    cfg.batch_size * cfg.n_samples,
                                    self.device)
        return LossStatics(
            n_samples=cfg.n_samples, use_prior=use_prior,
            use_solar=cfg.Use_Solar, classic_solar=cfg.Solar_Type_2,
            use_mse_loss=cfg.Use_MSE_loss,
            sc_lambda=cfg.sc_lambda, phase_len=phase.end,
            color_cfg=color_cfg, alpha_cfg=alpha_cfg,
            prior_keepalive=keepalive, phase_start=phase.start,
            trunk_spec=spec)

    def _enter_phase(self, phase):
        """Fresh latents (the color alpha and scale carried over), fresh
        optimizers and schedules."""
        st = self.statics
        if self._phase is not None and st is not None \
                and st.color_cfg is not None and "color" in self.ada_params:
            with torch.no_grad():
                lat = self.ada_params["color"]
                self._carry_alpha = float(robust_loss.alpha_of(
                    lat, st.color_cfg).mean())
                self._carry_scale = float(robust_loss.scale_of(
                    lat, st.color_cfg).mean())
        self.statics = st = self._statics_for(phase)
        self._phase = phase
        self.ada_params = {}
        for name, c in (("color", st.color_cfg), ("alpha", st.alpha_cfg)):
            if c is not None:
                self.ada_params[name] = {
                    k: v.requires_grad_() for k, v in
                    robust_loss.init_adaptive(c, self.device).items()}
        self.optimizers = state_lib.Optimizers(
            self.model.parameters(), self._ada_leaves(), self.cfg.lr,
            self.cfg.lr_alpha_scale, phase.length)

    def _ada_leaves(self):
        return [t for lat in self.ada_params.values() for t in lat.values()]

    # --- the step -----------------------------------------------------------
    def train_step(self) -> Dict[str, torch.Tensor]:
        """One optimizer step at ``self.step`` (entering its phase when
        needed) -> the loss values and ``Total``, on the device."""
        phase = phase_lib.phase_at(self.phases, self.step)
        if self._phase is None or phase.index != self._phase.index:
            self._enter_phase(phase)
        d = self.draws(self.step)
        idx = (d["idx"] if self.weight_cdf is None
               else weighted_indices(self.weight_cdf, d["u"]))
        batch = self.train_ds.batch(idx)
        self.optimizers.zero_grad()
        total, losses = season_nerf_loss(
            self.model, self.ada_params, self.statics, batch, d, self.step,
            prior_hm=self.prior_hm, sun_frame=self.sun_frame)
        total.backward()
        self.optimizers.step(self.step - phase.start)
        self.step += 1
        scalars = {k: v.detach() for k, (v, _) in losses.items()}
        scalars["Total"] = total.detach()
        return scalars

    def run(self, n_steps: Optional[int] = None, log_every: int = 50):
        """Train to ``max_train_steps`` (or ``n_steps`` more), logging every
        ``log_every`` steps and checkpointing at the save points."""
        end = min(self.step + n_steps if n_steps is not None
                  else self.cfg.max_train_steps, self.cfg.max_train_steps)
        while self.step < end:
            heartbeat.beat()
            scalars = self.train_step()
            done = self.step - 1
            if done % log_every == 0 or self.step in self.save_steps:
                self.writer.scalars("Training", {k: float(v) for k, v in
                                                 scalars.items()}, done)
            if self.step in self.save_steps:
                self._on_save_point()

    # --- checkpoints ---------------------------------------------------------
    def _ckpt_extra(self):
        return {"step": self.step,
                "carry_alpha": self._carry_alpha,
                "carry_scale": self._carry_scale}

    def save_checkpoint(self, path: str):
        state_lib.save_checkpoint(path, self.model, self.ada_params,
                                  self.optimizers, extra=self._ckpt_extra())

    def _on_save_point(self):
        if self.cfg.logs_dir:
            self.save_checkpoint(os.path.join(self.cfg.logs_dir,
                                              f"Model_{self.step}.nn"))
        self.writer.flush()

    def resume(self, ckpt_path: str):
        """Restore the whole training state (weights, running statistics,
        both optimizers, latents, step and carried values) and continue."""
        ck = state_lib.load_checkpoint(ckpt_path)
        extra = ck["extra"]
        self.step = int(extra.get("step", 0))
        self._carry_alpha = float(extra.get("carry_alpha", 2.0))
        self._carry_scale = float(extra.get("carry_scale", 0.03))
        self._phase = None
        self.model.load_state_dict(ck["model"])
        self._enter_phase(phase_lib.phase_at(self.phases,
                                             max(self.step - 1, 0)))
        with torch.no_grad():
            for name, lat in self.ada_params.items():
                for k, t in lat.items():
                    t.copy_(ck["ada"][name][k])
        self.optimizers.load_state_dict(ck["optim"])
        return self

    def finalize(self):
        """Write ``Final_Model.nn`` (the last step's weights)."""
        cfg = self.cfg
        if cfg.final_model_selection != "last":
            warnings.warn(f"final_model_selection="
                          f"{cfg.final_model_selection!r} is not ported yet: "
                          f"writing the last step's weights")
        meta = {"fc_units": cfg.fc_units,
                "n_classes": cfg.number_low_frequency_cases,
                "steps": self.step}
        if cfg.logs_dir:
            sd = {k: v for k, v in self.model.state_dict().items()
                  if k.split(".")[0] not in TNeRF.UNUSED_HEADS}
            state_lib.save_model_artifact(
                os.path.join(cfg.logs_dir, "Final_Model.nn"), sd, meta=meta)
        self.writer.flush()
