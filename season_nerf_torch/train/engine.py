"""The training engine: phases, the training step, checkpoints, the artifact.

The counterpart of ``season_nerf_tpu/train/engine.py``'s ``Trainer``:

- a phase machine (``train/phases``): at each phase entry the Barron alpha
  and scale carry over into fresh latents, and both Adam optimizers start
  again with a OneCycle over the phase;
- the step: gather a batch from the device-resident ray table, the
  Season-NeRF loss (``train/losses``), backward, both updates;
- ``pallas_trunk`` runs the trunk through the hand-written kernels K1/K2
  (ghost BatchNorm, ``ops/fused_train``) where ``spec_for_model`` accepts
  the model and ``n_importance`` is 0; where not, :func:`fused_trunk_spec`
  raises on the card and, on the CPU, warns and keeps the default trunk as
  the JAX package does;
- ``n_importance`` > 0 trains with hierarchical sampling: a density-only
  pass in eval mode places the extra samples (``ops/rendering.eval_rays``);
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

Validation, as the JAX package's ``Trainer`` does it: at every save point
the ``Testing`` losses on a batch of the validation table and, unless
``save_point_val_renders`` is 0, :meth:`Trainer.validation_report` (every
held-out image rendered, masked PSNR, the expected surface's height error
against the lidar DSM and against the prior), then the checkpoint.  Both
run the model in eval mode, that is through the folded inference trunk
(K3 on the card), with the running statistics that the training steps
left, which they do not update.  Their draws (the batch and the solar
rays) come from ``val_draws(step)``, a stream of their own
(:class:`ValDraws`), so validation never moves a training draw.
``finalize`` ships the last step's weights or, with
``final_model_selection="best_geometry[_on_decay]"``, the save point whose
renders scored the lowest height error against the prior.  A model trained
on HSLuv colors (``use_HSLuv``) is validated in sRGB: its renders and the
held-out rows are converted back before PSNR, as in the JAX package.
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
from season_nerf_torch.data.rays import RayTable, decode_batch
from season_nerf_torch.models.tnerf import TNeRF, model_from_config
from season_nerf_torch.ops import fused_trunk, rendering, robust_loss
from season_nerf_torch.ops.metrics import psnr as psnr_metric
from season_nerf_torch.ops.robust_loss import AdaptiveCfg
from season_nerf_torch.train import phases as phase_lib
from season_nerf_torch.train import state as state_lib
from season_nerf_torch.train.losses import LossStatics, season_nerf_loss
from season_nerf_torch.utils import heartbeat
from season_nerf_torch.utils.logging import MetricWriter


def mesh_refusal(cfg: Config, device, strict: bool = True) -> None:
    """The JAX package's mesh decisions (``_auto_mesh``,
    ``season_nerf_tpu/train/engine.py``) for one process on one device,
    where the port has no mesh yet (``parallel/mesh.py`` is not ported).

    ``mesh_shape`` None or 1: nothing to do, the run takes ``device``.  An
    explicit ``mesh_shape`` above 1 is never ignored.  With ``strict`` (the
    trainer) it raises: with the JAX package's message where it exceeds
    the visible devices, else because data-parallel training is not
    ported.  Without (``strict=False``: the render side, where a model
    directory's opts.json may record the slice it trained on) it warns, as
    the JAX package's render side does, and the model renders on
    ``device`` alone: every ray is independent, so the image is the same.
    Visible devices: ``torch.cuda.device_count()`` on a card, 1 on the
    CPU."""
    if cfg.mesh_shape is None or int(cfg.mesh_shape) <= 1:
        return
    want = int(cfg.mesh_shape)
    n_dev = (torch.cuda.device_count()
             if torch.device(device).type == "cuda" else 1)
    if want > n_dev:
        msg = (f"mesh_shape={cfg.mesh_shape} but only {n_dev} device(s) are "
               f"visible; lower mesh_shape or run on a larger slice")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg + f" — clamping to {n_dev}"
                      + (", rendering on one device (the render mesh is "
                         "not ported)" if n_dev > 1 else ""), stacklevel=2)
        return
    if strict:
        raise ValueError(
            f"mesh_shape={want}: data-parallel training over {want} "
            f"devices is not ported to season_nerf_torch yet (the mesh of "
            f"season_nerf_tpu/parallel/mesh.py); leave mesh_shape unset or "
            f"set it to 1")
    warnings.warn(f"mesh_shape={want}: the render mesh is not ported; "
                  f"rendering on one device", stacklevel=2)


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


def _generator(entropy, device) -> torch.Generator:
    """A generator on ``device`` seeded by the entropy list."""
    key = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


def _solar_draws(g, n: int, device) -> Dict[str, torch.Tensor]:
    """The solar rays' angles, starts and times of ``n`` rays."""
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    lo, hi = math.radians(1.0), math.radians(90.0)
    return {"solar_az": (u(n) * 2.0 - 1.0) * math.pi,
            "solar_el": lo + u(n) * (hi - lo),
            "solar_xy": u(n, 2) * 2.0 - 1.0,
            "solar_t": u(n, 2) * (2.0 * math.pi)}


def _fine_draws(g, n: int, n_importance: int, device):
    """The importance samples' ``fine_u`` [n, n_importance] and
    ``fine_shift`` [n, n_importance, 1]; none at ``n_importance`` 0."""
    if n_importance <= 0:
        return {}
    return {"fine_u": torch.rand((n, n_importance), generator=g,
                                 device=device),
            "fine_shift": torch.rand((n, n_importance, 1), generator=g,
                                     device=device)}


class StepDraws:
    """Every random number of one training step from a generator on
    ``device`` seeded by ``(seed, step)``: the batch indices (or, with
    ``weighted``, the uniform ``u`` of the inverse-CDF draw), the camera
    and solar jitter [R, S] and the solar rays' angles, starts and times
    (the names ``train/losses`` reads); with ``n_importance`` > 0, after
    all of these, the importance samples' ``fine_u`` and ``fine_shift``
    (so the draws of ``n_importance`` = 0 are unchanged)."""

    def __init__(self, seed: int, n_rows: int, batch_size: int,
                 n_samples: int, device="cuda", weighted: bool = False,
                 n_importance: int = 0):
        self.seed, self.n_rows = seed, n_rows
        self.R, self.S = batch_size, n_samples
        self.device = torch.device(device)
        self.weighted = weighted
        self.n_importance = n_importance

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        g = _generator([self.seed, step], self.device)
        R, S, dev = self.R, self.S, self.device
        u = lambda *shape: torch.rand(shape, generator=g, device=dev)
        batch = ({"u": u(R)} if self.weighted else
                 {"idx": torch.randint(0, self.n_rows, (R,), generator=g,
                                       device=dev)})
        jitter = u(R, S)
        solar = _solar_draws(g, R, dev)
        return {**batch, "jitter": jitter, **solar,
                "solar_jitter": u(R, S),
                **_fine_draws(g, R, self.n_importance, dev)}


class ValDraws:
    """The draws of the ``Testing`` losses at the save point ``step``: the
    indices of ``batch_size`` validation rows and their solar rays, from a
    generator seeded by ``(seed, step, VAL_STREAM)``, a stream apart from
    :class:`StepDraws`', then, with ``n_importance`` > 0, the importance
    samples' (eval mode places them too, as in the JAX package).  Eval mode
    samples without jitter."""

    VAL_STREAM = 1

    def __init__(self, seed: int, n_rows: int, batch_size: int,
                 device="cuda", n_importance: int = 0):
        self.seed, self.n_rows, self.R = seed, n_rows, batch_size
        self.device = torch.device(device)
        self.n_importance = n_importance

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        g = _generator([self.seed, step, self.VAL_STREAM], self.device)
        idx = torch.randint(0, self.n_rows, (self.R,), generator=g,
                            device=self.device)
        return {"idx": idx, **_solar_draws(g, self.R, self.device),
                **_fine_draws(g, self.R, self.n_importance, self.device)}


def fused_trunk_spec(model, rows: int, device, n_importance: int = 0):
    """The ``TrunkSpec`` that ``pallas_trunk`` trains ``model``'s trunk
    with over ``rows`` points a pass, or None for the default trunk.  Where
    ``spec_for_model`` refuses the model, or hierarchical sampling is on
    (``n_importance`` > 0, which the JAX package's fused trunk does not
    take either): on a CUDA device a ValueError with its reason, since the
    default trunk (full-batch BatchNorm) is another function and would
    hide K1/K2; on the CPU a warning and None, as the JAX package falls
    back."""
    from season_nerf_torch.ops.fused_train import spec_for_model
    if n_importance > 0:
        spec, why = None, "hierarchical sampling (n_importance > 0)"
    else:
        spec, why = spec_for_model(model, rows)
    if spec is None:
        if torch.device(device).type == "cuda":
            raise ValueError(f"pallas_trunk requested but unsupported: {why}")
        warnings.warn(f"pallas_trunk requested but unsupported ({why}): "
                      f"falling back to the default trunk", stacklevel=3)
    return spec


class Trainer:
    def __init__(self, cfg: Config, train_table: RayTable,
                 val_table: Optional[RayTable] = None,
                 prior_hm: Optional[np.ndarray] = None,
                 gt_dsm: Optional[np.ndarray] = None,
                 sun_frame: Optional[np.ndarray] = None,
                 writer: Optional[MetricWriter] = None, device="cuda",
                 draws: Optional[Callable[[int], Dict]] = None,
                 val_draws: Optional[Callable[[int], Dict]] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        # a model K3 cannot evaluate would train and then fail at its
        # first save point: refused before anything is built
        fused_trunk.refuse_on_card(cfg, self.device)
        mesh_refusal(cfg, self.device)      # never one device silently
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
        # validation stays on the host: a chunk at a time goes to the device
        self.val_table = val_table
        self.gt_dsm = gt_dsm
        self._prior_np = None if prior_hm is None else np.asarray(prior_hm)
        # (step, height error against the prior) per save point: what the
        # best_geometry selections choose from (the prior is training data,
        # so nothing of the ground truth leaks into the choice)
        self._save_geometry = []
        if val_draws is None and val_table is not None:
            val_draws = ValDraws(cfg.seed, len(val_table),
                                 min(cfg.batch_size, len(val_table)),
                                 self.device, n_importance=cfg.n_importance)
        self.val_draws = val_draws
        self.weight_cdf = as_dev(weight_cdf(train_table.rows[:, 18])
                                 if cfg.weight_training_samples else None)
        self.draws = draws or StepDraws(cfg.seed, self.train_ds.n,
                                        cfg.batch_size, cfg.n_samples,
                                        self.device,
                                        weighted=self.weight_cdf is not None,
                                        n_importance=cfg.n_importance)
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
                                    self.device, cfg.n_importance)
        return LossStatics(
            n_samples=cfg.n_samples, use_prior=use_prior,
            use_solar=cfg.Use_Solar, classic_solar=cfg.Solar_Type_2,
            use_mse_loss=cfg.Use_MSE_loss,
            sc_lambda=cfg.sc_lambda, phase_len=phase.end,
            color_cfg=color_cfg, alpha_cfg=alpha_cfg,
            prior_keepalive=keepalive, phase_start=phase.start,
            trunk_spec=spec, n_importance=cfg.n_importance)

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
        # the save-point scores travel with the checkpoint, so that a
        # resumed run selects among every save point, not only the later
        return {"step": self.step,
                "carry_alpha": self._carry_alpha,
                "carry_scale": self._carry_scale,
                "save_geometry": [[int(s), float(m)]
                                  for s, m in self._save_geometry]}

    def save_checkpoint(self, path: str):
        state_lib.save_checkpoint(path, self.model, self.ada_params,
                                  self.optimizers, extra=self._ckpt_extra())

    def _on_save_point(self):
        """The ``Testing`` losses, the validation report (the images
        capped at ``save_point_val_renders`` when it is positive, none when
        it is 0), then the checkpoint."""
        cfg = self.cfg
        if self.val_table is not None and len(self.val_table) > 0:
            self.writer.scalars("Testing", self.eval_losses(), self.step)
        if cfg.save_point_val_renders:
            rep = self.validation_report(
                max_images=max(cfg.save_point_val_renders, 0) or None)
            if "Prior_Height_Error" in rep:
                self._save_geometry.append(
                    (self.step, rep["Prior_Height_Error"]))
        if cfg.logs_dir:
            self.save_checkpoint(os.path.join(cfg.logs_dir,
                                              f"Model_{self.step}.nn"))
        self.writer.flush()

    def resume(self, ckpt_path: str):
        """Restore the whole training state (weights, running statistics,
        both optimizers, latents, step, carried values and the save-point
        scores) and continue."""
        ck = state_lib.load_checkpoint(ckpt_path)
        extra = ck["extra"]
        self.step = int(extra.get("step", 0))
        self._carry_alpha = float(extra.get("carry_alpha", 2.0))
        self._carry_scale = float(extra.get("carry_scale", 0.03))
        self._save_geometry = [(int(s), float(m))
                               for s, m in extra.get("save_geometry", [])]
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
        """Write ``Final_Model.nn``: the last step's weights or, with
        ``final_model_selection`` ``"best_geometry"``, the save point of
        the lowest height error against the prior; with
        ``"best_geometry_on_decay"`` that save point only where the last
        one's error exceeds it by more than ``geometry_decay_threshold``
        (relative), else the last step's.  The selection and its scores
        go into the artifact's meta."""
        cfg = self.cfg
        sd, steps = self.model.state_dict(), self.step
        meta = {"fc_units": cfg.fc_units,
                "n_classes": cfg.number_low_frequency_cases}
        mode = cfg.final_model_selection
        if mode in ("best_geometry", "best_geometry_on_decay"):
            if not self._save_geometry:
                warnings.warn(
                    f"final_model_selection={mode!r} requested but no "
                    "save-point geometry scores exist (needs a DSM prior, "
                    "and save_point_val_renders must not be 0); falling "
                    "back to the last-step weights")
            else:
                best_step, best_mae = min(self._save_geometry,
                                          key=lambda sm: sm[1])
                if mode == "best_geometry_on_decay":
                    last_mae = self._save_geometry[-1][1]
                    drift = (last_mae - best_mae) / max(best_mae, 1e-9)
                    meta.update(geometry_drift=float(drift),
                                decay_threshold=cfg.geometry_decay_threshold)
                    if drift <= cfg.geometry_decay_threshold:
                        print(f"[finalize] best_geometry_on_decay: drift "
                              f"{drift:.1%} <= threshold "
                              f"{cfg.geometry_decay_threshold:.0%}: keeping "
                              f"the last-step weights")
                        # the last save point's score taken as the last
                        # step's, as the JAX package does (ROADMAP Queue 3)
                        best_step, best_mae = self.step, last_mae
                meta.update(selection=mode, selected_step=int(best_step),
                            prior_height_mae=float(best_mae))
                if best_step != self.step and cfg.logs_dir:
                    sd = state_lib.load_checkpoint(os.path.join(
                        cfg.logs_dir, f"Model_{best_step}.nn"))["model"]
                    steps = best_step
                print(f"[finalize] best_geometry selected step {best_step} "
                      f"(prior-DSM MAE {best_mae:.4f}; last step "
                      f"{self.step})")
        meta["steps"] = steps
        if cfg.logs_dir:
            sd = {k: v for k, v in sd.items()
                  if k.split(".")[0] not in TNeRF.UNUSED_HEADS}
            state_lib.save_model_artifact(
                os.path.join(cfg.logs_dir, "Final_Model.nn"), sd, meta=meta)
        self.writer.flush()

    # --- validation ------------------------------------------------------------
    def eval_losses(self) -> Dict[str, float]:
        """The phase's Season-NeRF loss in eval mode on a batch of the
        validation table drawn by ``val_draws(step)`` -> the loss values
        and ``Total``."""
        d = self.val_draws(self.step)
        rows = self.val_table.rows[d["idx"].cpu().numpy()]
        batch = decode_batch(torch.as_tensor(rows, device=self.device))
        with rendering.running_statistics(self.model):
            total, losses = season_nerf_loss(
                self.model, self.ada_params, self.statics, batch, d,
                self.step, prior_hm=self.prior_hm, sun_frame=self.sun_frame)
        scalars = {k: float(v) for k, (v, _) in losses.items()}
        scalars["Total"] = float(total)
        return scalars

    def render_table_image(self, table: RayTable, img_index: int,
                           chunk: Optional[int] = None):
        """Render one image of ``table`` from its rays in eval mode, in
        chunks of ``min(chunk or cfg.chunk, 4096)`` rays (the last at its
        own size) -> (rendered [H, W, 3], gt [H, W, 3], both sRGB,
        expected-surface height [H, W] (NaN where no ray), mask [H, W])."""
        cfg = self.cfg
        chunk = min(chunk or cfg.chunk, 4096)
        rows = table.rows[table.img_ids == img_index]
        H, W = table.img_sizes[img_index]
        cols, zs = [], []
        with rendering.running_statistics(self.model):
            for s in range(0, rows.shape[0], chunk):
                b = decode_batch(torch.as_tensor(rows[s:s + chunk],
                                                 device=self.device))
                out = rendering.eval_rays(
                    self.model, b["top"], b["bot"], b["sun"], b["t4"],
                    n_samples=cfg.n_samples, classic_solar=cfg.Solar_Type_2)
                surf, _ = rendering.expected_surface(out["ps"], out["pts"],
                                                     out["deltas"])
                cols.append(out["rendered"])
                zs.append(surf[:, 2])
                heartbeat.beat()
        rend = np.zeros((H, W, 3), np.float32)
        gt = np.zeros((H, W, 3), np.float32)
        height = np.full((H, W), np.nan, np.float32)
        seen = np.zeros((H, W), bool)
        if cols:
            ij = rows[:, 0:2].astype(int)
            rend[ij[:, 0], ij[:, 1]] = torch.cat(cols).float().cpu().numpy()
            gt[ij[:, 0], ij[:, 1]] = rows[:, 19:22]
            height[ij[:, 0], ij[:, 1]] = torch.cat(zs).float().cpu().numpy()
            seen[ij[:, 0], ij[:, 1]] = True
        if cfg.use_HSLuv:
            # the model's space is normalized HSLuv: the render and the
            # HSLuv rows go back to sRGB for display and PSNR
            from season_nerf_torch.utils.hsluv import hsluv_normalized_to_rgb
            rend = hsluv_normalized_to_rgb(np.clip(rend, 0, 1)).astype(
                np.float32)
            gt = hsluv_normalized_to_rgb(np.clip(gt, 0, 1)).astype(np.float32)
        return rend, gt, height, seen

    def validation_report(self, step: Optional[int] = None,
                          max_images: Optional[int] = None):
        """Render the validation images (the first ``max_images``, or all)
        and log them, their mean masked PSNR (``Mean_PSNR``) and mean
        height errors against the ground-truth DSM
        (``Mean_Height_Error``) and against the prior
        (``Prior_Height_Error``) under ``Testing`` -> those means."""
        if self.val_table is None:
            return {}
        step = step if step is not None else self.step
        n_imgs = len(self.val_table.img_names)
        if max_images is not None:
            n_imgs = min(n_imgs, max_images)
        psnrs, maes, prior_maes = [], [], []
        for i in range(n_imgs):
            rend, gt, height, seen = self.render_table_image(self.val_table,
                                                             i)
            psnrs.append(float(psnr_metric(torch.from_numpy(rend),
                                           torch.from_numpy(gt),
                                           mask=torch.from_numpy(seen))))
            self.writer.image(f"Testing/render_{i}", rend, step)
            h_img = (np.nan_to_num(height, nan=-1.0) + 1.0) / 2.0
            self.writer.image(f"Testing/height_{i}",
                              np.repeat(h_img[..., None], 3, -1), step)
            for ref, out in ((self.gt_dsm, maes),
                             (self._prior_np, prior_maes)):
                if ref is not None:
                    mae = _height_mae(height, ref, self.val_table, i)
                    if mae is not None:
                        out.append(mae)
        report = {"Mean_PSNR": float(np.mean(psnrs))}
        if maes:
            report["Mean_Height_Error"] = float(np.mean(maes))
        if prior_maes:
            report["Prior_Height_Error"] = float(np.mean(prior_maes))
        self.writer.scalars("Testing", report, step)
        return report


def _height_mae(height, dsm, table: RayTable, img_index: int):
    """Mean |expected-surface height - the DSM| over the image's rays, the
    DSM sampled at the ray's midpoint footprint (nearest cell) -> None
    where no pixel has both."""
    rows = table.rows[table.img_ids == img_index]
    ij = rows[:, 0:2].astype(int)
    mid = (rows[:, 2:5] + rows[:, 5:8]) / 2
    g = dsm.shape
    xi = np.clip(((mid[:, 0] + 1) / 2 * (g[0] - 1)).astype(int), 0, g[0] - 1)
    yi = np.clip(((mid[:, 1] + 1) / 2 * (g[1] - 1)).astype(int), 0, g[1] - 1)
    ref = dsm[xi, yi]
    pred = height[ij[:, 0], ij[:, 1]]
    ok = np.isfinite(ref) & np.isfinite(pred)
    if not ok.any():
        return None
    return float(np.mean(np.abs(pred[ok] - ref[ok])))
