"""The Season-NeRF training loss.

The counterpart of ``season_nerf_tpu/train/losses.py``, branch for branch.
The loss is a dict ``name -> (value, weight)`` whose weighted sum is the
objective; every entry is logged.  ``.detach()`` stands where the JAX
package writes ``stop_gradient``.

- color: the Barron adaptive NLL over the unmerged rendered color, or the
  MSE over the merged color under ``use_mse_loss``; the plain MSE is always
  logged (detached under the adaptive loss);
- the prior phase adds the alpha-adjust terms (adaptive NLL and MSE of the
  per-sample hit probability against the supervised one);
- solar correction over synthetic sun rays: ``sum_s (vis - PV_exact)^2``
  and the absorption term, trained only under ``classic_solar``;
- the gated composite adds the sky-magnitude and albedo-floor terms (the
  floor divided by the batch size, as the reference does);
- under the adaptive loss the solar weights are divided by the detached
  mean color scale squared;
- the weight-1 diagnostic entries (``Color_alpha``, ``Color_width``, ...)
  carry detached values into ``Total``;
- the opt-in phase-4 keepalive keeps a decaying alpha-adjust term when the
  prior is off.

Randomness comes in through ``draws`` (see :func:`make_solar_rays` and
``train/engine.StepDraws``): the camera-pass jitter ``jitter`` [R, S], the
solar rays' ``solar_az``, ``solar_el`` [R], ``solar_xy`` [R, 2],
``solar_t`` [R, 2] and the solar-pass jitter ``solar_jitter`` [R, S];
with ``n_importance`` > 0 also the camera pass's importance samples'
``fine_u`` [R, n_importance] and ``fine_shift`` [R, n_importance, 1] (the
solar pass takes none).  A model in eval mode (the save-point ``Testing``
losses) samples without jitter, so its draws hold only the solar rays' and
the importance samples' (``train/engine.ValDraws``).

Under a training mesh (``mesh``, ``parallel/mesh.py``) ``batch`` and
``draws`` are this rank's rows, and every batch mean is this rank's share
of the global one: its sum over the global count.  The ranks' losses then
add up to the global loss, and their gradients, summed over the ranks, to
its gradient.  The albedo floor takes the minimum over the global batch;
it and the latents' detached means (:data:`REPLICATED`) are the same on
every rank.  :func:`logged_losses` gives what one process would log.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from season_nerf_torch.models.tnerf import supervised_sigma
from season_nerf_torch.ops import rendering, robust_loss
from season_nerf_torch.ops.robust_loss import AdaptiveCfg
from season_nerf_torch.parallel.mesh import all_reduce_sum, global_amin

# the entries every rank of a mesh computes whole; every other entry is a
# rank's share of a batch mean
REPLICATED = frozenset({"Color_alpha", "Color_width", "Alpha_alpha",
                        "Alpha_width", "Albedo_Color"})


class LossStatics(NamedTuple):
    """The switches of the loss, fixed for a phase."""
    n_samples: int
    use_prior: bool
    use_solar: bool
    classic_solar: bool
    use_mse_loss: bool
    sc_lambda: float
    phase_len: int             # the trust denominator (the phase's end step)
    color_cfg: Optional[AdaptiveCfg] = None
    alpha_cfg: Optional[AdaptiveCfg] = None
    prior_keepalive: float = 0.0
    phase_start: int = 0
    trunk_spec: Optional[object] = None   # ops/fused_train.TrunkSpec: the
    #                                       trunk through K1/K2 (ghost BN)
    n_importance: int = 0      # hierarchical samples a camera ray


def make_solar_rays(az, el, xy, t_ang, sun_frame=None):
    """Synthetic sun rays across the cube from their draws: azimuth ``az``
    in [-pi, pi) and elevation ``el`` in [1, 90) degrees (in radians) [R],
    start ``xy`` in [-1, 1)^2 at z = +1 [R, 2], periodic times ``t_ang`` in
    [0, 2 pi) [R, 2].  ``sun_frame`` [3, 3] maps ENU into the cube.
    -> (starts, ends (z = -1), sun vectors, t4)."""
    v = torch.stack([torch.cos(el) * torch.sin(az),
                     torch.cos(el) * torch.cos(az), torch.sin(el)], dim=1)
    if sun_frame is not None:
        v = v @ sun_frame.t()
        v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    starts = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=1)
    ends = starts - 2.0 * v / v[:, 2:3]
    t4 = torch.cat([torch.cos(t_ang[:, :1]), torch.sin(t_ang[:, :1]),
                    torch.cos(t_ang[:, 1:]), torch.sin(t_ang[:, 1:])], dim=1)
    return starts, ends, v, t4


def _batch_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the global batch: under a mesh this rank's
    share of it (its sum over the global count)."""
    if mesh is None:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * mesh.size)


def season_nerf_loss(model, ada_params, statics: LossStatics, batch, draws,
                     step: int, prior_hm=None, sun_frame=None, mesh=None):
    """-> (total, {name: (value, weight)}).  ``model`` in training mode
    updates its BatchNorm running statistics in place: the camera pass
    first, then the solar pass from there, as the JAX package composes
    them."""
    s = statics
    mean = lambda x: _batch_mean(x, mesh)
    model_trust = min(step / s.phase_len, 1.0) if s.use_prior else 1.0
    prior = prior_hm if s.use_prior else None
    spec = s.trunk_spec if model.training else None
    jitter = draws["jitter"] if model.training else None
    solar_jitter = draws["solar_jitter"] if model.training else None

    out = rendering.eval_rays(
        model, batch["top"], batch["bot"], batch["sun"], batch["t4"],
        n_samples=s.n_samples, n_importance=s.n_importance,
        fine_u=draws.get("fine_u"), fine_shift=draws.get("fine_shift"),
        classic_solar=s.classic_solar, jitter=jitter, prior_hm=prior,
        model_trust=model_trust, trunk_spec=spec)

    losses: Dict[str, Tuple[torch.Tensor, object]] = {}
    gt = batch["gt_rgb"]
    sc_w = s.sc_lambda

    if s.use_solar:
        tops_s, bots_s, sun_s, _ = make_solar_rays(
            draws["solar_az"], draws["solar_el"], draws["solar_xy"],
            draws["solar_t"], sun_frame)
        sol = rendering.eval_rho_only(
            model, tops_s, bots_s, sun_s, n_samples=s.n_samples,
            jitter=solar_jitter, prior_hm=prior,
            model_trust=model_trust, trunk_spec=spec)
        vis_s = sol["vis"][..., 0]
        pv_exact = sol["pv_exact"][..., 0].detach()
        solar_err = mean(torch.sum((vis_s - pv_exact) ** 2, dim=1))
        absorb = mean(1.0 - torch.sum(
            sol["pe"][..., 0].detach() * pv_exact * vis_s, dim=1))
        losses["Solar_Correction"] = (solar_err, sc_w)
        losses["Solar_Correction_2"] = (
            absorb if s.classic_solar else absorb.detach(), sc_w)
        if not s.classic_solar:
            ranks = mesh.size if mesh is not None else 1
            alb_min = global_amin(out["albedo"], mesh)
            viol = torch.clamp(1.0 - alb_min / 0.2, min=0.0)
            alb_floor = torch.sum(viol ** 2) / (out["albedo"].shape[0] * ranks)
            sk = (out["sky"] - 0.5) / 0.5
            sk_loss = torch.sum(torch.clamp(sk, min=0.0) ** 2) / (
                sk.numel() * ranks)
            if s.use_prior:
                sk_loss = sk_loss.detach()
            losses["Sky_Color_Var"] = (sk_loss, sc_w)
            losses["Albedo_Color"] = (alb_floor, sc_w)

    rendered_for_mse = (out["rendered_merged"]
                        if (s.use_prior and model.training)
                        else out["rendered"])
    mse_color = mean((rendered_for_mse - gt) ** 2)

    if s.use_mse_loss:
        losses["Color"] = (mse_color, 1.0)
        if s.use_prior:
            losses["Alpha_Adjust"] = (
                mean((out["pe"] - out["pe_sup"].detach()) ** 2), 1.0)
    else:
        c_cfg = s.color_cfg
        color_ada = mean(robust_loss.adaptive_nll(
            ada_params["color"], c_cfg, out["rendered"] - gt))
        scale_mean = torch.mean(
            robust_loss.scale_of(ada_params["color"], c_cfg)).detach()
        alpha_mean = torch.mean(
            robust_loss.alpha_of(ada_params["color"], c_cfg)).detach()
        losses["Color_ada"] = (color_ada, 1.0)
        losses["Color_alpha"] = (alpha_mean, 1.0)
        losses["Color_width"] = (scale_mean, 1.0)
        losses["Color"] = (mse_color.detach(), 1.0)
        inv_scale_sq = 1.0 / (scale_mean ** 2)
        if "Solar_Correction" in losses:
            for k in ("Solar_Correction", "Solar_Correction_2"):
                losses[k] = (losses[k][0], sc_w * inv_scale_sq)
        if s.use_prior:
            a_cfg = s.alpha_cfg
            pe_sup = out["pe_sup"].detach()
            losses["Alpha_Adjust_ada"] = (mean(robust_loss.adaptive_nll(
                ada_params["alpha"], a_cfg,
                (out["pe"] - pe_sup).reshape(-1, 1))), 1.0)
            losses["Alpha_Adjust"] = (mean((out["pe"] - pe_sup) ** 2), 1.0)
            losses["Alpha_alpha"] = (torch.mean(robust_loss.alpha_of(
                ada_params["alpha"], a_cfg)).detach(), 1.0)
            losses["Alpha_width"] = (torch.mean(robust_loss.scale_of(
                ada_params["alpha"], a_cfg)).detach(), 1.0)

    if (not s.use_prior) and s.prior_keepalive > 0 and prior_hm is not None:
        deltas = out["deltas"]
        rho_sup = supervised_sigma(prior_hm, out["pts"].reshape(-1, 3),
                                   deltas.reshape(-1, 1)).reshape(deltas.shape)
        _, pe_sup, _ = rendering.pv_pe_ps(rho_sup, deltas)
        pe_sup = pe_sup.detach()
        span = max(s.phase_len - s.phase_start, 1)
        w = s.prior_keepalive * min(max((s.phase_len - step) / span, 0.0),
                                    1.0)
        mse_pe = mean((out["pe"] - pe_sup) ** 2)
        if s.alpha_cfg is not None and not s.use_mse_loss:
            losses["Alpha_Adjust_ada"] = (mean(robust_loss.adaptive_nll(
                ada_params["alpha"], s.alpha_cfg,
                (out["pe"] - pe_sup).reshape(-1, 1))), w)
            losses["Alpha_Adjust"] = (mse_pe.detach(), 1.0)
        else:
            losses["Alpha_Adjust"] = (mse_pe, w)

    total = sum(v * w for v, w in losses.values())
    return total, losses


def logged_losses(total, losses, mesh=None) -> Dict[str, torch.Tensor]:
    """The values a step logs: every loss and ``Total``, detached.  Under
    a mesh the shares are summed over the ranks (one all-reduce) and
    ``Total`` is formed again from the sums, so every rank holds what one
    process on the global batch logs."""
    out = {k: v.detach() for k, (v, _) in losses.items()}
    if mesh is None:
        out["Total"] = total.detach()
        return out
    shares = [k for k in out if k not in REPLICATED]
    if shares:
        summed = all_reduce_sum(torch.stack([out[k] for k in shares]), mesh)
        out.update(zip(shares, summed.unbind()))
    out["Total"] = sum(out[k] * w for k, (_, w) in losses.items())
    return out
