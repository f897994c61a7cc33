"""Volume rendering: transmittance, compositing, and the ray evaluators.

The counterpart of ``season_nerf_tpu/ops/rendering.py``.  Two
illumination composites exist, selected by ``classic_solar`` (the
reference's ``Solar_Type_2``):

  classic: C = sum_s PS * col * (vis + (1 - vis) * sky)
  gated:   g = sigmoid((sum_s detached(vis) * PS - 0.2) * 30)
           C = (sum_s PS * col) * (g + (1 - g) * mean_s sky)

The model's mode is the JAX ``train`` flag.  In training mode the caller
passes the sample jitter; a ``trunk_spec`` sends the trunk through the
fused training kernels (``ops/fused_train``, ghost BatchNorm); a
``prior_hm`` adds the DSM-prior branches and the trust merge;
``n_importance`` adds hierarchical samples, placed by a density-only
coarse pass in eval mode (through the inference trunk, K3 on the card).
"""

from __future__ import annotations

import contextlib

import torch

from season_nerf_torch.models.tnerf import supervised_sigma
from season_nerf_torch.ops.sampling import (out_of_cube, sample_coarse,
                                            sample_fine)


def transmittance(rho, deltas):
    """P_visible before each sample: exp(-exclusive cumsum(rho * delta)).
    rho/deltas: [R, S, 1]."""
    acc = torch.cumsum(rho * deltas, dim=1)
    acc = torch.cat([torch.zeros_like(acc[:, :1]), acc[:, :-1]], dim=1)
    return torch.exp(-acc)


def pv_pe_ps(rho, deltas):
    """-> (PV, PE, PS): visibility, per-sample hit prob, surface prob."""
    pv = transmittance(rho, deltas)
    pe = 1.0 - torch.exp(-rho * deltas)
    return pv, pe, pv * pe


def composite_classic(ps, col, vis, sky):
    """S-NeRF irradiance composite."""
    return torch.sum(ps * col * (vis + (1.0 - vis) * sky), dim=1)


def gated_visibility(ps, vis):
    """Scalar per-ray sun gate from the detached per-sample visibility."""
    g = torch.sum(vis.detach() * ps, dim=1)
    return torch.sigmoid((g - 0.2) * 30.0)


def expected_surface(ps, pts, deltas):
    """Expected surface point and distance along the ray."""
    denom = torch.sum(ps, dim=1) + 1e-8
    loc = torch.sum(ps * pts, dim=1) / denom
    dist = torch.sum(ps * torch.cumsum(deltas, dim=1), dim=1) / denom
    return loc, dist


def broadcast_rays(a, n_samples):
    """[R, D] per-ray values -> [R * S, D] per-sample rows."""
    R, D = a.shape
    return a[:, None, :].expand(R, n_samples, D).reshape(-1, D)


@contextlib.contextmanager
def running_statistics(model):
    """``model`` in eval mode and without autograd for the block: its
    BatchNorms normalise with their running statistics and update none.
    Afterwards every submodule has the mode it had; a model that was
    training drops the fold the block built (``GNeRF.train``), since the
    weights change before its next evaluation."""
    modes = [(m, m.training) for m in model.modules()]
    if model.training:
        model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        if modes[0][1]:
            model.train()
            for m, mode in modes:
                m.training = mode


def eval_rays(model, tops, bots, sun, t4, *, n_samples, n_importance=0,
              fine_u=None, fine_shift=None, classic_solar=False,
              mask_out_of_cube=False, jitter=None, prior_hm=None,
              model_trust=1.0, trunk_spec=None):
    """Render a batch of rays (the JAX ``eval_rays``).

    tops/bots/sun: [R, 3]; t4: [R, 4]; ``jitter`` [R, S] in training.
    ``n_importance`` > 0 adds that many samples per ray by
    :func:`sample_fine` from the draws ``fine_u`` [R, n_importance] and
    ``fine_shift`` [R, n_importance, 1], weighted by the hit probabilities
    of a density-only pass over the S coarse samples in eval mode without
    gradient (:func:`running_statistics`, in either mode of the model, as
    the JAX package's ``train=False`` pass); everything after sees the
    S + n_importance merged samples.  ``mask_out_of_cube`` zeroes the step
    of samples outside the unit cube (whole-image renders, whose edge rays
    leave the volume).  ``prior_hm`` [H, W] adds the supervised and
    trust-merged branches of the prior phase.  ``trunk_spec`` (training
    mode only) runs the trunk through K1/K2.  Returns the results dict."""
    R, S = tops.shape[0], n_samples
    pts, deltas = sample_coarse(tops, bots, S, jitter=jitter)
    if n_importance > 0:
        with running_statistics(model):
            rho_c = model.sigma_only(pts.reshape(-1, 3)).reshape(R, S, 1)
        _, _, ps_c = pv_pe_ps(rho_c, deltas)
        pts, deltas = sample_fine(tops, bots, pts, ps_c[..., 0],
                                  n_importance, fine_u, fine_shift)
        S = S + n_importance
    if mask_out_of_cube:
        deltas = torch.where(out_of_cube(pts)[..., None],
                             torch.zeros_like(deltas), deltas)
    flat = pts.reshape(-1, 3)
    # the class, sun-encoding and sky branches depend on per-ray inputs
    # only: evaluate once per ray, broadcast to the samples
    probs_r, sun_pe_r, sky_raw_r = model.ray_consts(sun, t4)
    probs_f, sun_pe_f, sky_raw_f = (broadcast_rays(a, S) for a in
                                    (probs_r, sun_pe_r, sky_raw_r))
    if trunk_spec is not None and model.training:
        from season_nerf_torch.ops.fused_train import fused_forward
        out = fused_forward(model, trunk_spec, flat, probs_f, sun_pe_f,
                            sky_raw_f)
    else:
        out = model(flat, None, None, probs=probs_f, sun_pe=sun_pe_f,
                    sky_raw=sky_raw_f)
    rho = out["rho"].reshape(R, S, 1)
    col = out["col"].reshape(R, S, -1)
    vis = out["vis"].reshape(R, S, 1)
    sky = out["sky"].reshape(R, S, -1)

    pv, pe, ps = pv_pe_ps(rho, deltas)
    albedo = torch.sum(ps * col, dim=1)
    if classic_solar:
        rendered, gate = composite_classic(ps, col, vis, sky), None
    else:
        gate = gated_visibility(ps, vis)
        rendered = albedo * (gate + (1.0 - gate) * torch.mean(sky, dim=1))
    results = {
        "rendered": rendered, "albedo": albedo,
        "pv": pv, "pe": pe, "ps": ps,
        "rho": rho, "col": col, "vis": vis, "sky": sky,
        "class_probs": out["class_probs"].reshape(R, S, -1),
        "adjust": out["adjust"].reshape(R, S, -1),
        "pts": pts, "deltas": deltas,
    }
    if prior_hm is not None:
        rho_sup = supervised_sigma(prior_hm, flat, deltas.reshape(-1, 1))
        rho_sup = rho_sup.reshape(R, S, 1)
        pv_s, pe_s, ps_s = pv_pe_ps(rho_sup, deltas)
        rho_m = rho * model_trust + rho_sup * (1.0 - model_trust)
        pv_m, pe_m, ps_m = pv_pe_ps(rho_m, deltas)
        albedo_m = torch.sum(ps_m * col, dim=1)
        if classic_solar:
            rendered_sup = composite_classic(ps_s, col, vis, sky)
            rendered_m = composite_classic(ps_m, col, vis, sky)
        else:
            shade = gate + (1.0 - gate) * torch.mean(sky, dim=1)
            rendered_sup = torch.sum(ps_s * col, dim=1) * shade
            rendered_m = albedo_m * shade
        results.update({
            "rho_sup": rho_sup, "pv_sup": pv_s, "pe_sup": pe_s,
            "ps_sup": ps_s, "rendered_sup": rendered_sup,
            "rho_merged": rho_m, "pv_merged": pv_m, "pe_merged": pe_m,
            "ps_merged": ps_m, "rendered_merged": rendered_m,
            # with a prior the albedo used downstream is the merged one
            "albedo": albedo_m,
        })
    return results


def eval_rho_only(model, tops, bots, sun, *, n_samples, jitter=None,
                  prior_hm=None, model_trust=1.0, trunk_spec=None):
    """Density and solar visibility along sun rays (the solar-correction
    pass).  No gradient reaches the trunk (``forward_solar``).  With a
    prior, in-cube samples use the trust-merged density.  Returns the
    results dict."""
    R, S = tops.shape[0], n_samples
    pts, deltas = sample_coarse(tops, bots, S, include_end=True,
                                jitter=jitter)
    flat = pts.reshape(-1, 3)
    _, sun_pe_r, sky_raw_r = model.ray_consts(sun, None)
    sun_pe_f, sky_raw_f = (broadcast_rays(a, S) for a in
                           (sun_pe_r, sky_raw_r))
    if trunk_spec is not None and model.training:
        from season_nerf_torch.ops.fused_train import fused_forward_solar
        out = fused_forward_solar(model, trunk_spec, flat, sun_pe_f,
                                  sky_raw_f)
    else:
        out = model.forward_solar(flat, None, sun_pe=sun_pe_f,
                                  sky_raw=sky_raw_f)
    rho = out["rho"].reshape(R, S, 1)
    if prior_hm is not None:
        # supervision clamped to in-cube samples
        good = torch.all((flat <= 1.0) & (flat >= -1.0), dim=1)
        rho_sup = supervised_sigma(prior_hm, flat, deltas.reshape(-1, 1))
        rho_sup = torch.where(good[:, None], rho_sup, out["rho"].detach())
        rho_eff = rho * model_trust + rho_sup.reshape(R, S, 1) * (
            1.0 - model_trust)
    else:
        rho_eff = rho
    pv, pe, _ = pv_pe_ps(rho_eff, deltas)
    return {"pe": pe, "pv_exact": pv, "vis": out["vis"].reshape(R, S, 1),
            "sky_raw": out["sky_raw"].reshape(R, S, -1),
            "pts": pts, "deltas": deltas}
