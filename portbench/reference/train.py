"""The plain reference of one Season-NeRF training step in phase 1 (the
DSM prior on), in float32.

The step of the paper's trainer (EnterpriseCV-6/Season-NeRF), as the
benchmark's training cells run it: a batch of rays from the ray table,
stratified samples with the step's jitter, the camera pass through the
network, the supervised density of the prior DSM merged with the model's
by the trust ``step / phase_end``, the gated composite, the Barron
adaptive NLL of the colour (learned alpha and scale), the adaptive and
squared losses of the hit probabilities against the prior's, the solar
correction over synthetic sun rays, the sky and albedo-floor terms, then
one Adam update of the network and one of the loss's latents, each at
its OneCycle rate.  Every random number comes in through ``draws``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import Net, positional, PE_SOLAR

COLOR = dict(alpha_lo=0.001, alpha_hi=2.99, alpha_init=2.0, scale_lo=0.01,
             scale_init=0.03)
ALPHA = dict(alpha_lo=0.001, alpha_hi=2.99, alpha_init=2.0, scale_lo=0.05,
             scale_init=0.5)
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


# -- rays and compositing ---------------------------------------------------
def sample_coarse(tops, bots, n, jitter=None, include_end=False):
    """Samples along top -> bot: bin starts of [0, 1) moved by
    ``jitter / n`` (or, without jitter and with ``include_end``, n points
    spanning [0, 1]); the step |top - bot| / n for each."""
    if include_end and jitter is None:
        ts = torch.linspace(0.0, 1.0, n, device=tops.device)
    else:
        ts = torch.arange(n, dtype=torch.float32, device=tops.device) / n
    ts = ts[None, :].expand(tops.shape[0], n)
    if jitter is not None:
        ts = ts + jitter / n
    ts = ts[:, :, None]
    pts = tops[:, None, :] * (1.0 - ts) + bots[:, None, :] * ts
    step = torch.linalg.norm(tops - bots, dim=1) / n
    return pts, step[:, None, None].expand(tops.shape[0], n, 1)


def hit_probs(rho, deltas):
    """-> (P visible before each sample, P hit at it, P surface there)."""
    acc = torch.cumsum(rho * deltas, 1)
    pv = torch.exp(-(acc - rho * deltas))
    pe = 1.0 - torch.exp(-rho * deltas)
    return pv, pe, pv * pe


def prior_sigma(hm, pts, deltas, eps=0.99):
    """The prior DSM's density: occupied below its height (missing cells
    at -4), as the hit probability ``min(occupied, eps)`` over a step."""
    H, W = hm.shape
    hm = torch.nan_to_num(hm, nan=-4.0)
    r = ((pts[:, 0] + 1.0) / 2.0 * (H - 1)).long().clamp(0, H - 1)
    c = ((pts[:, 1] + 1.0) / 2.0 * (W - 1)).long().clamp(0, W - 1)
    occ = (hm[r, c] >= pts[:, 2]).float().clamp(max=eps)
    return -torch.log(1.0 - occ[:, None]) / deltas


def sun_rays(az, el, xy, t_ang):
    """Synthetic sun rays across the cube from z = +1 to z = -1."""
    v = torch.stack([torch.cos(el) * torch.sin(az),
                     torch.cos(el) * torch.cos(az), torch.sin(el)], 1)
    starts = torch.cat([xy, torch.ones_like(xy[:, :1])], 1)
    return starts, starts - 2.0 * v / v[:, 2:3], v


# -- the adaptive robust loss (Barron 2019) -------------------------------
def alpha_grid() -> np.ndarray:
    """The alphas at which the adaptive loss tabulates log Z, linear in
    between: 96 from 0.01 below 0.2, then 416 from 0.2 to 3.0."""
    return np.concatenate([np.linspace(0.01, 0.2, 96, endpoint=False),
                           np.linspace(0.2, 3.0, 416)])


def log_partition(alphas, eps=1e-6, u_max=200.0, panels=2000, nodes=8
                  ) -> np.ndarray:
    """log Z(alpha) = log 2 int_0^inf exp(-rho(x, alpha, 1)) dx for each
    alpha, in float64: x = sinh(u), Gauss-Legendre on ``panels`` equal
    panels of u in [0, u_max] (rho grows like |x|^alpha, so alpha = 0.01
    needs x out to ~e^200).  Converged to ~1e-15 at these settings."""
    t, w = np.polynomial.legendre.leggauss(nodes)
    h = u_max / panels
    u = ((np.arange(panels)[:, None] + (t[None, :] + 1.0) / 2.0) * h
         ).ravel()
    wu = np.tile(w * h / 2.0, panels) * np.cosh(u)
    x2 = np.sinh(u) ** 2
    out = []
    for a in np.asarray(alphas, np.float64):
        b, d = abs(a - 2.0) + eps, a + eps
        rho = (b / d) * np.expm1(0.5 * d * np.log1p(x2 / b))
        out.append(math.log(2.0 * float(np.sum(wu * np.exp(-rho)))))
    return np.array(out)


@functools.lru_cache(maxsize=1)
def _table() -> Tuple[np.ndarray, np.ndarray]:
    g = alpha_grid()
    return g, log_partition(g)


class Adaptive:
    """alpha = lo + (hi - lo) sigmoid(latent + offset), scale = lo + (init
    - lo) softplus(latent + softplus^-1(1)); both latents start at 0."""

    def __init__(self, channels, device, alpha_lo, alpha_hi, alpha_init,
                 scale_lo, scale_init):
        self.a = (alpha_lo, alpha_hi, alpha_init)
        self.s = (scale_lo, scale_init)
        self.latent_alpha = torch.zeros(1, channels, device=device,
                                        requires_grad=True)
        self.latent_scale = torch.zeros(1, channels, device=device,
                                        requires_grad=True)
        alphas, logz = _table()
        self.alphas = torch.tensor(alphas, dtype=torch.float32,
                                   device=device)
        self.logz = torch.tensor(logz, dtype=torch.float32, device=device)

    def alpha(self):
        lo, hi, ref = self.a
        return lo + (hi - lo) * torch.sigmoid(
            self.latent_alpha + math.log((ref - lo) / (hi - ref)))

    def scale(self):
        lo, ref = self.s
        one = math.log(math.e - 1.0)
        return lo + (ref - lo) * F.softplus(self.latent_scale + one) / \
            F.softplus(torch.tensor(one))

    def log_z(self, alpha):
        a = alpha.clamp(float(self.alphas[0]), float(self.alphas[-1]))
        i = torch.searchsorted(self.alphas, a.detach().contiguous(),
                               right=True).clamp(1, len(self.alphas) - 1)
        x0, x1 = self.alphas[i - 1], self.alphas[i]
        return self.logz[i - 1] + (a - x0) / (x1 - x0) * (
            self.logz[i] - self.logz[i - 1])

    def nll(self, x):
        alpha, scale = self.alpha(), self.scale()
        b = torch.abs(alpha - 2.0) + 1e-6
        d = alpha + 1e-6
        rho = (b / d) * torch.expm1(0.5 * d * torch.log1p(
            (x / scale) ** 2 / b))
        return rho + torch.log(scale) + self.log_z(alpha)


# -- the loss -------------------------------------------------------------
def phase1_loss(net: Net, color: Adaptive, alpha: Adaptive, batch, draws,
                step, prior_hm, n_samples, phase_end, sc_lambda=0.03
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total, {term: value}) of one step in phase 1."""
    S = n_samples
    tops, bots, sun, t4, gt = (batch[k] for k in
                               ("top", "bot", "sun", "t4", "gt_rgb"))
    R = tops.shape[0]
    trust = min(step / phase_end, 1.0)

    # camera rays
    pts, deltas = sample_coarse(tops, bots, S, jitter=draws["jitter"])
    flat = pts.reshape(-1, 3)
    sun_pe = positional(sun, PE_SOLAR)
    out = net.points(flat, sun_pe, net.sky(sun_pe), net.class_probs(t4), S)
    rho, col, vis, sky = (out[k].reshape(R, S, -1)
                          for k in ("rho", "col", "vis", "sky"))
    _, pe, ps = hit_probs(rho, deltas)
    gate = torch.sigmoid(((vis.detach() * ps).sum(1) - 0.2) * 30.0)
    shade = gate + (1.0 - gate) * sky.mean(1)
    rendered = (ps * col).sum(1) * shade
    rho_sup = prior_sigma(prior_hm, flat, deltas.reshape(-1, 1)).reshape(
        R, S, 1)
    _, pe_sup, _ = hit_probs(rho_sup, deltas)
    _, _, ps_m = hit_probs(rho * trust + rho_sup * (1.0 - trust), deltas)
    albedo_m = (ps_m * col).sum(1)
    rendered_m = albedo_m * shade

    # sun rays
    s_top, s_bot, s_vec = sun_rays(draws["solar_az"], draws["solar_el"],
                                   draws["solar_xy"], draws["solar_t"])
    s_pts, s_deltas = sample_coarse(s_top, s_bot, S, include_end=True,
                                    jitter=draws["solar_jitter"])
    s_flat = s_pts.reshape(-1, 3)
    s_rho, s_vis = net.solar_points(s_flat, positional(s_vec, PE_SOLAR), S)
    inside = ((s_flat <= 1.0) & (s_flat >= -1.0)).all(1)
    s_sup = torch.where(inside[:, None],
                        prior_sigma(prior_hm, s_flat,
                                    s_deltas.reshape(-1, 1)), s_rho)
    s_eff = (s_rho * trust + s_sup * (1.0 - trust)).reshape(R, S, 1)
    s_pv, s_pe, _ = hit_probs(s_eff, s_deltas)
    s_vis, s_pv, s_pe = (a[..., 0] for a in
                         (s_vis.reshape(R, S, 1), s_pv.detach(), s_pe))
    solar = ((s_vis - s_pv) ** 2).sum(1).mean()
    absorb = (1.0 - (s_pe.detach() * s_pv * s_vis).sum(1)).mean().detach()
    floor = (torch.clamp(1.0 - albedo_m.amin(0) / 0.2, min=0.0) ** 2
             ).sum() / R
    sky_var = (torch.clamp((sky - 0.5) / 0.5, min=0.0) ** 2).sum().detach() \
        / sky.numel()

    # colour and hit-probability terms
    width = color.scale().mean().detach()
    pe_gap = pe - pe_sup.detach()
    terms = {
        "Color_ada": (color.nll(rendered - gt).mean(), 1.0),
        "Color_alpha": (color.alpha().mean().detach(), 1.0),
        "Color_width": (width, 1.0),
        "Color": (((rendered_m - gt) ** 2).mean().detach(), 1.0),
        "Solar_Correction": (solar, sc_lambda / width ** 2),
        "Solar_Correction_2": (absorb, sc_lambda / width ** 2),
        "Sky_Color_Var": (sky_var, sc_lambda),
        "Albedo_Color": (floor, sc_lambda),
        "Alpha_Adjust_ada": (alpha.nll(pe_gap.reshape(-1, 1)).mean(), 1.0),
        "Alpha_Adjust": ((pe_gap ** 2).mean(), 1.0),
        "Alpha_alpha": (alpha.alpha().mean().detach(), 1.0),
        "Alpha_width": (alpha.scale().mean().detach(), 1.0),
    }
    total = sum(v * w for v, w in terms.values())
    return total, {k: v.detach() for k, (v, _) in terms.items()}


# -- the optimisers -----------------------------------------------------------
def onecycle(peak, total, count, pct=0.3, div=25.0, final_div=1e4):
    """The rate at ``count``: a cosine rise from peak / 25 over the first
    30 % of ``total`` steps, then a cosine fall to peak / 25 / 1e4."""
    warm = max(int(pct * total), 1)
    init = peak / div
    if count < warm:
        return init + (peak - init) * 0.5 * (1 - math.cos(math.pi * count
                                                          / warm))
    final = init / final_div
    frac = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    return final + (peak - final) * 0.5 * (1 + math.cos(math.pi * frac))


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) with a rate set each step."""

    def __init__(self, leaves):
        self.leaves = list(leaves)
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, lr):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(b1).add_((1 - b1) * p.grad)
            v.mul_(b2).add_((1 - b2) * p.grad * p.grad)
            p.sub_(lr / c1 * m / (torch.sqrt(v) / math.sqrt(c2) + ADAM_EPS))
            p.grad = None
