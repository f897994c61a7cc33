"""Novel-view rendering: the inference stack, in PyTorch.

The render surfaces of ``season_nerf_tpu/render/renderer.py``:

- whole-image render at any view/sun angle and time (``render_img``), with
  optional exact secondary-ray shadows, and the nadir height map
  (``get_dsm``);
- per-sample raw component capture (``component_render``, by view
  direction or through a fitted camera) and its compositing into display
  images (``images_from_components``);
- free perspective cameras (``render_perspective``);
- opt-in depth-guided fast rendering (``Renderer(fast_render=(n_coarse,
  n_fine))``): a density-only pass over ``n_coarse`` samples finds each
  ray's surface window (:func:`surface_window`), then the full network
  runs on ``n_fine`` samples inside it (:func:`render_chunk_outputs_fast`),
  on the composite and the component paths alike.  The evaluation never
  sets it, so its scores always come from the uniform sampler.

Rays are processed ``chunk`` rays per dispatch on the composite paths and
``chunk`` points per dispatch on the exact-solar path; every dispatch runs
the network once through the fused trunk kernel.  Results stay on the
device until the frame is done, then cross to the host once.

``Renderer(mesh=...)`` renders on a mesh of devices (``parallel/mesh.py``)
in this one process: ``chunk`` is rounded up to a multiple of its size,
each device holds a replica of the model (its trunk folded there), and
every chunk's rays are split over the replicas in order, each part run on
its device (K3 there) and the results gathered on the first.  Every ray is
independent, so the image is the one device's.

Spans (``utils/trace``): ``render.frame`` around ``render_img``, inside it
``render.rays`` (the rays, on the host) and ``render.scatter`` (the
images assembled on the host); ``render.chunk`` around each chunk's puts
and dispatch and ``render.gather`` around the copy back, where the host
waits for the device.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from season_nerf_torch.ops import rendering
from season_nerf_torch.ops.sampling import out_of_cube, sample_coarse
from season_nerf_torch.utils import heartbeat, trace


def encode_time(year_frac, day_frac=0.0):
    """4-dim periodic time encoding."""
    return np.array([np.cos(year_frac * 2 * np.pi),
                     np.sin(year_frac * 2 * np.pi),
                     np.cos(day_frac * 2 * np.pi),
                     np.sin(day_frac * 2 * np.pi)], dtype=np.float32)


def dir_grid_rays(view_vec, out_size):
    """Rays for an orthographic view along ``view_vec`` over the cube
    footprint: a grid on the z=0 plane, extended to z=+-1.
    -> (tops, bots, img_pts)."""
    h, w = out_size[0], out_size[1]
    xs = np.linspace(1, -1, h)
    ys = np.linspace(-1, 1, w)
    XY = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    XYZ = np.concatenate([XY, np.zeros((XY.shape[0], 1))], 1)
    v = np.asarray(view_vec, np.float64)
    tops = XYZ + (v / v[2])[None, :]
    bots = XYZ - (v / v[2])[None, :]
    img_pts = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                   indexing="ij"), -1).reshape(-1, 2)
    return tops.astype(np.float32), bots.astype(np.float32), img_pts


def perspective_rays(position, pitch_deg, yaw_deg, fov_deg, out_size,
                     z_clip=(1.0, -1.0)):
    """Free perspective camera rays: camera at ``position`` (cube coords),
    pitched down from horizontal and yawed about z, square FOV, clipped to
    the cube's z range.  -> (tops, bots, img_pts)."""
    h, w = out_size[0], out_size[1]
    fy = np.tan(np.deg2rad(fov_deg) / 2)
    V, U = np.meshgrid(np.linspace(fy, -fy, h), np.linspace(-fy, fy, w),
                       indexing="ij")
    d = np.stack([np.ones_like(U), U, V], -1).reshape(-1, 3)
    cp, sp = np.cos(np.deg2rad(pitch_deg)), np.sin(np.deg2rad(pitch_deg))
    cy, sy = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    R_pitch = np.array([[cp, 0, -sp], [0, 1, 0], [sp, 0, cp]])
    R_yaw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    d = d @ (R_yaw @ R_pitch).T
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    p = np.asarray(position, np.float64)
    dz = np.where(np.abs(d[:, 2]) < 1e-6, -1e-6, d[:, 2])
    t_top = (z_clip[0] - p[2]) / dz
    t_bot = (z_clip[1] - p[2]) / dz
    t0 = np.maximum(np.minimum(t_top, t_bot), 0.0)
    t1 = np.maximum(t_top, t_bot)
    tops = p[None] + t0[:, None] * d
    bots = p[None] + t1[:, None] * d
    img_pts = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                   indexing="ij"), -1).reshape(-1, 2)
    good = t1 > t0
    return (tops[good].astype(np.float32), bots[good].astype(np.float32),
            img_pts[good])


def camera_grid_rays(cam, out_size):
    """Rays through a fitted camera on an ``out_size`` grid of its image
    plane, kept where both ends stay inside the cube's x and y range
    -> (tops, bots, img_pts, gt_img_pts): grid and source-image pixels."""
    h_img, w_img = cam.img_shape[0], cam.img_shape[1]
    rr = np.round(np.linspace(0, h_img - 1, out_size[0])).astype(int)
    cc = np.round(np.linspace(0, w_img - 1, out_size[1])).astype(int)
    RC = np.stack(np.meshgrid(rr, cc, indexing="ij"), -1).reshape(-1, 2)
    x1, y1, _ = cam.backproject(RC[:, 0], RC[:, 1], 1.0)
    x0, y0, _ = cam.backproject(RC[:, 0], RC[:, 1], -1.0)
    tops = np.stack([x1, y1, np.ones_like(x1)], -1).astype(np.float32)
    bots = np.stack([x0, y0, -np.ones_like(x0)], -1).astype(np.float32)
    good = np.all((tops[:, :2] >= -1) & (tops[:, :2] <= 1)
                  & (bots[:, :2] >= -1) & (bots[:, :2] <= 1), axis=1)
    img_pts = np.stack(np.meshgrid(np.arange(out_size[0]),
                                   np.arange(out_size[1]),
                                   indexing="ij"), -1).reshape(-1, 2)
    return tops[good], bots[good], img_pts[good], RC[good]


def render_chunk_outputs(model, tops, bots, sun, t4, *, n_samples: int,
                         classic_solar: bool, with_samples: bool = False):
    """The full-composite per-chunk contract: per-ray rendered color, raw
    shadow visibility, expected surface height, accumulated opacity.
    ``with_samples`` also returns the per-sample hit weights and points,
    so an exact-shadow pass casts its secondary rays from the samples the
    composite used."""
    out = rendering.eval_rays(model, tops, bots, sun, t4,
                              n_samples=n_samples,
                              classic_solar=classic_solar,
                              mask_out_of_cube=True)
    surf, _ = rendering.expected_surface(out["ps"], out["pts"],
                                         out["deltas"])
    res = {"rendered": out["rendered"],
           "shadow_raw": torch.sum(out["ps"] * out["vis"], dim=1)[:, 0],
           "height": surf[:, 2], "ps_sum": torch.sum(out["ps"], dim=(1, 2))}
    if with_samples:
        res["ps"] = out["ps"][:, :, 0]
        res["pts"] = out["pts"]
    return res


def surface_window(model, tops, bots, n_coarse: int,
                   support_frac: float = 0.05, margin_bins: float = 1.5):
    """Each ray's surface window from a density-only pass over
    ``n_coarse`` samples spanning [0, 1] inclusive: the smallest interval
    of ray fractions covering every sample whose hit probability exceeds
    ``support_frac`` of the ray's largest (both modes of a bimodal ray),
    padded by ``margin_bins`` coarse bins.  A ray with no surface evidence
    (largest hit probability under 1e-6) takes the whole [0, 1]; then the
    window is clipped into [0, 1] and to at least two coarse bins.
    -> (t_lo, t_hi), fractions along top -> bot, each [R]."""
    R = tops.shape[0]
    pts_c, deltas_c = sample_coarse(tops, bots, n_coarse, include_end=True)
    rho_c = model.sigma_only(pts_c.reshape(-1, 3)).reshape(R, n_coarse, 1)
    ps_c = rendering.pv_pe_ps(rho_c, deltas_c)[2][..., 0]      # [R, Sc]
    ts_c = torch.linspace(0.0, 1.0, n_coarse, device=tops.device)[None]
    max_ps = torch.amax(ps_c, dim=1, keepdim=True)
    support = ps_c > support_frac * max_ps
    pad = margin_bins / n_coarse
    t_lo = torch.amin(torch.where(support, ts_c, 1.0), dim=1) - pad
    t_hi = torch.amax(torch.where(support, ts_c, 0.0), dim=1) + pad
    empty = max_ps[:, 0] < 1e-6
    t_lo = torch.where(empty, 0.0, t_lo)
    t_hi = torch.where(empty, 1.0, t_hi)
    min_w = 2.0 / n_coarse
    t_lo = torch.clamp(t_lo, 0.0, 1.0 - min_w)
    t_hi = torch.clamp(torch.maximum(t_hi, t_lo + min_w), 0.0, 1.0)
    return t_lo, t_hi


def window_points(tops, bots, t_lo, t_hi, n_fine: int):
    """``n_fine`` bin-centre samples of each ray's [t_lo, t_hi] window ->
    (pts [R, n_fine, 3], deltas [R, n_fine, 1], constant per ray)."""
    R = tops.shape[0]
    ts_f = (torch.arange(n_fine, dtype=torch.float32, device=tops.device)
            + 0.5) / n_fine
    tt = (t_lo[:, None] + (t_hi - t_lo)[:, None] * ts_f[None, :])[..., None]
    pts = tops[:, None, :] * (1.0 - tt) + bots[:, None, :] * tt
    raylen = torch.sqrt(torch.sum((tops - bots) ** 2, dim=1))
    deltas = ((t_hi - t_lo) * raylen / n_fine)[:, None, None]
    return pts, deltas.expand(R, n_fine, 1)


def render_chunk_outputs_fast(model, tops, bots, sun, t4, *, n_coarse: int,
                              n_fine: int, classic_solar: bool,
                              with_samples: bool = False,
                              support_frac: float = 0.05,
                              margin_bins: float = 1.5):
    """The contract of :func:`render_chunk_outputs` by depth-guided
    sampling: :func:`surface_window` from ``n_coarse`` density-only
    samples, then the full network on ``n_fine`` samples inside the window
    (:func:`window_points`, steps zeroed outside the cube), composited as
    the uniform path composites."""
    R = tops.shape[0]
    t_lo, t_hi = surface_window(model, tops, bots, n_coarse, support_frac,
                                margin_bins)
    pts, deltas = window_points(tops, bots, t_lo, t_hi, n_fine)
    deltas = torch.where(out_of_cube(pts)[..., None],
                         torch.zeros_like(deltas), deltas)
    probs_r, sun_pe_r, sky_raw_r = model.ray_consts(sun, t4)
    bc = rendering.broadcast_rays
    out = model(pts.reshape(-1, 3), None, None, probs=bc(probs_r, n_fine),
                sun_pe=bc(sun_pe_r, n_fine), sky_raw=bc(sky_raw_r, n_fine))
    rho = out["rho"].reshape(R, n_fine, 1)
    col = out["col"].reshape(R, n_fine, -1)
    vis = out["vis"].reshape(R, n_fine, 1)
    sky = out["sky"].reshape(R, n_fine, -1)
    _, _, ps = rendering.pv_pe_ps(rho, deltas)
    if classic_solar:
        rendered = rendering.composite_classic(ps, col, vis, sky)
    else:
        gate = rendering.gated_visibility(ps, vis)
        rendered = torch.sum(ps * col, dim=1) * (
            gate + (1.0 - gate) * torch.mean(sky, dim=1))
    surf, _ = rendering.expected_surface(ps, pts, deltas)
    res = {"rendered": rendered,
           "shadow_raw": torch.sum(ps * vis, dim=1)[:, 0],
           "height": surf[:, 2], "ps_sum": torch.sum(ps, dim=(1, 2))}
    if with_samples:
        res["ps"] = ps[:, :, 0]
        res["pts"] = pts
    return res


class Renderer:
    """Whole-image renderer over a trained T-NeRF (a ``TNeRF`` in eval mode
    whose weights already sit on the device to render on).
    ``fast_render=(n_coarse, n_fine)`` renders the composite and the
    component paths depth-guided (None: the uniform ``n_samples``).
    ``mesh`` (of more than one device) splits every chunk over a replica
    of the model on each of its devices; the results gather on its first
    device."""

    def __init__(self, model, n_samples=96, chunk=5_120, classic_solar=False,
                 sun_frame: Optional[np.ndarray] = None,
                 use_hsluv: bool = False,
                 fast_render: Optional[Tuple[int, int]] = None, mesh=None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.n_samples = n_samples
        self.fast_render = tuple(fast_render) if fast_render else None
        self.chunk = max(chunk, 16)     # rays (or exact-solar points) per
        #                                 dispatch; output is chunk-invariant
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.replicas = [(self.model, self.device)]     # (model, device)
        if self.mesh is not None:
            n, home = self.mesh.size, self.device
            self.chunk = -(-self.chunk // n) * n
            self.device = self.mesh.devices[0]
            self.replicas = [
                (self.model if i == 0 and dev == home
                 else copy.deepcopy(self.model).to(dev), dev)
                for i, dev in enumerate(self.mesh.devices)]
            for replica, _ in self.replicas:
                replica.G_NeRF_net.fused()      # fold once, on its device
        self.classic_solar = classic_solar
        self.sun_frame = sun_frame
        # a model trained on HSLuv targets renders in that space: rendered
        # colors are converted back to sRGB
        self.use_hsluv = use_hsluv

    def _put(self, arr, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device or self.device)

    def _parts(self, lo: int, hi: int):
        """The rows [lo, hi) of a chunk split over the replicas -> (model,
        device, rows) for each non-empty part, in order."""
        n = len(self.replicas)
        per = -(-(hi - lo) // n)
        for i, (model, dev) in enumerate(self.replicas):
            a, b = lo + i * per, min(hi, lo + (i + 1) * per)
            if a < b:
                yield model, dev, slice(a, b)

    # -- per-chunk programs --------------------------------------------------
    def _full_chunk(self, tops, bots, sun, t4, with_samples=False,
                    model=None):
        model = model or self.model
        if self.fast_render is not None:
            nc, nf = self.fast_render
            return render_chunk_outputs_fast(
                model, tops, bots, sun, t4, n_coarse=nc, n_fine=nf,
                classic_solar=self.classic_solar, with_samples=with_samples)
        return render_chunk_outputs(model, tops, bots, sun, t4,
                                    n_samples=self.n_samples,
                                    classic_solar=self.classic_solar,
                                    with_samples=with_samples)

    @property
    def _out_samples(self):
        """Samples a ray in the per-sample outputs: ``n_fine`` under fast
        rendering, else ``n_samples``."""
        return self.fast_render[1] if self.fast_render else self.n_samples

    def _component_chunk(self, tops, bots, sun, t4, model=None):
        """Per-sample raw components (forward_separate), with the steps of
        samples outside the cube zeroed; under fast rendering the samples
        of each ray's surface window."""
        model = model or self.model
        R, C = tops.shape[0], model.n_classes
        if self.fast_render is not None:
            nc, S = self.fast_render
            t_lo, t_hi = surface_window(model, tops, bots, nc)
            pts, deltas = window_points(tops, bots, t_lo, t_hi, S)
        else:
            S = self.n_samples
            pts, deltas = sample_coarse(tops, bots, S, include_end=True)
        deltas = torch.where(out_of_cube(pts)[..., None],
                             torch.zeros_like(deltas), deltas)
        probs_r, sun_pe_r, sky_raw_r = model.ray_consts(sun, t4)
        bc = rendering.broadcast_rays
        out = model.forward_separate(
            pts.reshape(-1, 3), None, None, probs=bc(probs_r, S),
            sun_pe=bc(sun_pe_r, S), sky_raw=bc(sky_raw_r, S))
        return {
            "pts": pts, "deltas": deltas,
            "rho": out["rho"].reshape(R, S, 1),
            "col_raw": out["col_raw"].reshape(R, S, 3),
            "vis": out["vis"].reshape(R, S, 1),
            "sky": out["sky"].reshape(R, S, 3),
            "class_probs": out["class_probs"].reshape(R, S, C),
            "adjust_per_class": out["adjust_per_class"].reshape(R, S, C, 3),
        }

    def _exact_solar_chunk(self, pts, sun_vec, model=None):
        """Exact secondary-ray solar transmittance at [n, 3] points: a sun
        ray from each point to z=+1, sigma integrated over its S-1 steps
        (S = ``n_samples``, under fast rendering too), one network pass per
        step (the O(n*S) secondary points are never held at once)."""
        model = model or self.model
        S = self.n_samples
        k = (1.0 - pts[:, 2]) / sun_vec[2]
        tops = pts + k[:, None] * sun_vec[None, :]
        delta = torch.sqrt(torch.sum((tops - pts) ** 2, dim=1))[:, None] / S
        tau = torch.zeros((pts.shape[0], 1), device=pts.device)
        for j in range(S - 1):
            # the step fraction in float32, as the JAX scan computes it
            s = np.float32(j) / np.float32(S - 1)
            spts = tops * float(np.float32(1.0) - s) + pts * float(s)
            d = torch.where(out_of_cube(spts)[:, None],
                            torch.zeros_like(delta), delta)
            tau = tau + model.sigma_only(spts) * d
        return torch.exp(-tau)[:, 0]

    @torch.no_grad()
    def _exact_solar_points(self, pts_flat, sun_vec):
        """Exact solar transmittance at [N, 3] flat points, ``chunk`` points
        per dispatch -> [N] numpy."""
        sv = np.asarray(sun_vec, np.float32)
        outs = []
        for s in range(0, pts_flat.shape[0], self.chunk):
            for model, dev, rows in self._parts(
                    s, min(s + self.chunk, pts_flat.shape[0])):
                outs.append(self._exact_solar_chunk(
                    self._put(pts_flat[rows], dev),
                    torch.from_numpy(sv).to(dev), model=model).to(
                        self.device))
            heartbeat.beat()
        return torch.cat(outs).cpu().numpy()

    # -- chunk loop ----------------------------------------------------------
    @torch.no_grad()
    def _run_chunks(self, kernel, tops, bots, sun, t4, keys):
        outs = {k: [] for k in keys}
        n = tops.shape[0]
        for s in range(0, n, self.chunk):
            with trace.span("render.chunk"):
                parts = self._parts(s, min(s + self.chunk, n))
                for model, dev, rows in parts:
                    res = kernel(*(self._put(a[rows], dev)
                                   for a in (tops, bots, sun, t4)),
                                 model=model)
                    for k in keys:
                        outs[k].append(res[k].to(self.device))
            heartbeat.beat()
        with trace.span("render.gather"):   # the host waits for the device
            return {k: torch.cat(v).float().cpu().numpy()
                    for k, v in outs.items()}

    def render_rays(self, tops, bots, sun_vec, t4_row, with_samples=False):
        """Full composite render of arbitrary rays -> dict of flat arrays.
        ``with_samples`` also returns per-sample ps/pts (for exact shadows)."""
        n = tops.shape[0]
        sun = np.broadcast_to(np.asarray(sun_vec, np.float32), (n, 3))
        t4 = np.broadcast_to(np.asarray(t4_row, np.float32), (n, 4))
        keys = ["rendered", "shadow_raw", "height", "ps_sum"]
        if with_samples:
            keys += ["ps", "pts"]
        res = self._run_chunks(
            functools.partial(self._full_chunk, with_samples=with_samples),
            tops, bots, sun, t4, keys)
        if self.use_hsluv:
            from season_nerf_torch.utils.hsluv import hsluv_normalized_to_rgb
            res["rendered"] = hsluv_normalized_to_rgb(
                np.clip(res["rendered"], 0, 1)).astype(np.float32)
        return res

    # -- public API ----------------------------------------------------------
    def render_img(self, view_el_az, sun_el_az, time_frac, out_size,
                   angles_to_vec=None, exact_shadow=False):
        """Whole-image render -> dict with Col_Img, Shadow_Mask (gated),
        Height, PS_Sum and Mask; ``exact_shadow`` adds Exact_Shadow_Mask from
        secondary-ray transmittance."""
        with trace.span("render.frame"):
            to_vec = angles_to_vec or _default_angles_to_vec(self.sun_frame)
            view_vec = to_vec(*view_el_az)
            sun_vec = to_vec(*sun_el_az)
            with trace.span("render.rays"):
                tops, bots, img_pts = dir_grid_rays(view_vec,
                                                    (out_size, out_size))
            res = self.render_rays(tops, bots, sun_vec,
                                   encode_time(time_frac),
                                   with_samples=exact_shadow)
            with trace.span("render.scatter"):
                ij = (img_pts[:, 0], img_pts[:, 1])
                col = np.zeros((out_size, out_size, 3), np.float32)
                shadow = np.zeros((out_size, out_size), np.float32)
                height = np.full((out_size, out_size), np.nan, np.float32)
                ps_sum = np.zeros((out_size, out_size), np.float32)
                mask = np.zeros((out_size, out_size), bool)
                col[ij] = res["rendered"]
                shadow[ij] = res["shadow_raw"]
                height[ij] = res["height"]
                ps_sum[ij] = res["ps_sum"]
                mask[ij] = True
            out = {"Col_Img": col, "Shadow_Mask": shadow, "Height": height,
                   "PS_Sum": ps_sum, "Mask": mask}
            if exact_shadow:
                # secondary sun rays from the same samples the composite used
                exact = self._exact_solar_points(
                    res["pts"].reshape(-1, 3), sun_vec).reshape(
                        -1, self._out_samples)
                ex = np.zeros((out_size, out_size), np.float32)
                ex[ij] = np.sum(res["ps"] * exact, 1)
                out["Exact_Shadow_Mask"] = ex
            return out

    def render_perspective(self, position, pitch_deg, yaw_deg, fov_deg,
                           out_size, sun_el_az, time_frac,
                           angles_to_vec=None):
        """Free-camera perspective render."""
        to_vec = angles_to_vec or _default_angles_to_vec(self.sun_frame)
        tops, bots, img_pts = perspective_rays(position, pitch_deg, yaw_deg,
                                               fov_deg, (out_size, out_size))
        res = self.render_rays(tops, bots, to_vec(*sun_el_az),
                               encode_time(time_frac))
        col = np.zeros((out_size, out_size, 3), np.float32)
        mask = np.zeros((out_size, out_size), bool)
        col[img_pts[:, 0], img_pts[:, 1]] = res["rendered"]
        mask[img_pts[:, 0], img_pts[:, 1]] = True
        return {"Col_Img": col, "Mask": mask}

    def get_dsm(self, out_size, min_ps_sum=1e-2):
        """Nadir expected-height map in [-1, 1]; NaN where nothing was hit
        (accumulated hit probability under ``min_ps_sum``) or no ray was
        evaluated."""
        out = self.render_img((90.0, 0.0), (90.0, 0.0), 0.0, out_size)
        h = out["Height"].copy()
        h[out["PS_Sum"] < min_ps_sum] = np.nan
        return h

    def component_render(self, tops, bots, sun_vec, year_frac,
                         exact_solar=False):
        """Per-sample raw components of arbitrary rays."""
        n = tops.shape[0]
        sun = np.broadcast_to(np.asarray(sun_vec, np.float32), (n, 3))
        t4 = np.broadcast_to(encode_time(year_frac), (n, 4))
        keys = ["pts", "deltas", "rho", "col_raw", "vis", "sky",
                "class_probs", "adjust_per_class"]
        res = self._run_chunks(self._component_chunk, tops, bots, sun, t4,
                               keys)
        if exact_solar:
            res["exact_solar"] = self._exact_solar_points(
                res["pts"].reshape(-1, 3), sun_vec).reshape(
                    n, self._out_samples, 1)
        # marks the color space for images_from_components
        res["hsluv"] = self.use_hsluv
        return res

    def component_render_by_dir(self, view_el_az, sun_el_az, time_frac,
                                out_size, angles_to_vec=None,
                                exact_solar=False):
        to_vec = angles_to_vec or _default_angles_to_vec(self.sun_frame)
        sun_vec = to_vec(*sun_el_az)
        tops, bots, img_pts = dir_grid_rays(to_vec(*view_el_az), out_size)
        res = self.component_render(tops, bots, sun_vec, time_frac,
                                    exact_solar)
        res["img_pts"] = img_pts
        res["sun_vec"] = np.asarray(sun_vec)
        return res

    def component_render_by_camera(self, cam, out_size, exact_solar=False):
        """Per-sample components of a camera's view on an ``out_size`` grid
        (:func:`camera_grid_rays`), with the grid pixels (``img_pts``) and
        the source-image pixels they sample (``gt_img_pts``)."""
        tops, bots, img_pts, gt_pts = camera_grid_rays(cam, out_size)
        res = self.component_render(tops, bots, cam.sun_vec, cam.time_frac,
                                    exact_solar)
        res["img_pts"] = img_pts
        res["gt_img_pts"] = gt_pts
        res["sun_vec"] = np.asarray(cam.sun_vec)
        return res


def _default_angles_to_vec(sun_frame):
    from season_nerf_torch.geometry.units import elevation_azimuth_to_vec

    def to_vec(el, az):
        v = elevation_azimuth_to_vec(el, az)
        if sun_frame is not None:
            v = sun_frame @ v
            v = v / np.linalg.norm(v)
        return v
    return to_vec


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def images_from_components(res: Dict[str, np.ndarray], out_size,
                           classic_shadows: bool = False):
    """Composite raw per-sample components into display images:
    Base_Img, Season_Adj_Img, Extreme_Imgs (per class), Shadow_Mask,
    Raw_Shadow_Mask, Shadow_Adjust (+ the _Exact variants when exact solar
    was rendered), Sky_Col, Time_Class.  Unrendered pixels are NaN."""
    rho, deltas = res["rho"], res["deltas"]
    ij = res["img_pts"]
    H, W = out_size[0], out_size[1]
    tau = np.cumsum(rho * deltas, axis=1)
    pv = np.exp(-np.concatenate([np.zeros_like(tau[:, :1]), tau[:, :-1]], 1))
    ps = pv * (1 - np.exp(-rho * deltas))

    # compositing happens in the model's color space; a normalized-HSLuv
    # model's composited colors are converted to sRGB for display
    if res.get("hsluv"):
        from season_nerf_torch.utils.hsluv import hsluv_normalized_to_rgb

        def to_rgb(v):
            return hsluv_normalized_to_rgb(np.clip(v, 0, 1)).astype(
                np.float32)
    else:
        def to_rgb(v):
            return v

    sky = res["sky"][0, 0]      # forward_separate emits the activated sky
    sky_disp = to_rgb(sky)
    probs = res["class_probs"]
    mix = np.einsum("rsc,rscd->rsd", probs, res["adjust_per_class"])

    def scatter(vals, ch=3):
        img = np.full((H, W, ch) if ch > 1 else (H, W), np.nan, np.float32)
        img[ij[:, 0], ij[:, 1]] = vals
        return img

    base_cols = np.sum(ps * _sig(res["col_raw"]), 1)
    season_cols = np.sum(ps * _sig(res["col_raw"] + mix), 1)
    extreme = [scatter(to_rgb(np.sum(
        ps * _sig(res["col_raw"] + res["adjust_per_class"][:, :, c]), 1)))
        for c in range(res["adjust_per_class"].shape[2])]

    def shadow_maps(vis_key):
        raw = scatter(np.sum(ps * res[vis_key], 1)[:, 0], ch=1)
        gated = _sig((raw - 0.2) * 30.0)
        adjust = (gated[..., None]
                  + (1 - gated[..., None]) * sky_disp[None, None])
        if classic_shadows:
            # ratio of shadow-attenuated to plain composite, in the model's
            # own color space (a multiplicative map)
            term = res[vis_key] + (1 - res[vis_key]) * res["sky"]
            col_adj = _sig(res["col_raw"] + mix) * term
            adjust = scatter(np.sum(ps * col_adj, 1) / (season_cols + 1e-8))
        return raw, gated, adjust

    raw_sm, sm, adj = shadow_maps("vis")
    out = {
        "Base_Img": scatter(to_rgb(base_cols)),
        "Season_Adj_Img": scatter(to_rgb(season_cols)),
        "Extreme_Imgs": extreme,
        "Shadow_Mask": sm, "Raw_Shadow_Mask": raw_sm, "Shadow_Adjust": adj,
        "Sky_Col": sky_disp,
        "Time_Class": probs[0, 0],
    }
    if "exact_solar" in res:
        raw_e, sm_e, adj_e = shadow_maps("exact_solar")
        out.update({"Shadow_Mask_Exact": sm_e,
                    "Raw_Shadow_Mask_Exact": raw_e,
                    "Shadow_Adjust_Exact": adj_e})
    return out
