"""The space-carving DSM prior: a plane sweep of photo-consistency on the
device, then a graph cut on the host.

The counterpart of ``season_nerf_tpu/priors/space_carving.py``.  For every
(x, y) cell of the site's grid and every height z, a patch x patch grid of
points on the cell's footprint is projected through every camera (a 3x4
camera maps points linearly, so no per-cell homography is fitted), gathered
bilinearly from the padded image stack, and scored by the mean over
ordered pairs of views of the global-window SSIM; the score volume's graph
cut (``priors/graph_cut``) under a truncated-linear smoothness gives the
height map, normalized to [-1, 1].

The sweep is plain PyTorch on ``device`` (the JAX package's is XLA, not a
Pallas kernel).  Per chunk of cells: the projection of all points through
all cameras, the bilinear gather, the patch moments, the pairwise
covariance as one batched [C, M, M] product in float64 (never TF32,
whatever the process's matmul settings) and the off-diagonal mean.  The
score volume stays on the device until the sweep ends.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from season_nerf_torch.geometry.units import lat_lon_to_meters
from season_nerf_torch.priors import graph_cut as gc

DEFAULT_VOXEL = (2.0, 2.0, 0.25)   # meters


def model_grid_from_bounds(bounds_lla: np.ndarray,
                           voxel=DEFAULT_VOXEL) -> Tuple[int, int, int]:
    """(nx, ny, nz) cells covering the site at the metric ``voxel``:
    haversine extents over the voxel, at least 2 a side."""
    lat0, lat1 = bounds_lla[0]
    lon0, lon1 = bounds_lla[1]
    h0, h1 = bounds_lla[2]
    mid_lat, mid_lon = (lat0 + lat1) / 2, (lon0 + lon1) / 2
    dy = lat_lon_to_meters(lat0, mid_lon, lat1, mid_lon)
    dx = lat_lon_to_meters(mid_lat, lon0, mid_lat, lon1)
    return (max(int(dy / voxel[0]), 2), max(int(dx / voxel[1]), 2),
            max(int((h1 - h0) / voxel[2]), 2))


def _pad_images(images: List[np.ndarray]) -> np.ndarray:
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    stack = np.zeros((len(images), hmax, wmax, 3), np.float32)
    for i, im in enumerate(images):
        stack[i, :im.shape[0], :im.shape[1]] = im[..., :3]
    return stack


def _score_cells(img_stack, Ps, pts):
    """Mean pairwise global-window SSIM of each cell's patch across the
    views.  img_stack [M, H, W, 3], Ps [M, 3, 4], pts [C, P2, 3] (float32,
    one device) -> [C]."""
    M, H, W, _ = img_stack.shape
    C = pts.shape[0]
    x, y, z = pts[None, ..., 0], pts[None, ..., 1], pts[None, ..., 2]
    P = Ps[:, None, None, :, :]                                # [M,1,1,3,4]
    proj = [P[..., i, 0] * x + P[..., i, 1] * y + P[..., i, 2] * z
            + P[..., i, 3] for i in range(3)]                  # [M,C,P2]
    rr = (proj[0] / proj[2]).clamp(0.0, H - 1.001)
    cc = (proj[1] / proj[2]).clamp(0.0, W - 1.001)
    r0, c0 = rr.floor(), cc.floor()
    fr, fc = (rr - r0)[..., None], (cc - c0)[..., None]
    # clamped as XLA's gather clamps (only a NaN projection needs it)
    r0, c0 = r0.long().clamp(0, H - 2), c0.long().clamp(0, W - 2)
    m = torch.arange(M, device=pts.device)[:, None, None]

    def at(dr, dc):
        return img_stack[m, r0 + dr, c0 + dc]                  # [M,C,P2,3]

    vals = ((1 - fr) * (1 - fc) * at(0, 0) + (1 - fr) * fc * at(0, 1)
            + fr * (1 - fc) * at(1, 0) + fr * fc * at(1, 1))
    flat = vals.reshape(M, C, -1)                              # [M,C,K]
    K = flat.shape[-1]
    mu = flat.mean(-1)                                         # [M,C]
    var = flat.var(-1, unbiased=False)
    cen = (flat - mu[..., None]).transpose(0, 1).double()      # [C,M,K]
    cov = (torch.bmm(cen, cen.transpose(1, 2)) / K).float()    # [C,M,M]
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_i, mu_j = mu.T[:, :, None], mu.T[:, None, :]
    var_i, var_j = var.T[:, :, None], var.T[:, None, :]
    ssim = ((2 * mu_i * mu_j + c1) * (2 * cov + c2)
            / ((mu_i ** 2 + mu_j ** 2 + c1) * (var_i + var_j + c2)))
    total = ssim.sum((1, 2))
    return (total - ssim.diagonal(dim1=1, dim2=2).sum(-1)) / (M * (M - 1))


@torch.no_grad()
def plane_sweep_scores(cameras, images, grid_size, patch: int = 5,
                       cell_chunk: int = 4096, z_range=(-1.0, 1.0),
                       device="cuda") -> np.ndarray:
    """Photo-consistency score volume [nx, ny, nz] over the cube, swept on
    ``device``.  cameras: scaled cameras (cube coordinates); images: the
    matching [H, W, 3+] arrays."""
    nx, ny, nz = grid_size
    device = torch.device(device)
    img_stack = torch.as_tensor(_pad_images(images), device=device)
    Ps = torch.as_tensor(np.stack([c.P for c in cameras]).astype(np.float32),
                         device=device)
    xs = np.linspace(-1, 1, nx + 1)
    ys = np.linspace(-1, 1, ny + 1)
    zs = np.linspace(z_range[0], z_range[1], nz)
    fr = (np.arange(patch) + 0.5) / patch       # patch offsets in a cell
    off = np.stack(np.meshgrid(fr, fr, indexing="ij"), -1).reshape(-1, 2)
    cx0 = np.repeat(xs[:-1], ny)
    cy0 = np.tile(ys[:-1], nx)
    base_xy = np.stack([cx0[:, None] + off[None, :, 0] * (xs[1] - xs[0]),
                        cy0[:, None] + off[None, :, 1] * (ys[1] - ys[0])],
                       -1)                                     # [C,P2,2]
    base_xy = torch.as_tensor(base_xy.astype(np.float32), device=device)
    n_cells = base_xy.shape[0]
    scores = torch.empty((n_cells, nz), dtype=torch.float32, device=device)
    for zi, z in enumerate(zs.astype(np.float32)):
        for s in range(0, n_cells, cell_chunk):
            blk = base_xy[s:s + cell_chunk]
            pts = torch.cat([blk, torch.full_like(blk[..., :1], float(z))],
                            -1)
            scores[s:s + blk.shape[0], zi] = _score_cells(img_stack, Ps, pts)
    return scores.cpu().numpy().reshape(nx, ny, nz)


def scores_to_heightmap(scores: np.ndarray, smooth_height: float = 1.0 / 3.0,
                        max_cycles: int = 3) -> np.ndarray:
    """Score volume -> height map in [-1, 1]: graph cut of the data cost
    -score (shifted non-negative) under a truncated-linear smoothness.
    Labels are normalized by nz, not nz - 1 (the reference's own
    normalization): the top slice maps to 1 - 2 / nz."""
    data = -scores
    data -= data.min()
    sm = gc.truncated_linear_costs(scores.shape[2], height=smooth_height)
    labels, _ = gc.aexpansion_grid(data.astype(np.float32), sm,
                                   max_cycles=max_cycles)
    return (labels.astype(np.float32) / scores.shape[2]) * 2.0 - 1.0


def space_carve_dsm(cameras, images, grid_size=None, bounds_lla=None,
                    voxel=DEFAULT_VOXEL, patch: int = 5,
                    cache_path: Optional[str] = None,
                    device="cuda") -> np.ndarray:
    """The space-carving prior in [-1, 1]: the sweep on ``device`` over
    ``grid_size`` (default: the site's bounds at ``voxel``, else 64 x 64 x
    32), then the graph cut; read from and written to ``cache_path``
    (``SC_<site>_hm.npy``) when given."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    if grid_size is None:
        grid_size = (model_grid_from_bounds(bounds_lla, voxel)
                     if bounds_lla is not None else (64, 64, 32))
    scores = plane_sweep_scores(cameras, images, grid_size, patch=patch,
                                device=device)
    hm = scores_to_heightmap(scores)
    if cache_path:
        np.save(cache_path, hm)
    return hm


def get_dsm(mode: str, cameras, images, gt_dsm=None, **kw):
    """The DSM prior of ``mode``: Space_Carve, LiDAR (the ground truth) or
    None."""
    if mode == "Space_Carve":
        return space_carve_dsm(cameras, images, **kw)
    if mode == "LiDAR":
        if gt_dsm is None:
            raise ValueError("LiDAR mode needs the ground-truth DSM")
        return np.asarray(gt_dsm)
    if mode in ("None", None):
        return None
    raise ValueError(f"unknown DSM mode {mode!r} (Stereo is not "
                     "implemented in the reference either)")
