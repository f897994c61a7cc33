"""Colour-distribution Earth-Mover's distance.

The counterpart of ``season_nerf_tpu/eval/emd.py``: histogram signatures in
CIE LAB (bin centroids and mass, neighbouring bins merged, small bins
pruned keeping at least 95 % of the mass), compared by the exact EMD under
an L1 ground distance (the transportation LP, solved by scipy's HiGHS as
the JAX package solves it), and a batched log-domain Sinkhorn for many
pairs at once, in torch on the caller's device.

The signatures and the LP are the same float64 numpy and scipy calls as the
JAX package's, so their values agree to the last bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# OpenCV COLOR_RGB2LAB float semantics (D65 white); EM values are L1
# distances in LAB units
_RGB2XYZ_D65 = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_D65_WHITE = np.array([0.950456, 1.0, 1.088754])
# per-axis LAB ranges the histogram bins over
LAB_RANGES = ((0.0, 100.0), (-127.0, 127.0), (-127.0, 127.0))
LAB_BIN_SIZE = 12.5


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] RGB in [0, 1] -> CIE LAB (L in [0, 100], a/b in about
    [-127, 127]), as cv2.cvtColor's float RGB2Lab."""
    x = np.asarray(rgb, np.float64)
    x = np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    xyz = x @ _RGB2XYZ_D65.T / _D65_WHITE
    thr = 0.008856

    def f(t):
        return np.where(t > thr, np.cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    L = np.where(xyz[..., 1] > thr, 116.0 * fy - 16.0, 903.3 * xyz[..., 1])
    return np.stack([L, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def _merge_close(cent: np.ndarray, w: np.ndarray, dist_thresh: float):
    """Merge bins whose centroids lie within ``dist_thresh`` (connected
    components of the KD-tree neighbour graph, by union-find) -> the
    mass-weighted centroids and summed masses of the components."""
    from scipy.spatial import cKDTree
    pairs = cKDTree(cent).query_pairs(dist_thresh, output_type="ndarray")
    parent = np.arange(cent.shape[0])

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(cent.shape[0])])
    _, inv = np.unique(roots, return_inverse=True)
    w_m = np.bincount(inv, weights=w)
    cent_m = np.stack([np.bincount(inv, weights=cent[:, c] * w)
                       for c in range(3)], 1) / w_m[:, None]
    return cent_m, w_m


def color_signature(img: np.ndarray, bins_per_edge: int = 8,
                    dist_thresh: Optional[float] = None,
                    prune_thresh: float = 0.001,
                    value_range: Tuple[float, float] = (0.0, 1.0),
                    space: str = "lab"):
    """[..., 3] image -> signature [K, 4] rows (cx, cy, cz, weight).

    A uniform 3-D histogram of the finite pixels, each bin's mean colour
    its centroid, bins within ``dist_thresh`` merged, bins under
    ``prune_thresh`` of the mass dropped (or, where that would keep under
    95 %, the largest bins that cover 95 %), weights renormalised to 1.
    ``space="lab"``: LAB bins of ``LAB_BIN_SIZE`` over ``LAB_RANGES``, the
    merge radius the mean half bin width; ``space="rgb"``:
    ``bins_per_edge`` bins over ``value_range``."""
    x = np.asarray(img, np.float64).reshape(-1, 3)
    x = x[np.isfinite(x).all(axis=1)]
    if space == "lab":
        x = rgb_to_lab(x)
        edges_n = [int((hi - lo) / LAB_BIN_SIZE) + 1 for lo, hi in LAB_RANGES]
        n_per_axis = [max(n - 1, 1) for n in edges_n]
        widths = [(hi - lo) / n
                  for (lo, hi), n in zip(LAB_RANGES, n_per_axis)]
        q = np.stack([
            np.clip(((x[:, c] - lo) / w_).astype(int), 0, n - 1)
            for c, ((lo, _hi), w_, n) in enumerate(
                zip(LAB_RANGES, widths, n_per_axis))], 1)
        flat = (q[:, 0] * n_per_axis[1] + q[:, 1]) * n_per_axis[2] + q[:, 2]
        n_bins = int(np.prod(n_per_axis))
        if dist_thresh is None:
            dist_thresh = float(np.mean([w_ / 2 for w_ in widths]))
    else:
        lo, hi = value_range
        q = np.clip(((x - lo) / (hi - lo) * bins_per_edge).astype(int),
                    0, bins_per_edge - 1)
        flat = (q[:, 0] * bins_per_edge + q[:, 1]) * bins_per_edge + q[:, 2]
        n_bins = bins_per_edge ** 3
        if dist_thresh is None:
            dist_thresh = (hi - lo) / bins_per_edge
    counts = np.bincount(flat, minlength=n_bins).astype(np.float64)
    sums = np.stack([np.bincount(flat, weights=x[:, c], minlength=n_bins)
                     for c in range(3)], 1)
    good = counts > 0
    cent = sums[good] / counts[good][:, None]
    w = counts[good]
    if cent.shape[0] > 1 and dist_thresh > 0:
        cent, w = _merge_close(cent, w, dist_thresh)

    w = w / w.sum()
    keep = w >= prune_thresh
    if w[keep].sum() < 0.95:
        order = np.argsort(-w)
        k = np.searchsorted(np.cumsum(w[order]), 0.95) + 1
        keep = np.zeros_like(keep)
        keep[order[:k]] = True
    cent, w = cent[keep], w[keep]
    w = w / w.sum()
    return np.concatenate([cent, w[:, None]], 1)


def _ground_distance(x1, x2, metric="l1"):
    d = x1[:, None, :] - x2[None, :, :]
    if metric == "l1":
        return np.abs(d).sum(-1)
    if metric == "l2":
        return np.sqrt((d ** 2).sum(-1))
    raise ValueError(metric)


def emd_exact(sig1: np.ndarray, sig2: np.ndarray, metric: str = "l1") -> float:
    """Exact EMD between two signatures [K, 4] (centroid xyz + weight): the
    transportation LP (flows >= 0, row sums the first weights, column sums
    the second, the redundant last constraint dropped) solved by HiGHS.
    The constraint matrix is built sparse: 2 m n entries of the dense
    (m + n) x m n one, the same LP."""
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix
    w1 = sig1[:, 3] / sig1[:, 3].sum()
    w2 = sig2[:, 3] / sig2[:, 3].sum()
    C = _ground_distance(sig1[:, :3], sig2[:, :3], metric)
    m, n = C.shape
    flow = np.arange(m * n)
    rows = np.concatenate([flow // n, m + flow % n])
    A_eq = csr_matrix((np.ones(2 * m * n), (rows, np.tile(flow, 2))),
                      shape=(m + n, m * n))
    b_eq = np.concatenate([w1, w2])
    res = linprog(C.reshape(-1), A_eq=A_eq[:-1], b_eq=b_eq[:-1],
                  bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"EMD linear program failed: {res.message}")
    return float(res.fun)


def pad_signatures(sigs):
    """List of [K_i, 4] signatures -> (weights [N, K_max], centroids
    [N, K_max, 3]) zero-padded for :func:`emd_sinkhorn_batch`."""
    k_max = max(s.shape[0] for s in sigs)
    W = np.zeros((len(sigs), k_max))
    X = np.zeros((len(sigs), k_max, 3))
    for i, s in enumerate(sigs):
        W[i, :s.shape[0]] = s[:, 3]
        X[i, :s.shape[0]] = s[:, :3]
    return W, X


def emd_sinkhorn_batch(w1, x1, w2, x2, metric="l1", reg=0.005,
                       n_iters=500, device="cuda") -> np.ndarray:
    """[P] EM distances of P signature pairs by entropy-regularised optimal
    transport (log-domain Sinkhorn, ``n_iters`` iterations), all pairs at
    once in float32 on ``device``.

    w1/w2: [P, K] weights (zero entries are padding, see
    :func:`pad_signatures`); x1/x2: [P, K, 3] centroids (tensors stay on
    their own device).  ``reg`` is relative to each pair's largest cost,
    so convergence does not depend on the signatures' units."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.float()
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    w1, x1, w2, x2 = put(w1), put(x1), put(w2), put(x2)
    w1 = w1 / w1.sum(1, keepdim=True)
    w2 = w2 / w2.sum(1, keepdim=True)
    d = x1[:, :, None, :] - x2[:, None, :, :]
    if metric == "l1":
        C = d.abs().sum(-1)
    elif metric == "l2":
        C = torch.sqrt((d ** 2).sum(-1) + 1e-12)
    else:
        raise ValueError(metric)
    scale = torch.clamp(C.amax(dim=(1, 2), keepdim=True), min=1e-12)
    logK = -(C / scale) / reg
    # a padding entry's log-mass is ~-69: its potential pushes no mass
    log_w1 = torch.log(w1 + 1e-30)
    log_w2 = torch.log(w2 + 1e-30)
    f, g = torch.zeros_like(log_w1), torch.zeros_like(log_w2)
    for _ in range(n_iters):
        f = log_w1 - torch.logsumexp(logK + g[:, None, :], dim=2)
        g = log_w2 - torch.logsumexp(logK + f[:, :, None], dim=1)
    P = torch.exp(f[:, :, None] + logK + g[:, None, :])
    return torch.sum(P * C, dim=(1, 2)).cpu().numpy()


def emd_sinkhorn(w1, x1, w2, x2, metric="l1", reg=0.005, n_iters=500,
                 device="cuda") -> float:
    """Entropy-regularised EMD of one signature pair (see
    :func:`emd_sinkhorn_batch`); converges to the exact EMD as reg -> 0."""
    return float(emd_sinkhorn_batch(
        np.asarray(w1)[None], np.asarray(x1)[None],
        np.asarray(w2)[None], np.asarray(x2)[None],
        metric=metric, reg=reg, n_iters=n_iters, device=device)[0])


def compare_em_imgs(img1, img2, bins_per_edge=8, metric="l1",
                    exact=True, device="cuda", **sig_kw) -> float:
    """EM distance between the colour distributions of two images: exact
    (the LP, on the host) or by Sinkhorn on ``device``."""
    s1 = color_signature(img1, bins_per_edge, **sig_kw)
    s2 = color_signature(img2, bins_per_edge, **sig_kw)
    if exact:
        return emd_exact(s1, s2, metric)
    return emd_sinkhorn(s1[:, 3], s1[:, :3], s2[:, 3], s2[:, :3], metric,
                        device=device)
