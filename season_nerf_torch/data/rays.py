"""The ray table: cameras -> one flat [N, 22] float32 array (numpy).

The counterpart of ``season_nerf_tpu/data/rays.py``.  Row layout:

  [0:2]   img_pt (row, col)
  [2:5]   ray top (cube coords, z = +1)
  [5:8]   ray bot (cube coords, z = -1)
  [8:11]  view direction (unit, top -> bot)
  [11:14] sun direction (unit)
  [14:18] time encoding (cos/sin year frac, cos/sin day frac)
  [18:19] sample weight
  [19:22] GT color (RGB in [0, 1], or normalized HSLuv with ``use_HSLuv``)

A table is cached as the JAX package's ``.npz`` (the same keys), so a cache
that either package writes loads in the other (an HSLuv table's name
carries ``_hsluv``, :func:`cache_path`).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

RAY_DIM = 22


@dataclass
class RayTable:
    """The flat per-ray table and its per-image bookkeeping."""
    rows: np.ndarray            # [N, 22] float32
    img_ids: np.ndarray         # [N] int32, index into img_names
    img_names: list
    img_sizes: np.ndarray       # [M, 2] int32
    sun_vecs: np.ndarray        # [M, 3]
    time_encs: np.ndarray       # [M, 4]

    def __len__(self):
        return self.rows.shape[0]

    def split(self, ids):
        ids = np.asarray(ids, np.int64)
        m = np.isin(self.img_ids, ids)
        remap = np.zeros(len(self.img_names), np.int32)
        remap[ids] = np.arange(len(ids), dtype=np.int32)
        return RayTable(self.rows[m], remap[self.img_ids[m]],
                        [self.img_names[i] for i in ids],
                        self.img_sizes[ids], self.sun_vecs[ids],
                        self.time_encs[ids])

    def save(self, path):
        np.savez_compressed(path, rows=self.rows, img_ids=self.img_ids,
                            img_names=np.array(self.img_names),
                            img_sizes=self.img_sizes, sun_vecs=self.sun_vecs,
                            time_encs=self.time_encs)

    @classmethod
    def load(cls, path):
        d = np.load(path, allow_pickle=False)
        return cls(d["rows"], d["img_ids"], [str(s) for s in d["img_names"]],
                   d["img_sizes"], d["sun_vecs"], d["time_encs"])


def rays_from_image(cam, image, downscale=1, weight=1.0,
                    bounds=((-1, 1), (-1, 1), (-1, 1))):
    """The [n, 22] rows of one camera and its image: every ``downscale``-th
    pixel whose ray stays inside ``bounds``."""
    img_pts, tops, bots, valid = cam.pixel_rays(downscale=downscale,
                                                bounds=bounds)
    img_pts, tops, bots = img_pts[valid], tops[valid], bots[valid]
    colors = image[img_pts[:, 0] * downscale, img_pts[:, 1] * downscale]
    view = bots - tops
    view = view / np.sqrt(np.sum(view ** 2, 1, keepdims=True))
    rows = np.empty((tops.shape[0], RAY_DIM), np.float32)
    rows[:, 0:2] = img_pts
    rows[:, 2:5] = tops
    rows[:, 5:8] = bots
    rows[:, 8:11] = view
    rows[:, 11:14] = cam.sun_vec
    rows[:, 14:18] = cam.time_enc
    rows[:, 18] = weight
    rows[:, 19:22] = colors[:, :3]
    return rows


def build_ray_table(cams, images, downscales=None, weights=None,
                    cache_path=None, use_hsluv=False) -> RayTable:
    """The table of a list of scaled cameras and their images, each camera
    at its ``downscales`` entry (default 1) with its ``weights`` entry
    (default 1) as the rows' sample weight.  ``use_hsluv`` stores the
    colors as normalized HSLuv (float64 on the host, then float32).  With
    ``cache_path``, a table cached there is loaded, and a built one is
    saved there."""
    if cache_path and os.path.exists(cache_path):
        return RayTable.load(cache_path)
    downscales = downscales or [1] * len(cams)
    weights = weights if weights is not None else np.ones(len(cams))
    if use_hsluv:
        from season_nerf_torch.utils.hsluv import rgb_to_hsluv_normalized
        images = [rgb_to_hsluv_normalized(img[..., :3]).astype(np.float32)
                  for img in images]
    all_rows = [rays_from_image(cam, img, downscale=d, weight=w)
                for cam, img, d, w in zip(cams, images, downscales, weights)]
    table = RayTable(
        rows=np.concatenate(all_rows, 0),
        img_ids=np.concatenate([np.full(r.shape[0], i, np.int32)
                                for i, r in enumerate(all_rows)]),
        img_names=[c.name for c in cams],
        img_sizes=np.array([[c.img_shape[0] // d, c.img_shape[1] // d]
                            for c, d in zip(cams, downscales)], np.int32),
        sun_vecs=np.stack([c.sun_vec for c in cams]),
        time_encs=np.stack([c.time_enc for c in cams]),
    )
    if cache_path:
        table.save(cache_path)
    return table


def cache_path(cache_dir, cfg, downscales) -> str:
    """The ray-table cache of a real site: its name carries the settings
    that shape the rows, and a digest of the per-camera downscales (which
    follow the split, so a changed split misses the cache)."""
    split_key = hashlib.sha1(
        ",".join(map(str, downscales)).encode()).hexdigest()[:8]
    name = (f"ray_table_ds{cfg.img_training_downscale}"
            f"_v{cfg.img_validation_downscale}"
            f"{'_hsluv' if cfg.use_HSLuv else ''}"
            f"{'_w' if cfg.weight_training_samples else ''}"
            f"_s{split_key}.npz")
    return os.path.join(cache_dir, name)


def inverse_density_weights(X, starts, ends, circular, sigma=None):
    """Per-item weights inversely proportional to a Gaussian kernel density
    over the feature rows ``X`` [n, d]; circular features wrap across
    [start, end].  The weights sum to n."""
    X = np.asarray(X, np.float64)
    n, d = X.shape
    pd = np.zeros((n, n, d))
    for j in range(d):
        diff = np.abs(X[:, j][:, None] - X[:, j][None, :])
        if circular[j]:
            d0 = (np.abs(X[:, j] - starts[j])[:, None]
                  + np.abs(X[:, j] - ends[j])[None, :])
            d2 = (np.abs(X[:, j] - ends[j])[:, None]
                  + np.abs(X[:, j] - starts[j])[None, :])
            diff = np.minimum(diff, np.minimum(d0, d2))
        s = np.std(diff) if sigma is None else sigma[j]
        pd[:, :, j] = diff / max(s, 1e-12)
    dists = np.sum(pd ** 2, -1)
    w = 1.0 / np.sum(np.exp(-dists), 1)
    w = w / np.max(w)
    return w / np.sum(w) * n


def camera_weights(cams):
    """Inverse-density image weights over (off-nadir angle, view azimuth,
    year fraction): the ``weight_training_samples`` weights."""
    X = np.array([[90.0 - c.view_el_az[0], c.view_el_az[1], c.time_frac]
                  for c in cams])
    starts = np.array([0.0, 0, 0])
    ends = np.array([min(np.max(X[:, 0]) + 5, 180.0), 360.0, 1.0])
    circular = np.array([False, True, True])
    return inverse_density_weights(X, starts, ends, circular)


def decode_batch(batch):
    """[B, 22] rows (numpy or torch) -> the dict of named columns."""
    return {
        "img_pt": batch[:, 0:2],
        "top": batch[:, 2:5],
        "bot": batch[:, 5:8],
        "view": batch[:, 8:11],
        "sun": batch[:, 11:14],
        "t4": batch[:, 14:18],
        "weight": batch[:, 18:19],
        "gt_rgb": batch[:, 19:22],
    }


def train_test_split(n_images, testing_size=3, testing_names=None,
                     names=None):
    """Deterministic split: by an explicit list of names, or a linspace
    over the image index."""
    if testing_names is not None:
        val_idx = np.array([names.index(t) for t in testing_names])
    else:
        val_idx = np.unique(np.linspace(0, n_images - 1, testing_size,
                                        dtype=int))
    held = set(val_idx.tolist())
    train_idx = np.array([i for i in range(n_images) if i not in held])
    return train_idx, val_idx
