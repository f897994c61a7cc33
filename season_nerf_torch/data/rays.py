"""The ray table: cameras -> one flat [N, 22] float32 array (numpy).

The counterpart of ``season_nerf_tpu/data/rays.py``.  Row layout:

  [0:2]   img_pt (row, col)
  [2:5]   ray top (cube coords, z = +1)
  [5:8]   ray bot (cube coords, z = -1)
  [8:11]  view direction (unit, top -> bot)
  [11:14] sun direction (unit)
  [14:18] time encoding (cos/sin year frac, cos/sin day frac)
  [18:19] sample weight
  [19:22] GT color (RGB in [0, 1])

Not ported yet: HSLuv-encoded colors, the inverse-density camera weights,
and the downscales and table cache of real sites.
"""

from __future__ import annotations

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
        m = np.isin(self.img_ids, ids)
        remap = {old: new for new, old in enumerate(ids)}
        return RayTable(self.rows[m],
                        np.array([remap[i] for i in self.img_ids[m]],
                                 np.int32),
                        [self.img_names[i] for i in ids],
                        self.img_sizes[ids], self.sun_vecs[ids],
                        self.time_encs[ids])


def rays_from_image(cam, image):
    """The [n, 22] rows of one camera and its image (sample weight 1)."""
    img_pts, tops, bots, valid = cam.pixel_rays()
    img_pts, tops, bots = img_pts[valid], tops[valid], bots[valid]
    colors = image[img_pts[:, 0], img_pts[:, 1]]
    view = bots - tops
    view = view / np.sqrt(np.sum(view ** 2, 1, keepdims=True))
    rows = np.empty((tops.shape[0], RAY_DIM), np.float32)
    rows[:, 0:2] = img_pts
    rows[:, 2:5] = tops
    rows[:, 5:8] = bots
    rows[:, 8:11] = view
    rows[:, 11:14] = cam.sun_vec
    rows[:, 14:18] = cam.time_enc
    rows[:, 18] = 1.0
    rows[:, 19:22] = colors[:, :3]
    return rows


def build_ray_table(cams, images, use_hsluv=False) -> RayTable:
    """The table of a list of scaled cameras and their images, at full
    resolution."""
    if use_hsluv:
        raise NotImplementedError("HSLuv-encoded ray colors are not ported "
                                  "yet (use_HSLuv)")
    all_rows = [rays_from_image(cam, img) for cam, img in zip(cams, images)]
    return RayTable(
        rows=np.concatenate(all_rows, 0),
        img_ids=np.concatenate([np.full(r.shape[0], i, np.int32)
                                for i, r in enumerate(all_rows)]),
        img_names=[c.name for c in cams],
        img_sizes=np.array([c.img_shape[:2] for c in cams], np.int32),
        sun_vecs=np.stack([c.sun_vec for c in cams]),
        time_encs=np.stack([c.time_enc for c in cams]),
    )


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
