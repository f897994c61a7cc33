"""The site's world-frame artifact of a model directory (``W2C_W2L_H.npy``)."""

from __future__ import annotations

import numpy as np


def save_world_artifact(path: str, wc, S, h_range=None):
    """Write ``W2C_W2L_H.npy``: (world_center, world-to-local similarity,
    site height range in meters).  Any field may be None (synthetic sites
    have no world frame)."""
    arr = np.empty(3, object)
    arr[0], arr[1], arr[2] = wc, S, h_range
    np.save(path, arr, allow_pickle=True)


def load_w2c_w2l(path: str):
    """-> (world_center, similarity, h_range or None).  Reads the
    3-element artifact and the older 2-element one (no height range).

    The file is a pickled object array: load only model directories you
    trust, as with any pickle."""
    arr = np.load(path, allow_pickle=True)
    h_range = arr[2] if arr.shape[0] > 2 else None
    if h_range is not None:
        h_range = (float(h_range[0]), float(h_range[1]))
    return arr[0], arr[1], h_range
