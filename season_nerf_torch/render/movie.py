"""Animations of rendered frames.

The counterpart of ``giffify`` in ``season_nerf_tpu/render/movie.py``; the
rest of that module (camera scripts, films) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from season_nerf_torch.utils.gif import encode_gif


def giffify(images: Sequence[np.ndarray], path: str,
            duration_ms: float = 200):
    """Write float [H, W, 3] images (clipped to [0, 1], NaN as 0) as a GIF
    that loops forever, ``duration_ms`` a frame -> ``path``."""
    frames = [(np.clip(np.nan_to_num(np.asarray(im, float)), 0, 1) * 255)
              .astype(np.uint8) for im in images]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_gif(frames, delay_cs=int(round(duration_ms / 10))))
    return path
