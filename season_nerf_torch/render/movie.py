"""Free-camera movies and animations of rendered frames.

The counterpart of ``season_nerf_tpu/render/movie.py``: a keyframe
``MovieScript`` (view el/az or a 6-DoF camera pose, sun el/az and time of
year per keyframe) smoothed by natural cubic splines with constant-speed
arc-length reparametrization (``geometry/spline.py``), frames rendered
through the ``Renderer`` (K3 for every trunk evaluation on the card), and
``export_film``/``giffify`` writing GIFs through ``utils/gif.py``.  The
JAX ``export_film`` writes an MP4 where imageio has an ffmpeg backend and
falls back to a GIF beside it; the port has no video encoder, so an
``.mp4`` path always becomes that GIF.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from season_nerf_torch.geometry.spline import Spline3
from season_nerf_torch.render.renderer import Renderer
from season_nerf_torch.utils.gif import encode_gif


@dataclass
class Keyframe:
    view_el_az: Tuple[float, float]
    sun_el_az: Tuple[float, float]
    time_frac: float
    # optional 6-DoF free-camera pose: (x, y, z, pitch_deg, yaw_deg,
    # fov_deg) in cube coordinates; when set, the frame renders through the
    # projective camera and view_el_az is ignored
    cam_pose: Optional[Tuple[float, ...]] = None


@dataclass
class MovieScript:
    """Keyframed camera/sun/time path with constant-speed interpolation.

    Two modes: by-direction (view el/az per keyframe) and 6-DoF free camera
    (``cam_pose`` per keyframe).  A script is one mode or the other: mixing
    raises."""
    keyframes: List[Keyframe] = field(default_factory=list)

    def add(self, view_el_az, sun_el_az, time_frac, cam_pose=None):
        self.keyframes.append(Keyframe(
            tuple(view_el_az) if view_el_az is not None else (90.0, 0.0),
            tuple(sun_el_az), float(time_frac),
            tuple(float(v) for v in cam_pose) if cam_pose is not None
            else None))
        return self

    @property
    def six_dof(self) -> bool:
        poses = [k.cam_pose is not None for k in self.keyframes]
        if any(poses) and not all(poses):
            raise ValueError("mixed script: every keyframe needs cam_pose, "
                             "or none")
        return bool(poses) and all(poses)

    def sample(self, n_frames: int) -> List[Keyframe]:
        """n_frames keyframe states along the arc-length-parameterized
        spline through all channels (constant speed along the path)."""
        if len(self.keyframes) < 2:
            raise ValueError("need at least 2 keyframes")
        six = self.six_dof
        if six:
            chans = np.array([[*k.cam_pose,
                               k.sun_el_az[0], k.sun_el_az[1], k.time_frac]
                              for k in self.keyframes])
        else:
            chans = np.array([[k.view_el_az[0], k.view_el_az[1],
                               k.sun_el_az[0], k.sun_el_az[1], k.time_frac]
                              for k in self.keyframes])
        sp = Spline3(chans)
        out = []
        for s in np.linspace(0, 1, n_frames):
            v = sp.at_arc(s)
            if six:
                out.append(Keyframe(
                    (90.0, 0.0),
                    (float(np.clip(v[6], 1, 90)), float(v[7])),
                    float(v[8]) % 1.0,
                    cam_pose=tuple(float(x) for x in v[:6])))
            else:
                out.append(Keyframe((float(v[0]), float(v[1])),
                                    (float(np.clip(v[2], 1, 90)),
                                     float(v[3])),
                                    float(v[4]) % 1.0))
        return out


def render_movie(renderer: Renderer, script: MovieScript, n_frames: int,
                 out_size: int, angles_to_vec=None, pipeline: int = 2):
    """-> [n_frames, H, W, 3] uint8 frames.  6-DoF scripts render through
    the projective free camera (``renderer.render_perspective``),
    by-direction scripts through the orthographic path
    (``renderer.render_img``).

    ``pipeline`` > 1 keeps two frames in flight on two threads: while one
    frame's results come back to the host and become uint8, the next
    frame's chunks queue on the device.  The trunk is folded before the
    threads start, so they share one fold, and every frame is the same
    bytes as with ``pipeline=1``."""
    def _one(kf: Keyframe) -> np.ndarray:
        if kf.cam_pose is not None:
            x, y, z, pitch, yaw, fov = kf.cam_pose
            out = renderer.render_perspective(
                (x, y, z), pitch, yaw, fov, out_size, kf.sun_el_az,
                kf.time_frac, angles_to_vec=angles_to_vec)
        else:
            out = renderer.render_img(kf.view_el_az, kf.sun_el_az,
                                      kf.time_frac, out_size,
                                      angles_to_vec=angles_to_vec)
        img = np.clip(np.nan_to_num(out["Col_Img"]), 0, 1)
        return (img * 255).astype(np.uint8)

    kfs = script.sample(n_frames)
    if pipeline <= 1 or len(kfs) < 2:
        return np.stack([_one(kf) for kf in kfs])
    renderer.model.G_NeRF_net.fused()       # one fold, before the threads
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(pipeline, 2)) as ex:
        return np.stack(list(ex.map(_one, kfs)))


def export_film(frames: np.ndarray, path: str, fps: int = 12) -> str:
    """Write uint8 [N, H, W, 3] frames as a GIF that loops forever, 1/fps
    seconds a frame (in hundredths, as GIF counts); an ``.mp4`` path is
    written as the ``.gif`` beside it.  Returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".mp4"):
        path = path[:-4] + ".gif"
    with open(path, "wb") as f:
        f.write(encode_gif(list(frames), delay_cs=int(round(100 / fps))))
    return path


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
