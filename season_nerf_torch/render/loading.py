"""Loading a trained model directory into a ready Renderer.

A model directory is ``opts.json`` + ``Final_Model.nn`` [+ ``W2C_W2L_H.npy``],
written by either package.  The sequence: config -> ``model_from_config``
-> weights through the weight bridge -> device -> trunk folded once on the
device -> Renderer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

import torch

from season_nerf_torch.config import Config
from season_nerf_torch.data.ingest import load_w2c_w2l
from season_nerf_torch.models.tnerf import TNeRF, model_from_config
from season_nerf_torch.ops.fused_trunk import refuse_on_card
from season_nerf_torch.render.renderer import Renderer
from season_nerf_torch.train.engine import _auto_mesh
from season_nerf_torch.train.state import load_model_artifact


@dataclasses.dataclass
class LoadedModel:
    """Everything a render surface needs from a trained model directory."""
    cfg: Config
    model: TNeRF
    renderer: Renderer
    angles_to_vec: Optional[Callable]        # world (el, az) -> cube vec
    h_range: Optional[Tuple[float, float]]   # site height range, meters


def load_model_dir(model_dir: str, n_samples: Optional[int] = None,
                   chunk: Optional[int] = None, use_mesh: bool = False,
                   fast_render: Optional[Tuple[int, int]] = None,
                   device="cuda") -> LoadedModel:
    """Load ``model_dir`` onto ``device`` (``cuda`` unless the caller asks
    for ``cpu``).  ``n_samples``/``chunk`` override the recorded values;
    ``fast_render=(n_coarse, n_fine)`` makes the Renderer depth-guided.
    ``use_mesh`` renders on the render mesh that the opts.json's
    ``mesh_shape`` gives on ``device``'s type (every visible card for
    None; :func:`_auto_mesh` with ``strict=False``, so a larger mesh than
    there are devices warns and clamps); without it ``mesh_shape`` is not
    read and the model renders on ``device``."""
    device = torch.device(device)
    cfg = Config.load_json(os.path.join(model_dir, "opts.json"))
    refuse_on_card(cfg, device)         # before the weights or a fold
    mesh = _auto_mesh(cfg, device, strict=False) if use_mesh else None
    sd, _ = load_model_artifact(os.path.join(model_dir, "Final_Model.nn"))
    model = model_from_config(cfg).load_weights(sd).to(device)
    model.G_NeRF_net.fused()            # fold the trunk once, on the device

    angles_to_vec, h_range = None, None
    w2c_path = os.path.join(model_dir, "W2C_W2L_H.npy")
    if os.path.exists(w2c_path):
        wc, S, h_range = load_w2c_w2l(w2c_path)
        if wc is not None:
            from season_nerf_torch.geometry.units import (
                angles_to_vec_from_site)
            angles_to_vec = angles_to_vec_from_site(wc, S)

    renderer = Renderer(model, n_samples=n_samples or cfg.n_samples,
                        chunk=chunk or cfg.chunk,
                        classic_solar=cfg.Solar_Type_2,
                        use_hsluv=cfg.use_HSLuv, fast_render=fast_render,
                        mesh=mesh)
    return LoadedModel(cfg=cfg, model=model, renderer=renderer,
                       angles_to_vec=angles_to_vec, h_range=h_range)
