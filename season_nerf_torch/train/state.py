"""The inference artifact ``Final_Model.nn``: read and write.

The file is flax msgpack, ``{"params", "batch_stats", "meta"}`` with the
network variables in flax's layout (the JAX package's
``train/state.save_model_artifact``).  The port reads and writes it through
its own codec (``utils/msgpack_lite.py``) and converts through the one
weight bridge (``utils/convert.py``), so a model directory written by
either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from season_nerf_torch.utils import msgpack_lite
from season_nerf_torch.utils.convert import (flax_from_state_dict,
                                             state_dict_from_flax)


def save_model_artifact(path: str, state_dict: Dict[str, torch.Tensor],
                        meta: Optional[Dict] = None):
    """Write the port's state dict as a flax-layout ``Final_Model.nn``."""
    params, stats = flax_from_state_dict(state_dict)
    payload = {"params": params, "batch_stats": stats, "meta": meta or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_lite.packb(payload))


def load_model_artifact(path: str
                        ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """-> (the port's state dict, meta)."""
    with open(path, "rb") as f:
        payload = msgpack_lite.unpackb(f.read())
    sd = state_dict_from_flax(payload["params"],
                              payload.get("batch_stats", {}))
    return sd, payload.get("meta", {})
