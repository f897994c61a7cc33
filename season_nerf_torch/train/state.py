"""Training state: the OneCycle schedule, the two Adam optimizers, the
full-state checkpoint, and the inference artifact ``Final_Model.nn``.

The counterpart of ``season_nerf_tpu/train/state.py``.

- :func:`onecycle` is the JAX package's piecewise cosine (warm-up over
  ``max(int(0.3 n), 1)`` steps, then the fall), not torch's
  ``OneCycleLR``, which counts steps differently.
- :class:`Optimizers`: Adam on the network at ``lr`` and Adam on the
  adaptive-loss latents at ``lr * lr_alpha_scale``, each with its own
  OneCycle over the phase, both fresh at every phase entry.
- A checkpoint (``Model_<step>.nn``) is the port's own msgpack layout:
  the model's state dict, both optimizers' state dicts, the latents and
  host metadata, enough to resume a run exactly.
- ``Final_Model.nn`` is flax msgpack, ``{"params", "batch_stats",
  "meta"}`` in flax's layout (the JAX package's ``save_model_artifact``),
  written and read through the port's codec (``utils/msgpack_lite.py``) and
  weight bridge (``utils/convert.py``), so a model directory written by
  either package loads in the other.
- :func:`load_weights` reads the weights and statistics of any of these,
  and of the JAX package's checkpoints, for the tools that score save
  points.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from season_nerf_torch.utils import msgpack_lite
from season_nerf_torch.utils.convert import (flax_from_state_dict,
                                             state_dict_from_flax)


def onecycle(peak_lr: float, total_steps: int, pct_start=0.3,
             div_factor=25.0, final_div_factor=1e4) -> Callable[[int], float]:
    """count -> learning rate: a cosine rise from ``peak / 25`` to the peak,
    then a cosine fall to ``peak / 25 / 1e4``; finite on tiny phases."""
    warmup = max(int(pct_start * total_steps), 1)
    decay = max(total_steps - warmup, 1)
    init_lr = peak_lr / div_factor
    final_lr = init_lr / final_div_factor

    def lr(count: int) -> float:
        if count < warmup:
            frac = min(max(count / warmup, 0.0), 1.0)
            return init_lr + (peak_lr - init_lr) * 0.5 * (
                1 - math.cos(math.pi * frac))
        frac = min(max((count - warmup) / decay, 0.0), 1.0)
        return final_lr + (peak_lr - final_lr) * 0.5 * (
            1 + math.cos(math.pi * frac))
    return lr


class Optimizers:
    """The network's Adam and the latents' Adam (absent when the phase has
    no latents), each with a OneCycle over ``phase_len`` steps."""

    def __init__(self, net_params, ada_params, lr: float,
                 lr_alpha_scale: float, phase_len: int):
        self.net = torch.optim.Adam(list(net_params), lr=lr)
        ada_params = list(ada_params)
        self.ada = (torch.optim.Adam(ada_params, lr=lr * lr_alpha_scale)
                    if ada_params else None)
        self.net_lr = onecycle(lr, phase_len)
        self.ada_lr = onecycle(lr * lr_alpha_scale, phase_len)

    def zero_grad(self):
        for opt in (self.net, self.ada):
            if opt is not None:
                opt.zero_grad(set_to_none=True)

    def step(self, count: int):
        """One update of each; ``count`` is the step within the phase."""
        for opt, sched in ((self.net, self.net_lr), (self.ada, self.ada_lr)):
            if opt is not None:
                for g in opt.param_groups:
                    g["lr"] = sched(count)
                opt.step()

    def state_dict(self):
        return {"net": self.net.state_dict(),
                "ada": self.ada.state_dict() if self.ada else None}

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd["net"])
        if self.ada is not None:
            self.ada.load_state_dict(sd["ada"])


# --- checkpoint --------------------------------------------------------------
def _to_plain(obj):
    """Tensors -> numpy, dict keys -> str (msgpack maps sort their keys)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {str(k): _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj


def _optim_from_plain(sd):
    """An optimizer state dict back from :func:`_to_plain`: integer
    parameter ids, tensors."""
    if sd is None:
        return None
    state = {int(k): {n: torch.as_tensor(np.array(v)) for n, v in s.items()}
             for k, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def save_checkpoint(path: str, model: torch.nn.Module, ada_params: Dict,
                    optimizers: Optimizers, extra: Optional[Dict] = None):
    """Full-state checkpoint: weights, running statistics, both optimizer
    states, the adaptive-loss latents and ``extra`` (step, carried alpha
    and scale)."""
    payload = {"model": _to_plain(model.state_dict()),
               "ada": _to_plain(ada_params),
               "optim": _to_plain(optimizers.state_dict()),
               "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_lite.packb(payload))


def load_checkpoint(path: str) -> Dict:
    """-> {"model": state dict, "ada": latents, "optim": optimizer state
    dicts, "extra": dict}, tensors on the CPU."""
    with open(path, "rb") as f:
        payload = msgpack_lite.unpackb(f.read())
    t = lambda a: torch.as_tensor(np.array(a))
    return {"model": {k: t(v) for k, v in payload["model"].items()},
            "ada": {g: {k: t(v) for k, v in lat.items()}
                    for g, lat in payload["ada"].items()},
            "optim": {"net": _optim_from_plain(payload["optim"]["net"]),
                      "ada": _optim_from_plain(payload["optim"]["ada"])},
            "extra": payload.get("extra", {})}


# --- the inference artifact -------------------------------------------------
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


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """The weights and running statistics of ``path`` as the port's state
    dict, whatever wrote it: the port's full-state checkpoint, the JAX
    package's (``{"state": {"params", "batch_stats", ...}}``) or a
    ``Final_Model.nn`` artifact of either package."""
    with open(path, "rb") as f:
        payload = msgpack_lite.unpackb(f.read())
    if "model" in payload:                  # the port's checkpoint
        return {k: torch.as_tensor(np.array(v))
                for k, v in payload["model"].items()}
    if "state" in payload:                  # the JAX package's checkpoint
        payload = payload["state"]
    return state_dict_from_flax(payload["params"],
                                payload.get("batch_stats", {}))
