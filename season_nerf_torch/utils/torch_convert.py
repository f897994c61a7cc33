"""Reference checkpoints: a torch ``T_NeRF`` ``Final_Model.nn`` -> the port.

The counterpart of ``season_nerf_tpu/utils/torch_convert.py``.  A reference
``Final_Model.nn`` / ``Model_<step>.nn`` is a torch state dict of
``T_NeRF_Full_2/T_NeRF_net_v2.py``, or a whole pickled module whose
``.state_dict()`` is taken.  The port's ``TNeRF`` keeps the reference's
names, layouts and unused heads, so converting is checking: every leaf of
a template (a port model's state dict at the target shape) must be there
with its shape, leaf by leaf, or the conversion raises; ``num_batches_
tracked`` is dropped (nothing reads it; flax has no counterpart); every
value becomes a float32 CPU tensor.  The reference's unused heads
(``adjust_rho``, ``adjust_solar_vis``, ``adjust_sky_col``) are kept where
the checkpoint has them, as the JAX converter keeps them, so the two
packages write the same arrays.  The other direction needs no code here:
``train/state.py::load_model_artifact`` already gives a reference state
dict.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from season_nerf_torch.models.tnerf import TNeRF


def read_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a torch checkpoint file: a state dict, or a
    pickled module's ``.state_dict()``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def convert_state_dict(state_dict: Dict, template: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the port's, held against ``template``:
    a leaf of the template missing from ``state_dict`` (an unused head
    excepted) or of another shape raises ``ValueError``; keys the template
    lacks are ignored, as the JAX converter ignores them."""
    out: Dict[str, torch.Tensor] = {}
    for key, want in template.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in state_dict:
            if key.split(".")[0] in TNeRF.UNUSED_HEADS:
                continue
            raise ValueError(f"missing converted leaf {key}")
        value = torch.as_tensor(state_dict[key])
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(value.shape)} vs {tuple(want.shape)}")
        out[key] = value.detach().to("cpu", torch.float32).contiguous()
    return out


def load_reference_checkpoint(path_or_state_dict: Union[str, Dict],
                              template: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """A checkpoint file or state dict -> the port's state dict, shape
    checked against ``template`` leaf by leaf (:func:`convert_state_dict`)."""
    sd = (read_reference_checkpoint(path_or_state_dict)
          if isinstance(path_or_state_dict, str) else path_or_state_dict)
    return convert_state_dict(sd, template)
