"""The weight bridge: flax variables <-> the port's ``TNeRF`` state dict.

The port's modules keep the reference ``T_NeRF`` state-dict names
(``G_NeRF_net.fc1.linear.weight``, ``time_layer_1.linear.bias``,
``get_class_layer.weight``, ...).  Flax keeps its own names and layouts:
Dense kernels are ``[in, out]`` (torch Linear weights are ``[out, in]``),
and BatchNorm has ``scale``/``bias`` params plus ``mean``/``var`` batch
stats (torch: ``weight``/``bias``/``running_mean``/``running_var``).

The mapping is by name, layer by layer, so it serves every trunk depth
that ``model_from_config`` builds (``fc1 .. fcN`` plus ``fc9``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# flax module name -> reference torch name (only names that differ)
_RENAME = {
    "gnerf": "G_NeRF_net",
    "fc10_col": "fc10Col",
    "fc10_sigma": "fc10Sigma",
    "fc_sky_1": "fc_sky_color_1",
    "fc_sky_2": "fc_sky_color_2",
    "time_1": "time_layer_1",
    "time_2": "time_layer_2",
    "adjust_1": "adjust_layer_1",
    "adjust_2": "adjust_layer_2",
    "adjust_3": "adjust_layer_3",
    "class_head": "get_class_layer",
}
_UNRENAME = {v: k for k, v in _RENAME.items()}

# flax leaf (under a Dense or a BatchNorm) -> torch leaf
_PARAM_LEAF = {"kernel": "weight", "bias": "bias"}
_NORM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, path=()):
    """Yield (path tuple, leaf) over a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _torch_prefix(path) -> str:
    return ".".join(_RENAME.get(p, p) for p in path)


def state_dict_from_flax(params: Dict, batch_stats: Dict
                         ) -> Dict[str, torch.Tensor]:
    """Flax ``(params, batch_stats)`` nested dicts of arrays (as
    ``jax.device_get(variables)`` or a restored ``Final_Model.nn`` gives
    them) -> the port's state dict of float32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value, transpose=False):
        a = np.array(value, np.float32)     # a writable copy
        sd[key] = torch.from_numpy(np.ascontiguousarray(a.T if transpose
                                                        else a))

    for path, leaf in _walk(params):
        *mods, name = path
        if mods and mods[-1] == "norm":
            put(_torch_prefix(mods) + "." + _NORM_LEAF[name], leaf)
        else:
            put(_torch_prefix(mods) + "." + _PARAM_LEAF[name], leaf,
                transpose=(name == "kernel"))
    for path, leaf in _walk(batch_stats or {}):
        *mods, name = path
        put(_torch_prefix(mods) + "." + _STAT_LEAF[name], leaf)
        sd[_torch_prefix(mods) + ".num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return sd


def flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of :func:`state_dict_from_flax`: the port's state dict
    -> flax ``(params, batch_stats)`` nested dicts of float32 numpy arrays
    (``num_batches_tracked`` has no flax counterpart and is dropped)."""
    params: Dict = {}
    stats: Dict = {}
    param_leaf = {v: k for k, v in _PARAM_LEAF.items()}
    norm_leaf = {v: k for k, v in _NORM_LEAF.items()}
    stat_leaf = {v: k for k, v in _STAT_LEAF.items()}
    for key, value in sd.items():
        *mods, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        mods = [_UNRENAME.get(m, m) for m in mods]
        a = value.detach().to("cpu", torch.float32).numpy()
        if mods[-1] == "norm" and name in stat_leaf:
            tree, leaf = stats, stat_leaf[name]
        elif mods[-1] == "norm":
            tree, leaf = params, norm_leaf[name]
        else:
            tree, leaf = params, param_leaf[name]
            if leaf == "kernel":
                a = a.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return params, stats
