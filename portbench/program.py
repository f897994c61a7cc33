"""The program under test, reached only through its public entry points:
a configuration turned into the port's ``Config``, a model directory
written by the port's own writers, and the shapes of its state dict."""

from __future__ import annotations

import dataclasses
import gc
import json
import os

import torch


def port_config(config: dict, **over):
    """The port's ``Config`` of a benchmark configuration: each of its
    keys that ``Config`` has, then ``over``."""
    from season_nerf_torch.config import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw.update(over)
    return Config(**kw)


def state_shapes(cfg) -> dict:
    """name -> shape of the state dict of the port's model of ``cfg``."""
    from season_nerf_torch.models.tnerf import model_from_config
    with torch.device("meta"):
        model = model_from_config(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def write_model_dir(d: str, cfg, weights: dict, drop=()):
    """A model directory of ``weights`` (opts.json without the keys in
    ``drop``, Final_Model.nn, the world artifact of a synthetic site)
    through the port's writers."""
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.train.state import save_model_artifact
    opts = dataclasses.asdict(cfg)
    for k in drop:
        opts.pop(k)
    with open(os.path.join(d, "opts.json"), "w") as f:
        json.dump(opts, f, indent=1)
    save_model_artifact(os.path.join(d, "Final_Model.nn"),
                        {k: v.cpu() for k, v in weights.items()})
    save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))


def free(run):
    """Drop the run's program objects and return their device memory, so
    that the reference that follows has the card."""
    run.program = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
