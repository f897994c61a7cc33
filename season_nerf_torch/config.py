"""Configuration: one dataclass, field-for-field the JAX package's ``Config``.

Every field and default matches ``season_nerf_tpu/config.py`` so that an
``opts.json`` written by either package loads unchanged in the other.  The
port reads the model-shape and render fields (``fc_units``, ``fc_layers``,
``number_low_frequency_cases``, ``compute_dtype``, ``fast_sine``,
``n_samples``, ``chunk``, ``Solar_Type_2``, ``use_HSLuv``) and the training
fields of its trainer (``train/engine``); the rest are carried so that a
model directory round-trips.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # --- identity / IO ------------------------------------------------------
    exp_name: str = "exp"
    site_name: str = "OMA_281"
    IO_Location: str = "./io"
    cache_dir: str = ""
    logs_dir: str = ""
    root_dir: str = ""
    rpc_dir: str = ""
    testing_image_names: Optional[str] = None

    # --- mode flags (the reference's public CLI names) ----------------------
    Use_MSE_loss: bool = False
    jump_start: bool = True            # DSM prior on in phase 1
    Solar_Type_2: bool = False         # classic irradiance composite
    skip_Bundle_Adjust: bool = False
    Use_Solar: bool = True
    Use_Reg: bool = False              # accepted but inert, as in the reference
    use_auto_balance: bool = False     # accepted but inert, as in the reference
    use_HSLuv: bool = False            # color head trained in normalized HSLuv
    weight_training_samples: bool = False

    # --- training hypers ----------------------------------------------------
    max_train_steps: int = 50_000
    n_samples: int = 96                # samples per render ray
    n_importance: int = 0
    batch_size: int = 512
    lr: float = 10 ** -4.86
    lr_alpha_scale: float = 1000.0
    fc_units: int = 512                # trunk width
    fc_layers: int = 8                 # trunk depth (skip concat at depth//2+1)
    sc_lambda: float = 0.03
    ds_lambda: float = 0.03
    p_lambda: float = 0.03
    number_low_frequency_cases: int = 4   # seasonal classes
    chunk: int = 5_120                 # render rays per dispatch
    n_saves: int = 20
    testing_size: int = 3
    img_training_downscale: int = 1
    img_validation_downscale: int = 1
    camera_model: str = "Pinhole"
    DSM_Mode: str = "Space_Carve"
    height_range: Optional[Tuple[float, float]] = None

    # --- fields of the JAX trainer, recorded in opts.json -------------------
    resume: bool = True
    synth_views: int = 10
    synth_img_size: int = 96
    synth_grid: int = 96
    save_point_val_renders: int = -1
    remat_trunk: str = ""
    seed: int = 0
    scan_chunk: int = 20
    mesh_shape: Optional[int] = None
    compute_dtype: str = "bfloat16"    # matmul dtype of the network
    compile_cache: bool = True
    final_model_selection: str = "last"
    geometry_decay_threshold: float = 0.10
    phase4_prior_keepalive: float = 0.0
    phase4_keepalive_barron: bool = False
    pallas_trunk: bool = False
    fast_sine: bool = True             # degree-11 polynomial sine activation
    prefetch_device: bool = True

    def resolve_dirs(self, create=True):
        """Derive the directory layout from IO_Location and optionally
        create it (the same layout as the JAX package)."""
        io = self.IO_Location
        if not self.cache_dir:
            self.cache_dir = os.path.join(io, "Cache", self.site_name)
        if not self.root_dir:
            self.root_dir = os.path.join(io, "IEEE_Data")
        if not self.rpc_dir:
            self.rpc_dir = os.path.join(io, "Cache", self.site_name, "RPCs")
        if not self.logs_dir:
            self.logs_dir = os.path.join(io, "Logs", self.exp_name)
        if create:
            for d in (self.cache_dir, self.logs_dir):
                os.makedirs(d, exist_ok=True)
        return self

    # --- opts.json round trip -------------------------------------------------
    def save_json(self, path=None):
        path = path or os.path.join(self.logs_dir, "opts.json")
        with open(path, "w") as fout:
            json.dump(dataclasses.asdict(self), fout, indent=2)
        return path

    # Keys whose class default changed after model directories already
    # existed: an opts.json without one predates the knob and gets the
    # behaviour it was trained under, not today's default.
    _LEGACY_DEFAULTS = {"compute_dtype": "float32", "fast_sine": False}

    @classmethod
    def load_json(cls, path):
        with open(path, "r") as fin:
            d = json.load(fin)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        for k, v in cls._LEGACY_DEFAULTS.items():
            kwargs.setdefault(k, v)
        return cls(**kwargs)


def add_config_flags(parser: argparse.ArgumentParser,
                     defaults: Optional[Config] = None):
    """Register every Config field as a flag of the same name (booleans as
    ``--X`` / ``--no-X``), as the JAX package's command line does."""
    defaults = defaults or Config()
    for f in dataclasses.fields(Config):
        default = getattr(defaults, f.name)
        flag = "--" + f.name
        if isinstance(default, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=f.name, action="store_true",
                               default=default)
            group.add_argument("--no-" + f.name, dest=f.name,
                               action="store_false")
        elif f.name == "height_range":
            parser.add_argument(flag, type=float, nargs=2, default=None,
                                metavar=("MIN_M", "MAX_M"))
        elif default is None:
            typ = int if "int" in str(f.type) else str
            parser.add_argument(flag, type=typ, default=None)
        else:
            parser.add_argument(flag, type=type(default), default=default)
    return parser
