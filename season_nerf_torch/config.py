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
import glob
import json
import os
import re
import warnings
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
    fast_sine: bool = True             # polynomial sine (FAST_SIN_DEGREE, 11)
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

    # Fields a resumed run keeps from its recorded opts.json: they set the
    # architecture, arithmetic, ray table, losses or schedule of the
    # training trajectory.  max_train_steps is absent (extending a run is
    # legitimate), and so is seed.
    _RESUME_CRITICAL = (
        "compute_dtype", "fast_sine", "fc_units", "fc_layers",
        "number_low_frequency_cases", "n_samples", "n_importance",
        "use_HSLuv", "Use_MSE_loss", "Use_Solar", "Solar_Type_2",
        "sc_lambda", "ds_lambda", "p_lambda", "lr", "lr_alpha_scale",
        "phase4_prior_keepalive", "phase4_keepalive_barron", "pallas_trunk",
        "batch_size", "n_saves", "jump_start", "DSM_Mode",
        "weight_training_samples", "img_training_downscale",
        "img_validation_downscale", "testing_size", "site_name",
        "camera_model", "skip_Bundle_Adjust",
    )

    def adopt_resume_settings(self):
        """Where the log directory holds checkpoints of an earlier run (a
        ``Model_<step>.nn`` past step 0), its recorded opts.json wins for
        every field of :attr:`_RESUME_CRITICAL`, with a warning naming
        each, so that the run finishes as it began and the opts.json
        written next still describes it.  ``resume=False`` (``--no-resume``)
        keeps the new settings.  Call it before :meth:`save_json`."""
        path = os.path.join(self.logs_dir, "opts.json") if self.logs_dir \
            else ""
        if not self.resume or not path or not os.path.exists(path):
            return self
        steps = [int(re.search(r"Model_(\d+)", p).group(1)) for p in
                 glob.glob(os.path.join(self.logs_dir, "Model_*.nn"))]
        if not steps or max(steps) == 0:
            return self
        saved = type(self).load_json(path)
        changed = []
        for name in self._RESUME_CRITICAL:
            old, new = getattr(saved, name), getattr(self, name)
            if old != new:
                setattr(self, name, old)
                changed.append(f"  {name}: {new!r} -> {old!r}")
        if changed:
            warnings.warn(
                "resuming an existing run: its recorded opts.json wins for "
                "trajectory-critical settings (pass --no-resume to retrain "
                "under the new values):\n" + "\n".join(changed))
        return self

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
            parser.add_argument(flag, type=float, nargs=2, default=default,
                                metavar=("MIN_M", "MAX_M"))
        elif default is None:
            typ = int if "int" in str(f.type) else str
            parser.add_argument(flag, type=typ, default=None)
        else:
            parser.add_argument(flag, type=type(default), default=default)
    return parser


def apply_overrides(cfg: Config, pairs):
    """Apply ``KEY=VALUE`` strings to ``cfg``, coerced by the field's
    declared type: booleans take true/false/1/0/yes/no/on/off (any case),
    ``none`` clears only an Optional field, an unknown name or a bad value
    raises ValueError."""
    fields = {f.name: f for f in dataclasses.fields(type(cfg))}
    for kv in pairs:
        key, _, val = kv.partition("=")
        if not _ or key not in fields:
            raise ValueError(f"unknown config override {kv!r} "
                             f"(expect KEY=VALUE with a Config field name)")
        cur = getattr(cfg, key)
        ann = str(fields[key].type)
        if isinstance(cur, bool) or ann == "bool":
            low = val.strip().lower()
            if low in ("1", "true", "yes", "on"):
                coerced = True
            elif low in ("0", "false", "no", "off"):
                coerced = False
            else:
                raise ValueError(f"boolean field {key} got {val!r}")
        elif val.strip().lower() == "none":
            if "Optional" not in ann and "None" not in ann:
                raise ValueError(
                    f"config field {key} is not Optional; cannot set it "
                    f"to None (got {kv!r})")
            coerced = None
        elif isinstance(cur, int):
            coerced = int(val)
        elif isinstance(cur, float):
            coerced = float(val)
        elif cur is None:
            coerced = (int(val) if "int" in ann
                       else float(val) if "float" in ann else val)
        else:
            coerced = type(cur)(val)
        setattr(cfg, key, coerced)
    return cfg


def get_opts(argv=None, defaults: Optional[Config] = None,
             **overrides) -> Config:
    """Command line -> Config: parse ``argv`` (every field a flag, over
    ``defaults``), set ``overrides``, derive the directories, let a resumed
    run's recorded settings win (:meth:`Config.adopt_resume_settings`),
    then write opts.json, in that order."""
    parser = argparse.ArgumentParser()
    add_config_flags(parser, defaults)
    cfg = Config(**vars(parser.parse_args(argv)))
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.resolve_dirs()
    cfg.adopt_resume_settings()
    cfg.save_json()
    return cfg


def lite_defaults() -> Config:
    """The quick-train defaults of the ``lite`` entry point: 5000 steps,
    the learning rate x3, 10 saves, training and validation images
    downscaled 4x and 8x."""
    return Config(exp_name="OMA_281_Lite", site_name="OMA_281",
                  max_train_steps=5000, lr=3 * 10 ** -4.86, n_saves=10,
                  img_training_downscale=4, img_validation_downscale=8)
