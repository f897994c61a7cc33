"""Command line of the port.

    python -m season_nerf_torch.cli train --site_name OMA_281 \
        --exp_name run --IO_Location DIR [any Config field as --flag] \
        [--train_steps N] [--device cuda]
    python -m season_nerf_torch.cli lite [the flags of train]
    python -m season_nerf_torch.cli render --Model_Location DIR \
        --VA 70 30 --SA 45 180 --tf 07/19 [--Output_Size 256 | H W S] \
        [--Save_Name out.png] [--exact_shadow] [--device cuda]
    python -m season_nerf_torch.cli setup_data --zip_dir ZIPS \
        --IO_Location DIR [--code_data_path DIR]
    python -m season_nerf_torch.cli eval_region --Model_Locations D [D ...] \
        [--Output DIR] [--full] [--device cuda]

``train`` is ``main.py`` (the JAX package's ``run_test``): prepare the
site, train (resuming from the newest ``Model_<step>.nn`` of the log
directory under the settings recorded in its opts.json), validate at every
save point, and write ``Final_Model.nn`` (the last step's or the selected
save point's weights), ``opts.json``, ``W2C_W2L_H.npy`` and the split
files, a model directory that ``render`` and the service load; then the
validation report of the trained model, and its evaluation:
``analyze_model`` into ``Analysis.pickle`` and ``Output/``, then
``regional_eval`` into ``Detailed_Output/``.  ``lite`` is
``train`` over ``lite_defaults()`` (``main_lite.py``).  A site named
``SYNTH*`` is the built-in synthetic scene; any other is a DFC2019-format
site under ``IO_Location`` (``IEEE_Data/Images/*_RGB.tif``,
``Cache/<site>/`` with the ``.ikono`` RPCs and ``RPCs/*.IMD``,
``IEEE_Data/Track3-Truth/<site>_DSM.{tif,txt}``): ingest, camera fits, ray
table, the DSM prior (space carving swept on the training device) and
training.  On several devices (``mesh_shape``; None: every visible card)
``train`` prepares the site once, trains one process per device over
``torch.distributed`` (``parallel/mesh.py``) and evaluates on the render
mesh.  ``eval_region`` is ``main_eval_region.py``: evaluate each
model directory as ``train`` does (``run_test`` with ``eval_only``), then
merge their ``Detailed_Output/`` into ``--Output`` (default
``Full_Summary`` beside the first); ``--full`` is parsed and unused, as in
the JAX package.  ``render`` is the port of ``main_run_Season_NeRF.py``: a
novel view of a model directory (season-adjusted composite times the
shadow adjustment), written as PNG.  ``setup_data`` is
``main_setup_data.py``: unpack the DFC2019 zips and the repository's
``Data.zip`` into that layout.  Serving is ``python -m
season_nerf_torch.render.serving``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
import sys
import zipfile
from typing import Optional, Tuple

import numpy as np

from season_nerf_torch.config import (Config, add_config_flags, get_opts,
                                      lite_defaults)
from season_nerf_torch.data import ingest, lidar, rays
from season_nerf_torch.ops.fused_trunk import refuse_on_card
from season_nerf_torch.priors import space_carving
from season_nerf_torch.geometry.time_enc import year_frac_from_month_day
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.parallel.mesh import Mesh, launch
from season_nerf_torch.train.engine import _auto_mesh
from season_nerf_torch.render.renderer import images_from_components
from season_nerf_torch.render.serving import png_bytes


def render_pretrained(model_dir: str, va: Tuple[float, float],
                      sa: Tuple[float, float], tf: str, out_size=256,
                      exact_shadow: bool = False,
                      save_name: Optional[str] = None, device="cuda"):
    """Novel view from a model directory -> (shown image, all images).

    ``out_size``: an int renders square at the model's n_samples; (H, W)
    sets the frame; (H, W, S) also sets the samples per ray."""
    try:
        if "/" in tf:
            month, day = tf.split("/")
            year_frac = year_frac_from_month_day(int(month), int(day))
        else:
            year_frac = float(tf)
    except (ValueError, TypeError):
        raise SystemExit(
            f"--tf must be MM/DD (e.g. 07/19) or a year fraction in [0,1); "
            f"got {tf!r}")
    size = ((out_size, out_size) if np.isscalar(out_size)
            else tuple(out_size))
    hw = (size[0], size[1] if len(size) > 1 else size[0])
    n_samples = size[2] if len(size) > 2 else None

    loaded = load_model_dir(model_dir, n_samples=n_samples, use_mesh=True,
                            device=device)
    comp = loaded.renderer.component_render_by_dir(
        tuple(va), tuple(sa), year_frac, hw,
        angles_to_vec=loaded.angles_to_vec, exact_solar=exact_shadow)
    imgs = images_from_components(comp, hw,
                                  classic_shadows=loaded.cfg.Solar_Type_2)
    shown = imgs["Season_Adj_Img"] * imgs["Shadow_Adjust"]
    if save_name:
        with open(save_name, "wb") as f:
            f.write(png_bytes(shown))
    return shown, imgs


def _write_split(cfg: Config, names, train_idx, test_idx):
    """``Training_Imgs.txt`` / ``Testing_Imgs.txt`` of the log directory."""
    for fname, idx in (("Training_Imgs.txt", train_idx),
                       ("Testing_Imgs.txt", test_idx)):
        with open(os.path.join(cfg.logs_dir, fname), "w") as f:
            f.write("\n".join(names[i] for i in idx))


def prepare_synthetic(cfg: Config):
    """The synthetic site of ``cfg`` -> (cameras, table, train_idx,
    test_idx, prior DSM, ground-truth DSM, height range, world centre,
    similarity), the world frame None; writes the split and the world
    artifact into the log directory."""
    from season_nerf_torch.data.synthetic import make_scene
    scene = make_scene(n_views=cfg.synth_views, img_size=cfg.synth_img_size,
                       grid=cfg.synth_grid, seed=cfg.seed)
    weights = (rays.camera_weights(scene.cameras)
               if cfg.weight_training_samples else None)
    table = rays.build_ray_table(scene.cameras, scene.images,
                                 weights=weights, use_hsluv=cfg.use_HSLuv)
    train_idx, test_idx = rays.train_test_split(len(scene.cameras),
                                                testing_size=cfg.testing_size)
    if cfg.logs_dir:
        _write_split(cfg, [c.name for c in scene.cameras], train_idx,
                     test_idx)
        # no world frame, but the height range lets the model directory
        # serve height maps in meters
        ingest.save_world_artifact(
            os.path.join(cfg.logs_dir, "W2C_W2L_H.npy"), None, None,
            (0.0, 30.0))
    return (scene.cameras, table, list(train_idx), list(test_idx),
            scene.prior_hm, scene.hm, (0.0, 30.0), None, None)


def prepare_real(cfg: Config, device="cuda"):
    """A DFC2019-format site -> the tuple of :func:`prepare_synthetic`.
    Ingests the site (bounds cached as ``bounds_LLA[_Refined].npy``),
    writes ``W2C_W2L_H.npy`` and the split, builds the ray table (cached by
    its settings and split), resamples the lidar DSM onto the prior's grid
    and computes the DSM prior: Space_Carve (swept on ``device``, cached as
    ``SC_<site>_hm.npy``), LiDAR or None."""
    if cfg.testing_image_names and not os.path.exists(cfg.testing_image_names):
        # a mistyped path must not fall back to another split: that would
        # train on the images meant to be held out
        raise FileNotFoundError(
            f"--testing_image_names {cfg.testing_image_names} not found")
    gt_dir = os.path.join(cfg.root_dir, "Track3-Truth")
    if not os.path.isdir(gt_dir):
        gt_dir = None
    h_override = tuple(cfg.height_range) if cfg.height_range else None
    if gt_dir is None and h_override is None:
        raise FileNotFoundError(
            f"{cfg.root_dir}/Track3-Truth not found: the site height range "
            "is derived from the lidar DSM. Either provide the Track3-Truth "
            "directory or pass an explicit --height_range MIN_M MAX_M "
            "(training then runs without GT evaluation).")
    site = ingest.preprocess_site(
        cfg.root_dir, cfg.site_name, cfg.rpc_dir, cfg.cache_dir,
        gt_dir=gt_dir, height_range=h_override,
        skip_bundle_adjust=cfg.skip_Bundle_Adjust,
        camera_model=cfg.camera_model)
    ingest.save_w2c_w2l(os.path.join(cfg.logs_dir, "W2C_W2L_H.npy"), site)
    wc, S = ingest.world_transform(site)

    t_file = cfg.testing_image_names or os.path.join(cfg.cache_dir,
                                                      "Testing_Imgs.txt")
    testing_names = None
    if os.path.exists(t_file):
        with open(t_file) as f:
            testing_names = [l.strip() for l in f if l.strip()] or None
    names = [c.name for c in site.cameras]
    train_idx, test_idx = rays.train_test_split(
        len(site.cameras), testing_size=cfg.testing_size,
        testing_names=testing_names, names=names)
    _write_split(cfg, names, train_idx, test_idx)

    weights = (rays.camera_weights(site.cameras)
               if cfg.weight_training_samples else None)
    # the held-out cameras at their own downscale
    held = set(test_idx.tolist())
    downscales = [cfg.img_validation_downscale if i in held
                  else cfg.img_training_downscale
                  for i in range(len(site.cameras))]
    table = rays.build_ray_table(
        site.cameras, [c.image for c in site.cameras], downscales=downscales,
        weights=weights, use_hsluv=cfg.use_HSLuv,
        cache_path=rays.cache_path(cfg.cache_dir, cfg, downscales))

    gt_dsm = None
    if gt_dir is not None:
        grid = space_carving.model_grid_from_bounds(site.bounds_lla)
        gt_dsm = lidar.get_gt_dsm(gt_dir, cfg.site_name, grid[:2],
                                  site.bounds_lla)
    prior = None
    if cfg.jump_start and cfg.DSM_Mode == "Space_Carve":
        train_cams = [site.cameras[i] for i in train_idx]
        prior = space_carving.space_carve_dsm(
            train_cams, [c.image for c in train_cams],
            bounds_lla=site.bounds_lla,
            cache_path=os.path.join(cfg.cache_dir,
                                    f"SC_{cfg.site_name}_hm.npy"),
            device=device)
    elif cfg.jump_start and cfg.DSM_Mode == "LiDAR":
        prior = gt_dsm
    return (site.cameras, table, list(train_idx), list(test_idx), prior,
            gt_dsm, tuple(site.bounds_lla[2]), wc, S)


def _prepare(cfg: Config, device):
    """The site of ``cfg``: built-in synthetic for ``SYNTH*`` names, else a
    DFC2019-format site -> the tuple of :func:`prepare_synthetic`.  A
    model K3 cannot take on the card is refused first."""
    refuse_on_card(cfg, device)
    if cfg.site_name.upper().startswith("SYNTH"):
        return prepare_synthetic(cfg)
    return prepare_real(cfg, device=device)


@dataclasses.dataclass
class MeshRun:
    """What a run on a mesh returns in the calling process, where no
    Trainer lives: the ranks trained in processes of their own."""
    step: int
    model: object           # rank 0's last weights (TNeRF), on ``device``


def _train_rank(mesh: Mesh, cfg: Config, prep, train_steps):
    """A rank of :func:`_train` on a mesh -> the step reached and, from
    rank 0, the model's weights on the CPU."""
    trainer = _train(cfg, prep, train_steps, mesh.device, mesh)
    sd = ({k: v.detach().cpu() for k, v in
           trainer.model.state_dict().items()} if mesh.rank == 0 else None)
    return trainer.step, sd


def _train(cfg: Config, prep, train_steps: Optional[int], device,
           mesh: Optional[Mesh] = None):
    """Train on the prepared site (resuming from the newest checkpoint of
    the log directory when ``cfg.resume``; a finished run skips to the
    end), finalize and write the validation report -> the Trainer.  On a
    ``mesh`` of devices, one rank a device (:func:`parallel.mesh.launch`),
    the ray tables handed over in shared memory -> a :class:`MeshRun`."""
    from season_nerf_torch.data.dataset import as_table, shared_table
    from season_nerf_torch.geometry.units import sun_frame_from_site
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.train.engine import Trainer
    _, table, train_idx, test_idx, prior, gt_dsm, h_range, wc, S = prep
    if mesh is not None and mesh.group is None:
        tables = tuple(None if t is None else shared_table(t) for t in (
            table.split(np.array(train_idx)),
            table.split(np.array(test_idx)) if test_idx else None))
        ranks = launch(_train_rank, mesh, cfg,
                       (None, tables, None, None, prior, gt_dsm, h_range,
                        wc, S), train_steps)
        model = model_from_config(cfg).load_weights(ranks[0][1])
        return MeshRun(step=ranks[0][0], model=model.to(device))
    sun_frame = sun_frame_from_site(wc, S) if wc is not None else None
    if mesh is not None:        # a rank: the tables came in shared memory
        train_table, val_table = (None if t is None else as_table(t)
                                  for t in table)
    else:
        train_table = table.split(np.array(train_idx))
        val_table = table.split(np.array(test_idx)) if test_idx else None
    trainer = Trainer(cfg, train_table, val_table, prior_hm=prior,
                      gt_dsm=gt_dsm, sun_frame=sun_frame, device=device,
                      mesh=mesh)
    step_of = lambda p: int(re.search(r"Model_(\d+)\.nn$", p).group(1))
    ckpts = sorted(glob.glob(os.path.join(cfg.logs_dir, "Model_*.nn")),
                   key=step_of)
    say = print if trainer.writes else (lambda *a: None)   # rank 0 speaks
    if ckpts and cfg.resume and step_of(ckpts[-1]) > 0:
        say(f"resuming from {ckpts[-1]}")
        trainer.resume(ckpts[-1])
    if trainer.step < cfg.max_train_steps:
        trainer.run(n_steps=train_steps)
    else:
        say("training already complete; skipping to the validation report")
    trainer.finalize()
    trainer.validation_report()
    return trainer


def run_train(cfg: Config, train_steps: Optional[int] = None,
              device="cuda", mesh: Optional[Mesh] = None):
    """Prepare the site, train (resuming from the newest checkpoint of the
    log directory when ``cfg.resume``; a finished run skips to the end),
    finalize and write the validation report -> the Trainer, or a
    :class:`MeshRun` where the run took a mesh: ``mesh``, else the one
    :func:`_auto_mesh` gives (``mesh_shape``; None: every visible card),
    decided before the site is prepared.  ``cfg`` is what :func:`get_opts`
    returns: its directories resolved, a resumed run's recorded settings
    adopted and opts.json written."""
    if mesh is None:
        mesh = _auto_mesh(cfg, device)
    return _train(cfg, _prepare(cfg, device), train_steps, device, mesh)


def run_test(cfg: Config, eval_only: bool = False,
             train_steps: Optional[int] = None, eval_img_size=None,
             eval_season_size=None, device="cuda",
             mesh: Optional[Mesh] = None):
    """The pipeline of ``main.py``: prepare the site; train as
    :func:`run_train` does (or, with ``eval_only``, load the model
    directory ``cfg.logs_dir``); then evaluate the model that
    ``Final_Model.nn`` holds (the last step's weights, or the save point
    ``final_model_selection`` chose) with :func:`analyze_model` into
    ``Analysis.pickle`` and ``Output/``, and with :func:`regional_eval`
    at its quick sizes into ``Detailed_Output/`` -> (the Trainer or None,
    the analysis).

    ``eval_img_size`` (H, W) shrinks the test renders from 256 x 256 and
    the walks from 128 px to H, and then both suites take ``cfg.n_samples``
    for the height map (and the regional suite for the shadow rays);
    ``eval_season_size`` (H, W) shrinks the regional season walk from
    64 x 64.  Training takes ``mesh`` as :func:`run_train` does; the
    evaluation renders on it (with ``eval_only``, on the one that
    :func:`_auto_mesh` gives with ``strict=False``)."""
    from season_nerf_torch.eval.regional import (analyze_model,
                                                 regional_eval,
                                                 write_analysis_outputs)
    from season_nerf_torch.geometry.units import angles_to_vec_from_site
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.render.renderer import Renderer
    from season_nerf_torch.train.state import load_model_artifact
    if eval_only:
        mesh = mesh or _auto_mesh(cfg, device, strict=False)
    elif mesh is None:
        mesh = _auto_mesh(cfg, device)      # before the site is prepared
    prep = _prepare(cfg, device)
    cams, _, _, test_idx, prior, gt_dsm, h_range, wc, S = prep
    if eval_only:
        # the model directory's own opts.json sets the architecture
        model = load_model_dir(cfg.logs_dir, device=device).model
        trainer = None
    else:
        trainer = _train(cfg, prep, train_steps, device, mesh)
        model = trainer.model
        if cfg.final_model_selection != "last" and cfg.logs_dir:
            # finalize() may have chosen an earlier save point: evaluate
            # the weights Final_Model.nn ships
            sd, _ = load_model_artifact(
                os.path.join(cfg.logs_dir, "Final_Model.nn"))
            model = model_from_config(cfg).load_weights(sd).to(device)
    renderer = Renderer(model, n_samples=cfg.n_samples, chunk=cfg.chunk,
                        classic_solar=cfg.Solar_Type_2,
                        use_hsluv=cfg.use_HSLuv, mesh=mesh)
    angles_to_vec = (angles_to_vec_from_site(wc, S) if wc is not None
                     else None)
    analysis = analyze_model(
        renderer, renderer.model, cams, test_idx, gt_dsm, h_range,
        cfg.logs_dir, hm_samples=cfg.n_samples,
        img_size=tuple(eval_img_size) if eval_img_size else (256, 256),
        walk_size=eval_img_size[0] if eval_img_size else 128,
        angles_to_vec=angles_to_vec)
    write_analysis_outputs(analysis, os.path.join(cfg.logs_dir, "Output"))
    regional_eval(
        renderer, renderer.model, cams, test_idx, gt_dsm, prior, h_range,
        os.path.join(cfg.logs_dir, "Detailed_Output"), quick=True,
        img_size=tuple(eval_img_size) if eval_img_size else None,
        season_size=tuple(eval_season_size) if eval_season_size else None,
        hm_samples=cfg.n_samples if eval_img_size else None,
        angles_to_vec=angles_to_vec)
    return trainer, analysis


def eval_region(model_locations, output: Optional[str] = None,
                device="cuda") -> str:
    """``main_eval_region.py``: :func:`run_test` with ``eval_only`` on
    each model directory (its opts.json, ``logs_dir`` set to it), then
    :func:`multi_region_merge` of their ``Detailed_Output/`` into
    ``output`` (default ``Full_Summary`` beside the first) -> ``output``."""
    from season_nerf_torch.eval.regional import multi_region_merge
    region_dirs = []
    for loc in model_locations:
        cfg = Config.load_json(os.path.join(loc, "opts.json"))
        cfg.logs_dir = loc
        run_test(cfg, eval_only=True, device=device)
        region_dirs.append(os.path.join(loc, "Detailed_Output"))
    out = output or os.path.join(os.path.dirname(model_locations[0]),
                                 "Full_Summary")
    multi_region_merge(region_dirs, out)
    return out


def setup_data(zip_dir: str, io_location: str, code_data_path=None):
    """Unpack the DFC2019 Track-3 zips of ``zip_dir`` into
    ``IEEE_Data/Images`` and the repository's ``Data.zip`` (cached RPCs and
    region lists; searched in ``zip_dir``, ``code_data_path`` and the
    repository root) into ``Cache/<site>/`` -> the images directory."""
    img_out = os.path.join(io_location, "IEEE_Data", "Images")
    os.makedirs(img_out, exist_ok=True)
    zips = [os.path.join(zip_dir, f) for f in sorted(os.listdir(zip_dir))
            if f.endswith(".zip")]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for extra in (code_data_path, repo_root):
        if not extra:
            continue
        dz = os.path.join(extra, "Data.zip")
        if os.path.exists(dz) and dz not in zips and not any(
                os.path.basename(z) == "Data.zip" for z in zips):
            zips.append(dz)
    for path in zips:
        fname = os.path.basename(path)
        with zipfile.ZipFile(path) as z:
            for member in z.namelist():
                base = os.path.basename(member)
                if not base:
                    continue
                if fname == "Data.zip":
                    parts = member.split("/")
                    site = next((p for p in parts if "_" in p and
                                 p[:3].isalpha()), None)
                    dest_dir = os.path.join(io_location, "Cache",
                                            site or "misc")
                    os.makedirs(dest_dir, exist_ok=True)
                    with z.open(member) as src, \
                            open(os.path.join(dest_dir, base), "wb") as dst:
                        dst.write(src.read())
                elif base.endswith((".tif", ".IMD", ".txt")):
                    with z.open(member) as src, \
                            open(os.path.join(img_out, base), "wb") as dst:
                        dst.write(src.read())
    return img_out


def _add_run_flags(parser):
    """The flags of ``train`` and ``lite`` that are not Config fields."""
    parser.add_argument("--train_steps", type=int, default=None,
                        help="stop after this many steps (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="python -m season_nerf_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    for name, defaults, what in (
            ("train", None, "train a site, write a model directory"),
            ("lite", lite_defaults(), "train with the quick defaults "
                                      "(5000 steps, downscaled images)")):
        t = sub.add_parser(name, help=what)
        _add_run_flags(add_config_flags(t, defaults))
    r = sub.add_parser("render", help="render a novel view of a model dir")
    r.add_argument("--Model_Location", required=True)
    r.add_argument("--VA", nargs=2, type=float, default=[70.0, 0.0],
                   help="view elevation azimuth (deg)")
    r.add_argument("--SA", nargs=2, type=float, default=[45.0, 180.0],
                   help="sun elevation azimuth (deg)")
    r.add_argument("--tf", type=str, default="07/01",
                   help="time of year, MM/DD or fraction")
    r.add_argument("--Output_Size", type=int, nargs="+", default=[256],
                   help="1 int (square) or H W n_samples")
    r.add_argument("--Save_Name", type=str, default=None)
    r.add_argument("--exact_shadow", action="store_true")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    d = sub.add_parser("setup_data", help="unpack the DFC2019 zips into "
                                          "the site layout")
    d.add_argument("--zip_dir", required=True)
    d.add_argument("--IO_Location", required=True)
    d.add_argument("--code_data_path", default=None)
    e = sub.add_parser("eval_region", help="evaluate model directories and "
                                           "merge their regional results")
    e.add_argument("--Model_Locations", nargs="+", required=True,
                   help="trained model dirs (opts.json + Final_Model.nn)")
    e.add_argument("--Output", default=None)
    e.add_argument("--full", action="store_true",
                   help="full-quality (slow) evaluation; unused, as in the "
                        "JAX package")
    e.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)
    if args.command == "eval_region":
        print("merged summary written to",
              eval_region(args.Model_Locations, args.Output,
                          device=args.device))
        return 0
    if args.command == "setup_data":
        print("images in", setup_data(args.zip_dir, args.IO_Location,
                                      args.code_data_path))
        return 0
    if args.command in ("train", "lite"):
        # the Config flags go through get_opts, as the JAX package's do
        _, rest = _add_run_flags(argparse.ArgumentParser(
            allow_abbrev=False)).parse_known_args(argv[1:])
        cfg = get_opts(rest, lite_defaults() if args.command == "lite"
                       else None)
        trainer, _ = run_test(cfg, train_steps=args.train_steps,
                              device=args.device)
        print("trained", trainer.step, "steps; model directory",
              cfg.logs_dir, "evaluated into Output/ and Detailed_Output/")
        return 0
    out_size = (args.Output_Size[0] if len(args.Output_Size) == 1
                else tuple(args.Output_Size))
    save = args.Save_Name or os.path.join(args.Model_Location, "render.png")
    render_pretrained(args.Model_Location, tuple(args.VA), tuple(args.SA),
                      args.tf, out_size=out_size,
                      exact_shadow=args.exact_shadow, save_name=save,
                      device=args.device)
    print("saved", save)


if __name__ == "__main__":
    sys.exit(main())
