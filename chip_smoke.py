#!/usr/bin/env python3
"""Drive the PyTorch port of Season-NeRF on one NVIDIA GPU and report.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``season_nerf_torch/csrc``: K3
   (``trunk_infer``), K1 (``trunk_train_fwd``), K2 (``trunk_train_bwd``),
   the polynomial sine (``fast_sine``) and the training BatchNorm
   (``batchnorm_train``), one ``nvcc`` per source, started together, and
   print what ``ptxas`` reports (registers, shared memory, spills);
3. hold each kernel against its plain PyTorch version:
   - K3 at the shapes of the flagship render chunk (width 512, fc1..fc8 +
     fc9, 5120 rays x 96 samples), at the validation chunk (4096 rays x 96
     samples), at the fast render's chunk (5120 rays x 32 samples), at the
     exact-shadow chunk (5120 points) and at a ragged row count, in bf16 and f32 with the polynomial and the exact sine, with
     BatchNorm statistics that are not trivial;
   - K1 and K2 at the flagship training shape (4096 rays x 96 samples,
     tile 2048, width 512, bf16, both sines), in f32 at a reduced row
     count, and at a 32-wide spec with tile 64 and a ragged tile count;
   - the bf16 GEMM inside K1 and K2 (TMA + wgmma) alone at the flagship's
     shapes (a 512 x 512 forward layer, the skip layer's PE half, an input
     gradient, a weight gradient) against the f32 product;
   - the polynomial sine's kernel at one SIREN layer of a flagship step
     (393,216 x 512, x in +-1e3), both directions, sine and cosine, f32
     and bf16, against the plain chain of ``ops/fast_math`` within
     SINE_TOL (a bf16 store: its own f32 value cast, bit for bit, and
     within the two casts of the plain chain's);
   - the training BatchNorm of a bf16 SineLayer (``ops/batchnorm_train``:
     the column sums, the folded sine both ways, dz) at a flagship step's
     393,216 x 512 and x 256 against its plain version, at the tolerances
     of ``tests/test_torch_batchnorm_cuda.py``, the column-sum and dz
     passes timed beside their bytes' bound, and the layer forward and
     backward beside the plain version's;
   - K3's f32 kernel also at width 768 (32-row tiles), and its nine layer
     products alone as cuBLAS f32 GEMMs (``torch.matmul``, TF32 off), a
     yardstick the port never calls;
   - K3 above the flagship's shapes: the bf16 kernel's wide instance at
     padded widths 640, 768 and 1024, the f32 kernel at 1024, and 11 and
     17 layers in both, at the flagship render chunk (timed, beside the
     bound) and a ragged row count, both sines, with ptxas's registers and
     spills of those instances; a 16 px frame of a 640-wide bf16 model on
     the card against the CPU; ``load_model_dir`` refusing a padded width
     of 1152 before any launch; the flagship times beside the parent's;
   and time the flagship cases with CUDA events beside the kernel's bound
   and its plain version (the GEMMs beside ``torch.matmul``'s bf16 time),
   K3 in bf16 and f32 also at the validation and fast render chunks (two
   launches there compared byte for byte), and in bf16 at the
   exact-shadow chunk also by its profiled device time a launch (there the
   wrapper's host time may exceed the kernel's); then, in one child
   process per degree with FAST_SIN_DEGREE set to 9 and to 7, build K3, K1
   and K2 at that degree (``nvcc`` seconds), hold K3 at the flagship render
   chunk and K1/K2 at the flagship training shape against their plain
   versions at that degree and time them beside degree 11's;
4. the serving main path: write a full-width model directory (``Config()``
   defaults, seeded random weights) with the port's own writer, load it
   onto the card, serve it over HTTP on an ephemeral localhost port and
   send a fixed set of ``/healthz``, ``/render`` and ``/dsm`` requests;
   check statuses, that every body decodes, that the launch counts of K3
   match the chunking, and that a small render agrees with the CPU path
   (plain versions) on the same model directory; then time 10 warm 128 px
   renders from one client and profile one (device time by kind, the
   device's idle share); then serve the same directory with
   ``fast_render=(32, 32)`` (``/render?size=128``, a 16 px exact-shadow
   frame, ``/dsm?size=128``; K3 twice a chunk), time 10 warm 128 px
   frames beside the exact ones, hold a 16 px frame against the CPU and
   profile one; then serve it as a legacy directory, its opts.json without
   ``compute_dtype`` and ``fast_sine``, so that it loads as float32 with
   ``sinf`` and every K3 launch is the f32 kernel (``/render?size=128``,
   ``/dsm?size=128``, a 16 px exact-shadow frame, 10 warm 128 px frames, a
   16 px frame against the CPU to 1e-3, one frame profiled); then a
   reference-format checkpoint made from the seed at the render cell's
   width, converted by ``tools/convert_reference_model`` into a legacy
   directory and served (10 warm 128 px frames, every K3 launch the f32
   kernel, a 16 px frame against the CPU); then ``tools/make_movie`` on the
   render cell's model (8 frames of 128 px, the default orbit: seconds a
   frame, K3 launches against frames x chunks, the GIF decoded back), a
   3-frame 16 px movie on the card against the CPU and ``pipeline=2``
   against ``pipeline=1`` byte for byte; then ``tools/export_render`` on
   the render cell's model, exact and with ``--fast_render 32 32``, and on
   its legacy float32 directory (no K3 launch while exporting), each
   program loaded with ``torch.export.load`` in a fresh process that
   imports ``season_nerf_torch`` and nothing of its tools, called on a
   flagship chunk (5,120 rays x 96 samples) and held against the live
   ``Renderer._full_chunk`` within 2e-5, K3 launched once a call exact and
   twice fast, the program's chunk time beside the live chunk's (CUDA
   events, in turns) and its size; then the data-parallel mesh
   (``parallel/mesh.py``) on the one card: the render cell's model on a
   render mesh of two replicas on the card (128 px, exact and fast, K3
   twice a chunk, four times fast) against one device, 3 flagship
   default-trunk steps on a training mesh of the card over NCCL at world
   size 1 and on two gloo ranks sharing the card (2048 rays each), each
   against the same steps with no mesh (every loss, the weights, the
   running statistics, the ranks' checksums, each rank's peak memory),
   and the refusals (``pallas_trunk`` on a mesh, ``cli.run_train`` with a
   ``mesh_shape`` above the cards);
5. the training main path: the flagship training config with
   ``pallas_trunk`` through ``Trainer`` on the synthetic site of
   ``bench.py`` in phase 1 (DSM prior on), one warm step and 20 timed
   ones; check finite losses, two K1 launches and one K2 launch a step,
   and that weights and running statistics moved; profile one step; write
   ``Final_Model.nn`` and render it through the serving loader; time 5
   steps of the default trunk (full-batch BatchNorm) for the record; train
   a small bf16 model 3 steps on the CPU and on the card from the same
   weights and draws and compare step 0's gradient of every leaf and the
   losses; then hierarchical sampling: the flagship config with
   ``n_importance=32`` on the default trunk, one warm step and 5 timed
   (K3 once a step: the coarse pass; the fold it rebuilds timed alone; one
   step profiled), ``pallas_trunk`` with it raising on the card, a small
   float32 model with ``n_importance`` on the CPU against the card; then
   the train cell on HSLuv ray colours (the rows against the host's
   float64 conversion, 4 steps through K1/K2 to a save point, its
   validation render in sRGB);
6. the validation path: ``cli.run_train`` with the flagship training
   config (``pallas_trunk``) on the synthetic site of ``bench.py``, 40
   steps, 4 save points, ``final_model_selection="best_geometry"``: at each
   save point the ``Testing`` losses and the validation report run the
   model in eval mode through K3, and ``run_train`` ends in the report;
   check finite ``Testing`` losses, ``Mean_PSNR``, ``Mean_Height_Error``
   and ``Prior_Height_Error`` at every save point, K3's launches against
   the chunking (2 for the losses and one per 4096-ray chunk of each
   held-out image, per save point, plus the final report), K1/K2's (2 and
   1 a step), that ``Final_Model.nn`` holds the save point of the lowest
   logged ``Prior_Height_Error`` and its weights; then repeat one save
   point's render on the CPU (plain versions) from its checkpoint; read
   the run's TensorBoard event file (every record's masked CRC-32C; as
   many scalar events as metrics.jsonl lines, a render and a height map
   of every held-out view per report); print
   the seconds spent in validation and in training (at this size a
   functional check, not the validation layer's metric: phase 7 gives
   that); then the run tools: ``quality_report``,
   ``select_best_geometry`` (its recomputed ``Prior_Height_Error`` of each
   save point against the value the run logged), ``time_to_quality`` and
   ``fast_render_ab`` on that run directory (functional: a 40-step model
   says nothing of quality), ``bench_serving_concurrent`` on the render
   cell's model at 1, 4 and 16 clients of 128 px (median, max, frames/s;
   K3's launches as the frames imply) and ``run_regions`` on one
   synthetic site at 4 flagship steps (``Full_Summary/``), each tool's
   launches counted from 0;
7. the real-site path: fabricate a DFC-format site from the seed (10
   GeoTIFFs of 2048 x 2048 px at 0.3 m with RPCs in tag 50844 and
   ``.ikono`` files, IMDs, a lidar DSM at 0.5 m with its UTM sidecar),
   ``cli.run_train`` on it with the flagship config (ingest, camera fits,
   the full-resolution ray table and its cache, the Space_Carve prior swept
   on the card at 2 x 2 x 0.25 m, the graph cut, one warm step through
   K1/K2, ``finalize`` and the validation report of the three held-out
   views at ``img_validation_downscale=8``), 5 timed steps, one step
   through ``Trainer.run`` that ends in a save point (the ``Testing``
   losses and the validation report, ``Mean_PSNR`` and
   ``Mean_Height_Error`` against the lidar DSM, timed: the validation
   layer's seconds per save point, projected onto the flagship schedule
   as a share of the run) and ``render_pretrained`` of the model directory
   through K3; check the launch counts, finite losses, the prior in
   [-1, 1], the world frame, the card's sweep against the CPU's on the
   site's first 4 z-slices, and that the carve recovers a synthetic
   surface;
   then evaluate the trained model directory at the JAX defaults
   (``analyze_model`` + ``write_analysis_outputs``: the 3 held-out views at
   256 x 256, 17 walk frames at 128 px, the density surface on the lidar
   DSM's grid) under the profiler: seconds by part, the device's busy
   share, K3's launches against the chunking, finite scores and every
   file of ``Output/``; then ``regional_eval`` of the same directory at
   the JAX ``quick`` sizes into ``Detailed_Output/`` (the site prepared
   once: not through ``eval_region``, whose ``eval_only`` ingests it
   again), once under the profiler: seconds by part, the device's busy
   share, K3's launches against the chunking, finite scores and every
   file;
8. print one ``{"kernels": [...]}`` line (K3, K1, K2 and the polynomial
   sine, their launches summed over the main paths, the exported
   programs', the render mesh's and the tools' included; the sine's counted
   on each main path alone, none on the two float32 directories' and some
   on every other, K3's f32 kernel with the legacy and the converted
   directories' and the float32 program's launches, and K3's wide bf16
   instance with the 640-wide frame's), then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--only f32`` builds K3 alone and runs only its float32 phases (the f32
kernel against its plain version and timed, the cuBLAS GEMMs, the legacy
directory served); ``--only k3`` builds K3 alone, times it at the flagship
render chunk in both dtypes and sines and, where the port has them, holds
the wider and deeper trunks.  Neither prints contract lines: run from an
unpacked copy of another commit, each compares two trees of the port in
one call.

Between 6 and 7, the evaluation path: ``cli.run_test`` on the synthetic
site of phase 6 (8 steps, 2 save points, ``best_geometry``, then
``Analysis.pickle`` and ``Output/`` at the JAX defaults and
``regional_eval`` into ``Detailed_Output/`` at the quick sizes),
``run_test(eval_only=True)`` on its directory and ``cli eval_region`` on
it (``Full_Summary/``), K3's launches against the chunking; then the
model's analysis, and its regional evaluation, on the card and on the CPU
(plain versions) at a small size: the image scores, the height scores,
the aligned time and the height shift, the shadow test's statistics, the
season walk's EM statistics and the prototype baseline held against each
other.  Before
phase 2, the host's scipy, cv2, imageio, tabulate, matplotlib, PIL and
tensorboard are looked up (``importlib.util.find_spec``); scipy must be there.

Exits non-zero, without the last line, when no CUDA device is visible or the
port is not beside this script.  Every measurement also goes, as JSON, to
``--json PATH`` (default ``build/chip_smoke.json`` beside this script).
"""

from __future__ import annotations

import copy
import io
import json
import os
import pickle
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from dataclasses import replace as dataclass_replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_JSON = os.path.join(ROOT, "build", "chip_smoke.json")

# H100 SXM published peaks (NVIDIA data sheet, dense), used for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP_N = 5120 * 96          # points in one flagship render chunk
VAL_N = 4096 * 96               # points in one validation render chunk
SHADOW_N = 5120                 # points in one exact-shadow chunk
SUN_ANGLE_N = 16 * 16 * 48      # the quick shadow test's points a sun angle
SURFACE_N = 4096 * 48           # the quick density surface's points a call
RAGGED_N = 4133                 # not a multiple of any tile
FAST_RENDER = (32, 32)          # --fast_render's qualified setting
FAST_N = 5120 * 32              # points of a fast render chunk's passes
SINE_SHAPE = (4096 * 96, 512)   # one SIREN layer's z in a flagship step
SINE_TOL = 2e-6                 # the sine's kernel against the plain chain
# the training BatchNorm's kernels against their plain version on the card
# (tests/test_torch_batchnorm_cuda.py derives each): y beyond the two casts'
# half steps; the running statistics, the scale's and shift's gradients and
# dz (beyond its casts) as shares of their largest
BN_WIDTHS = (512, 256)          # fc2..fc8 and fc9 of the flagship trunk
BN_Y_ATOL, BN_STATS_RTOL, BN_GRAD_RTOL = 3e-5, 2e-6, 2e-5
SEED = 0
STEADY_PATH = "/render?size=128"
STEADY_REQUESTS = 10
# profiled device time grouped by kind: the first kind whose marks occur
# in a kernel's name (lower case) takes it
KERNEL_KINDS = (("K3 trunk_infer", ("trunk_bf16", "trunk_f32")),
                ("K1+K2 trunk_train", ("tt::",)),
                ("GEMM", ("gemm", "cutlass", "nvjet")),
                ("copy/cast", ("copy",)),
                ("elementwise", ("elementwise",)))

# Kernel against plain version, max / mean absolute error on x_enc (values
# in [-1, 1]).  f32: the two differ only in the order of f32 accumulation
# (and, with the polynomial sine, in FMA contraction).  bf16: each layer
# rounds its activations to bf16 (ulp 2^-8 near 1), so an accumulation-order
# difference of ~1e-6 can flip one rounding, and the flip propagates through
# the later layers: the error grows with depth, to a few bf16 ulps at the
# flagship's nine layers (H100: max 5.0-5.5e-2, mean 6.6-7.5e-4 over 126 M
# values).
TOL = {torch.float32: (1e-3, 1e-5), torch.bfloat16: (1e-1, 2e-3)}
# a 16 px render on the card against the CPU path (plain versions) on the
# same model directory: bf16 colors and heights
RENDER_TOL = 5e-2
# the training main path: flagship steps timed after one warm step
TRAIN_STEPS = 20
DEFAULT_TRUNK_STEPS = 5
# 3 steps of a small bf16 model (width 256, 64 rays x 32 samples = one
# 2048-row tile) on the CPU (plain versions) and on the card (K1/K2) from the
# same weights and draws.  The two run the same bf16 arithmetic in other
# orders; a flipped bf16 rounding moves x_enc by up to 4e-2 (the K1
# tolerance above).  Each loss is held to 2e-3 relative (or 1e-3 absolute),
# 6x the worst reading (H100: 3.5e-4).  The losses say little about the
# backward: OneCycle starts at lr / 25 and Adam divides out the gradient's
# scale, so the weights barely move in 3 steps.  So step 0's gradient of
# every leaf is held too, its max abs difference over its own max
# |gradient|, to 3e-2: 2.5x the worst reading (H100: 1.2e-2 on
# fc3.norm.bias, median 4.6e-3 over 60 leaves).  A linear bias that feeds a
# BatchNorm has a zero gradient in exact arithmetic (the normalization
# subtracts it out), so both sides give rounding noise (H100: at most 1.9e-6
# of the layer's largest weight gradient); each side is held below 1e-4 of
# that instead.
CPU_CARD_STEPS = 3
CPU_CARD_RTOL, CPU_CARD_ATOL = 2e-3, 1e-3
CPU_CARD_GRAD_RTOL = 3e-2
BN_BIAS_NOISE = 1e-4


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# --- environment ------------------------------------------------------------
def import_port():
    """The port must come from this checkout, never from anywhere else."""
    sys.path.insert(0, ROOT)
    try:
        import season_nerf_torch
    except ImportError as e:
        fail(f"season_nerf_torch is not importable beside {__file__}: {e}")
    path = os.path.abspath(season_nerf_torch.__file__)
    if not path.startswith(os.path.join(ROOT, "season_nerf_torch") + os.sep):
        fail(f"season_nerf_torch comes from {path}, not from {ROOT}")
    for banned in ("jax", "flax", "season_nerf_tpu"):
        if banned in sys.modules:
            fail(f"{banned} was imported")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# --- the model --------------------------------------------------------------
def calibrate_bn_(gnerf, n_points: int = 4096, seed: int = SEED):
    """Give every trunk BatchNorm statistics that are not trivial
    (:func:`calibrate_layers_` of the model's trunk)."""
    from season_nerf_torch.ops.fused_trunk import trunk_layers
    calibrate_layers_(trunk_layers(gnerf), n_points, seed)


@torch.no_grad()
def calibrate_layers_(layers, n_points: int = 4096, seed: int = SEED):
    """The BatchNorms of a trunk given as [(SineLayer, input kind)]: the
    running mean and (biased) variance of the layer's own pre-activation
    over random points in the cube, and a scale and shift drawn around 1
    and 0.  Runs in f32; the layers lie on the CPU."""
    from season_nerf_torch.models.encodings import positional_encode
    from season_nerf_torch.ops.fused_trunk import PE_FREQS
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand(n_points, 3, generator=gen) * 2 - 1
    pe = positional_encode(pts, PE_FREQS)
    h = None
    for layer, kind in layers:
        x = (pe if kind == "pe" else torch.cat([h, pe], 1)
             if kind == "h+pe" else h)
        z = layer.omega_0 * (x @ layer.linear.weight.t() + layer.linear.bias)
        if layer.norm is not None:
            n = layer.norm
            n.running_mean.copy_(z.mean(0))
            n.running_var.copy_(z.var(0, unbiased=False))
            n.weight.copy_(torch.rand(n.weight.shape, generator=gen) + 0.5)
            n.bias.copy_(0.2 * torch.randn(n.bias.shape, generator=gen))
            z = layer.bn_eval(z)
        h = torch.sin(z)


def make_model(cfg, seed=SEED):
    """A seeded full-width model on the CPU, BN statistics calibrated."""
    from season_nerf_torch.models.tnerf import model_from_config
    torch.manual_seed(seed)
    model = model_from_config(cfg)
    calibrate_bn_(model.G_NeRF_net, seed=seed)
    return model


def deep_trunk_layers(width: int, fc_layers: int, seed: int = SEED):
    """A seeded trunk shaped as GNeRF's would be at ``fc_layers`` above 8:
    fc1 from the PE, BatchNorm on every later layer, the PE concatenated
    back in at fc_layers // 2 + 1, a half-width last layer; SIREN init,
    statistics calibrated; as [(SineLayer, input kind)] for
    ``fused_trunk.fold_layers``.  Neither package builds such a model (at
    fc_layers 9 and above a trunk layer would take the name fc9 of the
    half-width layer), so K3's deeper plans are held on these alone."""
    from season_nerf_torch.models.siren import SineLayer
    from season_nerf_torch.models.tnerf import _siren_init_
    from season_nerf_torch.ops.fused_trunk import PE_DIM
    torch.manual_seed(seed)
    skip = fc_layers // 2 + 1
    layers = []
    for i in range(1, fc_layers + 1):
        kind = "pe" if i == 1 else "h+pe" if i == skip else "h"
        fan = {"pe": PE_DIM, "h": width, "h+pe": width + PE_DIM}[kind]
        layers.append((_siren_init_(SineLayer(fan, width, use_norm=i > 1),
                                    i == 1), kind))
    layers.append((_siren_init_(SineLayer(width, max(width // 2, 1),
                                          use_norm=True), False), "h"))
    calibrate_layers_(layers, seed=seed)
    return layers


def trunk_macs(gnerf) -> int:
    """Multiply-adds per point of the trunk, without the padding."""
    from season_nerf_torch.ops.fused_trunk import trunk_layers
    return sum(layer.linear.in_features * layer.linear.out_features
               for layer, _ in trunk_layers(gnerf))


# --- phase 3: kernels against their plain versions --------------------------
TRUNK_NS = (FLAGSHIP_N, VAL_N, FAST_N, SURFACE_N, SUN_ANGLE_N, SHADOW_N,
            RAGGED_N)


def check_trunk(model, device, dtypes=(torch.bfloat16, torch.float32),
                sines=(True, False), ns=TRUNK_NS) -> dict:
    """K3 against its plain version at every row count of ``ns``, in each
    of ``dtypes`` with each sine of ``sines``; timed at the flagship render
    chunk and at the validation and fast render chunks, in bf16 also (with
    the profiler too) at the exact-shadow chunk; two launches at the
    validation chunk compared byte for byte."""
    from season_nerf_torch.ops import fused_trunk as ft
    g = model.G_NeRF_net
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = {}
    macs = trunk_macs(g)
    for dtype in dtypes:
        folded = ft.fold_trunk(g, dtype=dtype, device=device)
        for fast_sine in sines:
            name = (f"trunk_infer[{str(dtype).split('.')[-1]},"
                    f"{'fast_sin' if fast_sine else 'sinf'}]")
            for n in ns:
                pts = torch.rand(n, 3, generator=gen, device=device) * 2 - 1
                pe = ft.encode_points(pts).contiguous()
                got = ft.trunk_apply(pe, folded, fast_sine)
                want = ft.trunk_apply_reference(pe, folded, fast_sine)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"{name} N={n}: shape {tuple(got.shape)} or "
                         f"non-finite output")
                err = (got - want).abs()
                max_err, mean_err = float(err.max()), float(err.mean())
                tol_max, tol_mean = TOL[dtype]
                rec = {"n": n, "max_abs_err": max_err,
                       "mean_abs_err": mean_err, "tol_max": tol_max,
                       "tol_mean": tol_mean}
                if n == VAL_N:
                    # two launches on the same input give the same bytes
                    rec["repeat_equal"] = bool(torch.equal(
                        got, ft.trunk_apply(pe, folded, fast_sine)))
                    if not rec["repeat_equal"]:
                        fail(f"{name} N={n}: two launches differ")
                if n == SHADOW_N and dtype == torch.bfloat16:
                    run = lambda: ft.trunk_apply(pe, folded, fast_sine)
                    rec["ms"] = cuda_ms(run, 50)
                    rec["device_ms"] = device_ms(run, 50, "trunk_bf16")
                    rec["plain_ms"] = cuda_ms(
                        lambda: ft.trunk_apply_reference(pe, folded,
                                                         fast_sine), 5)
                    rec["bound_ms"] = (2.0 * macs * n / PEAK_BF16_FLOPS
                                       * 1e3)
                    rec["bound_by"] = "operations"
                if n in (FLAGSHIP_N, VAL_N, FAST_N):
                    reps = 10 if dtype == torch.bfloat16 else 5
                    rec["ms"] = cuda_ms(
                        lambda: ft.trunk_apply(pe, folded, fast_sine), reps)
                    rec["plain_ms"] = cuda_ms(
                        lambda: ft.trunk_apply_reference(pe, folded,
                                                         fast_sine), 2)
                    flops = 2.0 * macs * n
                    nbytes = (pe.numel() * 4 + got.numel() * 4
                              + sum(t.numel() * t.element_size()
                                    for t in folded.weights + folded.biases))
                    peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                            else PEAK_F32_FLOPS)
                    t_ops = flops / peak * 1e3
                    t_bytes = nbytes / PEAK_BYTES * 1e3
                    rec.update(flops=flops, bytes=nbytes,
                               bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes
                               else "bytes")
                log(f"  {name} N={n}: max_abs_err {max_err:.3e} "
                    f"(tol {tol_max:g}), mean_abs_err {mean_err:.3e} "
                    f"(tol {tol_mean:g})"
                    + (f", kernel {rec['ms']:.4f} ms, plain "
                       f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f}"
                       f" ms ({rec['bound_by']})" if "ms" in rec else "")
                    + (f", device {rec['device_ms']:.4f} ms a launch "
                       f"(profiler)" if rec.get("device_ms") is not None
                       else ""))
                results.setdefault(name, []).append(rec)
                if max_err > tol_max or mean_err > tol_mean:
                    fail(f"{name} N={n} disagrees with its plain version")
                del got, want, pe, pts
        del folded
    return results


# (width, depth, dtypes): narrow, shallow trunks in both kernels, and the
# f32 kernel's widest (768: 32-row tiles, where the bf16 kernel stops at 512)
SMALL_TRUNKS = ((32, 2, (torch.bfloat16, torch.float32)),
                (128, 4, (torch.bfloat16, torch.float32)),
                (96, 7, (torch.bfloat16, torch.float32)),
                (768, 8, (torch.float32,)))


def check_trunk_small_widths(device, trunks=SMALL_TRUNKS):
    """Every depth and width the model builds goes through the same kernel:
    narrow, shallow trunks and the f32 kernel's widest at a ragged row
    count."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import fused_trunk as ft
    for width, depth, dtypes in trunks:
        model = make_model(Config(fc_units=width, fc_layers=depth)).to(device)
        gen = torch.Generator(device=device).manual_seed(SEED + width)
        pe = ft.encode_points(torch.rand(RAGGED_N, 3, generator=gen,
                                         device=device) * 2 - 1)
        for dtype in dtypes:
            folded = ft.fold_trunk(model.G_NeRF_net, dtype=dtype)
            for fast_sine in (True, False):
                got = ft.trunk_apply(pe, folded, fast_sine)
                want = ft.trunk_apply_reference(pe, folded, fast_sine)
                err = float((got - want).abs().max())
                log(f"  width {width} depth {depth} {dtype} "
                    f"fast_sine={fast_sine}: max_abs_err {err:.3e}")
                if err > TOL[dtype][0]:
                    fail(f"trunk width {width} depth {depth} {dtype} "
                         f"fast_sine={fast_sine}: {err}")


# K3 at the shapes above the flagship's: (label, width, fc_layers, dtypes).
# The bf16 kernel's wide instance (the cluster's two CTAs share a tile and
# split its columns) at padded widths 640, 768 and 1024, the f32 kernel's
# widest (four rows of W'^T a ring slot), and trunks deeper than any model
# builds (deep_trunk_layers: 11 and 17 kernel layers) in both kernels.
WIDE_TRUNKS = (("bf16-640", 640, 8, (torch.bfloat16,)),
               ("bf16-768", 768, 8, (torch.bfloat16,)),
               ("bf16-1024", 1024, 8, (torch.bfloat16,)),
               ("f32-1024", 1024, 8, (torch.float32,)),
               ("deep-10", 512, 10, (torch.bfloat16, torch.float32)),
               ("deep-16", 512, 16, (torch.bfloat16, torch.float32)))
WIDE_NS = (FLAGSHIP_N, RAGGED_N)
# K3 at the flagship render chunk before the wider and deeper shapes, as
# PERF.md's kernel table records it (NVIDIA H100 80GB HBM3, 700.00 W); a
# comparison that counts runs the parent's tree in the same call
PARENT_K3_MS = {"trunk_infer[bfloat16,fast_sin]": 5.370,
                "trunk_infer[float32,fast_sin]": 45.81,
                "trunk_infer[float32,sinf]": 52.49}


# Deeper than the flagship, a trunk's output moves with the summation order
# alone by more than at nine layers, where TOL was set: each layer amplifies
# the rounding of its input (H100, 17 layers: the kernel against the plain
# version, bf16 max 0.30 and mean 5.9e-3, f32 mean 1.2e-5, growing ~1.5-1.7x
# every two layers from nine on).  What the order alone moves a trunk is
# probed by the plain version summing each layer in float64 against the
# plain version (:func:`order_moves`); at the wider and deeper trunks TOL is
# scaled by how much more that moves the trunk than the flagship's on the
# same points (:func:`order_tolerance`, never below TOL).


def order_moves(pe, folded, fast_sine, want) -> tuple:
    """(max, mean) |plain version summing in float64 - ``want``|, where
    ``want`` is the plain version's output on ``pe``."""
    from season_nerf_torch.ops import fused_trunk as ft
    d = (ft.trunk_apply_reference(pe, folded, fast_sine, torch.float64)
         - want).abs()
    return float(d.max()), float(d.mean())


def order_tolerance(order, flagship_order, dtype) -> tuple:
    """TOL[dtype] scaled by ``order`` / ``flagship_order`` (max, mean;
    :func:`order_moves` of a trunk and of the flagship's), never below."""
    tol_max, tol_mean = TOL[dtype]
    return (tol_max * max(1.0, order[0] / flagship_order[0]),
            tol_mean * max(1.0, order[1] / flagship_order[1]))


def wide_trunk_layers(width: int, fc_layers: int):
    """The trunk of a seeded model at ``width`` (BatchNorm calibrated), or
    :func:`deep_trunk_layers` above the depth a model builds."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops.fused_trunk import trunk_layers
    if fc_layers > 8:
        return deep_trunk_layers(width, fc_layers)
    return trunk_layers(make_model(Config(fc_units=width,
                                          fc_layers=fc_layers)).G_NeRF_net)


def check_trunk_wide(device, trunks=WIDE_TRUNKS, ns=WIDE_NS) -> dict:
    """K3 against its plain version at the wider and deeper trunks of
    ``trunks``, at each row count of ``ns`` with both sines, held to
    :func:`order_tolerance` (against the flagship trunk's order moves on
    the same points);
    timed at the flagship render chunk (CUDA events) beside its bound
    (operations at the dtype's peak, or the bytes) and its plain version.
    A launch of one row (in bf16 a cluster's one live tile; the wide
    instance's two CTAs on one tile) gives, byte for byte, that point's row
    of a launch of ``ns[-1]`` rows: a row's sums do not depend on the other
    rows, and a mean error over one row says nothing at TOL's scale."""
    from season_nerf_torch.ops import fused_trunk as ft
    results = {}
    flagship_layers = wide_trunk_layers(512, 8)
    flagship_order = {}         # (dtype, fast_sine, n) -> order_moves

    def points(n):
        gen = torch.Generator(device=device).manual_seed(SEED + n)
        return ft.encode_points(torch.rand(n, 3, generator=gen,
                                           device=device) * 2 - 1)

    def flagship(dtype, fast_sine, n):
        key = (dtype, fast_sine, n)
        if key not in flagship_order:
            f = ft.fold_layers(flagship_layers, dtype, device)
            pe = points(n)
            flagship_order[key] = order_moves(
                pe, f, fast_sine, ft.trunk_apply_reference(pe, f, fast_sine))
        return flagship_order[key]

    for label, width, fc_layers, dtypes in trunks:
        layers = wide_trunk_layers(width, fc_layers)
        macs = sum(layer.linear.in_features * layer.linear.out_features
                   for layer, _ in layers)
        for dtype in dtypes:
            folded = ft.fold_layers(layers, dtype, device)
            bf16 = dtype == torch.bfloat16
            for fast_sine in (True, False):
                name = (f"{label}[{'bfloat16' if bf16 else 'float32'},"
                        f"{'fast_sin' if fast_sine else 'sinf'}]")
                for n in ns:
                    pe = points(n)
                    got = ft.trunk_apply(pe, folded, fast_sine)
                    want = ft.trunk_apply_reference(pe, folded, fast_sine)
                    torch.cuda.synchronize()
                    if got.shape != want.shape or \
                            not torch.isfinite(got).all():
                        fail(f"{name} N={n}: shape {tuple(got.shape)} or "
                             f"non-finite output")
                    err = (got - want).abs()
                    order = order_moves(pe, folded, fast_sine, want)
                    flag = flagship(dtype, fast_sine, n)
                    tol_max, tol_mean = order_tolerance(order, flag, dtype)
                    rec = {"n": n, "width_pad": folded.width_pad,
                           "layers": len(folded.weights),
                           "max_abs_err": float(err.max()),
                           "mean_abs_err": float(err.mean()),
                           "order": order, "flagship_order": flag,
                           "tol_max": tol_max, "tol_mean": tol_mean}
                    if n == FLAGSHIP_N:
                        rec["repeat_equal"] = bool(torch.equal(
                            got, ft.trunk_apply(pe, folded, fast_sine)))
                        rec["ms"] = cuda_ms(
                            lambda: ft.trunk_apply(pe, folded, fast_sine),
                            5 if bf16 else 3)
                        rec["plain_ms"] = cuda_ms(
                            lambda: ft.trunk_apply_reference(pe, folded,
                                                             fast_sine), 1)
                        flops = 2.0 * macs * n
                        nbytes = (pe.numel() * 4 + got.numel() * 4
                                  + sum(t.numel() * t.element_size()
                                        for t in folded.weights
                                        + folded.biases))
                        t_ops = flops / (PEAK_BF16_FLOPS if bf16
                                         else PEAK_F32_FLOPS) * 1e3
                        t_bytes = nbytes / PEAK_BYTES * 1e3
                        rec.update(flops=flops, bytes=nbytes,
                                   bound_ms=max(t_ops, t_bytes),
                                   bound_by="operations" if t_ops >= t_bytes
                                   else "bytes")
                    log(f"  {name} N={n}: max_abs_err "
                        f"{rec['max_abs_err']:.3e} (tol {tol_max:.3g}), "
                        f"mean {rec['mean_abs_err']:.3e} (tol "
                        f"{tol_mean:.3g}); the order alone moves it "
                        f"{order[0]:.3e} / {order[1]:.3e}, the flagship's "
                        f"{flag[0]:.3e} / {flag[1]:.3e}"
                        + (f", kernel {rec['ms']:.4f} ms, plain "
                           f"{rec['plain_ms']:.3f} ms, bound "
                           f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                           f"repeat equal {rec['repeat_equal']}"
                           if "ms" in rec else ""))
                    results.setdefault(name, []).append(rec)
                    if rec["max_abs_err"] > tol_max \
                            or rec["mean_abs_err"] > tol_mean:
                        fail(f"{name} N={n} disagrees with its plain version")
                    if not rec.get("repeat_equal", True):
                        fail(f"{name} N={n}: two launches differ")
                    if n == ns[-1]:
                        one = ft.trunk_apply(pe[:1].contiguous(), folded,
                                             fast_sine)
                        rec["one_row_equal"] = bool(torch.equal(one,
                                                                got[:1]))
                        if not rec["one_row_equal"]:
                            fail(f"{name}: a launch of one row differs from "
                                 f"its row of a launch of {n}")
                    del got, want, pe, err
            del folded
        torch.cuda.empty_cache()
    return results


def f32_layer_gemms(model, device, ns=(FLAGSHIP_N, VAL_N, FAST_N)) -> dict:
    """A per-layer cuBLAS yardstick for K3's f32 kernel: each layer's
    product alone, ``torch.matmul`` in full f32 (``allow_tf32`` False) of
    an [N, k_pad] input and W'^T [k_pad, n_pad] into a preallocated output,
    at each row count of ``ns`` (CUDA events, 5 calls), beside the
    operations' bound at 67 TFLOP/s.  The port never calls it; it has no
    bias, sine or skip and writes every layer's output to device memory."""
    from season_nerf_torch.ops import fused_trunk as ft
    torch.backends.cuda.matmul.allow_tf32 = False
    folded = ft.fold_trunk(model.G_NeRF_net, dtype=torch.float32,
                           device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    results = {}
    for n in ns:
        layers = []
        for w in folded.weights:
            n_out, k = w.shape
            x = torch.rand(n, k, generator=gen, device=device) * 2 - 1
            wt, out = w.t().contiguous(), torch.empty(n, n_out, device=device)
            ms = cuda_ms(lambda: torch.matmul(x, wt, out=out), 5)
            flops = 2.0 * n * k * n_out
            layers.append({"k": k, "n": n_out, "ms": ms,
                           "tflops": flops / ms / 1e9,
                           "bound_ms": flops / PEAK_F32_FLOPS * 1e3})
            del x, wt, out
        total = sum(r["ms"] for r in layers)
        results[n] = {"layers": layers, "ms": total,
                      "bound_ms": sum(r["bound_ms"] for r in layers)}
        log(f"  cuBLAS f32 layer GEMMs alone, N={n}: {total:.3f} ms in all "
            f"(bound {results[n]['bound_ms']:.3f} ms); per layer (ms, "
            f"TFLOP/s): " + ", ".join(f"{r['k']}x{r['n']} {r['ms']:.3f} "
                                      f"{r['tflops']:.1f}" for r in layers))
        torch.cuda.empty_cache()
    return results


# --- K1 and K2 against their plain versions ----------------------------------
# K1 (x_enc in [-1, 1]): the K3 tolerances above, for the same reason: an
# f32 accumulation-order difference can flip one bf16 rounding of an
# activation and the flip propagates through the later layers.  The heads
# and the statistics sums are held relative to their largest magnitude.
# K2: each gradient's max error relative to its max |value|, or to 1 where
# that is smaller: the bias gradient of a BN layer is zero up to rounding
# (the tile's dz sums to zero), so only its absolute error means anything,
# as in tests/test_pallas_train.py.  bf16: the
# forward recompute flips bf16 roundings as K1 does, and the gradient
# products take bf16 operands (dz, the activations), so a few per cent of
# the largest value; f32: accumulation order over up to 393,216 rows.
K1_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
K2_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
TRAIN_N = 4096 * 96             # flagship points per training step
TRAIN_F32_N = 16 * 2048         # the f32 check, reduced


def train_params(spec, seed):
    """Kernel params for ``spec`` at the scale of a SIREN trunk with omega
    folded in (weights U(+-sqrt(6 / fan_in))), BN scale and shift around 1
    and 0, and the heads' four zero columns."""
    from season_nerf_torch.ops import fused_train as ftr
    rng = np.random.default_rng(seed)
    packed = []
    for i in range(spec.n_layers):
        fan, w = spec.in_dims[i], spec.widths[i]
        packed.append(rng.uniform(-1, 1, (fan, w)) * np.sqrt(6.0 / fan))
        packed.append(rng.uniform(-1, 1, (1, w)))
        if spec.has_bn[i]:
            packed.append(1.0 + 0.1 * rng.standard_normal((1, w)))
            packed.append(0.1 * rng.standard_normal((1, w)))
    wh = rng.uniform(-1, 1, (spec.enc_width, ftr.HEAD_PAD)) / 4.0
    wh[:, 4:] = 0.0
    packed += [wh, 0.1 * rng.standard_normal((1, ftr.HEAD_PAD))]
    return ftr.kernel_params(spec, [torch.tensor(p, dtype=torch.float32)
                                    for p in packed])


def train_flops(spec, n):
    """(K1, K2) operations: 2 x multiply-adds over the trunk without its
    padding and the four real head columns.  K2 = its forward recompute +
    every dW + every da (none below the first layer; the skip layer's h
    rows only)."""
    pe = 63 if spec.pe_dim == 64 else spec.pe_dim     # the PE's real width
    fwd = da = spec.enc_width * 4
    for i, w in enumerate(spec.widths):
        fwd += w * (pe if i == 0 else spec.widths[i - 1]
                    + (pe if spec.is_skip(i) else 0))
        da += w * spec.widths[i - 1] if i > 0 else 0
    return 2.0 * n * fwd, 2.0 * n * (2 * fwd + da)


def design_floor_bytes(spec, n, act_bytes, grad_bytes):
    """(K1, K2) bytes the layer-major design itself moves through HBM, at
    the least: per layer its input activation read, f32 z written and read
    back for the tile statistics, and its activation written; K2 adds per
    layer its kept f32 zh and the f32 input gradient read, dz written and
    read twice (dW, da), the input activation read again and the f32 input
    gradient written.  What a design that keeps a tile on chip removes."""
    k1 = k2 = 0
    for k, w in zip(spec.in_dims, spec.widths):
        fwd = n * (k * act_bytes + 2 * 4 * w + w * act_bytes)
        k1 += fwd
        k2 += fwd + n * (2 * 4 * w + 3 * grad_bytes * w + k * act_bytes
                         + 4 * k)
    return k1, k2


def check_train_kernels(device, only=None) -> dict:
    """K1 and K2 against trunk_fwd_reference / trunk_bwd_reference: at the
    flagship training shape (N = 393,216, tile 2048, width 512, bf16, with
    the polynomial and the exact sine), in f32 at a reduced N, and at a
    32-wide spec with tile 64 and a ragged tile count (37 tiles); ``only``
    names a subset of the cases.  Times the flagship bf16 case (polynomial
    sine) beside its bound."""
    from season_nerf_torch.ops import fused_train as ftr
    flag = ftr.TrunkSpec()
    small = dict(widths=(32, 32, 32, 16), skip_idx=2, pe_dim=16, tile=64)
    cases = [("flagship,bf16,fast_sin", flag, TRAIN_N),
             ("flagship,bf16,sinf", dataclass_replace(flag, fast_sine=False),
              TRAIN_N),
             ("flagship,f32,fast_sin",
              dataclass_replace(flag, act_dtype="float32",
                                grad_dtype="float32"), TRAIN_F32_N),
             ("w32,tile64,bf16", ftr.TrunkSpec(**small), 64 * 37),
             ("w32,tile64,f32", ftr.TrunkSpec(**small, act_dtype="float32",
                                             grad_dtype="float32"), 64 * 37)]
    results = {}
    for case, spec, n in cases:
        if only is not None and case not in only:
            continue
        dt = ftr._DTYPES[spec.act_dtype]
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        if spec.pe_dim == ftr.PE_PAD:
            pe = ftr.encode_pe(torch.rand(n, 3, generator=gen,
                                          device=device) * 2 - 1)
        else:
            pe = (torch.rand(n, spec.pe_dim, generator=gen, device=device)
                  * 2 - 1).to(torch.bfloat16)
        params = [p.to(device) for p in train_params(spec, SEED)]
        got = ftr.trunk_fwd(spec, pe, params)
        want = ftr.trunk_fwd_reference(spec, pe, params)
        torch.cuda.synchronize()
        rec = {"n": n, "tile": spec.tile, "widths": list(spec.widths)}
        err = (got[0].float() - want[0].float()).abs()
        rec["xenc_max_abs_err"] = float(err.max())
        rec["xenc_mean_abs_err"] = float(err.mean())
        for k, name in ((1, "heads"), (2, "stats")):
            rec[f"{name}_rel_err"] = float(
                (got[k] - want[k]).abs().max() / want[k].abs().max())
        rec["k1_max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                    for g, w in zip(got, want))
        ok = all(torch.isfinite(t.float()).all() for t in got)
        tol_max, tol_mean = TOL[dt]
        bad = (not ok or rec["xenc_max_abs_err"] > tol_max
               or rec["xenc_mean_abs_err"] > tol_mean
               or rec["heads_rel_err"] > K1_REL_TOL[dt]
               or rec["stats_rel_err"] > K1_REL_TOL[dt])
        log(f"  K1 {case} N={n}: x_enc max {rec['xenc_max_abs_err']:.3e} "
            f"mean {rec['xenc_mean_abs_err']:.3e} (tol {tol_max:g}/"
            f"{tol_mean:g}), heads rel {rec['heads_rel_err']:.3e}, stats "
            f"rel {rec['stats_rel_err']:.3e} (tol {K1_REL_TOL[dt]:g})")
        if bad:
            fail(f"K1 {case} disagrees with trunk_fwd_reference: {rec}")
        del got, want
        gd = ftr._DTYPES[spec.grad_dtype]
        d_xenc = (0.1 * torch.randn(n, spec.enc_width, generator=gen,
                                    device=device)).to(gd)
        d_heads = 0.1 * torch.randn(n, ftr.HEAD_PAD, generator=gen,
                                    device=device)
        got = ftr.trunk_bwd(spec, pe, params, d_xenc, d_heads)
        want = ftr.trunk_bwd_reference(spec, pe, params, d_xenc, d_heads)
        torch.cuda.synchronize()
        rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
               for a, b in zip(got, want)]
        finite = all(torch.isfinite(a).all() for a in got)
        rec["grad_rel_errs"] = rel
        rec["grad_max_rel_err"] = max(rel)
        rec["k2_max_abs_err"] = max(float((a - b).abs().max())
                                    for a, b in zip(got, want))
        log(f"  K2 {case} N={n}: max gradient error {max(rel):.3e} of its "
            f"max |value| (tol {K2_REL_TOL[gd]:g}), max abs "
            f"{rec['k2_max_abs_err']:.3e}")
        if not finite or max(rel) > K2_REL_TOL[gd]:
            fail(f"K2 {case} disagrees with trunk_bwd_reference: {rel}")
        del got, want
        if case == "flagship,bf16,fast_sin":
            f1, f2 = train_flops(spec, n)
            nbytes1 = (pe.numel() * 2 + n * spec.enc_width * dt.itemsize
                       + n * ftr.HEAD_PAD * 4 + sum(
                           p.numel() * p.element_size() for p in params))
            nbytes2 = (pe.numel() * 2 + d_xenc.numel() * d_xenc.element_size()
                       + d_heads.numel() * 4
                       + 2 * sum(p.numel() * 4 for p in params))
            floor1, floor2 = design_floor_bytes(spec, n, dt.itemsize,
                                                gd.itemsize)
            for name, fn, plain, flops, nb, floor in (
                    ("k1", lambda: ftr.trunk_fwd(spec, pe, params),
                     lambda: ftr.trunk_fwd_reference(spec, pe, params),
                     f1, nbytes1, floor1),
                    ("k2", lambda: ftr.trunk_bwd(spec, pe, params, d_xenc,
                                                 d_heads),
                     lambda: ftr.trunk_bwd_reference(spec, pe, params,
                                                     d_xenc, d_heads),
                     f2, nbytes2, floor2)):
                t_ops = flops / PEAK_BF16_FLOPS * 1e3
                t_bytes = nb / PEAK_BYTES * 1e3
                rec[f"{name}_ms"] = cuda_ms(fn, 5)
                rec[f"{name}_plain_ms"] = cuda_ms(plain, 2)
                rec[f"{name}_bound_ms"] = max(t_ops, t_bytes)
                rec[f"{name}_bound_by"] = ("operations" if t_ops >= t_bytes
                                           else "bytes")
                rec[f"{name}_flops"] = flops
                rec[f"{name}_bytes"] = nb
                rec[f"{name}_design_floor_ms"] = floor / PEAK_BYTES * 1e3
                log(f"  {name.upper()} {case}: kernel {rec[name + '_ms']:.3f}"
                    f" ms, plain {rec[name + '_plain_ms']:.3f} ms, bound "
                    f"{rec[name + '_bound_ms']:.3f} ms "
                    f"({rec[name + '_bound_by']}), the layer-major design's "
                    f"own HBM floor {rec[name + '_design_floor_ms']:.3f} ms")
        results[case] = rec
        del pe, params, d_xenc, d_heads
        torch.cuda.empty_cache()
    return results


# --- the bf16 GEMM inside K1 and K2 -------------------------------------------
# Against torch.matmul in f32 on the same bf16 operands: the products are
# exact in f32 on both sides and only the order of the f32 sums differs.
# Each element's error is held against sum_k |a_mk| |b_kn| (+ |c| + |bias|)
# there, at most 1e-4.  Rounding gives about sqrt(L) x 2^-24 of it for a
# chain of L sums (under 1e-5 for the 23,168-row splits of the flagship's
# weight gradient); a transposed or wrongly swizzled read gives errors of
# order 1, and one 64-deep K step missed or read twice 64 / K (1.6e-4 at
# the flagship's 393,216 rows).
GEMM_REL_TOL = 1e-4
# the GEMMs of a flagship training step (393,216 points, width 512):
# (name, layout, M, N, K, bias, accumulate, split)
GEMM_CASES = (
    ("forward 512x512", "fwd", TRAIN_N, 512, 512, True, False, False),
    ("skip layer, PE half", "fwd", TRAIN_N, 512, 64, True, True, False),
    ("input gradient", "dgrad", TRAIN_N, 512, 512, False, False, False),
    ("weight gradient", "wgrad", 512, 512, TRAIN_N, False, False, True),
)


def gemm_case(layout, m, n, k, device, seed):
    """Stored bf16 operands of an M x N x K product in ``layout`` (see
    ``fused_train.GEMM_LAYOUTS``), uniform in [-0.5, 1): not symmetric about
    0, so that the sums do not cancel and a misread tile shows; then an f32
    bias [N] and an f32 C [M, N] drawn the same way."""
    from season_nerf_torch.ops import fused_train as ftr
    gen = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: (torch.rand(*shape, generator=gen, device=device)
                        * 1.5 - 0.5)
    A, B = u(m, k).to(torch.bfloat16), u(k, n).to(torch.bfloat16)
    a_kc, b_kc = ftr.GEMM_LAYOUTS[layout]
    a = A if a_kc else A.t().contiguous()
    b = B.t().contiguous() if b_kc else B
    return a, b, u(n), u(m, n)


def gemm_rel_err(got, a, b, layout, bias=None, c=None) -> float:
    """max over elements of |got - the f32 product| / (|A| . |B| + |c| +
    |bias|), the f32 product from ``fused_train.gemm_reference``."""
    from season_nerf_torch.ops import fused_train as ftr
    A, B = ftr.gemm_operands(a, b, layout)
    want = ftr.gemm_reference(a, b, layout, bias, c)
    scale = A.float().abs() @ B.float().abs()
    if c is not None:
        scale += c.abs()
    if bias is not None:
        scale += bias.abs()
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


def check_gemms(device) -> dict:
    """The bf16 GEMM of K1 and K2 (TMA + wgmma) alone at the flagship
    training shapes: its error against the f32 product, its time (CUDA
    events, 10 calls), TFLOP/s, its own bound (operations against bytes:
    each operand read once, the f32 C written once and, when it
    accumulates, read once) and, as a yardstick only, ``torch.matmul`` on
    the same bf16 operands (cuBLAS; it writes bf16, half the output bytes,
    and the port never calls it)."""
    from season_nerf_torch.ops import fused_train as ftr
    results = {}
    for i, (name, layout, m, n, k, bias, acc, split) in enumerate(GEMM_CASES):
        a, b, bias_t, c = gemm_case(layout, m, n, k, device, SEED + 20 + i)
        bias_t = bias_t if bias else None
        c = c if acc else None
        run = lambda out=None: ftr.gemm_bf16(a, b, layout, bias=bias_t,
                                              c=out, split=split)
        got = run(None if c is None else c.clone())
        torch.cuda.synchronize()
        err = gemm_rel_err(got, a, b, layout, bias_t, c)
        finite = bool(torch.isfinite(got).all())
        del got
        target = None if c is None else c.clone()
        ms = cuda_ms(lambda: run(target), 10)
        A, B = ftr.gemm_operands(a, b, layout)
        library_ms = cuda_ms(lambda: torch.matmul(A, B), 10)
        flops = 2.0 * m * n * k
        nbytes = (a.numel() + b.numel()) * 2 + m * n * 4 * (2 if acc else 1) \
            + (n * 4 if bias else 0)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rec = {"layout": layout, "m": m, "n": n, "k": k, "bias": bias,
               "accumulate": acc, "split": split, "rel_err": err,
               "tol": GEMM_REL_TOL, "ms": ms, "tflops": flops / ms / 1e9,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "cublas_bf16_ms": library_ms}
        rec["share_of_bound"] = rec["bound_ms"] / ms
        log(f"  GEMM {name} ({layout}, {m} x {n} x {k}): error "
            f"{err:.3e} (tol {GEMM_REL_TOL:g}), {ms:.4f} ms, "
            f"{rec['tflops']:.1f} TFLOP/s, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {100 * rec['share_of_bound']:.1f} % of "
            f"it), torch.matmul bf16 {library_ms:.4f} ms")
        results[name] = rec
        if not finite or err > GEMM_REL_TOL:
            fail(f"GEMM {name} disagrees with the f32 product: {rec}")
        del a, b, A, B, c, target, bias_t
        torch.cuda.empty_cache()
    return results


# --- phase 4: the main path -------------------------------------------------
def decode_png(body: bytes) -> np.ndarray:
    """8-bit gray/RGB/RGBA PNG with unfiltered scanlines (what the port's
    encoder writes) -> uint8 array; checks every CRC."""
    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(body):
        (length,) = struct.unpack(">I", body[pos:pos + 4])
        kind, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", body[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + length
    w, h, depth, ctype = hdr[0], hdr[1], hdr[2], hdr[3]
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    if depth != 8:
        raise ValueError(f"bit depth {depth}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError("filtered scanlines")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def get(port: int, path: str):
    url = f"http://127.0.0.1:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def latency(port: int, path: str, n: int) -> dict:
    """``n`` back-to-back GETs of ``path`` from one client (a closed loop),
    after the main path has warmed the service; seconds per request."""
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        status, _, _ = get(port, path)
        secs.append(time.perf_counter() - t0)
        if status != 200:
            fail(f"GET {path}: HTTP {status}")
    size = int(path.split("size=")[1].split("&")[0])
    med = float(np.median(secs))
    return {"path": path, "n": n, "seconds": secs, "median_s": med,
            "min_s": min(secs), "max_s": max(secs),
            "rays_per_s": size * size / med}


def profile_device(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: device time by kernel and by
    kind, device busy time against the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    by_kind = {}
    for name, ms in top:
        kind = next((k for k, marks in KERNEL_KINDS
                     if any(m in name.lower() for m in marks)), "rest")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": (1 - busy / (wall * 1e3)) if busy else None,
            "by_kind_ms": by_kind, "kernels_ms": dict(top)}


def device_ms(fn, reps: int, mark: str):
    """Device time a call of the kernels whose names hold ``mark``, from
    ``torch.profiler`` over ``reps`` calls of ``fn`` (after a warm one);
    None where the profiler traced no device time."""
    fn()
    prof = profile_device(lambda: [fn() for _ in range(reps)])
    ms = sum(v for k, v in prof["kernels_ms"].items() if mark in k.lower())
    return ms / reps if ms else None


def log_profile(what: str, prof: dict):
    if prof["device_busy_ms"] == 0:
        log("  profiler: no device time traced (not measured)")
        return
    log(f"  profiler, {what}: wall {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}; by kind:")
    for kind, ms in sorted(prof["by_kind_ms"].items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.3f} ms  {100 * ms / prof['device_busy_ms']:5.1f} %  "
            f"{kind}")
    log("  top kernels:")
    for name, ms in list(prof["kernels_ms"].items())[:8]:
        log(f"    {ms:9.3f} ms  {name[:100]}")


def profile_render(renderer, size: int) -> dict:
    """One ``size`` px season render under the profiler (after a warm
    one)."""
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, size)
    renderer.render_img(*args)
    return {"size": size, **profile_device(lambda: renderer.render_img(*args))}


def serve_requests(port: int, requests, h_range) -> list:
    """GET each ``(path, expected K3 launches, body kind, expected shape)``
    of ``requests`` once; fail on a status other than 200, a body that
    does not decode to its shape, an empty or non-finite image, heights out
    of ``h_range``, or K3 launches other than the chunking implies."""
    from season_nerf_torch.ops import fused_trunk as ft
    records = []
    for path, want_launches, kind, shape in requests:
        before = ft.trunk_apply.launches
        t0 = time.perf_counter()
        status, headers, body = get(port, path)
        secs = time.perf_counter() - t0
        launches = ft.trunk_apply.launches - before
        if status != 200:
            fail(f"GET {path}: HTTP {status}: {body[:500]!r}")
        if kind == "json":
            info = json.loads(body)
            if info.get("status") != "ok":
                fail(f"GET {path}: {info}")
            arr = None
        elif kind == "png":
            arr = decode_png(body)
        else:
            arr = np.load(io.BytesIO(body))
            if headers.get("X-DSM-Units") != "meters":
                fail(f"GET {path}: units {headers.get('X-DSM-Units')}")
        if arr is not None:
            if arr.shape != shape:
                fail(f"GET {path}: shape {arr.shape}, want {shape}")
            finite = np.isfinite(arr.astype(np.float64))
            if kind == "npy":
                vals = arr[finite]
                lo, hi = h_range
                if vals.size == 0 or vals.min() < lo - 1e-3 \
                        or vals.max() > hi + 1e-3:
                    fail(f"GET {path}: heights {vals.size} finite, out of "
                         f"{h_range}")
            elif not finite.all() or not arr.any():
                fail(f"GET {path}: empty or non-finite image")
        if launches != want_launches:
            fail(f"GET {path}: {launches} K3 launches, the chunking implies "
                 f"{want_launches}")
        records.append({"path": path, "status": status, "seconds": secs,
                        "bytes": len(body), "k3_launches": launches})
        log(f"  GET {path}: {status}, {len(body)} B, {secs:.3f} s, K3 "
            f"launches {launches}")
    return records


def card_vs_cpu_render(card, cpu, tol=RENDER_TOL) -> dict:
    """A 16 px render by the ``card`` Renderer and by the ``cpu`` one
    (plain versions) of the same model directory: the max abs difference
    of each output, each held to ``tol``."""
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, 16)
    a, b = card.render_img(*args), cpu.render_img(*args)
    diffs = {k: float(np.nanmax(np.abs(
        np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))))
        for k in ("Col_Img", "Shadow_Mask", "Height", "PS_Sum")}
    log(f"  16 px render, card against CPU: {diffs} (tol {tol})")
    if not all(np.isfinite(v) and v <= tol for v in diffs.values()):
        fail("the card's render disagrees with the CPU path")
    return diffs


def write_model_dir(d: str, model, cfg, h_range):
    """A model directory of ``model`` (opts.json, Final_Model.nn, the world
    artifact with ``h_range``), written by the port's own writers."""
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.train.state import save_model_artifact
    cfg.save_json(os.path.join(d, "opts.json"))
    save_model_artifact(os.path.join(d, "Final_Model.nn"),
                        model.state_dict(), meta={"seed": SEED})
    save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                        h_range)


def main_path(model, cfg, device) -> dict:
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.serving import RenderService, make_server

    S, chunk = cfg.n_samples, cfg.chunk
    chunks = lambda n: -(-n // chunk)
    # (path, expected K3 launches, body kind, expected shape)
    requests = [
        ("/healthz", 0, "json", None),
        ("/render?size=128", chunks(128 * 128), "png", (128, 128, 3)),
        ("/render?size=64&layer=base", chunks(64 * 64), "png", (64, 64, 3)),
        ("/render?size=16&exact_shadow=1",
         chunks(16 * 16) + chunks(16 * 16 * S) * (S - 1), "png",
         (16, 16, 3)),
        ("/dsm?size=128", chunks(128 * 128), "npy", (128, 128)),
        ("/dsm?size=64&format=png", chunks(64 * 64), "png", (64, 64)),
    ]
    h_range = (0.0, 30.0)
    report = {}
    with tempfile.TemporaryDirectory() as d:
        write_model_dir(d, model, cfg, h_range)
        t0 = time.perf_counter()
        service = RenderService(d, device=device)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        log(f"  model directory loaded onto {device} in "
            f"{report['load_s']:.3f} s")
        server = make_server(service, "127.0.0.1", 0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            ft.trunk_apply.launches = 0
            report["requests"] = serve_requests(port, requests, h_range)
            report["k3_launches"] = ft.trunk_apply.launches
            report["latency"] = latency(port, STEADY_PATH, STEADY_REQUESTS)
            lat = report["latency"]
            log(f"  GET {STEADY_PATH} x {lat['n']}, one client: median "
                f"{lat['median_s']:.4f} s, min {lat['min_s']:.4f} s, max "
                f"{lat['max_s']:.4f} s ({lat['rays_per_s']:.0f} rays/s at "
                f"the median)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)

        # the same small render on the card and on the CPU (plain versions)
        report["card_vs_cpu_16px"] = card_vs_cpu_render(
            service.renderer, load_model_dir(d, device="cpu").renderer)

        prof = profile_render(service.renderer, 128)
        report["profile_128px"] = prof
        log_profile("one 128 px render", prof)
    return report


def fast_render_path(model, cfg, device, exact_latency) -> dict:
    """The depth-guided fast render at full width: the model directory of
    phase 4 served by ``RenderService(fast_render=FAST_RENDER)``.  A chunk
    runs K3 twice (the density-only window pass and the full pass over
    n_fine samples); the exact-shadow frame casts its secondary rays from
    the n_fine samples with ``n_samples`` steps.  Then 10 warm 128 px
    frames beside the exact path's (``exact_latency``, phase 4 of this
    run), a 16 px frame on the card against the CPU, and one 128 px frame
    under the profiler."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.serving import RenderService, make_server
    nc, nf = FAST_RENDER
    S, chunk = cfg.n_samples, cfg.chunk
    chunks = lambda n: -(-n // chunk)
    requests = [
        ("/render?size=128", 2 * chunks(128 * 128), "png", (128, 128, 3)),
        ("/render?size=16&exact_shadow=1",
         2 * chunks(16 * 16) + chunks(16 * 16 * nf) * (S - 1), "png",
         (16, 16, 3)),
        ("/dsm?size=128", 2 * chunks(128 * 128), "npy", (128, 128)),
    ]
    h_range = (0.0, 30.0)
    report = {"fast_render": list(FAST_RENDER)}
    with tempfile.TemporaryDirectory() as d:
        write_model_dir(d, model, cfg, h_range)
        service = RenderService(d, fast_render=FAST_RENDER, device=device)
        info = service.info()
        if info["fast_render"] != list(FAST_RENDER):
            fail(f"/info reports fast_render {info['fast_render']}")
        server = make_server(service, "127.0.0.1", 0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            ft.trunk_apply.launches = 0
            report["requests"] = serve_requests(port, requests, h_range)
            report["k3_launches"] = ft.trunk_apply.launches
            report["latency"] = lat = latency(port, STEADY_PATH,
                                              STEADY_REQUESTS)
            log(f"  GET {STEADY_PATH} x {lat['n']} with fast_render "
                f"{FAST_RENDER}: median {lat['median_s']:.4f} s, max "
                f"{lat['max_s']:.4f} s ({lat['rays_per_s']:.0f} rays/s); "
                f"the exact path in this run: median "
                f"{exact_latency['median_s']:.4f} s, max "
                f"{exact_latency['max_s']:.4f} s")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        report["card_vs_cpu_16px"] = card_vs_cpu_render(
            service.renderer,
            load_model_dir(d, fast_render=FAST_RENDER,
                           device="cpu").renderer)
        prof = profile_render(service.renderer, 128)
        report["profile_128px"] = prof
        log_profile("one fast 128 px render", prof)
    return report


# A model directory whose opts.json predates compute_dtype and fast_sine
# loads as float32 with the exact sine (config._LEGACY_DEFAULTS): every K3
# launch then runs the f32 kernel.  A 16 px frame on the card is held
# against the CPU path (plain versions) to 1e-3, the f32 density surface's
# tolerance in tests/test_torch_cuda.py: the two sum the same f32 products
# in other orders.
LEGACY_KEYS = ("compute_dtype", "fast_sine")
F32_RENDER_TOL = 1e-3


def write_legacy_model_dir(d: str, model, cfg, h_range):
    """:func:`write_model_dir`, then ``LEGACY_KEYS`` taken out of
    opts.json, as a directory written before those knobs existed."""
    write_model_dir(d, model, cfg, h_range)
    path = os.path.join(d, "opts.json")
    with open(path) as f:
        opts = json.load(f)
    for k in LEGACY_KEYS:
        opts.pop(k)
    with open(path, "w") as f:
        json.dump(opts, f, indent=1)


def legacy_f32_path(model, cfg, device) -> dict:
    """The render cell's model as a legacy directory (float32, ``sinf``)
    served over HTTP: ``/render?size=128``, ``/dsm?size=128`` and a 16 px
    exact-shadow frame with K3's launches as the chunking implies, 10 warm
    128 px frames (median, max), a 16 px frame on the card against the CPU
    within F32_RENDER_TOL, and one 128 px frame under the profiler."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.serving import RenderService, make_server
    S, chunk = cfg.n_samples, cfg.chunk
    chunks = lambda n: -(-n // chunk)
    requests = [
        ("/render?size=128", chunks(128 * 128), "png", (128, 128, 3)),
        ("/dsm?size=128", chunks(128 * 128), "npy", (128, 128)),
        ("/render?size=16&exact_shadow=1",
         chunks(16 * 16) + chunks(16 * 16 * S) * (S - 1), "png",
         (16, 16, 3)),
    ]
    h_range = (0.0, 30.0)
    report = {}
    with tempfile.TemporaryDirectory() as d:
        write_legacy_model_dir(d, model, cfg, h_range)
        service = RenderService(d, device=device)
        fused = service.renderer.model.G_NeRF_net.fused()
        report["dtype"] = str(fused.folded.dtype)
        report["fast_sine"] = bool(fused.fast_sine)
        if fused.folded.dtype != torch.float32 or fused.fast_sine:
            fail(f"the legacy directory loaded as {fused.folded.dtype}, "
                 f"fast_sine={fused.fast_sine}; want float32 with sinf")
        server = make_server(service, "127.0.0.1", 0)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            ft.trunk_apply.launches = 0
            report["requests"] = serve_requests(port, requests, h_range)
            report["k3_launches"] = ft.trunk_apply.launches
            report["latency"] = lat = latency(port, STEADY_PATH,
                                              STEADY_REQUESTS)
            log(f"  GET {STEADY_PATH} x {lat['n']}, float32 legacy model: "
                f"median {lat['median_s']:.4f} s, max {lat['max_s']:.4f} s "
                f"({lat['rays_per_s']:.0f} rays/s at the median)")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        report["card_vs_cpu_16px"] = card_vs_cpu_render(
            service.renderer, load_model_dir(d, device="cpu").renderer,
            F32_RENDER_TOL)
        prof = profile_render(service.renderer, 128)
        report["profile_128px"] = prof
        log_profile("one float32 legacy 128 px render", prof)
    return report


# --- K3 above the flagship's shapes, reference checkpoints, movies ----------
WIDE_FRAME_UNITS = 640          # the wide bf16 model served in phase (a)
REFUSED_UNITS = 1152            # a padded width K3 refuses
MOVIE_FRAMES, MOVIE_SIZE = 8, 128
MOVIE_SMALL = (3, 16)           # frames, px: the movie card against CPU
# a 16 px bf16 movie frame, card against CPU, in uint8 levels: RENDER_TOL
# on the colours (5e-2 x 255 = 12.75)
MOVIE_LEVELS = 13


def card_vs_cpu_dir(d, tol, device, **load_kw) -> dict:
    """A 16 px frame of the model directory ``d`` on the card against the
    CPU (:func:`card_vs_cpu_render`), with K3's launches on the card."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    card = load_model_dir(d, device=device, **load_kw).renderer
    cpu = load_model_dir(d, device="cpu", **load_kw).renderer
    before = ft.trunk_apply.launches
    diffs = card_vs_cpu_render(card, cpu, tol)
    return {"diffs": diffs, "k3_launches": ft.trunk_apply.launches - before,
            "dtype": str(card.model.G_NeRF_net.fused().folded.dtype)}


def wide_path(device, trunk, ptxas) -> dict:
    """Phase (a): K3 at the wider and deeper trunks against its plain
    version (:func:`check_trunk_wide`) with ptxas's registers and spills of
    each instance they take; a 16 px frame of a 640-wide bf16 model on the
    card against the CPU (the wide instance on the main path, its launches
    counted from 0); ``load_model_dir`` refusing a padded width of 1152
    before any launch; the flagship times beside the parent's."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    report = {"ptxas": {k: v for k, v in ptxas_entries(ptxas, "trunk_")
                        .items() if "wide" in k or "Li4E" in k}}
    for name, lines in report["ptxas"].items():
        log(f"  ptxas {name[-40:]}: {'; '.join(lines)}")
    report["trunks"] = check_trunk_wide(device)
    with tempfile.TemporaryDirectory() as d:
        cfg = Config(fc_units=WIDE_FRAME_UNITS)
        write_model_dir(d, make_model(cfg), cfg, (0.0, 30.0))
        ft.trunk_apply.launches = 0
        report["frame_16px"] = rec = card_vs_cpu_dir(d, RENDER_TOL, device)
        report["k3_launches"] = ft.trunk_apply.launches
        if report["k3_launches"] != -(-16 * 16 // cfg.chunk):
            fail(f"the {WIDE_FRAME_UNITS}-wide frame launched K3 "
                 f"{report['k3_launches']} times")
        log(f"  {WIDE_FRAME_UNITS}-wide bf16 model, 16 px frame: K3 "
            f"{rec['k3_launches']} launch(es), card against CPU "
            f"{rec['diffs']}")
    with tempfile.TemporaryDirectory() as d:
        Config(fc_units=REFUSED_UNITS).save_json(os.path.join(d,
                                                              "opts.json"))
        with open(os.path.join(d, "Final_Model.nn"), "wb") as f:
            f.write(b"never read")
        before = ft.trunk_apply.launches
        try:
            load_model_dir(d, device=device)
            fail(f"load_model_dir took a padded width of {REFUSED_UNITS}")
        except ValueError as e:
            report["refusal"] = str(e)
        if "up to 1024" not in report["refusal"] \
                or ft.trunk_apply.launches != before:
            fail(f"the refusal of {REFUSED_UNITS}: {report['refusal']}")
        log(f"  load_model_dir, fc_units {REFUSED_UNITS}: refused before "
            f"any launch: {report['refusal']}")
    report["flagship_ms"] = {}
    for name, parent in PARENT_K3_MS.items():
        ms = trunk[name][0]["ms"]
        report["flagship_ms"][name] = ms
        log(f"  flagship {name}: {ms:.4f} ms (PERF.md records {parent} ms "
            f"for the parent)")
    return report


def write_reference_checkpoint(path: str, cfg, seed: int = SEED):
    """A reference-format checkpoint (a torch state dict with the reference
    T_NeRF's names, its unused heads and num_batches_tracked) of a seeded
    model at ``cfg``'s width, BatchNorm calibrated, by ``torch.save``."""
    torch.save(make_model(cfg, seed).state_dict(), path)


def converted_model_dir(d: str, ckpt: str, cfg, h_range):
    """``d`` as a model directory of ``ckpt`` converted by the port's tool
    (``tools/convert_reference_model``), with an opts.json of ``cfg``
    without LEGACY_KEYS: float32 with the exact sine, as the reference
    trained."""
    from season_nerf_torch.data.ingest import save_world_artifact
    from season_nerf_torch.tools import convert_reference_model
    convert_reference_model.main([
        "--torch_model", ckpt, "--fc_units", str(cfg.fc_units),
        "--n_classes", str(cfg.number_low_frequency_cases), "--out",
        os.path.join(d, "Final_Model.nn")])
    cfg.save_json(os.path.join(d, "opts.json"))
    with open(os.path.join(d, "opts.json")) as f:
        opts = json.load(f)
    for k in LEGACY_KEYS:
        opts.pop(k)
    with open(os.path.join(d, "opts.json"), "w") as f:
        json.dump(opts, f, indent=1)
    save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                        h_range)


def reference_path(cfg, device) -> dict:
    """Phase (b): a reference checkpoint from the seed at the render cell's
    width, converted by the port's tool and served over HTTP: every K3
    launch the f32 kernel, 10 warm 128 px frames (median, max), a 16 px
    frame on the card against the CPU within F32_RENDER_TOL."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.serving import RenderService, make_server
    report = {}
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "reference_Final_Model.nn")
        write_reference_checkpoint(ckpt, cfg)
        model_dir = os.path.join(d, "converted")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        converted_model_dir(model_dir, ckpt, cfg, (0.0, 30.0))
        report["convert_s"] = time.perf_counter() - t0
        service = RenderService(model_dir, device=device)
        fused = service.renderer.model.G_NeRF_net.fused()
        if fused.folded.dtype != torch.float32 or fused.fast_sine:
            fail(f"the converted directory loaded as {fused.folded.dtype}, "
                 f"fast_sine={fused.fast_sine}; want float32 with sinf")
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            ft.trunk_apply.launches = 0
            report["latency"] = lat = latency(server.server_address[1],
                                              STEADY_PATH, STEADY_REQUESTS)
            report["k3_launches"] = ft.trunk_apply.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        want = STEADY_REQUESTS * -(-128 * 128 // cfg.chunk)
        log(f"  converted in {report['convert_s']:.2f} s; GET {STEADY_PATH} "
            f"x {lat['n']}: median {lat['median_s']:.4f} s, max "
            f"{lat['max_s']:.4f} s; K3 (f32) {report['k3_launches']} "
            f"launches (the chunking implies {want})")
        if report["k3_launches"] != want:
            fail(f"the converted model launched K3 {report['k3_launches']} "
                 f"times; the chunking implies {want}")
        report["frame_16px"] = card_vs_cpu_dir(model_dir, F32_RENDER_TOL,
                                               device)
    return report


def decode_gif(data: bytes) -> list:
    """The frames of a GIF as [H, W, 3] uint8 arrays: enough of the format
    to read what ``utils/gif.py`` writes back (each frame with a local
    palette, LZW-coded)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    at, frames, palette = 13, [], None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = np.frombuffer(data[13:13 + n], np.uint8).reshape(-1, 3)
        at += n
    while data[at] != 0x3B:
        if data[at] == 0x21:                  # an extension: skip it
            at += 2
            while data[at]:
                at += data[at] + 1
            at += 1
            continue
        x, y, fw, fh, fl = struct.unpack("<HHHHB", data[at + 1:at + 10])
        at += 10
        pal = palette
        if fl & 0x80:
            n = 3 << ((fl & 7) + 1)
            pal = np.frombuffer(data[at:at + n], np.uint8).reshape(-1, 3)
            at += n
        min_size, at = data[at], at + 1
        blocks = bytearray()
        while data[at]:
            blocks += data[at + 1:at + 1 + data[at]]
            at += data[at] + 1
        at += 1
        idx = _lzw_decode(bytes(blocks), min_size)[:fw * fh]
        frames.append(pal[np.asarray(idx, np.int64)].reshape(fh, fw, 3))
    return frames


def _lzw_decode(data: bytes, min_size: int) -> list:
    clear, end = 1 << min_size, (1 << min_size) + 1
    bits = int.from_bytes(data, "little")
    pos, size, out = 0, min_size + 1, []
    table, prev = None, None
    while pos + size <= len(data) * 8:
        code = (bits >> pos) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table = [[i] for i in range(clear)] + [None, None]
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = (table[code] if code < len(table)
                     else prev + [prev[0]])
            table.append(prev + [entry[0]])
            if len(table) == 1 << size and size < 12:
                size += 1
        out += entry
        prev = entry
    return out


def movie_path(model, cfg, device) -> dict:
    """Phase (c): ``tools/make_movie`` on the render cell's model directory
    (8 frames of 128 px, the default orbit script), timed a frame, K3's
    launches against frames x chunks; then a 3-frame 16 px movie on the
    card against the CPU (MOVIE_LEVELS), ``pipeline=2`` against
    ``pipeline=1`` byte for byte on the card, and the GIF decoded back."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.movie import render_movie
    from season_nerf_torch.tools import make_movie
    report = {}
    with tempfile.TemporaryDirectory() as d:
        write_model_dir(d, model, cfg, (0.0, 30.0))
        out = os.path.join(d, "movie.mp4")
        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        path = make_movie.main(["--Model_Location", d, "--frames",
                                str(MOVIE_FRAMES), "--size", str(MOVIE_SIZE),
                                "--out", out, "--device", str(device)])
        report["make_movie_s"] = time.perf_counter() - t0
        report["k3_launches"] = ft.trunk_apply.launches
        want = MOVIE_FRAMES * -(-MOVIE_SIZE ** 2 // cfg.chunk)
        with open(path, "rb") as f:
            frames = decode_gif(f.read())
        report["gif_frames"] = len(frames)
        if path != os.path.join(d, "movie.gif") or len(frames) != \
                MOVIE_FRAMES or frames[0].shape != (MOVIE_SIZE,) * 2 + (3,):
            fail(f"make_movie wrote {path} with {len(frames)} frames")
        if report["k3_launches"] != want:
            fail(f"the movie launched K3 {report['k3_launches']} times; "
                 f"{MOVIE_FRAMES} frames x chunks imply {want}")
        card = load_model_dir(d, device=device)
        script = make_movie.default_script()
        render_movie(card.renderer, script, 2, MOVIE_SIZE)      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_movie(card.renderer, script, MOVIE_FRAMES, MOVIE_SIZE)
        torch.cuda.synchronize()
        report["s_per_frame"] = (time.perf_counter() - t0) / MOVIE_FRAMES
        n, size = MOVIE_SMALL
        got = render_movie(card.renderer, script, n, size, pipeline=1)
        two = render_movie(card.renderer, script, n, size, pipeline=2)
        cpu = render_movie(load_model_dir(d, device="cpu").renderer, script,
                           n, size, pipeline=1)
        report["pipeline_equal"] = bool(np.array_equal(got, two))
        report["card_vs_cpu_levels"] = int(np.abs(
            got.astype(int) - cpu.astype(int)).max())
    log(f"  make_movie, {MOVIE_FRAMES} frames of {MOVIE_SIZE} px: "
        f"{report['make_movie_s']:.2f} s with the load, K3 "
        f"{report['k3_launches']} launches (implied {want}); warm "
        f"{report['s_per_frame']:.4f} s a frame; {n} frames of {size} px, "
        f"card against CPU {report['card_vs_cpu_levels']} uint8 levels "
        f"(tol {MOVIE_LEVELS}), pipeline=2 equal to pipeline=1: "
        f"{report['pipeline_equal']}; GIF decoded: {len(frames)} frames")
    if not report["pipeline_equal"]:
        fail("pipeline=2 frames differ from pipeline=1's")
    if report["card_vs_cpu_levels"] > MOVIE_LEVELS:
        fail("the card's movie disagrees with the CPU's")
    return report


# --- the render export: tools/export_render through the K3 operator ---------
# Each program exported on the card by the tool's main (the render cell's
# model, exact and with --fast_render 32 32, and its legacy float32
# directory, exact), then loaded in a fresh process (export_child) that
# imports season_nerf_torch and nothing of its tools, called on a flagship
# chunk (cfg.chunk rays x 96 samples: 491,520 trunk points; the tool's
# --check rays) and held against the live Renderer._full_chunk at the
# tool's 2e-5.
EXPORT_CASES = (("bf16-exact", "bf16", None, 1),
                ("bf16-fast", "bf16", FAST_RENDER, 2),
                ("f32-exact", "legacy", None, 1))
EXPORT_TOL = 2e-5
EXPORT_REPS = 10


def export_path(model, cfg, device) -> dict:
    """Export, load in a fresh process, call, compare, time (see above):
    K3's launches 0 while exporting, then 1 a call of an exact program and
    2 of a fast one; each program's chunk time beside the live chunk's in
    the same process (CUDA events, live / program / program / live), and
    its size."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.tools import export_render
    report = {"chunk": cfg.chunk, "points": cfg.chunk * cfg.n_samples}
    with tempfile.TemporaryDirectory() as d:
        dirs = {"bf16": os.path.join(d, "bf16"),
                "legacy": os.path.join(d, "legacy")}
        for kind, path in dirs.items():
            os.makedirs(path)
            (write_model_dir if kind == "bf16" else write_legacy_model_dir)(
                path, model, cfg, (0.0, 30.0))
        cases = []
        for name, kind, fast, per_call in EXPORT_CASES:
            out = os.path.join(d, f"{name}.pt2")
            argv = [dirs[kind], "-o", out, "--device", str(device)]
            if fast:
                argv += ["--fast_render", *map(str, fast)]
            ft.trunk_apply.launches = 0
            t0 = time.perf_counter()
            export_render.main(argv)
            torch.cuda.synchronize()
            rec = {"export_s": time.perf_counter() - t0,
                   "mb": os.path.getsize(out) / 1e6,
                   "export_launches": ft.trunk_apply.launches}
            with open(out + ".json") as f:
                manifest = json.load(f)
            if rec["export_launches"] != 0 or manifest["chunk"] != cfg.chunk \
                    or torch.device(manifest["device"]).type != device.type \
                    or manifest["fast_render"] != (list(fast) if fast
                                                   else None):
                fail(f"export {name}: {rec}, manifest {manifest}")
            report[name] = rec
            cases.append({"name": name, "program": out,
                          "device": manifest["device"],
                          "model_dir": dirs[kind],
                          "fast_render": list(fast) if fast else None,
                          "per_call": per_call})
        spec = os.path.join(d, "cases.json")
        with open(spec, "w") as f:
            json.dump(cases, f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--export-child",
             spec], capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  [loading process] {line}")
    if proc.returncode != 0 or not lines:
        fail(f"the export's loading process failed (rc {proc.returncode}): "
             f"{proc.stderr[-3000:]}")
    child = json.loads(lines[-1])
    report["k3_launches"] = {"bfloat16": 0, "float32": 0}
    for name, _, _, per_call in EXPORT_CASES:
        rec = {**report[name], **child["cases"][name]}
        report[name] = rec
        report["k3_launches"][rec["dtype"]] += rec["launches"]
        log(f"  {name}: exported in {rec['export_s']:.2f} s, "
            f"{rec['mb']:.2f} MB; loaded in a fresh process: max abs "
            f"difference from the live chunk {rec['max_abs_err']:.3e} (tol "
            f"{EXPORT_TOL}), K3 {rec['launches_per_call']} launch(es) a "
            f"call; chunk {rec['program_ms']:.3f} ms loaded against "
            f"{rec['live_ms']:.3f} ms live ({rec['points']} trunk points)")
    report["fast_sine_launches"] = child["fast_sine_launches"]
    report["child_modules"] = child["modules"]
    report["launch_states"] = child["launch_states"]
    return report


def export_child(spec: str):
    """``--export-child``: load each program of ``spec`` with
    ``torch.export.load`` (``season_nerf_torch`` imported, nothing of its
    tools), call it on the flagship chunk, hold it against the live
    ``Renderer._full_chunk`` of its model directory, count K3's and the
    polynomial sine's launches a call (the sine's as the live chunk's,
    none in float32) and time both; prints one JSON line."""
    import season_nerf_torch                 # registers the operator
    from season_nerf_torch.ops import fast_math as fm
    from season_nerf_torch.ops import fused_trunk as ft
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(spec) as f:
        cases = json.load(f)
    programs = {c["name"]: torch.export.load(c["program"]).module()
                for c in cases}
    from season_nerf_torch.render.loading import load_model_dir
    out = {"cases": {}}
    for c in cases:
        program = programs[c["name"]]
        device = torch.device(c["device"])  # the program's own
        lm = load_model_dir(c["model_dir"], device=device,
                            fast_render=c["fast_render"])
        rng = np.random.default_rng(0)
        n = lm.cfg.chunk
        tops = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                               np.ones((n, 1))], 1)
        bots = np.concatenate([tops[:, :2], -np.ones((n, 1))], 1)
        sun = np.broadcast_to([0.3, 0.2, 0.93], (n, 3))
        t4 = np.broadcast_to([1.0, 0.0, 1.0, 0.0], (n, 4))
        rays = [torch.tensor(a, dtype=torch.float32, device=device)
                for a in (tops, bots, sun, t4)]
        live = lambda: lm.renderer._full_chunk(*rays)
        call = lambda: program(*rays)
        ft.trunk_apply.launches = 0
        with torch.no_grad():
            s0 = fm.launches
            want = live()
            torch.cuda.synchronize()
            before, s1 = ft.trunk_apply.launches, fm.launches
            got = call()
            torch.cuda.synchronize()
            launches = ft.trunk_apply.launches - before
            sines = (fm.launches - s1, s1 - s0)     # program, live
            err = max(float((got[k] - want[k]).abs().max()) for k in want)
            finite = all(bool(torch.isfinite(got[k]).all()) for k in got)
            ms = [cuda_ms(f, EXPORT_REPS) for f in (live, call, call, live)]
        torch.cuda.synchronize()
        if sorted(got) != sorted(want) or not finite or err > EXPORT_TOL \
                or launches != c["per_call"] or sines[0] != sines[1] \
                or (sines[0] > 0) != lm.cfg.fast_sine:
            fail(f"the loaded program {c['name']}: keys {sorted(got)}, "
                 f"finite {finite}, max abs difference {err:.3e}, K3 "
                 f"launches a call {launches} (want {c['per_call']}), the "
                 f"sine's {sines[0]} (the live chunk's {sines[1]}, "
                 f"fast_sine {lm.cfg.fast_sine})")
        out["cases"][c["name"]] = {
            "max_abs_err": err, "launches_per_call": launches,
            "fast_sine_per_call": sines[0],
            "launches": ft.trunk_apply.launches,    # live and loaded
            "dtype": str(lm.model.G_NeRF_net.dtype or torch.float32)[6:],
            "points": n * (sum(c["fast_render"]) if c["fast_render"]
                           else lm.cfg.n_samples),      # both passes
            "live_ms": (ms[0] + ms[3]) / 2, "program_ms": (ms[1] + ms[2]) / 2,
            "ms_in_turn": ms}
        del lm
    out["fast_sine_launches"] = fm.launches
    out["modules"] = sorted(m for m in sys.modules
                            if m.startswith("season_nerf_torch"))
    out["launch_states"] = len(ft._launch_states)
    if any(m.startswith("season_nerf_torch.tools") for m in out["modules"]):
        fail("the loading process imported the port's tools")
    print(json.dumps(out), flush=True)


# --- the run tools on the card ------------------------------------------------
# On the validation path's run directory (a 40-step flagship model: the
# quality numbers are functional, not a model's quality): quality_report,
# select_best_geometry (its recomputed Prior_Height_Error against the one
# the run logged at each save point), time_to_quality and fast_render_ab;
# bench_serving_concurrent on the render cell's model at 1, 4 and 16
# clients; run_regions on one synthetic site at a few flagship steps.
TOOLS_TTQ_SIZE = 64
TOOLS_AB_SIZE = 256
TOOLS_AB_VIEWS = 3
TOOLS_CLIENTS = (1, 4, 16)
TOOLS_BENCH_SIZE = 128
TOOLS_REQUESTS = 4              # a client's requests, one after the other
TOOLS_REGION_STEPS = 4
TOOLS_PRIOR_RTOL = 1e-4


def _tool(fn, argv, report, key):
    """One tool's ``main(argv)`` with the kernels' counts set to 0 just
    before it and read just after -> its result; seconds, launches and
    stdout into ``report[key]``."""
    import contextlib
    from season_nerf_torch.ops import fused_train as ftr, fused_trunk as ft
    out = io.StringIO()
    ft.trunk_apply.launches = 0
    ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    torch.cuda.synchronize()
    report[key] = {"s": time.perf_counter() - t0,
                   "k3_launches": ft.trunk_apply.launches,
                   "k1_launches": ftr.trunk_fwd.launches,
                   "k2_launches": ftr.trunk_bwd.launches,
                   "stdout": out.getvalue()[-4000:]}
    return res


def tools_path(cfg, device, val_dir, val_testing) -> dict:
    """The run tools on the card (see above); ``val_testing`` is the
    validation path's logged ``Testing`` values by save point."""
    from season_nerf_torch.tools import (bench_serving_concurrent,
                                         fast_render_ab, quality_report,
                                         run_regions, select_best_geometry,
                                         time_to_quality)
    report = {}
    md = _tool(quality_report.main, [val_dir], report, "quality_report")
    log(f"  quality_report: {len(md.splitlines())} lines, "
        f"{report['quality_report']['s']:.2f} s")
    if "# Quality report" not in md or "camera-rays/s" not in md:
        fail(f"quality_report on the validation run: {md[:500]}")

    rows = _tool(select_best_geometry.main, [val_dir, "--device",
                                             str(device)],
                 report, "select_best_geometry")
    rec = report["select_best_geometry"]
    rec["rows"] = rows
    worst = 0.0
    for r in rows:
        logged = val_testing[r["step"]]["Prior_Height_Error"]
        worst = max(worst, abs(r["prior_mae"] - logged) / abs(logged))
    rec["prior_rel_diff_vs_logged"] = worst
    picked = min(rows, key=lambda r: r["prior_mae"])["step"]
    rec["selected_step"] = picked
    log(f"  select_best_geometry: {len(rows)} save points in "
        f"{rec['s']:.2f} s, K3 {rec['k3_launches']} launches; selects step "
        f"{picked}; its Prior_Height_Error against the run's logged values: "
        f"max relative difference {worst:.2e} (tol {TOOLS_PRIOR_RTOL})")
    if sorted(r["step"] for r in rows) != sorted(val_testing) \
            or worst > TOOLS_PRIOR_RTOL \
            or not all(np.isfinite([r["prior_mae"], r["gt_mae"], r["psnr"]])
                       .all() for r in rows):
        fail(f"select_best_geometry on the validation run: {rows}")

    with tempfile.TemporaryDirectory() as d:
        ttq = _tool(time_to_quality.main,
                    [val_dir, "-o", os.path.join(d, "ttq.json"), "--size",
                     str(TOOLS_TTQ_SIZE), "--device", str(device)],
                    report, "time_to_quality")
        report["time_to_quality"]["curve"] = ttq["curve"]
        report["time_to_quality"]["bands"] = ttq["bands"]
        ab = _tool(fast_render_ab.main,
                   ["--Model_Location", val_dir, "--size",
                    str(TOOLS_AB_SIZE), "--views", str(TOOLS_AB_VIEWS),
                    "--output", os.path.join(d, "ab.json"), "--device",
                    str(device)], report, "fast_render_ab")
        report["fast_render_ab"]["result"] = ab
    last = ttq["curve"][-1]
    log(f"  time_to_quality at {TOOLS_TTQ_SIZE} px: {len(ttq['curve'])} "
        f"save points in {report['time_to_quality']['s']:.2f} s, K3 "
        f"{report['time_to_quality']['k3_launches']} launches; the last: "
        f"aligned PSNR {last['aligned_psnr']}, DSM MAE {last['dsm_mae_m']} "
        f"m (a {VAL_STEPS}-step model: functional, not a quality number)")
    log(f"  fast_render_ab at {TOOLS_AB_SIZE} px, {TOOLS_AB_VIEWS} views: "
        f"PSNR fast vs exact {ab['psnr_fast_vs_exact']}, SSIM "
        f"{ab['ssim_fast_vs_exact']}, DSM MAE {ab['dsm_mae_m_fast_vs_exact']}"
        f" m, speed-up {ab['speedup']} ({ab['exact_rays_per_sec']} / "
        f"{ab['fast_rays_per_sec']} rays/s); K3 "
        f"{report['fast_render_ab']['k3_launches']} launches (the same "
        f"{VAL_STEPS}-step model: functional)")
    if [r["step"] for r in ttq["curve"]] != sorted(val_testing) or not all(
            np.isfinite(r["aligned_psnr"]) and np.isfinite(r["dsm_mae_m"])
            for r in ttq["curve"]):
        fail(f"time_to_quality on the validation run: {ttq['curve']}")
    if not (np.isfinite(ab["psnr_fast_vs_exact"]).all()
            and ab["speedup"] > 0):
        fail(f"fast_render_ab on the validation run: {ab}")

    with tempfile.TemporaryDirectory() as d:
        write_model_dir(d, make_model(cfg), cfg, (0.0, 30.0))
        bench = _tool(bench_serving_concurrent.main,
                      [d, "--size", str(TOOLS_BENCH_SIZE), "--clients",
                       *map(str, TOOLS_CLIENTS), "--requests",
                       str(TOOLS_REQUESTS), "--device", str(device)],
                      report, "bench_serving_concurrent")
    report["bench_serving_concurrent"]["levels"] = bench["levels"]
    frames = 1 + sum(n * TOOLS_REQUESTS for n in TOOLS_CLIENTS)  # + warm
    want = frames * -(-TOOLS_BENCH_SIZE ** 2 // cfg.chunk)
    report["bench_serving_concurrent"]["k3_implied"] = want
    for row in bench["levels"]:
        log(f"  bench_serving_concurrent, {row['clients']} client(s) x "
            f"{TOOLS_REQUESTS} requests of {TOOLS_BENCH_SIZE} px: median "
            f"{row['p50_s']} s, "
            f"max {row['max_s']} s, {row['frames_per_s']} frames/s")
    if any(r["errors"] for r in bench["levels"]) \
            or report["bench_serving_concurrent"]["k3_launches"] != want:
        fail(f"bench_serving_concurrent: {bench['levels']}, K3 "
             f"{report['bench_serving_concurrent']['k3_launches']} launches "
             f"(implied {want})")

    with tempfile.TemporaryDirectory() as io_dir:
        flags = flagship_train_config()
        sets = [f"{k}={getattr(flags, k)}" for k in (
            "batch_size", "n_samples", "fc_units", "pallas_trunk",
            "compute_dtype", "fast_sine", "jump_start", "seed")]
        out = _tool(run_regions.main,
                    ["--IO_Location", io_dir, "--sites", "SYNTH_REGION",
                     "--max_train_steps", str(TOOLS_REGION_STEPS),
                     "--device", str(device), "--set", *sets,
                     "synth_views=6", "synth_img_size=48", "synth_grid=64",
                     "testing_size=1", "n_saves=2"],
                    report, "run_regions")
        merged = sorted(os.listdir(out))
    report["run_regions"]["merged"] = merged
    log(f"  run_regions, one synthetic site, {TOOLS_REGION_STEPS} steps: "
        f"{report['run_regions']['s']:.1f} s, K3 "
        f"{report['run_regions']['k3_launches']} launches; Full_Summary/: "
        f"{merged}")
    rec = report["run_regions"]
    if merged != sorted(MERGED_FILES) or rec["k3_launches"] == 0 \
            or rec["k1_launches"] != 2 * TOOLS_REGION_STEPS \
            or rec["k2_launches"] != TOOLS_REGION_STEPS:
        fail(f"run_regions: {merged}, launches K1 {rec['k1_launches']}, K2 "
             f"{rec['k2_launches']}, K3 {rec['k3_launches']}")
    tools = list(report.values())
    for k in ("k1_launches", "k2_launches", "k3_launches"):
        report[k] = sum(r[k] for r in tools)
    return report


def _proto_fields(data: bytes) -> list:
    """(field number, value) of a protobuf message: varints as ints, 64-
    and 32-bit fields as bytes, length-delimited ones as bytes."""
    out, at = [], 0
    while at < len(data):
        key, at = _read_varint(data, at)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, at = _read_varint(data, at)
        elif wire == 1:
            value, at = data[at:at + 8], at + 8
        elif wire == 5:
            value, at = data[at:at + 4], at + 4
        elif wire == 2:
            n, at = _read_varint(data, at)
            value, at = data[at:at + n], at + n
        else:
            raise ValueError(f"protobuf wire type {wire}")
        out.append((number, value))
    return out


def _read_varint(data: bytes, at: int):
    n = shift = 0
    while True:
        b = data[at]
        n |= (b & 0x7F) << shift
        at, shift = at + 1, shift + 7
        if not b & 0x80:
            return n, at


def read_event_files(logs_dir: str) -> dict:
    """Every record of the TensorBoard event files in ``logs_dir``, each
    masked CRC-32C checked: {"file_version": [...], "scalars": {tag:
    [(step, value)]}, "images": {tag: [(step, height, width)]}}."""
    from season_nerf_torch.utils.logging import masked_crc32c
    out = {"file_version": [], "scalars": {}, "images": {}, "files": 0}
    for name in sorted(os.listdir(logs_dir)):
        if not name.startswith("events.out.tfevents."):
            continue
        out["files"] += 1
        with open(os.path.join(logs_dir, name), "rb") as f:
            data = f.read()
        at = 0
        while at < len(data):
            head = data[at:at + 8]
            (n,) = struct.unpack("<Q", head)
            rec = data[at + 12:at + 12 + n]
            if struct.unpack("<I", data[at + 8:at + 12])[0] != \
                    masked_crc32c(head) or struct.unpack(
                        "<I", data[at + 12 + n:at + 16 + n])[0] != \
                    masked_crc32c(rec):
                fail(f"{name}: a record's CRC does not hold at byte {at}")
            at += 16 + n
            event = dict(_proto_fields(rec))
            if 3 in event:
                out["file_version"].append(event[3].decode())
            for number, summary in _proto_fields(event.get(5, b"")):
                value = dict(_proto_fields(summary))
                tag = value[1].decode()
                step = event.get(2, 0)
                if 2 in value:
                    out["scalars"].setdefault(tag, []).append(
                        (step, struct.unpack("<f", value[2])[0]))
                elif 4 in value:
                    img = dict(_proto_fields(value[4]))
                    out["images"].setdefault(tag, []).append(
                        (step, img.get(1, 0), img.get(2, 0)))
    return out


def flagship_train_config(**kw):
    """The flagship training configuration (``bench.py:85-90``) with the
    fused trunk: width 512, fc1..fc8 + fc9, 4 seasonal classes, bf16,
    polynomial sine, 96 samples, batch 4096, DSM prior on."""
    from season_nerf_torch.config import Config
    base = dict(max_train_steps=50_000, n_samples=96, batch_size=4096,
                fc_units=512, n_saves=0, logs_dir="", jump_start=True,
                compute_dtype="bfloat16", fast_sine=True, pallas_trunk=True,
                seed=SEED)
    base.update(kw)
    return Config(**base)


def finite_losses(scalars: dict) -> bool:
    return all(bool(torch.isfinite(v)) for v in scalars.values())


def train_path(device) -> dict:
    """The training main path: the flagship config with ``pallas_trunk``
    through ``Trainer`` on the synthetic site of ``bench.py:95-96``, phase 1
    (prior on): one warm step, then TRAIN_STEPS timed steps.  The launch
    counts are set to 0 just before the warm step and read just after the
    last."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.ops import fused_train as ftr
    from season_nerf_torch.train.engine import Trainer
    report = {}
    scene = make_scene(n_views=6, img_size=48, grid=64, seed=0)
    table, _ = scene_ray_tables(scene, testing_size=1)
    report["train_rays"] = len(table)
    cfg = flagship_train_config()
    tr = Trainer(cfg, table, prior_hm=scene.prior_hm, device=device)
    g = tr.model.G_NeRF_net
    watch = {"fc3.weight": g.fc3.linear.weight,
             "fc5.running_mean": g.fc5.norm.running_mean,
             "fc9.running_var": g.fc9.norm.running_var,
             "fc10Sigma.weight": g.fc10Sigma.weight}
    before = {k: t.detach().clone() for k, t in watch.items()}

    ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
    losses = [tr.train_step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(tr.train_step())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1, k2 = ftr.trunk_fwd.launches, ftr.trunk_bwd.launches
    steps = TRAIN_STEPS + 1
    if tr.statics.trunk_spec is None:
        fail("the flagship config did not take the fused trunk")
    if k1 != 2 * steps or k2 != steps:
        fail(f"{steps} steps launched K1 {k1} and K2 {k2} times; each step "
             f"must launch K1 twice (camera and solar pass) and K2 once")
    if not all(finite_losses(l) for l in losses):
        fail(f"non-finite loss: {losses}")
    moved = {k: float((watch[k].detach() - before[k]).abs().max())
             for k in watch}
    if not all(v > 0 for v in moved.values()):
        fail(f"a parameter or running statistic did not move: {moved}")
    report.update(
        steps=steps, k1_launches=k1, k2_launches=k2,
        step_ms=secs / TRAIN_STEPS * 1e3,
        train_rays_per_s=cfg.batch_size * TRAIN_STEPS / secs,
        first_loss={k: float(v) for k, v in losses[0].items()},
        last_loss={k: float(v) for k, v in losses[-1].items()},
        moved=moved,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  {steps} steps, K1 launches {k1}, K2 launches {k2}; "
        f"{report['step_ms']:.1f} ms a step over {TRAIN_STEPS} timed steps, "
        f"{report['train_rays_per_s']:.0f} train rays/s; Total "
        f"{report['first_loss']['Total']:.3f} -> "
        f"{report['last_loss']['Total']:.3f}; moved {moved}")

    prof = profile_device(tr.train_step)
    report["profile_step"] = prof
    log_profile("one flagship training step", prof)

    # train -> serve: the model written by finalize() renders
    with tempfile.TemporaryDirectory() as d:
        from season_nerf_torch.data.ingest import save_world_artifact
        from season_nerf_torch.render.loading import load_model_dir
        tr.cfg.logs_dir = d
        tr.cfg.save_json(os.path.join(d, "opts.json"))
        save_world_artifact(os.path.join(d, "W2C_W2L_H.npy"), None, None,
                            (0.0, 30.0))
        tr.finalize()
        loaded = load_model_dir(d, device=device)
        img = loaded.renderer.render_img((70.0, 30.0), (45.0, 180.0), 0.5,
                                         16)
        col = np.asarray(img["Col_Img"])
        if col.shape != (16, 16, 3) or not np.isfinite(col).all():
            fail(f"the trained model's render is {col.shape}, finite "
                 f"{np.isfinite(col).all()}")
        report["render_16px_mean"] = float(col.mean())
        log(f"  finalize() -> Final_Model.nn -> load_model_dir -> 16 px "
            f"render, mean color {report['render_16px_mean']:.4f}")
    del tr, loaded
    torch.cuda.empty_cache()

    # for the record: the default trunk (full-batch BatchNorm), another
    # function, so no yardstick for K1 and K2; its BatchNorm runs
    # ops/batchnorm_train's kernels, 24 launches a step (16 column sums:
    # fc2..fc9 in the camera and the solar pass; 8 dz)
    from season_nerf_torch.ops import batchnorm_train as bt
    tr = Trainer(flagship_train_config(pallas_trunk=False), table,
                 prior_hm=scene.prior_hm, device=device)
    b0 = bt.launches
    tr.train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEFAULT_TRUNK_STEPS):
        last = tr.train_step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not finite_losses(last):
        fail(f"default trunk: non-finite loss {last}")
    bn = bt.launches - b0
    if bn != 24 * (DEFAULT_TRUNK_STEPS + 1):
        fail(f"default trunk: {DEFAULT_TRUNK_STEPS + 1} steps launched the "
             f"training BatchNorm's kernels {bn} times; want 24 a step")
    report["default_trunk_batchnorm_launches"] = bn
    report["default_trunk_step_ms"] = secs / DEFAULT_TRUNK_STEPS * 1e3
    log(f"  default trunk (full-batch BatchNorm, ops/batchnorm_train's "
        f"kernels, {bn} launches): {report['default_trunk_step_ms']:.1f} ms "
        f"a step over {DEFAULT_TRUNK_STEPS} steps")
    del tr
    torch.cuda.empty_cache()

    report["cpu_vs_card"] = cpu_vs_card(table, scene.prior_hm, device)
    return report


def cpu_vs_card(table, prior_hm, device, cfg=None, rtol=CPU_CARD_RTOL,
                atol=CPU_CARD_ATOL, grad_rtol=CPU_CARD_GRAD_RTOL) -> dict:
    """A small model trained CPU_CARD_STEPS steps on the CPU (plain
    versions) and on the card from the same weights and the same draws:
    by default bf16 through K1/K2 (width 256, 8 layers, 64 rays x 32
    samples, one ghost tile); step 0's gradients held to ``grad_rtol``,
    every step's losses to ``rtol`` relative or ``atol``."""
    from season_nerf_torch.train.engine import StepDraws, Trainer
    cfg = cfg or flagship_train_config(fc_units=256, batch_size=64,
                                       n_samples=32)
    draws = StepDraws(cfg.seed, len(table), cfg.batch_size, cfg.n_samples,
                      device="cpu", n_importance=cfg.n_importance)
    runs, grads = {}, {}
    for dev in ("cpu", device):
        src = (draws if dev == "cpu" else
               lambda step: {k: v.to(device) for k, v in draws(step).items()})
        tr = Trainer(cfg, table, prior_hm=prior_hm, device=dev, draws=src)
        runs[str(dev)] = [{k: float(v) for k, v in tr.train_step().items()}]
        if cfg.pallas_trunk and tr.statics.trunk_spec is None:
            fail("the CPU-vs-card model did not take the fused trunk")
        grads[str(dev)] = leaf_grads(tr)
        runs[str(dev)] += [{k: float(v) for k, v in tr.train_step().items()}
                           for _ in range(CPU_CARD_STEPS - 1)]
    step0_grads = compare_grads(grads["cpu"], grads[str(device)], grad_rtol)
    cpu, card = runs["cpu"], runs[str(device)]
    worst = 0.0
    for i, (a, b) in enumerate(zip(cpu, card)):
        if set(a) != set(b):
            fail(f"CPU and card loss dicts differ in keys at step {i}")
        for k in a:
            err = abs(a[k] - b[k])
            worst = max(worst, err / max(abs(a[k]), atol / rtol))
            if not np.isfinite(b[k]) or err > atol + rtol * abs(a[k]):
                fail(f"step {i} {k}: CPU {a[k]} against card {b[k]}")
    log(f"  {CPU_CARD_STEPS} steps of a {cfg.fc_units}-wide "
        f"{cfg.compute_dtype} model (pallas_trunk {cfg.pallas_trunk}, "
        f"n_importance {cfg.n_importance}), CPU (plain versions) against "
        f"the card: worst loss difference {worst:.3e} relative (tol "
        f"{rtol:g}); Total {[round(r['Total'], 4) for r in cpu]} against "
        f"{[round(r['Total'], 4) for r in card]}")
    return {"cpu": cpu, "card": card, "worst_rel": worst,
            "step0_grads": step0_grads}


def leaf_grads(tr) -> dict:
    """Every leaf's gradient after a step: the network's parameters and the
    adaptive-loss latents, as f32 on the CPU (None where a leaf got none)."""
    leaves = dict(tr.model.named_parameters())
    leaves.update({f"ada.{g}.{k}": t for g, lat in tr.ada_params.items()
                   for k, t in lat.items()})
    return {n: None if t.grad is None else t.grad.detach().float().cpu()
            for n, t in leaves.items()}


def grad_errors(cpu: dict, card: dict, rtol: float = CPU_CARD_GRAD_RTOL):
    """-> (rel, noise, problems): each leaf's max abs difference over its own
    max |gradient|; each BatchNorm-fed bias's larger max |gradient| over its
    layer's largest weight gradient; what breaks ``rtol`` or
    BN_BIAS_NOISE, or has a gradient on one side only, or is not finite."""
    rel, noise, problems = {}, {}, []
    for n, a in cpu.items():
        b = card[n]
        if (a is None) != (b is None):
            problems.append(f"leaf {n} has a gradient on only one side")
            continue
        if a is None:
            continue
        if not torch.isfinite(b).all():
            problems.append(f"the card's gradient of {n} is not finite")
        elif n.endswith(".linear.bias") and \
                n.replace(".linear.bias", ".norm.weight") in cpu:
            w = float(cpu[n.replace(".bias", ".weight")].abs().max())
            noise[n] = max(float(a.abs().max()), float(b.abs().max())) / w
            if noise[n] > BN_BIAS_NOISE:
                problems.append(
                    f"{n} feeds a BatchNorm, so its gradient is zero but for "
                    f"rounding; it is {noise[n]:.3e} of its layer's largest "
                    f"weight gradient (tol {BN_BIAS_NOISE:g})")
        else:
            scale = float(a.abs().max())
            err = float((a - b).abs().max())
            rel[n] = err / scale if scale > 0 else err
            if rel[n] > rtol:
                problems.append(
                    f"the gradient of {n} differs between the CPU and the "
                    f"card by {err:.3e}, {rel[n]:.3e} of its max |value| "
                    f"{scale:.3e} (tol {rtol:g})")
    return rel, noise, problems


def compare_grads(cpu: dict, card: dict,
                  rtol: float = CPU_CARD_GRAD_RTOL) -> dict:
    """Step 0's gradients, the CPU's (plain versions) against the card's,
    both from the same weights and draws -> {"rel", "bn_bias_noise"} of
    :func:`grad_errors` at ``rtol``.  Fails on any problem, and unless the
    check would catch the card's gradient of one leaf off by 5 %."""
    rel, noise, problems = grad_errors(cpu, card, rtol)
    if problems:
        fail("step 0: " + "; ".join(problems))
    for n, ref in (("G_NeRF_net.fc9.norm.bias",) * 2,
                   ("G_NeRF_net.fc5.linear.bias",
                    "G_NeRF_net.fc5.linear.weight")):
        off = card[n] + 0.05 * cpu[ref].abs().max()
        if not grad_errors(cpu, {**card, n: off}, rtol)[2]:
            fail(f"step 0: the gradient check misses a 5 % error in {n}")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    log(f"  step 0, CPU against card: {len(rel)} leaf gradients, worst "
        f"relative {', '.join(f'{n} {v:.3e}' for n, v in worst[:3])} "
        f"(tol {rtol:g}), median "
        f"{float(np.median(list(rel.values()))):.3e}; {len(noise)} "
        f"BatchNorm-fed biases, largest noise "
        f"{max(noise.values(), default=0.0):.3e} (tol {BN_BIAS_NOISE:g})")
    return {"rel": rel, "bn_bias_noise": noise}


# --- hierarchical sampling (n_importance) --------------------------------------
# The flagship training config with the importance samples of the
# reference's 96 + 32, on the default trunk (pallas_trunk refuses them).
HIER_IMPORTANCE = 32
HIER_STEPS = 5                  # timed after one warm step
HIER_FOLD_REPS = 5
# 3 steps of a small float32 model (width 64, 64 rays x 32 + 16 samples)
# with n_importance, on the CPU and on the card from the same weights and
# draws.  float32, since the inverse CDF is discontinuous: a bf16 rounding
# of a coarse density can move a searchsorted bin, and with it a fine
# sample.  In float32 the two sides differ by the order of their sums
# (~1e-6 relative), which the SIREN layers (omega 30) take to ~1e-4 on the
# visibility, as between the JAX package and the port: the f32 bounds of
# tests/test_torch_train_step.py (losses 1e-4 relative, gradients 2e-3 of
# their largest value), taken 10x and 5x to leave room for a draw that falls
# within that difference of a CDF step and moves one of the 1,024 fine
# samples of a step to the next bin.
HIER_SMALL = dict(fc_units=64, batch_size=64, n_samples=32, n_importance=16,
                  compute_dtype="float32", pallas_trunk=False)
HIER_RTOL, HIER_ATOL = 1e-3, 1e-5
HIER_GRAD_RTOL = 1e-2


def hierarchical_path(device) -> dict:
    """Hierarchical sampling at full width: the flagship training config
    with ``n_importance=HIER_IMPORTANCE`` on the default trunk through
    ``Trainer`` on the synthetic site of ``bench.py``, one warm step and
    HIER_STEPS timed; each step's density-only coarse pass is one K3
    launch (eval mode, the running statistics).  Then the fold that pass
    rebuilds every step, timed alone; one step under the profiler;
    ``pallas_trunk`` with ``n_importance`` raising on the card; and the
    small float32 model on the CPU against the card."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.ops.rendering import running_statistics
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=6, img_size=48, grid=64, seed=0)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = flagship_train_config(pallas_trunk=False,
                                n_importance=HIER_IMPORTANCE)
    tr = Trainer(cfg, table, prior_hm=scene.prior_hm, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.trunk_apply.launches = 0
    losses = [tr.train_step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HIER_STEPS):
        losses.append(tr.train_step())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k3 = ft.trunk_apply.launches
    steps = HIER_STEPS + 1
    if tr.statics.n_importance != HIER_IMPORTANCE \
            or tr.statics.trunk_spec is not None:
        fail(f"the hierarchical step's statics: {tr.statics}")
    if k3 != steps:
        fail(f"{steps} hierarchical steps launched K3 {k3} times; each "
             f"step's coarse pass must launch it once")
    if not all(finite_losses(l) for l in losses):
        fail(f"non-finite loss: {losses}")
    report = dict(
        steps=steps, k3_launches=k3, n_importance=HIER_IMPORTANCE,
        points_per_step=cfg.batch_size * (cfg.n_samples + HIER_IMPORTANCE),
        coarse_points_per_step=cfg.batch_size * cfg.n_samples,
        step_ms=secs / HIER_STEPS * 1e3,
        train_rays_per_s=cfg.batch_size * HIER_STEPS / secs,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_loss={k: float(v) for k, v in losses[0].items()},
        last_loss={k: float(v) for k, v in losses[-1].items()})
    # the fold (and the bf16 kernel's tensor maps) the coarse pass builds
    # each step: the weights change between steps
    from season_nerf_torch.ops.fused_trunk import FusedTrunk

    def fold():
        folded = FusedTrunk(tr.model.G_NeRF_net).folded
        if folded.dtype == torch.bfloat16 and folded.weights[0].is_cuda:
            folded.tensor_maps()
        torch.cuda.synchronize()

    with running_statistics(tr.model):
        fold()
        t0 = time.perf_counter()
        for _ in range(HIER_FOLD_REPS):
            fold()
        report["fold_ms"] = (time.perf_counter() - t0) / HIER_FOLD_REPS * 1e3
    log(f"  {steps} steps with n_importance {HIER_IMPORTANCE} (default "
        f"trunk), K3 launches {k3}: {report['step_ms']:.1f} ms a step over "
        f"{HIER_STEPS} timed steps, {report['train_rays_per_s']:.0f} train "
        f"rays/s, peak {report['peak_mem_gb']:.2f} GB; the fold a step "
        f"rebuilds {report['fold_ms']:.2f} ms; Total "
        f"{report['first_loss']['Total']:.3f} -> "
        f"{report['last_loss']['Total']:.3f}")
    prof = profile_device(tr.train_step)
    report["profile_step"] = prof
    log_profile("one hierarchical training step", prof)
    del tr
    torch.cuda.empty_cache()

    # pallas_trunk does not take hierarchical sampling: on the card it raises
    tr = Trainer(flagship_train_config(n_importance=HIER_IMPORTANCE), table,
                 prior_hm=scene.prior_hm, device=device)
    try:
        tr.train_step()
    except ValueError as e:
        report["pallas_refusal"] = str(e)
        log(f"  pallas_trunk with n_importance on the card: ValueError: {e}")
    else:
        fail("pallas_trunk with n_importance > 0 did not raise on the card")
    del tr
    torch.cuda.empty_cache()

    report["cpu_vs_card"] = cpu_vs_card(
        table, scene.prior_hm, device, flagship_train_config(**HIER_SMALL),
        HIER_RTOL, HIER_ATOL, HIER_GRAD_RTOL)
    return report


# --- HSLuv ray colours (use_HSLuv) ----------------------------------------------
HSLUV_STEPS = 4
HSLUV_ROW_TOL = 1e-6            # float32 rounding of colours in [0, 1]


def hsluv_path(device) -> dict:
    """The train cell with ``use_HSLuv``: the synthetic site of
    ``bench.py`` in an HSLuv ray table (its colours against the host's
    float64 conversion of the RGB table's), HSLUV_STEPS flagship steps
    through K1/K2 and ``Trainer.run``'s save point at the last (the
    ``Testing`` losses and the validation report through K3), then the
    held-out view's render: sRGB, as its ground truth."""
    from season_nerf_torch.data.rays import build_ray_table, train_test_split
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.ops import fused_train as ftr
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.train.engine import Trainer
    from season_nerf_torch.utils.hsluv import (hsluv_normalized_to_rgb,
                                               rgb_to_hsluv_normalized)
    scene = make_scene(n_views=6, img_size=48, grid=64, seed=0)
    table = build_ray_table(scene.cameras, scene.images, use_hsluv=True)
    rgb = build_ray_table(scene.cameras, scene.images)
    row_err = float(np.abs(table.rows[:, 19:22] - rgb_to_hsluv_normalized(
        rgb.rows[:, 19:22].astype(np.float64))).max())
    if not np.array_equal(table.rows[:, :19], rgb.rows[:, :19]) \
            or row_err > HSLUV_ROW_TOL:
        fail(f"the HSLuv table's rows: colours {row_err:.3e} from the "
             f"host's conversion (tol {HSLUV_ROW_TOL:g})")
    train_idx, val_idx = train_test_split(len(scene.cameras), testing_size=1)
    tt, vt = table.split(train_idx), table.split(val_idx)
    report = {"rows": len(table), "row_err": row_err}
    with tempfile.TemporaryDirectory() as d:
        cfg = flagship_train_config(use_HSLuv=True, n_saves=1, logs_dir=d,
                                    max_train_steps=HSLUV_STEPS)
        tr = Trainer(cfg, tt, vt, prior_hm=scene.prior_hm, gt_dsm=scene.hm,
                     device=device)
        chunks = sum(-(-int((vt.img_ids == i).sum()) // 4096)
                     for i in range(len(vt.img_names)))
        want_k3 = len(tr.save_steps) * (2 + chunks)
        ft.trunk_apply.launches = 0
        ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
        tr.run()
        torch.cuda.synchronize()
        report.update(k3_launches=ft.trunk_apply.launches,
                      k1_launches=ftr.trunk_fwd.launches,
                      k2_launches=ftr.trunk_bwd.launches)
        if (report["k3_launches"], report["k1_launches"],
                report["k2_launches"]) != (want_k3, 2 * HSLUV_STEPS,
                                           HSLUV_STEPS):
            fail(f"HSLuv path launches {report}, want K3 {want_k3}, K1 "
                 f"{2 * HSLUV_STEPS}, K2 {HSLUV_STEPS}")
        psnr = read_metrics(d).get("Testing/Mean_PSNR", [])
        if not psnr or not all(np.isfinite(v) for _, v in psnr):
            fail(f"HSLuv save point: Testing/Mean_PSNR {psnr}")
        report["mean_psnr"] = psnr
        rend, gt, _, seen = tr.render_table_image(vt, 0)
    rows = vt.rows[vt.img_ids == 0]
    ij = rows[:, 0:2].astype(int)
    gt_err = float(np.abs(gt[ij[:, 0], ij[:, 1]] - hsluv_normalized_to_rgb(
        rows[:, 19:22])).max())
    if not (np.isfinite(rend[seen]).all() and rend.min() >= 0.0
            and rend.max() <= 1.0) or gt_err > HSLUV_ROW_TOL:
        fail(f"HSLuv validation render: range [{rend.min()}, {rend.max()}],"
             f" ground truth {gt_err:.3e} from sRGB")
    report.update(gt_err=gt_err, render_mean=float(rend[seen].mean()))
    log(f"  {len(table)} HSLuv rows ({row_err:.3e} from the host's float64 "
        f"conversion); {HSLUV_STEPS} steps, K1 {report['k1_launches']}, K2 "
        f"{report['k2_launches']}, K3 {report['k3_launches']}; Mean_PSNR "
        f"(sRGB) {psnr}; the held-out render in [{rend.min():.4f}, "
        f"{rend.max():.4f}], its ground truth sRGB")
    return report


# --- the sine's degree (FAST_SIN_DEGREE) ----------------------------------------
DEGREES = (9, 7)


def degree_check(device) -> dict:
    """In a process whose FAST_SIN_DEGREE selects a degree: build K3, K1
    and K2 at that degree, and hold each against its plain version (K3 at
    the flagship render chunk in bf16 with the polynomial sine, K1/K2 at
    the flagship training shape) with their times."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import cuda_build, fast_math
    from season_nerf_torch.ops import fused_train as ftr
    from season_nerf_torch.ops import fused_trunk as ft
    names = [ft.KERNEL, ftr.FWD_KERNEL, ftr.BWD_KERNEL]
    t0 = time.perf_counter()
    cuda_build.build(names)
    nvcc_s = time.perf_counter() - t0
    log(f"built {', '.join(names)} at degree {fast_math.DEGREE} in "
        f"{nvcc_s:.1f} s")
    ptxas = {n: [line.strip() for line in
                 cuda_build.ptxas_report(n).splitlines()
                 if "registers" in line or "spill" in line] for n in names}
    model = make_model(Config()).to(device)
    trunk = check_trunk(model, device, dtypes=(torch.bfloat16,),
                        sines=(True,), ns=(FLAGSHIP_N,))
    train = check_train_kernels(device, only=("flagship,bf16,fast_sin",))
    return {"degree": fast_math.DEGREE, "nvcc_s": nvcc_s, "ptxas": ptxas,
            "k3": trunk["trunk_infer[bfloat16,fast_sin]"][0],
            "k1k2": train["flagship,bf16,fast_sin"]}


def degree_children() -> dict:
    """:func:`degree_check` at each of DEGREES, one child process each,
    since the port reads FAST_SIN_DEGREE at import as the JAX package
    does; a child that fails fails the run."""
    out = {}
    for degree in DEGREES:
        env = {**os.environ, "FAST_SIN_DEGREE": str(degree)}
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--degree-child"],
            env=env, capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            log(f"  [degree {degree}] {line}")
        if proc.returncode != 0 or not lines:
            fail(f"the degree-{degree} child failed (rc {proc.returncode}): "
                 f"{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1])
        if rec["degree"] != degree:
            fail(f"the degree-{degree} child ran at degree {rec['degree']}")
        out[degree] = rec
    return out


# --- phase 6: the validation path ---------------------------------------------
# cli.run_train on bench.py's synthetic site (bench.py:95-96) with the
# flagship training config: VAL_STEPS steps with VAL_SAVES save points
VAL_STEPS = 40
VAL_SAVES = 4
VAL_CHUNK = 4096                # rays a validation render chunk
# A save point's render on the card (K3) against the CPU (plain versions):
# the image is held to RENDER_TOL; the heights and the PSNR are printed, not
# held: a flipped bf16 rounding moves a sample's density, and a pixel's
# expected surface, a ratio of sums over its samples, can move further than
# its color


def read_metrics(logs_dir: str) -> dict:
    """metrics.jsonl -> {tag: [(step, value), ...]} in the order written."""
    out = {}
    with open(os.path.join(logs_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def render_on(dev, cfg, tr, ckpt):
    """The first held-out image rendered on ``dev`` by a Trainer resumed
    from ``ckpt`` -> (image, heights, mask, PSNR)."""
    from season_nerf_torch.ops.metrics import psnr
    from season_nerf_torch.train.engine import Trainer
    from season_nerf_torch.utils.logging import MetricWriter
    other = Trainer(cfg, tr.train_ds.table, tr.val_table,
                    prior_hm=tr._prior_np, gt_dsm=tr.gt_dsm,
                    writer=MetricWriter(""), device=dev)
    other.resume(ckpt)
    rend, gt, height, seen = other.render_table_image(tr.val_table, 0)
    p = float(psnr(torch.from_numpy(rend), torch.from_numpy(gt),
                   mask=torch.from_numpy(seen)))
    return rend, height, seen, p


def validation_path(device, steps=VAL_STEPS, io_dir=None,
                    **model_kw) -> dict:
    """The validation path through ``cli.run_train`` (see the module
    docstring) in ``io_dir`` (None: a temporary directory); ``model_kw``
    shrinks the flagship config for a rehearsal.  The launch counts are set
    to 0 just before ``run_train`` and read just after it."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import get_opts
    from season_nerf_torch.ops import fused_train as ftr, fused_trunk as ft
    from season_nerf_torch.train import state as state_lib
    from season_nerf_torch.train.engine import Trainer
    report = {"steps": steps, "n_saves": VAL_SAVES}
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = flagship_train_config(
            site_name="SYNTH_VAL", exp_name="val", IO_Location=io_dir or tmp,
            synth_views=6, synth_img_size=48, synth_grid=64, testing_size=1,
            max_train_steps=steps, n_saves=VAL_SAVES,
            final_model_selection="best_geometry", **model_kw)
        cfg = get_opts([], defaults=cfg)
        restore = [_timed(Trainer, name, rec)
                   for name in ("run", "eval_losses", "validation_report")]
        try:
            ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
            ft.trunk_apply.launches = 0
            t0 = time.perf_counter()
            tr = cli.run_train(cfg, device=device)
            torch.cuda.synchronize()
            report["run_train_s"] = time.perf_counter() - t0
            k1, k2 = ftr.trunk_fwd.launches, ftr.trunk_bwd.launches
            k3 = ft.trunk_apply.launches
        finally:
            for r in restore:
                r()
        saves = sorted(tr.save_steps)
        n_saves = len(saves)
        chunks = int(sum(-(-int(c) // VAL_CHUNK)
                         for c in np.bincount(tr.val_table.img_ids)))
        want_k3 = n_saves * (2 + chunks) + chunks
        run_s = rec["run"][0]["s"]
        losses_s = [r["s"] for r in rec["eval_losses"]]
        report_s = [r["s"] for r in rec["validation_report"]]
        in_run = sum(losses_s) + sum(report_s[:n_saves])
        report.update(
            save_steps=saves, val_rows=len(tr.val_table),
            chunks_per_report=chunks, k1_launches=k1, k2_launches=k2,
            k3_launches=k3, k3_launches_implied=want_k3, run_s=run_s,
            eval_losses_s=losses_s, validation_report_s=report_s,
            validation_in_run_s=in_run, training_s=run_s - in_run,
            validation_per_save_point_s=in_run / n_saves,
            validation_share_of_run=in_run / run_s)
        log(f"  {steps} steps, save points {saves}; K1 launches {k1}, "
            f"K2 {k2}, K3 {k3} (the chunking implies {want_k3}: "
            f"{n_saves} x (2 + {chunks}) + {chunks})")
        # a site this small says nothing of what validation costs a
        # deployment: phase 7's save point measures that
        log(f"  seconds at this size ({len(tr.val_table)} held-out rays; "
            f"the validation layer's metric comes from the real-site "
            f"phase): run_train {report['run_train_s']:.2f}, Trainer.run "
            f"{run_s:.2f} = training {report['training_s']:.2f} + validation "
            f"{in_run:.3f} ({100 * report['validation_share_of_run']:.1f} %; "
            f"{report['validation_per_save_point_s']:.3f} a save point: "
            f"losses {[round(x, 3) for x in losses_s]}, reports "
            f"{[round(x, 3) for x in report_s]}, the last after finalize)")
        if k1 != 2 * steps or k2 != steps:
            fail(f"{steps} steps launched K1 {k1} and K2 {k2} times")
        if k3 != want_k3:
            fail(f"the validation path launched K3 {k3} times; the chunking "
                 f"implies {want_k3}")

        tr.writer.flush()          # the report after finalize included
        logged = read_metrics(cfg.logs_dir)
        per_step = {}
        for tag, vals in logged.items():
            if tag.startswith("Testing/"):
                for step, v in vals:
                    per_step.setdefault(step, {}).setdefault(tag[8:], v)
        need = ("Total", "Color", "Mean_PSNR", "Mean_Height_Error",
                "Prior_Height_Error")
        for step in saves:
            got = per_step.get(step, {})
            bad = [k for k in need if not np.isfinite(got.get(k, np.nan))]
            bad += [k for k, v in got.items() if not np.isfinite(v)]
            if bad:
                fail(f"save point {step}: Testing values missing or not "
                     f"finite: {bad} in {got}")
        report["testing"] = {s_: per_step[s_] for s_ in saves}
        report["logs_dir"] = cfg.logs_dir

        # the same run's TensorBoard records: every scalar of
        # metrics.jsonl, and each report's render and height map of every
        # held-out view (a report a save point, one more after finalize)
        events = read_event_files(cfg.logs_dir)
        n_scalars = sum(len(v) for v in events["scalars"].values())
        n_images = sum(len(v) for v in events["images"].values())
        n_views = len(tr.val_table.img_names)
        want_images = len(report_s) * n_views * 2
        want_scalars = sum(len(v) for v in logged.values())
        report["tensorboard"] = {
            "files": events["files"], "scalar_events": n_scalars,
            "image_events": n_images, "images_implied": want_images,
            "scalars_in_jsonl": want_scalars,
            "image_steps": sorted({s_ for v in events["images"].values()
                                   for s_, _, _ in v})}
        log(f"  TensorBoard: {events['files']} event file(s), every CRC "
            f"holds; {n_scalars} scalar events (metrics.jsonl {want_scalars}"
            f"), {n_images} image events ({len(report_s)} reports x "
            f"{n_views} views x 2 = {want_images}) at steps "
            f"{report['tensorboard']['image_steps']}")
        if events["file_version"] != ["brain.Event:2"] * events["files"] \
                or events["files"] < 1 or n_images != want_images \
                or n_scalars != want_scalars \
                or not set(saves) <= set(report["tensorboard"]
                                         ["image_steps"]):
            fail(f"the TensorBoard records do not match the run: "
                 f"{report['tensorboard']}")
        for s_ in saves:
            t = per_step[s_]
            log(f"  save point {s_}: Testing/Total {t['Total']:.4f}, "
                f"Color {t['Color']:.5f}, Mean_PSNR {t['Mean_PSNR']:.3f}, "
                f"Mean_Height_Error {t['Mean_Height_Error']:.4f}, "
                f"Prior_Height_Error {t['Prior_Height_Error']:.4f}")

        # the selection: the save point of the lowest logged score
        prior_err = {s_: per_step[s_]["Prior_Height_Error"] for s_ in saves}
        best = min(saves, key=lambda s_: prior_err[s_])
        final = os.path.join(cfg.logs_dir, "Final_Model.nn")
        sd, meta = state_lib.load_model_artifact(final)
        ckpt = os.path.join(cfg.logs_dir, f"Model_{best}.nn")
        ck = state_lib.load_checkpoint(ckpt)["model"]
        same = all(torch.equal(v, ck[k].to(v.dtype)) for k, v in sd.items())
        report.update(selected_step=meta.get("selected_step"),
                      argmin_step=best, final_equals_checkpoint=same)
        log(f"  Final_Model.nn: selected step {meta.get('selected_step')} "
            f"(argmin of the logged Prior_Height_Error {best}), its weights "
            f"equal Model_{best}.nn's: {same}")
        if meta.get("selected_step") != best or not same:
            fail(f"finalize chose {meta}, the logged scores {prior_err}")

        # one save point on the card and on the CPU from its checkpoint
        last = os.path.join(cfg.logs_dir, f"Model_{saves[-1]}.nn")
        t0 = time.perf_counter()
        card = render_on(device, cfg, tr, last)
        report["card_render_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = render_on("cpu", cfg, tr, last)
        report["cpu_render_s"] = time.perf_counter() - t0
        seen = cpu[2]
        img_err = float(np.abs(card[0] - cpu[0])[seen].max())
        h_err = np.abs(card[1] - cpu[1])[seen]
        report["card_vs_cpu"] = {
            "step": saves[-1], "pixels": int(seen.sum()),
            "image_max_abs": img_err, "tol": RENDER_TOL,
            "height_max_abs": float(h_err.max()),
            "height_mean_abs": float(h_err.mean()),
            "psnr_card": card[3], "psnr_cpu": cpu[3]}
        log(f"  save point {saves[-1]} rendered on the card and on the CPU "
            f"(plain versions) from its checkpoint: image max abs difference "
            f"{img_err:.3e} (tol {RENDER_TOL}), heights max "
            f"{float(h_err.max()):.3e} mean {float(h_err.mean()):.3e}, PSNR "
            f"{card[3]:.4f} against {cpu[3]:.4f}; the CPU took "
            f"{report['cpu_render_s']:.1f} s")
        if not np.array_equal(card[2], seen) or not img_err <= RENDER_TOL \
                or not np.isfinite(card[1][seen]).all():
            fail("the card's validation render disagrees with the CPU's")
        del tr
    torch.cuda.empty_cache()
    return report


# --- the evaluation after training: cli.run_test, analyze_model -------------
# Phase 6 drives cli.run_test (training EVAL_STEPS flagship steps with
# EVAL_SAVES save points and best_geometry, then the evaluation at the JAX
# defaults) and run_test(eval_only=True) at EVAL_ONLY_SIZE, then repeats the
# model's analysis on the card and on the CPU (plain versions) at CPU_EVAL,
# the ground-truth height map taken every CPU_EVAL_HM_STRIDE-th cell (the
# CPU's plain bf16 trunk runs some 10^4 points a second at width 512).
EVAL_STEPS = 8
EVAL_SAVES = 2
EVAL_ONLY_SIZE = (16, 16)
CPU_EVAL = dict(img_size=(12, 12), walk_size=6)
CPU_EVAL_HM_STRIDE = 5
# Card (K3, the batched scorers on the device) against CPU (plain
# versions) on the same weights and inputs: the image scores (L2, PSNR,
# SSIM, EM) within ANALYSIS_SCORE_RTOL of max(1, |CPU value|), the height
# scores (MAE, RMSE, median) within ANALYSIS_HM_TOL_M meters.  Both run the
# same bf16 arithmetic in other orders (K3 against its plain version: x_enc
# within TOL), which moves a render by ~1e-3 (RENDER_TOL's measured
# 1.05e-3) and a column's expected height by about as much of the range.
# Where the two choose another alignment (the seasonal candidate or the
# height shift), the scores that follow the choice are not held and the
# runner-up gap that explains it is printed.
ANALYSIS_SCORE_RTOL = 5e-3
ANALYSIS_HM_TOL_M = 1e-3
OUTPUT_FILES = ("Height_Maps.png", "HM_scores.txt", "Image_scores.txt",
                "Time_Walk.gif", "Solar_Walk.gif")
CHUNK_COLS = 4096                   # density_surface's columns a K3 call


def analysis_k3_launches(cams, test_idx, img_size, walk_size, hm_shape,
                         chunk) -> int:
    """K3 launches ``analyze_model`` implies: one per ``chunk`` rays that
    ``camera_grid_rays`` keeps of each test view, one per ``chunk`` rays of
    each walk frame, one per CHUNK_COLS columns of the height map."""
    from season_nerf_torch.eval.walks import get_walking_points
    from season_nerf_torch.render.renderer import camera_grid_rays
    views = sum(-(-camera_grid_rays(cams[i], img_size)[0].shape[0]
                  // chunk) for i in test_idx)
    _, sun, times = get_walking_points(cams, 3, 5, 12, min_day_sep=0)
    walks = (len(sun) + len(times)) * -(-walk_size * walk_size // chunk)
    cols = -(-int(np.prod(hm_shape)) // CHUNK_COLS) if hm_shape else 0
    return views + walks + cols


def analysis_problems(analysis, out_dir, test_names) -> list:
    """What is wrong with an analysis and its ``Output/``: non-finite
    scores, missing files."""
    bad = []
    for part in ("Before", "After"):
        for k, v in analysis.get("HM", {}).get(part, {}).items():
            if k != "Shift_x_y_deg" and not np.isfinite(v):
                bad.append(f"HM {part} {k} = {v}")
    for name, e in analysis["Images"].items():
        for variant, scores in e["Scores"].items():
            if not np.all(np.isfinite(scores)):
                bad.append(f"{name} {variant} = {scores}")
    for imgs in (analysis["Solar_Walk"], analysis["Season_Walk"]["imgs"]):
        if not all(np.isfinite(im).all() for im in imgs):
            bad.append("a walk frame is not finite")
    need = set(OUTPUT_FILES) | {f"{n}_comparison.png" for n in test_names}
    bad += [f"Output/ lacks {f}"
            for f in sorted(need - set(os.listdir(out_dir)))]
    return bad


def compare_analyses(card, cpu, card_align, cpu_align,
                     score_rtol=ANALYSIS_SCORE_RTOL,
                     hm_tol_m=ANALYSIS_HM_TOL_M) -> dict:
    """The card's analysis against the CPU's (see ANALYSIS_SCORE_RTOL;
    ``score_rtol`` and ``hm_tol_m`` set the two tolerances) -> {"worst":
    largest differences, "problems": what exceeds them, "notes": differing
    choices and their runner-up gaps}."""
    worst = {"image_score_rel": 0.0, "hm_m": 0.0}
    problems, notes = [], []
    b_card, b_cpu = card["HM"]["After"], cpu["HM"]["After"]
    same_shift = b_card["Shift_x_y_deg"] == b_cpu["Shift_x_y_deg"]
    if not same_shift:
        notes.append(f"height alignment: card {b_card['Shift_x_y_deg']} "
                     f"(RMSE {b_card['RMSE']:.5f} m), CPU "
                     f"{b_cpu['Shift_x_y_deg']} (RMSE {b_cpu['RMSE']:.5f} m)"
                     f"; before alignment RMSE "
                     f"{card['HM']['Before']['RMSE']:.5f} against "
                     f"{cpu['HM']['Before']['RMSE']:.5f} m")
    for part in ("Before",) + (("After",) if same_shift else ()):
        for k in ("MAE", "RMSE", "Median"):
            d = abs(card["HM"][part][k] - cpu["HM"][part][k])
            worst["hm_m"] = max(worst["hm_m"], d)
            if not d <= hm_tol_m:
                problems.append(f"HM {part} {k}: {card['HM'][part][k]} "
                                f"against {cpu['HM'][part][k]}")
        worst[f"acc_1_m_{part}"] = abs(card["HM"][part]["Acc_1_m"]
                                       - cpu["HM"][part]["Acc_1_m"])
    for i, (name, e_cpu) in enumerate(cpu["Images"].items()):
        e_card = card["Images"][name]
        t_card, t_cpu = e_card["Aligned_Vals"][2], e_cpu["Aligned_Vals"][2]
        same_t = t_card == t_cpu
        if not same_t:
            gaps = []
            for who, rec in (("card", card_align[i]), ("CPU", cpu_align[i])):
                err = np.sort(rec["out"][2])
                gaps.append(f"{who} runner-up {(err[1] - err[0]) / err[0]:.3e}"
                            f" relative")
            notes.append(f"{name}: aligned time {t_card:.4f} on the card, "
                         f"{t_cpu:.4f} on the CPU; " + ", ".join(gaps))
        for variant, s_cpu in e_cpu["Scores"].items():
            if variant.startswith("Aligned") and not same_t:
                continue
            for m, a, b in zip(("L2", "PSNR", "SSIM", "EM"),
                               e_card["Scores"][variant], s_cpu):
                rel = abs(a - b) / max(1.0, abs(b))
                worst["image_score_rel"] = max(worst["image_score_rel"], rel)
                if not rel <= score_rtol:
                    problems.append(f"{name} {variant} {m}: {a} against {b}")
    return {"worst": worst, "problems": problems, "notes": notes}


# The regional evaluation (regional_eval into Detailed_Output/): the
# card's (K3) against the CPU's (plain versions) at CPU_REGIONAL, the
# shadow test at its quick sizes (16 x 16 ground points, 6 across the
# angles) and CPU_REGIONAL's samples, the quick sizes' 48, so that the
# surface and the sun rays go through K3 at the shapes the main path gives
# it (SURFACE_N and SUN_ANGLE_N points a call): height scores within
# REGIONAL_HM_TOL_M (the bf16 density's differences move a column's
# expected height in proportion to the samples' spacing: at 8 samples,
# 3.75 m of the 30 m range apart, the median moved 1.34e-3 m), image
# scores within REGIONAL_SCORE_RTOL relative
# (the same aligned time and shift, else the choice is reported as in
# compare_analyses), the shadow test's Loss and Avg_Error within
# SHADOW_ERR_TOL, its rates within SHADOW_RATE_TOL (bf16 re-rounding
# moves samples across the 0.5 threshold; Avg_Offset, the mean change of
# a ray's lit count, within SHADOW_RATE_TOL samples a sample of the ray),
# the season walk's EM statistics within SEASON_RTOL relative (Sinkhorn
# on renders ~1e-3 apart) and the prototype baseline equal (host LPs on
# the same images).
CPU_REGIONAL = dict(img_size=(12, 12), season_size=(8, 8), hm_samples=48)
REGIONAL_HM_TOL_M = 5e-4
REGIONAL_SCORE_RTOL = 1e-3
SHADOW_ERR_TOL = 1e-4
SHADOW_RATE_TOL = 2e-3
SEASON_RTOL = 1e-3
DETAILED_FILES = ("Data_Sat_and_Sun_pose.png", "Prototypical_Imgs.png",
                  "HM_Summary.pickle", "HM_scores.txt", "Height_Maps.png",
                  "Img_Summary.pickle", "Image_scores.txt",
                  "Shadow_Scores_Summary.pickle", "Shadow_scores.txt",
                  "Season_Summary.pickle", "Season_scores.txt",
                  "Region_Results.pickle")
MERGED_FILES = ("All_HM_scores.txt", "All_Image_scores.txt",
                "All_Shadow_scores.txt", "All_Season_scores.txt",
                "Merged_Results.pickle")
SHADOW_RATES = ("Acc", "Prec_Sun", "Recall_Sun", "Prec_Shadow",
                "Recall_Shadow")


def regional_k3_launches(cams, test_idx, img_size, season_size, hm_shape,
                         chunk) -> int:
    """K3 launches ``regional_eval`` (quick) implies: one per CHUNK_COLS
    columns of the height map, one per ``chunk`` rays that
    ``camera_grid_rays`` keeps of each test view, one ``forward_solar``
    per sun angle of the shadow test's four sets, one per ``chunk`` rays
    of each season render."""
    from season_nerf_torch.eval.walks import (get_walking_points,
                                              shadow_walk_points)
    from season_nerf_torch.render.renderer import camera_grid_rays
    held = set(test_idx)
    cols = -(-int(np.prod(hm_shape)) // CHUNK_COLS) if hm_shape else 0
    views = sum(-(-camera_grid_rays(cams[i], img_size)[0].shape[0]
                  // chunk) for i in test_idx)
    sets = shadow_walk_points([c for i, c in enumerate(cams) if i not in held],
                              [cams[i] for i in test_idx], 16, 6)
    angles = sum(len(v) for k, v in sets.items() if k != "Ground_Points")
    v, s, t = get_walking_points(cams, 3, 3, 4, 20.0)
    season = (len(v) * len(s) * len(t)
              * -(-season_size[0] * season_size[1] // chunk))
    return cols + views + angles + season


def regional_problems(results, out_dir) -> list:
    """What is wrong with a regional evaluation: non-finite scores (a rate
    without a denominator is NaN in both packages and not counted),
    missing files of ``Detailed_Output/``."""
    bad = []
    for part in ("Before", "After", "Prior"):
        for k, v in (results.get("HM", {}).get(part) or {}).items():
            if k != "Shift_x_y_deg" and not np.isfinite(v):
                bad.append(f"HM {part} {k} = {v}")
    for name, e in results["Images"]["Per_Image"].items():
        for variant, scores in e["Scores"].items():
            if not np.all(np.isfinite(scores)):
                bad.append(f"{name} {variant} = {scores}")
    for name, st in results["Shadows"].items():
        for k in ("Acc", "Loss", "Avg_Error", "Avg_Offset"):
            if not np.isfinite(st[k]):
                bad.append(f"shadows {name} {k} = {st[k]}")
    for k, v in results["Seasons"]["Stability"].items():
        if not np.isfinite(v):
            bad.append(f"season stability {k} = {v}")
    bad += [f"Detailed_Output/ lacks {f}"
            for f in sorted(set(DETAILED_FILES) - set(os.listdir(out_dir)))]
    return bad


def compare_regionals(card, cpu, card_align, cpu_align, hm_samples,
                      season_rtol=SEASON_RTOL) -> dict:
    """The card's regional results against the CPU's (see CPU_REGIONAL;
    ``season_rtol`` sets the season statistics' tolerance) ->
    compare_analyses's dict, with the shadow and season claims."""
    views = lambda r: {"HM": r["HM"], "Images": r["Images"]["Per_Image"]}
    out = compare_analyses(views(card), views(cpu), card_align, cpu_align,
                           score_rtol=REGIONAL_SCORE_RTOL,
                           hm_tol_m=REGIONAL_HM_TOL_M)
    worst, problems = out["worst"], out["problems"]
    for k, v in (cpu["HM"]["Prior"] or {}).items():
        if card["HM"]["Prior"][k] != v:
            problems.append(f"prior DSM {k}: {card['HM']['Prior'][k]} "
                            f"against {v} (host arithmetic)")
    worst.update(shadow_err=0.0, shadow_rate=0.0, shadow_offset=0.0,
                 season_rel=0.0)
    for name, s_cpu in cpu["Shadows"].items():
        s_card = card["Shadows"][name]
        for keys, tol, w in ((("Loss", "Avg_Error"), SHADOW_ERR_TOL,
                              "shadow_err"),
                             (SHADOW_RATES, SHADOW_RATE_TOL, "shadow_rate"),
                             (("Avg_Offset",), SHADOW_RATE_TOL * hm_samples,
                              "shadow_offset")):
            for k in keys:
                a, b = s_card[k], s_cpu[k]
                if np.isnan(a) and np.isnan(b):
                    continue
                d = abs(a - b)
                worst[w] = max(worst[w], d)
                if not d <= tol:
                    problems.append(f"shadows {name} {k}: {a} against {b}")
    for k, b in cpu["Seasons"]["Stability"].items():
        a = card["Seasons"]["Stability"][k]
        rel = abs(a - b) / abs(b)
        worst["season_rel"] = max(worst["season_rel"], rel)
        if not rel <= season_rtol:
            problems.append(f"season stability {k}: {a} against {b}")
    b_card, b_cpu = card["Seasons"]["Baseline"], cpu["Seasons"]["Baseline"]
    if not np.array_equal(b_card, b_cpu, equal_nan=True):
        problems.append(f"baseline EM: {b_card} against {b_cpu}")
    return out


def evaluation_path(device, steps=EVAL_STEPS, cpu_eval=CPU_EVAL,
                    eval_size=None, cpu_regional=CPU_REGIONAL,
                    **model_kw) -> dict:
    """``cli.run_test`` end to end (``eval_size`` its ``eval_img_size``,
    None the JAX defaults; the analysis, then ``regional_eval`` at its
    quick sizes) and with ``eval_only`` on the synthetic site of
    ``bench.py``, then ``cli eval_region`` on its model directory, then
    the model's analysis and its regional evaluation on the card against
    the CPU (see the constants above).  The launch counts are set to 0
    just before each ``run_test`` and ``eval_region`` and read just after
    it."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import get_opts
    from season_nerf_torch.eval import img_eval, regional
    from season_nerf_torch.ops import fused_train as ftr, fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.renderer import Renderer
    from season_nerf_torch.train import state as state_lib
    report = {"steps": steps, "n_saves": EVAL_SAVES}
    with tempfile.TemporaryDirectory() as io_dir:
        cfg = flagship_train_config(
            site_name="SYNTH_VAL", exp_name="test", IO_Location=io_dir,
            synth_views=6, synth_img_size=48, synth_grid=64, testing_size=1,
            max_train_steps=steps, n_saves=EVAL_SAVES,
            final_model_selection="best_geometry", **model_kw)
        cfg = get_opts([], defaults=cfg)
        cams, table, _, test_idx, prior, gt, h_range, _, _ = \
            cli.prepare_synthetic(cfg)
        names = [cams[i].name for i in test_idx]
        out_dir = os.path.join(cfg.logs_dir, "Output")
        detailed = os.path.join(cfg.logs_dir, "Detailed_Output")
        season = (64, 64)                   # regional_eval's quick size

        ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        tr, analysis = cli.run_test(cfg, eval_img_size=eval_size,
                                    device=device)
        torch.cuda.synchronize()
        report["run_test_s"] = time.perf_counter() - t0
        k1, k2 = ftr.trunk_fwd.launches, ftr.trunk_bwd.launches
        k3 = ft.trunk_apply.launches
        n_saves = len(tr.save_steps)
        chunks = int(sum(-(-int(c) // VAL_CHUNK)
                         for c in np.bincount(tr.val_table.img_ids)))
        img, walk = ((256, 256), 128) if eval_size is None else (
            tuple(eval_size), eval_size[0])
        want_k3 = (n_saves * (2 + chunks) + chunks + analysis_k3_launches(
            cams, test_idx, img, walk, gt.shape, cfg.chunk)
            + regional_k3_launches(cams, test_idx, img, season, gt.shape,
                                   cfg.chunk))
        report.update(k1_launches=k1, k2_launches=k2, k3_train_and_eval=k3,
                      k3_implied=want_k3)
        log(f"  cli.run_test ({steps} steps, save points "
            f"{sorted(tr.save_steps)}, then the evaluation at {img} and "
            f"{walk} px walks, then regional_eval at {img}, season walk "
            f"{season}): {report['run_test_s']:.1f} s; K1 {k1}, K2 "
            f"{k2}, K3 {k3} launches (the chunking implies {want_k3})")
        with open(os.path.join(detailed, "Region_Results.pickle"),
                  "rb") as f:
            region = pickle.load(f)
        bad = (analysis_problems(analysis, out_dir, names)
               + regional_problems(region, detailed))
        if k1 != 2 * steps or k2 != steps or k3 != want_k3 or bad:
            fail(f"cli.run_test: K1 {k1}, K2 {k2}, K3 {k3} (implied "
                 f"{want_k3}); {bad}")
        _, meta = state_lib.load_model_artifact(
            os.path.join(cfg.logs_dir, "Final_Model.nn"))
        log(f"  Output/: {sorted(os.listdir(out_dir))}; Final_Model.nn "
            f"holds step {meta.get('selected_step', meta.get('steps'))}; "
            f"Image_Summary Aligned_Img PSNR "
            f"{analysis['Image_Summary']['Aligned_Img']['PSNR']['avg']:.3f},"
            f" HM RMSE {analysis['HM']['After']['RMSE']:.3f} m")
        log(f"  Detailed_Output/: {sorted(os.listdir(detailed))}; shadow "
            f"Full_Walk Acc {region['Shadows']['Full_Walk']['Acc']:.4f}, "
            f"season walk EM mean "
            f"{region['Seasons']['Stability']['mean']:.4f}, prior DSM RMSE "
            f"{region['HM']['Prior']['RMSE']:.3f} m")
        del tr

        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        _, small = cli.run_test(cfg, eval_only=True,
                                eval_img_size=EVAL_ONLY_SIZE, device=device)
        torch.cuda.synchronize()
        report["eval_only_s"] = time.perf_counter() - t0
        report["k3_eval_only"] = ft.trunk_apply.launches
        want = (analysis_k3_launches(cams, test_idx, EVAL_ONLY_SIZE,
                                     EVAL_ONLY_SIZE[0], gt.shape, cfg.chunk)
                + regional_k3_launches(cams, test_idx, EVAL_ONLY_SIZE,
                                       season, gt.shape, cfg.chunk))
        with open(os.path.join(detailed, "Region_Results.pickle"),
                  "rb") as f:
            region = pickle.load(f)
        bad = (analysis_problems(small, out_dir, names)
               + regional_problems(region, detailed))
        log(f"  cli.run_test(eval_only=True) at {EVAL_ONLY_SIZE}: "
            f"{report['eval_only_s']:.1f} s, K3 {report['k3_eval_only']} "
            f"launches (implied {want})")
        if report["k3_eval_only"] != want or bad or set(small) != set(
                analysis):
            fail(f"run_test(eval_only=True): K3 {report['k3_eval_only']} "
                 f"(implied {want}), {bad}, keys {sorted(small)}")

        # cli eval_region, the port of main_eval_region.py, at its defaults
        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["eval_region", "--Model_Locations", cfg.logs_dir,
                       "--device", str(device)])
        torch.cuda.synchronize()
        report["eval_region_s"] = time.perf_counter() - t0
        report["k3_eval_region"] = ft.trunk_apply.launches
        want = (analysis_k3_launches(cams, test_idx, (256, 256), 128,
                                     gt.shape, cfg.chunk)
                + regional_k3_launches(cams, test_idx, (256, 256), season,
                                       gt.shape, cfg.chunk))
        summary = os.path.join(os.path.dirname(cfg.logs_dir), "Full_Summary")
        found = sorted(os.listdir(summary)) if os.path.isdir(summary) else []
        merged = {}
        if "Merged_Results.pickle" in found:
            with open(os.path.join(summary, "Merged_Results.pickle"),
                      "rb") as f:
                merged = pickle.load(f)
        finite = all(np.isfinite(v) for kind in ("HM", "Seasons")
                     for scores in merged.get(kind, {}).values()
                     for k, v in scores.items() if k != "Shift_x_y_deg")
        log(f"  cli eval_region on the model directory: rc {rc}, "
            f"{report['eval_region_s']:.1f} s, K3 {report['k3_eval_region']}"
            f" launches (implied {want}); Full_Summary/: {found}")
        if rc != 0 or report["k3_eval_region"] != want \
                or sorted(MERGED_FILES) != found or not finite \
                or not all(merged.get(k) for k in ("HM", "Images", "Shadows",
                                                   "Seasons")):
            fail(f"cli eval_region: rc {rc}, K3 {report['k3_eval_region']} "
                 f"(implied {want}), Full_Summary/ {found}, merged "
                 f"{ {k: list(v) for k, v in merged.items()} }")
        report["k3_launches"] = (k3 + report["k3_eval_only"]
                                 + report["k3_eval_region"])

        # the same model's analysis on the card and on the CPU
        gt_small = gt[::CPU_EVAL_HM_STRIDE, ::CPU_EVAL_HM_STRIDE]
        runs = {}
        for dev in (device, "cpu"):
            loaded = load_model_dir(cfg.logs_dir, device=dev)
            r = Renderer(loaded.model, n_samples=cfg.n_samples,
                         chunk=cfg.chunk, classic_solar=cfg.Solar_Type_2)
            rec = {}
            restore = _timed(img_eval, "align_errors", rec)
            t0 = time.perf_counter()
            try:
                an = regional.analyze_model(
                    r, r.model, cams, test_idx, gt_small, h_range,
                    os.path.join(io_dir, f"an_{dev}"),
                    hm_samples=cfg.n_samples, **cpu_eval)
            finally:
                restore()
            runs[str(dev)] = (an, rec["align_errors"],
                              time.perf_counter() - t0)
            del loaded, r
        card_an, card_align, card_s = runs[str(device)]
        cpu_an, cpu_align, cpu_s = runs["cpu"]
        cmp_ = compare_analyses(card_an, cpu_an, card_align, cpu_align)
        report["card_vs_cpu"] = {"worst": cmp_["worst"],
                                 "notes": cmp_["notes"], "card_s": card_s,
                                 "cpu_s": cpu_s, **cpu_eval,
                                 "hm_shape": list(gt_small.shape)}
        log(f"  analysis on the card and on the CPU (plain versions) at "
            f"{cpu_eval}, height map {gt_small.shape}: image scores within "
            f"{cmp_['worst']['image_score_rel']:.3e} relative (tol "
            f"{ANALYSIS_SCORE_RTOL:g}), height scores within "
            f"{cmp_['worst']['hm_m']:.3e} m (tol {ANALYSIS_HM_TOL_M:g}); "
            f"the CPU took {cpu_s:.1f} s, the card {card_s:.1f} s")
        for note in cmp_["notes"]:
            log(f"    differing choice: {note}")
        if cmp_["problems"]:
            fail(f"the card's analysis disagrees with the CPU's: "
                 f"{cmp_['problems']}")

        # the same model's regional evaluation on the card and on the CPU
        runs = {}
        for dev in (device, "cpu"):
            loaded = load_model_dir(cfg.logs_dir, device=dev)
            r = Renderer(loaded.model, n_samples=cfg.n_samples,
                         chunk=cfg.chunk, classic_solar=cfg.Solar_Type_2)
            rec = {}
            restore = _timed(img_eval, "align_errors", rec)
            t0 = time.perf_counter()
            try:
                res = regional.regional_eval(
                    r, r.model, cams, test_idx, gt, prior, h_range,
                    os.path.join(io_dir, f"region_{dev}"), **cpu_regional)
            finally:
                restore()
            runs[str(dev)] = (res, rec["align_errors"],
                              time.perf_counter() - t0)
            del loaded, r
        card_res, card_align, card_s = runs[str(device)]
        cpu_res, cpu_align, cpu_s = runs["cpu"]
        cmp_ = compare_regionals(card_res, cpu_res, card_align, cpu_align,
                                 cpu_regional["hm_samples"])
        report["regional_card_vs_cpu"] = {
            "worst": cmp_["worst"], "notes": cmp_["notes"], "card_s": card_s,
            "cpu_s": cpu_s, **{k: list(v) if isinstance(v, tuple) else v
                              for k, v in cpu_regional.items()},
            "hm_shape": list(gt.shape)}
        w = cmp_["worst"]
        log(f"  regional_eval on the card and on the CPU at {cpu_regional}, "
            f"shadows at 16 x 16 points: height scores within "
            f"{w['hm_m']:.3e} m (tol {REGIONAL_HM_TOL_M:g}), image scores "
            f"within {w['image_score_rel']:.3e} relative (tol "
            f"{REGIONAL_SCORE_RTOL:g}); shadow Loss/Avg_Error within "
            f"{w['shadow_err']:.3e} (tol {SHADOW_ERR_TOL:g}), rates within "
            f"{w['shadow_rate']:.3e} (tol {SHADOW_RATE_TOL:g}), Avg_Offset "
            f"within {w['shadow_offset']:.3e}; season EM within "
            f"{w['season_rel']:.3e} relative (tol {SEASON_RTOL:g}); the CPU "
            f"took {cpu_s:.1f} s, the card {card_s:.1f} s")
        for note in cmp_["notes"]:
            log(f"    differing choice: {note}")
        if cmp_["problems"]:
            fail(f"the card's regional evaluation disagrees with the "
                 f"CPU's: {cmp_['problems']}")
    torch.cuda.empty_cache()
    return report


# --- phase 7: the real-site path ----------------------------------------------
# A DFC2019-format site fabricated from SEED: SITE_VIEWS GeoTIFFs of
# SITE_PX^2 px at SITE_GSD m a pixel, affine RPCs (parallax by each view's
# off-nadir angle) fitted as in tests/conftest.py::_toy_rpc, IMDs, and a
# lidar DSM at DSM_GSD m with its UTM sidecar.  The surface: gentle ground
# near 215 m and SITE_BUILDINGS soft-edged buildings 8-33 m high; the
# images: a multi-scale texture of the ground, tinted by each view's date.
SITE_NAME = "OMA_900"
SITE_VIEWS = 10
SITE_PX = 2048
SITE_GSD = 0.3
SITE_LAT, SITE_LON = 39.0, -83.95
SITE_HALF_M = 400.0                 # the RPCs' and the scene's half extent
SITE_BUILDINGS = 40
DSM_GSD = 0.5
M_PER_DEG_LAT = 111_000.0
SITE_STEPS = 5                      # timed steps after run_train's warm one
SITE_RENDER_PX = 64
SITE_VAL_DOWN = 8                   # the held-out views' downscale (lite)
# The card's sweep against the CPU's (both this port) over the site's
# first 4 z-slices: the same f32 arithmetic in other orders (FMA
# contraction in the projection and the bilinear weights); a pixel
# coordinate near 2048 carries ~1e-4 px of f32 rounding, so a few 1e-6 of
# a score.  Held to 1e-4.
SWEEP_TOL = 1e-4
# the carve of a known surface: the JAX package's own bar
# (tests/test_priors.py::test_space_carving_recovers_heightfield)
CARVE_TOL = 0.25


def _tiff_entry(order, tag, typ, values, extra_off):
    """-> (the 12-byte entry, bytes that go to the offset area)."""
    code, size = {3: ("H", 2), 4: ("I", 4), 12: ("d", 8)}[typ]
    raw = struct.pack(order + code * len(values), *values)
    head = struct.pack(order + "HHI", tag, typ, len(values))
    if len(raw) <= 4:
        return head + raw.ljust(4, b"\0"), b""
    return head + struct.pack(order + "I", extra_off), raw


def tiff_bytes(arr: np.ndarray, rpc_values=None) -> bytes:
    """An uncompressed little-endian TIFF of ``arr`` ([H, W, 3] uint8 or
    [H, W] float32) in strips of 64 rows, with ``rpc_values`` (92 doubles)
    as tag 50844 when given.  What ``data/io.read_tiff`` and PIL read."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    spp = arr.shape[2] if arr.ndim == 3 else 1
    bits, fmt = {np.dtype(np.uint8): (8, 1),
                 np.dtype(np.float32): (32, 3)}[arr.dtype]
    per = 64
    strips = [arr[r:r + per].astype(arr.dtype.newbyteorder("<")).tobytes()
              for r in range(0, h, per)]
    offsets = list(np.cumsum([8] + [len(s) for s in strips[:-1]]))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [1]), (262, 3, [2 if spp == 3 else 1]),
            (273, 4, [int(o) for o in offsets]), (277, 3, [spp]),
            (278, 4, [per]), (279, 4, [len(s) for s in strips]),
            (284, 3, [1]), (339, 3, [fmt] * spp)]
    if rpc_values is not None:
        tags.append((50844, 12, [float(v) for v in rpc_values]))
    ifd_off = 8 + sum(len(s) for s in strips)
    ifd_off += ifd_off % 2
    extra_off = ifd_off + 2 + 12 * len(tags) + 4
    entries, extra = b"", b""
    for tag, typ, values in tags:
        entry, raw = _tiff_entry("<", tag, typ, values, extra_off + len(extra))
        entries += entry
        extra += raw + b"\0" * (len(raw) % 2)
    body = b"".join(strips)
    return (b"II" + struct.pack("<HI", 42, ifd_off) + body
            + b"\0" * (ifd_off - 8 - len(body))
            + struct.pack("<H", len(tags)) + entries + struct.pack("<I", 0)
            + extra)


def rpc_tag_values(rpc) -> list:
    """An RPCModel as the 92 doubles of TIFF tag 50844."""
    return ([0.0, 0.0, rpc.row_offset, rpc.col_offset, rpc.lat_offset,
             rpc.lon_offset, rpc.alt_offset, rpc.row_scale, rpc.col_scale,
             rpc.lat_scale, rpc.lon_scale, rpc.alt_scale]
            + [float(v) for v in np.concatenate(
                [rpc.row_num, rpc.row_den, rpc.col_num, rpc.col_den])])


def rpc_text(rpc) -> str:
    """An RPCModel as an ``.ikono`` text (``KEY_n: value`` lines)."""
    lines = [f"LINE_OFF: {rpc.row_offset}", f"SAMP_OFF: {rpc.col_offset}",
             f"LAT_OFF: {rpc.lat_offset}", f"LONG_OFF: {rpc.lon_offset}",
             f"HEIGHT_OFF: {rpc.alt_offset}", f"LINE_SCALE: {rpc.row_scale}",
             f"SAMP_SCALE: {rpc.col_scale}", f"LAT_SCALE: {rpc.lat_scale}",
             f"LONG_SCALE: {rpc.lon_scale}", f"HEIGHT_SCALE: {rpc.alt_scale}"]
    for prefix, vec in [("LINE_NUM_COEFF", rpc.row_num),
                        ("LINE_DEN_COEFF", rpc.row_den),
                        ("SAMP_NUM_COEFF", rpc.col_num),
                        ("SAMP_DEN_COEFF", rpc.col_den)]:
        lines += [f"{prefix}_{i + 1}: {v:.17e}" for i, v in enumerate(vec)]
    return "\n".join(lines)


class SiteScene:
    """The fabricated surface and texture over local meters (east, north)
    from (SITE_LAT, SITE_LON), evaluated with torch on ``device``."""

    def __init__(self, seed, device):
        rng = np.random.default_rng(seed)
        self.device = device
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.centres = t(rng.uniform(-0.8, 0.8, (SITE_BUILDINGS, 2))
                         * SITE_HALF_M)
        self.halves = t(rng.uniform(6.0, 30.0, (SITE_BUILDINGS, 2)))
        self.tall = t(rng.uniform(8.0, 33.0, SITE_BUILDINGS))
        self.phases = t(rng.uniform(0, 2 * np.pi, (3, 4)))

    def heights(self, east, north):
        h = 215.0 + 2.0 * torch.sin(east / 90.0) * torch.cos(north / 70.0)
        top = torch.zeros_like(east)
        for (cx, cy), (hx, hy), th in zip(self.centres, self.halves,
                                          self.tall):
            inside = (torch.sigmoid((hx - (east - cx).abs()) / 0.5)
                      * torch.sigmoid((hy - (north - cy).abs()) / 0.5))
            top = torch.maximum(top, th * inside)
        return h + top

    def albedo(self, east, north):
        ch = []
        for c in range(3):
            p = self.phases[c]
            ch.append(0.5 + 0.18 * torch.sin(east / 7.3 + p[0])
                      * torch.cos(north / 5.1 + p[1])
                      + 0.12 * torch.sin((east + north) / 2.3 + p[2])
                      + 0.08 * torch.cos((east - 2 * north) / 1.1 + p[3]))
        return torch.stack(ch, -1)


def fabricate_site(io_dir: str, views: int, px: int, device) -> dict:
    """Write the DFC-format site under ``io_dir`` -> {views' metadata}."""
    from season_nerf_torch.geometry import rpc as rpc_lib
    from season_nerf_torch.geometry.units import wgs84_to_utm
    rng = np.random.default_rng(SEED + 100)
    scene = SiteScene(SEED + 101, device)
    m_lon = M_PER_DEG_LAT * np.cos(np.deg2rad(SITE_LAT))
    imgs = os.path.join(io_dir, "IEEE_Data", "Images")
    truth = os.path.join(io_dir, "IEEE_Data", "Track3-Truth")
    cache = os.path.join(io_dir, "Cache", SITE_NAME)
    rpcs = os.path.join(cache, "RPCs")
    for d in (imgs, truth, rpcs):
        os.makedirs(d, exist_ok=True)
    # the surface as a 0.25 m raster, which the images are ray-cast against
    n_r = int(2 * SITE_HALF_M / 0.25)
    axis = (torch.arange(n_r, device=device, dtype=torch.float32) + 0.5) \
        * 0.25 - SITE_HALF_M
    E, N = torch.meshgrid(axis, axis, indexing="xy")     # [north, east]
    raster = scene.heights(E, N)
    lookup = lambda e, n: raster[
        ((n + SITE_HALF_M) / 0.25).long().clamp(0, n_r - 1),
        ((e + SITE_HALF_M) / 0.25).long().clamp(0, n_r - 1)]
    meta = []
    rr, cc = torch.meshgrid(torch.arange(px, device=device,
                                         dtype=torch.float32),
                            torch.arange(px, device=device,
                                         dtype=torch.float32), indexing="ij")
    for i in range(views):
        off = float(rng.uniform(4.0, 30.0))
        vaz = float(rng.uniform(0.0, 360.0))
        dn, de = rng.uniform(-20.0, 20.0, 2)
        pr, pc = (np.tan(np.deg2rad(off)) / SITE_GSD
                  * np.array([np.cos(np.deg2rad(vaz)),
                              np.sin(np.deg2rad(vaz))]))
        month = 1 + (i * 11) // max(views - 1, 1)
        sun_el, sun_az = float(rng.uniform(25, 70)), float(rng.uniform(120,
                                                                       240))

        def project(lat, lon, alt, dn=dn, de=de, pr=pr, pc=pc):
            north = (lat - SITE_LAT) * M_PER_DEG_LAT - dn
            east = (lon - SITE_LON) * m_lon - de
            return (north / SITE_GSD + px / 2 + (alt - 230.0) * pr,
                    east / SITE_GSD + px / 2 + (alt - 230.0) * pc)

        half_lat = SITE_HALF_M / M_PER_DEG_LAT
        half_lon = SITE_HALF_M / m_lon
        rpc = rpc_lib.fit_rpc_from_projector(
            project, (SITE_LAT - half_lat, SITE_LAT + half_lat),
            (SITE_LON - half_lon, SITE_LON + half_lon), (200.0, 260.0))
        # ray-cast every pixel down from 262 m in 0.25 m steps
        hit = torch.full_like(rr, 205.0)
        found = torch.zeros_like(rr, dtype=torch.bool)
        for alt in np.arange(262.0, 205.0, -0.25):
            n = (rr - px / 2 - (alt - 230.0) * pr) * SITE_GSD + dn
            e = (cc - px / 2 - (alt - 230.0) * pc) * SITE_GSD + de
            now = (~found) & (lookup(e, n) >= alt)
            hit = torch.where(now, torch.full_like(hit, float(alt)), hit)
            found |= now
        n = (rr - px / 2 - (hit - 230.0) * pr) * SITE_GSD + dn
        e = (cc - px / 2 - (hit - 230.0) * pc) * SITE_GSD + de
        tint = torch.tensor([1.0, 1.0 + 0.25 * np.sin(np.pi * month / 12),
                             1.0], device=device)
        img = (scene.albedo(e, n) * tint).clamp(0, 1) * 255
        name = f"{SITE_NAME}_{i:03d}_RGB"
        with open(os.path.join(imgs, name + ".tif"), "wb") as f:
            f.write(tiff_bytes(img.round().to(torch.uint8).cpu().numpy(),
                               rpc_tag_values(rpc)))
        with open(os.path.join(cache, f"rpc_{name}_original.ikono"),
                  "w") as f:
            f.write(rpc_text(rpc))
        with open(os.path.join(rpcs, name + ".IMD"), "w") as f:
            f.write(f"meanSunAz = {sun_az};\nmeanSunEl = {sun_el};\n"
                    f"meanOffNadirViewAngle = {off};\nmeanSatAz = {vaz};\n"
                    f"firstLineTime = 2016-{month:02d}-15T16:{i:02d}:30"
                    f".000000Z;\n")
        meta.append({"name": name, "off_nadir": off, "view_az": vaz,
                     "month": month, "sun_el": sun_el, "sun_az": sun_az,
                     "shift_m": [float(dn), float(de)],
                     "cast_hit_share": float(found.float().mean())})
    # the lidar DSM: UTM-aligned, row 0 at its southern edge, its pixels'
    # lat/lon by the local linearization of wgs84_to_utm at the centre
    e0, n0, _, _ = wgs84_to_utm(SITE_LAT, SITE_LON)
    d = 1e-4
    e_la, n_la, _, _ = wgs84_to_utm(SITE_LAT + d, SITE_LON)
    e_lo, n_lo, _, _ = wgs84_to_utm(SITE_LAT, SITE_LON + d)
    J = np.array([[e_la - e0, e_lo - e0], [n_la - n0, n_lo - n0]]) / d
    n_d = int(2 * SITE_HALF_M / DSM_GSD)
    g = np.arange(n_d) * DSM_GSD - SITE_HALF_M
    GE, GN = np.meshgrid(g, g, indexing="xy")
    lat_lon = np.linalg.solve(J, np.stack([GE.ravel(), GN.ravel()]))
    north = torch.tensor(lat_lon[0] * M_PER_DEG_LAT, dtype=torch.float32,
                         device=device)
    east = torch.tensor(lat_lon[1] * m_lon, dtype=torch.float32,
                        device=device)
    dsm = scene.heights(east, north).reshape(n_d, n_d).cpu().numpy()
    with open(os.path.join(truth, f"{SITE_NAME}_DSM.tif"), "wb") as f:
        f.write(tiff_bytes(dsm.astype(np.float32)))
    np.savetxt(os.path.join(truth, f"{SITE_NAME}_DSM.txt"),
               [e0 - SITE_HALF_M, n0 - SITE_HALF_M, n_d, DSM_GSD])
    return {"views": meta, "dsm_range_m": [float(dsm.min()),
                                          float(dsm.max())]}


def _timed(module, name, record, cuda_events=False, label=None):
    """Wrap ``module.name`` so that each call's seconds (or, with
    ``cuda_events``, device ms by CUDA events) and its arguments land in
    ``record[label or name]``; returns a function that restores it."""
    orig = getattr(module, name)
    key = label or name

    def wrapper(*args, **kw):
        if cuda_events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kw)
            end.record()
            end.synchronize()
            record.setdefault(key, []).append(
                {"ms": start.elapsed_time(end), "args": args, "kw": kw})
        else:
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            record.setdefault(key, []).append(
                {"s": time.perf_counter() - t0, "args": args, "kw": kw,
                 "out": out})
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def carve_recovers_surface(device) -> float:
    """The sweep on ``device`` and the graph cut recover a known surface:
    the median height error over the score grid."""
    from season_nerf_torch.data.synthetic import hm_lookup, make_scene
    from season_nerf_torch.priors import space_carving as sc
    scene = make_scene(n_views=6, img_size=64, grid=48, seed=2)
    scores = sc.plane_sweep_scores(scene.cameras, scene.images, (24, 24, 16),
                                   patch=5, cell_chunk=512, device=device)
    hm = sc.scores_to_heightmap(scores)
    xs = (np.linspace(-1, 1, 25)[:-1] + np.linspace(-1, 1, 25)[1:]) / 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    return float(np.median(np.abs(hm - hm_lookup(scene.hm, X, Y))))


def site_analysis(device, cfg, prep, img_size=(256, 256),
                  walk_size=128) -> dict:
    """``analyze_model`` + ``write_analysis_outputs`` of the model directory
    ``cfg.logs_dir`` on ``prep`` (what ``cli.prepare_real`` returned) at
    the JAX defaults, twice: first with each part timed (the density
    surface by CUDA events; the greedy alignment, the component renders,
    their compositing into images, the seasonal alignment, the gauntlet
    with its EMD LPs, the walks, the pickle and ``Output/`` by the host
    clock around calls that end in a copy to the host), the K3 count set
    to 0 just before and read just after; then again under
    ``torch.profiler`` for the device's busy share."""
    from season_nerf_torch.eval import hm_eval, img_eval, regional
    from season_nerf_torch.geometry.units import angles_to_vec_from_site
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.renderer import Renderer
    cams, _, _, test_idx, _, gt, h_range, wc, S = prep
    names = [cams[i].name for i in test_idx]
    renderer = Renderer(load_model_dir(cfg.logs_dir, device=device).model,
                        n_samples=cfg.n_samples, chunk=cfg.chunk,
                        classic_solar=cfg.Solar_Type_2)
    out_dir = os.path.join(cfg.logs_dir, "Output")
    rec, box = {}, {}
    restore = [_timed(hm_eval, "density_surface", rec, cuda_events=True),
               _timed(hm_eval, "greedy_align", rec),
               _timed(Renderer, "component_render_by_camera", rec),
               _timed(img_eval, "images_from_components", rec),
               _timed(img_eval, "seasonal_align", rec),
               _timed(img_eval, "image_quality_gauntlet", rec),
               _timed(Renderer, "render_img", rec),
               _timed(regional, "_dump", rec),
               _timed(regional, "write_analysis_outputs", rec)]

    def run():
        box["analysis"] = regional.analyze_model(
            renderer, renderer.model, cams, test_idx, gt, h_range,
            cfg.logs_dir, hm_samples=cfg.n_samples, img_size=img_size,
            walk_size=walk_size, angles_to_vec=angles_to_vec_from_site(wc,
                                                                       S))
        regional.write_analysis_outputs(box["analysis"], out_dir)

    try:
        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = ft.trunk_apply.launches
    finally:
        for r in restore:
            r()
    analysis = box["analysis"]
    secs = lambda name: float(sum(r["s"] for r in rec[name]))
    comps = [r["out"] for r in rec["component_render_by_camera"]]
    prof = profile_device(run)
    report = {
        "img_size": list(img_size), "walk_size": walk_size,
        "hm_shape": list(gt.shape), "hm_samples": cfg.n_samples,
        "test_views": names,
        "rays_kept": [int(c["img_pts"].shape[0]) for c in comps],
        "component_host_bytes": [int(sum(v.nbytes for v in c.values()
                                         if isinstance(v, np.ndarray)))
                                 for c in comps],
        "wall_s": wall,
        "profiled_wall_s": prof["wall_ms"] / 1e3,
        "device_busy_s": prof["device_busy_ms"] / 1e3,
        "idle_share": prof["idle_share"],
        "density_surface_device_ms": rec["density_surface"][0]["ms"],
        "greedy_align_s": secs("greedy_align"),
        "greedy_steps": float(np.abs(
            analysis["HM"]["After"]["Shift_x_y_deg"]).sum()),
        "component_renders_s": secs("component_render_by_camera"),
        "images_from_components_s": secs("images_from_components"),
        "seasonal_align_s": secs("seasonal_align"),
        "gauntlet_s": secs("image_quality_gauntlet"),
        "gauntlet_calls": len(rec["image_quality_gauntlet"]),
        "walks_s": secs("render_img"),
        "walk_frames": len(rec["render_img"]),
        "pickle_s": secs("_dump"),
        "output_s": secs("write_analysis_outputs"),
        "k3_launches": k3,
        "k3_implied": analysis_k3_launches(cams, test_idx, img_size,
                                           walk_size, gt.shape, cfg.chunk),
        "hm_before": analysis["HM"]["Before"],
        "hm_after": analysis["HM"]["After"],
        "image_summary": analysis["Image_Summary"]}
    del rec, comps
    log(f"  analysis at {tuple(img_size)} of {len(names)} held-out views "
        f"(rays kept {report['rays_kept']}, per-sample components "
        f"{[round(b / 1e9, 3) for b in report['component_host_bytes']]} GB "
        f"on the host), {report['walk_frames']} walk frames at {walk_size} "
        f"px, height map {tuple(gt.shape)} x {cfg.n_samples} samples: "
        f"{report['wall_s']:.2f} s; again under the profiler "
        f"{report['profiled_wall_s']:.2f} s, device busy "
        f"{report['device_busy_s']:.2f} s (idle share "
        + (f"{report['idle_share']:.3f})" if report["idle_share"] is not None
           else "not measured: the profiler traced no device time)"))
    log(f"    density surface {report['density_surface_device_ms']:.1f} ms "
        f"(device, CUDA events); greedy_align {report['greedy_align_s']:.2f}"
        f" s ({report['greedy_steps']:g} unit moves); component renders "
        f"{report['component_renders_s']:.2f} s, composited into images "
        f"{report['images_from_components_s']:.2f} s; seasonal_align "
        f"{report['seasonal_align_s']:.2f} s; gauntlet with the EMD LPs "
        f"{report['gauntlet_s']:.2f} s ({report['gauntlet_calls']} calls); "
        f"walks {report['walks_s']:.2f} s; Analysis.pickle "
        f"{report['pickle_s']:.2f} s; Output/ {report['output_s']:.2f} s")
    log(f"    K3 launches {k3} (the chunking implies {report['k3_implied']});"
        f" HM RMSE {report['hm_before']['RMSE']:.3f} m before alignment, "
        f"{report['hm_after']['RMSE']:.3f} m after "
        f"{report['hm_after']['Shift_x_y_deg']}; Aligned_Img PSNR avg "
        f"{report['image_summary']['Aligned_Img']['PSNR']['avg']:.3f}")
    bad = analysis_problems(analysis, out_dir, names)
    if k3 != report["k3_implied"] or bad:
        fail(f"the real site's analysis: K3 {k3} (implied "
             f"{report['k3_implied']}), {bad}")
    return report


def site_regional(device, cfg, prep, img_size=None, season_size=None,
                  hm_samples=None) -> dict:
    """``regional_eval`` (quick; the sizes override it) of the model
    directory ``cfg.logs_dir`` on ``prep`` (what ``cli.prepare_real``
    returned: the site is not ingested again) into its
    ``Detailed_Output/``, twice: first with the seconds of each part (host
    clock around calls that end in a copy to the host) and K3's launches
    (the count set to 0 just before, read just after) against the
    chunking; then again under ``torch.profiler`` for the device's busy
    share."""
    from season_nerf_torch.eval import (hm_eval, img_eval, regional,
                                        reports, season_eval, shadow_eval,
                                        summary_images)
    from season_nerf_torch.geometry.units import angles_to_vec_from_site
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.render.loading import load_model_dir
    from season_nerf_torch.render.renderer import Renderer
    cams, _, _, test_idx, prior, gt, h_range, wc, S = prep
    renderer = Renderer(load_model_dir(cfg.logs_dir, device=device).model,
                        n_samples=cfg.n_samples, chunk=cfg.chunk,
                        classic_solar=cfg.Solar_Type_2)
    out_dir = os.path.join(cfg.logs_dir, "Detailed_Output")
    parts = (("overview figures", summary_images, "angle_scatter"),
             ("overview figures", summary_images, "proto_time_plot"),
             ("HM surface", hm_eval, "density_surface"),
             ("greedy_align", hm_eval, "greedy_align"),
             ("image renders", Renderer, "component_render_by_camera"),
             ("compositing (images)", img_eval, "images_from_components"),
             ("alignment", img_eval, "seasonal_align"),
             ("gauntlet", img_eval, "image_quality_gauntlet"),
             ("shadow angles", shadow_eval, "eval_shadow_angles"),
             ("season renders", Renderer, "component_render_by_dir"),
             ("compositing (season walk)", season_eval,
              "images_from_components"),
             ("season EM (signatures, Sinkhorn batch)", season_eval,
              "season_stability"),
             ("prototype baseline (exact LPs)", season_eval,
              "prototype_baseline_em"),
             ("pickles and reports", regional, "_dump"),
             ("pickles and reports", regional, "_write_hm_outputs"),
             ("pickles and reports", reports, "image_report"),
             ("pickles and reports", reports, "shadow_report"),
             ("pickles and reports", reports, "season_report"))
    rec, box = {}, {}
    sizes = dict(img_size=img_size, season_size=season_size,
                 hm_samples=hm_samples)

    def run():
        box["results"] = regional.regional_eval(
            renderer, renderer.model, cams, test_idx, gt, prior, h_range,
            out_dir, quick=True, angles_to_vec=angles_to_vec_from_site(wc, S),
            **sizes)

    restore = [_timed(owner, name, rec, label=label)
               for label, owner, name in parts]
    try:
        ft.trunk_apply.launches = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = ft.trunk_apply.launches
    finally:
        for r in restore:
            r()
    by_part = {label: {"s": float(sum(r["s"] for r in calls)),
                       "calls": len(calls)} for label, calls in rec.items()}
    del rec
    res = box["results"]
    prof = profile_device(run)
    img = tuple(img_size or (256, 256))
    season = tuple(season_size or (64, 64))
    report = {
        "img_size": list(img), "season_size": list(season),
        "hm_samples": hm_samples or 48, "hm_shape": list(gt.shape),
        "wall_s": wall, "profiled_wall_s": prof["wall_ms"] / 1e3,
        "device_busy_s": prof["device_busy_ms"] / 1e3,
        "idle_share": prof["idle_share"], "by_part": by_part,
        "rest_s": wall - sum(v["s"] for v in by_part.values()),
        "greedy_steps": float(np.abs(res["HM"]["After"]["Shift_x_y_deg"])
                              .sum()),
        "k3_launches": k3,
        "k3_implied": regional_k3_launches(cams, test_idx, img, season,
                                           gt.shape, cfg.chunk),
        "hm_after": res["HM"]["After"], "prior": res["HM"]["Prior"],
        "shadows": res["Shadows"], "season": res["Seasons"]["Stability"],
        "baseline": res["Seasons"]["Baseline"].tolist()}
    log(f"  regional_eval (quick: {len(test_idx)} views at {img}, height "
        f"map {tuple(gt.shape)} x {report['hm_samples']}, shadows at 16 x 16"
        f" points, season walk at {season}): {wall:.2f} s; again under the "
        f"profiler {report['profiled_wall_s']:.2f} s, device busy "
        f"{report['device_busy_s']:.2f} s (idle share "
        + (f"{report['idle_share']:.3f})" if report["idle_share"] is not None
           else "not measured: the profiler traced no device time)"))
    for label, v in sorted(by_part.items(), key=lambda kv: -kv[1]["s"]):
        log(f"    {v['s']:8.3f} s  {100 * v['s'] / wall:5.1f} %  {label} "
            f"({v['calls']} calls)")
    log(f"    {report['rest_s']:8.3f} s  the rest (scores, signatures, "
        f"resizes, the shadow statistics)")
    log(f"    K3 launches {k3} (the chunking implies "
        f"{report['k3_implied']}); greedy_align {report['greedy_steps']:g} "
        f"unit moves; HM RMSE {report['hm_after']['RMSE']:.3f} m, prior DSM"
        f" RMSE {report['prior']['RMSE']:.3f} m; shadow Full_Walk Acc "
        f"{report['shadows']['Full_Walk']['Acc']:.4f}; season EM mean "
        f"{report['season']['mean']:.4f}, baseline {report['baseline']}")
    bad = regional_problems(res, out_dir)
    if k3 != report["k3_implied"] or bad:
        fail(f"the real site's regional evaluation: K3 {k3} (implied "
             f"{report['k3_implied']}), {bad}")
    return report


def real_site_path(device, views=SITE_VIEWS, px=SITE_PX, steps=SITE_STEPS,
                   analysis_kw=None, regional_kw=None, **model_kw) -> dict:
    """The real-site main path: fabricate a DFC-format site, then
    ``cli.run_train`` on it (ingest, camera fits, bounds, the ray table
    with its cache, the lidar DSM, the Space_Carve prior swept on the card,
    one warm step of the flagship config through K1/K2, ``finalize`` and
    the validation report), ``steps`` more timed steps, one more step
    through ``Trainer.run`` that ends in a save point (the ``Testing``
    losses, the validation report of the held-out views, the checkpoint),
    ``finalize`` again and ``render_pretrained`` of the written model
    directory through K3; then the model's evaluation
    (:func:`site_analysis`, ``analysis_kw`` its sizes) and its regional
    evaluation (:func:`site_regional`, ``regional_kw`` its sizes).  The
    launch counts are set to 0 just before ``run_train`` and read just
    after the render, and again around each evaluation."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import Config, get_opts
    from season_nerf_torch.data import ingest, lidar, rays
    from season_nerf_torch.ops import fused_train as ftr, fused_trunk as ft
    from season_nerf_torch.priors import graph_cut, space_carving as sc
    from season_nerf_torch.train import phases as phase_lib
    from season_nerf_torch.train.engine import Trainer
    report = {"views": views, "px": px}
    rec = {}
    analysis_kw = analysis_kw or {}
    regional_kw = regional_kw or {}
    with tempfile.TemporaryDirectory() as io_dir:
        t0 = time.perf_counter()
        report["site"] = fabricate_site(io_dir, views, px, device)
        report["fabricate_s"] = time.perf_counter() - t0
        log(f"  fabricated {SITE_NAME}: {views} views of {px} x {px} px at "
            f"{SITE_GSD} m, lidar DSM {report['site']['dsm_range_m']} m, in "
            f"{report['fabricate_s']:.1f} s")
        cfg = flagship_train_config(site_name=SITE_NAME, exp_name="site",
                                    IO_Location=io_dir, DSM_Mode="Space_Carve",
                                    img_training_downscale=1,
                                    img_validation_downscale=SITE_VAL_DOWN,
                                    **model_kw)
        cfg = get_opts([], defaults=cfg)
        restore = [_timed(cli, "prepare_real", rec),
                   _timed(ingest, "preprocess_site", rec),
                   _timed(rays, "build_ray_table", rec),
                   _timed(rays.RayTable, "save", rec),
                   _timed(sc, "plane_sweep_scores", rec, cuda_events=True),
                   _timed(graph_cut, "aexpansion_grid", rec)]
        restore += [_timed(Trainer, name, rec) for name in
                    ("eval_losses", "validation_report", "save_checkpoint")]
        try:
            ftr.trunk_fwd.launches = ftr.trunk_bwd.launches = 0
            ft.trunk_apply.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = cli.run_train(cfg, train_steps=1, device=device)
            torch.cuda.synchronize()
            report["run_train_s"] = time.perf_counter() - t0
            losses = []
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(tr.train_step())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            # a save point in the run: the next step is one
            save_step = tr.step + 1
            tr.save_steps.add(save_step)
            t0 = time.perf_counter()
            tr.run(n_steps=1)
            torch.cuda.synchronize()
            report["save_step_s"] = time.perf_counter() - t0
            tr.finalize()
            t0 = time.perf_counter()
            shown, _ = cli.render_pretrained(
                cfg.logs_dir, (70.0, 30.0), (45.0, 180.0), "07/01",
                out_size=SITE_RENDER_PX, device=device)
            report["render_s"] = time.perf_counter() - t0
            k1, k2 = ftr.trunk_fwd.launches, ftr.trunk_bwd.launches
            k3 = ft.trunk_apply.launches
        finally:
            for r in restore:
                r()
        site = rec["preprocess_site"][0]["out"]
        table = rec["build_ray_table"][0]["out"]
        sweep = rec["plane_sweep_scores"][0]
        prior = tr.prior_hm.cpu().numpy()
        wc, S, h_range = ingest.load_w2c_w2l(
            os.path.join(cfg.logs_dir, "W2C_W2L_H.npy"))
        # the prior against the lidar DSM on the prior's grid, in meters
        gt = lidar.get_gt_dsm(os.path.join(cfg.root_dir, "Track3-Truth"),
                              SITE_NAME, prior.shape, site.bounds_lla)
        to_m = (site.bounds_lla[2][1] - site.bounds_lla[2][0]) / 2
        report.update(
            ingest_s=rec["preprocess_site"][0]["s"],
            fit_px=site.accuracy, bounds_lla=site.bounds_lla.tolist(),
            ray_rows=len(table), ray_table_host_bytes=table.rows.nbytes,
            train_rows=tr.train_ds.n,
            ray_table_device_bytes=(tr.train_ds.rows.numel()
                                    * tr.train_ds.rows.element_size()),
            ray_table_build_s=rec["build_ray_table"][0]["s"],
            ray_table_save_s=rec["save"][0]["s"],
            sweep_grid=list(sweep["args"][2]), sweep_ms=sweep["ms"],
            graph_cut_s=rec["aexpansion_grid"][0]["s"],
            prior_range=[float(np.nanmin(prior)), float(np.nanmax(prior))],
            prior_vs_lidar_median_m=float(np.nanmedian(np.abs(prior - gt))
                                          * to_m),
            step_ms=secs / steps * 1e3,
            train_rays_per_s=cfg.batch_size * steps / secs,
            k1_launches=k1, k2_launches=k2, k3_launches=k3,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            last_loss={k: float(v) for k, v in losses[-1].items()},
            world_center=None if wc is None else list(map(float, wc)),
            h_range=h_range)
        log(f"  ingest {report['ingest_s']:.1f} s; projective fit "
            f"reprojection error mean {site.accuracy['mean_px']:.3e} px, max "
            f"{site.accuracy['max_px']:.3e} px")
        log(f"  ray table: {report['ray_rows']} rows ({report['train_rows']} "
            f"training rows, {report['ray_table_device_bytes'] / 1e9:.3f} GB "
            f"on the card), built in {report['ray_table_build_s']:.1f} s, of "
            f"which np.savez_compressed {report['ray_table_save_s']:.1f} s")
        log(f"  Space_Carve: sweep grid {report['sweep_grid']} on the card in "
            f"{report['sweep_ms']:.1f} ms (CUDA events), graph cut "
            f"{report['graph_cut_s']:.1f} s, prior in "
            f"[{report['prior_range'][0]:.4f}, {report['prior_range'][1]:.4f}]"
            f", median |prior - lidar DSM| "
            f"{report['prior_vs_lidar_median_m']:.2f} m")
        log(f"  training: {report['step_ms']:.1f} ms a step over {steps} "
            f"timed steps, {report['train_rays_per_s']:.0f} train rays/s, "
            f"K1 launches {k1}, K2 launches {k2}, peak memory "
            f"{report['peak_mem_gb']:.2f} GB; Total "
            f"{report['last_loss']['Total']:.4f}")
        n_steps = steps + 2
        if tr.statics.trunk_spec is None:
            fail("the real-site run did not take the fused trunk")
        if k1 != 2 * n_steps or k2 != n_steps:
            fail(f"{n_steps} steps launched K1 {k1} and K2 {k2} times")
        if not all(finite_losses(l) for l in losses):
            fail(f"non-finite loss on the real site: {losses[-1]}")
        if not np.isfinite(prior).all() or prior.min() < -1 \
                or prior.max() > 1:
            fail(f"the Space_Carve prior is not finite in [-1, 1]: "
                 f"{report['prior_range']}")
        if wc is None or S is None:
            fail("the real site's W2C_W2L_H.npy has no world frame")
        val_chunks = int(sum(-(-int(c) // VAL_CHUNK)
                             for c in np.bincount(tr.val_table.img_ids)))
        # run_train's report, then the save point's losses (2) and report
        want_k3 = (-(-SITE_RENDER_PX * SITE_RENDER_PX // cfg.chunk)
                   + 2 * val_chunks + 2)
        if k3 != want_k3 or shown.shape != (SITE_RENDER_PX, SITE_RENDER_PX,
                                            3) \
                or not np.isfinite(shown).all():
            fail(f"render_pretrained, the validation report and the save "
                 f"point of the real site: K3 launches {k3} (the chunking "
                 f"implies {want_k3}), shape {shown.shape}, finite "
                 f"{np.isfinite(shown).all()}")
        log(f"  render_pretrained of the model directory at "
            f"{SITE_RENDER_PX} px: mean {float(shown.mean()):.4f}, "
            f"{report['render_s']:.2f} s; K3 launches {k3} with two "
            f"validation reports ({val_chunks} chunks each) and the save "
            f"point's 2 loss passes")

        # the save point at full size: the metric of the validation layer
        testing = {tag[8:]: v for tag, vals in read_metrics(cfg.logs_dir)
                   .items() if tag.startswith("Testing/")
                   for st, v in vals if st == save_step}
        val = rec["validation_report"][-1]["out"]
        losses_s = rec["eval_losses"][-1]["s"]
        report_s = rec["validation_report"][-1]["s"]
        ckpt_s = rec["save_checkpoint"][-1]["s"]
        val_s = losses_s + report_s
        val_rows = len(tr.val_table)
        # projected onto the flagship schedule (Config(): max_train_steps
        # steps, its n_saves split over the phases): training at this
        # run's step time, every save point at this one's validation
        # seconds, and at img_validation_downscale=1, linear in the rays
        dep = Config()
        n_dep = len(phase_lib.save_points(tr.phases, dep.n_saves,
                                          dep.max_train_steps))
        train_dep_s = dep.max_train_steps * secs / steps
        full_s = losses_s + report_s * SITE_VAL_DOWN ** 2
        report.update(
            val_rows=val_rows, val_chunks=val_chunks, save_step=save_step,
            validation=val, testing=testing,
            save_point={"eval_losses_s": losses_s,
                        "validation_report_s": report_s,
                        "checkpoint_s": ckpt_s,
                        "validation_s": val_s,
                        "report_rays_per_s": val_rows / report_s},
            flagship_schedule={
                "max_train_steps": dep.max_train_steps,
                "save_points": n_dep, "training_s": train_dep_s,
                "validation_share": n_dep * val_s
                / (train_dep_s + n_dep * val_s),
                "downscale_1_save_point_s": full_s,
                "downscale_1_validation_share": n_dep * full_s
                / (train_dep_s + n_dep * full_s)})
        fs = report["flagship_schedule"]
        log(f"  save point at step {save_step} on the "
            f"{len(tr.val_table.img_names)} held-out views at "
            f"1/{SITE_VAL_DOWN} ({val_rows} rays, {val_chunks} K3 chunks): "
            f"Testing losses {losses_s:.3f} s + validation report "
            f"{report_s:.3f} s ({val_rows / report_s:.0f} rays/s) = "
            f"{val_s:.3f} s, checkpoint {ckpt_s:.3f} s; the step with its "
            f"save point {report['save_step_s']:.2f} s")
        log(f"  Testing/Total {testing.get('Total', float('nan')):.4f}, "
            f"Mean_PSNR {val.get('Mean_PSNR', float('nan')):.3f}, "
            f"Mean_Height_Error against the lidar DSM "
            f"{val.get('Mean_Height_Error', float('nan')):.4f} "
            f"({val.get('Mean_Height_Error', float('nan')) * to_m:.2f} m), "
            f"Prior_Height_Error "
            f"{val.get('Prior_Height_Error', float('nan')):.4f}")
        log(f"  projected onto the flagship schedule ({dep.max_train_steps} "
            f"steps at {report['step_ms']:.1f} ms, {n_dep} save points): "
            f"validation {100 * fs['validation_share']:.2f} % of the run at "
            f"1/{SITE_VAL_DOWN}; at 1/1 (linear in the rays) "
            f"{full_s:.1f} s a save point, "
            f"{100 * fs['downscale_1_validation_share']:.1f} %")
        need = ("Total", "Mean_PSNR", "Mean_Height_Error",
                "Prior_Height_Error")
        if not all(np.isfinite(testing.get(k, np.nan)) for k in need) \
                or not all(np.isfinite(v) for v in testing.values()):
            fail(f"the real site's save point logged {testing}")

        # the card's sweep against the CPU's on the site's first 4 slices
        cams, images, grid = sweep["args"][:3]
        patch = sweep["kw"].get("patch", 5)
        zs = np.linspace(-1.0, 1.0, grid[2])
        part = (grid[0], grid[1], 4)
        kw = dict(patch=patch, z_range=(zs[0], zs[3]))
        card = sc.plane_sweep_scores(cams, images, part, device=device, **kw)
        t0 = time.perf_counter()
        cpu = sc.plane_sweep_scores(cams, images, part, device="cpu", **kw)
        report["sweep_cpu_4_slices_s"] = time.perf_counter() - t0
        report["sweep_card_vs_cpu"] = float(np.abs(card - cpu).max())
        log(f"  sweep, card against CPU over {part}: max abs difference "
            f"{report['sweep_card_vs_cpu']:.3e} (tol {SWEEP_TOL:g}); the CPU "
            f"took {report['sweep_cpu_4_slices_s']:.1f} s")
        if not report["sweep_card_vs_cpu"] <= SWEEP_TOL:
            fail("the card's plane sweep disagrees with the CPU's")
        del tr
        report["analysis"] = site_analysis(device, cfg,
                                           rec["prepare_real"][0]["out"],
                                           **analysis_kw)
        report["regional"] = site_regional(device, cfg,
                                           rec["prepare_real"][0]["out"],
                                           **regional_kw)
        del rec
    report["carve_median_err"] = carve_recovers_surface(device)
    log(f"  carve of a known surface (synthetic, 6 views, grid 24 x 24 x 16)"
        f" on the card: median height error "
        f"{report['carve_median_err']:.4f} (bar {CARVE_TOL})")
    if not report["carve_median_err"] < CARVE_TOL:
        fail("the space carve does not recover the synthetic surface")
    torch.cuda.empty_cache()
    return report


# --- the data-parallel mesh (parallel/mesh.py) on the one card ---------------
MESH_SIZE = 128                 # px of the render mesh's frames
MESH_STEPS = 3                  # training steps a mesh run
# the mesh's steps against the no-mesh steps from the same weights and
# draws: every loss to CPU_CARD_RTOL / CPU_CARD_ATOL (the order of the sums
# differs, and a flipped bf16 rounding moves a loss by a few 1e-4); the
# weights to test_parallel's atol 2e-4 (in 3 steps at the OneCycle's
# start, lr / 25, Adam moves no weight by more than 2e-6: a bound on the
# sign noise of near-zero gradients, not a measure of the step); the
# running statistics to 1e-3 (0.01 of each pass's batch statistics over
# 393,216 points, where a flipped rounding averages out)
MESH_WEIGHT_ATOL = 2e-4
MESH_RUNNING_ATOL = 1e-3


def mesh_render(model, cfg, device, size=MESH_SIZE) -> dict:
    """(a) The render mesh: ``make_mesh(devices=[card, card])``, two
    replicas on the one card, renders the render cell's model at ``size``
    px, exact and with ``fast_render``, against the one-device renderer;
    K3's launches twice a chunk exact (4 times fast: two passes a part).
    The launch counts are set to 0 just before each mesh frame and read
    just after."""
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.parallel.mesh import make_mesh
    from season_nerf_torch.render.renderer import Renderer
    model = model.to(device).eval()
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, size)
    report = {"k3_launches": 0}
    for label, fast, passes in (("exact", None, 1),
                                ("fast", FAST_RENDER, 2)):
        kw = dict(n_samples=cfg.n_samples, chunk=cfg.chunk,
                  fast_render=fast)
        one = Renderer(model, **kw)
        two = Renderer(model, mesh=make_mesh(devices=[device, device]), **kw)
        if len(two.replicas) != 2 or two.replicas[1][0] is model:
            fail("the render mesh did not build a second replica")
        secs = {}
        for name, r in (("one", one), ("mesh", two)):
            r.render_img(*args)                     # warm
            torch.cuda.synchronize()
            ft.trunk_apply.launches = 0
            t0 = time.perf_counter()
            out = r.render_img(*args)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            launches = ft.trunk_apply.launches
            if name == "mesh":
                got, mesh_launches = out, launches
            else:
                want = out
        chunks = -(-size * size // two.chunk)
        if mesh_launches != 2 * passes * chunks:
            fail(f"render mesh ({label}): K3 launched {mesh_launches} "
                 f"times; {chunks} chunks split over 2 replicas, {passes} "
                 f"pass(es) a part, make {2 * passes * chunks}")
        err = max(float(np.nanmax(np.abs(got[k] - want[k])))
                  for k in ("Col_Img", "Shadow_Mask", "Height"))
        if not err <= RENDER_TOL:
            fail(f"render mesh ({label}): {err} from one device (tolerance "
                 f"{RENDER_TOL})")
        report["k3_launches"] += mesh_launches
        report[label] = {"frame_s": secs["mesh"], "one_device_s": secs["one"],
                         "k3_launches": mesh_launches, "chunks": chunks,
                         "max_abs_err": err}
        log(f"  render mesh of 2 replicas, {label}: {size} px frame "
            f"{secs['mesh']:.4f} s (one device {secs['one']:.4f} s), K3 "
            f"{mesh_launches} launches over {chunks} chunks, max |mesh - "
            f"one device| {err:.2e}")
    return report


def mesh_steps_against(ref: dict, run: dict, what: str) -> dict:
    """Every loss of every step and the weights, running statistics and
    latents of a mesh run against the no-mesh run ``ref`` -> the largest
    differences."""
    worst = {"loss_rel": 0.0, "weight": 0.0, "running": 0.0}
    for i, (a, b) in enumerate(zip(ref["scalars"], run["scalars"])):
        if set(a) != set(b):
            fail(f"{what}: step {i} logs {sorted(b)}, not {sorted(a)}")
        for k in a:
            d = abs(a[k] - b[k])
            if not d <= CPU_CARD_ATOL + CPU_CARD_RTOL * abs(a[k]):
                fail(f"{what}: step {i} {k} {b[k]} against {a[k]}")
            rel = d / max(abs(a[k]), 1e-12)
            if rel > worst["loss_rel"]:
                worst.update(loss_rel=rel, loss_worst=[i, k, b[k], a[k]])
    for k, want in ref["state_dict"].items():
        d = float((run["state_dict"][k].double()
                   - want.double()).abs().max())
        key, tol = (("running", MESH_RUNNING_ATOL) if "running" in k
                    else ("weight", MESH_WEIGHT_ATOL))
        if not d <= tol:
            fail(f"{what}: {k} differs by {d} (tolerance {tol})")
        worst[key] = max(worst[key], d)
    for g, lat in ref["ada"].items():
        for k, t in lat.items():
            d = float((run["ada"][g][k] - t).abs().max())
            if not d <= MESH_WEIGHT_ATOL:
                fail(f"{what}: latent {g}.{k} differs by {d}")
    if len(set(run["checksums"])) != 1:
        fail(f"{what}: the ranks' weights differ: {run['checksums']}")
    return worst


def mesh_train(device, cfg=None) -> dict:
    """(b) MESH_STEPS flagship default-trunk steps (batch 4096 x 96, the
    DSM prior on) on a mesh of the one card over NCCL at world size 1, and
    (c) on two gloo ranks sharing the card (2048 rays each), both against
    the same steps with no mesh from the same weights (the seed) and draws
    (keyed by step), every rank's peak memory recorded.  On the CPU (a
    rehearsal) both run on gloo."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.parallel.mesh import backend_for, launch, make_mesh
    from season_nerf_torch.train.engine import train_steps
    cfg = cfg or flagship_train_config(pallas_trunk=False)
    scene = make_scene(n_views=6, img_size=48, grid=64, seed=0)
    table, _ = scene_ray_tables(scene, testing_size=1)
    report = {}
    t0 = time.perf_counter()
    ref = train_steps(None, cfg, table, MESH_STEPS, scene.prior_hm,
                      device=device)
    report["no_mesh"] = {"s": time.perf_counter() - t0,
                         "peak_mem_gb": (ref["peak_mem_bytes"] or 0) / 1e9}
    torch.cuda.empty_cache()    # the ranks are other processes
    for key, devices in (("nccl_world_1", [device]),
                         ("gloo_two_ranks", [device, device])):
        mesh = make_mesh(devices=devices)
        backend = backend_for(mesh)
        t0 = time.perf_counter()
        ranks = launch(train_steps, mesh, cfg, table, MESH_STEPS,
                       scene.prior_hm)
        secs = time.perf_counter() - t0
        worst = mesh_steps_against(ref, ranks[0], key)
        if any(r["checksums"] != ranks[0]["checksums"] for r in ranks):
            fail(f"{key}: the ranks report other checksums")
        peaks = [(r["peak_mem_bytes"] or 0) / 1e9 for r in ranks]
        report[key] = {"backend": backend, "ranks": len(devices),
                       "launch_s": secs, "peak_mem_gb": peaks, **worst,
                       "last_total": ranks[0]["scalars"][-1]["Total"]}
        log(f"  {key} ({backend}, {len(devices)} rank(s)): {MESH_STEPS} "
            f"steps in {secs:.1f} s with the spawn; largest difference from "
            f"the no-mesh steps: loss {worst['loss_rel']:.2e} relative "
            f"(step, loss, mesh, no mesh: {worst.get('loss_worst')}), "
            f"weight {worst['weight']:.2e}, running statistic "
            f"{worst['running']:.2e}; peak memory a rank "
            f"{[round(p, 2) for p in peaks]} GB (no mesh "
            f"{report['no_mesh']['peak_mem_gb']:.2f} GB)")
    return report


def refusals_on_a_mesh(device) -> dict:
    """(d) ``pallas_trunk`` with a mesh raises on the card, and
    ``cli.run_train`` with ``mesh_shape=2`` on the one card raises the JAX
    package's message before the site is prepared."""
    from season_nerf_torch import cli
    from season_nerf_torch.config import get_opts
    from season_nerf_torch.models.tnerf import model_from_config
    from season_nerf_torch.parallel.mesh import make_mesh
    from season_nerf_torch.train.engine import fused_trunk_spec
    cfg = flagship_train_config()
    model = model_from_config(cfg).to(device).train()
    try:
        fused_trunk_spec(model, cfg.batch_size * cfg.n_samples, device,
                         mesh=make_mesh(devices=[device, device]))
        fail("pallas_trunk on a mesh did not raise on the card")
    except ValueError as e:
        spec_msg = str(e)
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    prepared = []
    saved = cli._prepare
    cli._prepare = lambda *a, **k: prepared.append(a)
    try:
        with tempfile.TemporaryDirectory() as io_dir:
            run_cfg = get_opts(["--site_name", "SYNTH_MESH", "--exp_name",
                                "m", "--IO_Location", io_dir,
                                "--mesh_shape", str(n + 1)])
            try:
                cli.run_train(run_cfg, device=device)
                fail(f"run_train with mesh_shape={n + 1} did not raise")
            except ValueError as e:
                run_msg = str(e)
    finally:
        cli._prepare = saved
    want = (f"mesh_shape={n + 1} but only {n} device(s) are visible; lower "
            f"mesh_shape or run on a larger slice")
    if run_msg != want or prepared:
        fail(f"run_train raised {run_msg!r} (prepared {len(prepared)} "
             f"sites), not {want!r} before preparing")
    log(f"  refusals: pallas_trunk on a mesh ({spec_msg}); run_train "
        f"mesh_shape={n + 1} ({run_msg})")
    return {"pallas_trunk": spec_msg, "run_train": run_msg}


def mesh_path(model, cfg, device) -> dict:
    """The mesh phase on the one card: (a) the render mesh, (b) NCCL at
    world size 1, (c) two gloo ranks sharing the card, (d) the
    refusals."""
    t0 = time.perf_counter()
    report = {"render": mesh_render(model, cfg, device)}
    report["train"] = mesh_train(device)
    report["refusals"] = refusals_on_a_mesh(device)
    report["k3_launches"] = report["render"]["k3_launches"]
    report["seconds"] = time.perf_counter() - t0
    log(f"  mesh phase {report['seconds']:.1f} s")
    return report


def check_sine(device, shape=SINE_SHAPE) -> dict:
    """The polynomial sine's kernel (``csrc/fast_sine.cu``) at one SIREN
    layer's activations of a flagship step, x in +-1e3: each direction
    against the plain chain of ``ops/fast_math`` on the card within
    SINE_TOL, timed by CUDA events beside the plain chain, with its bound
    (the bytes it must move over the card's bandwidth).  The kernel's FMA
    Horner chain and the plain chain's rounded passes differ by a few ulps;
    a bf16 store is its own f32 value cast, bit for bit, and within the
    two casts (half a bf16 step each) of the plain chain's."""
    from season_nerf_torch.ops import fast_math as fm
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * 1e3
    g = torch.rand(shape, generator=gen, device=device) * 2 - 1
    gb = g.to(torch.bfloat16)
    n = x.numel()
    cases = {
        "fwd[f32]": (lambda: fm.sine_op(x, False, False), 8,
                     lambda: fm.plain_sin(x)),
        "fwd[bf16]": (lambda: fm.sine_op(x, False, True), 6,
                      lambda: fm.plain_sin(x).to(torch.bfloat16)),
        "fwd_cos[f32]": (lambda: fm.sine_op(x, True, False), 8,
                         lambda: fm.plain_cos(x)),
        "bwd[g f32]": (lambda: fm.sine_grad_op(x, g, False), 12,
                       lambda: fm.plain_cos(x) * g),
        "bwd[g bf16]": (lambda: fm.sine_grad_op(x, gb, False), 10,
                        lambda: fm.plain_cos(x) * gb.float()),
    }
    out = {}
    for name, (kernel, bytes_per, plain) in cases.items():
        got, want = kernel(), plain()
        err = float((got.float() - want.float()).abs().max())
        if got.dtype == torch.bfloat16:
            own = fm.sine_op(x, False, False).to(torch.bfloat16)
            a, b = got.float(), want.float()
            ok = torch.equal(got, own) and bool(
                ((a - b).abs() <= SINE_TOL + 2.0 ** -8 * (a.abs() + b.abs()))
                .all())
        else:
            ok = err <= SINE_TOL
        if not ok:
            fail(f"fast_sine {name} at {shape[0]} x {shape[1]}: max abs "
                 f"err {err:.3e} against the plain chain (tol {SINE_TOL}; "
                 f"a bf16 store: its own f32 value cast, and two casts' "
                 f"half steps more)")
        ms = cuda_ms(kernel, 20, warmup=2)
        plain_ms = cuda_ms(plain, 5, warmup=1)
        bound_ms = 1e3 * n * bytes_per / PEAK_BYTES
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "roofline": bound_ms / ms, "max_abs_err": err}
        log(f"  fast_sine {name} at {shape[0]} x {shape[1]}: {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.1f} %), "
            f"plain chain {plain_ms:.3f} ms, max abs err {err:.3g}")
    return out


def check_batchnorm(device, rows=SINE_SHAPE[0], widths=BN_WIDTHS) -> dict:
    """The training BatchNorm of a bf16 SineLayer (``ops/batchnorm_train``)
    at one flagship step's layer shapes: the kernels against the plain
    version on the same card tensors (column means 5 N(0, 1), spreads 2-10,
    one constant column), within the BN_* tolerances; the column-sum pass
    (bf16 z in, float32 z out: 6 B an element) and the dz pass (float32 z
    and du in, bf16 dz out: 10 B) timed by CUDA events beside their bytes'
    bound and the plain version's passes; and the layer forward and
    backward, kernels against the plain version."""
    from season_nerf_torch.ops import batchnorm_train as bt
    out = {}
    for c in widths:
        gen = torch.Generator(device=device).manual_seed(SEED + c)
        mean = torch.randn(c, generator=gen, device=device) * 5
        std = torch.rand(c, generator=gen, device=device) * 8 + 2
        z = (torch.randn(rows, c, generator=gen, device=device) * std
             + mean).to(torch.bfloat16)
        z[:, 3] = 0.75
        g = torch.randn(rows, c, generator=gen,
                        device=device).to(torch.bfloat16)
        norm = torch.nn.BatchNorm1d(c).to(device)
        with torch.no_grad():
            norm.weight.uniform_(0.5, 1.5, generator=gen)
            norm.bias.uniform_(-0.5, 0.5, generator=gen)

        def layer(plain, keep=None):
            n = copy.deepcopy(norm)
            zr = z.clone().requires_grad_()
            y = bt.batchnorm_sine(zr, n, None, plain)
            y.backward(g)
            if keep is not None:
                keep.update(y=y, dz=zr.grad, dscale=n.weight.grad,
                            dshift=n.bias.grad, running_mean=n.running_mean,
                            running_var=n.running_var)

        got, want = {}, {}
        layer(False, got)
        layer(True, want)
        gaps = {}
        for k, a in got.items():
            a, b = a.detach().float(), want[k].detach().float()
            d = (a - b).abs()
            if k in ("y", "dz"):
                d = (d - 2.0 ** -8 * (a.abs() + b.abs())).clamp_min(0)
            gaps[k] = float(d.max() / (1.0 if k == "y" else b.abs().max()))
        tol = dict(y=BN_Y_ATOL, dz=BN_GRAD_RTOL, dscale=BN_GRAD_RTOL,
                   dshift=BN_GRAD_RTOL, running_mean=BN_STATS_RTOL,
                   running_var=BN_STATS_RTOL)
        if any(gaps[k] > tol[k] for k in tol):
            fail(f"batchnorm_train at {rows} x {c}: gaps {gaps} against the "
                 f"plain version (tolerances {tol})")

        scale = norm.weight.detach()
        rm, rv = norm.running_mean.clone(), norm.running_var.clone()
        zf, stats = bt._kernel_stats(z, scale, rm, rv, None)
        du, ab = bt._kernel_sine_grad(zf, g, stats, norm.bias.detach())
        n = z.numel()
        passes = {
            "column_sums": (lambda: bt._kernel_stats(z, scale, rm, rv, None),
                            lambda: bt._plain_stats(z, scale, rm, rv, None),
                            6),
            "dz": (lambda: bt._kernel_dz(zf, du, stats, ab),
                   lambda: bt._plain_dz(zf, du, stats, ab), 10),
        }
        rec = {"gaps": gaps}
        for name, (kernel, plain, bytes_per) in passes.items():
            ms = cuda_ms(kernel, 20, warmup=2)
            plain_ms = cuda_ms(plain, 5, warmup=1)
            bound_ms = 1e3 * n * bytes_per / PEAK_BYTES
            rec[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "roofline": bound_ms / ms}
            log(f"  batchnorm_train {name} at {rows} x {c}: {ms:.4f} ms "
                f"(bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.1f} %), "
                f"plain {plain_ms:.3f} ms")
        rec["layer_ms"] = cuda_ms(lambda: layer(False), 10, warmup=2)
        rec["layer_plain_ms"] = cuda_ms(lambda: layer(True), 3, warmup=1)
        log(f"  a layer forward and backward at {rows} x {c}: kernels "
            f"{rec['layer_ms']:.3f} ms, plain version "
            f"{rec['layer_plain_ms']:.3f} ms; gaps {gaps}")
        out[str(c)] = rec
        del z, g, zf, du, got, want
        torch.cuda.empty_cache()
    return out


def with_sine_launches(run, *args, **kwargs) -> dict:
    """``run(*args, **kwargs)``'s report with ``fast_sine_launches``: the
    polynomial sine kernel's launches in this process while it ran,
    counted from 0; ``batchnorm_launches``, the training BatchNorm's
    column-sum and dz launches, and ``folded_sine_launches``, the sine's
    launches with the BatchNorm folded in (among ``fast_sine_launches``),
    likewise."""
    from season_nerf_torch.ops import batchnorm_train as bt
    from season_nerf_torch.ops import fast_math as fm
    fm.launches = bt.launches = bt.sine_launches = 0
    report = run(*args, **kwargs)
    report["fast_sine_launches"] = fm.launches
    report["batchnorm_launches"] = bt.launches
    report["folded_sine_launches"] = bt.sine_launches
    log(f"  the polynomial sine's kernel: {fm.launches} launches on this "
        f"path ({bt.sine_launches} with the BatchNorm folded in); the "
        f"training BatchNorm's kernels: {bt.launches}")
    return report


def ptxas_entries(report: str, mark: str) -> dict:
    """ptxas's lines for each compiled entry whose name holds ``mark``:
    registers, shared memory, stack and spills."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            name = name if mark in name else None
            if name:
                out[name] = []
        elif name and any(w in line for w in ("registers", "spill",
                                              "stack")):
            out[name].append(line.strip())
    return out


def f32_only(args, model, cfg, device, card, nvcc_s, f32_ptxas, t_start):
    """``--only f32``: K3's float32 phases alone, into ``--json``."""
    log("K3's f32 kernel against trunk_apply_reference:")
    trunk = check_trunk(model.to(device), device, dtypes=(torch.float32,))
    check_trunk_small_widths(device, [(w, d, (torch.float32,))
                                      for w, d, _ in SMALL_TRUNKS])
    log("K3's f32 layers as cuBLAS f32 GEMMs alone (a yardstick):")
    f32_gemms = f32_layer_gemms(model, device)
    log("HTTP serving a legacy model directory (float32, sinf)")
    legacy = legacy_f32_path(model.cpu(), cfg, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "nvcc_s": nvcc_s,
                   "f32_ptxas": f32_ptxas, "trunk": trunk,
                   "f32_gemms": f32_gemms, "legacy_f32": legacy,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)


def k3_only(args, model, device, card, nvcc_s, ptxas, t_start):
    """``--only k3``: K3 alone at the flagship render chunk (bf16 and f32,
    both sines, timed), then, where the port has them, the wider and deeper
    trunks; into ``--json``.  Runs on an unpacked copy of another commit
    too (its flagship part needs nothing this tree added)."""
    from season_nerf_torch.ops import fused_trunk as ft
    log("K3 at the flagship render chunk against trunk_apply_reference:")
    trunk = check_trunk(model.to(device), device, ns=(FLAGSHIP_N,))
    for name, ms in PARENT_K3_MS.items():
        log(f"  {name}: {trunk[name][0]['ms']:.4f} ms (PERF.md records "
            f"{ms} ms for the parent)")
    wide = None
    if hasattr(ft, "fold_layers"):
        log("K3 at the wider and deeper trunks:")
        wide = check_trunk_wide(device)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "nvcc_s": nvcc_s,
                   "ptxas": ptxas_entries(ptxas, "trunk_"), "trunk": trunk,
                   "wide": wide,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)


def main():
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=DEFAULT_JSON,
                   help="where to write every measurement as JSON")
    p.add_argument("--degree-child", action="store_true",
                   help=argparse.SUPPRESS)     # see degree_children
    p.add_argument("--export-child", default=None,
                   help=argparse.SUPPRESS)     # see export_path
    p.add_argument("--only", choices=("f32", "k3"),
                   help="f32: build K3 alone and run only its float32 "
                        "phases (the f32 kernel against its plain version "
                        "and timed, the cuBLAS layer GEMMs, the legacy "
                        "float32 model directory served); k3: build K3 "
                        "alone, time it at the flagship render chunk in "
                        "both dtypes and sines and hold it at the wider and "
                        "deeper trunks; either e.g. to compare two trees of "
                        "the port in one call; prints no contract lines")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import_port()
    if args.degree_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(degree_check(torch.device("cuda"))), flush=True)
        return
    if args.export_child:
        export_child(args.export_child)
        return
    from season_nerf_torch.config import Config
    from season_nerf_torch.ops import cuda_build, fast_math as fm
    from season_nerf_torch.ops import fused_train as ftr
    from season_nerf_torch.ops import fused_trunk as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    import importlib.util
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("scipy", "cv2", "imageio", "tabulate", "matplotlib",
                       "PIL", "tensorboard")}
    log("host packages (find_spec): " + ", ".join(
        f"{m} {'present' if v else 'absent'}" for m, v in found.items()))
    if not found["scipy"]:
        fail("scipy is absent: the evaluation's alignment searches and LPs "
             "need it")

    from season_nerf_torch.ops import batchnorm_train as bt
    names = [ft.KERNEL] if args.only else [ft.KERNEL, ftr.FWD_KERNEL,
                                           ftr.BWD_KERNEL, fm.KERNEL,
                                           bt.KERNEL]
    t0 = time.perf_counter()
    cuda_build.build(names)
    nvcc_s = time.perf_counter() - t0
    log(f"built {', '.join(names)} in {nvcc_s:.1f} s")
    ptxas = {n: cuda_build.ptxas_report(n) for n in names}
    for n in names:
        for line in ptxas[n].splitlines():
            # C7515: ptxas serialized a kernel's wgmma
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "C7515")):
                log(f"  ptxas {n}: {line.strip()}")
    f32_ptxas = ptxas_entries(ptxas[ft.KERNEL], "trunk_f32")
    log("ptxas, K3's f32 kernel (registers, spills): " + json.dumps(f32_ptxas))

    cfg = Config()
    model = make_model(cfg)
    if args.only == "f32":
        f32_only(args, model, cfg, device, card, nvcc_s, f32_ptxas, t_start)
        return
    if args.only == "k3":
        k3_only(args, model, device, card, nvcc_s, ptxas[ft.KERNEL], t_start)
        return
    log("K3 (trunk_infer) against trunk_apply_reference:")
    trunk = check_trunk(model.to(device), device)
    check_trunk_small_widths(device)
    log("K3's f32 layers as cuBLAS f32 GEMMs alone (a yardstick):")
    f32_gemms = f32_layer_gemms(model, device)
    log("K3 at the wider and deeper trunks (the bf16 kernel's wide "
        "instance, the f32 kernel at 1024, 11 and 17 layers):")
    wide = wide_path(device, trunk, ptxas[ft.KERNEL])

    log("K1 (trunk_train_fwd) and K2 (trunk_train_bwd) against "
        "trunk_fwd_reference / trunk_bwd_reference:")
    train_kernels = check_train_kernels(device)
    log("the bf16 GEMM of K1 and K2 (TMA + wgmma) against the f32 product:")
    gemms = check_gemms(device)
    log("the polynomial sine's kernel against the plain chain:")
    sine = check_sine(device)
    log("the training BatchNorm's kernels against their plain version:")
    batchnorm = check_batchnorm(device)

    log(f"K3, K1 and K2 at FAST_SIN_DEGREE "
        f"{' and '.join(map(str, DEGREES))}, one child process each:")
    degrees = degree_children()
    k3_11 = trunk["trunk_infer[bfloat16,fast_sin]"][0]
    tk11 = train_kernels["flagship,bf16,fast_sin"]
    for d, rec in degrees.items():
        log(f"  degree {d} against 11 (ms): K3 {rec['k3']['ms']:.4f} / "
            f"{k3_11['ms']:.4f}, K1 {rec['k1k2']['k1_ms']:.3f} / "
            f"{tk11['k1_ms']:.3f}, K2 {rec['k1k2']['k2_ms']:.3f} / "
            f"{tk11['k2_ms']:.3f}; nvcc {rec['nvcc_s']:.1f} s / {nvcc_s:.1f}"
            f" s")

    log("main path: HTTP serving at full width")
    serving = with_sine_launches(main_path, model.cpu(), cfg, device)

    log(f"main path: HTTP serving at full width with fast_render "
        f"{FAST_RENDER}")
    fast = with_sine_launches(fast_render_path, model, cfg, device,
                              serving["latency"])

    log("main path: HTTP serving a legacy model directory (float32, sinf: "
        "K3's f32 kernel)")
    legacy = with_sine_launches(legacy_f32_path, model, cfg, device)

    log("main path: a reference checkpoint converted by "
        "tools/convert_reference_model and served (K3's f32 kernel)")
    reference = with_sine_launches(reference_path, cfg, device)

    log(f"main path: tools/make_movie on the render cell's model "
        f"({MOVIE_FRAMES} frames of {MOVIE_SIZE} px)")
    movie = with_sine_launches(movie_path, model, cfg, device)

    log("main path: tools/export_render on the render cell's model (exact, "
        f"fast {FAST_RENDER} and its legacy float32 directory), each "
        "program loaded in a fresh process and called on a flagship chunk")
    export = export_path(model, cfg, device)

    log("main path: the data-parallel mesh on the one card (the render mesh "
        "of two replicas, NCCL at world size 1, two gloo ranks sharing the "
        "card, the refusals)")
    mesh = with_sine_launches(mesh_path, model, cfg, device)
    del model
    torch.cuda.empty_cache()

    log("main path: training the flagship config through K1 and K2")
    training = with_sine_launches(train_path, device)

    log(f"main path: training the flagship config with n_importance "
        f"{HIER_IMPORTANCE} (hierarchical sampling)")
    hierarchical = with_sine_launches(hierarchical_path, device)

    log("main path: training the flagship config on HSLuv ray colours")
    hsluv = with_sine_launches(hsluv_path, device)

    log(f"main path: validation at the save points, cli.run_train on the "
        f"synthetic site ({VAL_STEPS} steps, {VAL_SAVES} save points)")
    with tempfile.TemporaryDirectory() as val_io:
        validation = with_sine_launches(validation_path, device,
                                        io_dir=val_io)
        log("main path: the run tools (quality_report, "
            "select_best_geometry, time_to_quality and fast_render_ab on "
            "the validation run, bench_serving_concurrent on the render "
            "cell's model, run_regions on one synthetic site)")
        tools = with_sine_launches(tools_path, cfg, device,
                                   validation["logs_dir"],
                                   validation["testing"])

    log(f"main path: the evaluation, cli.run_test on the synthetic site "
        f"({EVAL_STEPS} steps, {EVAL_SAVES} save points, best_geometry) and "
        f"with eval_only")
    evaluation = with_sine_launches(evaluation_path, device)

    log(f"main path: the real-site path, cli.run_train on a fabricated "
        f"DFC-format site ({SITE_VIEWS} views of {SITE_PX} px), then the "
        f"evaluation of its model")
    real_site = with_sine_launches(real_site_path, device)

    # the polynomial sine's launches, each main path's own: none where the
    # model is float32 with sinf, some wherever a bf16 model runs
    paths = {"serving": serving, "fast_render": fast, "legacy_f32": legacy,
             "reference": reference, "movie": movie, "export": export,
             "mesh": mesh, "training": training,
             "hierarchical": hierarchical, "hsluv": hsluv,
             "validation": validation, "tools": tools,
             "evaluation": evaluation, "real_site": real_site}
    sine_launches = {k: r["fast_sine_launches"] for k, r in paths.items()}
    log("the polynomial sine's kernel launches by main path: "
        + json.dumps(sine_launches))
    for k, n in sine_launches.items():
        if (n != 0) if k in ("legacy_f32", "reference") else (n == 0):
            fail(f"the {k} path launched the polynomial sine's kernel {n} "
                 f"times; want {'none' if n else 'some'}")
    # the training BatchNorm's launches: none where nothing trains, some
    # wherever a bf16 default trunk trains; one folded sine launch for each
    bn_launches = {k: [r["batchnorm_launches"], r["folded_sine_launches"]]
                   for k, r in paths.items() if "batchnorm_launches" in r}
    log("the training BatchNorm's kernel launches and the folded sine's by "
        "main path: " + json.dumps(bn_launches))
    for k, (n, folded) in bn_launches.items():
        frozen = k in ("serving", "fast_render", "legacy_f32", "reference",
                       "movie")
        trains = k in ("training", "mesh", "hierarchical")
        if n != folded or (frozen and n) or (trains and not n):
            fail(f"the {k} path launched the training BatchNorm's kernels "
                 f"{n} times and the folded sine {folded} times; want as "
                 f"many of each, {'none' if frozen else 'some'}")

    flagship = trunk["trunk_infer[bfloat16,fast_sin]"][0]
    kernels = [{
        "name": "trunk_infer",
        "route": "cuda",
        "source": "season_nerf_torch/csrc/trunk_infer.cu",
        "replaces": "season_nerf_tpu/ops/pallas_mlp.py:106",
        "launches": (serving["k3_launches"] + fast["k3_launches"]
                     + movie["k3_launches"] + mesh["k3_launches"]
                     + export["k3_launches"]["bfloat16"]
                     + tools["k3_launches"]
                     + hierarchical["k3_launches"] + hsluv["k3_launches"]
                     + validation["k3_launches"]
                     + evaluation["k3_launches"] + real_site["k3_launches"]
                     + real_site["analysis"]["k3_launches"]
                     + real_site["regional"]["k3_launches"]),
        "max_abs_err": max(r["max_abs_err"]
                           for r in trunk["trunk_infer[bfloat16,fast_sin]"]),
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": None,
    }]
    f32 = trunk["trunk_infer[float32,sinf]"][0]
    kernels.append({
        "name": "trunk_infer[float32]",
        "route": "cuda",
        "source": "season_nerf_torch/csrc/trunk_infer.cu",
        "replaces": "season_nerf_tpu/ops/pallas_mlp.py:106",
        "launches": (legacy["k3_launches"] + reference["k3_launches"]
                     + reference["frame_16px"]["k3_launches"]
                     + export["k3_launches"]["float32"]),
        "max_abs_err": max(r["max_abs_err"]
                           for r in trunk["trunk_infer[float32,sinf]"]),
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
    })
    w640 = wide["trunks"][f"bf16-{WIDE_FRAME_UNITS}[bfloat16,fast_sin]"]
    kernels.append({
        "name": "trunk_infer[bfloat16,wide]",
        "route": "cuda",
        "source": "season_nerf_torch/csrc/trunk_infer.cu",
        "replaces": "season_nerf_tpu/ops/pallas_mlp.py:106",
        "launches": wide["k3_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in w640),
        "ms": w640[0]["ms"],
        "plain_ms": w640[0]["plain_ms"],
        "bound_ms": w640[0]["bound_ms"],
        "bound_by": w640[0]["bound_by"],
        "library_ms": None,
    })
    tk = train_kernels["flagship,bf16,fast_sin"]
    for key, name, line, launches in (
            ("k1", ftr.FWD_KERNEL, 238, training["k1_launches"]
             + hsluv["k1_launches"] + validation["k1_launches"]
             + tools["k1_launches"]
             + evaluation["k1_launches"] + real_site["k1_launches"]),
            ("k2", ftr.BWD_KERNEL, 273, training["k2_launches"]
             + hsluv["k2_launches"] + validation["k2_launches"]
             + tools["k2_launches"]
             + evaluation["k2_launches"] + real_site["k2_launches"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"season_nerf_torch/csrc/{name}.cu",
            "replaces": f"season_nerf_tpu/ops/pallas_train.py:{line}",
            "launches": launches,
            "max_abs_err": tk[f"{key}_max_abs_err"],
            "ms": tk[f"{key}_ms"],
            "plain_ms": tk[f"{key}_plain_ms"],
            "bound_ms": tk[f"{key}_bound_ms"],
            "bound_by": tk[f"{key}_bound_by"],
            "library_ms": None,
        })
    bn = batchnorm[str(BN_WIDTHS[0])]
    kernels.append({
        "name": bt.KERNEL,
        "route": "cuda",
        "source": f"season_nerf_torch/csrc/{bt.KERNEL}.cu",
        "replaces": "season_nerf_tpu/models/siren.py:141",
        "launches": sum(n for n, _ in bn_launches.values()),
        "max_abs_err": max(r["gaps"]["y"] for r in batchnorm.values()),
        "ms": bn["column_sums"]["ms"] + bn["dz"]["ms"],
        "plain_ms": bn["column_sums"]["plain_ms"] + bn["dz"]["plain_ms"],
        "bound_ms": bn["column_sums"]["bound_ms"] + bn["dz"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    })
    fwd = sine["fwd[bf16]"]         # what every bf16 SineLayer launches
    kernels.append({
        "name": fm.KERNEL,
        "route": "cuda",
        "source": f"season_nerf_torch/csrc/{fm.KERNEL}.cu",
        "replaces": "season_nerf_tpu/ops/fast_math.py:88",
        "launches": sum(sine_launches.values()),
        "max_abs_err": max(r["max_abs_err"] for k, r in sine.items()
                           if k != "fwd[bf16]"),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    })
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "nvcc_s": nvcc_s,
                   "ptxas": ptxas,
                   "f32_ptxas": f32_ptxas, "f32_gemms": f32_gemms,
                   "trunk": trunk, "serving": serving, "fast_render": fast,
                   "legacy_f32": legacy, "wide": wide,
                   "reference": reference, "movie": movie,
                   "export": export, "mesh": mesh, "tools": tools,
                   "train_kernels": train_kernels, "gemms": gemms,
                   "sine": sine, "batchnorm": batchnorm,
                   "degrees": degrees, "training": training,
                   "hierarchical": hierarchical, "hsluv": hsluv,
                   "validation": validation,
                   "evaluation": evaluation, "real_site": real_site,
                   "host_packages": found,
                   "kernels": kernels,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
