"""The kernels on the card: K3 (the inference trunk) and K1/K2 (the
training trunk's forward and backward) against their plain versions, the
bf16 GEMM inside K1/K2 against the f32 product, the wrappers' checks and
launch counts, a render on the card against the same
render on the CPU, training steps on the card through K1/K2, a save
point's validation on the card (K3) against the CPU, the
space-carving sweep on the card against the CPU, the evaluation after
training, and the regional evaluation (the shadow test's sun rays through
K3, ``regional_eval``, the pairwise metrics) on the card against the CPU;
the opt-in variants: K3 at the fast render's chunk, a fast frame and a
hierarchical training step on the card against the CPU, ``pallas_trunk``
refusing hierarchical sampling, and K3 built at ``FAST_SIN_DEGREE=7``;
K3 above the flagship's shapes (widths 640-1024, 11 and 17 layers), wide
models' frames, a converted reference checkpoint's frame and a movie on
the card against the CPU; K3 called as the operator
``season_nerf::trunk_apply``, and render programs exported on the card,
loaded back and held against the live chunk; the data-parallel mesh on the
one card: a render mesh of two replicas against one device, and training
steps over NCCL at world size 1 and on two gloo ranks sharing the card
against the no-mesh steps.

Every test here needs a CUDA card and skips without one.  Run them on a
machine with an H100, from the repository root:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX, which
the port and these tests do not need.)"""

import dataclasses
import os

import numpy as np
import pytest
import torch

# the kernel tolerances, stated there
from chip_smoke import (CARVE_TOL, CPU_CARD_ATOL, CPU_CARD_RTOL, FAST_N,
                        F32_RENDER_TOL, FAST_RENDER, GEMM_REL_TOL, HIER_ATOL,
                        HIER_GRAD_RTOL, HIER_RTOL, HIER_SMALL, K1_REL_TOL,
                        K2_REL_TOL, RENDER_TOL, SWEEP_TOL, TOL, VAL_CHUNK,
                        WIDE_TRUNKS, carve_recovers_surface, card_vs_cpu_dir,
                        converted_model_dir, cpu_vs_card,
                        flagship_train_config, gemm_case, gemm_rel_err,
                        make_model, order_moves, order_tolerance,
                        train_params,
                        wide_trunk_layers,
                        write_legacy_model_dir, write_model_dir,
                        write_reference_checkpoint)
from season_nerf_torch.config import Config
from season_nerf_torch.data.ingest import save_world_artifact
from season_nerf_torch.ops import fused_train as ftr
from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.train.state import save_model_artifact
from season_nerf_torch.utils import trace

pytestmark = pytest.mark.gpu


def launched(kernel="k3") -> int:
    """The launches counted as ``<kernel>.launches`` so far."""
    return trace.counters()[f"{kernel}.launches"]

@pytest.fixture(scope="module")
def cuda():
    """The card; every test of this file skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on a machine with "
                    "one (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(width, depth):
    """A seeded eval model with trunk BatchNorm statistics that are not
    trivial (``chip_smoke.make_model``)."""
    return make_model(Config(fc_units=width, fc_layers=depth))


def _pe(n, device):
    gen = torch.Generator(device=device).manual_seed(n)
    return ft.encode_points(torch.rand(n, 3, generator=gen, device=device)
                            * 2 - 1).contiguous()


# Full width at every row count that shapes the kernels' grids (64-row
# tiles, in clusters of two in bf16): one row (in bf16 a cluster of one live
# and one idle tile), one tile, a ragged odd tile count (777: 13 tiles),
# 4,133, the exact-shadow chunk (5,120), 20,037, the fast render's chunk
# (163,840) and the flagship render chunk (491,520); then narrow, shallow
# trunks; then, f32 only, widths above the bf16 kernel's 512, where the f32
# kernel takes 32-row tiles, at ragged counts.  Tolerances: chip_smoke.TOL.
SHAPES = [*[(512, 8, n) for n in (1, 64, 777, 4133, 5120, 20_000 + 37,
                                  FAST_N, 491_520)],
          (32, 2, 1000), (96, 7, 777), (128, 4, 64)]
F32_WIDE = [(768, 8, 777), (768, 8, 20_000 + 37), (640, 3, 4133)]
CASES = [(*shape, dt) for shape in SHAPES
         for dt in (torch.bfloat16, torch.float32)] \
    + [(*shape, torch.float32) for shape in F32_WIDE]


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("width,depth,n,dtype", CASES, ids=[
    f"{'bf16' if dt == torch.bfloat16 else 'f32'}-{w}-{d}-{n}"
    for w, d, n, dt in CASES])
def test_kernel_matches_plain_version(cuda, width, depth, n, dtype,
                                      fast_sine):
    folded = ft.fold_trunk(_model(width, depth).G_NeRF_net, dtype=dtype,
                           device=cuda)
    pe = _pe(n, cuda)
    launches = launched()
    got = ft.trunk_apply(pe, folded, fast_sine)
    want = ft.trunk_apply_reference(pe, folded, fast_sine)
    torch.cuda.synchronize()
    assert launched() == launches + 1
    assert got.shape == want.shape == (n, max(width // 2, 1))
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    tol_max, tol_mean = TOL[dtype]
    assert float(err.max()) <= tol_max
    assert float(err.mean()) <= tol_mean


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two launches on the same input give the same bytes: each output
    element's sums run in one fixed order (no atomics, no split)."""
    folded = ft.fold_trunk(_model(512, 8).G_NeRF_net, dtype=dtype,
                           device=cuda)
    pe = _pe(20_000 + 37, cuda)
    for fast_sine in (True, False):
        a, b = (ft.trunk_apply(pe, folded, fast_sine) for _ in range(2))
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    folded = ft.fold_trunk(_model(32, 2).G_NeRF_net, device=cuda)
    pe = ft.encode_points(torch.zeros(10, 3, device=cuda)).contiguous()
    for bad in (pe.double(), pe[:, :32], pe.t().contiguous().t(),
                pe.unsqueeze(0)):
        with pytest.raises(ValueError):
            ft.trunk_apply(bad, folded)
    with pytest.raises(ValueError):
        ft.trunk_apply(pe, ft.fold_trunk(_model(32, 2).G_NeRF_net))
    with pytest.raises(ValueError):
        ft.trunk_apply(pe, ft.fold_trunk(_model(32, 2).G_NeRF_net,
                                         dtype=torch.float16, device=cuda))
    # both kernels: padded widths up to 1024, up to 17 layers
    for dtype, kernel in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        deep = ft.fold_layers(wide_trunk_layers(32, 17), dtype, cuda)
        wide = ft.fold_trunk(_model(1100, 2).G_NeRF_net, dtype=dtype,
                             device=cuda)
        assert (len(deep.weights), wide.width_pad) == (18, 1152)
        for bad in (deep, wide):
            with pytest.raises(ValueError, match=f"{kernel} trunk kernel"):
                ft.trunk_apply(pe, bad)
    # the f32 kernel: the fold's ring copy of the weights on the PE's device
    no_ring = dataclasses.replace(folded, ring_weights=None)
    cpu_ring = dataclasses.replace(folded,
                                   ring_weights=folded.ring_weights.cpu())
    for bad in (no_ring, cpu_ring):
        with pytest.raises(ValueError, match="f32 trunk kernel"):
            ft.trunk_apply(pe, bad)
    launches = launched()
    assert ft.trunk_apply(pe[:0], folded).shape == (0, 16)
    assert launched() == launches       # nothing to launch



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_operator_matches_plain_version(cuda, dtype):
    """``season_nerf::trunk_apply`` called as an operator on the card: the
    kernel (one launch a call) within chip_smoke.TOL of the plain version,
    the bytes of ``trunk_apply``'s, and one launch state a set of weights
    however often it is called."""
    folded = ft.fold_trunk(_model(512, 8).G_NeRF_net, dtype=dtype,
                           device=cuda)
    pe = _pe(FAST_N, cuda)
    args = (pe, folded.weights, folded.biases, folded.ring_weights,
            folded.inputs.index("h+pe"), 512, folded.width_pad,
            folded.out_features, True)
    launches = launched()
    got = torch.ops.season_nerf.trunk_apply(*args)
    states = len(ft._launch_states)
    again = ft.trunk_op(*args)
    via = ft.trunk_apply(pe, folded, True)
    torch.cuda.synchronize()
    assert launched() == launches + 3
    assert len(ft._launch_states) == states
    assert torch.equal(got, again) and torch.equal(got, via)
    want = ft.trunk_apply_reference(pe, folded, True)
    err = (got - want).abs()
    tol_max, tol_mean = TOL[dtype]
    assert float(err.max()) <= tol_max and float(err.mean()) <= tol_mean


@pytest.mark.parametrize("fast", [None, FAST_RENDER], ids=["exact", "fast"])
@pytest.mark.parametrize("legacy", [False, True], ids=["bf16", "f32"])
def test_exported_program_on_the_card_matches_live(cuda, tmp_path, legacy,
                                                   fast):
    """``tools/export_render`` on the card: nothing launched while
    exporting; the saved program, loaded back, equal to the live
    ``Renderer._full_chunk`` within the tool's 2e-5 (the same kernel and
    aten ops), with 1 K3 launch a call exact and 2 fast; bf16, and a legacy
    directory (float32, ``sinf``: K3-f32 with the ring copy)."""
    from season_nerf_torch.tools import export_render
    cfg = Config(fc_units=128, fc_layers=4, n_samples=16, chunk=300)
    d = str(tmp_path / "model")
    os.makedirs(d)
    (write_legacy_model_dir if legacy else write_model_dir)(
        d, make_model(cfg), cfg, (0.0, 30.0))
    out = str(tmp_path / "render.pt2")
    argv = [d, "-o", out, "--device", "cuda"]
    if fast:
        argv += ["--fast_render", *map(str, fast)]
    launches = launched()
    export_render.main(argv)
    assert launched() == launches
    program = export_render.load_exported(out)
    live = load_model_dir(d, device=cuda, fast_render=fast).renderer
    rays = [torch.from_numpy(a).to(cuda)
            for a in export_render.check_rays(cfg.chunk)]
    with torch.no_grad():
        want = live._full_chunk(*rays)
        launches = launched()
        got = program(*rays)
        torch.cuda.synchronize()
    assert launched() - launches == (2 if fast else 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.isfinite(got[k]).all(), k
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-5)

# K3 above the flagship's shapes (chip_smoke.WIDE_TRUNKS): the bf16
# kernel's wide instance at padded widths 640, 768 and 1024, the f32 kernel
# at 1024 (four rows of W'^T a ring slot), and 11 and 17 layers
# (deep_trunk_layers: no model builds them) in both kernels, at a ragged
# odd tile count and a ragged larger one.  Tolerances:
# chip_smoke.order_tolerance (TOL scaled by how much more the summation
# order alone moves the trunk than the flagship's, never below TOL).
WIDE_CASES = [(label, w, d, dt) for label, w, d, dts in WIDE_TRUNKS
              for dt in dts]


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("label,width,fc_layers,dtype", WIDE_CASES, ids=[
    f"{label}-{'bf16' if dt == torch.bfloat16 else 'f32'}"
    for label, _, _, dt in WIDE_CASES])
def test_kernel_matches_plain_version_wide_and_deep(cuda, label, width,
                                                    fc_layers, dtype,
                                                    fast_sine):
    """And a launch of one row gives that point's row of a larger launch,
    byte for byte (a row's sums do not depend on the others)."""
    folded = ft.fold_layers(wide_trunk_layers(width, fc_layers), dtype,
                            cuda)
    flagship = ft.fold_trunk(_model(512, 8).G_NeRF_net, dtype=dtype,
                             device=cuda)
    assert len(folded.weights) == fc_layers + 1
    for n in (777, 20_000 + 37):
        pe = _pe(n, cuda)
        flag = order_moves(pe, flagship, fast_sine, ft.trunk_apply_reference(
            pe, flagship, fast_sine))
        launches = launched()
        got = ft.trunk_apply(pe, folded, fast_sine)
        want = ft.trunk_apply_reference(pe, folded, fast_sine)
        torch.cuda.synchronize()
        assert launched() == launches + 1
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs()
        tol_max, tol_mean = order_tolerance(
            order_moves(pe, folded, fast_sine, want), flag, dtype)
        assert float(err.max()) <= tol_max, (n, float(err.max()))
        assert float(err.mean()) <= tol_mean, (n, float(err.mean()))
    assert torch.equal(ft.trunk_apply(pe[:1].contiguous(), folded,
                                      fast_sine), got[:1])


@pytest.mark.parametrize("units,legacy,tol", [
    (640, False, RENDER_TOL), (768, False, RENDER_TOL),
    (1024, True, F32_RENDER_TOL)], ids=["bf16-640", "bf16-768", "f32-1024"])
def test_render_16px_wide_model_matches_the_cpu(cuda, tmp_path, units,
                                                legacy, tol):
    """Models wider than the flagship: bf16 through the wide instance, a
    float32 (legacy) one through the f32 kernel at 1024; a 16 px frame on
    the card against the CPU (bf16: RENDER_TOL; f32: F32_RENDER_TOL), one
    launch."""
    cfg = Config(fc_units=units)
    (write_legacy_model_dir if legacy else write_model_dir)(
        str(tmp_path), make_model(cfg), cfg, (0.0, 30.0))
    rec = card_vs_cpu_dir(str(tmp_path), tol, cuda)
    assert rec["k3_launches"] == 1
    assert rec["dtype"] == str(torch.float32 if legacy else torch.bfloat16)


def test_converted_reference_dir_on_the_card_matches_the_cpu(cuda,
                                                             tmp_path):
    """A reference-format checkpoint (seeded, the render cell's width)
    converted by tools/convert_reference_model into a legacy directory:
    float32 with the exact sine, a 16 px frame on the card against the CPU
    within F32_RENDER_TOL."""
    cfg = Config()
    ckpt = str(tmp_path / "reference.nn")
    write_reference_checkpoint(ckpt, cfg)
    d = tmp_path / "converted"
    d.mkdir()
    converted_model_dir(str(d), ckpt, cfg, (0.0, 30.0))
    rec = card_vs_cpu_dir(str(d), F32_RENDER_TOL, cuda)
    assert rec["dtype"] == str(torch.float32) and rec["k3_launches"] == 1


def test_movie_on_the_card(cuda, tmp_path):
    """tools/make_movie on the card: frames x chunks launches; the frames
    within chip_smoke.MOVIE_LEVELS of the CPU's and byte-equal with
    pipeline=2."""
    from chip_smoke import MOVIE_LEVELS
    from season_nerf_torch.render.movie import render_movie
    from season_nerf_torch.tools import make_movie
    cfg = Config(fc_units=64, fc_layers=4, n_samples=16, chunk=100)
    write_model_dir(str(tmp_path), make_model(cfg), cfg, (0.0, 30.0))
    launches = launched()
    make_movie.main(["--Model_Location", str(tmp_path), "--frames", "3",
                     "--size", "12", "--out", str(tmp_path / "m.gif")])
    assert launched() - launches == 3 * -(-144 // cfg.chunk)
    script = make_movie.default_script()
    card = load_model_dir(str(tmp_path), device=cuda).renderer
    cpu = load_model_dir(str(tmp_path), device="cpu").renderer
    one = render_movie(card, script, 3, 12, pipeline=1)
    assert np.array_equal(one, render_movie(card, script, 3, 12, pipeline=2))
    want = render_movie(cpu, script, 3, 12, pipeline=1)
    assert np.abs(one.astype(int) - want.astype(int)).max() <= MOVIE_LEVELS


def test_render_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small bf16 model directory rendered on the card (kernel) and on
    the CPU (plain version): every trunk evaluation is a launch, and the
    images agree to bf16 accuracy."""
    cfg = Config(fc_units=64, fc_layers=4, n_samples=16, chunk=100)
    cfg.save_json(str(tmp_path / "opts.json"))
    save_model_artifact(str(tmp_path / "Final_Model.nn"),
                        _model(64, 4).state_dict())
    save_world_artifact(str(tmp_path / "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))
    card = load_model_dir(str(tmp_path), device=cuda).renderer
    cpu = load_model_dir(str(tmp_path), device="cpu").renderer
    args = ((70.0, 30.0), (45.0, 160.0), 0.4, 12)
    launches = launched()
    got = card.render_img(*args, exact_shadow=True)
    rays, S = 12 * 12, cfg.n_samples
    assert launched() - launches == (
        -(-rays // cfg.chunk) + -(-rays * S // cfg.chunk) * (S - 1))
    want = cpu.render_img(*args, exact_shadow=True)
    for k in ("Col_Img", "Shadow_Mask", "Exact_Shadow_Mask", "PS_Sum"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=5e-2, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(card.get_dsm(12), cpu.get_dsm(12), atol=5e-2,
                               rtol=0)


def test_render_16px_full_width_matches_the_cpu(cuda, tmp_path):
    """The flagship model (``Config()``: width 512, bf16, polynomial sine)
    renders a 16 px frame on the card (K3) as on the CPU (plain versions),
    within chip_smoke.RENDER_TOL: bf16 colors and heights."""
    cfg = Config()
    cfg.save_json(str(tmp_path / "opts.json"))
    save_model_artifact(str(tmp_path / "Final_Model.nn"),
                        make_model(cfg).state_dict())
    save_world_artifact(str(tmp_path / "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, 16)
    launches = launched()
    got = load_model_dir(str(tmp_path), device=cuda).renderer.render_img(
        *args)
    assert launched() - launches == -(-16 * 16 // cfg.chunk)
    want = load_model_dir(str(tmp_path), device="cpu").renderer.render_img(
        *args)
    for k in ("Col_Img", "Shadow_Mask", "Height", "PS_Sum"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=RENDER_TOL, rtol=0,
                                   err_msg=k)


def test_legacy_f32_model_dir_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A model directory whose opts.json predates compute_dtype and
    fast_sine loads as float32 with the exact sine, so every K3 launch is
    the f32 kernel: a 16 px frame at full width, and a 12 px exact-shadow
    frame of a narrow model, on the card against the CPU within
    chip_smoke.F32_RENDER_TOL, launches as the chunking implies."""
    cases = ((Config(), 16, False),
             (Config(fc_units=64, fc_layers=4, n_samples=16, chunk=100), 12,
              True))
    for i, (cfg, size, shadow) in enumerate(cases):
        d = str(tmp_path / str(i))
        os.makedirs(d)
        write_legacy_model_dir(d, make_model(cfg), cfg, (0.0, 30.0))
        card = load_model_dir(d, device=cuda).renderer
        cpu = load_model_dir(d, device="cpu").renderer
        fused = card.model.G_NeRF_net.fused()
        assert fused.folded.dtype == torch.float32 and not fused.fast_sine
        assert fused.folded.ring_weights.is_cuda
        args = ((70.0, 30.0), (45.0, 180.0), 0.5, size)
        launches = launched()
        got = card.render_img(*args, exact_shadow=shadow)
        rays, S = size * size, cfg.n_samples
        chunks = lambda n: -(-n // cfg.chunk)
        assert launched() - launches == chunks(rays) + (
            chunks(rays * S) * (S - 1) if shadow else 0)
        want = cpu.render_img(*args, exact_shadow=shadow)
        keys = ("Col_Img", "Shadow_Mask", "Height", "PS_Sum") + (
            ("Exact_Shadow_Mask",) if shadow else ())
        for k in keys:
            assert np.isfinite(got[k]).all(), k
            np.testing.assert_allclose(got[k], want[k], atol=F32_RENDER_TOL,
                                       rtol=0, err_msg=f"{cfg.fc_units} {k}")


def test_fast_render_16px_full_width_matches_the_cpu(cuda, tmp_path):
    """The flagship model rendered depth-guided (``FAST_RENDER``) on the
    card and on the CPU, within chip_smoke.RENDER_TOL; two K3 launches a
    chunk (the window pass and the full pass), and the exact-shadow frame's
    secondary rays from the n_fine samples with n_samples steps."""
    cfg = Config()
    cfg.save_json(str(tmp_path / "opts.json"))
    save_model_artifact(str(tmp_path / "Final_Model.nn"),
                        make_model(cfg).state_dict())
    save_world_artifact(str(tmp_path / "W2C_W2L_H.npy"), None, None,
                        (0.0, 30.0))
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, 16)
    card = load_model_dir(str(tmp_path), fast_render=FAST_RENDER,
                          device=cuda).renderer
    cpu = load_model_dir(str(tmp_path), fast_render=FAST_RENDER,
                         device="cpu").renderer
    launches = launched()
    got = card.render_img(*args, exact_shadow=True)
    rays, nf, S = 16 * 16, FAST_RENDER[1], cfg.n_samples
    chunks = lambda n: -(-n // cfg.chunk)
    assert launched() - launches == \
        2 * chunks(rays) + chunks(rays * nf) * (S - 1)
    want = cpu.render_img(*args, exact_shadow=True)
    for k in ("Col_Img", "Shadow_Mask", "Height", "PS_Sum",
              "Exact_Shadow_Mask"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=RENDER_TOL, rtol=0,
                                   err_msg=k)


def test_hierarchical_step_on_the_card_matches_the_cpu(cuda):
    """chip_smoke's small float32 model with n_importance: 3 steps on the
    CPU and on the card from the same weights and draws (losses within
    HIER_RTOL, step 0's gradients within HIER_GRAD_RTOL: the reasons are
    stated there), one K3 launch a step on the card for the coarse pass."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    scene = make_scene(n_views=3, img_size=24, grid=32, seed=1)
    table, _ = scene_ray_tables(scene, testing_size=1)
    launches = launched()
    res = cpu_vs_card(table, scene.prior_hm, cuda,
                      flagship_train_config(**HIER_SMALL), HIER_RTOL,
                      HIER_ATOL, HIER_GRAD_RTOL)
    assert launched() - launches == 3
    assert res["worst_rel"] <= HIER_RTOL


def test_pallas_trunk_refuses_hierarchical_sampling_on_the_card(cuda):
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=3, img_size=24, grid=32, seed=1)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=256, batch_size=64, n_samples=32, n_importance=8,
                 max_train_steps=10, pallas_trunk=True)
    tr = Trainer(cfg, table, prior_hm=scene.prior_hm, device=cuda)
    with pytest.raises(ValueError, match="hierarchical sampling"):
        tr.train_step()


DEGREE_CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
from chip_smoke import TOL, make_model
from season_nerf_torch.config import Config
from season_nerf_torch.ops import cuda_build, fast_math, fused_trunk as ft
from season_nerf_torch.utils import trace
assert fast_math.DEGREE == 7
cuda_build.build([ft.KERNEL])
assert "FAST_SIN_DEGREE=7" in " ".join(cuda_build.NVCC_FLAGS)
g = make_model(Config()).G_NeRF_net.cuda()
gen = torch.Generator(device="cuda").manual_seed(7)
for dtype in (torch.bfloat16, torch.float32):
    folded = ft.fold_trunk(g, dtype=dtype)
    for n in (4133, 163_840):
        pe = ft.encode_points(torch.rand(n, 3, generator=gen, device="cuda")
                              * 2 - 1).contiguous()
        err = (ft.trunk_apply(pe, folded, True)
               - ft.trunk_apply_reference(pe, folded, True)).abs()
        assert float(err.max()) <= TOL[dtype][0], (dtype, n, float(err.max()))
        assert float(err.mean()) <= TOL[dtype][1], (dtype, n)
print("ok", trace.counters()["k3.launches"])
"""


def test_kernel_at_sine_degree_7_matches_plain_version(cuda):
    """K3 built with -DFAST_SIN_DEGREE=7 in a child process (the port reads
    the degree at import) against its plain version at degree 7, bf16 and
    f32 with the polynomial sine; chip_smoke.TOL."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", DEGREE_CHILD], cwd=root,
                          env={**os.environ, "FAST_SIN_DEGREE": "7"},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", "4"]


def test_entry_points_default_to_the_card(cuda, tmp_path):
    cfg = Config(fc_units=32, fc_layers=2, n_samples=8)
    cfg.save_json(str(tmp_path / "opts.json"))
    save_model_artifact(str(tmp_path / "Final_Model.nn"),
                        _model(32, 2).state_dict())
    loaded = load_model_dir(str(tmp_path))
    assert loaded.renderer.device.type == "cuda"
    assert all(w.is_cuda for w in loaded.model.G_NeRF_net.fused()
               .folded.weights)


TRAIN_SPECS = {"w32-tile64": (dict(widths=(32, 32, 32, 16), skip_idx=2,
                                   pe_dim=16, tile=64), 64 * 5),
               "w256-tile128": (dict(widths=(256,) * 8 + (128,), tile=128),
                                128 * 3)}


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(TRAIN_SPECS))
def test_train_kernels_match_plain_versions(cuda, name, dtype, fast_sine):
    kw, n = TRAIN_SPECS[name]
    spec = ftr.TrunkSpec(**kw, fast_sine=fast_sine, act_dtype=dtype,
                         grad_dtype=dtype)
    params = [p.to(cuda) for p in train_params(spec, 1)]
    gen = torch.Generator(device=cuda).manual_seed(n)
    pe = (ftr.encode_pe(torch.rand(n, 3, generator=gen, device=cuda) * 2 - 1)
          if spec.pe_dim == ftr.PE_PAD else
          (torch.rand(n, spec.pe_dim, generator=gen, device=cuda) * 2 - 1)
          .to(torch.bfloat16))
    launches = (launched("k1"), launched("k2"))
    got = ftr.trunk_fwd(spec, pe, params)
    want = ftr.trunk_fwd_reference(spec, pe, params)
    dt = ftr._DTYPES[dtype]
    err = (got[0].float() - want[0].float()).abs()
    assert float(err.max()) <= TOL[dt][0] and float(err.mean()) <= TOL[dt][1]
    for k in (1, 2):
        assert float((got[k] - want[k]).abs().max()
                     / want[k].abs().max()) <= K1_REL_TOL[dt]
    d_x = 0.1 * torch.randn(n, spec.enc_width, generator=gen, device=cuda)
    d_h = 0.1 * torch.randn(n, ftr.HEAD_PAD, generator=gen, device=cuda)
    got = ftr.trunk_bwd(spec, pe, params, d_x, d_h)
    want = ftr.trunk_bwd_reference(spec, pe, params, d_x.to(dt), d_h)
    torch.cuda.synchronize()
    assert (launched("k1"), launched("k2")) == (
        launches[0] + 1, launches[1] + 1)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.isfinite(a).all(), k
        assert float((a - b).abs().max() / b.abs().max().clamp_min(1.0)) \
            <= K2_REL_TOL[dt], k


# The bf16 GEMM of K1 and K2 (TMA + wgmma) against the f32 product of the
# same bf16 operands on the card: every layout, M = 200 (not a multiple of
# the 128-row tile), the K and N that the trunk's shapes take (K = 8: the
# heads' input gradient; 64: the PE; 576: the skip layer's [h | PE]; N = 8:
# the heads; 16: the small specs; 256: fc9; 512: a full layer).  The error
# of each element is held against (|A| . |B|) there (see GEMM_REL_TOL).
@pytest.mark.parametrize("n", [8, 16, 256, 512])
@pytest.mark.parametrize("k", [8, 64, 576])
@pytest.mark.parametrize("layout", list(ftr.GEMM_LAYOUTS))
def test_gemm_matches_f32_matmul(cuda, layout, k, n):
    a, b, _, _ = gemm_case(layout, 200, n, k, cuda, seed=k * n)
    got = ftr.gemm_bf16(a, b, layout)
    assert got.shape == (200, n) and torch.isfinite(got).all()
    assert gemm_rel_err(got, a, b, layout) <= GEMM_REL_TOL


@pytest.mark.parametrize("layout,m,n,k,bias,acc,split", [
    ("fwd", 1000, 512, 512, True, False, False),     # a layer: z = h.W + b
    ("fwd", 2048 + 5, 512, 64, True, True, False),   # the skip layer's PE half
    ("fwd", 777, 8, 256, True, False, False),        # the heads
    ("dgrad", 300, 256, 8, False, True, False),      # the heads' da
    ("wgrad", 576, 512, 20_000 + 37, False, False, True),   # dW, split-K
    ("wgrad", 64, 512, 4096, False, True, True),
])
def test_gemm_bias_accumulate_split(cuda, layout, m, n, k, bias, acc, split):
    """The epilogue's contract: + bias, + C (in place in the kernels), and
    split-K through the workspace with a fixed-order reduction, whose bits
    do not change from call to call."""
    a, b, bias_t, c = gemm_case(layout, m, n, k, cuda, seed=m + n + k)
    bias_t = bias_t if bias else None
    c = c if acc else None
    got, again = (ftr.gemm_bf16(a, b, layout, bias=bias_t, split=split,
                                c=None if c is None else c.clone())
                  for _ in range(2))
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert gemm_rel_err(got, a, b, layout, bias_t, c) <= GEMM_REL_TOL


def test_gemm_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda)
    for bad_a, bad_b in ((a.float(), a.t().contiguous()),
                         (a[:, :30].contiguous(), a[:30].t().contiguous()),
                         (a, a), (a, a.t())):
        with pytest.raises(ValueError):
            ftr.gemm_bf16(bad_a, bad_b, "fwd")
    with pytest.raises(ValueError):
        ftr.gemm_bf16(a, a.t().contiguous(), "bwd")
    with pytest.raises(ValueError):
        ftr.gemm_bf16(a, a.t().contiguous(), "fwd",
                      bias=torch.zeros(32, device=cuda))


def test_train_wrappers_reject_what_the_kernels_do_not_take(cuda):
    spec = ftr.TrunkSpec(widths=(32, 32, 32, 16), skip_idx=2, pe_dim=16,
                         tile=64)
    params = [p.to(cuda) for p in train_params(spec, 1)]
    pe = torch.zeros(128, 16, dtype=torch.bfloat16, device=cuda)
    for bad in (pe[:100], pe.float(), pe[:, :8]):
        with pytest.raises(ValueError):
            ftr.trunk_fwd(spec, bad, params)
    with pytest.raises(ValueError):
        ftr.trunk_fwd(spec, pe, [p.cpu() for p in params])
    with pytest.raises(ValueError):
        ftr.trunk_bwd(spec, pe, params, torch.zeros(64, 16, device=cuda),
                      torch.zeros(128, 8, device=cuda))
    # TMA wants rows of a multiple of 8 bf16 values: widths and pe_dim too
    for kw in (dict(widths=(32, 36, 32, 16)), dict(pe_dim=12)):
        odd = ftr.TrunkSpec(**{**dict(widths=(32, 32, 32, 16), skip_idx=2,
                                      pe_dim=16, tile=64), **kw})
        odd_params = [p.to(cuda) for p in train_params(odd, 1)]
        odd_pe = torch.zeros(128, odd.pe_dim, dtype=torch.bfloat16,
                             device=cuda)
        with pytest.raises(ValueError, match="multiples of 8"):
            ftr.trunk_fwd(odd, odd_pe, odd_params)
        with pytest.raises(ValueError, match="multiples of 8"):
            ftr.trunk_bwd(odd, odd_pe, odd_params,
                          torch.zeros(128, 16, device=cuda),
                          torch.zeros(128, 8, device=cuda))


def test_trainer_steps_on_the_card_through_k1_and_k2(cuda):
    """The Trainer defaults to the card; with pallas_trunk each step
    launches K1 twice (camera and solar pass) and K2 once."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=3, img_size=24, grid=32, seed=1)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=256, batch_size=64, n_samples=32,
                 max_train_steps=100, pallas_trunk=True)
    tr = Trainer(cfg, table, prior_hm=scene.prior_hm)
    assert tr.device.type == "cuda"
    before = (launched("k1"), launched("k2"))
    for _ in range(2):
        loss = tr.train_step()
        assert all(bool(torch.isfinite(v)) for v in loss.values())
    assert tr.statics.trunk_spec is not None
    assert (launched("k1") - before[0],
            launched("k2") - before[1]) == (4, 2)


def test_save_point_validation_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A save point's ``Testing`` losses, validation render and report on
    the card (K3) against the CPU (plain versions), both resumed from the
    save point's checkpoint, with the same validation draws.  Tolerances:
    the losses as chip_smoke.CPU_CARD_RTOL/ATOL hold the training losses
    (the same bf16 arithmetic in other orders), the image
    chip_smoke.RENDER_TOL, the report's PSNR 1e-2 relative and its height
    errors RENDER_TOL (means over the image)."""
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer, ValDraws
    from season_nerf_torch.utils.logging import MetricWriter
    scene = make_scene(n_views=4, img_size=24, grid=32, seed=1)
    table, val = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=256, batch_size=64, n_samples=32, max_train_steps=4,
                 n_saves=1, pallas_trunk=True, logs_dir=str(tmp_path))
    tr = Trainer(cfg, table, val, prior_hm=scene.prior_hm, gt_dsm=scene.hm)
    before = launched()
    tr.run()
    assert sorted(tr.save_steps) == [4]
    assert launched() - before == 2 + -(-len(val) // VAL_CHUNK)
    assert tr.model.training
    draws = ValDraws(cfg.seed, len(val), min(cfg.batch_size, len(val)),
                     device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        other = Trainer(cfg, table, val, prior_hm=scene.prior_hm,
                        gt_dsm=scene.hm, writer=MetricWriter(""), device=dev,
                        val_draws=lambda s, dev=dev: {
                            k: v.to(dev) for k, v in draws(s).items()})
        other.resume(str(tmp_path / "Model_4.nn"))
        out[str(dev)] = (other.eval_losses(),
                         other.render_table_image(val, 0),
                         other.validation_report())
    (l_cpu, r_cpu, v_cpu), (l_card, r_card, v_card) = out["cpu"], \
        out[str(cuda)]
    assert set(l_cpu) == set(l_card)
    for k, want in l_cpu.items():
        assert abs(l_card[k] - want) <= CPU_CARD_ATOL + CPU_CARD_RTOL * abs(
            want), (k, l_card[k], want)
    seen = r_cpu[3]
    assert np.array_equal(r_card[3], seen) and seen.sum() > 100
    assert np.abs(r_card[0] - r_cpu[0])[seen].max() <= RENDER_TOL
    assert np.isfinite(r_card[2][seen]).all()
    assert set(v_card) == set(v_cpu) == {"Mean_PSNR", "Mean_Height_Error",
                                         "Prior_Height_Error"}
    assert abs(v_card["Mean_PSNR"] - v_cpu["Mean_PSNR"]) <= 1e-2 * abs(
        v_cpu["Mean_PSNR"])
    for k in ("Mean_Height_Error", "Prior_Height_Error"):
        assert abs(v_card[k] - v_cpu[k]) <= RENDER_TOL, k


def test_plane_sweep_on_the_card_matches_the_cpu(cuda):
    """The space-carving sweep (plain PyTorch on the device) against the
    same function on the CPU; tolerance: chip_smoke.SWEEP_TOL.  The score
    volume's graph cut then recovers the synthetic surface on the card."""
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.priors import space_carving as sc
    scene = make_scene(n_views=4, img_size=64, grid=48, seed=2)
    args = (scene.cameras, scene.images, (16, 16, 8))
    card = sc.plane_sweep_scores(*args, patch=5, cell_chunk=100, device=cuda)
    cpu = sc.plane_sweep_scores(*args, patch=5, cell_chunk=100, device="cpu")
    assert card.shape == (16, 16, 8) and np.isfinite(card).all()
    assert np.abs(card - cpu).max() <= SWEEP_TOL
    assert carve_recovers_surface(cuda) < CARVE_TOL


# --- the evaluation after training: the batched scorers and analyze_model --
def _eval_model(dtype, device, seed=0):
    """A seeded width-128, four-layer eval model (``make_model``) on
    ``device``: f32 or the flagship's bf16 with the polynomial sine."""
    return make_model(Config(fc_units=128, fc_layers=4, compute_dtype=dtype),
                      seed=seed).to(device)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", RENDER_TOL)])
def test_density_surface_on_the_card_matches_the_cpu(cuda, dtype, tol):
    """The density surface through K3 on the card against the plain
    versions on the CPU: f32 within TOL's 1e-3 (K3 against its plain
    version), bf16 within RENDER_TOL; one K3 launch per 4096 columns."""
    from chip_smoke import CHUNK_COLS
    from season_nerf_torch.eval import hm_eval
    grid = (70, 61)                       # 4270 columns: 2 calls
    before = launched()
    card = hm_eval.density_surface(_eval_model(dtype, cuda), grid,
                                   n_samples=96)
    assert launched() - before == -(-70 * 61 // CHUNK_COLS)
    cpu = hm_eval.density_surface(_eval_model(dtype, "cpu"), grid,
                                  n_samples=96)
    for a, b in zip(card, cpu):
        assert a.shape == grid and np.isfinite(a).all()
    assert np.abs(card[0] - cpu[0]).max() <= tol


def test_seasonal_alignment_on_the_card_matches_the_cpu(cuda):
    """Every candidate's error of the seasonal alignment, scored on the
    card, against the CPU on the same components: 1e-5 relative (float32
    in other orders), in blocks of 7 candidates on the card."""
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval import img_eval
    from season_nerf_torch.render.renderer import Renderer
    scene = make_scene(n_views=3, img_size=32, grid=24, seed=5)
    cam = scene.cameras[0]
    r_cpu = Renderer(_eval_model("float32", "cpu"), n_samples=32)
    comp = r_cpu.component_render_by_camera(cam, (24, 24))
    gt = cam.image[comp["gt_img_pts"][:, 0], comp["gt_img_pts"][:, 1]]
    want = img_eval.align_errors(r_cpu, comp, gt, cam.time_frac, 100)
    n, s = comp["rho"].shape[:2]
    block = img_eval.ALIGN_BLOCK_BYTES
    img_eval.ALIGN_BLOCK_BYTES = 7 * n * s * 3 * 4
    try:
        got = img_eval.align_errors(
            Renderer(_eval_model("float32", cuda), n_samples=32), comp, gt,
            cam.time_frac, 100)
    finally:
        img_eval.ALIGN_BLOCK_BYTES = block
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


def test_sinkhorn_batch_on_the_card_matches_the_cpu(cuda):
    """The batched Sinkhorn EMD on the card against the CPU: 1e-4
    relative (float32 logsumexps in other orders)."""
    from season_nerf_torch.eval import emd
    rng = np.random.default_rng(3)
    sigs = [emd.color_signature(rng.uniform(size=(16, 16, 3)) ** (1 + i))
            for i in range(6)]
    W1, X1 = emd.pad_signatures(sigs)
    W2, X2 = emd.pad_signatures(sigs[::-1])
    card = emd.emd_sinkhorn_batch(W1, X1, W2, X2, device=cuda)
    cpu = emd.emd_sinkhorn_batch(W1, X1, W2, X2, device="cpu")
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=0)


def test_analyze_model_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``analyze_model`` + ``write_analysis_outputs`` of a bf16 model on
    the card (K3) and on the CPU: chip_smoke.compare_analyses's
    tolerances (image scores ANALYSIS_SCORE_RTOL, height scores
    ANALYSIS_HM_TOL_M; a differing alignment choice is reported, not
    held), K3's launches as the chunking implies, every output file."""
    from chip_smoke import (_timed, analysis_k3_launches,
                            analysis_problems, compare_analyses)
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval import img_eval, regional
    from season_nerf_torch.render.renderer import Renderer
    scene = make_scene(n_views=4, img_size=32, grid=24, seed=6)
    test_idx = [1, 3]
    kw = dict(hm_samples=32, img_size=(20, 20), walk_size=12)
    runs = {}
    for dev in (cuda, "cpu"):
        r = Renderer(_eval_model("bfloat16", dev), n_samples=32, chunk=300)
        rec = {}
        restore = _timed(img_eval, "align_errors", rec)
        before = launched()
        try:
            an = regional.analyze_model(r, r.model, scene.cameras, test_idx,
                                        scene.hm, (0.0, 30.0),
                                        str(tmp_path / str(dev)), **kw)
        finally:
            restore()
        regional.write_analysis_outputs(an, str(tmp_path / str(dev) / "Out"))
        runs[str(dev)] = (an, rec["align_errors"],
                          launched() - before)
    (card, card_al, k3), (cpu, cpu_al, _) = runs[str(cuda)], runs["cpu"]
    assert k3 == analysis_k3_launches(scene.cameras, test_idx, (20, 20), 12,
                                      scene.hm.shape, 300)
    names = [scene.cameras[i].name for i in test_idx]
    assert not analysis_problems(card, str(tmp_path / str(cuda) / "Out"),
                                 names)
    res = compare_analyses(card, cpu, card_al, cpu_al)
    assert not res["problems"], res


# --- the regional evaluation: the shadow test, regional_eval, the metrics --
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", RENDER_TOL)])
def test_shadow_angles_on_the_card_match_the_cpu(cuda, dtype, tol):
    """The shadow test's sun rays through K3 (``forward_solar`` in eval
    mode) on the card against the plain versions on the CPU: f32 within
    TOL's 1e-3, bf16 within RENDER_TOL; one K3 launch per sun angle."""
    from season_nerf_torch.eval import shadow_eval
    angles = np.array([[20.0, 100.0], [55.0, 200.0], [85.0, 10.0]])
    ground = np.stack(np.meshgrid(np.linspace(-1, 1, 16),
                                  np.linspace(-1, 1, 16), indexing="ij"),
                      -1).reshape(-1, 2)
    before = launched()
    card = shadow_eval.eval_shadow_angles(_eval_model(dtype, cuda).eval(),
                                          angles, ground, n_samples=48)
    assert launched() - before == len(angles)
    cpu = shadow_eval.eval_shadow_angles(_eval_model(dtype, "cpu").eval(),
                                         angles, ground, n_samples=48)
    for a, b in zip(card, cpu):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= tol


@pytest.mark.parametrize("seed", [8, 9, 10])
def test_regional_eval_on_the_card_matches_the_cpu(cuda, tmp_path, seed):
    """``regional_eval`` of a bf16 model on the card (K3) and on the CPU,
    the scene and the weights from ``seed``: chip_smoke.compare_regionals's
    tolerances (a differing alignment choice is reported, not held), the
    height map at the quick sizes' 48 samples, but the season walk's EM
    statistics within 5e-2 relative: a random model's 12 x 12 renders put
    pixels on the LAB histogram's bin edges, where the renders' bf16
    differences (up to RENDER_TOL) move a pixel's mass to a bin 12.5
    units away (H100 readings over seeds 8, 9, 10: 1.5e-3, 1.6e-2,
    1.7e-3; heights within 1.7e-5 m); K3's launches as the chunking
    implies, every file of ``Detailed_Output/``.  The worst differences
    are printed (``-rP`` shows them)."""
    from chip_smoke import (_timed, compare_regionals, regional_k3_launches,
                            regional_problems)
    from season_nerf_torch.data.synthetic import make_scene
    from season_nerf_torch.eval import img_eval, regional
    from season_nerf_torch.render.renderer import Renderer
    scene = make_scene(n_views=5, img_size=32, grid=24, seed=seed)
    test_idx = [1, 3]
    kw = dict(img_size=(16, 16), season_size=(12, 12), hm_samples=48)
    runs = {}
    for dev in (cuda, "cpu"):
        r = Renderer(_eval_model("bfloat16", dev, seed), n_samples=32,
                     chunk=300)
        rec = {}
        restore = _timed(img_eval, "align_errors", rec)
        before = launched()
        out = str(tmp_path / str(dev))
        try:
            res = regional.regional_eval(r, r.model, scene.cameras, test_idx,
                                         scene.hm, scene.prior_hm,
                                         (0.0, 30.0), out, **kw)
        finally:
            restore()
        assert not regional_problems(res, out)
        runs[str(dev)] = (res, rec["align_errors"],
                          launched() - before)
    (card, card_al, k3), (cpu, cpu_al, _) = runs[str(cuda)], runs["cpu"]
    assert k3 == regional_k3_launches(scene.cameras, test_idx, (16, 16),
                                      (12, 12), scene.hm.shape, 300)
    res = compare_regionals(card, cpu, card_al, cpu_al, kw["hm_samples"],
                            season_rtol=5e-2)
    print(f"seed {seed}: worst differences {res['worst']}")
    assert not res["problems"], res


def test_pairwise_metrics_on_the_card_match_the_cpu(cuda):
    """Every pairwise metric on the card (cuFFT, cuDNN's convolution)
    against the CPU on a seeded stack: 1e-4 (float32 in other orders),
    the results on the card; SAM of an image against itself within 1e-3
    (the arccos of a cosine 1 up to rounding: its slope is unbounded
    there)."""
    from season_nerf_torch.eval import pairwise_metrics as pm
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (2, 3, 32, 32, 3))
                         .astype(np.float32))
    diag = np.eye(3, dtype=bool)[None].repeat(2, 0)
    for name, fn in pm.METRICS.items():
        card, cpu = fn(x.to(cuda)), fn(x)
        assert card.device.type == "cuda" and card.shape == (2, 3, 3), name
        card, cpu = card.cpu().numpy(), cpu.numpy()
        np.testing.assert_allclose(card[~diag], cpu[~diag], rtol=0,
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(card[diag], cpu[diag], rtol=1e-6,
                                   atol=1e-3 if name == "sam" else 1e-4,
                                   err_msg=name)


# --- the data-parallel mesh on the one card ----------------------------------
@pytest.mark.parametrize("fast", [None, (8, 8)], ids=["exact", "fast"])
def test_render_mesh_of_two_replicas_on_the_card_matches_one_device(cuda,
                                                                    fast):
    """``make_mesh(devices=[card, card])``: two replicas on the one card,
    K3 launched on each for its half of every chunk (twice a chunk, four
    times fast), the frame held against the one-device renderer at
    RENDER_TOL (bf16 heads through cuBLAS at another row count may round
    elsewhere)."""
    from season_nerf_torch.parallel.mesh import make_mesh
    from season_nerf_torch.render.renderer import Renderer
    cfg = Config(fc_units=256, n_samples=16, chunk=1000)
    model = make_model(cfg).to(cuda)
    kw = dict(n_samples=16, chunk=1000, fast_render=fast)
    one = Renderer(model, **kw)
    two = Renderer(model, mesh=make_mesh(devices=[cuda, cuda]), **kw)
    args = ((70.0, 30.0), (45.0, 180.0), 0.5, 48)
    before = launched()
    got = two.render_img(*args)
    chunks = -(-48 * 48 // two.chunk)
    assert launched() - before == 2 * chunks * (2 if fast else 1)
    want = one.render_img(*args)
    for k in ("Col_Img", "Shadow_Mask", "Height"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RENDER_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (2, "gloo")])
def test_mesh_step_on_the_card_matches_the_no_mesh_step(cuda, ranks,
                                                        backend):
    """3 bf16 default-trunk steps on a training mesh of the card, over
    NCCL at world size 1 and on two gloo ranks sharing the card, against
    the same steps with no mesh from the same weights and draws, at
    ``chip_smoke.mesh_steps_against``'s tolerances."""
    from chip_smoke import MESH_STEPS, flagship_train_config, \
        mesh_steps_against
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.parallel.mesh import (backend_for, launch,
                                                 make_mesh)
    from season_nerf_torch.train.engine import train_steps
    scene = make_scene(n_views=3, img_size=24, grid=32, seed=1)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = flagship_train_config(pallas_trunk=False, fc_units=256,
                                batch_size=256, n_samples=32)
    ref = train_steps(None, cfg, table, MESH_STEPS, scene.prior_hm,
                      device=cuda)
    torch.cuda.empty_cache()
    mesh = make_mesh(devices=[cuda] * ranks)
    assert backend_for(mesh) == backend
    run = launch(train_steps, mesh, cfg, table, MESH_STEPS, scene.prior_hm)
    assert len(run) == ranks
    mesh_steps_against(ref, run[0], backend)
    assert all(r["checksums"] == run[0]["checksums"] for r in run)
