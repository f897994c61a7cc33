"""The port's DSM prior against the JAX package's: the graph cut (the port's
own build of ``native/graph_cut.cc`` against the JAX package's library),
the plane sweep (plain PyTorch on the CPU against the jitted JAX sweep) and
the height map.  Tolerances, and why, at each test."""

import numpy as np
import pytest
import torch

from season_nerf_torch.data import synthetic as t_synth
from season_nerf_torch.priors import graph_cut as t_gc
from season_nerf_torch.priors import space_carving as t_sc
from season_nerf_tpu.data import synthetic as j_synth
from season_nerf_tpu.priors import graph_cut as j_gc
from season_nerf_tpu.priors import space_carving as j_sc

torch.set_num_threads(1)

# the sweep's small case: the same shapes as tests/test_torch_site.py's
# whole-slice test (patch 3, the default 4096-cell chunk), so that a worker
# running both compiles the JAX sweep once
GRID, PATCH = (8, 8, 6), 3


@pytest.mark.parametrize("n,height,start,end", [
    (10, 1 / 3, 0, -1), (7, 0.5, 1, 4), (1, 1.0, 0, -1), (33, 0.25, 2, 20)])
def test_truncated_linear_costs(n, height, start, end):
    """The same numpy expression: identical."""
    np.testing.assert_array_equal(
        t_gc.truncated_linear_costs(n, height, start, end),
        j_gc.truncated_linear_costs(n, height, start, end))


@pytest.mark.parametrize("shape,height,cycles,init", [
    ((12, 10, 6), 0.5, 3, False), ((16, 16, 5), 0.8, 3, True),
    ((9, 21, 12), 1 / 3, 1, False)])
def test_aexpansion_matches_the_jax_library(shape, height, cycles, init):
    """The port's build of native/graph_cut.cc against the library the JAX
    package loads, on the same data: the same source and flags, so the
    labels are identical and the energies (a float64 sum over float32
    costs) agree to 1e-6 relative."""
    rng = np.random.default_rng(sum(shape))
    data = rng.random(shape).astype(np.float32)
    sm = t_gc.truncated_linear_costs(shape[2], height=height)
    labels0 = (rng.integers(0, shape[2], shape[:2]).astype(np.int32)
               if init else None)
    lt, et = t_gc.aexpansion_grid(data, sm, init_labels=labels0,
                                  max_cycles=cycles)
    lj, ej = j_gc.aexpansion_grid(data, sm, init_labels=labels0,
                                  max_cycles=cycles)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(et, ej, rtol=1e-6)
    np.testing.assert_allclose(t_gc.grid_energy(data, sm, lt),
                               j_gc.grid_energy(data, sm, lj), rtol=1e-6)
    np.testing.assert_allclose(t_gc._energy_np(data, sm, lt), et, rtol=1e-6)
    if init:
        assert (labels0 >= 0).all()          # the caller's labels untouched
        lt, et = t_gc._icm(data, sm, labels0, sweeps=4)
        lj, ej = j_gc._icm(data, sm, labels0, sweeps=4)
        np.testing.assert_array_equal(lt, lj)
        assert et == ej


def test_graph_cut_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """No library, no graph cut: a missing or failing compiler raises; the
    port never answers with ICM's labels in the solver's place."""
    data = np.random.default_rng(0).random((4, 5, 3)).astype(np.float32)
    sm = t_gc.truncated_linear_costs(3)
    monkeypatch.setattr(t_gc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_gc, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        t_gc.aexpansion_grid(data, sm)
    with pytest.raises(RuntimeError, match="not found"):
        t_gc.grid_energy(data, sm, np.zeros((4, 5), np.int32))
    monkeypatch.setenv("CXX", "false")        # found, and fails
    with pytest.raises(RuntimeError, match="failed"):
        t_gc.aexpansion_grid(data, sm)
    assert not list((tmp_path / "build").glob("*.so"))


def test_graph_cut_checks_its_arguments():
    sm = t_gc.truncated_linear_costs(3)
    data = np.zeros((4, 5, 3), np.float32)
    with pytest.raises(ValueError, match="do not agree"):
        t_gc.grid_energy(data, t_gc.truncated_linear_costs(4),
                         np.zeros((4, 5), np.int32))
    with pytest.raises(ValueError, match="labels outside"):
        t_gc.grid_energy(data, sm, np.full((4, 5), 3, np.int32))


@pytest.fixture(scope="module")
def sweeps():
    """One JAX scene; its cameras and images through both sweeps, and each
    package's own scene through its own sweep (the two scenes are the same
    numpy arithmetic)."""
    js = j_synth.make_scene(n_views=4, img_size=32, grid=24, seed=1)
    ts = t_synth.make_scene(n_views=4, img_size=32, grid=24, seed=1)
    jax_scores = j_sc.plane_sweep_scores(js.cameras, js.images, GRID,
                                         patch=PATCH)
    port_scores = t_sc.plane_sweep_scores(js.cameras, js.images, GRID,
                                          patch=PATCH, device="cpu")
    own_scores = t_sc.plane_sweep_scores(ts.cameras, ts.images, GRID,
                                         patch=PATCH, device="cpu")
    return jax_scores, port_scores, own_scores


def test_plane_sweep_matches_jax(sweeps):
    """The same f32 arithmetic summed in other orders (the projection, the
    patch moments; the port's covariance product runs in float64): scores
    in [-1, 1] held to 1e-5 absolute (the CPU reading: 1.7e-6)."""
    jax_scores, port_scores, own_scores = sweeps
    assert port_scores.shape == GRID and port_scores.dtype == np.float32
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(own_scores, jax_scores, atol=1e-5, rtol=0)


def test_cell_chunking_does_not_change_the_scores(sweeps):
    """Cells are scored independently: another chunking, the same scores
    (within float32 rounding of the batched products)."""
    js = j_synth.make_scene(n_views=4, img_size=32, grid=24, seed=1)
    again = t_sc.plane_sweep_scores(js.cameras, js.images, GRID, patch=PATCH,
                                    cell_chunk=7, device="cpu")
    np.testing.assert_allclose(again, sweeps[1], atol=1e-6, rtol=0)


def test_heightmap_of_the_same_volume_is_identical(sweeps):
    """One score volume into both packages' graph cuts: the same numpy
    data cost and the same solver, so identical height maps."""
    jax_scores = sweeps[0]
    hm = t_sc.scores_to_heightmap(jax_scores.copy())
    np.testing.assert_array_equal(hm, j_sc.scores_to_heightmap(
        jax_scores.copy()))
    assert hm.shape == GRID[:2] and (hm >= -1).all() and (hm <= 1).all()


def test_heightmap_of_each_packages_scores(sweeps):
    """Each package's own scores into its own graph cut: near-ties may flip
    a label where the scores differ by ~1e-6.  Measured share of flipped
    cells on this case: 0 of 64; held to at most 1 in 16."""
    jax_scores, port_scores, _ = sweeps
    flipped = np.mean(t_sc.scores_to_heightmap(port_scores)
                      != j_sc.scores_to_heightmap(jax_scores))
    assert flipped <= 1 / 16


def test_model_grid_and_dsm_modes(tmp_path):
    bounds = np.array([[39.0, 39.009], [-84.0, -83.99], [200.0, 260.0]])
    for voxel in [(2.0, 2.0, 0.25), (1.0, 3.0, 0.5)]:
        assert (t_sc.model_grid_from_bounds(bounds, voxel)
                == j_sc.model_grid_from_bounds(bounds, voxel))
    gt = np.ones((3, 3))
    assert t_sc.get_dsm("LiDAR", [], [], gt_dsm=gt) is not None
    assert t_sc.get_dsm("None", [], []) is None
    with pytest.raises(ValueError, match="ground-truth"):
        t_sc.get_dsm("LiDAR", [], [])
    with pytest.raises(ValueError, match="unknown DSM mode"):
        t_sc.get_dsm("Stereo", [], [])


def test_space_carve_dsm_caches(tmp_path):
    """space_carve_dsm writes SC_<site>_hm.npy and reads it back instead
    of sweeping again."""
    scene = t_synth.make_scene(n_views=3, img_size=16, grid=16, seed=0)
    path = str(tmp_path / "SC_site_hm.npy")
    hm = t_sc.space_carve_dsm(scene.cameras, scene.images, grid_size=(4, 4, 5),
                              patch=2, cache_path=path, device="cpu")
    np.testing.assert_array_equal(np.load(path), hm)
    np.save(path, np.full((4, 4), 0.5, np.float32))
    assert (t_sc.space_carve_dsm([], [], cache_path=path,
                                 device="cpu") == 0.5).all()
