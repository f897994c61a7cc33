"""The port's depth-guided fast render against the JAX package's:
``surface_window``, ``window_points`` and ``render_chunk_outputs_fast`` on
the same weights, a twin of the JAX tests' analytic peak scene (a localized
surface and empty rays), ``Renderer(fast_render=...)`` on the composite,
exact-shadow and component paths with chunk invariance, and
``load_model_dir``, ``RenderService`` and ``serving.main`` with
``fast_render``.

Two model directories written by the JAX package, both with BatchNorm
statistics from a train-mode pass: an f32 exact-sine one of width 48
(padded to 64 in the fold) and four layers, and a bf16 polynomial-sine one
of width 32 and two layers.  f32 is held tightly, as in
``test_torch_render.py``: the two packages differ by the fold's
re-association (~3e-6 on x_enc), too little to move a sample across the
window's 5 % support threshold.  bf16 loosely: the packages round in other
places (x_enc up to ~0.08 apart), which may move a window edge by a coarse
bin, so the bf16 windows are held to a bin and the images to the tolerance
of the uniform path's bf16 test.  The peak scene is plain arithmetic in
both packages: 1e-5 (torch's and XLA's exp and sin differ in the last
bits, and a window edge sits where the hit probability crosses 5 % of its
peak, far from any sample at this scene's sharpness).

Seconds on one worker: about 60, most of them the JAX side's compiles and
its service's model init (op by op, 15 s).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.render import renderer as t_renderer
from season_nerf_torch.render import serving as t_serving
from season_nerf_tpu.config import Config
from season_nerf_tpu.data.ingest import save_world_artifact
from season_nerf_tpu.models.tnerf import model_from_config
from season_nerf_tpu.render import renderer as j_renderer
from season_nerf_tpu.render import serving as j_serving
from season_nerf_tpu.train.state import (restore_variables,
                                         save_model_artifact)

torch.set_num_threads(1)

VIEW, SUN, T, SIZE = (72.0, 25.0), (50.0, 150.0), 0.35, 10
FAST = (8, 8)
# (windows and per-sample outputs, images) max abs; a quarter on the mean
TOL = {"f32_dir": (1e-5, 1e-4), "bf16_dir": (None, 2e-2)}


def _model_dir(tmp_path_factory, name, **kw):
    d = tmp_path_factory.mktemp(name)
    cfg = Config(site_name=name, n_samples=12, chunk=37, **kw)
    cfg.save_json(str(d / "opts.json"))
    model = model_from_config(cfg)
    v = _init(model, 3)
    pts = jax.random.uniform(jax.random.PRNGKey(4), (512, 3), minval=-1,
                             maxval=1)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        v, pts, jnp.ones((512, 3)) / 3 ** 0.5, jnp.ones((512, 4)))
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        upd["batch_stats"], meta={})
    save_world_artifact(str(d / "W2C_W2L_H.npy"), None, None, (0.0, 30.0))
    return str(d)


@pytest.fixture(scope="module")
def f32_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory, "fast_f32", fc_units=48,
                      fc_layers=4, compute_dtype="float32", fast_sine=False)


@pytest.fixture(scope="module")
def bf16_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory, "fast_bf16", fc_units=32,
                      fc_layers=2, compute_dtype="bfloat16", fast_sine=True)


def _init(model, seed=0):
    return jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)


@pytest.fixture(scope="module", params=sorted(TOL))
def loaded(request):
    """(JAX model, its variables and fast Renderer; the port's loaded model
    directory; tolerances).  The JAX side is restored as its
    ``load_model_dir`` does, with a jitted init (its own is op by op)."""
    d = request.getfixturevalue(request.param)
    cfg = Config.load_json(os.path.join(d, "opts.json"))
    model = model_from_config(cfg)
    v, _ = restore_variables(_init(model),
                             os.path.join(d, "Final_Model.nn"))
    jr = j_renderer.Renderer(model, v, n_samples=cfg.n_samples,
                             chunk=cfg.chunk, fast_render=FAST)
    t = t_loading.load_model_dir(d, fast_render=FAST, device="cpu")
    return (model, jr.variables, jr), t, TOL[request.param]


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
    assert np.nanmean(np.abs(got - want)) <= atol / 4, what


def _rays(view=VIEW, size=SIZE):
    v = t_renderer._default_angles_to_vec(None)(*view)
    tops, bots, _ = t_renderer.dir_grid_rays(v, (size, size))
    n = tops.shape[0]
    sun = np.broadcast_to(np.array([0.3, 0.2, 0.93], np.float32), (n, 3))
    t4 = np.broadcast_to(t_renderer.encode_time(T), (n, 4))
    return [np.ascontiguousarray(a, np.float32) for a in (tops, bots, sun, t4)]


def test_surface_window_and_window_points(loaded):
    (jm, jv, _), t, (tol, _) = loaded
    tops, bots, _, _ = _rays()
    jt = (jnp.asarray(tops), jnp.asarray(bots))
    tt = (torch.from_numpy(tops), torch.from_numpy(bots))
    want = [np.array(a) for a in jax.jit(
        lambda v, a, b: j_renderer.surface_window(jm, v, a, b, 16))(jv, *jt)]
    with torch.no_grad():
        got = [a.numpy() for a in t_renderer.surface_window(t.model, *tt, 16)]
    bin_ = 1.0 / 15
    for g, w, name in zip(got, want, ("t_lo", "t_hi")):
        assert g.shape == w.shape == (SIZE * SIZE,)
        assert ((g >= 0) & (g <= 1)).all(), name
        np.testing.assert_allclose(g, w, atol=tol or bin_ + 1e-6, rtol=0,
                                   err_msg=name)
    assert (got[1] - got[0] >= 2.0 / 16 - 1e-6).all()
    # the points of a window: the JAX window into both
    jp, jd = j_renderer.window_points(*jt, *map(jnp.asarray, want), 8)
    tp, td = t_renderer.window_points(*tt, *map(torch.from_numpy, want), 8)
    assert tp.shape == (SIZE * SIZE, 8, 3) and td.shape == (SIZE * SIZE, 8, 1)
    _close(tp.numpy(), np.asarray(jp), 1e-6, "pts")
    _close(td.numpy(), np.asarray(jd), 1e-6, "deltas")


@pytest.mark.parametrize("classic_solar", [False, True])
def test_render_chunk_outputs_fast(loaded, classic_solar):
    (jm, jv, _), t, (_, tol) = loaded
    rays = _rays()
    want = jax.jit(lambda v, *a: j_renderer.render_chunk_outputs_fast(
        jm, v, *a, n_coarse=16, n_fine=8, classic_solar=classic_solar,
        with_samples=True))(jv, *map(jnp.asarray, rays))
    with torch.no_grad():
        got = t_renderer.render_chunk_outputs_fast(
            t.model, *map(torch.from_numpy, rays), n_coarse=16, n_fine=8,
            classic_solar=classic_solar, with_samples=True)
    assert set(got) == set(want)
    for k in want:
        _close(got[k].float().numpy(), np.asarray(want[k], np.float32),
               tol, k)


# --- the analytic peak scene ----------------------------------------------------
class PeakSceneModel(torch.nn.Module):
    """The twin of ``tests/test_render.py::_PeakSceneModel``: a sharp
    density peak at z = z0(x, y) and a position-dependent color, in the
    port's model interface."""

    n_classes = 4

    def __init__(self, z0=0.15, width=0.04, amp=80.0):
        super().__init__()
        self.z0, self.width, self.amp = z0, width, amp
        self.anchor = torch.nn.Parameter(torch.zeros(1))   # the device

    def _sigma(self, x):
        surf = self.z0 + 0.1 * torch.sin(2.0 * x[:, 0]) * torch.cos(x[:, 1])
        return self.amp * torch.exp(-(((x[:, 2:3] - surf[:, None])
                                       / self.width) ** 2))

    def sigma_only(self, x):
        return self._sigma(x)

    def ray_consts(self, sun, t4):
        R = sun.shape[0]
        return (torch.full((R, self.n_classes), 1.0 / self.n_classes),
                torch.zeros((R, 2)), torch.zeros((R, 3)))

    def _common(self, x):
        n = x.shape[0]
        return {"rho": self._sigma(x), "vis": torch.full((n, 1), 0.9),
                "sky": torch.full((n, 3), 0.3),
                "class_probs": torch.full((n, self.n_classes),
                                          1.0 / self.n_classes)}

    def forward(self, x, sun_dir, t4, probs=None, sun_pe=None, sky_raw=None):
        return {**self._common(x), "col": torch.sigmoid(x * 2.0),
                "adjust": torch.zeros((x.shape[0], 3))}

    def forward_separate(self, x, sun_dir, t4, probs=None, sun_pe=None,
                         sky_raw=None):
        return {**self._common(x), "col_raw": x * 2.0,
                "adjust_per_class": torch.zeros((x.shape[0],
                                                 self.n_classes, 3))}


def _peak_rays(v, size):
    v = np.asarray(v, np.float64) / np.linalg.norm(v)
    tops, bots, _ = t_renderer.dir_grid_rays(v, (size, size))
    n = tops.shape[0]
    sun = np.broadcast_to(np.float32([0.2, 0.2, 0.95]), (n, 3))
    t4 = np.broadcast_to(t_renderer.encode_time(0.3), (n, 4))
    return [np.ascontiguousarray(a, np.float32) for a in (tops, bots, sun, t4)]


@pytest.mark.parametrize("classic_solar", [False, True])
def test_fast_render_on_a_localized_surface(classic_solar):
    """On a localized surface the windowed composite matches a dense
    uniform one (the JAX test's 0.02), and the port's fast render matches
    the JAX package's on the JAX twin of the scene (1e-5)."""
    from tests.test_render import _PeakSceneModel
    rays = _peak_rays([0.25, 0.1, 0.95], 12)
    tr = [torch.from_numpy(a) for a in rays]
    model = PeakSceneModel()
    exact = t_renderer.render_chunk_outputs(
        model, *tr, n_samples=96, classic_solar=classic_solar)
    fast = t_renderer.render_chunk_outputs_fast(
        model, *tr, n_coarse=32, n_fine=32, classic_solar=classic_solar)
    want = jax.jit(lambda *a: j_renderer.render_chunk_outputs_fast(
        _PeakSceneModel(), {}, *a, n_coarse=32, n_fine=32,
        classic_solar=classic_solar))(*map(jnp.asarray, rays))
    for k in ("rendered", "height", "shadow_raw", "ps_sum"):
        np.testing.assert_allclose(fast[k].numpy(), exact[k].numpy(),
                                   atol=0.02, err_msg=k)
        np.testing.assert_allclose(fast[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_fast_render_empty_rays_well_formed():
    rays = _peak_rays([0.0, 0.0, 1.0], 4)
    model = PeakSceneModel(amp=0.0)
    t_lo, t_hi = t_renderer.surface_window(
        model, torch.from_numpy(rays[0]), torch.from_numpy(rays[1]), 16)
    assert torch.equal(t_lo, torch.zeros(16))
    assert torch.equal(t_hi, torch.ones(16))
    out = t_renderer.render_chunk_outputs_fast(
        model, *map(torch.from_numpy, rays), n_coarse=16, n_fine=8,
        classic_solar=False)
    for k in ("rendered", "height", "shadow_raw", "ps_sum"):
        assert torch.isfinite(out[k]).all(), k
    np.testing.assert_allclose(out["ps_sum"].numpy(), 0.0, atol=1e-5)


def test_fast_component_render_on_a_localized_surface():
    """The component path under fast rendering: n_fine samples a ray, and
    the composited images agree with the uniform sampler's (0.02, the JAX
    test's) and with the JAX package's fast ones (1e-5)."""
    from tests.test_render import _PeakSceneModel
    kw = dict(view_el_az=(75, 30), sun_el_az=(50, 200), time_frac=0.3,
              out_size=(10, 10))
    model = PeakSceneModel()
    exact = t_renderer.Renderer(model, n_samples=96, chunk=4096)
    fast = t_renderer.Renderer(model, n_samples=96, chunk=4096,
                               fast_render=(32, 32))
    res_e = exact.component_render_by_dir(**kw)
    res_f = fast.component_render_by_dir(**kw)
    assert res_f["rho"].shape == (100, 32, 1)
    want = j_renderer.Renderer(_PeakSceneModel(), {}, n_samples=96,
                               chunk=4096, fast_render=(32, 32)
                               ).component_render_by_dir(**kw)
    imgs_e = t_renderer.images_from_components(res_e, (10, 10))
    imgs_f = t_renderer.images_from_components(res_f, (10, 10))
    imgs_j = j_renderer.images_from_components(want, (10, 10))
    for k in ("Base_Img", "Season_Adj_Img", "Shadow_Mask"):
        np.testing.assert_allclose(imgs_f[k], imgs_e[k], atol=0.02,
                                   err_msg=k)
        np.testing.assert_allclose(imgs_f[k], imgs_j[k], atol=1e-5, rtol=0,
                                   err_msg=k)


# --- the Renderer ------------------------------------------------------------------
@pytest.mark.parametrize("exact", [False, True])
def test_fast_renderer_render_img(loaded, exact):
    (_, _, jr), t, (_, tol) = loaded
    assert t.renderer.fast_render == jr.fast_render == FAST
    assert t.renderer._out_samples == 8
    want = jr.render_img(VIEW, SUN, T, SIZE, exact_shadow=exact)
    got = t.renderer.render_img(VIEW, SUN, T, SIZE, exact_shadow=exact)
    assert set(got) == set(want)
    assert ("Exact_Shadow_Mask" in got) == exact
    for k in want:
        _close(got[k], want[k], tol, k)


def test_fast_renderer_chunk_invariance(loaded):
    """The fast output does not depend on the chunk (each ray's window is
    its own): a chunk that divides nothing against one chunk."""
    _, t, _ = loaded
    r = t.renderer
    one = t_renderer.Renderer(r.model, n_samples=r.n_samples,
                              chunk=SIZE * SIZE, fast_render=FAST)
    a = r.render_img(VIEW, SUN, T, SIZE, exact_shadow=True)
    b = one.render_img(VIEW, SUN, T, SIZE, exact_shadow=True)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)


def test_fast_renderer_component_render(loaded):
    (_, _, jr), t, (tol, img_tol) = loaded
    want = jr.component_render_by_dir(VIEW, SUN, T, (SIZE, SIZE + 2),
                                              exact_solar=True)
    got = t.renderer.component_render_by_dir(VIEW, SUN, T, (SIZE, SIZE + 2),
                                             exact_solar=True)
    assert got["rho"].shape == (SIZE * (SIZE + 2), 8, 1)
    assert got["exact_solar"].shape == (SIZE * (SIZE + 2), 8, 1)
    if tol is not None:                 # f32: every per-sample output
        for k in ("pts", "deltas", "rho", "col_raw", "vis", "sky",
                  "class_probs", "adjust_per_class", "exact_solar"):
            _close(got[k], want[k], 1e-4, k)
    wi = j_renderer.images_from_components(want, (SIZE, SIZE + 2))
    gi = t_renderer.images_from_components(got, (SIZE, SIZE + 2))
    for k in ("Base_Img", "Season_Adj_Img", "Shadow_Mask",
              "Shadow_Mask_Exact"):
        _close(gi[k], wi[k], img_tol, k)


# --- loading and serving ----------------------------------------------------------
def test_render_service_with_fast_render(f32_dir):
    """``RenderService(fast_render=...)`` against the JAX service on the
    same directory: ``info()`` and each layer (1e-4, the f32 images')."""
    jsvc = j_serving.RenderService(f32_dir, fast_render=FAST)
    tsvc = t_serving.RenderService(f32_dir, fast_render=FAST, device="cpu")
    assert tsvc.info()["fast_render"] == jsvc.info()["fast_render"] == [8, 8]
    assert t_serving.RenderService(f32_dir, device="cpu").info()[
        "fast_render"] is None
    for layer, exact in (("season", False), ("base", False),
                         ("shadow", False), ("season", True)):
        want = jsvc.render_view(VIEW, SUN, T, size=SIZE, layer=layer,
                                exact_shadow=exact)
        got = tsvc.render_view(VIEW, SUN, T, size=SIZE, layer=layer,
                               exact_shadow=exact)
        _close(got, want, 1e-4, f"{layer} exact={exact}")
    (jd, ju), (td, tu) = jsvc.dsm(SIZE), tsvc.dsm(SIZE)
    assert ju == tu == "meters"
    _close(td, jd, 1e-4 * 15, "dsm")            # meters over a 30 m range


def test_serving_main_takes_fast_render(f32_dir, monkeypatch):
    made = {}

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            made["served"] = True

    def make_server(service, host, port):
        made["service"] = service
        return _Server()

    monkeypatch.setattr(t_serving, "make_server", make_server)
    t_serving.main(["--Model_Location", f32_dir, "--device", "cpu",
                    "--fast_render", "6", "4"])
    assert made["served"]
    svc = made["service"]
    assert svc.renderer.fast_render == (6, 4)
    assert svc.info()["fast_render"] == [6, 4]
    img = svc.render_view(VIEW, SUN, T, size=6)
    assert img.shape == (6, 6, 3) and np.isfinite(img).all()
