"""The port's render and serve slice against the JAX package on the same
model directories: ``Renderer.render_img`` with and without exact shadows,
``get_dsm``, ``component_render_by_dir`` + ``images_from_components``, the
HTTP service and the CLI render.

Two model directories, both written by the JAX package: ``tiny_model_dir``
(bf16, polynomial sine, width 32, two layers) and an f32 exact-sine one of
width 48 (padded to 64 in the fold), four layers and BatchNorm statistics
from a train-mode pass, rendered with a chunk that does not divide the ray
count.  f32 is held tightly: the two differ by the fold's re-association
(~3e-6 on x_enc).  bf16 loosely: the two round in different places."""

import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from season_nerf_torch import cli as t_cli
from season_nerf_torch.ops import fused_trunk
from season_nerf_torch.render import loading as t_loading
from season_nerf_torch.render import renderer as t_renderer
from season_nerf_torch.render import serving as t_serving
from season_nerf_tpu.config import Config
from season_nerf_tpu.data.ingest import save_world_artifact
from season_nerf_tpu.models.tnerf import model_from_config
from season_nerf_tpu.render import loading as j_loading
from season_nerf_tpu.render import renderer as j_renderer
from season_nerf_tpu.render import serving as j_serving
from season_nerf_tpu.train.state import save_model_artifact

torch.set_num_threads(1)


def _init_with_batch_stats(model, seed, pts, sun, t4):
    """Initialise ``model`` and give its BatchNorms running statistics that
    are not trivial, from one train-mode pass (both jitted: one compile
    costs less than flax's op-by-op dispatch)."""
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, pts, sun, t4)
    return {"params": v["params"], "batch_stats": upd["batch_stats"]}


VIEW, SUN, T = (70.0, 30.0), (45.0, 160.0), 0.4
SIZE = 12


@pytest.fixture(scope="module")
def f32_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("f32_model_dir")
    cfg = Config(site_name="f32", fc_units=48, fc_layers=4, n_samples=12,
                 chunk=50, compute_dtype="float32", fast_sine=False)
    cfg.save_json(str(d / "opts.json"))
    pts = jax.random.uniform(jax.random.PRNGKey(8), (512, 3), minval=-1,
                             maxval=1)
    v = _init_with_batch_stats(model_from_config(cfg), 7, pts,
                               jnp.ones((512, 3)) / 3 ** 0.5,
                               jnp.ones((512, 4)))
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        v["batch_stats"], meta={})
    save_world_artifact(str(d / "W2C_W2L_H.npy"), None, None, None)
    return str(d)


# model dir fixture name -> (images, raw per-sample components): the max
# absolute difference, and a quarter of it on the mean.  bf16 rounds in other
# places in the two packages (x_enc differs by up to ~0.08); composited
# images average that out (measured max 8e-3), while single samples of the
# raw logits keep it (measured: adjust max 0.045, mean 0.006)
TOL = {"f32_model_dir": (1e-4, 1e-4), "tiny_model_dir": (2e-2, 6e-2)}


@pytest.fixture(scope="module", params=sorted(TOL))
def renderers(request):
    d = request.getfixturevalue(request.param)
    j = j_loading.load_model_dir(d)
    t = t_loading.load_model_dir(d, device="cpu")
    assert t.renderer.device.type == "cpu"
    assert t.renderer.chunk == j.renderer.chunk
    return j.renderer, t.renderer, TOL[request.param]


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
    assert np.nanmean(np.abs(got - want)) <= atol / 4, what


@pytest.mark.parametrize("exact", [False, True])
def test_render_img(renderers, exact):
    jr, tr, (tol, _) = renderers
    want = jr.render_img(VIEW, SUN, T, SIZE, exact_shadow=exact)
    got = tr.render_img(VIEW, SUN, T, SIZE, exact_shadow=exact)
    assert set(got) == set(want)
    assert ("Exact_Shadow_Mask" in got) == exact
    for k in want:
        _close(got[k], want[k], tol, k)


def test_get_dsm(renderers):
    jr, tr, (tol, _) = renderers
    _close(tr.get_dsm(SIZE), jr.get_dsm(SIZE), tol, "dsm")


def test_component_render_and_images(renderers):
    jr, tr, (tol, comp_tol) = renderers
    want = jr.component_render_by_dir(VIEW, SUN, T, (SIZE, SIZE + 3),
                                      exact_solar=True)
    got = tr.component_render_by_dir(VIEW, SUN, T, (SIZE, SIZE + 3),
                                     exact_solar=True)
    for k in ("pts", "deltas", "rho", "col_raw", "vis", "sky",
              "class_probs", "adjust_per_class", "exact_solar", "img_pts",
              "sun_vec"):
        _close(got[k], want[k], comp_tol, k)
    for classic in (False, True):
        wi = j_renderer.images_from_components(want, (SIZE, SIZE + 3),
                                               classic)
        gi = t_renderer.images_from_components(got, (SIZE, SIZE + 3),
                                               classic)
        assert set(gi) == set(wi)
        for k in wi:
            if k == "Extreme_Imgs":
                for a, b in zip(gi[k], wi[k], strict=True):
                    _close(a, b, tol, k)
            else:
                _close(gi[k], wi[k], tol, k)


def test_render_perspective(renderers):
    jr, tr, (tol, _) = renderers
    args = ((0.2, -1.5, 0.6), 20.0, 80.0, 50.0, SIZE, SUN, T)
    want, got = jr.render_perspective(*args), tr.render_perspective(*args)
    for k in want:
        _close(got[k], want[k], tol, k)


def test_every_chunk_goes_through_the_trunk(f32_model_dir):
    """The wrapper is called once per chunk on the composite path and once
    per step per point chunk on the exact-solar path (on the CPU it runs
    the plain version and counts no launch)."""
    calls = []
    real = fused_trunk.trunk_apply

    def spy(pe, folded, fast_sine=False):
        calls.append(pe.shape[0])
        return real(pe, folded, fast_sine)

    r = t_loading.load_model_dir(f32_model_dir, device="cpu").renderer
    fused_trunk.trunk_apply = spy
    try:
        r.render_img(VIEW, SUN, T, SIZE, exact_shadow=True)
    finally:
        fused_trunk.trunk_apply = real
    rays, S, chunk = SIZE * SIZE, r.n_samples, r.chunk
    n_comp = -(-rays // chunk)
    n_pts = -(-(rays * S) // chunk)
    assert len(calls) == n_comp + n_pts * (S - 1)
    assert calls[:n_comp] == [min(chunk, rays - i * chunk) * S
                              for i in range(n_comp)]
    assert max(calls[n_comp:]) == chunk


def test_no_silent_fallback_to_the_cpu(tiny_model_dir):
    """Entry points default to the card; without one they fail rather
    than render on the CPU."""
    with pytest.raises((RuntimeError, AssertionError)):
        t_loading.load_model_dir(tiny_model_dir)


# --- HTTP service ---------------------------------------------------------------
@pytest.fixture(scope="module")
def services(tiny_model_dir):
    jsvc = j_serving.RenderService(tiny_model_dir)
    tsvc = t_serving.RenderService(tiny_model_dir, device="cpu")
    srv = t_serving.make_server(tsvc, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", jsvc, tsvc
    srv.shutdown()
    srv.server_close()
    th.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, r.headers, r.read()


@pytest.mark.parametrize("query,layer,exact", [
    ("size=16&t=07/19", "season", False),
    ("size=16&t=07/19&layer=base", "base", False),
    ("size=16&t=07/19&layer=shadow", "shadow", False),
    ("size=8&t=07/19&exact_shadow=1", "season", True)])
def test_http_render_matches_jax_service(services, query, layer, exact):
    base, jsvc, _ = services
    status, headers, body = _get(
        f"{base}/render?view_el=70&view_az=30&sun_el=45&sun_az=160&{query}")
    assert status == 200 and headers["Content-Type"] == "image/png"
    size = 8 if exact else 16
    want = jsvc.render_view((70.0, 30.0), (45.0, 160.0),
                            j_serving.parse_time("07/19"), size=size,
                            layer=layer, exact_shadow=exact)
    want_px = np.asarray(Image.open(io.BytesIO(j_serving._png_bytes(want))),
                         np.int16)
    got_px = np.asarray(Image.open(io.BytesIO(body)), np.int16)
    assert got_px.shape == want_px.shape
    # bf16 model: colors within 2e-2, i.e. 6 of 255 levels after truncation
    assert np.abs(got_px - want_px).max() <= 6


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_http_dsm_matches_jax_service(services, fmt):
    base, jsvc, tsvc = services
    status, headers, body = _get(f"{base}/dsm?size=16&format={fmt}")
    assert status == 200
    want, units = jsvc.dsm(16)
    assert headers["X-DSM-Units"] == units == "meters"
    if fmt == "npy":
        got = np.load(io.BytesIO(body))
        # heights in meters over the site's 30 m range: 2e-2 of the cube
        _close(got, want, 2e-2 * 15, "dsm")
    else:
        got_px = np.asarray(Image.open(io.BytesIO(body)), np.int16)
        want_px = np.asarray(Image.open(io.BytesIO(
            j_serving._png_bytes(want, stretch=True))), np.int16)
        np.testing.assert_array_equal(got_px == 0, want_px == 0)
        assert np.abs(got_px - want_px).max() <= 16


def test_http_info_and_errors(services):
    base, _, tsvc = services
    status, _, body = _get(base + "/healthz")
    info = json.loads(body)
    assert status == 200 and info["status"] == "ok"
    assert info["device"] == "cpu" and info["fc_units"] == 32
    for bad in ("/render?layer=nope", "/render?t=1.5",
                "/render?exact_shadow=maybe"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + bad)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nothing")
    assert e.value.code == 404


# --- CLI ----------------------------------------------------------------------------
def test_cli_render_matches_jax(tiny_model_dir, tmp_path):
    from season_nerf_tpu.cli import render_pretrained
    out = str(tmp_path / "view.png")
    t_cli.main(["render", "--Model_Location", tiny_model_dir, "--VA", "70",
                "30", "--SA", "45", "160", "--tf", "07/19", "--Output_Size",
                "10", "12", "8", "--exact_shadow", "--Save_Name", out,
                "--device", "cpu"])
    want, _ = render_pretrained(tiny_model_dir, (70, 30), (45, 160), "07/19",
                                out_size=(10, 12, 8), exact_shadow=True)
    got = np.asarray(Image.open(out), np.int16)
    want_px = (np.clip(np.nan_to_num(want), 0, 1) * 255).astype(np.int16)
    assert got.shape == (10, 12, 3)
    assert np.abs(got - want_px).max() <= 6
