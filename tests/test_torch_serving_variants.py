"""The serving variants of a model trained with the classic irradiance
composite (``Solar_Type_2``) and an HSLuv color head (``use_HSLuv``): the
port's ``RenderService`` and ``Renderer.render_img`` against the JAX
package's on the same model directory, f32 and the exact sine, so held
tightly (the two differ by the trunk fold's re-association, ~3e-6 on
x_enc; HSLuv's conversion to sRGB is f64 numpy in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.render import serving as t_serving
from season_nerf_tpu.config import Config
from season_nerf_tpu.data.ingest import save_world_artifact
from season_nerf_tpu.models.tnerf import model_from_config
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


VIEW, SUN, T, SIZE = (65.0, 40.0), (50.0, 140.0), 0.7, 10
TOL = 1e-4
# Exact shadows: a secondary ray starts on the cube's top face, where the
# last bit of its z decides whether its first step counts.  The packages'
# primary samples differ in their last bit (XLA rounds the interpolation
# along the ray differently), which can flip that step: one flip moves one
# sample's transmittance by up to ~0.05 (measured) and a composited pixel by
# its hit probability times that (measured 5.5e-4)
TOL_EXACT = 2e-3


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    d = tmp_path_factory.mktemp("variant_model_dir")
    cfg = Config(site_name="variant", fc_units=32, fc_layers=3, n_samples=12,
                 chunk=64, compute_dtype="float32", fast_sine=False,
                 Solar_Type_2=True, use_HSLuv=True)
    cfg.save_json(str(d / "opts.json"))
    pts = jax.random.uniform(jax.random.PRNGKey(12), (256, 3), minval=-1,
                             maxval=1)
    v = _init_with_batch_stats(model_from_config(cfg), 11, pts,
                               jnp.ones((256, 3)) / 3 ** 0.5,
                               jnp.ones((256, 4)))
    save_model_artifact(str(d / "Final_Model.nn"), v["params"],
                        v["batch_stats"], meta={})
    save_world_artifact(str(d / "W2C_W2L_H.npy"), None, None, (10.0, 20.0))
    return (j_serving.RenderService(str(d)),
            t_serving.RenderService(str(d), device="cpu"))


@pytest.mark.parametrize("layer,exact", [("season", False), ("base", False),
                                         ("shadow", False),
                                         ("season", True)])
def test_render_view_matches_jax(services, layer, exact):
    jsvc, tsvc = services
    assert tsvc.renderer.classic_solar and tsvc.renderer.use_hsluv
    want = jsvc.render_view(VIEW, SUN, T, size=SIZE, layer=layer,
                            exact_shadow=exact)
    got = tsvc.render_view(VIEW, SUN, T, size=SIZE, layer=layer,
                           exact_shadow=exact)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=TOL_EXACT if exact else TOL,
                               rtol=0)


def test_classic_hsluv_render_img_and_dsm_match_jax(services):
    jsvc, tsvc = services
    want = jsvc.renderer.render_img(VIEW, SUN, T, SIZE)
    got = tsvc.renderer.render_img(VIEW, SUN, T, SIZE)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
    (jd, ju), (td, tu) = jsvc.dsm(SIZE), tsvc.dsm(SIZE)
    assert ju == tu == "meters"
    np.testing.assert_allclose(td, jd, atol=TOL * 5, rtol=0)   # 10 m range
