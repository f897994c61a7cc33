"""The sine's degree (``FAST_SIN_DEGREE``) in the port against the JAX
package: the polynomials of degree 11, 9 and 7 and their error bounds
(``tests/test_model_ops.py``'s), and, in a child process with
``FAST_SIN_DEGREE=7`` (both packages read it when ``fast_math`` is
imported), ``fast_sin``/``fast_cos`` and the plain version of K3 against
the JAX polynomial and ``pallas_mlp.trunk_apply`` in interpret mode; an
invalid degree raises; the CUDA library's path follows the degree (no
``nvcc`` needed to name it).

Tolerances: ``fast_sin`` 1e-6 absolute over |x| <= 1e3, as
``test_torch_trunk.py`` holds degree 11 (the same reduction, the last ulps
of the polynomial); against ``np.sin`` the degree's own bound plus the
reduction's ~3e-4 at |x| ~ 1e3.  K3's plain version at width 512, f32:
3e-4, ``test_torch_trunk.py``'s (the accumulation order).

Seconds on one worker: about 30, most of them the child's JAX init and the
Pallas kernel in interpret mode.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from season_nerf_torch.ops import cuda_build
from season_nerf_torch.ops import fast_math as t_fast_math
from season_nerf_tpu.ops import fast_math as j_fast_math

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = {11: 2.5e-7, 9: 1.5e-5, 7: 6e-4}      # test_model_ops.py:461-472

CHILD = r"""
import json, sys
from season_nerf_torch.ops import cuda_build, fast_math as t_fm

res = {"degree": t_fm.DEGREE, "poly": list(t_fm.POLY),
       "library": cuda_build.library_path("trunk_infer").name,
       "flags": list(cuda_build.NVCC_FLAGS)}
if sys.argv[1] == "full":
    import jax, jax.numpy as jnp, numpy as np, torch
    torch.set_num_threads(1)
    from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
    from season_nerf_torch.ops import fused_trunk as ft
    from season_nerf_torch.utils.convert import state_dict_from_flax
    from season_nerf_tpu.models.tnerf import TNeRF
    from season_nerf_tpu.ops import fast_math as j_fm, pallas_mlp
    res["jax_poly"] = list(j_fm._P)
    x = np.concatenate([np.linspace(-1e3, 1e3, 200_001),
                        np.random.default_rng(1).normal(0, 5, 10_000)]
                       ).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    s = t_fm.fast_sin(xt)
    (g,) = torch.autograd.grad(s.sum(), xt)
    c = t_fm.fast_cos(torch.from_numpy(x)).numpy()
    res["sin_err"] = float(np.abs(s.detach().numpy() - np.asarray(
        j_fm.fast_sin(jnp.asarray(x)))).max())
    res["cos_err"] = float(np.abs(c - np.asarray(
        j_fm.fast_cos(jnp.asarray(x)))).max())
    res["grad_is_cos"] = bool(torch.equal(g, torch.from_numpy(c)))
    pi = np.linspace(-np.pi, np.pi, 40001).astype(np.float32)
    res["sin_vs_np_on_pi"] = float(np.abs(t_fm.fast_sin(
        torch.from_numpy(pi)).numpy() - np.sin(pi.astype(np.float64))).max())
    model = TNeRF(layer_width=512, n_classes=4, fast_sine=True)
    pts = jax.random.uniform(jax.random.PRNGKey(3), (256, 3), minval=-1,
                             maxval=1)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    _, upd = jax.jit(lambda v, *a: model.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        v, pts, jnp.ones((256, 3)) / 3 ** 0.5, jnp.ones((256, 4)))
    v = jax.device_get({"params": v["params"],
                        "batch_stats": upd["batch_stats"]})
    x3 = np.random.default_rng(5).uniform(-1, 1, (512, 3)).astype(np.float32)
    want = np.asarray(pallas_mlp.trunk_apply(
        pallas_mlp.encode_points(jnp.asarray(x3)),
        pallas_mlp.fold_trunk(v, dtype=jnp.float32), True, True))
    tm = TTNeRF(layer_width=512, n_classes=4, fast_sine=True).load_weights(
        state_dict_from_flax(v["params"], v["batch_stats"])).eval()
    got = ft.trunk_apply_reference(
        ft.encode_points(torch.from_numpy(x3)),
        ft.fold_trunk(tm.G_NeRF_net, dtype=torch.float32), True).numpy()
    res["k3_err"] = float(np.abs(got - want).max())
    res["k3_shape"] = list(got.shape)
print(json.dumps(res))
"""


def _child(degree, mode="full"):
    env = {**os.environ, "FAST_SIN_DEGREE": str(degree),
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-c", CHILD, mode], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)


def _json(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def degree7():
    return _json(_child(7))


def test_polys_match_jax_and_their_bounds():
    assert t_fast_math.POLYS == j_fast_math._POLYS
    assert t_fast_math.DEGREE == 11
    assert t_fast_math.POLY == t_fast_math.POLYS[11]
    x = np.linspace(-np.pi, np.pi, 40001)
    for deg, bound in BOUNDS.items():
        p = t_fast_math.POLYS[deg]
        assert len(p) == (deg + 1) // 2
        acc = np.full_like(x, p[0])
        for c in p[1:]:
            acc = acc * (x * x) + c
        assert np.abs(x * acc - np.sin(x)).max() < bound, deg


def test_degree_7_against_jax(degree7):
    r = degree7
    assert r["degree"] == 7
    assert tuple(r["poly"]) == tuple(r["jax_poly"]) == \
        j_fast_math._POLYS[7]
    assert r["sin_err"] <= 1e-6 and r["cos_err"] <= 1e-6
    assert r["grad_is_cos"]
    assert 1e-4 < r["sin_vs_np_on_pi"] < BOUNDS[7]     # degree 7's error
    assert r["k3_shape"] == [512, 256]
    assert r["k3_err"] <= 3e-4


def test_library_follows_the_degree(degree7):
    """Each degree builds its own library (the digest covers it) with
    ``-DFAST_SIN_DEGREE``; degree 11 is this process's."""
    d9 = _json(_child(9, "names"))
    names = {11: cuda_build.library_path("trunk_infer").name,
             9: d9["library"], 7: degree7["library"]}
    assert len(set(names.values())) == 3
    assert all(n.startswith("libtrunk_infer-") for n in names.values())
    assert "-DFAST_SIN_DEGREE=11" in cuda_build.NVCC_FLAGS
    assert "-DFAST_SIN_DEGREE=9" in d9["flags"]
    assert "-DFAST_SIN_DEGREE=7" in degree7["flags"]
    assert cuda_build._ptxas_path("trunk_infer").name == \
        "trunk_infer.deg11.ptxas.txt"


@pytest.mark.parametrize("bad", ["8", "eleven", ""])
def test_invalid_degree_raises(bad):
    env = {**os.environ, "FAST_SIN_DEGREE": bad,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-c", "import season_nerf_torch.ops.fast_math"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "ValueError" in proc.stderr and "FAST_SIN_DEGREE" in proc.stderr
