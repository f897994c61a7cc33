"""K3 (the fused inference trunk) and K0 (the polynomial sine) of the port
against the JAX package: the fold against ``pallas_mlp.fold_trunk``, the
plain version of the kernel against ``pallas_mlp.trunk_apply`` in interpret
mode, and ``fast_sin`` against ``fast_math._poly_sin(_reduced(x))``.

The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``
holds it against the plain version tested here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.models.encodings import (encoded_size,
                                                positional_encode as t_pe)
from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
from season_nerf_torch.ops import fast_math as t_fast_math
from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.utils import trace
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.models.encodings import positional_encode as j_pe
from season_nerf_tpu.models.tnerf import TNeRF
from season_nerf_tpu.ops import fast_math, pallas_mlp

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


def _port_model(variables, **kw):
    v = jax.device_get(variables)
    return TTNeRF(**kw).load_weights(state_dict_from_flax(
        v["params"], v.get("batch_stats", {}))).eval()


@pytest.fixture(scope="module")
def flagship_vars():
    """Full-width (512) trunk with BN running stats from a train-mode pass,
    so that the fold meets statistics that are not trivial."""
    pts = jax.random.uniform(jax.random.PRNGKey(3), (256, 3), minval=-1,
                             maxval=1)
    return _init_with_batch_stats(TNeRF(layer_width=512, n_classes=4), 0,
                                  pts, jnp.ones((256, 3)) / 3 ** 0.5,
                                  jnp.ones((256, 4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_matches_jax_fold(flagship_vars, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = pallas_mlp.fold_trunk(flagship_vars, dtype=jdt)
    got = ft.fold_trunk(_port_model(flagship_vars).G_NeRF_net, dtype=dtype)
    assert got.inputs == ["pe", "h", "h", "h", "h+pe", "h", "h", "h", "h"]
    assert got.width_pad == 512 and got.out_features == 256
    for i, name in enumerate(["fc1", "fc2", "fc3", "fc4", "fc5", "fc6",
                              "fc7", "fc8", "fc9"]):
        w, b = got.weights[i].float().numpy().T, got.biases[i].numpy()
        want_w = np.asarray(want[name + "_w"], np.float32)
        want_b = np.asarray(want[name + "_b"])
        if name == "fc1":
            # fc1 has no BatchNorm, yet the JAX fold scales it by
            # 1/sqrt(1 + eps) (pallas_mlp.py:73-82 folds var = 1); the flax
            # module does not, and the port follows the module
            s = 1 / np.sqrt(1 + 1e-5)
            rtol = 1e-6 if dtype == torch.float32 else 2 ** -7   # 1 ulp
            np.testing.assert_allclose(w * s, want_w, rtol=rtol, atol=0)
            np.testing.assert_allclose(b * s, want_b, rtol=1e-6, atol=0)
            continue
        # the same f64 fold cast once: equal bit for bit, [out, in] here
        np.testing.assert_array_equal(w, want_w, err_msg=name)
        np.testing.assert_array_equal(b, want_b, err_msg=name)


@pytest.mark.parametrize("fast_sine", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_trunk_matches_pallas_kernel(flagship_vars, dtype, fast_sine):
    """The plain version of K3 computes what the Pallas kernel computes
    (run as its own tests run it on the CPU: interpret mode), at the
    flagship width on one 512-row tile."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pts = np.random.default_rng(5).uniform(-1, 1, (512, 3)).astype(np.float32)
    pe_j = pallas_mlp.encode_points(jnp.asarray(pts))
    want = np.asarray(pallas_mlp.trunk_apply(
        pe_j, pallas_mlp.fold_trunk(flagship_vars, dtype=jdt), True,
        fast_sine))
    pe_t = ft.encode_points(torch.from_numpy(pts))
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), atol=1e-6)
    got = ft.trunk_apply_reference(
        pe_t, ft.fold_trunk(_port_model(flagship_vars).G_NeRF_net,
                            dtype=dtype), fast_sine).numpy()
    # f32: accumulation order only; bf16: that can flip a bf16 rounding of
    # an activation, which propagates through the later layers (a few
    # bf16 ulps at nine layers)
    atol = 3e-4 if dtype == torch.float32 else 6e-2
    np.testing.assert_allclose(got, want, atol=atol)
    assert got.shape == (512, 256)


@pytest.mark.parametrize("fast_sine", [False, True])
def test_fused_trunk_heads_match_jax_fused_trunk(flagship_vars, fast_sine):
    """``FusedTrunk.sigma``/``sigma_color`` against the JAX ``FusedTrunk``
    (Pallas kernel in interpret mode), f32, on a ragged row count."""
    pts = np.random.default_rng(6).uniform(-1, 1, (300, 3)).astype(np.float32)
    jft = pallas_mlp.FusedTrunk(TNeRF(layer_width=512, n_classes=4),
                                flagship_vars, interpret=True,
                                fast_sine=fast_sine)
    g = _port_model(flagship_vars, fast_sine=fast_sine).G_NeRF_net
    tft = ft.FusedTrunk(g)
    assert tft.fast_sine == fast_sine
    x = torch.from_numpy(pts)
    # x_enc within the 3e-4 of test_plain_trunk_matches_pallas_kernel; the
    # heads are 256-wide dot products of it with weights ~U(+-0.005)
    np.testing.assert_allclose(tft.sigma(x).numpy(),
                               np.asarray(jft.sigma(jnp.asarray(pts))),
                               atol=3e-4, rtol=0)
    for got, want in zip(tft.sigma_color(x),
                         jft.sigma_color(jnp.asarray(pts))):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                                   rtol=0)


@pytest.mark.parametrize("width,depth,fast_sine", [(32, 2, False),
                                                   (64, 3, True),
                                                   (96, 7, False)])
def test_layer_table_serves_every_depth_and_width(width, depth, fast_sine):
    """The fold is a layer table: fused x_enc equals the flax eval trunk at
    any width and depth ``model_from_config`` builds (widths padded to the
    kernel's multiple, the skip layer's [h | PE] laid out padded)."""
    model = TNeRF(layer_width=width, n_layers=depth, n_classes=2,
                  fast_sine=fast_sine)
    pts = np.random.default_rng(depth).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    variables = _init_with_batch_stats(model, width, jnp.asarray(pts),
                                       jnp.ones((300, 3)), jnp.ones((300, 4)))
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False,
        method=lambda m, x, train: m.gnerf.encode_x(x, train)))(
            variables, jnp.asarray(pts)))
    g = _port_model(variables, layer_width=width, n_layers=depth,
                    n_classes=2, fast_sine=fast_sine).G_NeRF_net
    folded = ft.fold_trunk(g)
    assert folded.width_pad % ft.MULTIPLE == 0
    assert all(w.shape[0] % ft.MULTIPLE == 0 and w.shape[1] % 16 == 0
               for w in folded.weights)
    got = g.encode_x(torch.from_numpy(pts)).numpy()
    assert got.shape == (300, max(width // 2, 1))
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("width", [32, 96, 512, 768])
def test_f32_plan_streams_every_layer(width):
    """The f32 kernel's host side: the fold's ring copy holds every W' as
    W'^T [k, n], the layers one after the other; the plan (built once) says
    per layer b', k, n, the activation row where its input starts (the PE's
    rows follow h's width_pad rows: fc1 reads them alone, the skip layer
    reads [h | PE] from row 0 on), the copy's offset, and the input's k
    where the PE starts.  Then the kernel's walk, emulated in float64 on
    the tile's K-major activations with W'^T read kKs = 8 rows a slot,
    gives the plain version's x_enc."""
    g = TTNeRF(layer_width=width, n_layers=8).eval().G_NeRF_net
    folded = ft.fold_trunk(g)
    plan = folded.f32_plan()
    assert plan is folded.f32_plan()                     # built once
    assert plan.dtype == torch.int64 and plan.device.type == "cpu"
    wp = -(-width // 128) * 128
    assert folded.width_pad == wp <= ft.MAX_WIDTH
    out_pad = -(-(width // 2) // 128) * 128
    want_k = [64] + [wp] * 3 + [wp + 64] + [wp] * 4
    want_n = [wp] * 8 + [out_pad]
    want_in = [wp] + [0] * 8
    want_pe = [0, -1, -1, -1, wp, -1, -1, -1, -1]
    ring = folded.ring_weights
    assert ring.dtype == torch.float32 and ring.is_contiguous()
    assert ring.numel() == sum(k * n for k, n in zip(want_k, want_n))
    off = 0
    for l, row in enumerate(plan.tolist()):
        w, b = folded.weights[l], folded.biases[l]
        assert row == [b.data_ptr(), want_k[l], want_n[l], want_in[l], off,
                       want_pe[l]], l
        assert torch.equal(ring[off:off + w.numel()].view(want_k[l],
                                                          want_n[l]), w.t())
        off += w.numel()
    assert len(plan) <= ft.MAX_LAYERS
    # the kernel's walk: act[k][row], the PE in rows wp .. wp + 63; each
    # layer reads rows in_k .. in_k + k - 1 and writes rows 0 .. n - 1
    rows = 5
    pe = ft.encode_points(torch.from_numpy(np.random.default_rng(width)
                          .uniform(-1, 1, (rows, 3)).astype(np.float32)))
    act = np.zeros((wp + 64, rows))
    act[wp:] = pe.double().numpy().T
    r = ring.double().numpy()
    for l, (bp, k, n, in_k, w_off, pe_k) in enumerate(plan.tolist()):
        z = np.repeat(folded.biases[l].double().numpy()[:, None], rows, 1)
        for kc in range(0, k, 8):            # one ring slot
            slot = r[w_off + kc * n:w_off + (kc + 8) * n].reshape(8, n)
            z += slot.T @ act[in_k + kc:in_k + kc + 8]
        act[:n] = np.sin(z)
    want = ft.trunk_apply_reference(pe, folded).double().numpy()
    np.testing.assert_allclose(act[:folded.out_features].T, want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("width", [32, 96, 512])
def test_launch_plan_maps_every_layer(width):
    """The bf16 kernel's host-side plan: per layer W' as [n, k] with n a
    multiple of 128 and k of 64, a tensor map box of 64 K x SLOT_ROWS /
    CLUSTER W' rows (each CTA of the cluster loads its share of a slot of
    the kernel's weight ring and multicasts it), W''s row stride, and the
    K chunk that reads the PE: fc1's only chunk, the skip layer's chunk
    after h's."""
    g = TTNeRF(layer_width=width, n_layers=8).eval().G_NeRF_net
    folded = ft.fold_trunk(g, dtype=torch.bfloat16)
    plan = folded.launch_plan()
    assert plan is folded.launch_plan()                  # built once
    assert plan.dtype == torch.int64 and plan.device.type == "cpu"
    wp = -(-width // 128) * 128
    assert folded.width_pad == wp
    out_pad = -(-(width // 2) // 128) * 128
    want_k = [64] + [wp] * 3 + [wp + 64] + [wp] * 4
    want_n = [wp] * 8 + [out_pad]
    want_pe = [0, -1, -1, -1, wp // 64, -1, -1, -1, -1]
    for l, row in enumerate(plan.tolist()):
        w, b = folded.weights[l], folded.biases[l]
        assert row[:2] == [w.data_ptr(), b.data_ptr()]
        assert row[2:] == [want_k[l], want_n[l], 64,
                           ft.SLOT_ROWS // ft.CLUSTER, 2 * want_k[l],
                           want_pe[l]], l
        assert tuple(w.shape) == (want_n[l], want_k[l])
        assert want_n[l] <= ft.MAX_WIDTH and want_n[l] % ft.SLOT_ROWS == 0
    assert len(plan) <= ft.MAX_LAYERS


def test_trunk_apply_takes_the_plain_version_only_on_the_cpu():
    g = TTNeRF(layer_width=32, n_layers=2).eval().G_NeRF_net
    folded = ft.fold_trunk(g)
    pe = ft.encode_points(torch.zeros(5, 3))
    before = trace.counters()
    np.testing.assert_array_equal(ft.trunk_apply(pe, folded).numpy(),
                                  ft.trunk_apply_reference(pe,
                                                           folded).numpy())
    assert trace.counters() == before       # no kernel launched
    with pytest.raises(ValueError):
        ft.trunk_apply(pe.to("meta"), folded)


def test_positional_encoding_matches():
    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    for n, ext in [(10, True), (4, True), (2, False), (0, True)]:
        np.testing.assert_allclose(
            t_pe(torch.from_numpy(x), n, ext).numpy(),
            np.asarray(j_pe(jnp.asarray(x), n, ext)), atol=1e-6)
    assert encoded_size(3, 10) == 63 and encoded_size(2, 2) == 10


def test_fast_sin_matches_jax_polynomial():
    """K0 in plain PyTorch against the JAX polynomial over |x| <= 1e3; the
    range reduction rounds identically, so only the last ulps differ."""
    x = np.concatenate([np.linspace(-1e3, 1e3, 200_001),
                        np.random.default_rng(1).normal(0, 5, 10_000),
                        [0.0, np.pi, -np.pi, 2 * np.pi]]).astype(np.float32)
    got = t_fast_math.fast_sin(torch.from_numpy(x)).numpy()
    want = np.asarray(fast_math._poly_sin(fast_math._reduced(jnp.asarray(x))))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and it is a sine: within the reduction error of sin itself
    np.testing.assert_allclose(got, np.sin(x.astype(np.float64)), atol=3e-4)
    assert t_fast_math.POLY == fast_math._POLYS[11]
    # fast_cos: the same polynomial a quarter period on
    got = t_fast_math.fast_cos(torch.from_numpy(x)).numpy()
    want = np.asarray(fast_math._poly_sin(fast_math._reduced(
        jnp.asarray(x) + fast_math._HALF_PI)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.cos(x.astype(np.float64)), atol=3e-4)
