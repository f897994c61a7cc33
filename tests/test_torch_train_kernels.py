"""The port's fused training trunk (``ops/fused_train``) against the JAX
package's ``ops/pallas_train``, on the CPU.

On a CPU tensor ``trunk_fwd``/``trunk_bwd`` run their plain versions, the
math that K1/K2 compute on the card.  The JAX side runs its Pallas kernels
in interpret mode, at the spec of ``tests/test_pallas_train.py`` (widths
32, 32, 32, 16; skip 2; pe 16; tile 64; two tiles), fast sine on and off.

Tolerances:
- f32 (act and grad f32): the two packages compute the same sums in other
  orders, so the forward agrees to 1e-5 and each gradient to 1e-4 of its
  largest value;
- bf16: one f32 rounding difference can flip a bf16 rounding of an
  activation, and the flip propagates (the 2e-2 of
  ``test_pallas_train.py``); gradients, whose products take bf16 operands,
  to 2e-2 of their largest value (or of 1 where that is smaller); a BN
  layer's linear-bias gradient, zero up to rounding, to 2e-5 of the
  largest gradient of all;
- against ``jax.grad`` of the reference, the tolerances of
  ``test_pallas_train.py::test_bwd_matches_autodiff_of_reference``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from season_nerf_torch.models.tnerf import TNeRF as TTNeRF
from season_nerf_torch.ops import fused_train as ftr
from season_nerf_torch.utils import trace
from season_nerf_torch.utils.convert import state_dict_from_flax
from season_nerf_tpu.ops import pallas_train as pt

torch.set_num_threads(1)

SMALL = dict(widths=(32, 32, 32, 16), skip_idx=2, pe_dim=16, tile=64)
N = 128
CASES = [(dt, fs) for dt in ("float32", "bfloat16") for fs in (True, False)]
IDS = [f"{'f32' if dt == 'float32' else 'bf16'}-"
       f"{'fast_sin' if fs else 'sin'}" for dt, fs in CASES]
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _jax_params(spec, seed=0):
    rng = np.random.default_rng(seed)
    params = []
    for i in range(spec.n_layers):
        fan = spec.in_dims[i]
        params.append(jnp.asarray(rng.uniform(-1, 1, (fan, spec.widths[i]))
                                  / np.sqrt(fan) / 8.0, jnp.bfloat16))
        params.append(jnp.asarray(rng.uniform(-0.5, 0.5, (1, spec.widths[i]))
                                  / np.sqrt(fan), jnp.float32))
        if spec.has_bn[i]:
            params.append(jnp.asarray(1.0 + 0.1 * rng.standard_normal(
                (1, spec.widths[i])), jnp.float32))
            params.append(jnp.asarray(0.1 * rng.standard_normal(
                (1, spec.widths[i])), jnp.float32))
    wh = rng.uniform(-1, 1, (spec.enc_width, pt.HEAD_PAD)) / 4.0
    wh[:, 4:] = 0.0
    params += [jnp.asarray(wh, jnp.bfloat16),
               jnp.asarray(0.1 * rng.standard_normal((1, pt.HEAD_PAD)),
                           jnp.float32)]
    return params


def _t(a):
    """A jax array -> torch, keeping bf16 as bf16."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """Both packages' forward and backward at one spec, computed once."""
    dt, fs = request.param
    kw = dict(SMALL, fast_sine=fs, grad_dtype=dt, act_dtype=dt)
    jspec, tspec = pt.TrunkSpec(**kw), ftr.TrunkSpec(**kw)
    params = _jax_params(jspec)
    rng = np.random.default_rng(1)
    pe = jnp.asarray(rng.uniform(-1, 1, (N, jspec.pe_dim)), jnp.bfloat16)
    cot_x = np.random.default_rng(3).standard_normal(
        (N, jspec.enc_width)).astype(np.float32) * 0.1
    cot_h = np.random.default_rng(4).standard_normal(
        (N, pt.HEAD_PAD)).astype(np.float32) * 0.1
    j_fwd = pt.trunk_fwd(jspec, (pe, *params), True)
    j_ref = pt.trunk_train_reference(jspec, pe, params)
    j_bwd = pt.trunk_bwd(jspec, (pe, *params), jnp.asarray(cot_x),
                         jnp.asarray(cot_h), True)
    tp = [_t(p) for p in params]
    t_fwd = ftr.trunk_fwd(tspec, _t(pe), tp)
    t_bwd = ftr.trunk_bwd(tspec, _t(pe), tp, torch.from_numpy(cot_x),
                          torch.from_numpy(cot_h))
    return dict(dt=dt, jspec=jspec, tspec=tspec, params=params, pe=pe,
                cot=(cot_x, cot_h), j_fwd=j_fwd, j_ref=j_ref, j_bwd=j_bwd,
                t_fwd=t_fwd, t_bwd=t_bwd)


def test_fwd_matches_jax_kernel_and_reference(case):
    tol = FWD_TOL[case["dt"]]
    for want in (case["j_fwd"], case["j_ref"]):
        for g, w, name in zip(case["t_fwd"], want, ("xenc", "heads")):
            np.testing.assert_allclose(_np(g), _np(w), atol=tol,
                                       err_msg=name)
        # the statistics sums: f32 math on both sides
        np.testing.assert_allclose(_np(case["t_fwd"][2]), _np(want[2]),
                                   rtol=1e-4, atol=1e-4, err_msg="stats")
    assert case["t_fwd"][0].dtype == ftr._DTYPES[case["dt"]]


def test_bwd_matches_jax_kernel(case):
    """The same math as ``pallas_train.trunk_bwd``: tight in f32.  The
    linear bias of a BN layer has a gradient that is zero up to rounding
    (each tile's dz sums to zero), so it is held to 2e-5 of the largest
    gradient of all (measured 8e-6 in f32)."""
    tol = BWD_TOL[case["dt"]]
    spec = case["tspec"]
    bn_bias = {o + 1 for o, bn in zip(spec.offsets(), spec.has_bn) if bn}
    assert len(case["t_bwd"]) == len(case["j_bwd"])
    top = max(np.abs(_np(w)).max() for w in case["j_bwd"])
    for k, (g, w) in enumerate(zip(case["t_bwd"], case["j_bwd"])):
        w = _np(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        atol = (2e-5 * top if k in bn_bias
                else tol * max(np.abs(w).max(), 1.0))
        np.testing.assert_allclose(_np(g), w, atol=atol,
                                   err_msg=f"param {k}")


def test_bwd_matches_autodiff_of_reference(case):
    jspec, params, pe = case["jspec"], case["params"], case["pe"]
    cot_x, cot_h = case["cot"]

    def loss_ref(*ps):
        xenc, heads, _ = pt.trunk_train_reference(jspec, pe, ps)
        return (jnp.sum(xenc.astype(jnp.float32) * cot_x)
                + jnp.sum(heads * cot_h))

    gr = jax.grad(loss_ref, argnums=tuple(range(len(params))))(*params)
    for g, w, p in zip(case["t_bwd"], gr, params):
        # autodiff rounds each gradient to its param's dtype: round ours so
        g = np.asarray(jnp.asarray(_np(g)).astype(p.dtype), np.float32)
        w = _np(w)
        if case["dt"] == "float32":
            atol = 2e-3 * max(np.abs(w).max(), 1.0)
        else:
            atol = 4e-2 * max(np.abs(w).max(), 3.0)
        np.testing.assert_allclose(g, w, atol=atol)


def test_ghost_stats_are_tile_local():
    """Two tiles of different spread: the sums are of per-tile rows."""
    spec = ftr.TrunkSpec(**SMALL)
    params = [_t(p) for p in _jax_params(pt.TrunkSpec(**SMALL))]
    pe = torch.rand(N, spec.pe_dim, generator=torch.Generator().manual_seed(
        2)) * 2 - 1
    pe[spec.tile:] *= 3.0
    pe = pe.to(torch.bfloat16)
    stats = ftr.trunk_fwd(spec, pe, params)[2]
    a = ftr.trunk_fwd(spec, pe[:spec.tile], params)[2]
    b = ftr.trunk_fwd(spec, pe[spec.tile:], params)[2]
    np.testing.assert_allclose(stats.numpy(), (a + b).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_head_grad_unpack_shapes():
    spec = ftr.TrunkSpec(**SMALL)
    d_wh = torch.arange(spec.enc_width * ftr.HEAD_PAD,
                        dtype=torch.float32).reshape(spec.enc_width, -1)
    dws, dbs, dwc, dbc = ftr.unpack_head_grads(d_wh, d_wh[:1])
    assert dws.shape == (spec.enc_width, 1) and dbs.shape == (1,)
    assert dwc.shape == (spec.enc_width, 3) and dbc.shape == (3,)
    assert torch.equal(dwc, d_wh[:, 1:4]) and torch.equal(dbc, d_wh[0, 1:4])


def test_wrappers_run_the_plain_version_on_cpu_only():
    """A CPU tensor takes the plain version without counting a launch; a
    tensor on any other device goes to the kernel path, which refuses what
    is not a CUDA tensor (it never falls back)."""
    spec = ftr.TrunkSpec(**SMALL)
    params = [_t(p) for p in _jax_params(pt.TrunkSpec(**SMALL))]
    pe = torch.zeros(N, spec.pe_dim, dtype=torch.bfloat16)
    before = trace.counters()
    ftr.trunk_fwd(spec, pe, params)
    ftr.trunk_bwd(spec, pe, params, torch.zeros(N, spec.enc_width),
                  torch.zeros(N, ftr.HEAD_PAD))
    assert trace.counters() == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ftr.trunk_fwd(spec, pe.to("meta"), [p.to("meta") for p in params])


# --- the GEMM inside K1 and K2 ------------------------------------------------
@pytest.mark.parametrize("layout", sorted(ftr.GEMM_LAYOUTS))
def test_gemm_plain_version_matches_jax_dot(layout):
    """``gemm_bf16`` on CPU tensors (its plain version) against ``jnp.dot``
    of the same bf16 operands with f32 accumulation, the product
    ``pallas_train``'s kernels take for every layer, then ``c +`` and ``+
    bias``, each operand stored as the layout says.  Exact products, f32
    sums in other orders: 1e-5 of sum |a| |b|."""
    rng = np.random.default_rng(11)
    M, N, K = 40, 24, 72
    A = jnp.asarray(rng.uniform(-0.5, 1, (M, K)), jnp.bfloat16)
    B = jnp.asarray(rng.uniform(-0.5, 1, (K, N)), jnp.bfloat16)
    bias = rng.standard_normal(N).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32)
    want = c + jnp.dot(A, B, preferred_element_type=jnp.float32) + bias
    a_kc, b_kc = ftr.GEMM_LAYOUTS[layout]
    a = _t(A) if a_kc else _t(A).t().contiguous()
    b = _t(B).t().contiguous() if b_kc else _t(B)
    out = torch.from_numpy(c.copy())
    got = ftr.gemm_bf16(a, b, layout, bias=torch.from_numpy(bias), c=out)
    assert got is out
    scale = np.abs(_np(A)) @ np.abs(_np(B)) + np.abs(c) + np.abs(bias)
    assert np.all(np.abs(got.numpy() - _np(want)) <= 1e-5 * scale)
    np.testing.assert_allclose(
        ftr.gemm_bf16(a, b, layout).numpy(),
        _np(jnp.dot(A, B, preferred_element_type=jnp.float32)),
        rtol=0, atol=1e-5 * float(scale.max()))


def test_gemm_wrapper_refuses_what_is_not_cpu_or_cuda():
    a = torch.zeros(16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cuda"):
        ftr.gemm_bf16(a.to("meta"), a.t().contiguous().to("meta"), "fwd")


def test_card_width_rule():
    """On the card, TMA loads the GEMM's bf16 rows, 16 bytes at a time:
    widths and pe_dim must be multiples of 8.  The specs in use pass."""
    for spec in (ftr.TrunkSpec(), ftr.TrunkSpec(**SMALL),
                 ftr.TrunkSpec(widths=(256,) * 8 + (128,), tile=128)):
        ftr.check_card_widths(spec, "trunk_fwd")
    for kw in (dict(widths=(32, 36, 32, 16)), dict(pe_dim=12)):
        with pytest.raises(ValueError, match="multiples of 8"):
            ftr.check_card_widths(ftr.TrunkSpec(**{**SMALL, **kw}),
                                  "trunk_fwd")


# --- the network glue: pack_params, TrunkTrain, batch_stats_updates ---------
W = 256   # the narrowest width spec_for_model accepts (128-multiples)


@pytest.fixture(scope="module")
def tiny():
    """A width-256 bf16 TNeRF in both packages with the same weights, and a
    64-point input (two ghost tiles of 32)."""
    from season_nerf_tpu.models.tnerf import TNeRF
    jm = TNeRF(layer_width=W, n_layers=8, dtype=jnp.bfloat16, fast_sine=True)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2, 4)), train=False)
    v = jax.device_get(v)
    tm = TTNeRF(layer_width=W, n_layers=8, dtype=torch.bfloat16,
                fast_sine=True).load_weights(
        state_dict_from_flax(v["params"], v["batch_stats"])).train()
    rng = np.random.default_rng(7)
    flat = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    sun = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    t4 = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    return jm, v, tm, flat, sun, t4


def test_trunk_train_grads_match_jax_fused_forward(tiny):
    """``TrunkTrain`` through ``pack_params``: the gradient of every network
    parameter against ``jax.grad`` of ``pallas_train.fused_forward`` (the
    interpret-mode kernels).  bf16 activations: each gradient to 5e-2 of
    its largest value (or of 1e-2, for the near-zero BN-layer biases)."""
    jm, v, tm, flat, sun, t4 = tiny
    jspec, _ = pt.spec_for_model(jm, 64, tile=32)
    tspec, why = ftr.spec_for_model(tm, 64, tile=32)
    assert tspec is not None, why
    probs, sun_pe, sky_raw = jm.apply(v, sun, t4, train=True,
                                      method="ray_consts")

    def loss(params):
        out, _ = pt.fused_forward(jm, {**v, "params": params}, jspec,
                                  jnp.asarray(flat), probs, sun_pe, sky_raw,
                                  train=True, interpret=True)
        return (jnp.sum(out["rho"]) + jnp.sum(out["col"] ** 2)
                + jnp.sum(out["vis"]))

    jg = state_dict_from_flax(jax.device_get(jax.grad(loss)(v["params"])),
                              {})
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    tm.zero_grad(set_to_none=True)
    saved = {k: b.clone() for k, b in tm.named_buffers()}
    out = ftr.fused_forward(tm, tspec, t(flat), t(probs), t(sun_pe),
                            t(sky_raw))
    (out["rho"].sum() + (out["col"] ** 2).sum() + out["vis"].sum()).backward()
    with torch.no_grad():                  # the fixture's model is shared
        for k, b in tm.named_buffers():
            b.copy_(saved[k])
    names = [k for k in jg if k.startswith("G_NeRF_net.fc")]
    assert any(".fc5.linear.weight" in k for k in names)
    for name, p in tm.named_parameters():
        if name not in jg:
            continue
        want = jg[name].numpy()
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, atol=5e-2 * max(
            np.abs(want).max(), 1e-2), err_msg=name)


def test_batch_stats_updates_match_jax(tiny):
    jm, v, tm, flat, _, _ = tiny
    jspec, _ = pt.spec_for_model(jm, 64, tile=32)
    tspec, _ = ftr.spec_for_model(tm, 64, tile=32)
    stats = np.random.default_rng(5).standard_normal(
        (2 * jspec.n_bn, jspec.stat_width)).astype(np.float32) ** 2
    want = pt.batch_stats_updates(v, jspec, jnp.asarray(stats), 2)
    saved = {k: b.clone() for k, b in tm.named_buffers()}
    try:
        ftr.batch_stats_updates(tm.G_NeRF_net, tspec, torch.from_numpy(stats),
                                2)
        got = {k: b for k, b in tm.state_dict().items() if "running" in k}
        ref = state_dict_from_flax({}, jax.device_get(want["batch_stats"]))
        assert set(k for k in ref if "running" in k) <= set(got)
        for k, b in got.items():
            np.testing.assert_allclose(b.numpy(), ref[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    finally:
        for k, b in tm.named_buffers():
            b.copy_(saved[k])


def test_spec_for_model_guards(tiny):
    _, _, tm, _, _, _ = tiny
    spec, why = ftr.spec_for_model(tm, 64, tile=32)
    assert why is None and spec.widths == (W,) * 8 + (W // 2,)
    assert spec.skip_idx == 4 and spec.fast_sine and spec.pe_dim == 64
    assert ftr.spec_for_model(tm, 63, tile=32)[1].count("divisible")
    for model, word in (
            (TTNeRF(layer_width=W, n_layers=8, dtype=None), "bfloat16"),
            (TTNeRF(layer_width=W, n_layers=6, dtype=torch.bfloat16),
             "depth"),
            (TTNeRF(layer_width=192, n_layers=8, dtype=torch.bfloat16),
             "128-multiple"),
            (TTNeRF(layer_width=W, n_layers=8, dtype=torch.bfloat16,
                    use_norm=False), "BatchNorm")):
        spec, why = ftr.spec_for_model(model, 64, tile=32)
        assert spec is None and word in why


# --- pallas_trunk on a model the fused path does not represent ---------------
def test_fused_trunk_spec_raises_on_the_card(tiny):
    """On a CUDA device a refused model raises with spec_for_model's
    reason (decided from the device alone: no card needed); an accepted
    model gets its spec on either device."""
    from season_nerf_torch.train.engine import fused_trunk_spec
    refused = TTNeRF(layer_width=W, n_layers=8, dtype=None)
    with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
        fused_trunk_spec(refused, 2048, torch.device("cuda"))
    with pytest.raises(ValueError, match="divisible"):
        fused_trunk_spec(tiny[2], 2047, "cuda:0")
    for device in (torch.device("cuda"), torch.device("cpu")):
        spec = fused_trunk_spec(tiny[2], 2048, device)
        assert spec is not None and spec.widths == (W,) * 8 + (W // 2,)


def test_trainer_on_the_cpu_warns_and_trains_on_the_default_trunk():
    """On the CPU a refused model (float32 here) keeps today's behaviour,
    as the JAX package does: a warning, then the default trunk."""
    from season_nerf_torch.config import Config
    from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
    from season_nerf_torch.train.engine import Trainer
    scene = make_scene(n_views=3, img_size=12, grid=16, seed=2)
    table, _ = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=32, batch_size=16, n_samples=8, max_train_steps=4,
                 compute_dtype="float32", n_saves=0, logs_dir="",
                 pallas_trunk=True)
    tr = Trainer(cfg, table, prior_hm=scene.prior_hm, device="cpu")
    with pytest.warns(UserWarning, match="falling back to the default trunk"):
        loss = tr.train_step()
    assert tr.statics.trunk_spec is None
    assert all(bool(torch.isfinite(v)) for v in loss.values())
