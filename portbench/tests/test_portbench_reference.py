"""The plain reference against the port on the CPU at a tiny width: a
training step of each trunk and whole frames."""

import numpy as np
import pytest
import torch

from portbench import bench, run as harness
from portbench.tests.conftest import small


def _run(cell, seed=5, **config):
    ov = small(cell, **config)
    c = bench.cell(cell)
    for key, part in ov.items():
        getattr(c, key).update(part)
    r = harness.Run(c, seed, 1.0, torch.device("cpu"))
    return r, bench.kind(c.traffic)


@pytest.mark.parametrize("cell", ["train-bf16-default"])
def test_train_steps_float32_agree(cell):
    """At float32 with the exact sine the port's default step and the
    reference compute the same function: three steps' losses, the first
    gradient and the change agree to float32 rounding."""
    r, kind = _run(cell, compute_dtype="float32", fast_sine=False)
    try:
        kind.setup(r)
        gaps = kind.compare(r.readings, kind.reference(r, "f32"))
    finally:
        r.close()
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["update_gap"] < 1e-4, gaps


def test_ghost_trunk_matches_the_port_plain_kernels():
    """The reference's ghost BatchNorm trunk against the plain versions of
    K1 and K2 (``fused_train.trunk_fwd_reference`` /
    ``trunk_bwd_reference``) in float32: x_enc, the running statistics'
    update and the weight gradients."""
    from season_nerf_torch.ops import fused_train as ftr
    from season_nerf_torch.models.tnerf import TNeRF
    from portbench.reference.model import Net, positional, state_from
    torch.manual_seed(0)
    model = TNeRF(layer_width=32, n_layers=8).train()
    g = model.G_NeRF_net
    spec = ftr.TrunkSpec(widths=(32,) * 8 + (16,), skip_idx=4, tile=64,
                         fast_sine=False, grad_dtype="float32",
                         act_dtype="float32")
    x = torch.rand(256, 3) * 2 - 1
    pe = torch.nn.functional.pad(positional(x, 10), (0, 1))
    packed = [p.detach() for p in ftr.pack_params(g, spec)]
    xenc, heads, stats = ftr.trunk_fwd_reference(spec, pe, packed)
    r = torch.randn_like(xenc)
    grads = ftr.trunk_bwd_reference(spec, pe, packed, r,
                                    torch.zeros_like(heads))
    names = {k for k, _ in model.named_parameters()}
    p = state_from(model.state_dict(), learned=names)
    net = Net(p, bn="ghost", tile=64)
    mine = net.trunk(x)
    (mine * r).sum().backward()
    np.testing.assert_allclose(mine.detach(), xenc, atol=2e-5)
    w2 = p["G_NeRF_net.fc2.linear.weight"].grad   # [out, in]
    np.testing.assert_allclose(w2.t() / 30.0, grads[spec.offsets()[1]],
                               rtol=1e-4, atol=2e-4)
    mean_fc3 = stats[1, :32] / 4                  # mean of tile means
    want = 0.99 * g.fc3.norm.running_mean + 0.01 * mean_fc3
    np.testing.assert_allclose(p["G_NeRF_net.fc3.norm.running_mean"],
                               want, atol=1e-5)


def test_ghost_step_is_closer_to_its_own_reference():
    """The fused trunk's bf16 step on the CPU (its plain versions) agrees
    with the ghost-BatchNorm reference better than with the full-batch
    one on the trunk's BatchNorm scales and shifts: the reference follows
    the arithmetic the configuration states."""
    r, kind = _run("train-bf16-ghostbn")
    try:
        kind.setup(r)
        ghost = kind.reference(r, "f32")
        r.config["pallas_trunk"] = False
        full = kind.reference(r, "f32")
    finally:
        r.close()
    bn = [k for k in ghost["grad"] if k.startswith("G_NeRF_net.fc")
          and ".norm." in k]
    gap = lambda ref: max(kind._gaps(r.readings["grad"], ref["grad"],
                                     bn).values())
    assert gap(full) > 3 * gap(ghost), (gap(ghost), gap(full))
    assert kind.compare(r.readings, ghost)["loss_gap"] < 1e-2


@pytest.mark.parametrize("cell,bound", [("render-f32-frames", 1e-5)])
def test_frames_agree(cell, bound):
    """Frames the float32 legacy directory renders through
    ``Renderer.render_img`` against the reference's, pixel by pixel."""
    res = harness.execute(cell, 77, 1.0, False, device="cpu",
                          overrides=small(cell), age=lambda: 0.0)
    assert res["readings"]["frame_max_gap"] < bound, res["readings"]
    assert res["correct"]


def test_served_frames_decode_and_agree():
    """Frames served over HTTP, decoded from their PNG bodies, against the
    reference's in 8-bit levels (bf16 products: a few levels)."""
    cell = "serve-bf16-mixed"
    res = harness.execute(cell, 78, 2.0, False, device="cpu",
                          overrides=small(cell), age=lambda: 0.0)
    assert res["failed"] == 0 and res["attempted"] == 8
    assert res["readings"]["frame_mean_gap"] < 3.0, res["readings"]


def test_log_partition_closed_forms():
    """The reference's own log Z(alpha) against its closed forms: Cauchy
    (alpha 0) pi sqrt 2, alpha 1 2 e K_1(1), Gauss (alpha 2) sqrt(2 pi);
    the loss's eps of 1e-6 moves each by a few 1e-6."""
    from math import e, log, pi, sqrt
    from portbench.reference.train import log_partition
    k1_of_1 = 0.60190723019723457      # modified Bessel K_1(1)
    want = [log(pi * sqrt(2)), log(2 * e * k1_of_1), log(sqrt(2 * pi))]
    np.testing.assert_allclose(log_partition([0.0, 1.0, 2.0]), want,
                               atol=1e-5)


def test_log_partition_table_agrees_with_the_port():
    """The reference's table on its grid and the port's, made apart
    (Gauss-Legendre against a trapezoid rule), within 1e-5."""
    from season_nerf_torch.ops import robust_loss
    from portbench.reference.train import _table
    alphas, logz = _table()
    port_a, port_z = robust_loss._table(torch.device("cpu"))
    np.testing.assert_allclose(alphas, port_a.double(), rtol=1e-7)
    np.testing.assert_allclose(logz, port_z.double(), atol=1e-5)


def test_frames_window_starts_again_after_the_drawn_frames():
    """A window longer than the drawn frames renders them again from the
    first, and the frames it produced still agree with the reference."""
    cell = "render-f32-frames"
    ov = small(cell)
    ov["traffic"] = dict(ov["traffic"], frames=3)
    res = harness.execute(cell, 79, 1.0, False, device="cpu",
                          overrides=ov, age=lambda: 0.0)
    assert res["attempted"] > 2, res["attempted"]
    assert res["correct"], res["checks"]
