"""Each whole-step and whole-frame count against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at
a small batch: the counts are linear in rays and samples, so agreeing at
two batches fixes them at the cells' sizes too."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs
from portbench.counts import frame, k1k2, k3, train_step
from portbench.reference.model import Net, positional
from portbench.reference.render import render_colour
from portbench.reference.train import ALPHA, COLOR, Adaptive, phase1_loss

CFG = {"fc_units": 64, "fc_layers": 8, "number_low_frequency_cases": 4,
       "n_samples": 8, "chunk": 64, "compute_dtype": "bfloat16"}


def _weights():
    shapes = {}
    from season_nerf_torch.models.tnerf import TNeRF
    with torch.device("meta"):
        m = TNeRF(layer_width=CFG["fc_units"])
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    return inputs.make_weights(shapes, 3, "cpu", n_calib=256)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("rays", [4, 12])
def test_train_step(rays):
    c = dict(CFG, batch_size=rays)
    w = _weights()
    p = {k: v.requires_grad_(True) if v.is_floating_point() else v
         for k, v in w.items()}
    net = Net(p)
    rows, prior = inputs.make_site(1, views=2, px=8, grid=8)
    draws = inputs.StepDraws(1, len(rows), rays, c["n_samples"], "cpu")(0)
    batch = inputs.columns(torch.from_numpy(rows)[draws["idx"]])

    def step():
        total, _ = phase1_loss(net, Adaptive(3, "cpu", **COLOR),
                               Adaptive(1, "cpu", **ALPHA), batch, draws, 0,
                               torch.from_numpy(prior), c["n_samples"], 100)
        total.backward()
    assert _counted(step) == train_step.step_flops(c)


@pytest.mark.parametrize("size", [4, 8])
def test_frame(size):
    net = Net(_weights())
    got = _counted(lambda: render_colour(net, (70.0, 10.0), (45.0, 180.0),
                                         0.3, size, CFG["n_samples"], "cpu"))
    assert got == frame.frame_flops(CFG, size * size)


def test_k3_is_the_trunk():
    net = Net(_weights())
    net.training = False
    x = torch.rand(100, 3)
    assert _counted(lambda: net.trunk(x)) == k3.flops(CFG, 100)
    assert k3.frame_launches(dict(CFG, chunk=10), 25) == [80, 80, 40]


def test_k1_k2_are_the_trunk_and_heads():
    """K1: the trunk and the four real head columns forward; K2: that
    forward again (recompute) and its backward, the encoding taking no
    gradient."""
    w = _weights()
    p = {k: v.requires_grad_(True) if v.is_floating_point() else v
         for k, v in w.items()}
    net = Net(p)
    n = 50
    x = torch.rand(n, 3)

    def fwd():
        e = net.trunk(x)
        return net.dense("G_NeRF_net.fc10Sigma", e), \
            net.dense("G_NeRF_net.fc10Col", e)
    f1 = _counted(fwd)
    out = fwd()
    f2 = f1 + _counted(lambda: (out[0].sum() + out[1].sum()).backward())
    assert (f1, f2) == k1k2.flops(CFG, n)


def test_bounds_are_the_kernel_table():
    """The flagship shapes give the kernel table's bounds: K3 2.018 ms a
    491,520-point chunk (bf16), K1 1.615 ms and K2 4.795 ms at 393,216."""
    c = dict(CFG, fc_units=512, compute_dtype="bfloat16")
    assert round(k3.launch_bound_s(c, 491520) * 1e3, 3) == 2.018
    f1, f2 = k1k2.flops(c, 393216)
    assert (round(f1 / 989e9, 3), round(f2 / 989e9, 3)) == (1.615, 4.795)
    assert positional(torch.zeros(1, 3), 10).shape[1] == 63
