"""K3 on the card: the CUDA trunk kernel against its plain version, the
wrapper's checks and launch count, and a render on the card against the
same render on the CPU.

Every test here needs a CUDA card and skips without one.  Run them on a
machine with an H100, from the repository root:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX, which
the port and these tests do not need.)"""

import numpy as np
import pytest
import torch

from chip_smoke import TOL, make_model   # the kernel tolerances, stated there
from season_nerf_torch.config import Config
from season_nerf_torch.data.ingest import save_world_artifact
from season_nerf_torch.ops import fused_trunk as ft
from season_nerf_torch.render.loading import load_model_dir
from season_nerf_torch.train.state import save_model_artifact

pytestmark = pytest.mark.gpu

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


@pytest.mark.parametrize("fast_sine", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("width,depth,n", [(512, 8, 20_000 + 37),
                                           (32, 2, 1000), (96, 7, 777),
                                           (128, 4, 64)])
def test_kernel_matches_plain_version(cuda, width, depth, n, dtype,
                                      fast_sine):
    folded = ft.fold_trunk(_model(width, depth).G_NeRF_net, dtype=dtype,
                           device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    pe = ft.encode_points(torch.rand(n, 3, generator=gen, device=cuda) * 2
                          - 1).contiguous()
    launches = ft.trunk_apply.launches
    got = ft.trunk_apply(pe, folded, fast_sine)
    want = ft.trunk_apply_reference(pe, folded, fast_sine)
    torch.cuda.synchronize()
    assert ft.trunk_apply.launches == launches + 1
    assert got.shape == want.shape == (n, max(width // 2, 1))
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    tol_max, tol_mean = TOL[dtype]
    assert float(err.max()) <= tol_max
    assert float(err.mean()) <= tol_mean


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
    launches = ft.trunk_apply.launches
    assert ft.trunk_apply(pe[:0], folded).shape == (0, 16)
    assert ft.trunk_apply.launches == launches       # nothing to launch


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
    launches = ft.trunk_apply.launches
    got = card.render_img(*args, exact_shadow=True)
    rays, S = 12 * 12, cfg.n_samples
    assert ft.trunk_apply.launches - launches == (
        -(-rays // cfg.chunk) + -(-rays * S // cfg.chunk) * (S - 1))
    want = cpu.render_img(*args, exact_shadow=True)
    for k in ("Col_Img", "Shadow_Mask", "Exact_Shadow_Mask", "PS_Sum"):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], atol=5e-2, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(card.get_dsm(12), cpu.get_dsm(12), atol=5e-2,
                               rtol=0)


def test_entry_points_default_to_the_card(cuda, tmp_path):
    cfg = Config(fc_units=32, fc_layers=2, n_samples=8)
    cfg.save_json(str(tmp_path / "opts.json"))
    save_model_artifact(str(tmp_path / "Final_Model.nn"),
                        _model(32, 2).state_dict())
    loaded = load_model_dir(str(tmp_path))
    assert loaded.renderer.device.type == "cuda"
    assert all(w.is_cuda for w in loaded.model.G_NeRF_net.fused()
               .folded.weights)
