"""What the ranks of ``tests/test_torch_mesh.py`` run.

``parallel.mesh.launch`` spawns its ranks, and each imports the module
that defines its function by name; this one imports nothing of JAX (the
test files do), so a rank starts in a second or two.
"""

import torch

from season_nerf_torch.models.siren import SineLayer
from season_nerf_torch.parallel.mesh import all_reduce_grads, global_amin


def bn_and_min(mesh, state, x, g, albedo, w):
    """A BatchNorm SIREN layer (``state``) in training mode on this rank's
    rows of ``x``, its loss ``sum(y * g)`` over them, and the replicated
    ``sum(w * global_amin(albedo))``, with their gradients; ``mesh`` None
    takes every row in one process -> (y and albedo's gradient of these
    rows, the layer's gradients summed over the ranks, its running
    statistics, the minimum)."""
    rows = slice(None)
    if mesh is not None:
        per = x.shape[0] // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    layer = SineLayer(x.shape[1], g.shape[1], use_norm=True)
    layer.load_state_dict(state)
    layer.train()
    layer.mesh = mesh
    y = layer(x[rows])
    a = albedo[rows].clone().requires_grad_()
    m = global_amin(a, mesh)
    (torch.sum(y * g[rows]) + torch.sum(w * m)).backward()
    if mesh is not None:
        all_reduce_grads(list(layer.parameters()), mesh)
    return {"y": y.detach(), "albedo_grad": a.grad,
            "grads": {k: p.grad for k, p in layer.named_parameters()},
            "running": {k: v for k, v in layer.state_dict().items()
                        if "running" in k},
            "min": m.detach()}
