"""Model operations of one training step: every product of the forward
and backward passes of the camera pass and of the solar pass, none
counted twice (no recompute), from the configuration's shapes.

Camera pass, a sample: the trunk, both heads and the adjust forward and
backward, the solar branch forward only (the composite's sun gate reads
its visibility detached); a ray: the class and sky branches.  Solar
pass, a sample: the trunk and the density head forward only (no gradient
reaches the trunk), the solar branch forward and backward with x_enc
fixed."""

from portbench.counts import layers as L


def step_flops(c: dict) -> float:
    rays, pts = c["batch_size"], c["batch_size"] * c["n_samples"]
    cam = L.trunk(c) + L.heads(c) + L.adjust(c)
    sol_fixed = L.trunk(c) + L.heads(c)[:1]
    sol = L.solar(c, enc_grad=False)
    per_pt = (L.forward(cam) + L.backward(cam) + L.forward(L.solar(c))
              + L.forward(sol_fixed) + L.forward(sol) + L.backward(sol))
    per_ray = L.forward(L.per_ray(c)) + L.backward(L.per_ray(c))
    return 2.0 * (pts * per_pt + rays * per_ray)
