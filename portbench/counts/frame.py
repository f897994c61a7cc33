"""Model operations of one rendered frame: every product of the network
in eval mode at each of its samples (trunk, heads, solar branch, adjust),
and the class and sky branches once a frame (one time and one sun a
frame), from the configuration's shapes."""

from portbench.counts import layers as L


def frame_flops(c: dict, rays: int) -> float:
    per_pt = L.forward(L.trunk(c) + L.heads(c) + L.solar(c) + L.adjust(c))
    return 2.0 * (rays * c["n_samples"] * per_pt + L.forward(L.per_ray(c)))
