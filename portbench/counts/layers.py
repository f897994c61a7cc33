"""The network's products as ``(grad_in, fixed_in, out)`` per layer:
``grad_in`` input columns that carry a gradient in training, ``fixed_in``
those that do not (encodings, or a trunk output under no_grad), ``out``
output columns.  A layer's forward costs (grad_in + fixed_in) x out
multiply-adds a row, its weight gradient as many, its input gradient
grad_in x out.  Widths follow the configuration: trunk width W, fc9 and
the heads' input W / 2, the sky branch W / 4."""

PE_POSE = 3 * (1 + 2 * 10)      # extended encoding of a point, 10 freqs
PE_SUN = 3 * (1 + 2 * 4)        # of the sun direction, 4 freqs
PE_TIME = 2 * (1 + 2 * 2)       # of the year pair, 2 freqs


def trunk(c: dict):
    """fc1 from the point's encoding, fc2..fcN (the encoding concatenated
    back in at N // 2 + 1), fc9 at half width."""
    W, n = c["fc_units"], c["fc_layers"]
    skip = n // 2 + 1
    out = [(0, PE_POSE, W)]
    out += [(W, PE_POSE if i == skip else 0, W) for i in range(2, n + 1)]
    return out + [(W, 0, W // 2)]


def heads(c: dict):
    """sigma and colour from x_enc."""
    return [(c["fc_units"] // 2, 0, 1), (c["fc_units"] // 2, 0, 3)]


def solar(c: dict, enc_grad: bool = True):
    """The solar visibility branch from [x_enc, PE(sun)]."""
    h = c["fc_units"] // 2
    first = (h, PE_SUN, h) if enc_grad else (0, h + PE_SUN, h)
    return [first, (h, 0, h), (h, 0, h), (h, 0, 1)]


def adjust(c: dict):
    """The per-class albedo adjust from x_enc."""
    W, h = c["fc_units"], c["fc_units"] // 2
    return [(h, 0, W), (W, 0, W), (W, 0, W),
            (W, 0, 3 * c["number_low_frequency_cases"])]


def per_ray(c: dict):
    """The class softmax from the year pair and the sky colour from the
    sun, once a ray."""
    W = c["fc_units"]
    return [(0, PE_TIME, W), (W, 0, W),
            (W, 0, c["number_low_frequency_cases"]),
            (0, PE_SUN, W // 4), (W // 4, 0, 3)]


def forward(layers) -> int:
    return sum((g + f) * o for g, f, o in layers)


def backward(layers) -> int:
    """Weight and input gradients."""
    return sum((g + f) * o + g * o for g, f, o in layers)
