"""K1 and K2, the training trunk (``ops/fused_train.py``): operations and
bytes of a launch over ``n`` samples and their bound, by the rule of the
kernel table (each input read once, each output written once).

K1: 2 x the forward multiply-adds of the trunk (the encoding's 63 real
columns) and of the four real head columns.  K2: its forward recompute,
every weight gradient and every input gradient (none below the first
layer; the skip layer's trunk rows only).  Bytes: K1 reads the bf16
encoding (64 columns) and the parameters (counted as float32) and writes
bf16 x_enc and the float32 heads (8 columns); K2 reads the encoding and
both float32 output gradients and reads and writes every parameter in
float32."""

from portbench.counts import layers as L
from portbench.counts.peaks import bound_s

PE_COLS, HEAD_COLS = 64, 8


def _params(c: dict) -> int:
    cols = [(PE_COLS if i == 0 else g) + (f if i else 0)
            for i, (g, f, o) in enumerate(L.trunk(c))]
    return sum(k * o + 4 * o for k, (_, _, o) in zip(cols, L.trunk(c))) \
        + (c["fc_units"] // 2 + 1) * HEAD_COLS


def flops(c: dict, n: int):
    """-> (K1, K2) operations."""
    tr = L.trunk(c)
    fwd = L.forward(tr) + c["fc_units"] // 2 * 4
    da = sum(g * o for g, _, o in tr) + c["fc_units"] // 2 * 4
    return 2.0 * n * fwd, 2.0 * n * (2 * fwd + da)


def nbytes(c: dict, n: int):
    p = _params(c)
    k1 = n * (PE_COLS * 2 + c["fc_units"] // 2 * 2 + HEAD_COLS * 4) + p * 4
    k2 = n * (PE_COLS * 2 + c["fc_units"] // 2 * 4 + HEAD_COLS * 4) + 8 * p
    return k1, k2


def launch_bounds_s(c: dict):
    """-> (K1, K2): the bound of one launch over the batch's samples."""
    n = c["batch_size"] * c["n_samples"]
    (f1, f2), (b1, b2) = flops(c, n), nbytes(c, n)
    return bound_s(f1, b1, "bfloat16"), bound_s(f2, b2, "bfloat16")


def step_bound_s(c: dict) -> float:
    """K1 twice (camera and solar pass) and K2 once a step."""
    k1, k2 = launch_bounds_s(c)
    return 2 * k1 + k2
