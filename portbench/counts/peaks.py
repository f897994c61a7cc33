"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
700 W): the denominators of every roofline share and share of the peak."""

FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations at the dtype's peak
    or bytes at the memory's, whichever is longer."""
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)
