"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W): HBM3 bandwidth and vector (non-tensor-core) rates by
element size.  A roofline share is stated against these, with the card's
power limit beside it."""
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {4: 67e12, 8: 34e12}


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """Least time for this work: the larger of bytes over bandwidth and
    operations over the vector rate."""
    return max(nbytes / PEAK_BYTES_S,
               flops / PEAK_FLOPS_S.get(itemsize, PEAK_FLOPS_S[4]))
