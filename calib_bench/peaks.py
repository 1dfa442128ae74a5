"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit), and the least time a piece of work
can take on it (``chip_smoke.bound_ms``, frozen here)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores


def bound_s(nbytes, flops):
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
