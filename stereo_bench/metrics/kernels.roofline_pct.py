"""kernels.roofline_pct: the summed least time of the B1 and B2 launches
of the stretch (roofline.py: bytes over the card's memory rate) over
their summed device time, in %."""
from stereo_bench import roofline


def read(trace):
    h, w, d = trace.shape
    bound_s = measured_us = 0.0
    for s, e, n in trace.kernels():
        kid = trace.kernel_id(n)
        if kid in roofline.BOUNDS:
            bound_s += roofline.BOUNDS[kid](h, w, d)
            measured_us += e - s
    if measured_us <= 0:
        return None
    return 100.0 * bound_s / (measured_us / 1e6)
