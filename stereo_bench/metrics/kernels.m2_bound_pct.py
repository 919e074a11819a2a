"""kernels.m2_bound_pct: the summed least time of the stretch's M2
launches (discontinuity adjustment; roofline_refine.py: its map's bytes
at the memory rate) over their summed device time, in %."""
from stereo_bench import roofline_refine


def read(trace):
    return roofline_refine.bound_pct(trace, "M2")
