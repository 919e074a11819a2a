"""kernels.m1_bound_pct: the summed least time of the stretch's M1
launches (the in-place median; roofline_refine.py: the larger of its
map's bytes at the memory rate and W + 2H - 2 steps of its recurrence)
over their summed device time, in %."""
from stereo_bench import roofline_refine


def read(trace):
    return roofline_refine.bound_pct(trace, "M1")
