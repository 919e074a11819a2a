"""refine.dda.device_ms: device ms a pair of the operations launched
while the host's innermost span was "refine.dda", the discontinuity
adjustment (kernel M2) inside ``multistep_refine``, launch calls matched
to operations in order (stereo_bench/spans.py). None where the program
recorded no such span (it opens it only with
``do_discontinuity_adjustment`` on)."""
from stereo_bench import spans

NAME = "refine.dda"


def read(trace):
    if not any(s.name == NAME for s in spans.trace_spans(trace)):
        return None
    return spans.device_ms(trace, NAME)
