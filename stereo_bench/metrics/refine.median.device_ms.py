"""refine.median.device_ms: device ms a pair of the operations launched
while the host's innermost span was "refine.median", the in-place median
(kernel M1) inside ``multistep_refine``, launch calls matched to
operations in order (stereo_bench/spans.py). None where the program
recorded no such span (it opens it only with ``exact_median`` on)."""
from stereo_bench import spans

NAME = "refine.median"


def read(trace):
    if not any(s.name == NAME for s in spans.trace_spans(trace)):
        return None
    return spans.device_ms(trace, NAME)
