"""stages.refine.idle_ms.stream: device idle ms a pair while the host's
innermost span was match_core's "refine" (multi-step refinement), split
by overlap (stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "refine")
