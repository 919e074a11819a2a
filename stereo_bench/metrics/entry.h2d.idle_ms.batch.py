"""entry.h2d.idle_ms.batch: device idle ms a pair while the host's
innermost span was entry.h2d: the stacks' copies to the device
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "entry.h2d")
