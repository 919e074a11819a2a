"""entry.idle_ms.stream: device idle ms a pair while the host's innermost
span was the entry point's own, outside match_core: its root span's self
time (gray conversion, checks, dispatch between spans), the images'
copies to the device (entry.h2d) and the map's copy back (entry.d2h)
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "root", "entry.h2d", "entry.d2h")
