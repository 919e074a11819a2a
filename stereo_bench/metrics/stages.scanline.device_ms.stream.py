"""stages.scanline.device_ms.stream: device ms a pair of the operations
launched while the host was in match_core's "scanline" span (the four
scanline passes), launch calls matched to operations in order
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.device_ms(trace, "scanline")
