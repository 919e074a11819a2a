"""stages.cost.device_ms.stream: device ms a pair of the operations
launched while the host was in match_core's "cost" span (both census
transforms and the cost volume), launch calls matched to operations in
order (stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.device_ms(trace, "cost")
