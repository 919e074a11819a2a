"""stages.wta.device_ms: device ms a pair of the operations launched
while the host's innermost span was "wta": in the sharded body,
both winner-take-alls. A collective's operations fall in its own span
(shard.*), not in the stage's. Launch calls are matched to operations in
order (stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.device_ms(trace, "wta")
