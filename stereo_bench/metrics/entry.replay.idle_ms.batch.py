"""entry.replay.idle_ms.batch: device idle ms a pair while the host's
innermost span was entry.replay: each group's copy-in, graph replay and
copy-out (stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "entry.replay")
