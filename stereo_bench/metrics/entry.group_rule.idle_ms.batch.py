"""entry.group_rule.idle_ms.batch: device idle ms a pair while the
host's innermost span was entry.group_rule: the group rule
(_batch_group_size, with group_budget's read of the card's free memory)
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "entry.group_rule")
