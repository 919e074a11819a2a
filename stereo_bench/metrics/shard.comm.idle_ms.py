"""shard.comm.idle_ms: device idle ms a pair while the host's innermost
span was a collective's: shard.broadcast (the pair to every rank),
shard.halo (halo exchanges), shard.all_gather and shard.all_to_all
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.idle_ms(trace, "shard.broadcast", "shard.halo",
                         "shard.all_gather", "shard.all_to_all")
