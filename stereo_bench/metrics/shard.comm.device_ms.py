"""shard.comm.device_ms: device ms a pair in NCCL's kernels on the traced
card (rank 0's), picked by name and their durations summed
(``comm.nccl_ms``). An NCCL kernel runs from when its stream reaches it
until its peers' data have arrived and its own have left, and spins while
it waits for them, so this holds the skew between the ranks besides the
transfers."""
from stereo_bench import comm


def read(trace):
    return comm.nccl_ms(trace)
