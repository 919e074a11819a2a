"""shard.link_pct.sharded4: the collectives' share of the link's roofline
on rank 0's card of mb2014-full.sharded4, in %: the bytes rank 0
receives a pair (``comm.received_bytes``, from the cell's geometry) over
the device seconds a pair of its NCCL kernels (``comm.nccl_ms``), over
one direction of the card's NVLink (``comm.LINK_BYTES_PER_S``). The
kernels' time includes their wait for the other ranks, so the share
reads low where the ranks are out of step."""
from stereo_bench import comm

CELL = "mb2014-full.sharded4"


def read(trace):
    ms = comm.nccl_ms(trace)
    if not ms:
        return None
    received = comm.received_bytes(*comm.cell_geometry(CELL), rank=0)
    return 100.0 * received / (ms / 1e3) / comm.LINK_BYTES_PER_S
