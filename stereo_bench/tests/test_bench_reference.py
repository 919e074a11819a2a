"""The reference agrees with the program's CPU path, and its control in
a lower precision does not."""
import numpy as np
import pytest
import torch

from conftest import tiny_cell
from stereo_bench import harness
from stereo_bench.reference import adcensus as ref
from stereo_bench.reference import adcensus_blocked as blocked


def pairs(workload: str, n: int = 2):
    cell = tiny_cell(workload)
    cell.traffic = dict(cell.traffic, pool_pairs=n)
    return cell, harness.make_pool(cell, 97)


@pytest.mark.parametrize("workload", ["cones.stream", "kitti.stream"])
def test_reference_equals_the_programs_cpu_path(workload):
    from adcensus_torch.config import ADCensusOptions
    from adcensus_torch.stages import pipeline
    cell, (lefts, rights, _) = pairs(workload)
    opts = cell.options()
    for left, right in zip(lefts, rights):
        got = pipeline.match(left, right, ADCensusOptions(**opts),
                             device="cpu")["disparity"]
        want = ref.match(left, right, opts, "cpu")
        assert want.dtype == np.float32 and want.shape == left.shape[:2]
        assert harness.mismatch_count(got, want) == 0
        assert np.isfinite(want).mean() > 0.9


def test_control_in_bfloat16_differs():
    cell, (lefts, rights, _) = pairs("cones.stream")
    opts = cell.options()
    for left, right in zip(lefts, rights):
        want = ref.match(left, right, opts, "cpu")
        low = ref.match(left, right, opts, "cpu", torch.bfloat16)
        assert harness.mismatch_count(low, want) > 0.05 * want.size


def test_reference_refuses_paths_it_does_not_hold():
    cell, (lefts, rights, _) = pairs("cones.stream", 1)
    for flag in ("exact_median", "do_discontinuity_adjustment"):
        with pytest.raises(ValueError):
            ref.match(lefts[0], rights[0], dict(cell.options(), **{flag: True}))


# (cell, options changed, block_bytes, volume type). Each block_bytes
# gives every blocked axis three blocks or more, and a d-block that D is
# not a multiple of; the tiny Cone's D = 6 has no block that does both,
# so there the blocks are three of two planes.
BLOCKED = [
    ("cones.stream", {}, 3840, torch.float32),
    ("kitti.stream", {}, 32768, torch.float32),
    ("cones.stream", {"min_disparity": -4}, 5760, torch.float32),
    ("kitti.stream", {"do_lr_check": False}, 32768, torch.float32),
    ("kitti.stream", {}, 32768, torch.bfloat16),
]


@pytest.mark.parametrize("workload, change, block_bytes, vol_dtype", BLOCKED)
def test_blocked_reference_equals_the_plain_one(workload, change,
                                                block_bytes, vol_dtype):
    cell, (lefts, rights, _) = pairs(workload)
    opts = dict(cell.options(), **change)
    h, w, _ = lefts[0].shape
    d = opts["max_disparity"] - opts["min_disparity"]
    axes = ((d, h * w * 4), (h, d * w * 4), (w, d * h * 4))
    assert min(len(blocked.blocks(n, unit, block_bytes))
               for n, unit in axes) >= 3
    assert d == 6 or d % blocked.block_len(d, h * w * 4, block_bytes)
    for left, right in zip(lefts, rights):
        want = ref.match(left, right, opts, "cpu", vol_dtype)
        got = blocked.match(left, right, opts, "cpu", vol_dtype,
                            block_bytes=block_bytes)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert harness.mismatch_count(got, want) == 0
    # the voting statistics merged over blocks, on votes spread over
    # every d but the second block's, where counts tie across blocks
    gen = torch.Generator().manual_seed(d)
    di = torch.randint(0, d, (h, w), generator=gen, dtype=torch.int32)
    d0, d1 = blocked.blocks(d, h * w * 4, block_bytes)[1]
    di = torch.where((di >= d0) & (di < d1), d1, di)
    valid = torch.rand((h, w), generator=gen) > 0.2
    target = torch.rand((h, w), generator=gen) > 0.1
    arms = ref.build_arms(torch.as_tensor(lefts[0]), opts)
    max_arm = opts["cross_L1"]
    want = ref._region_vote_stats(di, valid, arms, d, max_arm, target)
    got = blocked.region_vote_stats(di, valid, arms, d, max_arm, target,
                                    block_bytes)
    assert all(torch.equal(g, e) for g, e in zip(got, want))
