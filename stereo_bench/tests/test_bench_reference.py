"""The reference agrees with the program's CPU path, and its control in
a lower precision does not."""
import numpy as np
import pytest
import torch

from conftest import tiny_cell
from stereo_bench import harness
from stereo_bench.reference import adcensus as ref


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
