"""Fixtures of the benchmark's tests: a tiny copy of a cell, run on the
CPU with the program's plain versions."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from stereo_bench import harness  # noqa: E402

# A Cone-like and a street-like pair small enough for the CPU.
TINY = {
    "middlebury2003-cones": dict(height=16, width=30, max_disparity=6,
                                 scene_params={"d_bg": 2, "d_fg": 4}),
    "kitti2015": dict(height=24, width=64, max_disparity=16, scene_params={
        "focal_px": 40.0, "principal_row": 8.0, "baseline_m": 0.54,
        "camera_height_m": 1.0, "background_distance_m": 60.0,
        "vehicle_width_m": 1.7, "vehicle_height_m": 1.5,
        "vehicles": [[2, 4.0], [36, 3.0]]}),
}


def tiny_cell(workload: str, pairs: int = 2) -> harness.Cell:
    """The cell of BENCHMARK.json at a CPU size, comparing ``pairs``."""
    cell = harness.Cell.from_spec(harness.load_spec(ROOT), workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY[cfg["name"]])
    cfg["check"]["pairs"] = pairs
    cell.config = cfg
    return cell


def run_tiny(workload: str, trace: bool = False, entry=None,
             seconds: float = 0.0, warmup: int = 0) -> harness.Outcome:
    """One request of the tiny cell (a window of ``seconds`` sends at
    least one) on the CPU."""
    return harness.run_cell(tiny_cell(workload), seed=2 ** 33 + 5,
                            seconds=seconds, trace=trace, device="cpu",
                            entry=entry, warmup=warmup, log=lambda *a: None)


@pytest.fixture
def spec():
    return harness.load_spec(ROOT)


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
