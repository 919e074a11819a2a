"""Each cell on the card for a short window, traced and not: the last
line parses, with the contract's keys, and the run is correct. The
blocked reference equals the plain one on the card, and holds a
Middlebury 2014 full-size pair at D = 640 within 40 GB.

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        stereo_bench/tests/test_bench_cuda.py

from the root of a checkout on a machine with a card; it skips without
one.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
CHIPS = {w["name"]: w["chips"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
CELLS = list(CHIPS)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_prints_a_correct_last_line(card, workload, trace):
    import torch
    if torch.cuda.device_count() < CHIPS[workload]:
        pytest.skip(f"{workload} needs {CHIPS[workload]} cards")
    out = subprocess.run(
        [sys.executable, "stereo_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == CHIPS[workload]
    assert line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["device"]["window_s"] > 0
    else:
        assert "setup_s" in line["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def _pair(config: str, height: int, width: int, d_max: int, scene_params,
          seed: int):
    """A pair of the configuration's scene at another size and range,
    and the options to match it with."""
    from stereo_bench import harness
    cfg = json.loads((ROOT / f"stereo_bench/configs/{config}.json")
                     .read_text())
    cfg.update(height=height, width=width, max_disparity=d_max,
               scene_params=scene_params)
    cell = harness.Cell("x", 1, cfg, {}, [], [])
    rng = np.random.default_rng(harness.seed_words(seed))
    left, right, gt = cell.scene().make(height, width, scene_params, rng)
    return left, right, gt, cell.options()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["middlebury2003-cones", "kitti2015"])
def test_blocked_reference_equals_the_plain_one_on_the_card(card, config):
    from stereo_bench import harness
    from stereo_bench.reference import adcensus, adcensus_blocked
    cfg = json.loads((ROOT / f"stereo_bench/configs/{config}.json")
                     .read_text())
    h, w, d = cfg["height"], cfg["width"], cfg["max_disparity"]
    left, right, _, opts = _pair(config, h, w, d, cfg["scene_params"],
                                 2 ** 31 + 29)
    want = adcensus.match(left, right, opts, "cuda")
    # five blocks or so on every axis
    got = adcensus_blocked.match(left, right, opts, "cuda",
                                 block_bytes=d * h * w * 4 // 5)
    assert harness.mismatch_count(got, want) == 0


@pytest.mark.cuda
def test_blocked_reference_at_middlebury_2014_full_size(card):
    """Middlebury 2014 trainingF size, 2632x1988 at d in [0, 640): one
    pair through the blocked reference alone; prints its seconds and
    peak reserved bytes."""
    import time

    import torch

    from stereo_bench import harness
    from stereo_bench.reference import adcensus_blocked
    left, right, gt, opts = _pair("middlebury2003-cones", 1988, 2632, 640,
                                  {"d_bg": 150, "d_fg": 520}, 2 ** 31 + 31)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    disp = adcensus_blocked.match(left, right, opts, "cuda")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved()
    print(json.dumps({"blocked_reference": "2632x1988 D 640",
                      "seconds": seconds, "peak_reserved_bytes": peak,
                      "peak_allocated_bytes":
                          torch.cuda.max_memory_allocated(),
                      "block_bytes": adcensus_blocked.BLOCK_BYTES,
                      "bad_2_pct": harness.bad_pct(disp, gt),
                      "card": torch.cuda.get_device_name()}))
    assert disp.shape == (1988, 2632) and disp.dtype == np.float32
    assert peak <= 40e9
