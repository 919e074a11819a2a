"""Each cell on the card for a short window, traced and not: the last
line parses, with the contract's keys, and the run is correct.

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        stereo_bench/tests/test_bench_cuda.py

from the root of a checkout on a machine with a card; it skips without
one.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_prints_a_correct_last_line(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "stereo_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["device"]["window_s"] > 0
    else:
        assert "setup_s" in line["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
