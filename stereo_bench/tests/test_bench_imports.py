"""Nothing the benchmark runs imports JAX or the JAX package, by
top-level module names compared whole; the reference imports nothing of
the program."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "stereo_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "adcensus_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_names_jax():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_names_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                           "torch"}, path


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, json; sys.path.insert(0, 'stereo_bench/tests');"
        "from conftest import run_tiny;"
        "out = run_tiny('cones.batch8');"
        "assert out.correct, out.checks;"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )
    names = _modules_after(code)
    assert "adcensus_torch" in names and "stereo_bench" in names
    assert not names & FORBIDDEN


def test_the_reference_runs_without_the_program():
    code = (
        "import sys, json, numpy as np; sys.path.insert(0, '.');"
        "from stereo_bench.reference import adcensus as ref;"
        "from stereo_bench.scenes import two_layer;"
        "l, r, g = two_layer.make(16, 30, {'d_bg': 2, 'd_fg': 4},"
        " np.random.default_rng(1));"
        "o = json.load(open('stereo_bench/configs/"
        "middlebury2003-cones.json'));"
        "opts = dict(o['options'], min_disparity=0, max_disparity=6);"
        "ref.match(l, r, opts);"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )
    names = _modules_after(code)
    assert "torch" in names
    assert "adcensus_torch" not in names and not names & FORBIDDEN


def test_a_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run stops before any result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "stereo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from stereo_bench import harness;"
        "cell = harness.Cell.from_spec(harness.load_spec(), 'cones.stream');"
        "harness.run_cell(cell, 1, 0.0, False, device='cpu')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and not out.stdout
    assert "No module named 'adcensus_torch'" in out.stderr
