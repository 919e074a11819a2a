"""The port stands alone: every module of adcensus_torch, and
chip_smoke.py, imports with JAX made unimportable and loads nothing of
adcensus_tpu; and no source of the port reads an environment variable."""
import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None      # `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import adcensus_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    adcensus_torch.__path__, "adcensus_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({
    "modules": names,
    "tpu": sorted(m for m in sys.modules
                  if m.split(".")[0] == "adcensus_tpu"),
    "jax": [m for m in ("jax", "jaxlib") if sys.modules.get(m) is not None],
}))
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen["tpu"] == [] and seen["jax"] == []
    on_disk = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "adcensus_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    assert set(on_disk) <= set(seen["modules"])
    assert "adcensus_torch.ops.band_mm" in seen["modules"]


def test_port_reads_no_environment_variable():
    for path in sorted((ROOT / "adcensus_torch").rglob("*.py")):
        text = path.read_text()
        for word in ("environ", "getenv"):
            assert word not in text, f"{path.name} mentions {word}"


def _imported_names(path):
    """Every module name that ``path`` imports, with each name taken from
    a module (``from a.b import c`` gives a.b and a.b.c)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names += [node.module] + [
                f"{node.module}.{a.name}" for a in node.names]
    return names


def _imports_of(subs, package):
    """{file: names of adcensus_torch.<package> it imports} for the
    files under adcensus_torch/<sub> of ``subs`` that import any."""
    found = {}
    for sub in subs:
        for path in sorted((ROOT / "adcensus_torch" / sub).rglob("*.py")):
            bad = [n for n in _imported_names(path)
                   if n.split(".")[:2] == ["adcensus_torch", package]]
            if bad:
                found[f"{sub}/{path.name}"] = bad
    return found


def test_stages_and_ops_do_not_import_the_sharded_layer():
    """Arrows point one way, parallel -> stages -> ops: no module under
    adcensus_torch/stages or adcensus_torch/ops imports
    adcensus_torch.parallel."""
    assert _imports_of(("stages", "ops"), "parallel") == {}


def test_utils_do_not_import_the_stages():
    """utils -> stages would close a cycle, as the stages import
    ``span`` from utils/profiling.py: no module under adcensus_torch/utils
    imports adcensus_torch.stages or adcensus_torch.parallel."""
    assert _imports_of(("utils",), "stages") == {}
    assert _imports_of(("utils",), "parallel") == {}
