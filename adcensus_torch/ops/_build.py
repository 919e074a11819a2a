"""Build and bind the CUDA kernels of ``adcensus_torch/csrc``.

Each ``csrc/<source>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/adcensus_torch/`` at the repository root, on
first use. Libraries are keyed by a hash of their sources and flags, so
an edited kernel rebuilds. They are loaded with ``ctypes``; every entry
point returns ``cudaGetLastError()`` and :func:`launch` raises on a
nonzero code. A failed build raises too: there is no fallback.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math``, and ``-fmad=false``
so that the kernels' float arithmetic rounds exactly like the plain
PyTorch versions, which run one operation per rounding.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adcensus_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# kernel name -> argtypes of its C entry point adc_<name>
SIGNATURES = {
    "cross_sum": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P),
    "scanline": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L,
                 _F, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    "region_vote": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ray_interp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P),
    "band_mm": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "median_inplace": (_P, _P, _I, _I, _P),
    "dda": (_P, _P, _P, _I, _I, _I, _P),
    "census": (_P, _P, _I, _I, _I, _I, _I, _P),
    "cost_volume": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _P),
}
# kernel name -> its source csrc/<source>.cu, where that is not the name
SOURCES = {"census": "cost", "cost_volume": "cost"}

# Kernel launches since the last reset, by kernel name. Only launch()
# adds to it; the plain versions never do.
launches = {name: 0 for name in SIGNATURES}

_entries: dict = {}
_error_string = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    """The CUDA toolkit's nvcc: /usr/local/cuda/bin/nvcc, else the first
    on PATH."""
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit in "
                           "/usr/local/cuda or add nvcc to PATH")
    return found


def _source(name: str) -> str:
    return SOURCES.get(name, name)


def _library(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / f"{src}.cu", CSRC / "common.cuh"):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile whichever of ``names`` (default: all kernels) are not
    built yet, one ``nvcc`` per source, all started together; load them.
    Returns {name: C entry point}."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if n not in _entries]
    if not todo:
        return {n: _entries[n] for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in dict.fromkeys(_source(n) for n in todo):
        lib = _library(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs.append((src, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for src, tmp, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    global _error_string
    for name in todo:
        cdll = ctypes.CDLL(str(_library(name)))
        fn = getattr(cdll, f"adc_{name}")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
        if _error_string is None:
            _error_string = cdll.adc_error_string
            _error_string.argtypes = (ctypes.c_int,)
            _error_string.restype = ctypes.c_char_p
    return {n: _entries[n] for n in names}


def entry(name: str, symbol: str, argtypes):
    """Another C entry point ``symbol`` of kernel ``name``'s library,
    built on first use, such as a probe that ``chip_smoke.py`` times. It
    returns an int error code; its calls are not counted."""
    build([name])
    fn = getattr(ctypes.CDLL(str(_library(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point (building it on first use),
    raise on a CUDA error, and count the launch."""
    fn = build([name])[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed: {_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    launches[name] += 1


def check(name: str, t, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` is what a kernel takes: ``dtype``,
    ``shape``, contiguous, on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
