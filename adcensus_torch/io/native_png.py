"""ctypes binding of the repository's native PNG codec
(``native/png_codec.cpp``, a small C++ codec over the system zlib).

The port's own copy of ``adcensus_tpu/io/native_png.py``. The codec is
compiled with ``g++`` on first use into ``build/adcensus_torch/`` under a
name keyed by a hash of its source (written under a temporary name and
renamed, so that processes building at once never load a partial file)
and loaded with ``ctypes``. Where it cannot be built, or a file uses a PNG
flavour it does not decode (palette, interlaced), ``decode`` and
``encode`` say so and the callers (``io/image.py``) use PIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "png_codec.cpp"
BUILD_DIR = _ROOT / "build" / "adcensus_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libpng_codec-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-lz", "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The codec, built on first use; None where it cannot be built (no
    g++ or no zlib)."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            try:
                lib = ctypes.CDLL(str(_build()))
            except (OSError, subprocess.CalledProcessError):
                _failed = True
                return None
            lib.png_probe.argtypes = (_U8P, ctypes.c_long, _IP, _IP, _IP,
                                      _IP, _IP)
            lib.png_probe.restype = ctypes.c_int
            lib.png_decode.argtypes = (_U8P, ctypes.c_long, _U8P)
            lib.png_decode.restype = ctypes.c_int
            lib.png_encode_bound.argtypes = (ctypes.c_int,) * 3
            lib.png_encode_bound.restype = ctypes.c_long
            lib.png_encode.argtypes = (_U8P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _U8P)
            lib.png_encode.restype = ctypes.c_long
            _lib = lib
        return _lib


def decode(path: str) -> Optional[np.ndarray]:
    """Decode a PNG natively: (H, W) uint8, (H, W) uint16 or (H, W, 3)
    uint8; None when the codec is unavailable or the flavour unsupported
    (the caller falls back to PIL)."""
    lib = load()
    if lib is None:
        return None
    buf = np.fromfile(path, dtype=np.uint8)
    ints = [ctypes.c_int() for _ in range(5)]
    if lib.png_probe(buf.ctypes.data_as(_U8P), buf.size,
                     *(ctypes.byref(i) for i in ints)) != 0:
        return None
    w, h, _, _, ch = (i.value for i in ints)
    out = np.empty(h * w * ch, dtype=np.uint8)
    if lib.png_decode(buf.ctypes.data_as(_U8P), buf.size,
                      out.ctypes.data_as(_U8P)) != 0:
        return None
    if ch == 2:  # gray16, native endian
        return out.view(np.uint16).reshape(h, w)
    if ch == 1:
        return out.reshape(h, w)
    return out.reshape(h, w, 3)


def encode(img: np.ndarray, path: str) -> bool:
    """Encode (H, W) or (H, W, 3) uint8 to a PNG file natively. False when
    the codec is unavailable or the shape is not one it encodes."""
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        (h, w), ch = img.shape, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        h, w, ch = img.shape
    else:
        return False
    out = np.empty(int(lib.png_encode_bound(w, h, ch)), dtype=np.uint8)
    n = lib.png_encode(img.ctypes.data_as(_U8P), w, h, ch,
                       out.ctypes.data_as(_U8P))
    if n <= 0:
        return False
    out[:n].tofile(path)
    return True
