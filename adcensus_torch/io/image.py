"""Image and dataset I/O.

The port's own copy of ``adcensus_tpu/io/image.py``. The reference uses
OpenCV only for PNG I/O and the JET colormap display (main.cpp:12-17,
147-210). Here PNGs go through the native codec (``io/native_png.py``)
first and PIL second; PIL is imported only where a file needs it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from adcensus_torch.io import native_png

# Where get_pair looks for the Middlebury pairs by default: Data/<name>/
# at the repository root, laid out as the reference's Data/ directory.
DATA_ROOT = Path(__file__).resolve().parents[2] / "Data"


def _pil_image():
    from PIL import Image

    return Image


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB: the native codec for 8-bit
    PNGs (gray promoted to three channels), PIL for anything else."""
    if str(path).lower().endswith(".png"):
        img = native_png.decode(path)
        if img is not None and img.dtype == np.uint8:
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            return img
    return np.array(_pil_image().open(path).convert("RGB"))


def load_gt_disparity(path: str, scale: float) -> np.ndarray:
    """Load a Middlebury ground-truth disparity PNG, stored scaled (Cone
    x4, Cloth3/Wood2 x2): 0 marks unknown pixels, returned as NaN."""
    raw = None
    if str(path).lower().endswith(".png"):
        raw = native_png.decode(path)
        if raw is not None and raw.ndim == 3:
            raw = raw[..., 0]
    if raw is None:
        raw = np.array(_pil_image().open(path))
        if raw.ndim == 3:  # the native path's channel-0 view
            raw = raw[..., 0]
    raw = raw.astype(np.float32)
    gt = raw / scale
    gt[raw == 0] = np.nan
    return gt


def load_pfm(path: str) -> np.ndarray:
    """Load a Middlebury ``.pfm`` disparity/float image as (H, W) or
    (H, W, 3) float32, top row first. The scale line's sign is the
    endianness (negative = little-endian); rows are stored bottom to top.
    Middlebury-2014 ground truth marks unknown pixels +inf (``pfm_to_gt``
    maps them to NaN)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"Pf", b"PF"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        channels = 3 if header == b"PF" else 1
        dims = f.readline().split()
        while dims and dims[0].startswith(b"#"):  # comment lines
            dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dt)
    img = data.reshape(h, w, channels)[::-1]
    img = np.ascontiguousarray(img).astype(np.float32)
    if abs(scale) not in (0.0, 1.0):
        img = img * np.float32(abs(scale))
    return img[..., 0] if channels == 1 else img


def save_pfm(img: np.ndarray, path: str) -> None:
    """Write a float32 (H, W) or (H, W, 3) array as little-endian PFM."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        header, data = b"Pf", img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        header, data = b"PF", img
    else:
        raise ValueError(f"PFM needs (H, W) or (H, W, 3), got {img.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # negative scale = little-endian
        f.write(np.ascontiguousarray(data[::-1]).astype("<f4").tobytes())


def pfm_to_gt(disp: np.ndarray) -> np.ndarray:
    """Middlebury-2014 PFM ground truth -> the engine's convention:
    unknown (inf) -> NaN."""
    gt = disp.astype(np.float32).copy()
    gt[~np.isfinite(gt)] = np.nan
    return gt


def load_d_range(path: str) -> Tuple[int, int]:
    """Parse a Data/<set>/d_range.txt file (``dmin=0\\ndmax=64``)."""
    with open(path) as f:
        text = f.read()
    dmin = int(re.search(r"dmin\s*=\s*(-?\d+)", text).group(1))
    dmax = int(re.search(r"dmax\s*=\s*(-?\d+)", text).group(1))
    return dmin, dmax


def normalize_disparity_u8(disp: np.ndarray) -> np.ndarray:
    """Min-max normalize |disparity| to uint8, invalid -> 0
    (main.cpp:147-178)."""
    a = np.abs(disp)
    valid = np.isfinite(a)
    if not valid.any():
        return np.zeros_like(a, dtype=np.uint8)
    lo, hi = a[valid].min(), a[valid].max()
    rng = hi - lo if hi > lo else 1.0
    out = np.zeros(a.shape, dtype=np.uint8)
    out[valid] = ((a[valid] - lo) / rng * 255).astype(np.uint8)
    return out


def _jet_lut() -> np.ndarray:
    """256-entry JET colormap (the piecewise-linear ramp family of
    OpenCV's COLORMAP_JET, main.cpp:175)."""
    lut = np.zeros((256, 3), dtype=np.uint8)
    for i in range(256):
        v = i / 255.0
        r = np.clip(1.5 - abs(4 * v - 3), 0, 1)
        g = np.clip(1.5 - abs(4 * v - 2), 0, 1)
        b = np.clip(1.5 - abs(4 * v - 1), 0, 1)
        lut[i] = (int(r * 255), int(g * 255), int(b * 255))
    return lut


_JET = _jet_lut()


def colorize_disparity(disp: np.ndarray) -> np.ndarray:
    """JET-colormapped (H, W, 3) uint8 rendering of a disparity map."""
    return _JET[normalize_disparity_u8(disp)]


def save_png(img: np.ndarray, path: str) -> None:
    """Write (H, W) or (H, W, 3) uint8 as a PNG: native codec, else PIL."""
    if not native_png.encode(img, path):
        _pil_image().fromarray(img).save(path)


def save_disparity_map(disp: np.ndarray, path_prefix: str) -> None:
    """Save gray + JET-colormap PNGs, ``<prefix>-d.png`` and
    ``<prefix>-c.png``, mirroring SaveDisparityMap (main.cpp:180-210)."""
    save_png(normalize_disparity_u8(disp), path_prefix + "-d.png")
    save_png(colorize_disparity(disp), path_prefix + "-c.png")


def save_disparity_cloud(
    img_rgb: np.ndarray, disp: np.ndarray, path: str
) -> None:
    """Point-cloud text export ``x y d r g b`` of the valid pixels
    (main.cpp:212-230)."""
    h, w = disp.shape
    with open(path, "w") as f:
        for y in range(h):
            for x in range(w):
                d = abs(disp[y, x])
                if not np.isfinite(d):
                    continue
                r, g, b = img_rgb[y, x]
                f.write(f"{float(x):f} {float(y):f} {d:f} {r} {g} {b}\n")


@dataclass(frozen=True)
class StereoPair:
    name: str
    left_path: str
    right_path: str
    gt_path: Optional[str]
    gt_scale: float
    dmin: int
    dmax: int

    def load(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        left = load_image_rgb(self.left_path)
        right = load_image_rgb(self.right_path)
        if self.gt_path is None:
            gt = None
        elif self.gt_path.lower().endswith(".pfm"):
            gt = pfm_to_gt(load_pfm(self.gt_path))
        else:
            gt = load_gt_disparity(self.gt_path, self.gt_scale)
        return left, right, gt


# The Middlebury pairs of the reference's Data/ (d ranges from
# d_range.txt; ground-truth scales: Cone quarter-size x4, Cloth3/Wood2
# half-size 2006 pairs x2).
_PAIR_FILES = {
    "Cone": ("im2.png", "im6.png", "disp2.png", 4.0),
    "Cloth3": ("view1.png", "view5.png", "disp1.png", 2.0),
    "Wood2": ("view1.png", "view5.png", "disp1.png", 2.0),
    "Piano": ("im0.png", "im1.png", None, 1.0),
}
ALL_PAIRS = tuple(_PAIR_FILES)


def get_pair(name: str, data_root=DATA_ROOT) -> StereoPair:
    """The pair ``name`` under ``data_root``/``name``/. An unknown name
    raises ValueError listing the known ones. A 2014-style pair (Piano)
    without ground truth takes ``disp0.pfm`` if one is there."""
    if name not in _PAIR_FILES:
        raise ValueError(
            f"unknown pair {name!r}; bundled pairs: "
            + ", ".join(sorted(_PAIR_FILES))
        )
    lf, rf, gf, scale = _PAIR_FILES[name]
    base = Path(data_root) / name
    if gf is None and (base / "disp0.pfm").exists():
        gf = "disp0.pfm"
    dmin, dmax = load_d_range(str(base / "d_range.txt"))
    return StereoPair(
        name=name,
        left_path=str(base / lf),
        right_path=str(base / rf),
        gt_path=str(base / gf) if gf else None,
        gt_scale=scale,
        dmin=dmin,
        dmax=dmax,
    )
