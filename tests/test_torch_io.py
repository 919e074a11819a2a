"""The port's image and dataset I/O (adcensus_torch/io) against the JAX
package's (adcensus_tpu/io), following the cases of tests/test_io.py
that need no Middlebury data: PNG round trips through the native codec
and PIL, gray promotion, PFM, a Piano-style pair with a dropped-in PFM
ground truth under get_pair(data_root=...), d_range.txt, the colormap,
and the saved disparity PNGs and point cloud."""
import numpy as np
import pytest
from PIL import Image

from adcensus_torch.io import image, native_png
from adcensus_tpu.io import image as jax_image
from adcensus_tpu.io import native_png as jax_native_png


def test_native_codec_builds():
    assert native_png.load() is not None, "native codec failed to build"


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (1, 1, 3)])
def test_native_encode_roundtrip(tmp_path, shape):
    """Encode and decode give the image back; PIL and the JAX package's
    codec read the same file the same way."""
    img = np.random.default_rng(0).integers(0, 255, size=shape,
                                            dtype=np.uint8)
    p = str(tmp_path / "x.png")
    assert native_png.encode(img, p)
    np.testing.assert_array_equal(native_png.decode(p), img)
    np.testing.assert_array_equal(np.array(Image.open(p)), img)
    np.testing.assert_array_equal(jax_native_png.decode(p), img)


def test_load_image_rgb_gray_promotes(tmp_path):
    gray = np.random.default_rng(1).integers(0, 255, (9, 14), np.uint8)
    p = str(tmp_path / "g.png")
    image.save_png(gray, p)
    img = image.load_image_rgb(p)
    assert img.shape == (9, 14, 3)
    for c in range(3):
        np.testing.assert_array_equal(img[..., c], gray)
    np.testing.assert_array_equal(img, jax_image.load_image_rgb(p))


@pytest.mark.parametrize("mode", ["P", "RGBA", "I;16"])
def test_pil_fallback_equals_jax(tmp_path, mode):
    """Flavours the native codec decodes differently or not at all
    (palette, alpha, 16-bit gray) load as the JAX package loads them."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (11, 13, 3), np.uint8)
    if mode == "I;16":
        pil = Image.fromarray(rng.integers(0, 65535, (11, 13),
                                           np.uint16))
    else:
        pil = Image.fromarray(rgb).convert(mode)
    p = str(tmp_path / f"{mode[0]}.png")
    pil.save(p)
    ours = image.load_image_rgb(p)
    assert ours.shape == (11, 13, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, jax_image.load_image_rgb(p))


def test_gt_png_equals_jax(tmp_path):
    """Scaled ground truth, 0 as NaN, from a gray and an RGB PNG."""
    raw = np.random.default_rng(3).integers(0, 255, (10, 12), np.uint8)
    raw[2, 3] = 0
    for name, img in (("g.png", raw), ("c.png", np.repeat(raw[..., None],
                                                          3, -1))):
        p = str(tmp_path / name)
        image.save_png(img, p)
        ours = image.load_gt_disparity(p, 4.0)
        assert np.isnan(ours[2, 3])
        np.testing.assert_array_equal(ours,
                                      jax_image.load_gt_disparity(p, 4.0))


def test_pfm_roundtrip_and_gt_mapping(tmp_path):
    """PFM write/read round trip (both endianness branches), the
    Middlebury-2014 inf -> NaN convention, and the JAX reader's result."""
    rng = np.random.default_rng(1)
    disp = rng.uniform(0, 256, size=(23, 41)).astype(np.float32)
    disp[3, 5] = np.inf
    p = str(tmp_path / "disp0.pfm")
    image.save_pfm(disp, p)
    back = image.load_pfm(p)
    np.testing.assert_array_equal(back, disp)
    np.testing.assert_array_equal(jax_image.load_pfm(p), disp)
    gt = image.pfm_to_gt(back)
    assert np.isnan(gt[3, 5]) and np.isfinite(gt[0, 0])

    img = rng.uniform(-4, 4, size=(7, 9, 3)).astype(np.float32)
    pc = str(tmp_path / "c.pfm")
    with open(pc, "wb") as f:
        f.write(b"PF\n# a comment\n9 7\n1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype(">f4").tobytes())
    np.testing.assert_array_equal(image.load_pfm(pc), img)
    with pytest.raises(ValueError):
        image.save_pfm(np.zeros((2, 2, 2), np.float32), pc)


def _piano_dir(root, with_gt):
    """A Piano-style pair directory: two small PNGs, d_range.txt and,
    if asked, a disp0.pfm ground truth."""
    d = root / "Piano"
    d.mkdir()
    rng = np.random.default_rng(4)
    for name in ("im0.png", "im1.png"):
        image.save_png(rng.integers(0, 255, (12, 16, 3), np.uint8),
                       str(d / name))
    (d / "d_range.txt").write_text("dmin=-3\ndmax=61\n")
    if with_gt:
        gt = np.full((12, 16), 7.5, np.float32)
        gt[0, 0] = np.inf
        image.save_pfm(gt, str(d / "disp0.pfm"))


@pytest.mark.parametrize("with_gt", [True, False])
def test_get_pair_picks_up_piano_pfm(tmp_path, with_gt):
    """get_pair(data_root=...) finds a dropped-in disp0.pfm as ground
    truth, and loads what the JAX package's get_pair loads."""
    _piano_dir(tmp_path, with_gt)
    pair = image.get_pair("Piano", data_root=tmp_path)
    ref = jax_image.get_pair("Piano", data_root=str(tmp_path))
    assert (pair.dmin, pair.dmax) == (ref.dmin, ref.dmax) == (-3, 61)
    left, right, gt = pair.load()
    for ours, theirs in zip((left, right), ref.load()[:2]):
        np.testing.assert_array_equal(ours, theirs)
    if with_gt:
        assert np.isnan(gt[0, 0]) and gt[5, 5] == 7.5
    else:
        assert gt is None and ref.gt_path is None


def test_get_pair_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown pair 'Bogus'.*Cone"):
        image.get_pair("Bogus")
    assert image.ALL_PAIRS == jax_image.ALL_PAIRS


def test_d_range_and_colormap(tmp_path):
    p = tmp_path / "d_range.txt"
    p.write_text("dmin=0\ndmax=64\n")
    assert image.load_d_range(str(p)) == (0, 64)
    disp = np.array([[0.0, 32.0], [np.inf, 64.0]], np.float32)
    u8 = image.normalize_disparity_u8(disp)
    assert u8[1, 0] == 0 and u8[1, 1] == 255
    rgb = image.colorize_disparity(disp)
    assert rgb.shape == (2, 2, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_colormap_equals_jax(seed):
    rng = np.random.default_rng(seed)
    disp = rng.uniform(-5, 70, (20, 30)).astype(np.float32)
    disp[rng.random((20, 30)) < 0.2] = np.inf
    np.testing.assert_array_equal(image.normalize_disparity_u8(disp),
                                  jax_image.normalize_disparity_u8(disp))
    np.testing.assert_array_equal(image.colorize_disparity(disp),
                                  jax_image.colorize_disparity(disp))
    flat = np.full((3, 4), 2.0, np.float32)
    np.testing.assert_array_equal(image.colorize_disparity(flat),
                                  jax_image.colorize_disparity(flat))
    empty = np.full((3, 4), np.inf, np.float32)
    assert not image.normalize_disparity_u8(empty).any()


def test_saved_map_and_cloud_equal_jax(tmp_path):
    """The two PNGs and the point cloud decode and read as the JAX
    package's."""
    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 30, (8, 10)).astype(np.float32)
    disp[rng.random((8, 10)) < 0.3] = np.inf
    rgb = rng.integers(0, 255, (8, 10, 3), np.uint8)
    image.save_disparity_map(disp, str(tmp_path / "ours"))
    jax_image.save_disparity_map(disp, str(tmp_path / "jax"))
    for suffix in ("-d.png", "-c.png"):
        np.testing.assert_array_equal(
            image.load_image_rgb(str(tmp_path / ("ours" + suffix))),
            jax_image.load_image_rgb(str(tmp_path / ("jax" + suffix))))
    image.save_disparity_cloud(rgb, disp, str(tmp_path / "ours.txt"))
    jax_image.save_disparity_cloud(rgb, disp, str(tmp_path / "jax.txt"))
    ours = (tmp_path / "ours.txt").read_text()
    assert ours == (tmp_path / "jax.txt").read_text()
    assert len(ours.splitlines()) == int(np.isfinite(disp).sum())
