"""Cases shared by the tests of kernel A1 (csrc/arms.cu): its numpy
emulation on the CPU (test_torch_arms_loop.py) and the kernel on the card
(test_torch_arms_cuda.py), each against stages/arms.py:build_arms_plain."""
import numpy as np

KINDS = ("random", "smooth", "noisy", "blocks")
# (cross_L1, cross_L2); a cap of 300 runs 255 steps
CAPS = ((0, 0), (1, 1), (34, 17), (34, 40), (200, 100), (300, 150))
# (cross_t1, cross_t2)
THRESHOLDS = ((20, 6), (20.5, 6.25), (1, 0), (256, 256))
SMALL = ((1, 1), (1, 50), (50, 1), (2, 3))
# (row_offset, full_h, full_w, columns of the slab beyond full_w)
SLABS = (
    (-34, 60, 47, 0),   # the slab starts 34 rows above the image
    (20, 60, 47, 0),    # rows 20.. of a 60-row image: context missing below
    (10, 200, 45, 2),   # a slab two columns wider than the image
    (0, 33, 40, 7),
)


def image(kind, h, w, seed):
    """A seeded (H, W, 3) uint8 image of a kind."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "smooth":  # arms run to the cap or the border
        return (100 + rng.integers(-2, 3, (h, w, 3))).astype(np.uint8)
    if kind == "noisy":  # distances of 0 to 10: arms beyond L2 end at t2
        return (100 + rng.integers(-5, 6, (h, w, 3))).astype(np.uint8)
    # blocks of flat color with noise: arms stop at the blocks' edges
    yy, xx = np.mgrid[:h, :w]
    base = ((yy // 7 * 37 + xx // 11 * 59) % 200).astype(np.int64)
    noise = rng.integers(-4, 5, (h, w, 3))
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)
