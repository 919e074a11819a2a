"""Kernel B4's grid of test cases and their seeded inputs, shared by the
CPU emulation tests (test_torch_ray_interp_geometry.py) and the card tests
(test_torch_cuda.py). Imports numpy and the port only."""
import numpy as np

from adcensus_torch.stages.refine import ray_offset_table

# (H, W, max_search, target, +inf share): target densities of 0, one
# pixel, 30 % and 100 % and a clustered strip; max_search 1, 2, 8, 64 and
# 256 (rays longer than the map); 1xN and Nx1 maps; maps with no finite
# cell and with every cell finite
CASES = {
    "empty": (20, 30, 8, "0%", 0.6),
    "one_pixel": (20, 30, 64, "one", 0.9),
    "sparse30": (20, 30, 8, "30%", 0.6),
    "all": (12, 17, 8, "100%", 0.6),
    "strip": (30, 20, 64, "strip", 0.8),
    "search1": (10, 13, 1, "30%", 0.3),
    "search2": (10, 13, 2, "30%", 0.5),
    "search64": (24, 30, 64, "30%", 0.95),
    "search256": (20, 30, 256, "30%", 0.97),
    "row": (1, 70, 64, "30%", 0.7),
    "column": (70, 1, 64, "30%", 0.7),
    "no_finite": (12, 17, 8, "30%", 1.0),
    "all_finite": (12, 17, 8, "100%", 0.0),
}


def ray_inputs(h, w, max_search, target_kind, seed, inf_share=0.6,
               nan_share=0.0):
    """Seeded (disp, color, offsets, target) as numpy arrays: disparities
    in [-8, 56) with ``inf_share`` +inf (and ``nan_share`` NaN) cells,
    random colors, the ray table of ``max_search`` and a target: a
    density such as "30%", "one" pixel, or a "strip" of rows."""
    rng = np.random.default_rng(seed)
    disp = (rng.random((h, w), np.float32) * 64 - 8).astype(np.float32)
    u = rng.random((h, w))
    disp[u < inf_share] = np.inf
    disp[u > 1 - nan_share] = np.nan
    color = rng.integers(0, 256, (h, w, 3), np.uint8)
    if target_kind == "one":
        target = np.zeros((h, w), bool)
        target[h // 2, w // 2] = True
    elif target_kind == "strip":
        target = np.zeros((h, w), bool)
        target[h // 3:h // 3 + max(1, h // 5)] = True
    else:
        target = rng.random((h, w)) < float(target_kind.rstrip("%")) / 100
    return disp, color, ray_offset_table(max_search), target


def case_inputs(case, seed=None, nan_share=0.0):
    """ray_inputs for a case of CASES, seeded by its size unless ``seed``
    is given."""
    h, w, max_search, target_kind, inf_share = CASES[case]
    return ray_inputs(h, w, max_search, target_kind,
                      seed=h * w + max_search if seed is None else seed,
                      inf_share=inf_share, nan_share=nan_share)
