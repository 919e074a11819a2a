"""Cases of kernel W1's tests (csrc/wta.cu): the CPU emulation's
(tests/test_torch_wta_scan.py) and the card's (tests/test_torch_wta_cuda.py).
numpy only, so the card's tests load no JAX."""
import numpy as np

# name -> (D, H, W, min_disparity, real_w (None: W), volume kind)
CASES = {
    "d64": (64, 20, 70, 0, None, "random"),
    "d1": (1, 5, 7, 0, None, "random"),
    "d2": (2, 5, 7, 3, None, "random"),
    "d3": (3, 5, 7, -4, None, "random"),
    "w_below_d": (24, 6, 9, 0, None, "random"),
    "min_d_neg": (16, 8, 40, -4, None, "random"),
    "min_d_pos": (16, 8, 40, 3, None, "random"),
    "real_w": (16, 8, 40, 0, 29, "random"),
    "real_w_min_d_neg": (16, 8, 40, -4, 33, "random"),
    "constant": (8, 6, 30, 0, None, "constant"),
    "ties_adjacent": (12, 10, 30, 0, None, "ties"),
    "integer_costs": (12, 10, 30, -4, None, "integer"),
    # x + d + 30 >= W for every column and plane
    "right_all_beyond": (8, 6, 20, 30, None, "random"),
    # x + d - 40 < 0 for every plane of the first 33 columns
    "right_all_before": (8, 6, 50, -40, None, "random"),
}


def volume(name: str) -> np.ndarray:
    d, h, w, _, _, kind = CASES[name]
    rng = np.random.default_rng(d * 1000 + h * 10 + w)
    if kind == "constant":
        return np.full((d, h, w), 0.75, np.float32)
    if kind == "integer":
        return rng.integers(0, 3, (d, h, w)).astype(np.float32)
    vol = (rng.random((d, h, w), np.float32) + 1).astype(np.float32)
    if kind == "ties":  # the minimum twice, at k and k + 1
        k = rng.integers(0, d - 1, (h, w))
        np.put_along_axis(vol, k[None], np.float32(0.5), 0)
        np.put_along_axis(vol, k[None] + 1, np.float32(0.5), 0)
    return vol
