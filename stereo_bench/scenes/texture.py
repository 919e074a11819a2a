"""The block texture both scenes paint their surfaces with."""
from __future__ import annotations

import numpy as np

BLOCK = 8       # side of the texture's constant-colour blocks
NOISE = 8       # per-channel noise amplitude on top of the blocks


def texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random RGB in BLOCK x BLOCK blocks plus +-NOISE a channel, (h, w, 3)
    uint8. The blocks stay under the arms' colour threshold (cross_t1 =
    20), so cross arms and voting regions span several pixels, while the
    noise gives the census windows texture."""
    c = rng.integers(0, 256, size=(h // BLOCK + 1, w // BLOCK + 1, 3))
    c = np.repeat(np.repeat(c, BLOCK, 0), BLOCK, 1)[:h, :w]
    n = rng.integers(-NOISE, NOISE + 1, size=(h, w, 3))
    return np.clip(c + n, 0, 255).astype(np.uint8)
