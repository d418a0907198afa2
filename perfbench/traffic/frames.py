"""The frames a cell's traffic carries, made from the seed with numpy:
the client process and the check make the same ones."""

from __future__ import annotations

import numpy as np


def uint8_frames(ring: int, height: int, width: int, seed: int) -> np.ndarray:
    """``ring`` RGB frames, ``(ring, height, width, 3)`` uint8."""
    return np.random.default_rng([seed, 3]).integers(0, 256, (ring, height, width, 3),
                                                    dtype=np.uint8)
