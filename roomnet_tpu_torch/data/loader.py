"""Square crops of the host preprocess (port of roomnet_tpu/data/loader.py:49-75).

The reference centre-crops every image to a square on its short side
before the resize (generator.py:69-78, network.py:137-146). `draw_crop_rect`
gives the same rectangle from the header's (h, w) alone, for the native
decoder, which crops while it resizes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["center_crop", "draw_crop_rect"]


def center_crop(im: np.ndarray) -> np.ndarray:
    """Centered square crop (generator.py:69-78, network.py:137-146)."""
    h, w = im.shape[:2]
    off = abs((w - h) // 2)
    if h < w:
        return im[:, off : off + h, :]
    if w < h:
        return im[off : off + w, :, :]
    return im


def draw_crop_rect(
    h: int, w: int, *, random_crop: bool, rng: np.random.RandomState | None
) -> tuple[int, int, int, int]:
    """(cx, cy, cw, ch) square crop — random-sliding (generator.py:52-67) or
    centered (generator.py:69-78). Drawn in Python so the native and cv2
    backends consume the identical RNG sequence."""
    if h == w:
        return 0, 0, w, h
    side = min(h, w)
    if random_crop:
        start = int(rng.randint(max(h, w) - side))
    else:
        start = abs((w - h) // 2)
    if h < w:
        return start, 0, side, side
    return 0, start, side, side
