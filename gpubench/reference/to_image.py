"""Plain min-max normalization of a microscopy slice to SAM's input, as
upstream micro-sam's ``util._to_image`` writes it: the channels brought to
three (a grey slice repeated), then per channel, in float32, the minimum
subtracted and the result divided by its maximum plus 1e-7, times 255,
truncated to uint8. Nothing here imports ``jax``, ``micro_sam_tpu`` or
``micro_sam_tpu_torch``.
"""
from __future__ import annotations

import numpy as np


def to_image(image: np.ndarray) -> np.ndarray:
    """(H, W) grey or (H, W, 3) -> (H, W, 3) uint8."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"a grey or three-channel slice, not {image.shape}")
    x = image.astype(np.float32)
    x -= x.min(axis=(0, 1))[None, None]
    x /= x.max(axis=(0, 1))[None, None] + 1e-7
    return (x * 255).astype(np.uint8)
