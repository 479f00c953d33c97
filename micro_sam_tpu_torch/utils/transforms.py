"""Input-size transforms for the SAM image encoder (``ResizeLongestSide``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_preprocess_shape(old_h: int, old_w: int, long_side: int) -> Tuple[int, int]:
    """Output (h, w) after resizing the longest side to ``long_side``."""
    scale = long_side * 1.0 / max(old_h, old_w)
    return int(old_h * scale + 0.5), int(old_w * scale + 0.5)


def resize_uint8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear, antialiased resize of an (H, W, C) uint8 image to ``size``,
    rounded to uint8 values (returned as float32)."""
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).numpy()


class ResizeLongestSide:
    """Resize so that the longest side is ``target_length``, with the matching
    coordinate and box transforms."""

    def __init__(self, target_length: int = 1024):
        self.target_length = target_length

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """(H, W, C) uint8 -> resized (h, w, C) float32 holding uint8 values."""
        h, w = image.shape[:2]
        new_hw = get_preprocess_shape(h, w, self.target_length)
        if new_hw == (h, w):
            return np.asarray(image, dtype=np.float32)
        return resize_uint8(image, new_hw)

    def apply_coords(self, coords: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """Map (..., 2) (x, y) coordinates from the original to the resized image."""
        old_h, old_w = original_size
        new_h, new_w = get_preprocess_shape(old_h, old_w, self.target_length)
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords.astype(np.float32)

    def apply_boxes(self, boxes: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """Map (..., 4) XYXY boxes from the original to the resized image."""
        return self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2), original_size).reshape(-1, 4)
