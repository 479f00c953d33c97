"""Synthetic sample data (counterpart of ``micro_sam_tpu/sample_data.py::synthetic_data``)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_data(shape: Tuple[int, ...] = (512, 512), radius_range: Tuple[int, int] = (15, 30),
                   n_objects: Optional[int] = None, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A synthetic image of disks (spheres in 3d) and its instance segmentation.

    2d (H, W) or 3d (Z, H, W); objects never overlap, so the segmentation has
    exact object counts. The same seed gives the JAX package's arrays."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    if ndim not in (2, 3):
        raise ValueError(f"synthetic_data: shape {shape} is neither 2d nor 3d")
    r_cap = max(2, (min(shape) - 6) // 2)  # radii must fit the smallest axis
    radius_range = (min(radius_range[0], r_cap), min(radius_range[1], r_cap))
    image = np.zeros(shape, dtype=np.uint8)
    segmentation = np.zeros(shape, dtype=np.uint32)
    if n_objects is None:
        n_objects = max(4, int(np.prod([s / 96 for s in shape[-2:]]) * 4))

    centers = np.zeros((n_objects, ndim), np.int64)  # of the objects placed so far
    radii = np.zeros(n_objects, np.int64)
    label = 0
    attempts = 0
    while label < n_objects and attempts < n_objects * 50:
        attempts += 1
        r = int(rng.integers(radius_range[0], radius_range[1] + 1))
        center = [int(rng.integers(r + 2, s - r - 2)) for s in shape]
        d2 = ((centers[:label] - np.array(center)) ** 2).sum(axis=1)
        if (d2 < (radii[:label] + r + 3) ** 2).any():
            continue
        # the disk within its bounding box (the centre keeps it inside the image)
        box = tuple(slice(c - r, c + r + 1) for c in center)
        disk = sum(d ** 2 for d in np.ogrid[tuple(slice(-r, r + 1) for _ in shape)]) <= r ** 2
        label += 1
        image[box][disk] = 255
        segmentation[box][disk] = label
        centers[label - 1], radii[label - 1] = center, r

    noise = rng.normal(0, 8, size=shape)
    image = np.clip(image.astype(np.float64) * 0.7 + 40 + noise, 0, 255).astype(np.uint8)
    return image, segmentation
