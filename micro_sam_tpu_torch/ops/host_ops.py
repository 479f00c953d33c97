"""Host-side (CPU) image ops used by prompt derivation and postprocessing.

A copy of ``micro_sam_tpu/ops/host_ops.py`` (scipy / numpy only; the JAX
package's module cannot be imported here, since its package imports JAX):
``find_boundaries``, ``gaussian``, ``peak_local_max`` and ``regionprops`` in
the skimage semantics the prompt derivation needs. The heavier ops live in
``micro_sam_tpu_torch.native`` (C++).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def find_boundaries_outer(mask: np.ndarray) -> np.ndarray:
    """Background pixels 4-adjacent to the object (skimage mode='outer')."""
    mask = mask.astype(bool)
    dilated = ndimage.binary_dilation(mask, structure=ndimage.generate_binary_structure(2, 1))
    return dilated & ~mask


def gaussian_smooth(image: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    return ndimage.gaussian_filter(image.astype(np.float64), sigma=sigma, mode="nearest")


def peak_local_max(
    image: np.ndarray, min_distance: int = 1, exclude_border: bool = False
) -> np.ndarray:
    """Coordinates of local maxima with a minimum separation, ordered by
    decreasing intensity (skimage.feature.peak_local_max semantics subset)."""
    size = 2 * min_distance + 1
    maxfilt = ndimage.maximum_filter(image, size=size, mode="constant", cval=-np.inf)
    peaks_mask = (image == maxfilt) & (image > 0)
    if exclude_border and min_distance > 0:
        m = np.zeros_like(peaks_mask)
        m[min_distance:-min_distance or None, min_distance:-min_distance or None] = True
        peaks_mask &= m
    coords = np.column_stack(np.nonzero(peaks_mask))
    if len(coords) == 0:
        return coords
    order = np.argsort(image[tuple(coords.T)])[::-1]
    coords = coords[order]
    # greedy min-distance suppression (Chebyshev, matching the max-filter window)
    kept = []
    for c in coords:
        if all(np.abs(c - k).max() > min_distance for k in kept):
            kept.append(c)
    return np.asarray(kept, dtype=np.int64)


def distance_transform_edt(mask: np.ndarray, sampling=None) -> np.ndarray:
    return ndimage.distance_transform_edt(mask, sampling=sampling)


def binary_closing_1d_z(segmentation: np.ndarray, gap_closing: int) -> np.ndarray:
    """Binary closing along the z axis only (used in 3d merge preprocessing)."""
    structure = np.zeros((3, 1, 1), dtype=bool)
    structure[:, 0, 0] = True
    return ndimage.binary_closing(
        segmentation > 0, structure=structure, iterations=gap_closing
    )


class RegionProps:
    """Minimal regionprops record: label, area, bbox (y0, x0, y1, x1 [, z...]),
    centroid."""

    __slots__ = ("label", "area", "bbox", "slices", "centroid")

    def __init__(self, label, area, bbox, slices, centroid):
        self.label = label
        self.area = area
        self.bbox = bbox
        self.slices = slices
        self.centroid = centroid


def regionprops(segmentation: np.ndarray):
    """Per-object label/area/bbox/centroid (skimage.measure.regionprops subset)."""
    seg = np.asarray(segmentation)
    slices = ndimage.find_objects(seg)
    props = []
    for idx, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        local = seg[sl] == idx
        area = int(local.sum())
        bbox = tuple(s.start for s in sl) + tuple(s.stop for s in sl)
        coords = np.nonzero(local)
        centroid = tuple(float(c.mean() + s.start) for c, s in zip(coords, sl))
        props.append(RegionProps(idx, area, bbox, sl, centroid))
    return props
