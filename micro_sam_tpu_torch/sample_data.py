"""Sample data: the synthetic generator, the cached sample files and the
napari sample hooks (counterpart of the JAX package's ``sample_data.py``).

There is no download: a ``fetch_*`` helper returns the file or folder that
the cache (``<cachedir>/sample_data/``) already holds, and raises where it
does not; the ``sample_data_*`` hooks fall back to synthetic data.
"""
from __future__ import annotations

import os
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


def _require_cached(name: str) -> str:
    from .util import microsam_cachedir
    path = os.path.join(microsam_cachedir(), "sample_data", name)
    if not os.path.exists(path):
        raise RuntimeError(
            f"Sample dataset {name} is not cached at {path}; it is not downloaded.")
    return path


def fetch_image_series_example_data(save_directory: str) -> str:
    return _require_cached("image-series.zip.unzip")


def fetch_wholeslide_example_data(save_directory: str) -> str:
    return _require_cached("whole-slide-example-image.tif")


def fetch_livecell_example_data(save_directory: str) -> str:
    return _require_cached("livecell-2d-image.png")


def fetch_hela_2d_example_data(save_directory: str) -> str:
    return _require_cached("hela-2d-image.png")


def fetch_3d_example_data(save_directory: str) -> str:
    return _require_cached("lucchi_pp.zip.unzip")


def fetch_tracking_example_data(save_directory: str) -> str:
    return _require_cached("DIC-C2DH-HeLa.zip.unzip")


def fetch_tracking_segmentation_data(save_directory: str) -> str:
    return _require_cached("hela-ctc-01-gt.zip.unzip")


def fetch_nucleus_3d_example_data(save_directory: str) -> str:
    return _require_cached("3d-nucleus-data.zip.unzip")


def fetch_wholeslide_histopathology_example_data(save_directory: str) -> str:
    return _require_cached("whole-slide-histopathology-example-image.tif")


# -----------------------------------------------------------------------------
# napari sample-data hooks (reference sample_data.py:58-340): each returns
# napari layer-data tuples. Cached real data is used when present; otherwise a
# deterministic synthetic sample is generated.
# -----------------------------------------------------------------------------

def _layer(data, name):
    return [(data, {"name": name}, "image")]


def _cached_or_synthetic(fname: str, shape, seed: int, name: str):
    from .util import microsam_cachedir
    path = os.path.join(microsam_cachedir(), "sample_data", fname)
    if os.path.exists(path):
        import imageio.v3 as imageio
        return _layer(imageio.imread(path), name)
    image, _ = synthetic_data(shape=shape, seed=seed)
    return _layer(image, name)


def sample_data_wholeslide():
    """Whole-slide sample (reference sample_data.py:104)."""
    return _cached_or_synthetic(
        "whole-slide-example-image.tif", (1024, 1024), 10, "wholeslide")


def sample_data_livecell():
    """LIVECell sample (reference sample_data.py:143)."""
    return _cached_or_synthetic("livecell-2d-image.png", (520, 704), 11, "livecell")


def sample_data_hela_2d():
    """HeLa 2d sample (reference sample_data.py:182)."""
    return _cached_or_synthetic("hela-2d-image.png", (512, 512), 12, "hela_2d")


def sample_data_3d():
    """3d EM sample (reference sample_data.py:226)."""
    return _cached_or_synthetic("lucchi_volume.tif", (16, 384, 384), 13, "em_3d")


def sample_data_tracking():
    """Tracking timeseries sample (reference sample_data.py:277)."""
    frames = [synthetic_data(shape=(256, 256), seed=14 + t)[0] for t in range(8)]
    return _layer(np.stack(frames), "tracking")


def sample_data_segmentation():
    """Segmented sample with labels (reference sample_data.py:324)."""
    image, seg = synthetic_data(shape=(512, 512), seed=15)
    return [(image, {"name": "image"}, "image"),
            (seg, {"name": "segmentation"}, "labels")]


def sample_data_image_series():
    """Image series sample: one napari image layer per file in the series
    (reference sample_data.py:58). Falls back to three synthetic images of
    different sizes when no cached series exists."""
    from .util import microsam_cachedir
    base = os.path.join(microsam_cachedir(), "sample_data")
    try:
        data_dir = fetch_image_series_example_data(base)
        import imageio.v3 as imageio
        layers = []
        for i, fname in enumerate(sorted(os.listdir(data_dir))):
            layers.append((imageio.imread(os.path.join(data_dir, fname)),
                           {"name": f"series_{i}"}, "image"))
        return layers
    except Exception:
        shapes = [(512, 512), (512, 512), (256, 384)]
        return [(synthetic_data(shape=s, seed=20 + i)[0],
                 {"name": f"series_{i}"}, "image") for i, s in enumerate(shapes)]
