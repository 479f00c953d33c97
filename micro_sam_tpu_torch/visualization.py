"""Embedding visualization via PCA: counterpart of the JAX package's
``visualization.py`` (upstream micro_sam/visualization.py), numpy on the host
over the embeddings' cache layout.

Projects the (64, 64, 256) image embeddings to RGB with a PCA fit on the
embedding pixels, crops the square padding back to the image aspect ratio, and
reassembles tiled embeddings.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .util import ImageEmbeddings
from .utils.blocking import Blocking


def compute_pca(embeddings: np.ndarray, n_components: int = 3,
                as_rgb: bool = True) -> np.ndarray:
    """PCA of per-pixel embedding channels -> (H, W, n_components); with
    ``as_rgb`` the projection is normalized to [0, 1] for display
    (reference visualization.py:20)."""
    if embeddings.ndim == 4:  # (1, C, H, W)
        embeddings = embeddings[0]
    C, H, W = embeddings.shape
    X = embeddings.reshape(C, -1).T  # (H*W, C)
    X = X - X.mean(axis=0, keepdims=True)
    # PCA via SVD on the (pixels, channels) matrix
    _, _, vt = np.linalg.svd(X, full_matrices=False)
    proj = X @ vt[:n_components].T  # (H*W, n_components)
    if as_rgb:
        proj -= proj.min(axis=0, keepdims=True)
        denom = np.maximum(proj.max(axis=0, keepdims=True), 1e-7)
        proj /= denom
    return proj.reshape(H, W, n_components)


def _get_crop(embedding_shape: Tuple[int, int], original_shape: Tuple[int, int]):
    """Embeddings correspond to the square-padded image; crop back to the
    aspect ratio of the original (reference visualization.py:58)."""
    eh, ew = embedding_shape
    oh, ow = original_shape
    if oh == ow:
        return np.s_[:, :]
    if oh > ow:
        return np.s_[:, : int(round(ew * ow / oh))]
    return np.s_[: int(round(eh * oh / ow)), :]


def project_embeddings_for_visualization(
    image_embeddings: ImageEmbeddings, n_components: int = 3, as_rgb: bool = True,
) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Project image embeddings to an RGB visualization, handling 2d / 3d /
    tiled layouts (reference visualization.py:152).

    Returns (embedding_vis, scale_to_original).
    """
    features = image_embeddings["features"]
    if image_embeddings.get("input_size") is None:
        return _project_tiled_embeddings(image_embeddings)

    original_size = image_embeddings["original_size"]
    feats = np.asarray(features)
    if feats.ndim == 4:  # 2d: (1, C, H, W)
        crop = _get_crop(feats.shape[-2:], original_size)
        vis = compute_pca(feats, n_components=n_components, as_rgb=as_rgb)[crop]
        scale = tuple(float(o) / float(v) for o, v in zip(original_size, vis.shape[:2]))
    else:  # 3d: (Z, 1, C, H, W)
        vis = []
        for z in range(feats.shape[0]):
            crop = _get_crop(feats.shape[-2:], original_size)
            vis.append(compute_pca(feats[z], n_components=n_components, as_rgb=as_rgb)[crop])
        vis = np.stack(vis)
        scale = (1.0,) + tuple(
            float(o) / float(v) for o, v in zip(original_size, vis.shape[1:3])
        )
    return vis, scale


def _project_tiled_embeddings(image_embeddings: ImageEmbeddings):
    features = image_embeddings["features"]
    shape = tuple(image_embeddings["shape"])[-2:]
    tile_shape = tuple(image_embeddings["tile_shape"])
    halo = tuple(image_embeddings["halo"])
    tiling = Blocking([0, 0], shape, tile_shape)

    # per-tile PCA, paste inner blocks into the full grid (approximate but fast)
    tile_keys = sorted(
        features.keys() if isinstance(features, dict) else [int(k) for k in features.keys()]
    )
    # determine embedding resolution per tile from the first tile
    first = features[tile_keys[0]]
    feats0 = np.asarray(first["features"] if isinstance(first, dict) else first[...])
    e = feats0.shape[-1]

    # output canvas at (shape / tile * e) resolution
    out_h = int(np.ceil(shape[0] / tile_shape[0])) * e
    out_w = int(np.ceil(shape[1] / tile_shape[1])) * e
    vis = np.zeros((out_h, out_w, 3), dtype=np.float32)

    for tile_id in tile_keys:
        entry = features[tile_id]
        feats = np.asarray(entry["features"] if isinstance(entry, dict) else entry[...])
        pca = compute_pca(feats)
        pos = tiling.block_grid_position(int(tile_id))
        y0, x0 = pos[0] * e, pos[1] * e
        vis[y0:y0 + e, x0:x0 + e] = pca
    scale = tuple(float(s) / float(v) for s, v in zip(shape, vis.shape[:2]))
    return vis, scale
