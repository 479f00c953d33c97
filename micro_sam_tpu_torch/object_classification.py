"""Object classification from SAM embeddings and a random forest:
counterpart of the JAX package's ``object_classification.py`` (upstream
micro_sam/object_classification.py). The features are numpy on the host over
the embeddings' cache layout (bf16 embeddings from the card are read as
float32); sklearn, joblib and h5py are imported at the call."""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from . import util
from .utils.blocking import Blocking


def _resize_nearest(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    ys = (np.arange(shape[0]) * arr.shape[0] / shape[0]).astype(int)
    xs = (np.arange(shape[1]) * arr.shape[1] / shape[1]).astype(int)
    return arr[ys[:, None], xs[None, :]]


def compute_object_features_2d(image_embeddings, segmentation: np.ndarray,
                               resize_embedding_shape: Tuple[int, int] = (256, 256),
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-object features: mean embedding (256) + area = 257-dim
    (reference object_classification.py:20). ``resize_embedding_shape``:
    pooling resolution for the embedding grid — upsampling the 64x64 grid
    (capped at the segmentation size, as in the reference) keeps small
    objects from vanishing during mean pooling."""
    feats = np.asarray(image_embeddings["features"])
    if feats.ndim == 4:
        feats = feats[0]  # (C, H, W)
    C = feats.shape[0]
    if resize_embedding_shape is not None:
        pool_shape = tuple(min(r, s) for r, s in
                           zip(resize_embedding_shape, segmentation.shape[:2]))
        if pool_shape != feats.shape[-2:]:
            feats = np.stack([_resize_nearest(c, pool_shape) for c in feats])
    seg_small = _resize_nearest(segmentation, feats.shape[-2:])

    ids = np.unique(segmentation)
    ids = ids[ids != 0]
    features, kept = [], []
    for oid in ids:
        mask = seg_small == oid
        if not mask.any():
            # object vanished at embedding resolution; use its nearest pixel
            ys, xs = np.nonzero(segmentation == oid)
            cy = int(ys.mean() * feats.shape[-2] / segmentation.shape[0])
            cx = int(xs.mean() * feats.shape[-1] / segmentation.shape[1])
            mean_emb = feats[:, min(cy, feats.shape[-2] - 1), min(cx, feats.shape[-1] - 1)]
        else:
            mean_emb = feats[:, mask].mean(axis=1)
        area = float((segmentation == oid).sum())
        features.append(np.concatenate([mean_emb, [area]]))
        kept.append(oid)
    return np.asarray(kept), np.asarray(features, dtype=np.float32)


def compute_object_features(
    image_embeddings, segmentation: np.ndarray, n_threads: Optional[int] = None,
    verbose: bool = True, resize_embedding_shape: Tuple[int, int] = (256, 256),
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute object features for 2d / tiled / 3d embeddings
    (reference object_classification.py:109)."""
    if image_embeddings.get("input_size") is None:
        return _compute_object_features_tiled(image_embeddings, segmentation)
    feats = np.asarray(image_embeddings["features"])
    if feats.ndim == 5:  # 3d
        all_ids, all_feats, all_weights = {}, {}, {}
        for z in range(feats.shape[0]):
            emb_z = {"features": feats[z], "input_size": image_embeddings["input_size"],
                     "original_size": image_embeddings["original_size"]}
            ids, fz = compute_object_features_2d(
                emb_z, segmentation[z], resize_embedding_shape=resize_embedding_shape)
            for oid, f in zip(ids, fz):
                w = f[-1]
                if oid in all_feats:
                    all_feats[oid] += f * w
                    all_weights[oid] += w
                else:
                    all_feats[oid] = f * w
                    all_weights[oid] = w
        ids = np.array(sorted(all_feats.keys()))
        features = np.stack([all_feats[i] / all_weights[i] for i in ids])
        return ids, features.astype(np.float32)
    return compute_object_features_2d(
        image_embeddings, segmentation, resize_embedding_shape=resize_embedding_shape)


def _compute_object_features_tiled(image_embeddings, segmentation):
    features = image_embeddings["features"]
    shape = tuple(image_embeddings["shape"])[-2:]
    tile_shape = tuple(image_embeddings["tile_shape"])
    halo = tuple(image_embeddings["halo"])
    tiling = Blocking([0, 0], shape, tile_shape)

    acc_feats, acc_weights = {}, {}
    keys = features.keys() if isinstance(features, dict) else list(features.keys())
    for tile_id in keys:
        entry = features[tile_id] if isinstance(features, dict) else None
        if entry is None:
            ds = features[str(tile_id)]
            entry = {"features": ds[...], "input_size": tuple(ds.attrs["input_size"]),
                     "original_size": tuple(ds.attrs["original_size"])}
        tile = tiling.get_block_with_halo(int(tile_id), list(halo)).outer_block
        tile_seg = segmentation[tile.slicing]
        ids, f = compute_object_features_2d(entry, tile_seg)
        for oid, fv in zip(ids, f):
            w = fv[-1]
            if oid in acc_feats:
                acc_feats[oid] += fv * w
                acc_weights[oid] += w
            else:
                acc_feats[oid] = fv * w
                acc_weights[oid] = w
    ids = np.array(sorted(acc_feats.keys()))
    feats = np.stack([acc_feats[i] / acc_weights[i] for i in ids])
    return ids, feats.astype(np.float32)


def project_prediction_to_segmentation(
    segmentation: np.ndarray, object_prediction: np.ndarray, seg_ids: np.ndarray
) -> np.ndarray:
    """Map per-object class predictions back onto the label image
    (reference object_classification.py:224)."""
    lut = np.zeros(int(segmentation.max()) + 1, dtype=object_prediction.dtype)
    lut[np.asarray(seg_ids, dtype=int)] = object_prediction
    return lut[segmentation]


def train_classifier(features: np.ndarray, labels: np.ndarray,
                     n_estimators: int = 200, max_depth: int = 10):
    """Train the object RF classifier (reference object_classifier.py:49)."""
    from sklearn.ensemble import RandomForestClassifier
    rf = RandomForestClassifier(n_estimators=n_estimators, max_depth=max_depth)
    rf.fit(features, labels)
    return rf


def run_prediction_with_classifier(rf, features: np.ndarray) -> np.ndarray:
    return rf.predict(features)


def run_prediction_with_object_classifier(
    images, segmentations, predictor, rf_path, image_key=None,
    segmentation_key=None, project_prediction: bool = True, ndim=None,
):
    """Predict with a pretrained object classifier over an image series
    (reference object_classification.py:224).

    Returns per-image predictions: projected label images when
    ``project_prediction`` else raw per-object class vectors.
    """
    import pickle

    if len(images) != len(segmentations):
        raise ValueError("images and segmentations must pair up")
    try:
        from joblib import load as _load_rf
        rf = _load_rf(rf_path)
    except Exception:
        with open(rf_path, "rb") as f:
            rf = pickle.load(f)

    def _load_arr(source, key):
        if isinstance(source, np.ndarray):
            return source
        path = str(source)
        if key is not None:
            import h5py
            with h5py.File(path, "r") as f:
                return f[key][:]
        return util.load_image_data(path)

    predictions = []
    for image, segmentation in zip(images, segmentations):
        image = _load_arr(image, image_key)
        segmentation = _load_arr(segmentation, segmentation_key)
        embeddings = util.precompute_image_embeddings(
            predictor, image, verbose=False, ndim=ndim)
        seg_ids, features = compute_object_features(
            embeddings, segmentation, verbose=False)
        prediction = rf.predict(features)
        if project_prediction:
            prediction = project_prediction_to_segmentation(
                segmentation, prediction, seg_ids)
        predictions.append(prediction)
    return predictions
