"""Prompt-based segmentation: point / box / mask prompts -> binary masks.

Counterpart of ``micro_sam_tpu/prompt_based_segmentation.py``, with its four
entry points and signatures. Prompts derived from a mask (distance-transform
points, the inverse-sigmoid logit prompt, the extended box) are host numpy;
the decode is ``SamPredictor.predict`` on the predictor's device. Under tiled
embeddings a prompt goes to the tile whose inner block holds its centre: it is
shifted into that tile's halo frame, and the predicted mask pasted back into
the full frame.

The public functions take points as (y, x) and boxes as (y0, x0, y1, x1) in
image order; the predictor takes (x, y) and XYXY.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import util
from .ops.host_ops import (distance_transform_edt, find_boundaries_outer, gaussian_smooth,
                           peak_local_max)
from .predictor import SamPredictor
from .utils.blocking import Blocking
from .utils.transforms import ResizeLongestSide, get_preprocess_shape


# -----------------------------------------------------------------------------
# mask -> derived prompts
# -----------------------------------------------------------------------------

def _mask_bbox_yx(mask) -> np.ndarray:
    """Tight (y0, x0, y1, x1) bounds of the foreground, end-exclusive."""
    ys, xs = np.nonzero(mask == 1)
    return np.array([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])


def _process_box(box, shape, original_size=None, box_extension=0):
    """(y0, x0, y1, x1) -> the extended, clipped, rounded XYXY box.

    box_extension: 0 none, >= 1 pixels, < 1 a fraction of the box's side
    (per axis)."""
    box = np.asarray(box, dtype="float64")
    if box_extension == 0:
        ext = np.zeros(2)
    elif box_extension >= 1:
        ext = np.array([box_extension, box_extension], dtype="float64")
    else:
        ext = box_extension * (box[2:] - box[:2])

    lo = np.maximum(box[:2] - ext, 0)
    hi = np.minimum(box[2:] + ext, np.asarray(shape[:2], dtype="float64"))
    xyxy = np.array([lo[1], lo[0], hi[1], hi[0]])

    if original_size is not None:
        trafo = ResizeLongestSide(max(original_size))
        xyxy = trafo.apply_boxes(xyxy[None], (256, 256)).squeeze()
    return np.round(xyxy).astype(int)


def _compute_box_from_mask(mask, original_size=None, box_extension=0):
    return _process_box(_mask_bbox_yx(mask), mask.shape, original_size=original_size,
                        box_extension=box_extension)


def _compute_points_from_mask(mask, original_size, box_extension, use_single_point=False):
    """Point prompts from a mask: positives at the smoothed inner distance
    maxima, negatives at the maxima of the background ring."""
    y0, x0, y1, x1 = _mask_bbox_yx(mask)
    if box_extension:
        x0, y0, x1, y1 = _compute_box_from_mask(mask, box_extension=box_extension)
    crop = mask[y0:y1, x0:x1].astype(bool)
    offset = np.array([y0, x0])

    boundaries = find_boundaries_outer(crop)
    distances = gaussian_smooth(distance_transform_edt(boundaries == 0))

    inner = np.where(crop, distances, 0.0)
    if use_single_point:
        center = np.unravel_index(inner.argmax(), inner.shape)
        yx = (np.asarray(center) + offset)[None].astype("float64")
        return yx[:, ::-1], np.ones(1, dtype="uint8")

    outer = np.where(crop, 0.0, distances)
    pos = peak_local_max(inner, exclude_border=False, min_distance=3)
    neg = peak_local_max(outer, exclude_border=False, min_distance=5)
    if len(pos) == 0:  # a tiny mask: its centroid
        pos = np.column_stack(np.nonzero(crop)).mean(axis=0).round()[None].astype("int64")

    coords = np.concatenate([pos, neg] if len(neg) else [pos]).astype("float64")
    coords += offset
    if original_size is not None:
        coords *= (np.asarray(original_size, dtype="float64")
                   / np.asarray(mask.shape, dtype="float64"))[None]

    labels = np.concatenate([np.ones(len(pos), dtype="uint8"), np.zeros(len(neg), dtype="uint8")])
    return coords[:, ::-1], labels


def _compute_logits_from_mask(mask, eps=1e-3, expected_shape=(256, 256)):
    """Binary mask -> low-res logit prompt (inverse sigmoid), resized to the
    longest side of SAM's mask input (bilinear, half-pixel centres,
    antialiased when it shrinks) and zero-padded (zero: "unknown")."""
    p = np.where(mask == 1, 1.0 - eps, eps).astype("float32")
    logits = np.log(p / (1.0 - p))
    assert logits.ndim == 2

    if logits.shape != expected_shape:
        new_shape = get_preprocess_shape(logits.shape[0], logits.shape[1], expected_shape[0])
        down = new_shape[0] < logits.shape[0] or new_shape[1] < logits.shape[1]
        logits = F.interpolate(torch.from_numpy(logits)[None, None], new_shape, mode="bilinear",
                               align_corners=False, antialias=down)[0, 0].numpy()
        pad = (expected_shape[0] - logits.shape[0], expected_shape[1] - logits.shape[1])
        if pad != (0, 0):
            logits = np.pad(logits, ((0, pad[0]), (0, pad[1])))

    logits = logits[None]
    assert logits.shape == (1,) + expected_shape, f"{logits.shape}"
    return logits


# -----------------------------------------------------------------------------
# routing prompts to the tiles of tiled embeddings
# -----------------------------------------------------------------------------

def _tile_at(shape, tile_shape, halo, center_yx):
    """(tile_id, outer block) of the tile whose inner block holds center_yx."""
    tiling = Blocking([0, 0], shape, tile_shape)
    center = np.asarray(center_yx).round().astype("int").tolist()
    tile_id = tiling.coordinates_to_block_id(center)
    return tile_id, tiling.get_block_with_halo(tile_id, list(halo)).outer_block


def _points_to_tile(prompts, shape, tile_shape, halo):
    points, labels = (np.asarray(p) for p in prompts)
    tile_id, tile = _tile_at(shape, tile_shape, halo, points.mean(axis=0))

    shifted = points - np.asarray(tile.begin)
    inside = ((shifted >= 0) & (shifted < np.asarray(tile.shape))).all(axis=1)
    if not inside.all():
        warnings.warn(f"{(~inside).sum()} points were not in the tile and are dropped")
        shifted, labels = shifted[inside], labels[inside]
    return tile_id, tile, (shifted, labels)


def _box_to_tile(box, shape, tile_shape, halo):
    box = np.asarray(box)
    tile_id, tile = _tile_at(shape, tile_shape, halo, (box[:2] + box[2:]) / 2)
    begin = np.asarray(tile.begin)
    lo = np.maximum(box[:2] - begin, 0)
    hi = np.minimum(box[2:] - begin, np.asarray(tile.shape))
    return tile_id, tile, np.concatenate([lo, hi])


def _mask_to_tile(mask, shape, tile_shape, halo):
    center = [np.mean(c) for c in np.nonzero(mask)]
    tile_id, tile = _tile_at(shape, tile_shape, halo, center)
    return tile_id, tile, mask[tile.slicing]


def _initialize_predictor(predictor, image_embeddings, i, prompts, to_tile):
    """Install the embeddings on the predictor; under tiled embeddings route
    the prompts to their tile. Returns (predictor, tile or None, prompts, shape)."""
    if image_embeddings is None:
        return predictor, None, prompts, predictor.original_size

    if image_embeddings.get("input_size") is not None:  # untiled
        util.set_precomputed(predictor, image_embeddings, i)
        return predictor, None, prompts, image_embeddings["original_size"]

    shape = tuple(image_embeddings["shape"])
    if len(shape) == 3:
        shape = shape[1:]
    tile_id, tile, prompts = to_tile(prompts, shape, image_embeddings["tile_shape"],
                                     image_embeddings["halo"])
    util.set_precomputed(predictor, image_embeddings, i, tile_id=tile_id)
    return predictor, tile, prompts, shape


def _tile_to_full_mask(mask, shape, tile):
    full_mask = np.zeros(mask.shape[0:1] + tuple(shape), dtype=mask.dtype)
    full_mask[(slice(None),) + tile.slicing] = mask
    return full_mask


def _finalize(mask, scores, logits, tile, shape, return_all):
    if tile is not None:
        mask = _tile_to_full_mask(mask, shape, tile)
    return (mask, scores, logits) if return_all else mask


# -----------------------------------------------------------------------------
# the entry points
# -----------------------------------------------------------------------------

def segment_from_points(
    predictor: SamPredictor,
    points: np.ndarray,
    labels: np.ndarray,
    image_embeddings=None,
    i: Optional[int] = None,
    multimask_output: bool = False,
    return_all: bool = False,
    use_best_multimask: Optional[bool] = None,
):
    """Segmentation from point prompts in (y, x) image coordinates.

    Returns the binary mask (1, H, W); with ``return_all`` also the scores and
    the low-res logits. For a single positive point the best of the three
    multimask outputs is taken."""
    predictor, tile, (points, labels), shape = _initialize_predictor(
        predictor, image_embeddings, i, (np.asarray(points), np.asarray(labels)), _points_to_tile)

    if use_best_multimask is None:
        use_best_multimask = len(points) == 1 and labels[0] == 1

    mask, scores, logits = predictor.predict(
        point_coords=np.asarray(points)[:, ::-1], point_labels=np.asarray(labels),
        multimask_output=multimask_output or use_best_multimask)
    if use_best_multimask:
        mask = mask[np.argmax(scores)][None]
    return _finalize(mask, scores, logits, tile, shape, return_all)


def segment_from_mask(
    predictor: SamPredictor,
    mask: np.ndarray,
    image_embeddings=None,
    i: Optional[int] = None,
    use_box: bool = True,
    use_mask: bool = True,
    use_points: bool = False,
    original_size: Optional[Tuple[int, ...]] = None,
    multimask_output: bool = False,
    return_all: bool = False,
    return_logits: bool = False,
    box_extension: float = 0.0,
    box: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    use_single_point: bool = False,
):
    """Segmentation from a mask prompt, optionally turned into box, point and
    logit prompts. A box or points passed in take the place of the derived ones."""

    def _to_tile(prompts, shape, tile_shape, halo):
        mask, box, points, labels = prompts
        tile_id, tile, mask = _mask_to_tile(mask, shape, tile_shape, halo)
        if points is not None:
            pt_tile_id, tile, (points, labels) = _points_to_tile(
                (points, labels), shape, tile_shape, halo)
            if pt_tile_id != tile_id:
                raise RuntimeError(
                    f"Inconsistent tile ids for mask and point prompts: {pt_tile_id} != {tile_id}.")
        if box is not None:
            box_tile_id, tile, box = _box_to_tile(box, shape, tile_shape, halo)
            if box_tile_id != tile_id:
                raise RuntimeError(
                    f"Inconsistent tile ids for mask and box prompts: {box_tile_id} != {tile_id}.")
        return tile_id, tile, (mask, box, points, labels)

    predictor, tile, (mask, box, points, labels), shape = _initialize_predictor(
        predictor, image_embeddings, i, (mask, box, points, labels), _to_tile)

    if points is not None:
        if labels is None:
            raise ValueError("If points are passed you also need to pass labels.")
        point_coords, point_labels = points, labels
    elif use_points and mask.sum() != 0:
        point_coords, point_labels = _compute_points_from_mask(
            mask, original_size=original_size, box_extension=box_extension,
            use_single_point=use_single_point)
    else:
        point_coords = point_labels = None

    if box is not None:
        box = _process_box(box, mask.shape, original_size=original_size,
                           box_extension=box_extension)
    elif use_box and mask.sum() != 0:
        box = _compute_box_from_mask(mask, original_size=original_size,
                                     box_extension=box_extension)

    logits = None
    if use_mask:
        logits = _compute_logits_from_mask(
            mask, expected_shape=(predictor.model.config.embedding_size * 4,) * 2)

    mask, scores, logits = predictor.predict(
        point_coords=point_coords, point_labels=point_labels, mask_input=logits, box=box,
        multimask_output=multimask_output, return_logits=return_logits)
    return _finalize(mask, scores, logits, tile, shape, return_all)


def segment_from_box(
    predictor: SamPredictor,
    box: np.ndarray,
    image_embeddings=None,
    i: Optional[int] = None,
    multimask_output: bool = False,
    return_all: bool = False,
    box_extension: float = 0.0,
):
    """Segmentation from a (y0, x0, y1, x1) box prompt."""
    predictor, tile, box, shape = _initialize_predictor(
        predictor, image_embeddings, i, np.asarray(box), _box_to_tile)
    mask, scores, logits = predictor.predict(
        box=_process_box(box, shape, box_extension=box_extension),
        multimask_output=multimask_output)
    return _finalize(mask, scores, logits, tile, shape, return_all)


def segment_from_box_and_points(
    predictor: SamPredictor,
    box: np.ndarray,
    points: np.ndarray,
    labels: np.ndarray,
    image_embeddings=None,
    i: Optional[int] = None,
    multimask_output: bool = False,
    return_all: bool = False,
):
    """Segmentation from a (y0, x0, y1, x1) box and (y, x) point prompts."""

    def _to_tile(prompts, shape, tile_shape, halo):
        box, points, labels = prompts
        tile_id, tile, (points, labels) = _points_to_tile(
            (points, labels), shape, tile_shape, halo)
        box_tile_id, tile, box = _box_to_tile(box, shape, tile_shape, halo)
        if box_tile_id != tile_id:
            raise RuntimeError(
                f"Inconsistent tile ids for box and point annotations: {box_tile_id} != {tile_id}.")
        return tile_id, tile, (box, points, labels)

    predictor, tile, (box, points, labels), shape = _initialize_predictor(
        predictor, image_embeddings, i,
        (np.asarray(box), np.asarray(points), np.asarray(labels)), _to_tile)

    mask, scores, logits = predictor.predict(
        point_coords=np.asarray(points)[:, ::-1], point_labels=np.asarray(labels),
        box=_process_box(box, shape), multimask_output=multimask_output)
    return _finalize(mask, scores, logits, tile, shape, return_all)
