"""Prompt generators for training and evaluation (numpy / scipy, on the host).

Counterpart of ``micro_sam_tpu/prompt_generators.py`` (upstream
micro_sam/prompt_generators.py semantics; the kornia dilation upstream uses is
a scipy binary dilation): the same random draws in the same order, so one
``RandomState`` seed gives the same prompts in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage


def _sample_from_mask(rng, mask, size=1, replace=None):
    """``size`` (y, x) coordinates drawn uniformly from the True pixels of
    ``mask``; None when the mask is empty."""
    flat = np.flatnonzero(mask)
    if flat.size == 0:
        return None
    if replace is None:
        replace = size > flat.size
    picks = rng.choice(flat.size, size=size, replace=replace)
    coords = np.unravel_index(flat[picks], mask.shape)
    return np.stack(coords, axis=-1).astype(np.int64)


class PromptGeneratorBase:
    """The interface of a prompt generator."""

    def __call__(self, segmentation, prediction=None, bbox_coordinates=None,
                 center_coordinates=None):
        raise NotImplementedError(
            "PromptGeneratorBase is just a class template. "
            "Use a child class that implements the specific generator instead"
        )


class PointAndBoxPromptGenerator(PromptGeneratorBase):
    """Point and / or box prompts from an instance segmentation.

    Args:
        n_positive_points: Positive point prompts per mask.
        n_negative_points: Negative point prompts per mask.
        dilation_strength: Dilation of the mask before sampling negatives.
        get_point_prompts: Whether to generate point prompts.
        get_box_prompts: Whether to generate box prompts.
        rng: The random stream (default: numpy's global one).
    """

    def __init__(self, n_positive_points: int, n_negative_points: int, dilation_strength: int,
                 get_point_prompts: bool = True, get_box_prompts: bool = False,
                 rng: Optional[np.random.RandomState] = None) -> None:
        self.n_positive_points = n_positive_points
        self.n_negative_points = n_negative_points
        self.dilation_strength = dilation_strength
        self.get_box_prompts = get_box_prompts
        self.get_point_prompts = get_point_prompts
        self._rng = rng or np.random
        if not self.get_point_prompts and not self.get_box_prompts:
            raise ValueError("You need to request box prompts, point prompts or both.")

    def _positives(self, mask, center):
        """n_positive_points inside the object; the given center (if any) first."""
        out = [] if center is None else [tuple(int(v) for v in center)]
        remaining = self.n_positive_points - len(out)
        if remaining > 0:
            sampled = _sample_from_mask(self._rng, mask, size=remaining)
            if sampled is not None:
                out.extend(tuple(pt) for pt in sampled)
        return out

    def _ring_region(self, mask, bbox):
        """Background inside the dilation-extended bbox, outside the dilated object."""
        grown = ndimage.binary_dilation(mask, structure=np.ones((3, 3)),
                                        iterations=self.dilation_strength)
        d = self.dilation_strength
        h, w = mask.shape[-2:]
        window = np.zeros_like(grown)
        window[max(bbox[0] - d, 0):min(bbox[2] + d, h), max(bbox[1] - d, 0):min(bbox[3] + d, w)] = True
        return window & ~grown

    def _negatives(self, mask, bbox):
        if self.n_negative_points == 0:
            return []
        ring = self._ring_region(mask, bbox)
        n_avail = int(ring.sum())
        if n_avail == 0:
            return []
        sampled = _sample_from_mask(self._rng, ring, size=min(self.n_negative_points, n_avail),
                                    replace=False)
        return [tuple(pt) for pt in sampled]

    def _prompts_for_object(self, mask, bbox, center):
        coords = self._positives(mask, center)
        labels = [1] * len(coords)
        coords += self._negatives(mask, bbox)
        labels += [0] * (len(coords) - len(labels))
        want = self.n_positive_points + self.n_negative_points
        if len(coords) < want:  # top up with plain background points
            extra = _sample_from_mask(self._rng, mask == 0, size=want - len(coords), replace=False)
            coords += [tuple(pt) for pt in extra]
            labels += [0] * len(extra)
        if len(coords) != want:
            raise RuntimeError(f"sampled {len(coords)} prompts, wanted {want}")
        return coords, labels

    def __call__(self, segmentation: np.ndarray, bbox_coordinates: List[Tuple],
                 center_coordinates: Optional[List[np.ndarray]] = None):
        """segmentation (NUM_OBJECTS, 1, H, W) -> (point_coords (N, P, 2) xy,
        point_labels (N, P), boxes (N, 4) xyxy, None)."""
        segmentation = np.asarray(segmentation)
        points = labels = None
        if self.get_point_prompts:
            centers = [None] * len(segmentation) if center_coordinates is None \
                else center_coordinates
            per_object = [self._prompts_for_object(obj[0], bbox, center)
                          for obj, bbox, center in zip(segmentation, bbox_coordinates, centers)]
            points = np.array([c for c, _ in per_object])[:, :, ::-1].copy()  # (y, x) -> (x, y)
            labels = np.array([lb for _, lb in per_object])
        boxes = None
        if self.get_box_prompts:
            boxes = np.array(bbox_coordinates)[:, [1, 0, 3, 2]]  # yxyx -> xyxy
        return points, labels, boxes, None


class IterativePromptGenerator(PromptGeneratorBase):
    """Corrective point prompts from where a prediction and the truth differ:
    per object one positive point in the false-negative region and one
    negative point in the false-positive region, with fallbacks for empty
    regions; 2d and 3d. The draws are the JAX package's, in its order.

    Args:
        rng: The random stream (default: numpy's global one).
    """

    def __init__(self, rng: Optional[np.random.RandomState] = None):
        self._rng = rng or np.random

    def _pick_one(self, *candidate_regions):
        """One (y, x[, z]) point from the first non-empty region; the origin
        as the last resort."""
        for region in candidate_regions:
            pt = _sample_from_mask(self._rng, region, size=1)
            if pt is not None:
                return pt[0]
        return np.zeros(candidate_regions[0].ndim, dtype=np.int64)

    @staticmethod
    def _bbox_ring(true_obj, margin=3):
        """Background inside the object's bbox grown by ``margin`` (the
        negative fallback when there is no false-positive region)."""
        if not true_obj.any():
            return ~true_obj
        obj_slices = ndimage.find_objects(true_obj.astype(np.uint8))[0]
        h, w = true_obj.shape[-2:]
        window = np.zeros_like(true_obj)
        window[...,
               max(obj_slices[-2].start - margin, 0):min(obj_slices[-2].stop + margin, h),
               max(obj_slices[-1].start - margin, 0):min(obj_slices[-1].stop + margin, w)] = True
        return window & ~true_obj

    def __call__(self, segmentation: np.ndarray, prediction: np.ndarray, **kwargs):
        """segmentation / prediction (NUM_OBJECTS, 1, [Z,] H, W), float or
        bool -> (coords (N, 2, 2 | 3) xy[z], labels (N, 2), None, None)."""
        segmentation = np.asarray(segmentation) > 0.5
        prediction = np.asarray(prediction) > 0.5
        if segmentation.shape != prediction.shape:
            raise ValueError("The segmentation and prediction tensors should have the same shape.")
        if segmentation.ndim not in (4, 5):
            raise ValueError("The segmentation and prediction tensors should have either '4' or "
                             "'5' dimensions.")
        coords, labels = [], []
        for gt, pred in zip(segmentation, prediction):
            pos = self._pick_one(gt & ~pred, gt & pred)        # missed: a positive point
            neg = self._pick_one(pred & ~gt, self._bbox_ring(gt), ~gt)  # spurious: negative
            coords.append([pos[:0:-1], neg[:0:-1]])  # (c, [z,] y, x) -> (x, y[, z])
            labels.append([1, 0])
        return np.asarray(coords, dtype=np.int64), np.asarray(labels), None, None
