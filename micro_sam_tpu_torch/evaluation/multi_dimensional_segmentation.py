"""3d segmentation evaluation: each object segmented from a prompt in its
middle slice and projected through the volume, then scored; and the grid
search over the projection's parameters.

Counterpart of the JAX package's ``evaluation/multi_dimensional_segmentation.py``
(upstream micro_sam/evaluation/multi_dimensional_segmentation.py). The grid
search's CSV is written with the standard library's ``csv`` in pandas'
layout; a stored segmentation (``save_path``, ``store_segmentation``) needs
``imageio``.
"""
from __future__ import annotations

import os
from itertools import product
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import util
from ..multi_dimensional_segmentation import PROJECTION_MODES, segment_mask_in_volume
from ..prompt_based_segmentation import segment_from_box, segment_from_points
from .instance_segmentation import write_csv
from .matching import matching


def default_grid_search_values_multi_dimensional_segmentation(
    iou_threshold_values: Optional[List[float]] = None,
    projection_method_values: Optional[List] = None,
    box_extension_values: Optional[List[float]] = None,
) -> Dict[str, List]:
    """The default grid: IoU stop 0.5-1.0, every projection mode, box extension 0-0.25."""
    if iou_threshold_values is None:
        iou_threshold_values = [x / 100 for x in range(50, 101, 10)]
    if projection_method_values is None:
        projection_method_values = list(PROJECTION_MODES)
    if box_extension_values is None:
        box_extension_values = [x / 100 for x in range(0, 26, 5)]
    return {"iou_threshold": iou_threshold_values, "projection": projection_method_values,
            "box_extension": box_extension_values}


def segment_slices_from_ground_truth(
    volume: np.ndarray,
    ground_truth: np.ndarray,
    model_type: str = "vit_b",
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    embedding_path: Optional[Union[str, os.PathLike]] = None,
    save_path: Optional[Union[str, os.PathLike]] = None,
    iou_threshold: float = 0.8,
    projection: Union[str, dict] = "mask",
    box_extension: Union[float, int] = 0.025,
    device=None,
    interactive_seg_mode: str = "box",
    verbose: bool = False,
    return_segmentation: bool = False,
    min_size: int = 0,
    evaluation_metric: str = "sa",
    predictor=None,
) -> Union[Dict, Tuple[Dict, np.ndarray]]:
    """Segment every object of ``ground_truth`` from a box (or a point) in
    its middle slice, project it through the volume with
    ``segment_mask_in_volume``, and score the result ("sa": ``matching``;
    else "dice"). A segmentation stored at ``save_path`` is scored without
    segmenting again."""
    if predictor is None:
        predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                       device=device)
    if save_path is not None and os.path.exists(save_path):
        import imageio.v3 as imageio
        return _evaluate_volume_segmentation(imageio.imread(save_path), ground_truth,
                                             evaluation_metric, return_segmentation)

    embeddings = util.precompute_image_embeddings(predictor, volume, save_path=embedding_path,
                                                  ndim=3, verbose=verbose)
    gt_ids = np.unique(ground_truth)[1:]
    final_segmentation = np.zeros_like(ground_truth, dtype="uint32")
    for gt_id in gt_ids:
        this_gt = ground_truth == gt_id
        slice_range = np.nonzero(this_gt.any(axis=(1, 2)))[0]
        if len(slice_range) == 0 or this_gt.sum() < min_size:
            continue
        z_mid = int(slice_range[len(slice_range) // 2])
        ys, xs = np.nonzero(this_gt[z_mid])
        if interactive_seg_mode == "points":
            seg_slice = segment_from_points(predictor, np.array([[ys.mean(), xs.mean()]]),
                                            np.array([1]), image_embeddings=embeddings, i=z_mid)
        else:
            box = np.array([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
            seg_slice = segment_from_box(predictor, box, image_embeddings=embeddings, i=z_mid)
        seg = np.zeros(volume.shape, dtype="uint8")
        seg[z_mid] = seg_slice[0]
        seg, _ = segment_mask_in_volume(seg, predictor, embeddings, np.array([z_mid]),
                                        stop_lower=False, stop_upper=False,
                                        iou_threshold=iou_threshold, projection=projection,
                                        box_extension=box_extension, verbose=verbose)
        final_segmentation[seg > 0] = int(gt_id)

    if save_path is not None:
        import imageio.v3 as imageio
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        imageio.imwrite(save_path, final_segmentation)
    return _evaluate_volume_segmentation(final_segmentation, ground_truth, evaluation_metric,
                                         return_segmentation)


def _evaluate_volume_segmentation(final_segmentation, ground_truth, evaluation_metric,
                                  return_segmentation):
    if evaluation_metric == "sa":
        result = matching(final_segmentation, ground_truth)
        scores = {"sa": result["segmentation_accuracy"], **result}
    else:
        inter = np.logical_and(final_segmentation > 0, ground_truth > 0).sum()
        denom = (final_segmentation > 0).sum() + (ground_truth > 0).sum()
        scores = {"dice": 2 * inter / max(denom, 1)}
    if return_segmentation:
        return scores, final_segmentation
    return scores


def run_multi_dimensional_segmentation_grid_search(
    volume: np.ndarray,
    ground_truth: np.ndarray,
    model_type: str,
    checkpoint_path: Optional[Union[str, os.PathLike]],
    embedding_path: Optional[Union[str, os.PathLike]],
    result_dir: Union[str, os.PathLike],
    interactive_seg_mode: str = "box",
    verbose: bool = False,
    grid_search_values: Optional[Dict[str, List]] = None,
    min_size: int = 0,
    evaluation_metric: str = "sa",
    store_segmentation: bool = False,
    device=None,
) -> str:
    """The grid search over (iou_threshold, projection, box_extension): one
    row per combination in ``<result_dir>/grid_search_results.csv``, which is
    returned (and, where it exists, returned at once)."""
    if grid_search_values is None:
        grid_search_values = default_grid_search_values_multi_dimensional_segmentation()
    os.makedirs(result_dir, exist_ok=True)
    result_path = os.path.join(result_dir, "grid_search_results.csv")
    if os.path.exists(result_path):
        return result_path
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                   device=device)
    rows = []
    for combo in product(*grid_search_values.values()):
        kwargs = dict(zip(grid_search_values.keys(), combo))
        result = segment_slices_from_ground_truth(
            volume, ground_truth, model_type=model_type, embedding_path=embedding_path,
            interactive_seg_mode=interactive_seg_mode, verbose=verbose, min_size=min_size,
            evaluation_metric=evaluation_metric, predictor=predictor,
            return_segmentation=store_segmentation, **kwargs)
        if store_segmentation:
            scores, seg = result
            import imageio.v3 as imageio
            combo_name = "-".join(f"{k}_{v}" for k, v in kwargs.items())
            imageio.imwrite(os.path.join(result_dir, f"segmentation-{combo_name}.tif"),
                            np.asarray(seg).astype("uint32"))
        else:
            scores = result
        row = dict(kwargs)
        row.update({k: v for k, v in scores.items() if np.isscalar(v)})
        rows.append(row)
    write_csv(result_path, rows)
    return result_path
