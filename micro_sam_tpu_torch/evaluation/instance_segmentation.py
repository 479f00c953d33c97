"""Grid search for the parameters of automatic instance segmentation.

Counterpart of the JAX package's ``evaluation/instance_segmentation.py``
(upstream micro_sam/evaluation/instance_segmentation.py): the cartesian
product of the parameters per image (``initialize`` once, ``generate`` per
combination), one CSV per image, the best parameters by the group mean over
the images, then the test images with them.

The CSVs are written and read with the standard library's ``csv``, in the
columns, order and number format pandas gives the JAX package's files, so
the grid search needs no pandas; the TIFF predictions need ``imageio``.
"""
from __future__ import annotations

import csv
import math
import os
from glob import glob
from itertools import product
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import util
from .matching import mean_segmentation_accuracy


def _write_tif(path, data):
    import imageio.v3 as imageio
    try:
        imageio.imwrite(path, data, compression="zlib")
    except TypeError:
        imageio.imwrite(path, data)


def write_csv(path: str, rows: Sequence[Dict[str, Any]], index: bool = False) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=index)`` without pandas: the
    columns in the order they first appear, a missing value empty, and with
    ``index`` an unnamed first column of row numbers."""
    columns: List[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(([""] if index else []) + columns)
        for i, row in enumerate(rows):
            writer.writerow(([i] if index else []) + [_csv_value(row.get(c)) for c in columns])


def _csv_value(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, (np.floating, float)) and not isinstance(v, bool):
        return repr(float(v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _parse(text: str):
    """A CSV field as pandas reads it back: int, float, bool or the string."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"True": True, "False": False}.get(text, text)


def read_csv(path: str) -> List[Dict[str, Any]]:
    """The rows of a CSV this module wrote (or pandas did), their fields parsed."""
    with open(path, newline="") as f:
        return [{k: _parse(v) for k, v in row.items()} for row in csv.DictReader(f)]


def default_grid_search_values_amg(
    iou_thresh_values: Optional[List[float]] = None,
    stability_score_values: Optional[List[float]] = None,
) -> Dict[str, List[float]]:
    """The default grid of AMG: the IoU and stability thresholds, 0.6-0.9."""
    if iou_thresh_values is None:
        iou_thresh_values = np.arange(0.6, 0.925, 0.025).round(3).tolist()
    if stability_score_values is None:
        stability_score_values = np.arange(0.6, 0.925, 0.025).round(3).tolist()
    return {"pred_iou_thresh": iou_thresh_values,
            "stability_score_thresh": stability_score_values}


def default_grid_search_values_instance_segmentation_with_decoder(
    center_distance_threshold_values: Optional[List[float]] = None,
    boundary_distance_threshold_values: Optional[List[float]] = None,
    distance_smoothing_values: Optional[List[float]] = None,
    min_size_values: Optional[List[float]] = None,
) -> Dict[str, List[float]]:
    """The default grid of AIS: the distance thresholds and the smoothing."""
    if center_distance_threshold_values is None:
        center_distance_threshold_values = np.arange(0.3, 0.8, 0.1).round(2).tolist()
    if boundary_distance_threshold_values is None:
        boundary_distance_threshold_values = np.arange(0.3, 0.8, 0.1).round(2).tolist()
    if distance_smoothing_values is None:
        distance_smoothing_values = [1.0, 1.6, 2.2]
    grid = {"center_distance_threshold": center_distance_threshold_values,
            "boundary_distance_threshold": boundary_distance_threshold_values,
            "distance_smoothing": distance_smoothing_values}
    if min_size_values is not None:
        grid["min_size"] = min_size_values
    return grid


def default_grid_search_values_apg(
    min_distance_values: Optional[List[float]] = None,
    threshold_abs_values: Optional[List[float]] = None,
    multimasking_values: Optional[List[float]] = None,
    prompt_selection_values: Optional[List[float]] = None,
    min_size_values: Optional[List[float]] = None,
    nms_threshold_values: Optional[List[float]] = None,
    intersection_over_min_values: Optional[List[bool]] = None,
    mask_threshold_values: Optional[List] = None,
    center_distance_threshold_values: Optional[List[float]] = None,
    boundary_distance_threshold_values: Optional[List[float]] = None,
) -> Dict[str, List[float]]:
    """The default grid of APG. As upstream, the distance-based parameters
    (min_distance, threshold_abs, multimasking, prompt_selection) are
    accepted but left out: prompting from connected components ignores them."""
    if center_distance_threshold_values is None:
        center_distance_threshold_values = np.arange(0.3, 0.8, 0.1).round(2).tolist()
    if boundary_distance_threshold_values is None:
        boundary_distance_threshold_values = np.arange(0.3, 0.8, 0.1).round(2).tolist()
    if min_size_values is None:
        min_size_values = [50, 100, 200]
    if nms_threshold_values is None:
        nms_threshold_values = np.arange(0.5, 1.0, 0.1).round(2).tolist()
    if intersection_over_min_values is None:
        intersection_over_min_values = [True, False]
    grid = {"center_distance_threshold": center_distance_threshold_values,
            "boundary_distance_threshold": boundary_distance_threshold_values,
            "min_size": min_size_values,
            "nms_threshold": nms_threshold_values,
            "intersection_over_min": intersection_over_min_values}
    if mask_threshold_values is not None:
        grid["mask_threshold"] = mask_threshold_values
    return grid


def _load(path):
    return path if isinstance(path, np.ndarray) else util.load_image_data(str(path))


def _name_of(path, fallback):
    return Path(str(path)).stem if not isinstance(path, np.ndarray) else fallback


def grid_search_rows(segmenter, grid_search_values: Dict[str, List], image: np.ndarray,
                     gt: np.ndarray, embedding_path: Optional[str] = None,
                     fixed_generate_kwargs: Optional[Dict[str, Any]] = None,
                     tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
                     verbose_gs: bool = False, name: str = "") -> List[Dict[str, Any]]:
    """One image's grid search: ``initialize`` once, then per combination of
    the grid ``generate`` and its mSA / SA50 / SA75 against ``gt``; one row
    per combination, in the grid's product order."""
    fixed_generate_kwargs = fixed_generate_kwargs or {}
    tiling_window_params = tiling_window_params or {}
    emb = util.precompute_image_embeddings(segmenter._predictor, image, embedding_path,
                                           verbose=False, **tiling_window_params)
    segmenter.initialize(image, image_embeddings=emb, verbose=False, **tiling_window_params)
    rows = []
    for vals in product(*grid_search_values.values()):
        gs_kwargs = dict(zip(grid_search_values.keys(), vals))
        seg = segmenter.generate(**gs_kwargs, **fixed_generate_kwargs)
        if isinstance(seg, list):
            seg = np.zeros(gt.shape, dtype="uint32")
        msa, scores = mean_segmentation_accuracy(seg, gt, return_accuracies=True)
        row = dict(gs_kwargs)
        row.update({"mSA": msa, "SA50": scores[0], "SA75": scores[5]})
        rows.append(row)
        if verbose_gs:
            print(name, gs_kwargs, "->", msa)
    return rows


def run_instance_segmentation_grid_search(
    segmenter,
    grid_search_values: Dict[str, List],
    image_paths: List,
    gt_paths: List,
    result_dir: Union[str, os.PathLike],
    embedding_dir: Optional[Union[str, os.PathLike]],
    fixed_generate_kwargs: Optional[Dict[str, Any]] = None,
    verbose_gs: bool = False,
    image_key: Optional[str] = None,
    gt_key: Optional[str] = None,
    rois: Optional[Tuple] = None,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
) -> None:
    """The grid search over images (paths or arrays), one CSV per image in
    ``result_dir``; an image whose CSV exists is skipped. ``rois`` restricts
    each image / truth pair to a region; ``tiling_window_params`` (tile_shape
    and halo) takes the tiled path."""
    assert len(image_paths) == len(gt_paths)
    os.makedirs(result_dir, exist_ok=True)
    for idx, (image_path, gt_path) in enumerate(zip(image_paths, gt_paths)):
        name = _name_of(image_path, f"image-{idx}")
        result_path = os.path.join(result_dir, f"{name}.csv")
        if os.path.exists(result_path):
            continue
        image, gt = _load(image_path), _load(gt_path)
        if rois is not None:
            image, gt = image[rois[idx]], gt[rois[idx]]
        embedding_path = None if embedding_dir is None else \
            os.path.join(embedding_dir, f"{name}.zarr")
        rows = grid_search_rows(segmenter, grid_search_values, image, gt, embedding_path,
                                fixed_generate_kwargs, tiling_window_params, verbose_gs, name)
        write_csv(result_path, rows)


def evaluate_instance_segmentation_grid_search(
    result_dir: Union[str, os.PathLike],
    grid_search_parameters: List[str],
    criterion: str = "mSA",
) -> Tuple[Dict[str, Any], float]:
    """The best parameters over the images: the mean of ``criterion`` per
    combination over the CSVs, the first maximum in ascending order of the
    combinations (pandas' groupby and idxmax, as the JAX package picks)."""
    csvs = sorted(glob(os.path.join(str(result_dir), "*.csv")))
    assert csvs, f"No grid-search results in {result_dir}"
    groups: Dict[tuple, List[float]] = {}
    for path in csvs:
        for row in read_csv(path):
            groups.setdefault(tuple(row[p] for p in grid_search_parameters),
                              []).append(row[criterion])
    means = {k: math.fsum(v) / len(v) for k, v in groups.items()}
    best_key = max(sorted(means), key=lambda k: means[k])
    best_score = means[best_key]
    # a row of only numbers comes out of pandas as float64: its ints as floats
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in best_key):
        best_key = tuple(float(v) for v in best_key)
    return dict(zip(grid_search_parameters, best_key)), float(best_score)


def save_grid_search_best_params(best_kwargs: Dict[str, Any], best_msa: float,
                                 grid_search_result_dir=None) -> str:
    """The best parameters and their score as a one-row CSV under
    ``<grid_search_result_dir>/results/`` (pandas' layout, with its index)."""
    row = {"best_msa": best_msa, **best_kwargs}
    is_amg = "pred_iou_thresh" in best_kwargs or "stability_score_thresh" in best_kwargs
    fname = ("grid_search_params_amg.csv" if is_amg
             else "grid_search_params_instance_segmentation_with_decoder.csv")
    if grid_search_result_dir is not None:
        os.makedirs(os.path.join(str(grid_search_result_dir), "results"), exist_ok=True)
        path = os.path.join(str(grid_search_result_dir), "results", fname)
    else:
        path = fname
    write_csv(path, [row], index=True)
    return path


def run_instance_segmentation_inference(
    segmenter,
    image_paths: List,
    prediction_dir: Union[str, os.PathLike],
    embedding_dir: Optional[Union[str, os.PathLike]],
    generate_kwargs: Optional[Dict[str, Any]] = None,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
) -> None:
    """Segment every image with fixed ``generate`` parameters and write
    ``<prediction_dir>/<name>.tif``."""
    generate_kwargs = generate_kwargs or {}
    tiling_window_params = tiling_window_params or {}
    os.makedirs(prediction_dir, exist_ok=True)
    predictor = segmenter._predictor
    for idx, image_path in enumerate(image_paths):
        name = _name_of(image_path, f"image-{idx}")
        prediction_path = os.path.join(prediction_dir, f"{name}.tif")
        if os.path.exists(prediction_path):
            continue
        image = _load(image_path)
        embedding_path = None if embedding_dir is None else \
            os.path.join(embedding_dir, f"{name}.zarr")
        emb = util.precompute_image_embeddings(predictor, image, embedding_path, verbose=False,
                                               **tiling_window_params)
        segmenter.initialize(image, image_embeddings=emb, verbose=False, **tiling_window_params)
        seg = segmenter.generate(**generate_kwargs)
        if isinstance(seg, list):
            seg = np.zeros(image.shape[:2], dtype="uint32")
        _write_tif(prediction_path, seg.astype(np.uint32))


def run_instance_segmentation_grid_search_and_inference(
    segmenter,
    grid_search_values: Dict[str, List],
    val_image_paths: List,
    val_gt_paths: List,
    test_image_paths: List,
    embedding_dir: Optional[Union[str, os.PathLike]],
    prediction_dir: Union[str, os.PathLike],
    result_dir: Union[str, os.PathLike],
    fixed_generate_kwargs: Optional[Dict[str, Any]] = None,
    verbose_gs: bool = True,
    experiment_folder: Optional[Union[str, os.PathLike]] = None,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
) -> str:
    """The grid search on the validation images, then the test images with
    the best parameters. The best-parameter CSV goes under
    ``experiment_folder`` (default: the parent of the grid-search layout)."""
    run_instance_segmentation_grid_search(
        segmenter, grid_search_values, val_image_paths, val_gt_paths, result_dir=result_dir,
        embedding_dir=embedding_dir, fixed_generate_kwargs=fixed_generate_kwargs,
        verbose_gs=verbose_gs, tiling_window_params=tiling_window_params)
    best_kwargs, best_score = evaluate_instance_segmentation_grid_search(
        result_dir, list(grid_search_values.keys()))
    if verbose_gs:
        print("Best grid-search result:", best_score, "with", best_kwargs)
    if experiment_folder is not None:
        gs_parent = str(experiment_folder)
    else:
        gs_parent = os.path.dirname(str(result_dir).rstrip(os.sep))
        if os.path.basename(str(result_dir).rstrip(os.sep)) == "grid_search":
            # the layout <experiment>/<mode>/grid_search -> <experiment>
            gs_parent = os.path.dirname(gs_parent)
    save_grid_search_best_params(best_kwargs, best_score, gs_parent or None)
    generate_kwargs = dict(fixed_generate_kwargs or {})
    generate_kwargs.update(best_kwargs)
    run_instance_segmentation_inference(segmenter, test_image_paths, prediction_dir,
                                        embedding_dir, generate_kwargs,
                                        tiling_window_params=tiling_window_params)
    return str(prediction_dir)
