"""Inference harnesses for evaluation.

Counterpart of the JAX package's ``evaluation/inference.py`` (upstream
micro_sam/evaluation/inference.py): prompts derived from the truth (batched
over all objects of an image), iterative prompting (start from a point or a
box, add corrective points each round, optionally feed the mask logits back),
and the AMG / AIS / APG runners with their grid search.

Each file-level harness stands on a function that returns arrays
(``segmentation_from_prompts``, ``iterative_prompting_segmentations``); the
TIFF writer on top imports ``imageio`` at the call. An input given as an
array instead of a path is named ``image-<index>`` (its position in the
list), so its embeddings and predictions get a file of their own.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import native, util
from ..inference import batched_inference
from ..instance_segmentation import (AutomaticMaskGenerator, AutomaticPromptGenerator,
                                     InstanceSegmentationWithDecoder, get_predictor_and_decoder)
from ..prompt_generators import IterativePromptGenerator, PointAndBoxPromptGenerator
from . import instance_segmentation as grid_search_mod


def _write_tif(path, data):
    import imageio.v3 as imageio
    try:
        imageio.imwrite(path, data, compression="zlib")
    except TypeError:
        imageio.imwrite(path, data)


def _load(path):
    return path if isinstance(path, np.ndarray) else util.load_image_data(str(path))


def _name_of(path, idx: int) -> str:
    return f"image-{idx}" if isinstance(path, np.ndarray) else Path(str(path)).stem


def _embedding_path(embedding_dir, name):
    return None if embedding_dir is None else os.path.join(embedding_dir, f"{name}.zarr")


def precompute_all_embeddings(predictor, image_paths, embedding_dir, ndim: int = 2,
                              **kwargs) -> None:
    """Precompute the embeddings of every image into ``<embedding_dir>/<name>.zarr``."""
    os.makedirs(embedding_dir, exist_ok=True)
    for idx, path in enumerate(image_paths):
        util.precompute_image_embeddings(predictor, _load(path),
                                         _embedding_path(embedding_dir, _name_of(path, idx)),
                                         ndim=ndim, verbose=False, **kwargs)


def _get_batched_prompts(gt, gt_ids, use_points, use_boxes, n_positives, n_negatives,
                         dilation, rng=None):
    prompt_generator = PointAndBoxPromptGenerator(
        n_positive_points=n_positives if use_points else 0,
        n_negative_points=n_negatives if use_points else 0,
        dilation_strength=dilation, get_point_prompts=use_points, get_box_prompts=use_boxes,
        rng=rng)
    center_coordinates, bbox_coordinates = util.get_centers_and_bounding_boxes(gt)
    centers = [center_coordinates[int(i)] for i in gt_ids]
    bboxes = [(bbox_coordinates[int(i)][0][0], bbox_coordinates[int(i)][1][0],
               bbox_coordinates[int(i)][0][1], bbox_coordinates[int(i)][1][1]) for i in gt_ids]
    masks = np.stack([gt == i for i in gt_ids])[:, None].astype(np.float32)
    points, labels, boxes, _ = prompt_generator(masks, bboxes, centers)
    return points, labels, boxes


def _settings_name(settings: Dict) -> str:
    if settings.get("use_boxes") and not settings.get("use_points"):
        return "boxes"
    return f"points-p{settings['n_positives']}-n{settings['n_negatives']}"


def precompute_all_prompts(gt_paths, prompt_save_dir, prompt_settings: List[Dict]) -> None:
    """Derive the prompts of every setting for every truth image and pickle
    them, one file per setting."""
    os.makedirs(prompt_save_dir, exist_ok=True)
    for settings in prompt_settings:
        save_path = os.path.join(prompt_save_dir, f"{_settings_name(settings)}.pkl")
        if os.path.exists(save_path):
            continue
        all_prompts = {}
        for idx, gt_path in enumerate(gt_paths):
            gt = _load(gt_path)
            gt_ids = np.unique(gt)[1:]
            if len(gt_ids) == 0:
                continue
            all_prompts[_name_of(gt_path, idx)] = _get_batched_prompts(
                gt, gt_ids, use_points=settings.get("use_points", True),
                use_boxes=settings.get("use_boxes", False),
                n_positives=settings.get("n_positives", 1),
                n_negatives=settings.get("n_negatives", 0),
                dilation=settings.get("dilation", 5))
        with open(save_path, "wb") as f:
            pickle.dump(all_prompts, f)


def segmentation_from_prompts(predictor, image: np.ndarray, gt: np.ndarray,
                              embedding_path: Optional[str], use_points: bool, use_boxes: bool,
                              n_positives: int, n_negatives: int, dilation: int = 5,
                              batch_size: int = 512) -> Optional[np.ndarray]:
    """The instance segmentation from one prompt set per truth object (the
    truth relabelled consecutively), or None when the truth is empty."""
    gt, _, _ = native.relabel_consecutive(gt)
    gt_ids = np.unique(gt)[1:]
    if len(gt_ids) == 0:
        return None
    emb = util.precompute_image_embeddings(predictor, image, embedding_path, verbose=False)
    util.set_precomputed(predictor, emb)
    points, labels, boxes = _get_batched_prompts(gt, gt_ids, use_points, use_boxes, n_positives,
                                                 n_negatives, dilation)
    ids = [int(i) for i in gt_ids]
    if use_boxes and not use_points:
        return batched_inference(predictor, image=None, batch_size=batch_size,
                                 boxes=boxes.astype(np.float64), segmentation_ids=ids)
    return batched_inference(
        predictor, image=None, batch_size=batch_size,
        points=points.astype(np.float64).reshape(len(gt_ids), -1, 2),
        point_labels=np.asarray(labels).reshape(len(gt_ids), -1),
        boxes=boxes.astype(np.float64) if use_boxes else None, segmentation_ids=ids)


def run_inference_with_prompts(
    predictor,
    image_paths: List,
    gt_paths: List,
    embedding_dir: Union[str, os.PathLike],
    prediction_dir: Union[str, os.PathLike],
    use_points: bool,
    use_boxes: bool,
    n_positives: int,
    n_negatives: int,
    dilation: int = 5,
    prompt_save_dir: Optional[Union[str, os.PathLike]] = None,
    batch_size: int = 512,
) -> None:
    """Segment every image from prompts derived from its truth and write
    ``<prediction_dir>/<name>.tif``. ``prompt_save_dir`` is accepted for the
    JAX package's signature, which does not read it either."""
    if not (use_points or use_boxes):
        raise ValueError("You need to use at least one of point or box prompts.")
    os.makedirs(prediction_dir, exist_ok=True)
    for idx, (image_path, gt_path) in enumerate(zip(image_paths, gt_paths)):
        name = _name_of(image_path, idx)
        prediction_path = os.path.join(prediction_dir, f"{name}.tif")
        if os.path.exists(prediction_path):
            continue
        seg = segmentation_from_prompts(
            predictor, _load(image_path), _load(gt_path), _embedding_path(embedding_dir, name),
            use_points, use_boxes, n_positives, n_negatives, dilation, batch_size)
        if seg is not None:
            _write_tif(prediction_path, seg.astype(np.uint32))


def iterative_prompting_segmentations(
    predictor, gt: np.ndarray, start_with_box_prompt: bool, dilation: int = 5,
    batch_size: int = 32, n_iterations: int = 8, use_masks: bool = False,
    prompt_generator=None,
) -> List[np.ndarray]:
    """Iterative prompting against the embeddings set on ``predictor``: one
    (H, W) uint32 segmentation per iteration, each object painted with its
    truth id. Round 0 prompts each truth object with its box or its center
    point; each later round adds the corrective points ``prompt_generator``
    (default: ``IterativePromptGenerator()`` on numpy's global stream) draws
    from the last round's masks, and with ``use_masks`` feeds back their
    logits. An empty truth gives no iteration."""
    prompt_generator = prompt_generator or IterativePromptGenerator()
    gt_ids = np.unique(gt)[1:]
    if len(gt_ids) == 0:
        return []
    points, labels, boxes = _get_batched_prompts(
        gt, gt_ids, use_points=not start_with_box_prompt, use_boxes=start_with_box_prompt,
        n_positives=1, n_negatives=0, dilation=dilation)
    sampled_binary_gt = np.stack([gt == i for i in gt_ids]).astype(np.float32)

    segmentations, logits_masks = [], None
    for it in range(n_iterations):
        if start_with_box_prompt and it == 0:
            records = batched_inference(predictor, image=None, batch_size=batch_size,
                                        boxes=boxes.astype(np.float64),
                                        return_instance_segmentation=False)
        else:
            records = batched_inference(predictor, image=None, batch_size=batch_size,
                                        points=points.astype(np.float64), point_labels=labels,
                                        return_instance_segmentation=False,
                                        logits_masks=logits_masks)
        seg = np.zeros(gt.shape, dtype=np.uint32)
        for obj_idx, rec in enumerate(records):
            seg[np.asarray(rec["segmentation"], dtype=bool)] = int(gt_ids[obj_idx])
        segmentations.append(seg)
        if it == n_iterations - 1:
            break
        pred_masks = np.stack([np.asarray(r["segmentation"]) for r in records])[:, None]
        new_points, new_labels, _, _ = prompt_generator(sampled_binary_gt[:, None],
                                                        pred_masks.astype(np.float32))
        if it == 0 and start_with_box_prompt:
            points, labels = new_points.astype(np.float64), new_labels
        else:
            points = np.concatenate([points, new_points], axis=1)
            labels = np.concatenate([labels, new_labels], axis=1)
        if use_masks:
            logits_masks = np.stack([np.asarray(r["logits"]) for r in records])
    return segmentations


def _run_inference_with_iterative_prompting_for_image(
    predictor, image, gt, start_with_box_prompt, dilation, batch_size,
    n_iterations, prediction_paths, use_masks=False,
) -> None:
    """``iterative_prompting_segmentations``, each iteration's segmentation
    written to its entry of ``prediction_paths``."""
    segs = iterative_prompting_segmentations(predictor, gt, start_with_box_prompt, dilation,
                                             batch_size, n_iterations, use_masks)
    for seg, path in zip(segs, prediction_paths):
        _write_tif(path, seg)


# the name the JAX package's API gives it
get_predictions_with_iterative_prompting = _run_inference_with_iterative_prompting_for_image


def run_inference_with_iterative_prompting(
    predictor,
    image_paths: List,
    gt_paths: List,
    embedding_dir: Union[str, os.PathLike],
    prediction_dir: Union[str, os.PathLike],
    start_with_box_prompt: bool = True,
    dilation: int = 5,
    batch_size: int = 32,
    n_iterations: int = 8,
    use_masks: bool = False,
) -> None:
    """Iterative prompting over images; each iteration's predictions go to
    ``<prediction_dir>/iteration<NN>/<name>.tif``."""
    prediction_folders = []
    for it in range(n_iterations):
        folder = os.path.join(prediction_dir, f"iteration{it:02}")
        os.makedirs(folder, exist_ok=True)
        prediction_folders.append(folder)

    for idx, (image_path, gt_path) in enumerate(zip(image_paths, gt_paths)):
        name = _name_of(image_path, idx)
        prediction_paths = [os.path.join(f, f"{name}.tif") for f in prediction_folders]
        if all(os.path.exists(p) for p in prediction_paths):
            continue
        gt, _, _ = native.relabel_consecutive(_load(gt_path))
        emb = util.precompute_image_embeddings(predictor, _load(image_path),
                                               _embedding_path(embedding_dir, name),
                                               verbose=False)
        util.set_precomputed(predictor, emb)
        _run_inference_with_iterative_prompting_for_image(
            predictor, None, gt, start_with_box_prompt=start_with_box_prompt, dilation=dilation,
            batch_size=batch_size, n_iterations=n_iterations, prediction_paths=prediction_paths,
            use_masks=use_masks)


#
# AMG / AIS / APG evaluation runners: the grid search on the validation
# images, then the test images with the best parameters
#

def _run_grid_search(segmenter, prefix, grid_search_values, experiment_folder,
                     val_image_paths, val_gt_paths, test_image_paths, tiling_window_params,
                     cache_embeddings, verbose_gs) -> str:
    embedding_folder = os.path.join(experiment_folder, "embeddings") if cache_embeddings else None
    if embedding_folder:
        os.makedirs(embedding_folder, exist_ok=True)
    gs_result_folder = os.path.join(experiment_folder, prefix, "grid_search")
    os.makedirs(gs_result_folder, exist_ok=True)
    return grid_search_mod.run_instance_segmentation_grid_search_and_inference(
        segmenter, grid_search_values, val_image_paths, val_gt_paths, test_image_paths,
        embedding_dir=embedding_folder,
        prediction_dir=os.path.join(experiment_folder, prefix, "inference"),
        result_dir=gs_result_folder, verbose_gs=verbose_gs,
        experiment_folder=experiment_folder, tiling_window_params=tiling_window_params)


def run_amg(
    checkpoint: Optional[Union[str, os.PathLike]],
    model_type: str,
    experiment_folder: Union[str, os.PathLike],
    val_image_paths: List,
    val_gt_paths: List,
    test_image_paths: List,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
    iou_thresh_values: Optional[List[float]] = None,
    stability_score_values: Optional[List[float]] = None,
    peft_kwargs: Optional[Dict] = None,
    cache_embeddings: bool = False,
    verbose_gs: bool = False,
    device: Optional[str] = None,
) -> str:
    """AMG: grid search over the IoU and stability thresholds, then the test
    images; returns the prediction folder."""
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint,
                                   peft_kwargs=peft_kwargs, device=device)
    grid = grid_search_mod.default_grid_search_values_amg(
        iou_thresh_values=iou_thresh_values, stability_score_values=stability_score_values)
    return _run_grid_search(AutomaticMaskGenerator(predictor), "amg", grid, experiment_folder,
                            val_image_paths, val_gt_paths, test_image_paths,
                            tiling_window_params, cache_embeddings, verbose_gs)


def run_instance_segmentation_with_decoder(
    checkpoint: Optional[Union[str, os.PathLike]],
    model_type: str,
    experiment_folder: Union[str, os.PathLike],
    val_image_paths: List,
    val_gt_paths: List,
    test_image_paths: List,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
    peft_kwargs: Optional[Dict] = None,
    cache_embeddings: bool = False,
    verbose_gs: bool = False,
    device: Optional[str] = None,
) -> str:
    """AIS: grid search over the watershed thresholds, then the test images."""
    predictor, decoder = get_predictor_and_decoder(model_type=model_type,
                                                   checkpoint_path=checkpoint,
                                                   peft_kwargs=peft_kwargs, device=device)
    grid = grid_search_mod.default_grid_search_values_instance_segmentation_with_decoder()
    return _run_grid_search(InstanceSegmentationWithDecoder(predictor, decoder),
                            "instance_segmentation_with_decoder", grid, experiment_folder,
                            val_image_paths, val_gt_paths, test_image_paths,
                            tiling_window_params, cache_embeddings, verbose_gs)


def run_apg(
    checkpoint: Optional[Union[str, os.PathLike]],
    model_type: str,
    experiment_folder: Union[str, os.PathLike],
    val_image_paths: List,
    val_gt_paths: List,
    test_image_paths: List,
    tiling_window_params: Optional[Dict[str, Tuple[int, int]]] = None,
    peft_kwargs: Optional[Dict] = None,
    cache_embeddings: bool = False,
    verbose_gs: bool = False,
    device: Optional[str] = None,
) -> str:
    """APG: grid search over the prompt thresholds and NMS, then the test images."""
    predictor, decoder = get_predictor_and_decoder(model_type=model_type,
                                                   checkpoint_path=checkpoint,
                                                   peft_kwargs=peft_kwargs, device=device)
    grid = grid_search_mod.default_grid_search_values_apg()
    return _run_grid_search(AutomaticPromptGenerator(predictor, decoder), "apg", grid,
                            experiment_folder, val_image_paths, val_gt_paths, test_image_paths,
                            tiling_window_params, cache_embeddings, verbose_gs)
