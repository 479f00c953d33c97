"""LIVECell evaluation pipelines: counterpart of the JAX package's
``evaluation/livecell.py`` (upstream micro_sam/evaluation/livecell.py).

The LIVECell layout is the official one: ``images/livecell_test_images`` and
``annotations/livecell_test_images/<CELL_TYPE>/...``, present locally (there
is no download). The runners build their model on the card unless given
``device``.
"""
from __future__ import annotations

import os
from glob import glob
from typing import List, Optional, Tuple, Union

import numpy as np

from .. import util
from . import inference as inference_mod
from .evaluation import run_evaluation
from .experiments import default_experiment_settings, get_experiment_setting_name

CELL_TYPES = ["A172", "BT474", "BV2", "Huh7", "MCF7", "SHSY5Y", "SkBr3", "SKOV3"]


def _get_livecell_paths(input_folder: str, split: str = "test",
                        n_val_per_cell_type: Optional[int] = None
                        ) -> Tuple[List[str], List[str]]:
    """Resolve LIVECell image/gt path pairs (reference livecell.py:80)."""
    assert split in ("val", "test")
    img_dir = os.path.join(input_folder, "images", "livecell_test_images")
    gt_dir = os.path.join(input_folder, "annotations", "livecell_test_images")
    if not os.path.exists(img_dir):
        raise RuntimeError(
            f"LIVECell images not found at {img_dir}. The dataset cannot be "
            "downloaded in this environment; place it there manually."
        )
    image_paths, gt_paths = [], []
    for cell_type in CELL_TYPES:
        candidates = sorted(glob(os.path.join(gt_dir, cell_type, "*.tif")))
        if n_val_per_cell_type is not None:
            candidates = candidates[:n_val_per_cell_type]
        for gt_path in candidates:
            image_paths.append(os.path.join(img_dir, os.path.basename(gt_path)))
            gt_paths.append(gt_path)
    return image_paths, gt_paths


def run_livecell_inference(
    checkpoint: Optional[str],
    input_folder: str,
    model_type: str,
    experiment_folder: str,
    use_points: bool = True,
    use_boxes: bool = False,
    n_positives: int = 1,
    n_negatives: int = 0,
    use_default_experiment_settings: bool = True,
    device: Optional[str] = None,
) -> None:
    """Run LIVECell prompt-based inference (reference livecell.py:300)."""
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint,
                                   device=device)
    image_paths, gt_paths = _get_livecell_paths(input_folder)

    embedding_dir = os.path.join(experiment_folder, "embeddings")
    os.makedirs(embedding_dir, exist_ok=True)

    settings = default_experiment_settings() if use_default_experiment_settings else [{
        "use_points": use_points, "use_boxes": use_boxes,
        "n_positives": n_positives, "n_negatives": n_negatives,
    }]
    for setting in settings:
        name = get_experiment_setting_name(setting)
        prediction_dir = os.path.join(experiment_folder, name)
        inference_mod.run_inference_with_prompts(
            predictor, image_paths, gt_paths, embedding_dir, prediction_dir,
            use_points=setting["use_points"], use_boxes=setting["use_boxes"],
            n_positives=setting["n_positives"], n_negatives=setting["n_negatives"],
        )


def run_livecell_evaluation(input_folder: str, experiment_folder: str) -> None:
    """Evaluate LIVECell predictions (reference livecell.py:441)."""
    _, gt_paths = _get_livecell_paths(input_folder)
    for setting in default_experiment_settings():
        name = get_experiment_setting_name(setting)
        pred_dir = os.path.join(experiment_folder, name)
        if not os.path.exists(pred_dir):
            continue
        pred_paths = sorted(glob(os.path.join(pred_dir, "*.tif")))
        save_path = os.path.join(experiment_folder, "results", f"{name}.csv")
        run_evaluation(gt_paths[:len(pred_paths)], pred_paths, save_path=save_path)


def livecell_inference(
    checkpoint: Optional[str],
    input_folder: str,
    model_type: str,
    experiment_folder: str,
    use_points: bool,
    use_boxes: bool,
    n_positives: Optional[int] = None,
    n_negatives: Optional[int] = None,
    prompt_folder: Optional[str] = None,
    predictor=None,
    device: Optional[str] = None,
) -> None:
    """Run LIVECell inference for ONE fixed prompt setting (reference
    livecell.py:80). Results land under
    ``<experiment_folder>/<setting_name>/``; prompts are pickled so other
    experiments can reuse them."""
    if not (use_boxes or use_points):
        raise ValueError("You need to use at least one of point or box prompts.")
    image_paths, gt_paths = _get_livecell_paths(input_folder)
    if predictor is None:
        predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint,
                                       device=device)

    if use_boxes and use_points:
        if n_positives is None or n_negatives is None:
            raise ValueError("Point counts are required when point prompts are used.")
        setting_name = f"box/p{n_positives}-n{n_negatives}"
    elif use_boxes:
        setting_name = "box/p0-n0"
    elif use_points:
        if n_positives is None or n_negatives is None:
            raise ValueError("Point counts are required when point prompts are used.")
        setting_name = f"points/p{n_positives}-n{n_negatives}"
    else:
        raise ValueError("You need to use at least one of point or box prompts.")

    prediction_dir = os.path.join(experiment_folder, setting_name)
    os.makedirs(prediction_dir, exist_ok=True)
    embedding_dir = os.path.join(experiment_folder, "embeddings")
    os.makedirs(embedding_dir, exist_ok=True)
    if prompt_folder is None:
        prompt_folder = os.path.join(experiment_folder, "prompts")
        os.makedirs(prompt_folder, exist_ok=True)

    inference_mod.run_inference_with_prompts(
        predictor, image_paths, gt_paths, embedding_dir, prediction_dir,
        use_points=use_points, use_boxes=use_boxes,
        n_positives=0 if n_positives is None else n_positives,
        n_negatives=0 if n_negatives is None else n_negatives,
        prompt_save_dir=prompt_folder,
    )


def run_livecell_precompute_embeddings(
    checkpoint: Optional[str],
    input_folder: str,
    model_type: str,
    experiment_folder: str,
    n_val_per_cell_type: int = 25,
    device: Optional[str] = None,
) -> None:
    """Precompute val+test LIVECell embeddings (reference livecell.py:147)."""
    embedding_dir = os.path.join(experiment_folder, "embeddings")
    os.makedirs(embedding_dir, exist_ok=True)
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint,
                                   device=device)
    val_image_paths, _ = _get_livecell_paths(input_folder, "val",
                                             n_val_per_cell_type=n_val_per_cell_type)
    test_image_paths, _ = _get_livecell_paths(input_folder, "test")
    inference_mod.precompute_all_embeddings(predictor, val_image_paths, embedding_dir)
    inference_mod.precompute_all_embeddings(predictor, test_image_paths, embedding_dir)


def run_livecell_iterative_prompting(
    checkpoint: Optional[str],
    input_folder: str,
    model_type: str,
    experiment_folder: str,
    start_with_box: bool = False,
    use_masks: bool = False,
    device: Optional[str] = None,
) -> str:
    """Iterative-prompting inference on LIVECell (reference livecell.py:175)."""
    embedding_dir = os.path.join(experiment_folder, "embeddings")
    os.makedirs(embedding_dir, exist_ok=True)
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint,
                                   device=device)
    prediction_dir = os.path.join(
        experiment_folder, "start_with_box" if start_with_box else "start_with_point")
    image_paths, gt_paths = _get_livecell_paths(input_folder, "test")
    inference_mod.run_inference_with_iterative_prompting(
        predictor=predictor, image_paths=image_paths, gt_paths=gt_paths,
        embedding_dir=embedding_dir, prediction_dir=prediction_dir,
        start_with_box_prompt=start_with_box, use_masks=use_masks,
    )
    return prediction_dir


def run_livecell_amg(checkpoint, input_folder, model_type, experiment_folder,
                     n_val_per_cell_type: int = 25, **kwargs) -> str:
    """LIVECell AMG with grid search (reference livecell.py:218)."""
    val_image_paths, val_gt_paths = _get_livecell_paths(
        input_folder, "val", n_val_per_cell_type=n_val_per_cell_type)
    test_image_paths, _ = _get_livecell_paths(input_folder, "test")
    return inference_mod.run_amg(
        checkpoint, model_type, experiment_folder,
        val_image_paths, val_gt_paths, test_image_paths, **kwargs,
    )


def run_livecell_instance_segmentation_with_decoder(
    checkpoint, input_folder, model_type, experiment_folder,
    n_val_per_cell_type: int = 25, **kwargs,
) -> str:
    """LIVECell AIS with grid search (reference livecell.py:275)."""
    val_image_paths, val_gt_paths = _get_livecell_paths(
        input_folder, "val", n_val_per_cell_type=n_val_per_cell_type)
    test_image_paths, _ = _get_livecell_paths(input_folder, "test")
    return inference_mod.run_instance_segmentation_with_decoder(
        checkpoint, model_type, experiment_folder,
        val_image_paths, val_gt_paths, test_image_paths, **kwargs,
    )
