"""Evaluation of (interactive) segmentation results against ground truth.

Counterpart of the JAX package's ``evaluation/evaluation.py`` (upstream
micro_sam/evaluation/evaluation.py): mSA / SA50 / SA75 over prediction and
truth pairs, CSV caching, the iterative-prompting evaluation over iteration
folders, and the command line. The results are pandas DataFrames, so pandas
is imported at the call; the scores themselves are ``matching``'s.
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .. import util
from .matching import mean_segmentation_accuracy


def _load_image(path, key=None):
    if isinstance(path, np.ndarray):
        return path
    return util.load_image_data(str(path), key)


def run_evaluation(
    gt_paths: List[Union[np.ndarray, str, os.PathLike]],
    prediction_paths: List[Union[np.ndarray, str, os.PathLike]],
    save_path: Optional[Union[os.PathLike, str]] = None,
    verbose: bool = True,
    thresholds: Optional[List[float]] = None,
):
    """Evaluate instance segmentations against their truth: a one-row
    DataFrame of mSA (and SA50, SA75 at the default thresholds), read from
    ``save_path`` where that exists, else written there."""
    import pandas as pd
    assert len(gt_paths) == len(prediction_paths), f"{len(gt_paths)}, {len(prediction_paths)}"
    if save_path is not None and os.path.exists(save_path):
        return pd.read_csv(save_path)
    msas, sa50s, sa75s = [], [], []
    for gt_path, pred_path in zip(gt_paths, prediction_paths):
        msa, scores = mean_segmentation_accuracy(_load_image(pred_path), _load_image(gt_path),
                                                 thresholds=thresholds, return_accuracies=True)
        msas.append(msa)
        if thresholds is None:
            sa50s.append(scores[0])
            sa75s.append(scores[5])
    columns = {"mSA": [float(np.mean(msas))]}
    if thresholds is None:
        columns.update(SA50=[float(np.mean(sa50s))], SA75=[float(np.mean(sa75s))])
    results = pd.DataFrame.from_dict(columns)
    if save_path is not None:
        os.makedirs(Path(save_path).parent, exist_ok=True)
        results.to_csv(save_path, index=False)
    return results


def run_evaluation_for_iterative_prompting(
    gt_paths: List[Union[str, os.PathLike]],
    prediction_root: Union[os.PathLike, str],
    experiment_folder: Union[os.PathLike, str],
    start_with_box_prompt: bool = False,
    overwrite_results: bool = False,
    use_masks: bool = False,
):
    """Evaluate iterative-prompting results, one row per ``iteration*``
    folder, cached under ``<experiment_folder>/results/``."""
    import pandas as pd
    assert os.path.exists(prediction_root), prediction_root

    csv_dir = os.path.join(experiment_folder, "results")
    os.makedirs(csv_dir, exist_ok=True)
    result_name = "iterative_prompts_start_box" if start_with_box_prompt \
        else "iterative_prompts_start_point"
    if use_masks:
        result_name += "_use_masks"
    csv_path = os.path.join(csv_dir, f"{result_name}.csv")
    if os.path.exists(csv_path) and not overwrite_results:
        return pd.read_csv(csv_path)

    prediction_folders = sorted(glob(os.path.join(prediction_root, "iteration*")))
    list_of_results = []
    for pred_folder in prediction_folders:
        pred_paths = sorted(glob(os.path.join(pred_folder, "*")))
        list_of_results.append(run_evaluation(gt_paths, pred_paths, save_path=None))

    res_df = pd.concat(list_of_results, ignore_index=True)
    res_df.to_csv(csv_path, index=False)
    return res_df


def main(argv: Optional[List[str]] = None):
    """The command line: ``python -m micro_sam_tpu_torch.evaluation.evaluation``."""
    import argparse

    parser = argparse.ArgumentParser(description="Evaluate segmentation vs ground truth.")
    parser.add_argument("--labels", "-g", "--gt_paths", dest="labels", required=True, nargs="+",
                        help="Ground-truth label image paths or a directory.")
    parser.add_argument("--predictions", "-p", "--prediction_paths", dest="predictions",
                        required=True, nargs="+",
                        help="Predicted label image paths or a directory.")
    parser.add_argument("--label_key", default=None,
                        help="Pattern / container key for the label data.")
    parser.add_argument("--prediction_key", default=None,
                        help="Pattern / container key for the prediction data.")
    parser.add_argument("-o", "--output_path", "--save_path", dest="output_path", default=None,
                        help="Where to store the results csv.")
    parser.add_argument("--pattern", default=None,
                        help="Glob pattern for directory inputs (alias for the keys).")
    parser.add_argument("--threshold", default=None, type=float, nargs="+",
                        help="Overlap threshold(s) for the segmentation accuracy.")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    def expand(paths, key):
        pattern = key or args.pattern
        out = []
        for p in paths:
            if os.path.isdir(p):
                if pattern is None:
                    raise ValueError(f"A key/pattern is required for directory input {p}")
                out.extend(sorted(glob(os.path.join(p, pattern))))
            else:
                out.append(p)
        return out

    results = run_evaluation(expand(args.labels, args.label_key),
                             expand(args.predictions, args.prediction_key),
                             save_path=args.output_path, verbose=args.verbose,
                             thresholds=args.threshold)
    print(results.to_string(index=False))


if __name__ == "__main__":
    main()
