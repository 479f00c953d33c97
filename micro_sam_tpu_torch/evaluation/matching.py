"""Segmentation matching metrics: mSA / SA@t / precision / recall / F1.

A copy of the JAX package's ``evaluation/matching.py`` (numpy and scipy only):
Hungarian matching (scipy's linear_sum_assignment) over the IoU matrix, the
elf.evaluation API micro-sam's evaluation uses.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def intersection_over_union_matrix(seg: np.ndarray, gt: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IoU matrix between all (non-background) objects of seg and gt.

    Returns (iou (n_seg, n_gt), seg_ids, gt_ids).
    """
    seg = np.asarray(seg)
    gt = np.asarray(gt)
    seg_ids = np.unique(seg)
    seg_ids = seg_ids[seg_ids != 0]
    gt_ids = np.unique(gt)
    gt_ids = gt_ids[gt_ids != 0]
    if len(seg_ids) == 0 or len(gt_ids) == 0:
        return np.zeros((len(seg_ids), len(gt_ids))), seg_ids, gt_ids

    # contingency table via paired encoding
    s = np.searchsorted(seg_ids, seg.ravel())
    g = np.searchsorted(gt_ids, gt.ravel())
    valid = (seg.ravel() != 0) & (gt.ravel() != 0)
    pair = s[valid].astype(np.int64) * len(gt_ids) + g[valid]
    counts = np.bincount(pair, minlength=len(seg_ids) * len(gt_ids))
    inter = counts.reshape(len(seg_ids), len(gt_ids)).astype(np.float64)

    seg_sizes = np.array([(seg == i).sum() for i in seg_ids], dtype=np.float64)
    gt_sizes = np.array([(gt == i).sum() for i in gt_ids], dtype=np.float64)
    union = seg_sizes[:, None] + gt_sizes[None, :] - inter
    return inter / np.maximum(union, 1), seg_ids, gt_ids


def matching(
    segmentation: np.ndarray,
    groundtruth: np.ndarray,
    threshold: float = 0.5,
) -> Dict[str, float]:
    """Object matching at an IoU threshold. Returns precision/recall/f1/
    segmentation_accuracy plus tp/fp/fn counts (elf.evaluation.matching API)."""
    iou, seg_ids, gt_ids = intersection_over_union_matrix(segmentation, groundtruth)
    n_seg, n_gt = len(seg_ids), len(gt_ids)
    if n_seg == 0 or n_gt == 0:
        tp = 0
    else:
        cost = -(iou * (iou > threshold))
        rows, cols = linear_sum_assignment(cost)
        tp = int(np.sum(iou[rows, cols] > threshold))
    fp = n_seg - tp
    fn = n_gt - tp
    precision = tp / n_seg if n_seg else 0.0
    recall = tp / n_gt if n_gt else 0.0
    f1 = 2 * tp / (n_seg + n_gt) if (n_seg + n_gt) else 0.0
    sa = tp / (tp + fp + fn) if (tp + fp + fn) else 0.0
    return {
        "precision": precision, "recall": recall, "f1": f1,
        "segmentation_accuracy": sa, "tp": tp, "fp": fp, "fn": fn,
    }


def mean_segmentation_accuracy(
    segmentation: np.ndarray,
    groundtruth: np.ndarray,
    thresholds: Optional[Sequence[float]] = None,
    return_accuracies: bool = False,
):
    """mSA over IoU thresholds 0.5:0.05:0.95 (elf.evaluation API)."""
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)
    iou, seg_ids, gt_ids = intersection_over_union_matrix(segmentation, groundtruth)
    n_seg, n_gt = len(seg_ids), len(gt_ids)

    accuracies = []
    for t in thresholds:
        if n_seg == 0 or n_gt == 0:
            tp = 0
        else:
            cost = -(iou * (iou > t))
            rows, cols = linear_sum_assignment(cost)
            tp = int(np.sum(iou[rows, cols] > t))
        fp, fn = n_seg - tp, n_gt - tp
        accuracies.append(tp / (tp + fp + fn) if (tp + fp + fn) else 0.0)

    msa = float(np.mean(accuracies))
    if return_accuracies:
        return msa, accuracies
    return msa
