"""Predefined prompt settings for evaluation: a copy of the JAX package's
``evaluation/experiments.py`` (upstream micro_sam/evaluation/experiments.py
semantics)."""
from __future__ import annotations

from typing import Dict, List, Optional

# The prompt settings for the experiments.
ExperimentSetting = Dict

_DEFAULT_POSITIVES = (1, 2, 4, 8, 16)
_DEFAULT_NEGATIVES = (0, 1, 2, 4, 8, 16)
_BOX_ONLY = {"use_points": False, "use_boxes": True,
             "n_positives": 0, "n_negatives": 0}


def _point_setting(n_pos: int, n_neg: int, with_boxes: bool = False) -> ExperimentSetting:
    return {"use_points": True, "use_boxes": with_boxes,
            "n_positives": n_pos, "n_negatives": n_neg}


def full_experiment_settings(
    use_boxes: bool = False,
    positive_range: Optional[List[int]] = None,
    negative_range: Optional[List[int]] = None,
) -> List[ExperimentSetting]:
    """The full prompt-count grid (reference experiments.py:13):
    p in {1,2,4,8,16} x n in {0,...,16}, plus the box setting when boxes are
    enabled."""
    grid = [
        _point_setting(p, n, with_boxes=use_boxes)
        for p in (positive_range or _DEFAULT_POSITIVES)
        for n in (negative_range or _DEFAULT_NEGATIVES)
        if (p, n) != (0, 0)
    ]
    return ([dict(_BOX_ONLY)] if use_boxes else []) + grid


def default_experiment_settings() -> List[ExperimentSetting]:
    """The four default settings (reference experiments.py:51):
    p1-n0, p2-n4, p4-n8 and box."""
    return [_point_setting(1, 0), _point_setting(2, 4), _point_setting(4, 8),
            dict(_BOX_ONLY)]


def get_experiment_setting_name(setting: ExperimentSetting) -> str:
    """Name for an experiment setting (reference experiments.py:69)."""
    use_points, use_boxes = setting["use_points"], setting["use_boxes"]
    assert use_points or use_boxes
    if not use_points:
        return "box"
    prefix = "box-and-points" if use_boxes else "points"
    return f"{prefix}-p{setting['n_positives']}-n{setting['n_negatives']}"
