"""Trainers with one prompting round per step (counterpart of
``micro_sam_tpu/training/simple_sam_trainer.py``)."""
from __future__ import annotations

import random

from .sam_trainer import SamTrainer

_POINT = (True, False, True, 1, 0)   # (use_points, use_box, multimask, n_pos, n_neg)
_BOX = (False, True, False, 0, 0)


class SimpleSamTrainer(SamTrainer):
    """One round per step (``n_sub_iteration`` 1, no mask prompt by default),
    prompted by one point or one box: with both allowed, training draws the
    kind from Python's ``random`` (a point below 0.5) and validation
    alternates, a point on even iterations."""

    def __init__(self, *args, use_points: bool = True, use_box: bool = True, **kwargs):
        if kwargs.get("mesh") is not None:  # each rank would draw its own prompt kind
            raise NotImplementedError("SimpleSamTrainer is not meshed; use SamTrainer(mesh=)")
        kwargs.setdefault("n_sub_iteration", 1)
        kwargs.setdefault("mask_prob", 0.0)
        super().__init__(*args, **kwargs)
        self.use_points = use_points
        self.use_box = use_box

    def _get_prompt_and_multimasking_choices(self, iteration):
        if self.use_points and self.use_box:
            return _POINT if random.random() < 0.5 else _BOX
        return _POINT if self.use_points else _BOX

    def _get_prompt_and_multimasking_choices_for_val(self, iteration):
        if self.use_points and self.use_box:
            return _POINT if iteration % 2 == 0 else _BOX
        return _POINT if self.use_points else _BOX


class MedSAMTrainer(SimpleSamTrainer):
    """Box prompts only (the MedSAM recipe)."""

    def __init__(self, *args, **kwargs):
        kwargs["use_points"] = False
        kwargs["use_box"] = True
        super().__init__(*args, **kwargs)
