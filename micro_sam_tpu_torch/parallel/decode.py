"""The meshed AMG grid decode.

Counterpart of ``micro_sam_tpu/parallel/decode.py``. AMG decodes hundreds of
point prompts against one embedding, an embarrassingly data-parallel
workload: the points are padded to a multiple of the data axis, each data
rank decodes and reduces its contiguous share on its device
(``predictor.amg_decode``), and the rows are all-gathered in the points'
order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .mesh import Mesh, make_mesh


class ShardedAmgDecoder:
    """The AMG decode of a predictor with its points over a mesh's data axis
    (default: the predictor's mesh, else the 1 x 1 mesh on its device). Call
    with (B, 2) transformed point coords; returns numpy (packed masks (B * 3,
    W, ceil(H / 8)), iou (B, 3), stability (B, 3), boxes (B, 3, 4)), the
    padding points' rows trimmed."""

    def __init__(self, predictor, mesh: Optional[Mesh] = None,
                 stability_offset: float = 1.0, mask_threshold: float = 0.0):
        self.predictor = predictor
        self.mesh = mesh or predictor.mesh or make_mesh(device=predictor.device)
        self.stability_offset = stability_offset
        self.mask_threshold = mask_threshold

    def __call__(self, points_xy: np.ndarray) -> Tuple[np.ndarray, ...]:
        from ..predictor import amg_decode
        B = np.asarray(points_xy).shape[0]
        rows = amg_decode(self.predictor, points_xy, self.mask_threshold, self.stability_offset,
                          None, mesh=self.mesh)
        return (rows["packed"].cpu().numpy(), rows["iou"].reshape(B, 3).cpu().numpy(),
                rows["stability"].reshape(B, 3).cpu().numpy(),
                rows["boxes"].reshape(B, 3, 4).cpu().numpy())
