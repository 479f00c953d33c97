"""Mask helpers on the device (the part of ``micro_sam_tpu/ops/amg_utils.py``
the trainer needs)."""
from __future__ import annotations

import torch


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """XYXY boxes around masks (..., H, W) -> (..., 4) int32; zeros for empty
    masks. Edge scans with argmax instead of a data-dependent nonzero, so it
    stays on the device."""
    masks = masks.bool()
    H, W = masks.shape[-2], masks.shape[-1]
    any_y = masks.any(dim=-1).to(torch.uint8)  # (..., H)
    any_x = masks.any(dim=-2).to(torch.uint8)  # (..., W)
    top = any_y.argmax(dim=-1)
    bottom = H - 1 - any_y.flip(-1).argmax(dim=-1)
    left = any_x.argmax(dim=-1)
    right = W - 1 - any_x.flip(-1).argmax(dim=-1)
    box = torch.stack([left, top, right + 1, bottom + 1], dim=-1).to(torch.int32)
    empty = ~any_y.bool().any(dim=-1)
    return torch.where(empty[..., None], torch.zeros_like(box), box)
