"""The API of upstream micro_sam's vendored helpers (``micro_sam/_vendored.py``):
mask -> box on torch, RLE by the native library or by numpy.

Counterpart of ``micro_sam_tpu/_vendored.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .ops.amg_utils import batched_mask_to_box as _batched_mask_to_box
from .ops.amg_utils import batched_mask_to_rle, mask_to_rle


def batched_mask_to_box(masks) -> np.ndarray:
    """XYXY boxes around a batch of masks; zeros for empty masks. A tensor is
    reduced on its own device."""
    if isinstance(masks, torch.Tensor):
        return _batched_mask_to_box(masks).cpu().numpy()
    return _batched_mask_to_box(torch.as_tensor(np.asarray(masks, dtype=bool))).numpy()


def _as_mask_batch(tensor) -> np.ndarray:
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.cpu().numpy()
    arr = np.asarray(tensor, dtype=bool)
    return arr[None] if arr.ndim == 2 else arr


def mask_to_rle_numpy(tensor) -> List[Dict[str, Any]]:
    """Uncompressed RLE records, numpy."""
    return [mask_to_rle(m) for m in _as_mask_batch(tensor)]


def mask_to_rle_pytorch(tensor, rle_implementation: str = "default") -> List[Dict[str, Any]]:
    """Uncompressed RLE records (name kept from upstream). Every
    ``rle_implementation`` gives the same records: ``"numpy"`` encodes with
    numpy, anything else with the native library."""
    arr = _as_mask_batch(tensor)
    if rle_implementation == "numpy":
        return mask_to_rle_numpy(arr)
    return batched_mask_to_rle(arr)
