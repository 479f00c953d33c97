"""Input-size transforms for the SAM image encoder (``ResizeLongestSide``)."""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def get_preprocess_shape(old_h: int, old_w: int, long_side: int) -> Tuple[int, int]:
    """Output (h, w) after resizing the longest side to ``long_side``."""
    scale = long_side * 1.0 / max(old_h, old_w)
    return int(old_h * scale + 0.5), int(old_w * scale + 0.5)


PRECISION_BITS = 22  # fixed-point bits of the resampling coefficients (32 - 8 - 2)


@functools.lru_cache(maxsize=64)
def _bilinear_taps(n_in: int, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The taps of a uint8 bilinear resample of an axis of ``n_in`` samples to
    ``n_out``, as PIL computes them (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` of its ``Resample.c``): for output i, the
    triangle filter of support ``max(scale, 1)`` centred at ``(i + 0.5) *
    scale``, normalised in float64, in fixed point with ``PRECISION_BITS``.
    Returns the input index of each tap and its int32 weight, both
    (n_out, taps), without the taps that are zero for every output (a tap
    past an output's window has index 0 and weight 0)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), n_in) - xmin
    taps = np.arange(ksize)
    live = taps[None] < xmax[:, None]
    w = np.where(live, np.maximum(
        1.0 - np.abs((taps[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / support)),
        0.0), 0.0)
    total = np.zeros(n_out)
    for k in range(ksize):  # summed in tap order, as PIL does
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)
    index = np.where(live, xmin[:, None] + taps[None], 0)
    used = (fixed != 0).any(axis=0)
    return torch.from_numpy(np.ascontiguousarray(index[:, used])), \
        torch.from_numpy(np.ascontiguousarray(fixed[:, used]))


def _resample_rows(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """One pass of the uint8 resample over the rows of an (n_in, D) int32
    tensor of uint8 values: each output row a sum of whole input rows (one
    gather and one fused multiply-add a tap, in place), rounded and clipped
    to uint8 as PIL does (``(sum + 2^21) >> 22``, then 0..255)."""
    index, weight = _bilinear_taps(x.shape[0], n_out)
    acc = torch.full((n_out, x.shape[1]), 1 << (PRECISION_BITS - 1), dtype=torch.int32)
    rows = torch.empty_like(acc)
    for k in range(index.shape[1]):
        torch.index_select(x, 0, index[:, k], out=rows)
        acc.addcmul_(rows, weight[:, k:k + 1])
    return acc.bitwise_right_shift_(PRECISION_BITS).clamp_(0, 255)


def resize_uint8(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize(..., Image.BILINEAR)`` of an (H, W), (H, W, 1) or
    (H, W, C) uint8 image to ``size`` = (h, w), to the bit, in torch integer
    arithmetic (no Pillow): the horizontal pass, then the vertical one, uint8
    values between them, a pass skipped where its axis keeps its size. Each
    pass gathers whole rows (the horizontal one of the image transposed to
    (W, H, C)). Every tap sum fits int32: 255 * 2^22 (the weights of an output
    sum to about 2^22) + 2^21 < 2^31. Returns the image's shape with (h, w) as
    float32 holding uint8 values."""
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.uint8))
    grey = x.dim() == 2
    if grey:
        x = x[..., None]
    H, W, C = x.shape
    h, w = size
    if W != w:
        xt = torch.empty((W, H, C), dtype=torch.int32)
        xt.copy_(x.permute(1, 0, 2))
        cols = _resample_rows(xt.view(W, H * C), w).view(w, H, C)
        x = torch.empty((H, w, C), dtype=torch.int32)
        x.copy_(cols.permute(1, 0, 2))
    if H != h:
        x = _resample_rows(x.reshape(H, w * C).to(torch.int32), h).view(h, w, C)
    out = x.to(torch.float32)
    return (out[..., 0] if grey else out).numpy()


class ResizeLongestSide:
    """Resize so that the longest side is ``target_length``, with the matching
    coordinate and box transforms."""

    def __init__(self, target_length: int = 1024):
        self.target_length = target_length

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """(H, W, C) uint8 (or (H, W) / (H, W, 1) grey) -> resized (h, w, ...)
        float32 holding uint8 values, equal to PIL's bilinear resize."""
        h, w = image.shape[:2]
        new_hw = get_preprocess_shape(h, w, self.target_length)
        if new_hw == (h, w):
            return np.asarray(image, dtype=np.float32)
        return resize_uint8(image, new_hw)

    def apply_coords(self, coords: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """Map (..., 2) (x, y) coordinates from the original to the resized image."""
        old_h, old_w = original_size
        new_h, new_w = get_preprocess_shape(old_h, old_w, self.target_length)
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords.astype(np.float32)

    def apply_boxes(self, boxes: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """Map (..., 4) XYXY boxes from the original to the resized image."""
        return self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2), original_size).reshape(-1, 4)
