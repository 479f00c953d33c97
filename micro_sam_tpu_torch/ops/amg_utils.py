"""AMG utilities: the ``segment_anything.utils.amg`` surface.

Counterpart of ``micro_sam_tpu/ops/amg_utils.py``. The pieces that run in the
AMG device decode (stability score, mask -> box, box IoU) are torch functions
on the tensors' own device; the rest (``MaskData``, NMS, point grids, crop
boxes, RLE, small-region repair) is host numpy, as in the JAX package. NMS
keeps torchvision's ``batched_nms`` ordering: kept indices by descending
score, ties in index order.
"""
from __future__ import annotations

import math
from copy import deepcopy
from itertools import product
from typing import Any, Dict, Generator, ItemsView, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# MaskData: columnar store for mask records
# ---------------------------------------------------------------------------

_ARRAYS = (list, np.ndarray, torch.Tensor)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class MaskData:
    """Dict of parallel arrays / lists describing candidate masks, with
    filter / cat semantics (``segment_anything.utils.amg.MaskData``)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, _ARRAYS), "MaskData only supports list, numpy and torch arrays."
        self._stats: Dict[str, Any] = dict(**kwargs)

    def __setitem__(self, key: str, item: Any) -> None:
        assert isinstance(item, _ARRAYS)
        self._stats[key] = item

    def __delitem__(self, key: str) -> None:
        del self._stats[key]

    def __getitem__(self, key: str) -> Any:
        return self._stats[key]

    def __contains__(self, key: str) -> bool:
        return key in self._stats

    def items(self) -> ItemsView[str, Any]:
        return self._stats.items()

    def keys(self):
        return self._stats.keys()

    def filter(self, keep) -> None:
        keep = _host(keep)
        for k, v in self._stats.items():
            if v is None:
                self._stats[k] = None
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                self._stats[k] = _host(v)[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]
            else:
                raise TypeError(f"MaskData key {k} has an unsupported type {type(v)}.")

    def cat(self, new_stats: "MaskData") -> None:
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                self._stats[k] = np.concatenate([_host(self._stats[k]), _host(v)], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)
            else:
                raise TypeError(f"MaskData key {k} has an unsupported type {type(v)}.")

    def to_numpy(self) -> None:
        for k, v in self._stats.items():
            if isinstance(v, torch.Tensor):
                self._stats[k] = _host(v)

    def __len__(self) -> int:
        for v in self._stats.values():
            if v is not None:
                return len(v)
        return 0


# ---------------------------------------------------------------------------
# On the device (torch)
# ---------------------------------------------------------------------------

def calculate_stability_score(masks: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU between the masks binarized at threshold + offset and at threshold
    - offset, float32. masks: (..., H, W)."""
    high = (masks > (mask_threshold + threshold_offset)).sum(dim=(-2, -1), dtype=torch.int32)
    low = (masks > (mask_threshold - threshold_offset)).sum(dim=(-2, -1), dtype=torch.int32)
    return high.float() / low.float().clamp_min(1e-7)


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


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of XYXY boxes: (N, 4) x (M, 4) -> (N, M)."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union.clamp_min(1e-7)


# ---------------------------------------------------------------------------
# NMS (host)
# ---------------------------------------------------------------------------

def batched_nms(boxes: np.ndarray, scores: np.ndarray, categories: Optional[np.ndarray] = None,
                iou_threshold: float = 0.7) -> np.ndarray:
    """Greedy box NMS, per category by offsetting the boxes of each category
    apart (torchvision ``batched_nms``). Returns the kept indices by
    descending score."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n = len(boxes)
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    if categories is not None:
        offsets = np.asarray(categories, dtype=np.float64) * (boxes.max() + 1.0)
        boxes = boxes + offsets[:, None]
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    suppressed = np.zeros(n, dtype=bool)
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(idx)
        xx1 = np.maximum(x1[idx], x1[order])
        yy1 = np.maximum(y1[idx], y1[order])
        xx2 = np.minimum(x2[idx], x2[order])
        yy2 = np.minimum(y2[idx], y2[order])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[idx] + areas[order] - inter, 1e-12)
        suppressed[order[iou > iou_threshold]] = True
        suppressed[idx] = False
    return np.asarray(keep, dtype=np.int64)


# ---------------------------------------------------------------------------
# Grids and crops
# ---------------------------------------------------------------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) xy point grid in the unit square."""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, ...], n_layers: int, overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """XYXY crop boxes of each layer of the crop pyramid; layer 0 is the whole image."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0, y0 in product(crop_box_x0, crop_box_y0):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return np.asarray(boxes) + np.array([[x0, y0, x0, y0]])


def uncrop_points(points, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return np.asarray(points) + np.array([[x0, y0]])


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = ((0, 0),) * (masks.ndim - 2) + ((y0, orig_h - y1), (x0, orig_w - x1))
    return np.pad(masks, pad)


def is_box_near_crop_edge(boxes, crop_box: List[int], orig_box: List[int],
                          atol: float = 20.0) -> np.ndarray:
    """Boxes that touch their crop's edge where it is not the image's edge."""
    crop_box_t = np.asarray(crop_box, dtype=np.float64)
    orig_box_t = np.asarray(orig_box, dtype=np.float64)
    boxes = np.asarray(uncrop_boxes_xyxy(boxes, crop_box), dtype=np.float64)
    near_crop_edge = np.isclose(boxes, crop_box_t[None], atol=atol, rtol=0)
    near_image_edge = np.isclose(boxes, orig_box_t[None], atol=atol, rtol=0)
    return np.any(near_crop_edge & ~near_image_edge, axis=1)


def box_xyxy_to_xywh(box_xyxy: np.ndarray) -> np.ndarray:
    box = np.asarray(box_xyxy).copy()
    box[..., 2] = box[..., 2] - box[..., 0]
    box[..., 3] = box[..., 3] - box[..., 1]
    return box


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size: (b + 1) * batch_size] for arg in args]


# ---------------------------------------------------------------------------
# RLE (uncompressed COCO layout: column-major, counts start with zeros)
# ---------------------------------------------------------------------------

def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Binary (H, W) mask -> {"size": [H, W], "counts": [...]}, column-major,
    the counts starting with the run of zeros."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=bool).T.flatten()
    if flat.size == 0:
        return {"size": [h, w], "counts": [0]}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def batched_mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """RLE records of a (N, H, W) batch, encoded by the native library."""
    from .. import native
    return native.compute_rle_batch(np.asarray(masks, dtype=bool))


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> binary (H, W) mask."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx: idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).T


def area_from_rle(rle: Dict[str, Any]) -> int:
    return int(sum(rle["counts"][1::2]))


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """The COCO string encoding of an uncompressed RLE (pycocotools' LEB128 variant)."""
    h, w = uncompressed_rle["size"]
    counts = [int(c) for c in uncompressed_rle["counts"]]
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return {"size": [h, w], "counts": out.decode("ascii")}


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str
                         ) -> Tuple[np.ndarray, bool]:
    """Remove small connected components ("islands") or fill small holes.
    Returns (mask, modified)."""
    from scipy import ndimage
    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working_mask = (correct_holes ^ np.asarray(mask, dtype=bool)).astype(np.uint8)
    labels, n_labels = ndimage.label(working_mask)
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n_labels + 1))
    small_regions = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if len(small_regions) == 0:
        return mask, False
    fill_labels = [0] + small_regions
    if not correct_holes:
        fill_labels = [i for i in range(n_labels + 1) if i not in fill_labels]
        if len(fill_labels) == 0:
            fill_labels = [int(np.argmax(sizes)) + 1]
    return np.isin(labels, fill_labels), True
