"""Batched prompt inference, flat and tiled.

Counterpart of ``micro_sam_tpu/inference.py``: many point / box prompts
against one embedding set. Each batch of prompts is one decode on the
predictor's device; the threshold, stability scores and boxes are computed
there too, and only the binary masks and the numbers come to the host.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from . import util
from .ops import amg_utils
from .ops.amg_utils import MaskData
from .predictor import SamPredictor
from .utils.blocking import Blocking


@dataclass
class _PromptSet:
    """One validated bundle of prompts, sliceable into decode batches."""
    boxes: Optional[np.ndarray]
    points: Optional[np.ndarray]
    labels: Optional[np.ndarray]
    logits: Optional[np.ndarray]

    def __len__(self) -> int:
        for arr in (self.boxes, self.points):
            if arr is not None:
                return len(arr)
        return 0

    def __getitem__(self, sl) -> "_PromptSet":
        pick = lambda a: None if a is None else a[sl]  # noqa: E731
        return _PromptSet(pick(self.boxes), pick(self.points), pick(self.labels),
                          pick(self.logits))

    def batches(self, batch_size: int) -> Iterator["_PromptSet"]:
        for start in range(0, len(self), batch_size):
            yield self[start:start + batch_size]


def _checked_prompt_set(boxes, points, point_labels, logits_masks,
                        segmentation_ids=None) -> _PromptSet:
    """Validate the combination of prompts (every mismatch is a ValueError) and wrap it."""
    if (points is None) is not (point_labels is None):
        raise ValueError("Point prompts need `points` and `point_labels` together; "
                         "got exactly one of them.")
    if points is None and boxes is None:
        raise ValueError("No prompts: pass `boxes` and/or `points`.")
    counts = {name: len(arr) for name, arr in (
        ("boxes", boxes), ("points", points), ("point_labels", point_labels),
        ("logits_masks", logits_masks), ("segmentation_ids", segmentation_ids),
    ) if arr is not None}
    if len(set(counts.values())) > 1:
        detail = ", ".join(f"{k}={v}" for k, v in counts.items())
        raise ValueError(f"Prompt inputs disagree in length: {detail}.")
    return _PromptSet(boxes, points, point_labels, logits_masks)


def _local_otsu_threshold(images: np.ndarray, window_size: int = 31, num_bins: int = 64,
                          eps: float = 1e-6) -> np.ndarray:
    """The automatic mask threshold: the largest of the local (windowed) Otsu
    thresholds of each image (host numpy). images: (B, [1,] H, W) -> (B, 1, 1)."""
    x = np.asarray(images, dtype=np.float32)
    if x.ndim == 4:
        x = x[:, 0]
    B, H, W = x.shape
    thresholds = np.zeros((B, 1, 1), dtype=np.float32)
    pad = window_size // 2
    for b in range(B):
        img = x[b]
        mn, mx = img.min(), img.max()
        rng = max(mx - mn, eps)
        norm = (img - mn) / rng
        bins = np.clip((norm * (num_bins - 1)).astype(np.int32), 0, num_bins - 1)
        padded = np.pad(bins, pad, mode="constant", constant_values=0)
        windows = np.lib.stride_tricks.sliding_window_view(padded, (window_size, window_size))
        wf = windows.reshape(H * W, -1)
        hist = np.zeros((H * W, num_bins), dtype=np.float32)
        rows = np.repeat(np.arange(H * W), wf.shape[1])
        np.add.at(hist, (rows, wf.ravel()), 1.0)
        p = hist / np.maximum(hist.sum(axis=1, keepdims=True), eps)
        bvals = np.arange(num_bins, dtype=np.float32)[None]
        omega1 = np.cumsum(p, axis=1)
        mu = np.cumsum(p * bvals, axis=1)
        mu_T = mu[:, -1:]
        omega2 = 1.0 - omega1
        mu1 = mu / np.maximum(omega1, eps)
        mu2 = (mu_T - mu) / np.maximum(omega2, eps)
        sigma_b2 = omega1 * omega2 * (mu1 - mu2) ** 2
        t_bin = np.argmax(sigma_b2, axis=1)
        t_norm = t_bin.astype(np.float32) / (num_bins - 1)
        thresholds[b, 0, 0] = np.clip(mn + t_norm * rng, 0.0, None).max()
    return thresholds


def _decode_one_batch(predictor: SamPredictor, chunk: _PromptSet, multimasking: bool,
                      reduce_multimasking: bool):
    """Decode one chunk of prompts on the device; optionally keep only the
    best of the multimask outputs."""
    logit_masks, ious, lowres = predictor.predict_torch(
        point_coords=chunk.points, point_labels=chunk.labels, box=chunk.boxes,
        mask_input=chunk.logits, multimask_output=multimasking)
    if multimasking and reduce_multimasking:
        rows = torch.arange(logit_masks.shape[0], device=logit_masks.device)
        best = ious.argmax(dim=1)
        logit_masks = logit_masks[rows, best][:, None]
        ious = ious[rows, best][:, None]
        lowres = lowres[rows, best][:, None]
    return logit_masks, ious, lowres


def _reduce_to_mask_data(logit_masks: torch.Tensor, ious: torch.Tensor, lowres: torch.Tensor,
                         return_highres_logits: bool, mask_threshold) -> MaskData:
    """Threshold the logits and compute the stability scores and boxes on the
    device, then copy to the host. ``mask_threshold="auto"`` takes a
    threshold per image from local Otsu thresholds of its low-res logits, and
    the stability is measured around it."""
    flat = logit_masks.reshape((-1,) + tuple(logit_masks.shape[-2:]))
    if mask_threshold == "auto":
        thr = torch.from_numpy(_local_otsu_threshold(lowres.cpu().numpy())).to(
            flat.device).reshape(-1, 1, 1)
        n_above = (flat > (thr + 1.0)).sum(dim=(-2, -1))
        n_below = (flat > (thr - 1.0)).sum(dim=(-2, -1))
        stability = n_above.float() / n_below.float().clamp_min(1e-7)
    else:
        thr = float(mask_threshold)
        stability = amg_utils.calculate_stability_score(flat, thr, 1.0)
    masks = flat > thr
    boxes = amg_utils.batched_mask_to_box(masks)
    out = MaskData(masks=masks.cpu().numpy(), iou_preds=ious.reshape(-1).cpu().numpy())
    out["logits"] = (logit_masks if return_highres_logits else lowres).cpu().numpy()
    out["stability_scores"] = stability.cpu().numpy()
    out["boxes"] = boxes.cpu().numpy()
    return out


def _mask_records(masks: MaskData, segmentation_ids) -> List[Dict[str, Any]]:
    """MaskData -> the list-of-dict mask records."""
    records = []
    for idx, seg in enumerate(masks["masks"]):
        records.append({
            "segmentation": seg,
            "area": int(seg.sum()),
            "bbox": amg_utils.box_xyxy_to_xywh(masks["boxes"][idx]).tolist(),
            "predicted_iou": float(masks["iou_preds"][idx]),
            "stability_score": float(masks["stability_scores"][idx]),
            "seg_id": idx + 1 if segmentation_ids is None else int(segmentation_ids[idx]),
            "logits": masks["logits"][idx],
        })
    return records


def batched_inference(
    predictor: SamPredictor,
    image: Optional[np.ndarray],
    batch_size: int,
    boxes: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
    point_labels: Optional[np.ndarray] = None,
    multimasking: bool = False,
    embedding_path: Optional[Union[str, os.PathLike]] = None,
    return_instance_segmentation: bool = True,
    segmentation_ids: Optional[list] = None,
    reduce_multimasking: bool = True,
    logits_masks: Optional[np.ndarray] = None,
    verbose_embeddings: bool = True,
    mask_threshold: Optional[Union[float, str]] = None,
    return_highres_logits: bool = False,
    i: Optional[int] = None,
) -> Union[List[Dict[str, Any]], np.ndarray]:
    """Segment many prompts against one image, ``batch_size`` prompts a decode.

    boxes: (N, 4) XYXY in original image coordinates; points: (N, 1, 2) xy;
    point_labels: (N, 1); logits_masks: (N, 1, 256, 256). Returns an instance
    segmentation, or the mask records."""
    if multimasking and segmentation_ids is not None and not return_instance_segmentation:
        raise NotImplementedError
    prompts = _checked_prompt_set(boxes, points, point_labels, logits_masks, segmentation_ids)

    if image is None:
        predictor.get_image_embedding()  # raises if no embeddings are installed
    else:
        target = image if i is None else image[i]
        emb = util.precompute_image_embeddings(predictor, target, embedding_path,
                                               verbose=verbose_embeddings)
        util.set_precomputed(predictor, emb)

    thr = 0.0 if mask_threshold is None else mask_threshold
    collected = MaskData()
    for chunk in prompts.batches(batch_size):
        decoded = _decode_one_batch(predictor, chunk, multimasking, reduce_multimasking)
        collected.cat(_reduce_to_mask_data(*decoded, return_highres_logits, thr))

    records = _mask_records(collected, segmentation_ids)
    if return_instance_segmentation:
        return util.mask_data_to_segmentation(records, min_object_size=0)
    return records


def _require_tiled_embeddings(predictor, image, image_embeddings, embedding_path, tile_shape,
                              halo, verbose_embeddings):
    """Compute tiled embeddings, or check the given ones against the
    requested tile_shape / halo."""
    if image_embeddings is None:
        assert image is not None
        assert (tile_shape is not None) and (halo is not None)
        image_embeddings = util.precompute_image_embeddings(
            predictor, image, embedding_path, ndim=2, tile_shape=tile_shape, halo=halo,
            verbose=verbose_embeddings)
    shape = tuple(image_embeddings["shape"])
    for name, wanted, stored in (("tile_shape", tile_shape, image_embeddings["tile_shape"]),
                                 ("halo", halo, image_embeddings["halo"])):
        if wanted is not None and tuple(wanted) != tuple(stored):
            raise ValueError(f"Incompatible {name}: {tuple(wanted)} != {tuple(stored)}")
    return (image_embeddings, shape, tuple(image_embeddings["tile_shape"]),
            tuple(image_embeddings["halo"]))


def _tile_frame(tiling: Blocking, tile_id: int, halo):
    """(yx offset, shape) of a tile with its halo."""
    outer = tiling.get_block_with_halo(tile_id, list(halo)).outer_block
    return np.asarray(outer.begin), tuple(outer.shape)


def _route_prompts_to_tiles(prompts: _PromptSet, tiling: Blocking, halo) -> Dict[int, _PromptSet]:
    """Split prompts in image coordinates into a prompt set per tile.

    A prompt goes to the tile holding its box's centre or its (first) point,
    shifted into that tile's halo frame; a box and a point of one prompt must
    fall in the same tile."""
    per_tile: Dict[int, Dict[str, list]] = {}

    def bucket(tile_id):
        return per_tile.setdefault(tile_id, {"boxes": [], "points": [], "labels": []})

    for k in range(len(prompts)):
        tid = None
        if prompts.boxes is not None:
            x0, y0, x1, y1 = prompts.boxes[k]
            cy, cx = int(round((y0 + y1) / 2)), int(round((x0 + x1) / 2))
            tid = tiling.coordinates_to_block_id([cy, cx])
            off, tshape = _tile_frame(tiling, tid, halo)
            bucket(tid)["boxes"].append([
                max(x0 - off[1], 0), max(y0 - off[0], 0),
                min(x1 - off[1], tshape[1]), min(y1 - off[0], tshape[0])])
        if prompts.points is not None:
            pt_xy = prompts.points[k, 0]
            point_tid = tiling.coordinates_to_block_id([int(round(pt_xy[1])), int(round(pt_xy[0]))])
            if tid is None:
                tid = point_tid
            else:
                assert tid == point_tid, "box and point of one prompt disagree on the tile"
            off, _ = _tile_frame(tiling, tid, halo)
            bucket(tid)["points"].append(pt_xy - off[::-1])
            bucket(tid)["labels"].append(prompts.labels[k])

    return {tid: _PromptSet(
        boxes=np.asarray(e["boxes"], dtype="float64") if e["boxes"] else None,
        points=np.asarray(e["points"], dtype="float64")[:, None] if e["points"] else None,
        labels=np.asarray(e["labels"]) if e["labels"] else None,
        logits=None) for tid, e in per_tile.items()}


def _suppress_covered_objects(this_seg, prev_seg, overlap_threshold=0.75):
    """Drop the new objects mostly covered by the existing segmentation, then
    paint the existing objects back on top (where two tiles overlap)."""
    from . import native
    ov = native.overlap(this_seg, prev_seg)
    for seg_id in np.unique(this_seg):
        if seg_id == 0:
            continue
        other_ids, fractions = ov.overlapArraysNormalized(int(seg_id), True)
        fractions = fractions[other_ids != 0]
        if fractions.size and fractions[0] > overlap_threshold:
            this_seg[this_seg == seg_id] = 0
    keep = prev_seg != 0
    this_seg[keep] = prev_seg[keep]
    return this_seg


def _stitch_segmentation(masks, tile_ids, tiling: Blocking, halo, output_shape, verbose=False):
    assert len(masks) == len(tile_ids)
    segmentation = np.zeros(output_shape, dtype="uint32")
    for n, (tile_id, this_seg) in enumerate(zip(tile_ids, masks)):
        bb = tiling.get_block_with_halo(tile_id, list(halo)).outer_block.slicing
        segmentation[bb] = this_seg if n == 0 else \
            _suppress_covered_objects(this_seg, segmentation[bb])
    return segmentation


def batched_tiled_inference(
    predictor: SamPredictor,
    image: Optional[np.ndarray],
    batch_size: int,
    image_embeddings=None,
    boxes: Optional[np.ndarray] = None,
    points: Optional[np.ndarray] = None,
    point_labels: Optional[np.ndarray] = None,
    multimasking: bool = False,
    embedding_path: Optional[Union[str, os.PathLike]] = None,
    return_instance_segmentation: bool = True,
    reduce_multimasking: bool = True,
    logits_masks=None,
    verbose_embeddings: bool = True,
    mask_threshold: Optional[Union[float, str]] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    optimize_memory: bool = False,
    i: Optional[int] = None,
    **nms_kwargs,
) -> Union[List[Dict[str, Any]], np.ndarray]:
    """``batched_inference`` over tiled embeddings: each prompt is decoded in
    the tile that holds it. ``optimize_memory`` runs NMS per tile
    (``nms_kwargs`` go to ``util.apply_nms``) and stitches the tiles' label
    images instead of keeping every tile's mask records."""
    prompts = _checked_prompt_set(boxes, points, point_labels, logits_masks)
    if prompts.logits is not None:
        raise NotImplementedError

    image_embeddings, shape, tile_shape, halo = _require_tiled_embeddings(
        predictor, image, image_embeddings, embedding_path, tile_shape, halo, verbose_embeddings)
    tiling = Blocking([0, 0], shape, tile_shape)
    routed = _route_prompts_to_tiles(prompts, tiling, halo)

    collected: List = []
    stitched_segs: List[np.ndarray] = []
    id_offset = 0
    tile_order = sorted(routed)
    for tile_id in tile_order:
        tile_prompts = routed[tile_id]
        predictor = util.set_precomputed(predictor, image_embeddings, tile_id=tile_id, i=i)
        tile_masks = batched_inference(
            predictor=predictor, image=None, batch_size=batch_size, boxes=tile_prompts.boxes,
            points=tile_prompts.points, point_labels=tile_prompts.labels,
            multimasking=multimasking, return_instance_segmentation=False,
            reduce_multimasking=reduce_multimasking, mask_threshold=mask_threshold)
        if optimize_memory:
            seg = util.apply_nms(tile_masks, **nms_kwargs)
            seg[seg != 0] += id_offset
            id_offset = seg.max()
            stitched_segs.append(seg)
        else:
            off, _ = _tile_frame(tiling, tile_id, halo)
            shift = np.array([off[1], off[0], 0, 0])
            for mask in tile_masks:
                mask["global_bbox"] = (np.array(mask["bbox"]) + shift).tolist()
            collected.extend(tile_masks)

    if optimize_memory:
        return _stitch_segmentation(stitched_segs, tile_order, tiling, halo, output_shape=shape)
    if return_instance_segmentation:
        return util.mask_data_to_segmentation(collected, shape=shape, min_object_size=0)
    return collected
