"""Automatic instance segmentation by grid prompts (AMG), untiled and tiled.

Counterpart of the AMG half of ``micro_sam_tpu/instance_segmentation.py``.
``initialize(image, image_embeddings, i, ...)`` does the expensive part once:
every batch of grid points is decoded and reduced on the predictor's device
(``predictor.amg_decode``: stability scores, boxes, bit-packed masks, and the
candidates under the prefilter floors dropped there), its survivors are
copied to the host and run-length encoded by the native library.
``generate(**params)`` is the cheap host postprocessing (filters, NMS,
painting) that can be re-run with other thresholds.
"""
from __future__ import annotations

import warnings
from abc import ABC
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import native, util
from .ops import amg_utils
from .ops.amg_utils import MaskData, batched_nms
from .predictor import SamPredictor, amg_decode
from .utils.blocking import Blocking

MASK_THRESHOLD = 0.0


class _FakeInput:
    """A shape-only stand-in for an image whose embeddings are precomputed:
    slicing it gives zeros of the slice's extent."""

    def __init__(self, shape):
        self.shape = shape

    def __getitem__(self, index):
        return np.zeros(tuple(sl.stop - sl.start for sl in index), dtype="float32")


def _concat(parts: List[MaskData]) -> MaskData:
    """The columns of ``parts`` joined in order. ``MaskData.cat`` deep-copies
    what it appends; the parts here are fresh, so they are joined as they are."""
    if not parts:
        return MaskData()
    return MaskData(**{k: (sum((p[k] for p in parts), []) if isinstance(parts[0][k], list)
                           else np.concatenate([np.asarray(p[k]) for p in parts]))
                       for k in parts[0].keys()})


class AMGBase(ABC):
    """The state computed by ``initialize`` (mask data per crop) and the
    postprocessing ``generate`` shares."""

    _STATE_FIELDS = ("crop_list", "crop_boxes", "original_size")

    def __init__(self):
        self._is_initialized = False
        for field in self._STATE_FIELDS:
            setattr(self, f"_{field}", None)

    @property
    def is_initialized(self):
        return self._is_initialized

    @property
    def crop_list(self):
        return self._crop_list

    @property
    def crop_boxes(self):
        return self._crop_boxes

    @property
    def original_size(self):
        return self._original_size

    def _postprocess_batch(self, data, crop_box, original_size, pred_iou_thresh,
                           stability_score_thresh, box_nms_thresh):
        """The quality filters, then NMS within the crop, in upstream's order
        (iou -> stability -> crop edge -> NMS); then the coordinates out of
        the crop's frame."""
        orig_h, orig_w = original_size
        for field, threshold, op in (("iou_preds", pred_iou_thresh, np.greater),
                                     ("stability_score", stability_score_thresh,
                                      np.greater_equal)):
            if threshold > 0.0:
                data.filter(op(np.asarray(data[field]), threshold))

        at_crop_edge = amg_utils.is_box_near_crop_edge(data["boxes"], crop_box,
                                                       [0, 0, orig_w, orig_h])
        if at_crop_edge.any():
            data.filter(~at_crop_edge)

        data.filter(batched_nms(np.asarray(data["boxes"], dtype=np.float64),
                                np.asarray(data["iou_preds"]), None,
                                iou_threshold=box_nms_thresh))

        data["boxes"] = amg_utils.uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["crop_boxes"] = np.tile(np.asarray(crop_box)[None], (len(data["rles"]), 1))
        if "points" in data:
            data["points"] = amg_utils.uncrop_points(data["points"], crop_box)
        return data

    def _postprocess_small_regions(self, mask_data, min_area, nms_thresh):
        """Fill small holes and drop small islands of each mask, then NMS in
        which the untouched masks score 1 and the repaired ones 0."""
        if len(mask_data["rles"]) == 0:
            return mask_data

        def repair(rle):
            m = amg_utils.rle_to_mask(rle)
            m, filled = amg_utils.remove_small_regions(m, min_area, mode="holes")
            m, dropped = amg_utils.remove_small_regions(m, min_area, mode="islands")
            return m, filled or dropped

        repaired = [repair(rle) for rle in mask_data["rles"]]
        masks = np.stack([m for m, _ in repaired])
        was_touched = np.array([touched for _, touched in repaired])
        boxes = amg_utils.batched_mask_to_box(torch.from_numpy(masks)).numpy()

        survivors = batched_nms(boxes.astype(np.float64), (~was_touched).astype(np.float64),
                                None, iou_threshold=nms_thresh)
        for idx in survivors:
            if was_touched[idx]:
                mask_data["rles"][idx] = amg_utils.mask_to_rle(masks[idx])
                mask_data["boxes"][idx] = boxes[idx]
        mask_data.filter(survivors)
        return mask_data

    _SEGMENTATION_CODECS = {
        "coco_rle": amg_utils.coco_encode_rle,
        "rle": lambda rle: rle,
        "binary_mask": amg_utils.rle_to_mask,
        "instance_segmentation": amg_utils.rle_to_mask,
    }

    def _postprocess_masks(self, mask_data, min_mask_region_area, box_nms_thresh,
                           crop_nms_thresh, output_mode):
        if min_mask_region_area > 0:
            mask_data = self._postprocess_small_regions(
                mask_data, min_mask_region_area, max(box_nms_thresh, crop_nms_thresh))
        try:
            encode = self._SEGMENTATION_CODECS[output_mode]
        except KeyError:
            raise ValueError(f"Invalid output mode {output_mode}.") from None

        annotations = []
        for idx, rle in enumerate(mask_data["rles"]):
            record = {
                "segmentation": encode(rle),
                "area": amg_utils.area_from_rle(rle),
                "bbox": amg_utils.box_xyxy_to_xywh(mask_data["boxes"][idx]).tolist(),
                "predicted_iou": float(mask_data["iou_preds"][idx]),
                "stability_score": float(mask_data["stability_score"][idx]),
                "crop_box": amg_utils.box_xyxy_to_xywh(mask_data["crop_boxes"][idx]).tolist(),
            }
            if "points" in mask_data:
                record["point_coords"] = [mask_data["points"][idx].tolist()]
            annotations.append(record)
        return annotations

    def get_state(self) -> Dict[str, Any]:
        if not self.is_initialized:
            raise RuntimeError("The state has not been computed yet. Call initialize first.")
        state = {"crop_list": self.crop_list, "crop_boxes": self.crop_boxes,
                 "original_size": self.original_size}
        floors = getattr(self, "_prefilter_thresholds", None)
        if floors is not None:
            # the state holds only the candidates above the floors: a
            # generator restoring it enforces the same limit
            state["prefilter_thresholds"] = floors
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._crop_list = state["crop_list"]
        self._crop_boxes = state["crop_boxes"]
        self._original_size = state["original_size"]
        self._prefilter_thresholds = state.get("prefilter_thresholds")
        self._init_call = None  # restored state cannot redo the decode
        self._is_initialized = True

    def clear_state(self):
        self._crop_list = None
        self._crop_boxes = None
        self._original_size = None
        self._init_call = None
        self._is_initialized = False


class AutomaticMaskGenerator(AMGBase):
    """Automatic mask generation from a grid of point prompts: the decode in
    ``initialize``, the filtering in ``generate``."""

    #: the floors (predicted IoU, stability) under which candidates are
    #: dropped on the device in ``initialize``; below the usual grid-search
    #: range (0.6 and up), so the state serves every usual ``generate``
    DEFAULT_PREFILTER = (0.5, 0.5)

    def __init__(
        self,
        predictor: SamPredictor,
        points_per_side: Optional[int] = 32,
        points_per_batch: Optional[int] = None,
        crop_n_layers: int = 0,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        stability_score_offset: float = 1.0,
        prefilter_thresholds: Optional[Tuple[float, float]] = DEFAULT_PREFILTER,
    ):
        """prefilter_thresholds: (iou_floor, stability_floor), applied on the
        device during ``initialize``: only the candidates above them reach the
        host. A ``generate`` with thresholds below the floors lowers them and
        redoes the decode, with a warning (re-encoding the image if its
        embeddings were not given); after ``set_state`` it raises instead,
        since the dropped candidates are gone. ``None`` keeps every
        candidate."""
        super().__init__()
        self._predictor = predictor
        self._stability_score_offset = stability_score_offset
        self._prefilter_thresholds = (
            None if prefilter_thresholds is None
            else (float(prefilter_thresholds[0]), float(prefilter_thresholds[1])))
        self._points_per_side = points_per_side
        self._points_per_batch = points_per_batch or 64
        self._crop_n_layers = crop_n_layers
        self._crop_overlap_ratio = crop_overlap_ratio
        self._crop_n_points_downscale_factor = crop_n_points_downscale_factor
        if points_per_side is not None:
            self.point_grids = amg_utils.build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        elif point_grids is None:
            raise ValueError("Pass exactly one of points_per_side or point_grids.")
        else:
            self.point_grids = point_grids

    def _decode_batch(self, points, im_size) -> Dict[str, torch.Tensor]:
        """One batch of grid points through the device decode; the survivors
        stay on the device."""
        transformed = self._predictor.transform.apply_coords(points, im_size)
        return amg_decode(self._predictor, transformed, MASK_THRESHOLD,
                          self._stability_score_offset, self._prefilter_thresholds)

    def _batch_data(self, survivors: Dict[str, torch.Tensor], points, crop_box,
                    original_size) -> MaskData:
        """Copy one batch's survivors to the host and encode them: RLE records
        in the full image's frame, straight from the packed bits."""
        host = {k: v.cpu().numpy() for k, v in survivors.items()}
        orig_h, orig_w = original_size
        crop_h, crop_w = self._predictor.original_size
        n_channels = 3  # the multimask outputs
        data = MaskData(iou_preds=host["iou"])
        data["points"] = np.repeat(np.asarray(points), n_channels,
                                   axis=0)[host["order"]].astype(np.float64)
        data["stability_score"] = host["stability"]
        data["boxes"] = host["boxes"]  # in the crop's frame until _postprocess_batch
        if list(crop_box) == [0, 0, orig_w, orig_h]:
            data["rles"] = native.rle_from_packed(host["packed"], crop_h, crop_w)
        else:
            origins = np.tile([[int(crop_box[0]), int(crop_box[1])]], (len(host["packed"]), 1))
            data["rles"] = native.rle_from_packed_cropped(host["packed"], origins,
                                                          (crop_h, crop_w), orig_h, orig_w)
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx, precomputed_embeddings,
                      pbar_init=None, pbar_update=None):
        """Decode the point grid of one crop, batch by batch."""
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1, :]
        crop_hw = crop.shape[:2]
        if not precomputed_embeddings:
            self._predictor.set_image(crop)

        # the grid is in the unit square: scale it to the crop's pixels (xy)
        grid_xy = self.point_grids[crop_layer_idx] * np.array(crop_hw)[None, ::-1]
        batches = [pts for (pts,) in amg_utils.batch_iterator(self._points_per_batch, grid_xy)]
        if pbar_init is not None:
            pbar_init(len(batches), "Predict masks for point grid prompts")
        parts = []
        for points in batches:
            parts.append(self._batch_data(self._decode_batch(points, crop_hw), points, crop_box,
                                          self.original_size))
            if pbar_update is not None:
                pbar_update(1)
        if not precomputed_embeddings:
            self._predictor.reset_image()
        return _concat(parts)

    def initialize(
        self,
        image: np.ndarray,
        image_embeddings=None,
        i: Optional[int] = None,
        verbose: bool = False,
        pbar_init=None,
        pbar_update=None,
    ) -> None:
        """Compute the mask data of the point grid (the expensive part)."""
        # kept so that generate can redo the decode under lower floors
        self._init_call = ((image,), dict(image_embeddings=image_embeddings, i=i,
                                          verbose=verbose))
        self._original_size = image.shape[:2]
        crop_boxes, layer_idxs = amg_utils.generate_crop_boxes(
            self._original_size, self._crop_n_layers, self._crop_overlap_ratio)

        # one crop: the precomputed embeddings serve; a crop pyramid encodes each crop
        single_crop = len(crop_boxes) == 1
        if single_crop:
            if image_embeddings is None:
                image_embeddings = util.precompute_image_embeddings(self._predictor, image,
                                                                    verbose=verbose)
            util.set_precomputed(self._predictor, image_embeddings, i=i)

        image = util._to_image(image)
        pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)
        self._crop_list = [
            self._process_crop(image, crop_box, layer_idx, precomputed_embeddings=single_crop,
                               pbar_init=pbar_init, pbar_update=pbar_update)
            for crop_box, layer_idx in zip(crop_boxes, layer_idxs)]
        pbar_close()
        self._crop_boxes = crop_boxes
        self._is_initialized = True

    def generate(
        self,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        box_nms_thresh: float = 0.7,
        crop_nms_thresh: float = 0.7,
        min_mask_region_area: int = 0,
        output_mode: str = "instance_segmentation",
        with_background: bool = True,
    ) -> Union[List[Dict[str, Any]], np.ndarray]:
        """Filter, NMS and merge the initialized mask data (cheap)."""
        if not self.is_initialized:
            raise RuntimeError(
                "AutomaticMaskGenerator has not been initialized. Call initialize first.")
        floors = getattr(self, "_prefilter_thresholds", None)
        if floors is not None and (pred_iou_thresh < floors[0]
                                   or stability_score_thresh < floors[1]):
            init_call = getattr(self, "_init_call", None)
            if init_call is None:
                raise ValueError(
                    f"generate thresholds ({pred_iou_thresh}, {stability_score_thresh}) are below "
                    f"the device-side prefilter floors {floors}: candidates under the floors were "
                    "never transferred. Re-initialize with prefilter_thresholds=None (or lower "
                    "floors) to generate at these thresholds.")
            warnings.warn(
                f"generate thresholds ({pred_iou_thresh}, {stability_score_thresh}) are below the "
                f"device prefilter floors {floors}; re-running the device decode with lowered "
                "floors (this re-encodes the image if embeddings were not precomputed). "
                "Construct with prefilter_thresholds=None to avoid the redo.")
            self._prefilter_thresholds = (min(floors[0], float(pred_iou_thresh)),
                                          min(floors[1], float(stability_score_thresh)))
            args, kwargs = init_call
            self.initialize(*args, **kwargs)

        # each crop's state through a shallow copy: the filters replace its
        # columns and never change the state's
        data = _concat([self._postprocess_batch(
            data=MaskData(**dict(per_crop.items())), crop_box=crop_box,
            original_size=self.original_size, pred_iou_thresh=pred_iou_thresh,
            stability_score_thresh=stability_score_thresh, box_nms_thresh=box_nms_thresh)
            for per_crop, crop_box in zip(self.crop_list, self.crop_boxes)])

        if len(self.crop_boxes) > 1 and len(data["crop_boxes"]) > 0:
            # NMS across crops, scored by inverse crop area: the smaller
            # (higher-resolution) crops win
            cb = np.asarray(data["crop_boxes"], dtype=np.float64)
            crop_area = np.prod(cb[:, 2:] - cb[:, :2], axis=1)
            data.filter(batched_nms(np.asarray(data["boxes"], dtype=np.float64),
                                    1.0 / np.maximum(crop_area, 1), None,
                                    iou_threshold=crop_nms_thresh))

        data.to_numpy()
        masks = self._postprocess_masks(data, min_mask_region_area, box_nms_thresh,
                                        crop_nms_thresh, output_mode)
        if output_mode == "instance_segmentation":
            shape = masks[0]["segmentation"].shape if masks else self.original_size
            masks = util.mask_data_to_segmentation(masks, shape=shape,
                                                   with_background=with_background,
                                                   merge_exclusively=False)
        return masks


def _process_tiled_embeddings(predictor, image, image_embeddings, tile_shape, halo, verbose,
                              batch_size, mask, i):
    """Compute tiled embeddings or take the given ones, and reconcile the
    tiling. Returns (embeddings, tile_shape, halo, tile ids present or None
    when every tile of the grid is)."""
    if image_embeddings is None:
        if tile_shape is None or halo is None:
            raise ValueError(
                "To compute tiled embeddings the parameters tile_shape and halo have to be passed.")
        image_embeddings = util.precompute_image_embeddings(
            predictor, image, tile_shape=tile_shape, halo=halo, verbose=verbose,
            batch_size=batch_size, mask=mask)

    for param_name, requested in (("tile_shape", tile_shape), ("halo", halo)):
        stored = tuple(image_embeddings[param_name])
        if requested is not None and tuple(requested) != stored:
            raise ValueError(f"Inconsistent {param_name} parameter {tuple(requested)} "
                             f"with precomputed embeddings: {stored}.")
    tile_shape = tuple(image_embeddings["tile_shape"])
    halo = tuple(image_embeddings["halo"])

    present = sorted(int(k) for k in image_embeddings["features"].keys())
    grid = Blocking([0, 0], tuple(image_embeddings["shape"])[-2:], tile_shape)
    return image_embeddings, tile_shape, halo, None if len(present) == len(grid) else present


class TiledAutomaticMaskGenerator(AutomaticMaskGenerator):
    """AMG over tiled embeddings: each tile, with its halo, is a crop."""

    def __init__(
        self,
        predictor: SamPredictor,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        point_grids: Optional[List[np.ndarray]] = None,
        stability_score_offset: float = 1.0,
        prefilter_thresholds: Optional[Tuple[float, float]] =
            AutomaticMaskGenerator.DEFAULT_PREFILTER,
    ) -> None:
        super().__init__(predictor, points_per_side, points_per_batch, point_grids=point_grids,
                         stability_score_offset=stability_score_offset,
                         prefilter_thresholds=prefilter_thresholds)

    def initialize(
        self,
        image: np.ndarray,
        image_embeddings=None,
        i: Optional[int] = None,
        tile_shape: Optional[Tuple[int, int]] = None,
        halo: Optional[Tuple[int, int]] = None,
        verbose: bool = False,
        pbar_init=None,
        pbar_update=None,
        batch_size: int = 1,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        original_size = image.shape[:2]
        self._original_size = original_size
        self._init_call = ((image,), dict(image_embeddings=image_embeddings, i=i,
                                          tile_shape=tile_shape, halo=halo, verbose=verbose,
                                          batch_size=batch_size, mask=mask))
        self._image_embeddings, tile_shape, halo, tiles_in_mask = _process_tiled_embeddings(
            self._predictor, image, image_embeddings, tile_shape, halo, verbose=verbose,
            batch_size=batch_size, mask=mask, i=i)

        tiling = Blocking([0, 0], original_size, tile_shape)
        tile_ids = list(range(len(tiling))) if tiles_in_mask is None else \
            [int(t) for t in tiles_in_mask]
        tiles = [tiling.get_block_with_halo(tid, list(halo)).outer_block for tid in tile_ids]
        crop_boxes = [[t.begin[1], t.begin[0], t.end[1], t.end[0]] for t in tiles]

        pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)
        pbar_init(len(tile_ids), "Compute masks for tile")
        image = util._to_image(image)
        mask_data = []
        for crop_box, tile_id in zip(crop_boxes, tile_ids):
            util.set_precomputed(self._predictor, self._image_embeddings, i, tile_id=tile_id)
            mask_data.append(self._process_crop(image, crop_box=crop_box, crop_layer_idx=0,
                                                precomputed_embeddings=True))
            pbar_update(1)
        pbar_close()
        self._is_initialized = True
        self._crop_list = mask_data
        self._crop_boxes = crop_boxes
