"""Automatic instance segmentation: by grid prompts (AMG), by the UNETR
decoder's maps and a seeded watershed (AIS), and by prompts derived from those
maps (APG); each untiled and tiled.

Counterpart of ``micro_sam_tpu/instance_segmentation.py``. Every segmenter
splits its work the same way: ``initialize(image, image_embeddings, i, ...)``
does the expensive part once, ``generate(**params)`` the cheap host
postprocessing that can be re-run with other thresholds.

- AMG: every batch of grid points is decoded and reduced on the predictor's
  device (``predictor.amg_decode``: stability scores, boxes, bit-packed masks,
  and the candidates under the prefilter floors dropped there); the survivors
  are copied to the host and run-length encoded by the native library;
  ``generate`` filters, runs NMS and paints.
- AIS: the decoder runs on the device over the installed embeddings, its
  maps are cropped and resized there and copied to the host once
  (``DecoderAdapter``); ``generate`` smooths them and floods the C++ seeded
  watershed from the thresholded distance maps.
- APG: the AIS maps give one point prompt per object core; ``generate``
  decodes them in batches (``batched_inference``) and runs mask NMS.
"""
from __future__ import annotations

import warnings
from abc import ABC
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import native, util
from .inference import batched_inference, batched_tiled_inference
from .models import unetr as unetr_mod
from .models.build_sam import resolve_device
from .models.convert import unetr_params_from_jax
from .ops import amg_utils
from .ops.amg_utils import MaskData, batched_nms
from .ops.host_ops import find_boundaries_outer, gaussian_smooth, regionprops
from .predictor import SamPredictor, amg_decode
from .utils.blocking import Blocking

DEFAULT_SEGMENTATION_MODE_WITH_DECODER = "ais"

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


#
# AIS: decoder-based instance segmentation
#

class DecoderAdapter:
    """The UNETR decoder over installed embeddings. ``__call__`` runs it on the
    decoder's device, crops and resizes its output there, and copies the
    (B, C, H, W) float32 maps to the host once."""

    def __init__(self, unetr: unetr_mod.UNETRDecoder):
        self.unetr = unetr.eval()

    @property
    def device(self) -> torch.device:
        return next(self.unetr.parameters()).device

    @torch.no_grad()
    def _forward_impl(self, features) -> torch.Tensor:
        """(B, h, w, C) NHWC or (B, C, h, w) NCHW features -> (B, out, 16h, 16w)
        on the device, in the features' dtype (numpy features: float32)."""
        f = features if torch.is_tensor(features) else torch.from_numpy(np.asarray(features))
        if f.dim() == 3:
            f = f[None]
        emb = self.unetr.embed_dim
        if not (f.shape[-1] != emb and f.shape[1] == emb):
            f = f.permute(0, 3, 1, 2)  # NHWC: a channels-last NCHW view, no copy
        return self.unetr(f.to(self.device))

    @torch.no_grad()
    def __call__(self, features, input_shape, original_shape) -> np.ndarray:
        """(B, C, *original_shape) float32 numpy maps."""
        out = self._forward_impl(features).float()
        out = unetr_mod.postprocess_decoder_output(out, tuple(input_shape), tuple(original_shape))
        return out.cpu().numpy()


def get_unetr(image_encoder=None, decoder_state=None, device=None, out_channels: int = 3,
              flexible_load_checkpoint: bool = False, final_activation="Sigmoid",
              embed_dim: int = 256, seed: int = 0) -> unetr_mod.UNETRDecoder:
    """The UNETR decoder on ``device`` (None: the GPU, raising without one).

    decoder_state: a torch_em UNETR state dict (a zoo ``*_decoder``
    checkpoint's), the JAX package's UNETR pytree (a native trainer
    checkpoint's), or None for random weights from ``seed``. The widths come
    from the state."""
    dev = resolve_device(device)
    if decoder_state is not None:
        model = _merge_decoder_state(decoder_state, flexible_load_checkpoint)
    else:
        model = unetr_mod.UNETRDecoder(embed_dim=embed_dim, out_channels=out_channels)
        model.init_(torch.Generator().manual_seed(seed))
    model.final_activation = final_activation is not None
    return model.to(dev).eval()


def _random_decoder() -> unetr_mod.UNETRDecoder:
    return unetr_mod.UNETRDecoder().init_(torch.Generator().manual_seed(0))


def _merge_decoder_state(decoder_state, flexible: bool) -> unetr_mod.UNETRDecoder:
    """A decoder holding a saved decoder state (on the CPU)."""
    if unetr_mod.is_torch_decoder_state(decoder_state):
        try:
            return unetr_mod.decoder_from_state(unetr_mod.clean_torch_em_state(decoder_state))
        except Exception as e:
            if flexible:
                warnings.warn(f"Decoder state conversion failed ({e}); keeping random "
                              "initialization.")
                return _random_decoder()
            raise
    if isinstance(decoder_state, dict) and "deconv1" in decoder_state:
        return unetr_mod.decoder_from_state(unetr_params_from_jax(decoder_state))
    if flexible:
        warnings.warn("Unrecognized decoder state format; keeping random initialization.")
        return _random_decoder()
    raise ValueError("Unrecognized decoder state format. Expected a torch_em UNETR state dict "
                     "or the JAX package's UNETR parameter tree.")


def get_decoder(image_encoder=None, decoder_state=None, device=None) -> DecoderAdapter:
    """The decoder that predicts the maps of automatic instance segmentation."""
    return DecoderAdapter(get_unetr(image_encoder, decoder_state, device))


def get_predictor_and_decoder(model_type: str, checkpoint_path=None, device=None,
                              peft_kwargs: Optional[Dict] = None
                              ) -> Tuple[SamPredictor, DecoderAdapter]:
    """SAM predictor and segmentation decoder from one checkpoint; with
    ``peft_kwargs`` the SAM of that PEFT surgery, its trained PEFT parameters
    loaded from the checkpoint."""
    predictor, state = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                          device=device, return_state=True,
                                          peft_kwargs=peft_kwargs)
    if "decoder_state" not in state:
        raise ValueError(f"The checkpoint at '{checkpoint_path}' or the chosen model "
                         f"'{model_type}' does not contain a decoder state")
    return predictor, get_decoder(None, state["decoder_state"], device)


def watershed_from_center_and_boundary_distances(
    center_distances: np.ndarray,
    boundary_distances: np.ndarray,
    foreground_map: np.ndarray,
    center_distance_threshold: float = 0.5,
    boundary_distance_threshold: float = 0.5,
    foreground_threshold: float = 0.5,
    distance_smoothing: float = 1.6,
    min_size: int = 0,
) -> np.ndarray:
    """Seeded watershed from thresholded distance maps: markers where both
    smoothed distances are under their thresholds inside the foreground,
    flooded over the smoothed boundary distance within the foreground."""
    from scipy import ndimage
    cd = gaussian_smooth(center_distances, distance_smoothing)
    bd = gaussian_smooth(boundary_distances, distance_smoothing)
    fg_mask = foreground_map > foreground_threshold
    markers, _ = ndimage.label((cd < center_distance_threshold)
                               & (bd < boundary_distance_threshold) & fg_mask)
    segmentation = native.seeded_watershed(bd.astype(np.float32), markers.astype(np.uint32),
                                           mask=fg_mask)
    if min_size > 0:
        segmentation = native.size_filter(segmentation, min_size=min_size)
    return segmentation.astype(np.uint32)


class InstanceSegmentationWithDecoder:
    """Decoder-based instance segmentation (AIS). The decoder predicts three
    maps (foreground probability, center distance, boundary distance):
    ``initialize`` computes them once, ``generate`` is a re-tunable watershed
    over them."""

    # decoder channel -> the attribute its map is stored under
    _MAP_ATTRS = ("_foreground", "_center_distances", "_boundary_distances")
    # state keys of the h5 / pickle cache layout
    _STATE_KEYS = ("foreground", "center_distances", "boundary_distances")

    def __init__(self, predictor: SamPredictor, decoder: DecoderAdapter) -> None:
        self._predictor = predictor
        self._decoder = decoder
        self._is_initialized = False
        self._store_maps(None)

    def _store_maps(self, maps) -> None:
        for channel, attr in enumerate(self._MAP_ATTRS):
            setattr(self, attr, None if maps is None else maps[channel])

    @property
    def is_initialized(self):
        return self._is_initialized

    def initialize(
        self,
        image: np.ndarray,
        image_embeddings=None,
        i: Optional[int] = None,
        verbose: bool = False,
        pbar_init=None,
        pbar_update=None,
        ndim: int = 2,
    ) -> None:
        """Compute the decoder's maps for ``image`` (encoding it unless its
        embeddings are given)."""
        pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)
        pbar_init(1, "Initialize instance segmentation with decoder")
        if image_embeddings is None:
            image_embeddings = util.precompute_image_embeddings(self._predictor, image, ndim=ndim,
                                                                verbose=verbose)
        self._predictor = util.set_precomputed(self._predictor, image_embeddings, i=i)
        maps = self._decoder(self._predictor.features, self._predictor.input_size,
                             self._predictor.original_size)[0]
        assert maps.shape[0] == len(self._MAP_ATTRS), maps.shape
        pbar_update(1)
        pbar_close()
        self._store_maps(maps)
        self._i = i
        self._is_initialized = True

    @staticmethod
    def _to_masks(segmentation, output_mode):
        """Label image -> binary-mask records (bbox as [x, w, y, h(, z, d)])."""
        if output_mode != "binary_mask":
            raise ValueError(f"Output mode {output_mode} is not supported. "
                             "Choose one of 'instance_segmentation', 'binary_mask'.")
        ndim = segmentation.ndim
        assert ndim in (2, 3)
        # the whole image as the crop box, innermost axis first: [0, W, 0, H(, 0, D)]
        crop_box = [v for size in segmentation.shape[::-1] for v in (0, size)]

        def record(prop):
            lo, hi = prop.bbox[:ndim], prop.bbox[ndim:]
            if ndim == 2:
                (y0, x0), (y1, x1) = lo, hi
                bbox = [x0, x1 - x0, y0, y1 - y0]
            else:
                (z0, y0, x0), (z1, y1, x1) = lo, hi
                # depth measured from y0, as the JAX package's record has it
                bbox = [x0, x1 - x0, y0, y1 - y0, z0, z1 - y0]
            return {"segmentation": segmentation == prop.label, "area": prop.area,
                    "bbox": bbox, "crop_box": crop_box, "seg_id": prop.label}

        return [record(prop) for prop in regionprops(segmentation)]

    def generate(
        self,
        center_distance_threshold: float = 0.5,
        boundary_distance_threshold: float = 0.5,
        foreground_threshold: float = 0.5,
        foreground_smoothing: float = 1.0,
        distance_smoothing: float = 1.6,
        min_size: int = 0,
        output_mode: str = "instance_segmentation",
        tile_shape: Optional[Tuple[int, int]] = None,
        halo: Optional[Tuple[int, int]] = None,
        n_threads: Optional[int] = None,
        optimize_memory: bool = False,
        segmentation: Optional[np.ndarray] = None,
    ) -> Union[List[Dict[str, Any]], np.ndarray]:
        """The watershed over the initialized maps (cheap, re-tunable)."""
        if not self.is_initialized:
            raise RuntimeError("InstanceSegmentationWithDecoder has not been initialized. "
                               "Call initialize first.")
        fg = self._foreground
        if foreground_smoothing > 0:
            fg = gaussian_smooth(fg, foreground_smoothing)
        segmentation = watershed_from_center_and_boundary_distances(
            self._center_distances, self._boundary_distances, fg,
            center_distance_threshold=center_distance_threshold,
            boundary_distance_threshold=boundary_distance_threshold,
            foreground_threshold=foreground_threshold, distance_smoothing=distance_smoothing,
            min_size=min_size)
        if output_mode != "instance_segmentation":
            segmentation = self._to_masks(segmentation, output_mode)
        return segmentation

    def get_state(self) -> Dict[str, Any]:
        if not self.is_initialized:
            raise RuntimeError("The state has not been computed yet. Call initialize first.")
        return {key: getattr(self, f"_{key}") for key in self._STATE_KEYS}

    def set_state(self, state: Dict[str, Any]) -> None:
        for key in self._STATE_KEYS:
            setattr(self, f"_{key}", state[key])
        self._is_initialized = True

    def clear_state(self):
        self._store_maps(None)
        self._is_initialized = False

    # shared by the APG classes: prompts derived from the maps
    def _derive_prompts(self, prompt_function, foreground_threshold, center_distance_threshold,
                        boundary_distance_threshold):
        derive = prompt_function or _derive_point_prompts
        return derive(self._foreground, self._center_distances, self._boundary_distances,
                      foreground_threshold=foreground_threshold,
                      center_distance_threshold=center_distance_threshold,
                      boundary_distance_threshold=boundary_distance_threshold)

    @staticmethod
    def _empty_result(shape, output_mode):
        if output_mode == "instance_segmentation":
            return np.zeros(shape, dtype="uint32")
        return []


class TiledInstanceSegmentationWithDecoder(InstanceSegmentationWithDecoder):
    """AIS over tiled embeddings: the decoder runs over ``batch_size`` tiles at
    a time, and each tile's inner block is pasted into full-size maps."""

    def _predict_decoder(self, batched_embeddings, input_shapes, original_shapes):
        """One decoder run over the tiles' features (on the device), then per
        tile the crop and resize there and one copy to the host."""
        output = self._decoder._forward_impl(torch.cat(list(batched_embeddings), dim=0)).float()
        out = []
        for k, (input_shape, original_shape) in enumerate(zip(input_shapes, original_shapes)):
            x = unetr_mod.postprocess_decoder_output(output[k:k + 1], input_shape, original_shape)
            out.append(x[0].cpu().numpy())
        return out

    def _decode_tile_batch(self, tile_ids, i):
        """Install each tile's embeddings, run the decoder over them batched,
        return the tiles' (3, h, w) maps."""
        feats, in_shapes, out_shapes = [], [], []
        for tile_id in tile_ids:
            self._predictor = util.set_precomputed(self._predictor, self._image_embeddings, i=i,
                                                   tile_id=int(tile_id))
            feats.append(self._predictor.features)
            in_shapes.append(tuple(self._predictor.input_size))
            out_shapes.append(tuple(self._predictor.original_size))
        return self._predict_decoder(feats, in_shapes, out_shapes)

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
        self._image_embeddings, tile_shape, halo, tiles_in_mask = _process_tiled_embeddings(
            self._predictor, image, image_embeddings, tile_shape, halo, verbose=verbose,
            batch_size=batch_size, mask=mask, i=i)
        tiling = Blocking([0, 0], original_size, tile_shape)
        tile_ids = (list(range(len(tiling))) if tiles_in_mask is None
                    else [int(t) for t in tiles_in_mask])

        pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)
        pbar_init(len(tile_ids), "Initialize tiled instance segmentation with decoder")
        # one full-size canvas per decoder channel; the inner blocks partition the image
        canvases = np.zeros((len(self._MAP_ATTRS),) + tuple(original_size), dtype="float32")
        n_batches = int(np.ceil(len(tile_ids) / batch_size))
        for chunk in np.array_split(tile_ids, n_batches):
            for tile_id, maps in zip(chunk, self._decode_tile_batch(chunk, i)):
                assert maps.shape[0] == len(self._MAP_ATTRS)
                block = tiling.get_block_with_halo(int(tile_id), list(halo))
                canvases[(slice(None),) + block.inner_block.slicing] = \
                    maps[(slice(None),) + block.inner_block_local.slicing]
                pbar_update(1)
        pbar_close()
        self._i = i
        self._store_maps(canvases)
        self._is_initialized = True


#
# APG: prompts derived from the decoder's maps, then NMS
#

def _get_centers(segmentation, avoid_image_border=True):
    """One interior point per object: the maximum of the distance to the
    object's outer boundary (and, by default, the image border) inside it."""
    interior = find_boundaries_outer(segmentation > 0) == 0
    if avoid_image_border:
        for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
            interior[edge] = False
    depth = native.distance_transform(interior)
    centers = []
    for prop in regionprops(segmentation):
        y0, x0, y1, x1 = prop.bbox
        window = np.s_[y0:y1, x0:x1]
        local_depth = np.where(segmentation[window] == prop.label, depth[window], 0)
        dy, dx = np.unravel_index(np.argmax(local_depth), local_depth.shape)
        centers.append((y0 + dy, x0 + dx))
    return np.array(centers) if centers else np.zeros((0, 2), dtype=np.int64)


def _derive_point_prompts(
    foreground: np.ndarray,
    center_distances: np.ndarray,
    boundary_distances: np.ndarray,
    foreground_threshold: float = 0.5,
    center_distance_threshold: float = 0.5,
    boundary_distance_threshold: float = 0.5,
):
    """Decoder maps -> one positive point per object core: the connected
    components of the low-distance foreground, each at its deepest point."""
    core = ((center_distances < center_distance_threshold)
            & (boundary_distances < boundary_distance_threshold)
            & (foreground >= foreground_threshold))
    centers_yx = _get_centers(native.label(core.astype(np.uint32)))
    if len(centers_yx) == 0:
        return None
    return {"points": centers_yx[:, None, ::-1].astype(np.float64),  # yx -> xy
            "point_labels": np.ones((len(centers_yx), 1))}


def _derive_box_prompts(predictions, box_extension, bbox_key="bbox", shape=None):
    """Slightly extended XYXY boxes around predicted masks, for a refinement
    round. ``bbox_key="global_bbox"`` reads the image-frame boxes of tiled
    predictions, with ``shape`` bounding the extension."""
    if shape is None:
        shape = predictions[0]["segmentation"].shape
    height, width = shape[:2]
    prompts = []
    for pred in predictions:
        x, y, w, h = pred[bbox_key]
        # x against the width, y against the height
        prompts.append([max(x - w * box_extension, 0), max(y - h * box_extension, 0),
                        min(x + (1 + box_extension) * w, width),
                        min(y + (1 + box_extension) * h, height)])
    return {"boxes": np.array(prompts)}


class AutomaticPromptGenerator(InstanceSegmentationWithDecoder):
    """Point prompts derived from the decoder's maps, decoded in batches, then
    mask NMS."""

    def generate(
        self,
        min_size: int = 25,
        center_distance_threshold: float = 0.5,
        boundary_distance_threshold: float = 0.5,
        foreground_threshold: float = 0.5,
        multimasking: bool = False,
        batch_size: int = 32,
        nms_threshold: float = 0.9,
        intersection_over_min: bool = False,
        output_mode: str = "instance_segmentation",
        mask_threshold: Optional[Union[float, str]] = None,
        refine_with_box_prompts: bool = False,
        prompt_function: Optional[callable] = None,
    ) -> Union[List[Dict[str, Any]], np.ndarray]:
        if not self.is_initialized:
            raise RuntimeError("AutomaticPromptGenerator has not been initialized. "
                               "Call initialize first.")
        prompts = self._derive_prompts(prompt_function, foreground_threshold,
                                       center_distance_threshold, boundary_distance_threshold)
        shape = self._foreground.shape
        if prompts is None:
            return self._empty_result(shape, output_mode)

        def decode(prompt_dict):
            return batched_inference(self._predictor, image=None, batch_size=batch_size,
                                     return_instance_segmentation=False,
                                     multimasking=multimasking, mask_threshold=mask_threshold,
                                     i=getattr(self, "_i", None), **prompt_dict)

        predictions = decode(prompts)
        if refine_with_box_prompts and len(predictions) > 0:
            # a second round from slightly extended boxes around the masks
            predictions = decode(_derive_box_prompts(predictions, box_extension=0.01))
        segmentation = util.apply_nms(predictions, min_size=min_size, nms_thresh=nms_threshold,
                                      intersection_over_min=intersection_over_min, shape=shape)
        if output_mode != "instance_segmentation":
            segmentation = self._to_masks(segmentation, output_mode)
        return segmentation


class TiledAutomaticPromptGenerator(TiledInstanceSegmentationWithDecoder):
    """APG over tiled embeddings: each prompt is decoded in the tile holding it."""

    def generate(
        self,
        min_size: int = 25,
        center_distance_threshold: float = 0.5,
        boundary_distance_threshold: float = 0.5,
        foreground_threshold: float = 0.5,
        multimasking: bool = False,
        batch_size: int = 32,
        nms_threshold: float = 0.9,
        intersection_over_min: bool = False,
        output_mode: str = "instance_segmentation",
        mask_threshold: Optional[Union[float, str]] = None,
        refine_with_box_prompts: bool = False,
        prompt_function: Optional[callable] = None,
        optimize_memory: bool = False,
    ) -> Union[List[Dict[str, Any]], np.ndarray]:
        if not self.is_initialized:
            raise RuntimeError("TiledAutomaticPromptGenerator has not been initialized. "
                               "Call initialize first.")
        if optimize_memory and (output_mode != "instance_segmentation" or refine_with_box_prompts):
            raise ValueError("Invalid settings")
        prompts = self._derive_prompts(prompt_function, foreground_threshold,
                                       center_distance_threshold, boundary_distance_threshold)
        shape = self._foreground.shape
        if prompts is None:
            return self._empty_result(shape, output_mode)

        def decode(prompt_dict, **extra):
            return batched_tiled_inference(
                self._predictor, image=None, batch_size=batch_size,
                image_embeddings=self._image_embeddings, return_instance_segmentation=False,
                multimasking=multimasking, i=getattr(self, "_i", None), **extra, **prompt_dict)

        if optimize_memory:
            # NMS per tile and stitching inside tiled inference: a finished label image
            prompts.update(min_size=min_size, nms_thresh=nms_threshold,
                           intersection_over_min=intersection_over_min)
            return decode(prompts, optimize_memory=True)

        predictions = decode(prompts)
        if refine_with_box_prompts and len(predictions) > 0:
            # the boxes in the image's frame, from each prediction's global_bbox,
            # routed through tiled inference again
            predictions = decode(_derive_box_prompts(predictions, box_extension=0.01,
                                                     bbox_key="global_bbox", shape=shape))
        segmentation = util.apply_nms(predictions, shape=shape, min_size=min_size,
                                      nms_thresh=nms_threshold,
                                      intersection_over_min=intersection_over_min)
        if output_mode != "instance_segmentation":
            segmentation = self._to_masks(segmentation, output_mode)
        return segmentation

    def get_state(self) -> Dict[str, Any]:
        """The maps, and the embeddings when they are held in memory (a lazily
        loaded cache leaves None: pass ``image_embeddings=`` to ``set_state``)."""
        state = super().get_state()
        feats = self._image_embeddings.get("features")
        in_memory = isinstance(feats, dict) and all(isinstance(v, dict) for v in feats.values())
        state["image_embeddings"] = self._image_embeddings if in_memory else None
        state["i"] = getattr(self, "_i", None)
        return state

    def set_state(self, state: Dict[str, Any], image_embeddings=None) -> None:
        emb = image_embeddings if image_embeddings is not None else state.get("image_embeddings")
        if emb is None:
            raise ValueError("This tiled APG state does not carry embeddings (they were "
                             "zarr-backed when saved); pass image_embeddings= to set_state.")
        super().set_state({k: state[k] for k in self._STATE_KEYS})
        self._image_embeddings = emb
        self._i = state.get("i")


def get_instance_segmentation_generator(
    predictor: SamPredictor,
    is_tiled: bool,
    decoder: Optional[DecoderAdapter] = None,
    segmentation_mode: Optional[str] = None,
    **kwargs,
):
    """The segmenter of a mode (amg / ais / apg), tiled or not; without a mode,
    AIS when a decoder is given, else AMG."""
    if segmentation_mode is None:
        segmentation_mode = "amg" if decoder is None else DEFAULT_SEGMENTATION_MODE_WITH_DECODER
    registry = {  # mode -> ((untiled class, tiled class), needs a decoder)
        "amg": ((AutomaticMaskGenerator, TiledAutomaticMaskGenerator), False),
        "ais": ((InstanceSegmentationWithDecoder, TiledInstanceSegmentationWithDecoder), True),
        "apg": ((AutomaticPromptGenerator, TiledAutomaticPromptGenerator), True),
    }
    try:
        (flat_cls, tiled_cls), needs_decoder = registry[segmentation_mode.lower()]
    except KeyError:
        raise ValueError(f"Invalid segmentation_mode: {segmentation_mode}. "
                         "Choose one of 'amg', 'ais', or 'apg'.") from None
    cls = tiled_cls if is_tiled else flat_cls
    if needs_decoder:
        if decoder is None:
            raise ValueError(f"segmentation_mode {segmentation_mode!r} needs a decoder.")
        return cls(predictor, decoder, **kwargs)
    return cls(predictor, **kwargs)
