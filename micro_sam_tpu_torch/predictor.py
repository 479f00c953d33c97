"""SamPredictor: the interactive inference interface.

Counterpart of ``micro_sam_tpu/predictor.py`` (``segment_anything.SamPredictor``
semantics). Features are kept as (1, 64, 64, 256) NHWC on the model's device;
the embedding cache stores them NCHW. Prompts are packed as upstream SAM packs
them: boxes become two points with labels 2 / 3, and one padding point (label
-1) is appended only when there is no box. No further padding is added: every
padding token takes part in the two-way transformer's attention and changes
the result.

On a mesh (``SamPredictor(sam, mesh=)``, ``shard_on_mesh``; ``parallel/mesh.py``)
the encoder's blocks are split over the model axis, and every encode, prompt
and AMG batch is padded to a multiple of the data axis (repeating its last
element, as the JAX package pads) and split over the data ranks: each encodes
or decodes its contiguous slice, and the slices are all-gathered, so every
rank holds the whole result. Every rank of the mesh makes the same calls.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .models.sam import MASK_THRESHOLD, Sam, postprocess_masks, preprocess
from .ops.amg_utils import batched_mask_to_box, calculate_stability_score
from .utils.transforms import ResizeLongestSide, get_preprocess_shape


class SamPredictor:
    def __init__(self, sam: Sam, mesh=None):
        self.model = sam
        self.device = next(sam.parameters()).device
        self.transform = ResizeLongestSide(sam.config.img_size)
        self.model_type: str = sam.config.model_type
        self.model_name: Optional[str] = None
        self._hash: Optional[str] = None
        self.reset_image()
        self.mesh = None
        self.batch_multiple = 1  # encode / decode batches pad to a multiple of this
        if mesh is not None:
            self.shard_on_mesh(mesh)

    def shard_on_mesh(self, mesh) -> "SamPredictor":
        """Run this predictor on ``mesh`` (``parallel.mesh.make_mesh``): the
        encoder's blocks split over its model axis (``shard_sam_``, in place),
        every encode and decode batch over its data axis. The model must be on
        the mesh's device."""
        from .parallel.mesh import shard_sam_
        if self.mesh is not None:
            raise ValueError("this predictor is already on a mesh")
        if self.device != mesh.device:
            raise ValueError(f"the model is on {self.device}, the mesh's rank on {mesh.device}")
        shard_sam_(self.model, mesh)
        self.mesh = mesh
        self.batch_multiple = int(mesh.shape["data"])
        return self

    def _pad_batch(self, *arrays):
        """Pad dim 0 of every array to a multiple of ``batch_multiple``,
        repeating the last element; returns (*padded, true_n)."""
        n = arrays[0].shape[0]
        r = (-n) % self.batch_multiple
        if r == 0:
            return (*arrays, n)
        return (*(np.concatenate([a, np.repeat(a[-1:], r, axis=0)]) for a in arrays), n)

    def _data_slice(self, n: int) -> slice:
        """This data rank's contiguous share of a padded batch of ``n``."""
        per = n // self.batch_multiple
        i = self.mesh.data_index
        return slice(i * per, (i + 1) * per)

    # ------------------------------------------------------------------
    # image side
    # ------------------------------------------------------------------
    def reset_image(self) -> None:
        self.is_image_set = False
        self.features: Optional[torch.Tensor] = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    @torch.no_grad()
    def encode_batch(self, batch: np.ndarray) -> torch.Tensor:
        """(B, h, w, 3) resized pixels -> (B, 64, 64, 256) embeddings on the
        device; on a mesh each data rank encodes its slice of the padded batch
        and the slices are all-gathered."""
        with tracing.span("encode_batch", images=len(batch)):
            with tracing.span("encode_batch.cast") as cast:
                made = np.asarray(batch, dtype=np.float32)
                cast.count(bytes=0 if made is batch else made.nbytes)
            if self.mesh is None:
                with tracing.span("encode_batch.copy_in", bytes=made.nbytes):
                    x = torch.as_tensor(made, device=self.device)
                with tracing.span("encode_batch.launch"):
                    return self.model.encode_image(preprocess(x, self.model.config.img_size))
            from .parallel.mesh import all_gather_cat
            made, n = self._pad_batch(made)
            part = made[self._data_slice(len(made))]
            with tracing.span("encode_batch.copy_in", bytes=part.nbytes):
                x = torch.as_tensor(part, device=self.device)
            with tracing.span("encode_batch.launch"):
                feats = self.model.encode_image(preprocess(x, self.model.config.img_size))
                return all_gather_cat(feats, self.mesh.data_group)[:n]

    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """image: (H, W, 3) uint8 (use util._to_image to normalize other inputs)."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"Bad image shape {image.shape}")
        if image_format == "BGR":
            image = image[..., ::-1]
        self.original_size = tuple(image.shape[:2])
        resized = self.transform.apply_image(image)
        self.input_size = tuple(resized.shape[:2])
        self.features = self.encode_batch(resized[None])
        self.is_image_set = True

    def set_features(self, features, original_size: Tuple[int, int],
                     input_size: Optional[Tuple[int, int]] = None) -> None:
        """Install precomputed embeddings: NHWC (1, 64, 64, 256) or the cache's
        NCHW (1, 256, 64, 64), numpy or torch."""
        f = torch.as_tensor(np.asarray(features) if not torch.is_tensor(features) else features)
        if f.dim() == 3:
            f = f[None]
        if f.shape[1] == self.model.config.prompt_embed_dim and f.shape[-1] != f.shape[1]:
            f = f.permute(0, 2, 3, 1)
        self.features = f.to(self.device, self.model.config.dtype).contiguous()
        self.original_size = tuple(int(s) for s in original_size)
        if input_size is None:
            input_size = get_preprocess_shape(*self.original_size, self.model.config.img_size)
        self.input_size = tuple(int(s) for s in input_size)
        self.is_image_set = True

    def get_image_embedding(self) -> np.ndarray:
        """Embeddings in the reference's NCHW layout (1, 256, 64, 64), float32."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...).")
        return self.features.permute(0, 3, 1, 2).float().cpu().numpy()

    # ------------------------------------------------------------------
    # prompt side
    # ------------------------------------------------------------------
    @staticmethod
    def _is_batched(point_coords, box, mask_input) -> bool:
        """Whether the prompts carry a batch axis (the outputs keep it)."""
        if point_coords is not None:
            return np.asarray(point_coords).ndim != 2
        if box is not None:
            return np.asarray(box).ndim != 1
        return not (mask_input is not None and np.asarray(mask_input).ndim == 3)

    def _pack_prompts(self, point_coords, point_labels, box, mask_input):
        """-> (points (B, P, 2), labels (B, P), mask (B, s, s, 1), has_mask (B,))."""
        pts_list, lbl_list = [], []
        B = 1
        if point_coords is not None:
            pc = np.asarray(point_coords, dtype=np.float32)
            pc = pc if pc.ndim == 3 else pc[None]
            pl = np.asarray(point_labels, dtype=np.int64)
            pl = pl if pl.ndim == 2 else pl[None]
            B = pc.shape[0]
            pts_list.append(self.transform.apply_coords(pc, self.original_size).reshape(B, -1, 2))
            lbl_list.append(pl)
        if box is not None:
            bx = np.asarray(box, dtype=np.float32)
            bx = bx if bx.ndim == 2 else bx[None]
            B = max(B, bx.shape[0])
            pts_list.append(self.transform.apply_boxes(bx, self.original_size).reshape(-1, 2, 2))
            lbl_list.append(np.tile(np.array([[2, 3]], dtype=np.int64), (bx.shape[0], 1)))

        if pts_list:
            pts_list = [p if p.shape[0] == B else np.broadcast_to(p, (B,) + p.shape[1:])
                        for p in pts_list]
            lbl_list = [lb if lb.shape[0] == B else np.broadcast_to(lb, (B,) + lb.shape[1:])
                        for lb in lbl_list]
            points = np.concatenate(pts_list, axis=1)
            labels = np.concatenate(lbl_list, axis=1)
        elif mask_input is not None:
            if np.asarray(mask_input).ndim == 4:
                B = np.asarray(mask_input).shape[0]
            points = np.zeros((B, 0, 2), np.float32)
            labels = np.zeros((B, 0), np.int64)
        else:
            raise ValueError("At least one of point, box or mask prompts is required.")

        # upstream SAM: one padding point when there is no box
        if box is None and points.shape[1] > 0:
            points = np.concatenate([points, np.zeros((B, 1, 2), np.float32)], axis=1)
            labels = np.concatenate([labels, -np.ones((B, 1), np.int64)], axis=1)

        mask_hw = self.model.config.embedding_size * 4
        if mask_input is not None:
            mi = np.asarray(mask_input, dtype=np.float32)
            mi = mi if mi.ndim == 4 else mi[None]
            mi = np.transpose(mi, (0, 2, 3, 1))
            if mi.shape[0] != B:
                mi = np.broadcast_to(mi, (B,) + mi.shape[1:])
            has_mask = np.ones((B,), bool)
        else:
            mi = None
            has_mask = np.zeros((B,), bool)
        return points, labels, mi, has_mask

    @torch.no_grad()
    def predict_torch(self, point_coords: Optional[np.ndarray] = None,
                      point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                      mask_input: Optional[np.ndarray] = None, multimask_output: bool = True):
        """``predict`` without the copy to the host: (mask logits (B, C, H, W),
        iou (B, C), low-res logits (B, C, 256, 256)) as float32 tensors on the
        predictor's device, batched whatever the prompts' shape."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before prediction.")
        points, labels, mi, has_mask = self._pack_prompts(
            point_coords, point_labels, box, mask_input)
        if self.mesh is not None:  # this data rank's slice of the padded prompts
            mi_pad = np.zeros((points.shape[0], 1, 1, 1), np.float32) if mi is None else mi
            points, labels, mi_pad, has_mask, n = self._pad_batch(points, labels, mi_pad, has_mask)
            sl = self._data_slice(len(points))
            points, labels, has_mask = points[sl], labels[sl], has_mask[sl]
            mi = None if mi is None else mi_pad[sl]
        dev = self.device
        low_res, iou = self.model.decode_masks(
            self.features, torch.as_tensor(np.ascontiguousarray(points), device=dev),
            torch.as_tensor(np.ascontiguousarray(labels), device=dev),
            None if mi is None else torch.as_tensor(np.ascontiguousarray(mi), device=dev),
            None if mi is None else torch.as_tensor(has_mask, device=dev))
        if multimask_output:
            low_res, iou = low_res[:, 1:], iou[:, 1:]
        else:
            low_res, iou = low_res[:, 0:1], iou[:, 0:1]
        low_res, iou = low_res.float(), iou.float()
        if self.mesh is not None:
            from .parallel.mesh import all_gather_cat
            low_res = all_gather_cat(low_res, self.mesh.data_group)[:n]
            iou = all_gather_cat(iou, self.mesh.data_group)[:n]
        masks = postprocess_masks(low_res, self.input_size, self.original_size,
                                  self.model.config.img_size)
        return masks, iou, low_res

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False):
        """Prediction from prompts in original-image coordinates.

        Returns (masks (C, H, W), iou_predictions (C,), low_res_masks (C, 256, 256))
        for unbatched prompts, with a leading batch axis otherwise."""
        masks, iou, low_res = self.predict_torch(point_coords, point_labels, box, mask_input,
                                                 multimask_output)
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        masks, iou, low_res = masks.cpu().numpy(), iou.cpu().numpy(), low_res.cpu().numpy()
        if not self._is_batched(point_coords, box, mask_input):
            return masks[0], iou[0], low_res[0]
        return masks, iou, low_res

    def predict_batched(self, point_coords=None, point_labels=None, boxes=None,
                        mask_input=None, multimask_output=True, return_logits=False):
        return self.predict(point_coords, point_labels, boxes, mask_input,
                            multimask_output, return_logits)


# ---------------------------------------------------------------------------
# The AMG decode: grid prompts -> packed masks and their scores, on the device
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``numpy.packbits`` along the last axis, most significant bit first, on
    the tensor's device; the last axis is zero-padded to a multiple of 8."""
    pad = (-bits.shape[-1]) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    groups = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.uint8)
    return (groups * w).sum(dim=-1, dtype=torch.uint8)


@torch.no_grad()
def amg_decode(predictor: SamPredictor, points_xy, mask_threshold: float = MASK_THRESHOLD,
               stability_offset: float = 1.0,
               prefilter: Optional[Tuple[float, float]] = None,
               mesh=None) -> Dict[str, torch.Tensor]:
    """Decode one batch of AMG grid prompts and reduce it on the device.

    points_xy: (B, 2) xy points in the encoder's frame (``transform.apply_coords``).
    Each point is packed as upstream SAM packs it, the point and one pad
    point of label -1, and decoded with multimask output; the three masks of
    each point (channel 0 dropped before the upscale) are upscaled to the
    predictor's original size and reduced in float32 whatever the compute
    dtype: the stability score, the threshold, the XYXY boxes, and the masks
    transposed and bit-packed, (N, W, ceil(H/8)) uint8, the layout
    ``native.rle_from_packed`` reads. ``prefilter=(iou_floor, stability_floor)``
    keeps the candidates with iou > floor and stability >= floor (the
    comparisons of ``AMGBase``'s filters), in their order.

    Returns the kept rows on the device: ``packed``, ``iou`` (n,),
    ``stability`` (n,), ``boxes`` (n, 4) int32 and ``order`` (n,), each row's
    index among the B * 3 candidates (point-major).

    On a mesh (``mesh``, default the predictor's) the points are padded to a
    multiple of its data axis and each data rank decodes and reduces its
    contiguous share; the kept rows are all-gathered in the points' order,
    so ``order`` indexes the B * 3 candidates as in one process."""
    points_xy = np.asarray(points_xy, dtype=np.float32)
    mesh = predictor.mesh if mesh is None else mesh
    if mesh is None or len(points_xy) == 0:
        return _amg_decode_rows(predictor, points_xy, mask_threshold, stability_offset, prefilter)
    from .parallel.mesh import all_gather_rows
    B, d = len(points_xy), mesh.shape["data"]
    pad = (-B) % d
    if pad:
        points_xy = np.concatenate([points_xy, np.repeat(points_xy[-1:], pad, axis=0)])
    per = len(points_xy) // d
    i = mesh.data_index
    rows = _amg_decode_rows(predictor, points_xy[i * per:(i + 1) * per], mask_threshold,
                            stability_offset, prefilter)
    rows["order"] = rows["order"] + i * per * 3
    rows = {k: all_gather_rows(v, mesh.data_group) for k, v in rows.items()}
    keep = rows["order"] < B * 3  # the padding points' rows go
    return {k: v[keep] for k, v in rows.items()}


def _amg_decode_rows(predictor: SamPredictor, points_xy: np.ndarray, mask_threshold: float,
                     stability_offset: float, prefilter: Optional[Tuple[float, float]]
                     ) -> Dict[str, torch.Tensor]:
    """``amg_decode`` of one process's points."""
    dev = predictor.device
    pts = torch.as_tensor(points_xy, device=dev)
    B = pts.shape[0]
    points = torch.cat([pts[:, None], torch.zeros(B, 1, 2, device=dev)], dim=1)
    labels = torch.tensor([[1, -1]], dtype=torch.int64, device=dev).expand(B, 2)
    low_res, iou = predictor.model.decode_masks(predictor.features, points, labels)
    masks = postprocess_masks(low_res[:, 1:].float(), predictor.input_size,
                              predictor.original_size, predictor.model.config.img_size)
    iou = iou[:, 1:].float().reshape(-1)
    stability = calculate_stability_score(masks, mask_threshold, stability_offset).reshape(-1)
    binary = masks > mask_threshold
    del masks
    boxes = batched_mask_to_box(binary).reshape(-1, 4)
    H, W = binary.shape[-2:]
    packed = packbits(binary.transpose(-1, -2).reshape(-1, W, H))
    if prefilter is None:
        order = torch.arange(iou.shape[0], device=dev)
    else:
        order = torch.nonzero((iou > prefilter[0]) & (stability >= prefilter[1])).reshape(-1)
    return {"packed": packed[order], "iou": iou[order], "stability": stability[order],
            "boxes": boxes[order], "order": order}
