"""SamPredictor: the interactive inference interface.

Counterpart of ``micro_sam_tpu/predictor.py`` (``segment_anything.SamPredictor``
semantics). Features are kept as (1, 64, 64, 256) NHWC on the model's device;
the embedding cache stores them NCHW. Prompts are packed as upstream SAM packs
them: boxes become two points with labels 2 / 3, and one padding point (label
-1) is appended only when there is no box. No further padding is added: every
padding token takes part in the two-way transformer's attention and changes
the result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .models.sam import MASK_THRESHOLD, Sam, postprocess_masks, preprocess
from .utils.transforms import ResizeLongestSide, get_preprocess_shape


class SamPredictor:
    def __init__(self, sam: Sam):
        self.model = sam
        self.device = next(sam.parameters()).device
        self.transform = ResizeLongestSide(sam.config.img_size)
        self.model_type: str = sam.config.model_type
        self.model_name: Optional[str] = None
        self._hash: Optional[str] = None
        self.reset_image()

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
        """(B, h, w, 3) resized pixels -> (B, 64, 64, 256) embeddings on the device."""
        x = torch.as_tensor(np.asarray(batch, dtype=np.float32), device=self.device)
        return self.model.encode_image(preprocess(x, self.model.config.img_size))

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
    def _pack_prompts(self, point_coords, point_labels, box, mask_input):
        """-> (points (B, P, 2), labels (B, P), mask (B, s, s, 1), has_mask (B,), batched)."""
        batched = True
        if point_coords is not None and np.asarray(point_coords).ndim == 2:
            batched = False
        if point_coords is None and box is not None and np.asarray(box).ndim == 1:
            batched = False
        if (point_coords is None and box is None and mask_input is not None
                and np.asarray(mask_input).ndim == 3):
            batched = False

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
        return points, labels, mi, has_mask, batched

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False):
        """Prediction from prompts in original-image coordinates.

        Returns (masks (C, H, W), iou_predictions (C,), low_res_masks (C, 256, 256))
        for unbatched prompts, with a leading batch axis otherwise."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before prediction.")
        points, labels, mi, has_mask, batched = self._pack_prompts(
            point_coords, point_labels, box, mask_input)
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
        masks = postprocess_masks(low_res, self.input_size, self.original_size,
                                  self.model.config.img_size)
        masks = masks.cpu().numpy()
        iou, low_res = iou.float().cpu().numpy(), low_res.cpu().numpy()
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        if not batched:
            return masks[0], iou[0], low_res[0]
        return masks, iou, low_res

    def predict_batched(self, point_coords=None, point_labels=None, boxes=None,
                        mask_input=None, multimask_output=True, return_logits=False):
        return self.predict(point_coords, point_labels, boxes, mask_input,
                            multimask_output, return_logits)
