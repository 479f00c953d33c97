"""Trainable SAM: batched forward over images and per-object prompts.

Counterpart of ``micro_sam_tpu/training/trainable_sam.py``: the encoder runs
once per batch of images (in autograd, blocks checkpointed), and the decoder
decodes all sampled objects of all images in one call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.common import resize_bilinear
from ..models.sam import Sam, preprocess


class TrainableSAM:
    """Bundles a ``Sam`` with the training-forward functions."""

    def __init__(self, sam: Sam):
        self.sam = sam
        self.config = sam.config

    @property
    def device(self) -> torch.device:
        return next(self.sam.parameters()).device

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 3) raw pixels -> resized (longest side to the model input),
        normalized and padded (B, S, S, 3) float32."""
        h, w = x.shape[1], x.shape[2]
        size = self.config.img_size
        if (h, w) != (size, size):
            scale = size / max(h, w)
            new_hw = (int(h * scale + 0.5), int(w * scale + 0.5))
            x = resize_bilinear(x.float().permute(0, 3, 1, 2), new_hw).permute(0, 2, 3, 1)
        return preprocess(x, size)

    def image_embeddings_oft(self, batched_inputs: torch.Tensor) -> torch.Tensor:
        """One encoder forward for the whole batch: (B, h, w, 3) -> (B, e, e, C)
        in the compute dtype (the ViT's ``forward_train``, or TinyViT's
        training forward for vit_t)."""
        return self.sam.encode_image_train(self.preprocess(batched_inputs))

    def forward_decoder(self, image_embeddings: torch.Tensor, points: torch.Tensor,
                        labels: torch.Tensor, mask_input: Optional[torch.Tensor] = None,
                        has_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All object prompts at once: (low_res_masks (N, 4, s, s), iou (N, 4)), f32."""
        return self.sam.decode(image_embeddings, points, labels, mask_input, has_mask)

    def upscale_masks(self, low_res: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        """(N, C, s, s) logits -> (N, C, H, W) at the training patch size."""
        return resize_bilinear(low_res, out_hw)
