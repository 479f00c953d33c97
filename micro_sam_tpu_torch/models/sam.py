"""SAM model assembly: image encoder + prompt encoder + mask decoder.

Counterpart of ``micro_sam_tpu/models/sam.py``. ``Sam`` is an ``nn.Module``
whose state dict has the segment_anything key layout. ``config.compute_dtype``
is the dtype activations run in (bfloat16 on the card). For serving, the
encoder blocks' product weights are held in it and every other parameter is
float32; a model built to train (``weight_dtype=torch.float32``) holds every
parameter in float32 and casts at use, inside autograd, as the JAX trainer
does (an AdamW step of 1e-5 on a weight of 0.02 is below bfloat16's
resolution). ``encode_image`` / ``decode_masks`` run without autograd;
``encode_image_train`` / ``decode`` are the same modules with it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from .image_encoder import ImageEncoderViT
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from .tiny_vit import TinyViT

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SamConfig:
    model_type: str = "vit_b"
    encoder: str = "vit"            # "vit" or "tiny_vit"
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_embed_dim: int = 256
    compute_dtype: str = "float32"

    @property
    def embedding_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def preprocess(x: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """Normalize (B, h, w, 3) pixels and zero-pad to (B, img_size, img_size, 3), f32."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=x.device)
    x = (x.float() - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int], img_size: int = 1024) -> torch.Tensor:
    """Upscale (B, N, 256, 256) mask logits to the original image size.

    Bilinear with half-pixel centres; a downscale is antialiased, as
    ``jax.image.resize`` does in the JAX package."""
    if tuple(masks.shape[2:]) != (img_size, img_size):
        masks = F.interpolate(masks, (img_size, img_size), mode="bilinear", align_corners=False)
    x = masks[:, :, : input_size[0], : input_size[1]]
    if tuple(x.shape[2:]) == tuple(original_size):
        return x
    down = original_size[0] < x.shape[2] or original_size[1] < x.shape[3]
    return F.interpolate(x, tuple(original_size), mode="bilinear", align_corners=False,
                         antialias=down)


class Sam(nn.Module):
    def __init__(self, config: SamConfig, weight_dtype: Optional[torch.dtype] = None):
        """``weight_dtype``: the dtype of the encoder blocks' product weights
        (default: the compute dtype, for the serving kernel chain)."""
        super().__init__()
        self.config = config
        e = config.embedding_size
        if config.encoder == "tiny_vit":
            self.image_encoder = TinyViT(config.prompt_embed_dim, dtype=weight_dtype or config.dtype)
        elif config.encoder == "vit":
            self.image_encoder = ImageEncoderViT(
                img_size=config.img_size, patch_size=config.patch_size,
                embed_dim=config.embed_dim, depth=config.depth, num_heads=config.num_heads,
                mlp_ratio=config.mlp_ratio, out_chans=config.prompt_embed_dim,
                window_size=config.window_size, global_attn_indexes=config.global_attn_indexes,
                dtype=weight_dtype or config.dtype)
        else:
            raise ValueError(f"unknown encoder {config.encoder!r}")
        self.prompt_encoder = PromptEncoder(config.prompt_embed_dim, (e, e),
                                            (config.img_size, config.img_size))
        self.mask_decoder = MaskDecoder(config.prompt_embed_dim)

    def init_(self, generator: torch.Generator) -> "Sam":
        cm.init_module_(self, generator)
        return self

    def hold_weights_in_(self, dtype: torch.dtype) -> "Sam":
        """Keep the encoder blocks' product weights in ``dtype`` (what
        ``weight_dtype`` of the constructor sets)."""
        self.image_encoder.hold_weights_in_(dtype)
        return self

    @torch.no_grad()
    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, S, S, 3) preprocessed -> (B, S/16, S/16, 256) in the compute dtype."""
        return self.image_encoder(pixels.to(self.config.dtype))

    def encode_image_train(self, pixels: torch.Tensor) -> torch.Tensor:
        """``encode_image`` in autograd (``forward_train`` of the encoder: the
        ViT's blocks checkpointed, TinyViT's chains through their autograd
        functions)."""
        return self.image_encoder.forward_train(pixels.to(self.config.dtype))

    @torch.no_grad()
    def decode_masks(self, image_embeddings: torch.Tensor, points: torch.Tensor,
                     labels: torch.Tensor, mask_input: Optional[torch.Tensor] = None,
                     has_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeddings (B or 1, 64, 64, 256); points (B, P, 2); labels (B, P);
        mask_input (B, 256, 256, 1) -> (low_res_masks (B, 4, 256, 256), iou (B, 4)), f32."""
        return self.decode(image_embeddings, points, labels, mask_input, has_mask)

    def decode(self, image_embeddings: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
               mask_input: Optional[torch.Tensor] = None, has_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``decode_masks`` in autograd."""
        dt = self.config.dtype
        sparse, dense = self.prompt_encoder(points, labels, mask_input, has_mask)
        image_pe = self.prompt_encoder.get_dense_pe()
        return self.mask_decoder(image_embeddings.to(dt), image_pe.to(dt),
                                 sparse.to(dt), dense.to(dt))
