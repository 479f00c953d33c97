"""3d SAM wrappers: depth adapters around the ViT encoder's blocks, and a
per-slice encoder with a small convolutional head.

Counterpart of ``micro_sam_tpu/models/sam_3d_wrapper.py``. ``Sam3DWrapper``
gives every encoder block two depth adapters (before and after the block):
a depthwise (3, 1, 1) convolution along z over the volume's slices, a
LayerNorm, a point-wise linear and a residual. The volume runs as a batch of
slices, the slice count threading through the adapters; the blocks run as in
serving (the kernel chain, with the PEFT terms of a PEFT block), or in
autograd as in training (``train_block``: K1 forward, K4 backward); then the
prompt-less decode.
``SimpleSam3DWrapper`` encodes slice by slice and maps the features through
three conv / LN / ReLU stages and a 1 x 1 head. The adapters and the head
are plain PyTorch, as the JAX package leaves them to XLA.

The adapters live on the blocks (``image_encoder.blocks.<i>.adapter_pre`` /
``adapter_post``), where the JAX package keeps them in its tree, so
``models/convert.py`` carries them. A fresh adapter is the identity: its
depth convolution starts at zero, and so does its point-wise bias (the JAX
package draws that bias, so its fresh adapter adds it).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from .image_encoder import run_block
from .sam import Sam, preprocess


class _DepthConv(nn.Module):
    """A depthwise (3, 1, 1) convolution's kernel, nn.Conv3d's layout (C, 1, 3, 1, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, 1, 3, 1, 1))


class DepthAdapter(nn.Module):
    """x + point(LN(dwconv_z(x))) over a volume's slices (keys ``depth_conv``,
    ``norm``, ``point``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.depth_conv = _DepthConv(dim)
        self.norm = cm.LayerNorm(dim)
        self.point = cm.Linear(dim, dim)

    def init_(self, g: torch.Generator) -> None:
        cm.kaiming_uniform_(self.point.weight, self.point.in_features, g)
        with torch.no_grad():
            self.depth_conv.weight.zero_()
            self.point.bias.zero_()

    def forward(self, x: torch.Tensor, d_size: int) -> torch.Tensor:
        """x: (B * D, H, W, C), the D slices of each volume in turn."""
        BD, H, W, C = x.shape
        xv = F.pad(x.float().reshape(BD // d_size, d_size, H, W, C), (0, 0, 0, 0, 0, 0, 1, 1))
        w = self.depth_conv.weight.float().view(C, 3)
        y = xv[:, :-2] * w[:, 0] + xv[:, 1:-1] * w[:, 1] + xv[:, 2:] * w[:, 2]
        y = self.point(self.norm(y.to(x.dtype)))
        return x + y.reshape(BD, H, W, C)


def attach_depth_adapters_(encoder, generator: torch.Generator) -> None:
    """Give every block of ``encoder`` fresh depth adapters (the identity)."""
    dev = encoder.pos_embed.device
    for blk in encoder.blocks:
        dim = blk.attn.qkv.in_features
        for name in ("adapter_pre", "adapter_post"):
            ad = DepthAdapter(dim)
            ad.init_(generator)
            setattr(blk, name, ad.to(dev))


def apply_block_3d(block, x: torch.Tensor, d_size: int, fact=None,
                   plain: bool = False) -> torch.Tensor:
    """One block with its depth adapters (``models/image_encoder.run_block``;
    the block's plain version with ``plain``)."""
    if block.adapter_pre is not None:
        x = block.adapter_pre(x, d_size)
    x = run_block(block, x, fact, plain)
    if block.adapter_post is not None:
        x = block.adapter_post(x, d_size)
    return x


def apply_sam_3d_encoder(encoder, pixels: torch.Tensor, d_size: int,
                         plain: bool = False) -> torch.Tensor:
    """pixels: (B * D, S, S, 3) preprocessed, in the compute dtype -> (B * D,
    S / 16, S / 16, 256), the depth adapters threading D through every block
    (the blocks through their plain versions with ``plain``)."""
    x = encoder._patch_embed(pixels)
    fact = encoder.fact
    for blk in encoder.blocks:
        x = apply_block_3d(blk, x, d_size, fact, plain)
    return encoder.neck(x)


class Sam3DWrapper(nn.Module):
    """Prompt-less semantic 3d segmentation with a depth-adapted encoder.
    ``forward(volume)``: (B, D, S, S, 3) raw pixels -> (B, D, 4, S / 4, S / 4)
    mask logits. ``freeze_encoder`` freezes the encoder's base parameters (the
    adapters train). The depth adapters are drawn from the fixed seed 17, as
    the JAX package draws them from ``PRNGKey(17)``."""

    def __init__(self, sam: Optional[Sam] = None, d_size: int = 8, sam_model: Optional[Sam] = None,
                 freeze_encoder: bool = False, model_type: Optional[str] = None):
        super().__init__()
        sam = sam if sam is not None else sam_model
        if sam is None:
            raise ValueError("Pass the Sam model (sam= or sam_model=).")
        if sam.config.encoder != "vit":
            raise ValueError("Sam3DWrapper needs a ViT encoder (vit_b / vit_l / vit_h)")
        self.sam = sam
        self.config = sam.config
        self.d_size = d_size
        self.encoder_frozen = bool(freeze_encoder)
        attach_depth_adapters_(sam.image_encoder, torch.Generator().manual_seed(17))
        if freeze_encoder:
            for name, p in sam.image_encoder.named_parameters():
                if ".adapter_" not in name:
                    p.requires_grad_(False)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        B, D = volume.shape[:2]
        flat = volume.reshape((B * D,) + tuple(volume.shape[2:]))
        px = preprocess(flat, self.config.img_size).to(self.config.dtype)
        feats = apply_sam_3d_encoder(self.sam.image_encoder, px, D)
        points = torch.zeros((B * D, 0, 2), device=feats.device)
        labels = torch.zeros((B * D, 0), dtype=torch.int32, device=feats.device)
        masks, _ = self.sam.decode(feats, points, labels)
        return masks.reshape((B, D) + tuple(masks.shape[1:]))


class BasicBlock(nn.Module):
    """conv 3 x 3 -> LN -> ReLU, twice: a stage of the simple 3d head, over
    channel-last maps (keys ``conv1``, ``ln1``, ``conv2``, ``ln2``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = cm.Conv2d(in_channels, out_channels, 3, padding=1)
        self.ln1 = cm.LayerNorm(out_channels)
        self.conv2 = cm.Conv2d(out_channels, out_channels, 3, padding=1)
        self.ln2 = cm.LayerNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.ln1(self.conv1(x)))
        return F.relu(self.ln2(self.conv2(x)))


class SegmentationHead(nn.Module):
    """A 1 x 1 convolution from the head's features to class logits (key ``head``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.head = cm.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


SIMPLE_HEAD_DIMS = (256, 128, 64, 32)


class SimpleSam3DWrapper(nn.Module):
    """The encoder slice by slice, then three ``BasicBlock`` stages and a
    ``SegmentationHead``: ``forward(volume)`` (B, D, S, S, 3) raw pixels ->
    (B, D, S / 16, S / 16, out_channels) logits. ``freeze_encoder`` freezes
    the SAM."""

    def __init__(self, sam: Sam, out_channels: int = 1, seed: int = 23,
                 num_classes: Optional[int] = None, freeze_encoder: bool = False):
        super().__init__()
        if num_classes is not None:
            out_channels = num_classes
        self.sam = sam
        self.config = sam.config
        self.encoder_frozen = bool(freeze_encoder)
        d = SIMPLE_HEAD_DIMS
        self.blocks = nn.ModuleList(BasicBlock(d[i], d[i + 1]) for i in range(3))
        self.head = SegmentationHead(d[-1], out_channels)
        dev = next(sam.parameters()).device
        g = torch.Generator().manual_seed(seed)
        cm.init_module_(self.blocks, g)
        cm.init_module_(self.head, g)
        self.blocks.to(dev)
        self.head.to(dev)
        if freeze_encoder:
            sam.requires_grad_(False)

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        B, D = volume.shape[:2]
        flat = volume.reshape((B * D,) + tuple(volume.shape[2:]))
        px = preprocess(flat, self.config.img_size)
        if torch.is_grad_enabled():
            x = self.sam.encode_image_train(px)
        else:
            x = self.sam.encode_image(px)
        for blk in self.blocks:
            x = blk(x)
        x = self.head(x)
        return x.reshape((B, D) + tuple(x.shape[1:]))


def simple_head_from_jax(decoder_params: dict) -> Dict[str, torch.Tensor]:
    """The JAX ``SimpleSam3DWrapper.decoder_params`` (numpy leaves) -> the
    state dict of the port's ``blocks`` and ``head``."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    conv = lambda a: t(np.asarray(a).transpose(3, 2, 0, 1))
    sd = {}
    for i, bp in enumerate(decoder_params["blocks"]):
        for c in ("conv1", "conv2"):
            sd[f"blocks.{i}.{c}.weight"] = conv(bp[c]["w"])
            sd[f"blocks.{i}.{c}.bias"] = t(bp[c]["b"])
        for n in ("ln1", "ln2"):
            sd[f"blocks.{i}.{n}.weight"] = t(bp[n]["scale"])
            sd[f"blocks.{i}.{n}.bias"] = t(bp[n]["bias"])
    sd["head.head.weight"] = conv(decoder_params["head"]["w"])
    sd["head.head.bias"] = t(decoder_params["head"]["b"])
    return sd


class ImageEncoderViT3DWrapper:
    """The depth-adapted encoder as a callable: ``enc(pixels, d_size)`` ->
    (B * D, e, e, 256) (the reference's class surface; the encoder's blocks
    need their adapters, ``attach_depth_adapters_`` or ``Sam3DWrapper``)."""

    def __init__(self, image_encoder=None, num_heads: Optional[int] = None,
                 embed_dim: Optional[int] = None):
        self.image_encoder = image_encoder

    def __call__(self, pixels: torch.Tensor, d_size: int) -> torch.Tensor:
        return apply_sam_3d_encoder(self.image_encoder, pixels, d_size)


class NDBlockWrapper:
    """One encoder block with its depth adapters: ``blk(x, d_size)`` on
    (B * D, H, W, C) (the reference's class surface)."""

    def __init__(self, block=None, dim: Optional[int] = None, num_heads: Optional[int] = None,
                 norm_layer=None, adapter_channels: int = 384):
        self.block = block

    def __call__(self, x: torch.Tensor, d_size: int) -> torch.Tensor:
        return apply_block_3d(self.block, x, d_size)


def get_sam_3d_model(model_type: str = "vit_b", d_size: int = 8, device: Optional[str] = None,
                     freeze_encoder: bool = False, **kwargs) -> Sam3DWrapper:
    """A 3d-adapted SAM with random weights (``build_sam(model_type,
    **kwargs)``). ``device=None`` is the GPU."""
    from .build_sam import build_sam
    return Sam3DWrapper(build_sam(model_type, device=device, **kwargs), d_size=d_size,
                        freeze_encoder=freeze_encoder)


def get_simple_sam_3d_model(model_type: str = "vit_b", device: Optional[str] = None,
                            num_classes: Optional[int] = None, freeze_encoder: bool = False,
                            **kwargs) -> SimpleSam3DWrapper:
    """A simple 3d SAM with random weights. ``device=None`` is the GPU."""
    from .build_sam import build_sam
    return SimpleSam3DWrapper(build_sam(model_type, device=device, **kwargs),
                              num_classes=num_classes, freeze_encoder=freeze_encoder)
