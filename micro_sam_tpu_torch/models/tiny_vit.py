"""TinyViT image encoder for vit_t (MobileSAM's TinyViT-5M).

Counterpart of ``micro_sam_tpu/models/tiny_vit.py``, with MobileSAM's module
names, so a ``vit_t`` / ``vit_t_lm`` state dict loads as it is: a conv patch
embed (two 3 x 3 stride-2 ``Conv2d_BN``), a stage of MBConvs, three stages of
window-attention blocks (windows 7 / 14 / 7, head dim 32, learned per-offset
attention biases), patch-merging downsamples (the last with stride 1, so a
1024^2 input ends at 64 x 64 x 320) and the SAM neck to 256 channels.
BatchNorm uses its running statistics (frozen). Layout is NHWC.

The MBConvs run as the kernel chain of ``ops/fused_mbconv.py``; each
attention block as the chains of ``ops/fused_tiny_attention.py`` (over the map
zero-padded to window multiples, then cropped) and ``ops/fused_tiny_tail.py``.
The patch embed, the merges and the neck are convolutions, left to
PyTorch (cuDNN on the card), as the JAX package leaves them to XLA. The
blocks' product weights (qkv, proj, fc1, fc2) are held in the dtype the chains
run in (float32 for training, cast at use); every other parameter is
float32. ``forward_train`` is the same forward in autograd.

The qkv product follows upstream TinyViT: its 3C output channels are per head
[q | k | v] (head h's q at 96h, k at 96h + 32, v at 96h + 64), where the JAX
package splits them into global thirds; ``models/convert.py`` permutes
between the two.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from ..ops.fused_mbconv import fused_mbconv
from ..ops.fused_tiny_attention import fused_tiny_attention
from ..ops.fused_tiny_tail import fused_tiny_tail

EMBED_DIMS = (64, 128, 160, 320)
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (2, 4, 5, 10)
WINDOW_SIZES = (7, 7, 14, 7)
MBCONV_EXPAND = 4
MLP_RATIO = 4


class MBConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        hidden = dim * MBCONV_EXPAND
        self.conv1 = cm.Conv2d_BN(dim, hidden)
        self.conv2 = cm.Conv2d_BN(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = cm.Conv2d_BN(hidden, dim)


class PatchMerging(nn.Module):
    """gelu(conv1) -> gelu(depthwise 3 x 3 conv2, stride 2 or 1) -> conv3, each
    with its BN folded in (PyTorch convolutions)."""

    def __init__(self, dim: int, out_dim: int, stride: int):
        super().__init__()
        self.conv1 = cm.Conv2d_BN(dim, out_dim)
        self.conv2 = cm.Conv2d_BN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = cm.Conv2d_BN(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        return self.conv3(x).contiguous()


class TinyAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.norm = cm.LayerNorm(dim, eps=1e-5)
        self.qkv = cm.Linear(dim, 3 * dim)
        self.proj = cm.Linear(dim, dim)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, window * window))

    def init_(self, g: torch.Generator) -> None:
        # random tables (upstream starts them at zero) so that a random-weight
        # model carries signal through the learned bias
        with torch.no_grad():
            self.attention_biases.normal_(0.0, 0.5, generator=g)


class TinyMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = cm.LayerNorm(dim, eps=1e-5)
        self.fc1 = cm.Linear(dim, hidden)
        self.fc2 = cm.Linear(hidden, dim)


class TinyViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.window = window
        self.attn = TinyAttention(dim, num_heads, window)
        self.local_conv = cm.Conv2d_BN(dim, dim, 3, 1, 1, groups=dim)
        self.mlp = TinyMlp(dim, dim * MLP_RATIO)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) contiguous -> (B, H, W, C)."""
        B, H, W, C = x.shape
        w = self.window
        pad_h, pad_w = (-H) % w, (-W) % w
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        x = fused_tiny_attention(x, self.attn)
        if pad_h or pad_w:
            x = x[:, :H, :W].contiguous()
        return fused_tiny_tail(x, self.local_conv, self.mlp)


class ConvLayer(nn.Module):
    def __init__(self, dim: int, depth: int, out_dim: int):
        super().__init__()
        self.blocks = nn.ModuleList(MBConv(dim) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim, 2)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 out_dim: Optional[int], stride: int):
        super().__init__()
        self.blocks = nn.ModuleList(TinyViTBlock(dim, num_heads, window) for _ in range(depth))
        self.downsample = None if out_dim is None else PatchMerging(dim, out_dim, stride)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.seq = nn.Sequential(cm.Conv2d_BN(3, dim // 2, 3, 2, 1), nn.GELU(),
                                 cm.Conv2d_BN(dim // 2, dim, 3, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq[2](F.gelu(self.seq[0](x))).contiguous()


class TinyViT(nn.Module):
    def __init__(self, out_chans: int = 256, dtype: torch.dtype = torch.float32):
        """``dtype``: the dtype the blocks' product weights are held in (the
        compute dtype, which the kernel chains run in)."""
        super().__init__()
        d = EMBED_DIMS
        self.patch_embed = PatchEmbed(d[0])
        self.layers = nn.ModuleList([ConvLayer(d[0], DEPTHS[0], d[1])])
        for i in (1, 2, 3):
            # the last merge keeps the resolution (upstream: stride 1 into 320 wide)
            out_dim, stride = (d[i + 1], 2 if i == 1 else 1) if i < 3 else (None, 1)
            self.layers.append(BasicLayer(d[i], DEPTHS[i], NUM_HEADS[i], WINDOW_SIZES[i],
                                          out_dim, stride))
        self.neck = nn.Sequential(
            cm.Conv2d(d[3], out_chans, 1, bias=False),
            cm.LayerNorm(out_chans),
            cm.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            cm.LayerNorm(out_chans),
        )
        self.hold_weights_in_(dtype)

    def hold_weights_in_(self, dtype: torch.dtype) -> None:
        """Keep the attention blocks' product weights in ``dtype``."""
        for layer in self.layers[1:]:
            for blk in layer.blocks:
                for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                    lin.hold_weight_in_(dtype)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward: ``forward`` in autograd. Each chain call runs
        as its autograd function (the kernels forward, the plain chain's
        gradient backward, ``ops/chain_grad.py``); the patch embed, merges and
        neck are PyTorch convolutions with the BN folded at each call, so the
        BN weight and bias train while its statistics stay frozen buffers.
        Nothing is checkpointed, as in the JAX package."""
        return self(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, 3) preprocessed pixels in the compute dtype ->
        (B, S / 16, S / 16, 256) embeddings (for S = 1024)."""
        x = self.patch_embed(x)
        stage0 = self.layers[0]
        for blk in stage0.blocks:
            x = fused_mbconv(x, blk)
        x = stage0.downsample(x)
        for layer in self.layers[1:]:
            for blk in layer.blocks:
                x = blk(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return self.neck(x)
