"""UNETR decoder over SAM image embeddings: the maps of decoder-based
instance segmentation (AIS).

Counterpart of ``micro_sam_tpu/models/unetr.py``. The submodules carry
torch_em's UNETR names (``deconv1..4``, ``base``, ``decoder.samplers.i`` /
``decoder.blocks.i``, ``deconv_out``, ``decoder_head``, ``out_conv``, each
``block.k`` at torch_em's index), so a zoo ``decoder_state`` loads with
``load_state_dict(strict=True)`` once ``clean_torch_em_state`` has dropped
what the decoder does not use. The dataflow:

- four side branches ``Deconv2DBlock`` (upsample, 3x3 conv, BatchNorm, ReLU)
  give z9 / z6 / z3 / z0 at 2x / 4x / 8x / 16x the embedding's resolution;
- ``base``, a ConvBlock (InstanceNorm, 3x3 conv, ReLU, twice) on the
  embedding;
- three decoder stages, each an upsampler and a ConvBlock over the upsampled
  map joined with its skip;
- ``deconv_out``, joined with z0, ``decoder_head``, the 1x1 ``out_conv`` and a
  sigmoid.

Upsamplers come in torch_em's two kinds: a ConvTranspose2d(k=2, s=2), stored
as ``block`` (``SingleDeconv2DBlock``), or a bilinear x2 followed by a 1x1
conv, stored as ``conv`` (``Upsampler2d``). BatchNorm runs on its stored
statistics. The ConvBlocks' InstanceNorms are affine-free unless built with
``affine_norms``.

Layout NCHW; the port's features are NHWC and contiguous, so
``features.permute(0, 3, 1, 2)`` is a channels-last NCHW tensor and the
convolutions keep that memory format. The decoder runs in its input's dtype,
as the JAX package's does: weights, BN scale and shift are cast to it at use;
the InstanceNorm is computed in float32 and cast back. The stage functions
(``conv``, ``conv_transpose``, ``upsample2x``, ``instance_norm``,
``bn_relu``) are called through this module's names, so that a profile can
wrap each.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common
from .common import BatchNorm, fold_bn, init_module_

# decoder widths, wide to narrow (torch_em: initial_features 64, depth 3, gain 2)
FEATURES = (512, 256, 128, 64)

# the ConvBlocks (InstanceNorms inside) and their torch_em key prefixes
_CONV_BLOCK_PREFIXES = ("base.", "decoder.blocks.", "decoder_head.")


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
         padding: int) -> torch.Tensor:
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    padding=padding)


def conv_transpose(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   stride: int) -> torch.Tensor:
    return F.conv_transpose2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                              stride=stride)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, half-pixel centers (torch_em's ``Upsampler2d``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def instance_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W in float32 (float64
    input in float64; biased variance, as InstanceNorm2d), the optional
    affine in the same, cast back."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc)
    var, mean = torch.var_mean(xa, dim=(2, 3), keepdim=True, correction=0)
    y = (xa - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(acc).view(1, -1, 1, 1) + bias.to(acc).view(1, -1, 1, 1)
    return y.to(x.dtype)


def bn_relu(x: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
    """ReLU(BN(x)) on the stored statistics: the float32 scale and shift cast
    to x's dtype, applied in it."""
    scale, shift = fold_bn(bn)
    return F.relu(x * scale.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1))


# ---------------------------------------------------------------------------
# modules (torch_em names)
# ---------------------------------------------------------------------------

class Conv2d(common.Conv2d):
    """nn.Conv2d over NCHW input, in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.weight, self.bias, self.padding[0])


class ConvTranspose2d(common.ConvTranspose2d):
    """nn.ConvTranspose2d (kernel == stride) over NCHW input, in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose(x, self.weight, self.bias, self.stride[0])


class InstanceNorm(nn.Module):
    """InstanceNorm2d without running statistics; ``weight`` / ``bias`` only
    when affine."""

    def __init__(self, dim: int, affine: bool = False):
        super().__init__()
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.affine:
            return instance_norm(x, self.weight, self.bias)
        return instance_norm(x)


class SingleConv(nn.Module):
    """torch_em ``SingleConv2DBlock``: a k x k conv, 'same' padding, under ``block``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.block = Conv2d(in_ch, out_ch, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class SingleDeconv(nn.Module):
    """torch_em ``SingleDeconv2DBlock``: ConvTranspose2d(k=2, s=2) under ``block``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = ConvTranspose2d(in_ch, out_ch, kernel_size=2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Upsampler(nn.Module):
    """torch_em ``Upsampler2d``: bilinear x2, then a 1x1 conv under ``conv``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x(x))


def _upsampler(in_ch: int, out_ch: int, use_conv_transpose: bool) -> nn.Module:
    return SingleDeconv(in_ch, out_ch) if use_conv_transpose else Upsampler(in_ch, out_ch)


class DeconvBlock(nn.Module):
    """torch_em ``Deconv2DBlock``: block = [upsampler, 3x3 conv, BatchNorm, ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, use_conv_transpose: bool = True):
        super().__init__()
        self.block = nn.ModuleList([_upsampler(in_ch, out_ch, use_conv_transpose),
                                    SingleConv(out_ch, out_ch, 3), BatchNorm(out_ch), nn.ReLU()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up, conv3, bn, _ = self.block
        return bn_relu(conv3(up(x)), bn)


class ConvBlock(nn.Module):
    """torch_em ``ConvBlock2d``: block = [norm, 3x3 conv, ReLU, norm, 3x3 conv, ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, affine_norms: bool = False):
        super().__init__()
        self.block = nn.ModuleList([
            InstanceNorm(in_ch, affine_norms), Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU(),
            InstanceNorm(out_ch, affine_norms), Conv2d(out_ch, out_ch, 3, padding=1), nn.ReLU()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm1, conv1, _, norm2, conv2, _ = self.block
        x = F.relu(conv1(norm1(x)))
        return F.relu(conv2(norm2(x)))


class Decoder(nn.Module):
    """torch_em ``unet.Decoder``: per stage an upsampler, then a ConvBlock over
    the upsampled map joined with the stage's skip input."""

    def __init__(self, features: Sequence[int], use_conv_transpose: bool, affine_norms: bool):
        super().__init__()
        pairs = list(zip(features[:-1], features[1:]))
        self.samplers = nn.ModuleList(_upsampler(a, b, use_conv_transpose) for a, b in pairs)
        self.blocks = nn.ModuleList(ConvBlock(2 * b, b, affine_norms) for _, b in pairs)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        for sampler, block, skip in zip(self.samplers, self.blocks, skips):
            x = block(torch.cat([sampler(x), skip], dim=1))
        return x


class UNETRDecoder(nn.Module):
    """The decoder of torch_em's UNETR (backbone "sam", no encoder skips):
    (B, embed_dim, h, w) embeddings -> (B, out_channels, 16h, 16w)."""

    def __init__(self, embed_dim: int = 256, out_channels: int = 3,
                 features: Sequence[int] = FEATURES, use_conv_transpose: bool = True,
                 affine_norms: bool = False, final_activation: bool = True):
        super().__init__()
        f0, f1, f2, f3 = features
        self.geometry = dict(embed_dim=embed_dim, out_channels=out_channels,
                             features=tuple(features), use_conv_transpose=use_conv_transpose,
                             affine_norms=affine_norms)
        self.final_activation = final_activation
        self.deconv1 = DeconvBlock(embed_dim, f1, use_conv_transpose)
        self.deconv2 = DeconvBlock(f1, f2, use_conv_transpose)
        self.deconv3 = DeconvBlock(f2, f3, use_conv_transpose)
        self.deconv4 = DeconvBlock(f3, f3, use_conv_transpose)
        self.base = ConvBlock(embed_dim, f0, affine_norms)
        self.decoder = Decoder(features, use_conv_transpose, affine_norms)
        self.deconv_out = _upsampler(f3, f3, use_conv_transpose)
        self.decoder_head = ConvBlock(2 * f3, f3, affine_norms)
        self.out_conv = Conv2d(f3, out_channels, 1)

    @property
    def embed_dim(self) -> int:
        return self.geometry["embed_dim"]

    def init_(self, generator: torch.Generator) -> "UNETRDecoder":
        """Random convolutions from ``generator`` (uniform in +-1/sqrt(fan_in)
        for weights and biases); norms at weight 1, bias 0, BN statistics at
        mean 0, variance 1."""
        init_module_(self, generator)
        return self

    def forward(self, z12: torch.Tensor) -> torch.Tensor:
        z9 = self.deconv1(z12)  # 2x
        z6 = self.deconv2(z9)   # 4x
        z3 = self.deconv3(z6)   # 8x
        z0 = self.deconv4(z3)   # 16x
        x = self.decoder(self.base(z12), (z9, z6, z3))
        x = torch.cat([self.deconv_out(x), z0], dim=1)
        x = self.out_conv(self.decoder_head(x))
        return torch.sigmoid(x) if self.final_activation else x


# ---------------------------------------------------------------------------
# torch_em state dicts
# ---------------------------------------------------------------------------

def is_torch_decoder_state(decoder_state) -> bool:
    """True for a flat torch_em UNETR state dict (dotted string keys)."""
    if not isinstance(decoder_state, dict) or not decoder_state:
        return False
    return all(isinstance(k, str) for k in decoder_state) and any(
        k.startswith(("deconv1.", "base.", "decoder.", "out_conv.")) for k in decoder_state)


def clean_torch_em_state(decoder_state: Dict) -> Dict[str, torch.Tensor]:
    """The keys of a torch_em UNETR state dict that the decoder loads: no
    ``encoder.*``, no ``num_batches_tracked``, and no running statistics of the
    ConvBlocks' InstanceNorms (the decoder normalizes by each sample's own
    statistics, as the JAX package does). Values as float32 tensors."""
    out = {}
    for k, v in decoder_state.items():
        if k.startswith("encoder") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith(_CONV_BLOCK_PREFIXES) and k.endswith(("running_mean", "running_var")):
            continue
        out[k] = torch.as_tensor(v).float()
    return out


def geometry_of(state: Dict[str, torch.Tensor]) -> Dict:
    """The constructor arguments of the decoder a torch_em state dict holds."""
    base_conv = state["base.block.1.weight"]
    return dict(
        embed_dim=int(base_conv.shape[1]),
        out_channels=int(state["out_conv.weight"].shape[0]),
        features=(int(base_conv.shape[0]),) + tuple(
            int(state[f"deconv{i}.block.1.block.weight"].shape[0]) for i in (1, 2, 3)),
        use_conv_transpose="deconv1.block.0.block.weight" in state,
        affine_norms="base.block.0.weight" in state)


def decoder_from_state(state: Dict[str, torch.Tensor]) -> UNETRDecoder:
    """A decoder of the state's geometry holding its weights (strict load)."""
    model = UNETRDecoder(**geometry_of(state))
    model.load_state_dict(state, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def postprocess_decoder_output(output: torch.Tensor, input_size: Tuple[int, int],
                               original_size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, S, S) decoder output -> (B, C, *original_size): crop away the
    encoder's padding, then resize bilinearly, antialiased when it shrinks
    (``jax.image.resize``'s bilinear)."""
    out = output[:, :, : input_size[0], : input_size[1]]
    if tuple(out.shape[-2:]) == tuple(original_size):
        return out
    return F.interpolate(out, size=tuple(int(s) for s in original_size), mode="bilinear",
                         align_corners=False, antialias=True)
