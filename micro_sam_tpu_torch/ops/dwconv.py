"""Depthwise 3 x 3 convolution with a folded BatchNorm and an optional GELU
(``csrc/dwconv.cu``) and its plain PyTorch version.

Replaces the depthwise stages inside the TPU kernels
``micro_sam_tpu/ops/fused_mbconv.py::_mbconv_kernel`` (gelu(bn2(dw3x3(h))) on
the MBConv's hidden map) and ``ops/fused_tiny_tail.py::_tiny_tail_kernel``
(bn(dw3x3(x)) of the block tail). Channel-last (B, H, W, C), stride 1, zero
padding 1, any H, W and C; the sum in f32, the result rounded to the working
type after the scale and shift, and again after the GELU (exact erf).

Bound on the H100: bytes (18 flops per output element against one element in
and one out). One thread computes 16 bytes of channels of one pixel from nine
coalesced 16-byte loads; the re-reads of the 3 x 3 window hit the caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda


def dwconv_plain(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, gelu: bool = False) -> torch.Tensor:
    """x: (B, H, W, C); weight: (C, 1, 3, 3); scale / shift: (C,) -> (B, H, W, C)
    in x.dtype, the convolution in f32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.float(), padding=1, groups=x.shape[-1])
    y = (y.permute(0, 2, 3, 1) * scale.float() + shift.float()).to(x.dtype)
    if gelu:
        y = F.gelu(y)
    return y.contiguous()


def dwconv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           gelu: bool = False) -> torch.Tensor:
    """``act(dw3x3(x) * scale + shift)`` over a channel-last map. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return dwconv_plain(x, weight, scale, shift, gelu)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"dwconv takes a contiguous (B, H, W, C) map, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if weight.numel() != 9 * C or scale.numel() != C or shift.numel() != C:
        raise ValueError("dwconv: weight must be (C, 1, 3, 3), scale and shift (C,)")
    w, s, t = (a.to(device=x.device, dtype=torch.float32).contiguous()
               for a in (weight, scale, shift))
    y = torch.empty_like(x)
    lib = _cuda.library("dwconv")
    rc = lib.msam_dwconv(x.data_ptr(), w.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(),
                         B, H, W, C, int(gelu), _cuda.dtype_code(x), _cuda.stream_ptr(x))
    _cuda.check("dwconv", rc)
    dwconv.launches += 1
    return y


dwconv.launches = 0
