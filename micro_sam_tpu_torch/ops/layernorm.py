"""Row LayerNorm kernel (``csrc/layernorm.cu``) and its plain PyTorch version.

Replaces the LN1 / LN2 stages inside the TPU kernels
``micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel`` and
``::_fused_global_kernel``. Statistics are f32, the result is rounded to the
working type and then multiplied by the optional per-row ``valid`` mask (the
window pad mask of the encoder).

Bound on the H100: bytes (x read once, y written once; 4 flops per element).
One warp owns one row and keeps it in registers through mean, variance and
write, so device memory sees only x in and y out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, C); weight/bias: (C,) f32; valid: (M,) or None -> (M, C) in x.dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(x.dtype)
    if valid is not None:
        y = y * valid.reshape(-1, 1).to(y.dtype)
    return y


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis of a (M, C) tensor, then ``* valid[:, None]``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps, valid)
    if x.device.type != "cuda":
        raise RuntimeError(f"layernorm: unsupported device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"layernorm takes a contiguous (M, C) tensor, got {tuple(x.shape)}")
    M, C = x.shape
    w = weight.to(device=x.device, dtype=torch.float32).contiguous()
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    v = None
    if valid is not None:
        v = valid.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
        if v.numel() != M:
            raise ValueError("layernorm: valid must hold one value per row")
    y = torch.empty_like(x)
    lib = _cuda.library("layernorm")
    rc = lib.msam_layernorm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            v.data_ptr() if v is not None else None, y.data_ptr(),
                            M, C, float(eps), _cuda.dtype_code(x), _cuda.stream_ptr(x))
    _cuda.check("layernorm", rc)
    layernorm.launches += 1
    return y


layernorm.launches = 0
