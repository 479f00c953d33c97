"""Linear-layer kernel ``Y = X W^T + b`` with a fused epilogue
(``csrc/gemm.cu``) and its plain PyTorch version.

Replaces the qkv, proj, lin1 and lin2 products computed inside the TPU kernels
``micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel`` and
``::_fused_global_kernel``. Epilogues: ``"none"``, ``"gelu"`` (exact erf) and
``"residual"`` (adds R). Rounding follows the plain composition, which stores
every intermediate in the working type: v = round(acc + b), then
round(gelu(v)) or round(R + v).

Bound on the H100: operations (every encoder block product has over 130
flops per byte). The bf16 path runs WMMA tensor-core fragments fed by a
four-stage cp.async ring, 128 x 128 output tiles; ragged M (4900 window rows)
is zero-filled in shared memory and masked in the epilogue. The f32 path is a
SIMT tile kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

EPILOGUES = {"none": 0, "gelu": 1, "residual": 2}


def gemm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epilogue: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K); weight: (N, K); bias: (N,) -> (M, N) in x.dtype; f32 accumulation."""
    y = (x.float() @ weight.float().t() + bias.float()).to(x.dtype)
    if epilogue == "gelu":
        y = F.gelu(y)
    elif epilogue == "residual":
        y = residual + y
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y


def gemm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
         epilogue: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``epilogue(x @ weight.T + bias)``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("a residual is given exactly when epilogue='residual'")
    if x.device.type == "cpu":
        return gemm_plain(x, weight, bias, epilogue, residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"gemm: unsupported device {x.device}")
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} x {tuple(weight.shape)}^T")
    if not (x.is_contiguous() and weight.is_contiguous()) or weight.dtype != x.dtype:
        raise ValueError("gemm takes contiguous x and weight of one dtype")
    M, K = x.shape
    N = weight.shape[0]
    if x.dtype == torch.bfloat16 and (K % 8 or x.data_ptr() % 16 or weight.data_ptr() % 16):
        raise ValueError("gemm: bf16 needs K divisible by 8 and 16-byte aligned operands")
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if residual is not None and (residual.shape != (M, N) or residual.dtype != x.dtype
                                 or not residual.is_contiguous() or residual.data_ptr() % 16):
        raise ValueError("gemm: residual must be a contiguous, 16-byte aligned (M, N) "
                         "tensor of x.dtype")
    y = torch.empty((M, N), device=x.device, dtype=x.dtype)
    lib = _cuda.library("gemm")
    rc = lib.msam_gemm(x.data_ptr(), weight.data_ptr(), b.data_ptr(),
                       residual.data_ptr() if residual is not None else None, y.data_ptr(),
                       M, N, K, EPILOGUES[epilogue], _cuda.dtype_code(x), _cuda.stream_ptr(x))
    _cuda.check("gemm", rc)
    gemm.launches += 1
    return y


gemm.launches = 0
