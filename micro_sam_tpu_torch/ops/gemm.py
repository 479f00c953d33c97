"""Linear-layer kernel ``Y = X W^T + b`` with a fused epilogue
(``csrc/gemm.cu``) and its plain PyTorch version.

Replaces the qkv, proj, lin1 and lin2 products computed inside the TPU kernels
``micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel`` and
``::_fused_global_kernel``, and the 1 x 1 convolutions and MLP products of the
TinyViT kernels (``ops/fused_mbconv.py``, ``ops/fused_tiny_attention.py``,
``ops/fused_tiny_tail.py``). Epilogues: ``"none"``, ``"gelu"`` (exact erf),
``"residual"`` (adds R) and ``"residual_gelu"`` (gelu(R + v), the MBConv's
last step). Rounding follows the plain composition, which stores every
intermediate in the working type: v = round(acc + b), then round(gelu(v)),
round(R + v) or round(gelu(round(R + v))).

Bound on the H100: operations (every encoder block product has over 130
flops per byte). The bf16 path is one warp-specialised kernel: warpgroup
``wgmma`` products on 128 x BN tiles fed by TMA through an mbarrier-guarded
ring, a persistent grid of at most one block an SM, the epilogues in
registers; ``gemm_plan`` picks BN, the ring's stages, the grid and whether
the two consumer warpgroups split each tile or take tiles in turns.
Ragged M, N and K are zero-filled by TMA and masked in the epilogue. The f32
path is a SIMT tile kernel.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _cuda

EPILOGUES = {"none": 0, "gelu": 1, "residual": 2, "residual_gelu": 3}
RESIDUAL_EPILOGUES = ("residual", "residual_gelu")
GELU_EPILOGUES = ("gelu", "residual_gelu")
TILE_M = 128              # rows of an output tile
TILE_N = (256, 128)       # the column widths built, the wider first
SMEM_LIMIT = 232448       # bytes of dynamic shared memory a block may use
STAGES = {256: 4, 128: 5}  # ring slots a plan takes: 48 / 32 KB each
H100_SMS = 132


def max_stages(bn: int) -> int:
    """The most ring slots of ``bn``-wide tiles (16 bytes of barriers each)
    that fit beside two order barriers and 1024 bytes of alignment."""
    return (SMEM_LIMIT - 16 - 1024) // ((TILE_M + bn) * 64 * 2 + 16)


class GemmPlan(NamedTuple):
    """How the bf16 kernel runs one shape: ``bn``-wide tiles, a ring of
    ``stages`` K steps, ``grid`` persistent blocks over ``tiles`` tiles; the
    two consumer warpgroups split each tile, or, with ``turns`` (128-wide
    tiles and epilogues without a GELU only), take whole tiles in turns."""
    bn: int
    stages: int
    grid: int
    tiles: int
    turns: bool = False

    def __str__(self):
        return (f"BN {self.bn}{' in turns' if self.turns else ''}, {self.stages} stages, "
                f"grid {self.grid} of {self.tiles} tiles")


@functools.lru_cache(maxsize=1024)
def gemm_plan(M: int, N: int, K: int, epilogue: str = "none", sms: int = H100_SMS) -> GemmPlan:
    """128-wide tiles in turns where the epilogue has no GELU and a block has
    more than one tile: one warpgroup's epilogue then runs beside the other's
    products. Otherwise (a GELU, an erf for every output, keeps one
    warpgroup longer than the other's products, and the kernel takes none in
    turns; a lone tile wants both warpgroups on its products) the two split
    each tile, and the width is
    the one whose tiles take the fewest column-weighted waves over ``sms``
    SMs: a wave of 256-wide tiles costs twice one of 128-wide tiles; a tie
    goes to 256 (fewer tiles and epilogues, more work per operand byte read
    from shared memory). K does not enter: every tile runs the whole K in one
    order, whatever the plan. Measured at the encoders' shapes with
    ``kernel_replay.py --gemm-plans``, as are the ring depths."""
    m_tiles = -(-M // TILE_M)
    tiles128 = m_tiles * -(-N // 128)
    if epilogue not in GELU_EPILOGUES and tiles128 > sms:
        return GemmPlan(128, STAGES[128], sms, tiles128, True)
    best = None
    for bn in TILE_N:
        tiles = m_tiles * -(-N // bn)
        cost = -(-tiles // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    return GemmPlan(bn, STAGES[bn], min(tiles, sms), tiles)


_sms: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def gemm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epilogue: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K); weight: (N, K); bias: (N,) -> (M, N) in x.dtype; f32 accumulation."""
    y = (x.float() @ weight.float().t() + bias.float()).to(x.dtype)
    if epilogue == "gelu":
        y = F.gelu(y)
    elif epilogue == "residual":
        y = residual + y
    elif epilogue == "residual_gelu":
        y = F.gelu(residual + y)
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return y


def check_launch(x: torch.Tensor, weight: torch.Tensor,
                 residual: Optional[torch.Tensor]) -> None:
    """What the kernel takes, checked before a launch: 2-d x (M, K) and weight
    (N, K), contiguous, of one dtype; a residual contiguous (M, N) of x's
    dtype; in bf16, K a positive multiple of 8 and x, weight and residual
    16-byte aligned (TMA's strides and bases, the epilogue's 16-byte
    accesses)."""
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} x {tuple(weight.shape)}^T")
    if not (x.is_contiguous() and weight.is_contiguous()) or weight.dtype != x.dtype:
        raise ValueError("gemm takes contiguous x and weight of one dtype")
    M, K = x.shape
    N = weight.shape[0]
    if residual is not None and (tuple(residual.shape) != (M, N) or residual.dtype != x.dtype
                                 or not residual.is_contiguous()):
        raise ValueError("gemm: residual must be a contiguous (M, N) tensor of x.dtype")
    if x.dtype == torch.bfloat16:
        if K <= 0 or K % 8:
            raise ValueError(f"gemm: bf16 needs K a positive multiple of 8, got {K}")
        if any(t is not None and t.data_ptr() % 16 for t in (x, weight, residual)):
            raise ValueError("gemm: bf16 needs 16-byte aligned x, weight and residual")


def gemm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
         epilogue: str = "none", residual: Optional[torch.Tensor] = None,
         plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """``epilogue(x @ weight.T + bias)``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel, in bf16 by ``plan`` (default
    ``gemm_plan``; another plan gives the same result, and times it)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (epilogue in RESIDUAL_EPILOGUES) != (residual is not None):
        raise ValueError(f"a residual is given exactly when the epilogue is one of "
                         f"{RESIDUAL_EPILOGUES}")
    if x.device.type == "cpu":
        return gemm_plain(x, weight, bias, epilogue, residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"gemm: unsupported device {x.device}")
    check_launch(x, weight, residual)
    M, K = x.shape
    N = weight.shape[0]
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((M, N), device=x.device, dtype=x.dtype)
    if M == 0 or N == 0:
        return y
    if y.data_ptr() % 16:
        raise ValueError("gemm: the output is not 16-byte aligned")
    if x.dtype != torch.bfloat16:
        plan = GemmPlan(0, 0, 0, 0)
    elif plan is None:
        plan = gemm_plan(M, N, K, epilogue, _sm_count(x.device))
    lib = _cuda.library("gemm")
    rc = lib.msam_gemm(x.data_ptr(), weight.data_ptr(), b.data_ptr(),
                       residual.data_ptr() if residual is not None else None, y.data_ptr(),
                       M, N, K, EPILOGUES[epilogue], _cuda.dtype_code(x), plan.bn, plan.stages,
                       plan.grid, int(plan.turns), _cuda.stream_ptr(x))
    _cuda.check("gemm", rc)
    gemm.launches += 1
    return y


gemm.launches = 0
