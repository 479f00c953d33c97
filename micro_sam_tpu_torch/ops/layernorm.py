"""Row LayerNorm kernel (``csrc/layernorm.cu``) and its plain PyTorch version.

Replaces the LN1 / LN2 stages inside the TPU kernels
``micro_sam_tpu/ops/fused_window_block.py::_fused_block_kernel`` and
``::_fused_global_kernel``. Statistics are f32, the result is rounded to the
working type and then multiplied by the optional per-row ``valid`` mask (the
window pad mask of the encoder). In the grid mode (``grid=(Hp, Wp, H, W)``,
the spatial window route, ``micro_sam_tpu/ops/fused_window_block.py::
_fused_block_kernel(spatial=)``) the rows are those of padded (B, Hp, Wp)
maps and the mask is the row's position: (b, y, x) is valid when y < H and
x < W.

Bound on the H100: bytes (x read once, y written once; 8 flops per element).
The kernel's vector variant (bf16 at the four models' widths) reads and
writes 16-byte vectors, a row to a group of lanes sized to its width, several
rows a warp, gamma / beta in registers, on a persistent grid that keeps a
warp's next rows in flight; the general variant (any other width up to 1536,
f32, unaligned addresses) is one warp a row. ``layernorm_plan`` picks them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .dwconv import _alignment

SMS = 132  # streaming multiprocessors of the H100 SXM
WARPS = 8  # warps a block (the kernels' 256 threads)
MAX_COLS = 1536  # the general variant's widest row (48 elements a lane)
VEC_WIDTHS = (128, 160, 320, 768, 1024, 1280)  # vit_t's three, vit_b's, vit_l's, vit_h's


class LayernormPlan(NamedTuple):
    """``variant``: "vec" (16-byte vectors, bf16 at ``VEC_WIDTHS``) or
    "general" (one warp a row); ``lanes``: lanes a row; ``per_lane``:
    16-byte vectors (vec) or elements (general) a lane; ``rows_per_warp``;
    ``grid``: blocks of 8 warps (vec: persistent, at most ``blocks_per_sm``
    an SM)."""
    variant: str
    lanes: int
    per_lane: int
    rows_per_warp: int
    grid: int


def vec_layout(cols: int) -> Tuple[int, int]:
    """(lanes a row, vectors a lane) of the vector variant at ``cols`` bf16
    columns: the row's cols / 8 vectors over the largest power of two up to
    32 lanes that divides their count (``VecShape`` of the kernel)."""
    v = cols // 8
    lanes = 32
    while v % lanes:
        lanes //= 2
    return lanes, v // lanes


def blocks_per_sm(per_lane: int) -> int:
    """The blocks an SM the vector kernel's registers are held to (its
    launch bounds): gamma, beta and two row groups of 16-byte vectors a lane."""
    return {1: 4, 2: 3, 3: 2}.get(per_lane, 1)


@functools.lru_cache(maxsize=256)
def layernorm_plan(rows: int, cols: int, elt: int, align: int = 16) -> LayernormPlan:
    """The kernel's variant and layout for (rows, cols) of ``elt``-byte
    elements whose x, y, gamma and beta addresses are multiples of ``align``
    bytes (the kernel checks the same rules): the vector variant exactly
    where the elements are bf16, ``cols`` is one of ``VEC_WIDTHS`` and every
    address is 16-byte aligned, its grid the blocks the row groups need, at
    most ``blocks_per_sm`` on each of the SMs; else the general variant, a
    block per 8 rows."""
    if cols <= 0 or cols > MAX_COLS:
        raise ValueError(f"layernorm: {cols} columns; the kernel takes 1 to {MAX_COLS}")
    if elt == 2 and cols in VEC_WIDTHS and align % 16 == 0:
        lanes, nv = vec_layout(cols)
        per_warp = 32 // lanes
        blocks = _cdiv(_cdiv(rows, per_warp), WARPS)
        return LayernormPlan("vec", lanes, nv, per_warp,
                             max(1, min(blocks, SMS * blocks_per_sm(nv))))
    return LayernormPlan("general", 32, _cdiv(cols, 32), 1, max(1, _cdiv(rows, WARPS)))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_mask(rows: int, grid: Tuple[int, int, int, int], device) -> torch.Tensor:
    """The (rows,) f32 validity of the rows of padded (B, Hp, Wp) maps, ``grid``
    = (Hp, Wp, H, W): row (b, y, x) is 1 when y < H and x < W."""
    Hp, Wp, H, W = grid
    if rows % (Hp * Wp):
        raise ValueError(f"{rows} rows are not whole ({Hp}, {Wp}) maps")
    yx = torch.zeros((Hp, Wp), device=device)
    yx[:H, :W] = 1.0
    return yx.reshape(-1).repeat(rows // (Hp * Wp))


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float, valid: Optional[torch.Tensor] = None,
                    grid: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """x: (M, C); weight/bias: (C,) f32; valid: (M,) or None, or ``grid`` ->
    (M, C) in x.dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(x.dtype)
    if grid is not None:
        valid = grid_mask(x.shape[0], grid, x.device)
    if valid is not None:
        y = y * valid.reshape(-1, 1).to(y.dtype)
    return y


def _f32_on(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor on ``device``; itself where it is one."""
    if t.dtype == torch.float32 and t.device == device and t.is_contiguous():
        return t
    return t.to(device=device, dtype=torch.float32).contiguous()


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
              valid: Optional[torch.Tensor] = None,
              grid: Optional[Tuple[int, int, int, int]] = None,
              plan: Optional[LayernormPlan] = None) -> torch.Tensor:
    """LayerNorm over the last axis of a (M, C) tensor, then ``* valid[:, None]``,
    or with ``grid`` = (Hp, Wp, H, W) times the rows' validity in padded
    (B, Hp, Wp) maps (``grid_mask``).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    in the variant of ``layernorm_plan``, or of ``plan`` where given (the
    same result up to the statistics' summation order; for tests and timing)."""
    if valid is not None and grid is not None:
        raise ValueError("layernorm takes a valid mask or a grid, not both")
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps, valid, grid)
    if x.device.type != "cuda":
        raise RuntimeError(f"layernorm: unsupported device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"layernorm takes a contiguous (M, C) tensor, got {tuple(x.shape)}")
    M, C = x.shape
    w, b = _f32_on(weight, x.device), _f32_on(bias, x.device)
    v = None
    if valid is not None:
        v = _f32_on(valid.reshape(-1), x.device)
        if v.numel() != M:
            raise ValueError("layernorm: valid must hold one value per row")
    Hp, Wp, H, W = grid if grid is not None else (0, 0, 0, 0)
    if grid is not None and (Hp <= 0 or Wp <= 0 or M % (Hp * Wp)):
        raise ValueError(f"layernorm: {M} rows are not whole ({Hp}, {Wp}) maps")
    y = torch.empty_like(x)
    if plan is None:
        plan = layernorm_plan(M, C, x.element_size(), _alignment(x, y, w, b))
    lib = _cuda.library("layernorm")
    rc = lib.msam_layernorm(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            v.data_ptr() if v is not None else None, y.data_ptr(),
                            M, C, float(eps), Hp, Wp, H, W, _cuda.dtype_code(x),
                            int(plan.variant == "vec"), plan.lanes, plan.grid,
                            _cuda.stream_ptr(x))
    _cuda.check("layernorm", rc)
    layernorm.launches += 1
    return y


layernorm.launches = 0
