"""Depthwise 3 x 3 convolution with a folded BatchNorm and an optional GELU
(``csrc/dwconv.cu``) and its plain PyTorch version.

Replaces the depthwise stages inside the TPU kernels
``micro_sam_tpu/ops/fused_mbconv.py::_mbconv_kernel`` (gelu(bn2(dw3x3(h))) on
the MBConv's hidden map) and ``ops/fused_tiny_tail.py::_tiny_tail_kernel``
(bn(dw3x3(x)) of the block tail). Channel-last (B, H, W, C), stride 1, zero
padding 1, any H, W and C; the sum in f32, the result rounded to the working
type after the scale and shift, and again after the GELU (exact erf).

Bound on the H100: bytes (18 flops per output element against one element in
and one out). The kernel walks halo tiles of TH x TW pixels x CT channels,
brought into shared memory by one TMA load each (the padding zero-filled by
the TMA unit) through a 2-slot ring on a persistent grid; a thread slides
the 3 x 3 window of its 16 bytes of channels down a tile column in
registers. Shapes TMA cannot take run the same walk on tiles the block loads
itself. ``dwconv_plan`` picks the body and the tile; the weight is re-laid
once per weight tensor as (9, C) f32 (``_tap_major``).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

SMS = 132  # streaming multiprocessors of the H100 SXM: the tiles a wave takes
MAX_THREADS = 256  # a block's threads (the kernels' launch bounds)
THREADS = 128  # the threads a plan gives a block: two blocks an SM at the vit_t tiles
MAX_TW = 128  # tile columns: the TMA box's TW + 2 stays within its 256


class DwconvPlan(NamedTuple):
    """``body``: "tma" (halo tiles by TMA) or "plain" (tiles the block loads
    itself); ``vec``: channels a thread owns (16 bytes where the body is
    TMA); ``ct``: channels a tile (divides C); ``th`` / ``tw``: tile rows and
    columns."""
    body: str
    vec: int
    ct: int
    th: int
    tw: int

    def tiles(self, B: int, H: int, W: int, C: int) -> int:
        return C // self.ct * B * -(-H // self.th) * -(-W // self.tw)


@functools.lru_cache(maxsize=256)
def dwconv_plan(B: int, H: int, W: int, C: int, elt: int, align: int = 16) -> DwconvPlan:
    """The kernel's body and tile for a (B, H, W, C) map of ``elt``-byte
    elements whose x and y addresses are multiples of ``align`` bytes (the
    kernel checks the same rules):

    - the TMA body where C * elt is a multiple of 16 bytes and both are
      16-byte aligned (every vit_t shape), ``vec`` = 16 / elt channels a
      thread; else the plain body with the widest ``vec`` (16, 8, 4, 2 or 1
      element bytes) that divides C and the alignment;
    - ``ct``: the largest multiple of ``vec`` up to 128 bytes of channels that
      divides C (64 bf16 channels at C 64 / 128 / 256 / 320, 40 at 160);
    - ``tw`` = 128 threads / (ct / vec) (at most 128 and W), ``th`` = 16 (at
      most H); then, while the map gives fewer than two waves of tiles, ``th``
      halves down to 8, and while fewer than half a wave, ``tw`` halves down
      to 8. (Timed on the card by ``kernel_replay.py . --dwconv-plans``: at
      the vit_t shapes 128-thread tiles of 16 or 8 rows were the fastest of
      128 and 256 threads, 4 to 32 rows; PERF.md §6.)"""
    if C % (16 // elt) == 0 and align % 16 == 0:
        body, vec = "tma", 16 // elt
    else:
        body, vec = "plain", 1
        for v in (16 // elt, 8 // elt, 4 // elt, 2 // elt):
            if v >= 1 and C % v == 0 and align % (v * elt) == 0:
                vec = v
                break
    ct = max(d for d in range(vec, max(vec, 128 // elt) + 1, vec) if C % d == 0)
    groups = ct // vec
    tw = max(1, min(W, MAX_TW, THREADS // groups))
    th = max(1, min(H, 16))
    plan = DwconvPlan(body, vec, ct, th, tw)
    while plan.tiles(B, H, W, C) < 2 * SMS and plan.th > 8:
        plan = plan._replace(th=max(8, plan.th // 2))
    while plan.tiles(B, H, W, C) < SMS // 2 and plan.tw > 8:
        plan = plan._replace(tw=max(8, plan.tw // 2))
    return plan


def _alignment(*ts: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every tensor's address."""
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


# (9, C) f32 re-layouts of the weights handed to ``dwconv``, keyed on the
# weight tensor; an entry is used while the weight's storage, shape and
# version are the same, so an in-place update of the weight re-lays it
_TAP_MAJOR: Dict[int, Tuple[torch.Tensor, Tuple, torch.Tensor]] = {}


def _tap_major(weight: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``weight`` (C, 1, 3, 3) as a contiguous (9, C) f32 tensor on ``device``
    (w9[3 di + dj, c] = weight[c, 0, di, dj]), made once per weight tensor."""
    key = (weight.data_ptr(), tuple(weight.shape), weight.dtype, weight.device,
           weight._version, device)
    hit = _TAP_MAJOR.get(id(weight))
    if hit is not None and hit[0] is weight and hit[1] == key:
        return hit[2]
    w9 = weight.detach().reshape(-1, 9).t().to(device=device, dtype=torch.float32).contiguous()
    if len(_TAP_MAJOR) >= 256:
        _TAP_MAJOR.clear()
    _TAP_MAJOR[id(weight)] = (weight, key, w9)
    return w9


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
           gelu: bool = False, plan: Optional[DwconvPlan] = None) -> torch.Tensor:
    """``act(dw3x3(x) * scale + shift)`` over a channel-last map. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (one launch)
    in the body and tile of ``dwconv_plan``, or of ``plan`` where given (the
    same result; for timing other tiles)."""
    if x.device.type == "cpu":
        return dwconv_plain(x, weight, scale, shift, gelu)
    if x.device.type != "cuda":
        raise RuntimeError(f"dwconv: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"dwconv takes a contiguous (B, H, W, C) map, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if weight.numel() != 9 * C or scale.numel() != C or shift.numel() != C:
        raise ValueError("dwconv: weight must be (C, 1, 3, 3), scale and shift (C,)")
    w9 = _tap_major(weight, x.device)
    s, t = (a.to(device=x.device, dtype=torch.float32).contiguous() for a in (scale, shift))
    y = torch.empty_like(x)
    if plan is None:
        plan = dwconv_plan(B, H, W, C, x.element_size(), _alignment(x, y))
    lib = _cuda.library("dwconv")
    rc = lib.msam_dwconv(x.data_ptr(), w9.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(),
                         B, H, W, C, int(gelu), _cuda.dtype_code(x), int(plan.body == "tma"),
                         plan.vec, plan.ct, plan.th, plan.tw, _cuda.stream_ptr(x))
    _cuda.check("dwconv", rc)
    dwconv.launches += 1
    return y


dwconv.launches = 0
