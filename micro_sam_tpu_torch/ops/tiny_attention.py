"""TinyViT window attention kernel (``csrc/tiny_attention.cu``) and its plain
PyTorch version.

Per (window, head) of the zero-padded (B, Hp, Wp, C) map, hd = 32:

    out = softmax((q k^T) * hd^-0.5 + B[h, |dy| * w + |dx|]) v

q, k and v are read from the qkv product's rows in upstream TinyViT's
per-head order (head h: q at columns 96h, k at 96h + 32, v at 96h + 64); the
result is written to the same rows of a (B * Hp * Wp, C) tensor at column 32h,
the order the proj product reads. ``attention_biases`` is the learned
(nH, w^2) table; ``bias_offset_index`` numbers the offsets as upstream's
``attention_bias_idxs`` does.

Replaces the attention core of the TPU kernel
``micro_sam_tpu/ops/fused_tiny_attention.py::_tiny_attn_kernel``, whose
skip-max softmax (a fixed exponent offset of 16, clamped at 80) is not
ported: both versions here take the exact per-row maximum.

Bound on the H100: bytes (4 N hd flops per head and token against 4 hd
values moved, N = 49 or 196). The bf16 kernel walks units of (window, group
of heads) on a persistent grid, a warp per (head, 16-row group), the unit's
q, k and v brought in by TMA through a two-slot ring, a whole row of logits
in registers on ``mma.sync``; ``tiny_attention_plan`` picks the heads a unit,
the warps and the grid. The f32 kernel is a SIMT loop.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .layernorm import _f32_on

HEAD_DIM = 32
WINDOWS = (7, 14)  # vit_t's stages
SMS = 132  # streaming multiprocessors of the H100 SXM
# the bf16 kernel's launch bounds: warps a block at most, and the blocks an SM
# its registers allow (85 registers a thread at window 7, 128 at window 14)
MAX_WARPS = {7: 8, 14: 13}
REG_BLOCKS_PER_SM = {7: 3, 14: 1}
SMEM_LIMIT = 232448  # dynamic shared memory a block may take (227 KB)
SMEM_PER_SM = 233472  # shared memory of an SM (228 KB), 1 KB of it reserved a block


class TinyAttentionPlan(NamedTuple):
    """The bf16 kernel's layout: ``heads`` a unit (a divisor of nH; a unit is
    one window's group of heads), ``warps`` a block (one per head and 16-row
    group), ``units`` in all, ``grid`` persistent blocks, ``slots`` of the
    load ring, ``smem`` bytes of dynamic shared memory a block,
    ``blocks_per_sm`` that fit an SM."""
    heads: int
    warps: int
    units: int
    grid: int
    slots: int
    smem: int
    blocks_per_sm: int


def smem_bytes(window: int, heads: int, nH: int) -> int:
    """The bf16 kernel's shared memory (``ta_layout`` of the kernel): two ring
    slots of 3 x heads parts of NP 64-byte rows (the outputs go over the q
    rows), the bias tables of all nH heads, the key offsets, two barriers,
    1024 bytes of alignment slack."""
    N = window * window
    NP, T = -(-N // 16) * 16, 2 * window - 1
    koff = (2 * 3 * heads * NP * 64 + nH * T * T * 4 + 15) & ~15
    bars = (koff + NP * 4 + 7) & ~7
    return bars + 16 + 1024


def blocks_per_sm(window: int, heads: int, nH: int) -> int:
    """Blocks of the plan's shape an SM holds: by the launch bounds' registers
    and by shared memory."""
    return max(1, min(REG_BLOCKS_PER_SM[window],
                      SMEM_PER_SM // (smem_bytes(window, heads, nH) + 1024)))


@functools.lru_cache(maxsize=256)
def tiny_attention_plan(B: int, Hp: int, Wp: int, C: int, nH: int,
                        window: int) -> TinyAttentionPlan:
    """The bf16 kernel's layout over a (B, Hp, Wp, C) map of ``nH`` heads in
    ``window`` x ``window`` windows (the kernel checks the same limits): a
    unit takes the most heads of a window (a divisor of nH) whose warps, one
    per head and 16-row group, fit the kernel's ``MAX_WARPS`` and whose
    shared memory fits the block's, so the row groups run side by side, not
    in turns (window 7: 2 heads, 8 warps; window 14: one head, 13 warps);
    the persistent grid takes the fewest rounds of units that
    ``blocks_per_sm`` blocks on each SM allow, with as few blocks as give
    every block the same number of units (``kernel_replay.py .
    --tiny-attention-plans``: at stage 3, 500 units, 250 blocks of 2 units
    each beat 396 blocks, some of 1 unit, some of 2)."""
    if window not in WINDOWS or C != nH * HEAD_DIM or Hp % window or Wp % window:
        raise ValueError(f"tiny_attention: no kernel for a ({B}, {Hp}, {Wp}, {C}) map of {nH} "
                         f"heads in windows of {window}")
    groups = -(-window * window // 16)
    fits = [d for d in range(1, nH + 1) if nH % d == 0 and d * groups <= MAX_WARPS[window]
            and smem_bytes(window, d, nH) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"tiny_attention: {nH} heads' bias tables at window {window} exceed "
                         f"a block's shared memory")
    heads = max(fits)
    units = B * (Hp // window) * (Wp // window) * (nH // heads)
    per_sm = blocks_per_sm(window, heads, nH)
    rounds = -(-units // (SMS * per_sm))
    return TinyAttentionPlan(heads, heads * groups, units, max(1, -(-units // rounds)), 2,
                             smem_bytes(window, heads, nH), per_sm)


def bias_offset_index(window: int, device=None) -> torch.Tensor:
    """(N, N) index of each (query, key) pair's offset (|dy|, |dx|) into the
    (nH, w^2) bias table: |dy| * w + |dx|."""
    r = np.arange(window * window)
    y, x = r // window, r % window
    idx = np.abs(y[:, None] - y[None, :]) * window + np.abs(x[:, None] - x[None, :])
    return torch.from_numpy(idx).to(device) if device is not None else torch.from_numpy(idx)


def tiny_attention_plain(qkv: torch.Tensor, attention_biases: torch.Tensor,
                         shape: Tuple[int, int, int], window: int) -> torch.Tensor:
    """qkv: (B * Hp * Wp, 3C) rows of the padded map; attention_biases (nH, w^2);
    shape (B, Hp, Wp). Returns (B * Hp * Wp, C) in qkv.dtype, computed in f32."""
    B, Hp, Wp = shape
    nH = attention_biases.shape[0]
    C = qkv.shape[1] // 3
    hd, w = C // nH, window
    ny, nx = Hp // w, Wp // w
    t = qkv.float().view(B, ny, w, nx, w, nH, 3, hd).permute(6, 0, 1, 3, 5, 2, 4, 7)
    q, k, v = t.reshape(3, B * ny * nx, nH, w * w, hd).unbind(0)
    # a host index (no device constant in a trace)
    bias = attention_biases.float()[:, bias_offset_index(w)]  # (nH, N, N)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5 + bias
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    o = o.view(B, ny, nx, nH, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(B * Hp * Wp, C).to(qkv.dtype)


def tiny_attention(qkv: torch.Tensor, attention_biases: torch.Tensor,
                   shape: Tuple[int, int, int], window: int,
                   plan: Optional[TinyAttentionPlan] = None) -> torch.Tensor:
    """Window attention over the qkv rows of a padded (B, Hp, Wp) map. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, in
    bf16 with the layout of ``tiny_attention_plan`` or of ``plan`` where
    given (the same result; for tests and timing)."""
    B, Hp, Wp = shape
    nH = attention_biases.shape[0]
    if qkv.dim() != 2 or qkv.shape[0] != B * Hp * Wp or qkv.shape[1] % (3 * nH):
        raise ValueError(f"tiny_attention: qkv {tuple(qkv.shape)} over the map {shape} "
                         f"with {nH} heads")
    if Hp % window or Wp % window or attention_biases.shape[1] != window * window:
        raise ValueError(f"tiny_attention: map {shape} and table "
                         f"{tuple(attention_biases.shape)} do not fit window {window}")
    if qkv.device.type == "cpu":
        return tiny_attention_plain(qkv, attention_biases, shape, window)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"tiny_attention: unsupported device {qkv.device}")
    hd = qkv.shape[1] // (3 * nH)
    if hd != HEAD_DIM or window not in WINDOWS:
        raise ValueError(f"tiny_attention: head dim {hd} / window {window} not built "
                         f"(head dim {HEAD_DIM}, windows {WINDOWS})")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("tiny_attention: qkv must be contiguous and 16-byte aligned")
    table = _f32_on(attention_biases, qkv.device)
    out = torch.empty((qkv.shape[0], nH * hd), device=qkv.device, dtype=qkv.dtype)
    heads = warps = grid = 0
    if qkv.dtype == torch.bfloat16:
        if plan is None:
            plan = tiny_attention_plan(B, Hp, Wp, nH * hd, nH, window)
        heads, warps, grid = plan.heads, plan.warps, plan.grid
    lib = _cuda.library("tiny_attention")
    rc = lib.msam_tiny_attention(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), B, Hp, Wp,
                                 nH, window, hd, float(hd ** -0.5), _cuda.dtype_code(qkv),
                                 heads, warps, grid, _cuda.stream_ptr(qkv))
    _cuda.check("tiny_attention", rc)
    tiny_attention.launches += 1
    return out


tiny_attention.launches = 0
