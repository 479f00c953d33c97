"""Rel-pos flash attention kernels (``csrc/relpos_attention.cu`` forward,
``csrc/relpos_attention_bwd.cu`` backward), their plain PyTorch versions and
the autograd function that joins them.

Computes, per (batch, head), over an (H, W) token grid with N = H * W:

    out = softmax((q * hd^-0.5) k^T + bias) v
    bias[i, j] = q_i . rel_h[y(i), y(j)] + q_i . rel_w[x(i), x(j)]   (unscaled q)

The forward replaces ``micro_sam_tpu/ops/flash_attention.py::_flash_kernel_qkv``
(reached through ``flash_attention_qkv``) and the attention stage inside
``ops/fused_window_block.py::_fused_block_kernel`` / ``::_fused_global_kernel``;
the backward replaces ``flash_attention.py::_flash_bwd_kernel`` (reached
through ``_flash_backward_qkv``, the custom_vjp backward of
``flash_attention_qkv``).

Forward bound on the H100: operations (4 N^2 hd flops per head against 4 N hd
values moved: a vit_b global block is 52 GFLOP). The bias is built in the
kernel from per-row u tables, so neither N x N logits nor the bias touch
device memory. In bf16 both products run on the tensor cores (``mma.sync``)
with logits, probabilities and output in registers; keys are tiled in whole
map rows, so each thread's share of the bias sits in registers. Three
variants (``forward_plan``, a pure function of N, H, W and the head dim, the
same on every route): ``"window"`` (the 14 x 14 windows: one block per
window and head, the window's keys resident), ``"rows"`` (W <= 64: a block
per patch of q cells, key tiles of 64 / W whole rows) and ``"general"``
(W > 64: key tiles of 64-column row segments). f32 is a plain SIMT loop. q, k, v and out
are strided views (the head dim contiguous), so the kernel reads the qkv
product's rows and writes the proj product's rows in place.

The forward can also store each row's log-sum-exp of the logits (``lse``,
natural units, one f32 store a row); ``RelPosAttentionFn`` keeps it for the
backward, so the backward does not walk the keys again for its row
statistics.

Backward: four launches (u rows and D, dk/dv, dq with the per-key-row and
per-key-column sums of dS, the table gradients), about 10 N^2 hd flops per
head; see the source for the design. Stages 1 and 2 have the forward's
three variants in bf16 (``backward_plan``): ``"window"`` (the window's keys
and q rows resident, a block per window and head), ``"rows"`` and
``"general"``.

Head dims: both directions are built for 32, 64 (vit_b, vit_l), 80 (vit_h),
96, 128 and 256 (``HEAD_DIMS``; above 128 each block computes one 128-column
slice of its output). A CUDA tensor of another head dim runs in the smallest
built one at least as large: the wrapper stages q, k, v, the tables (and for
the backward out and dout) into zero-padded buffers, keeps the scale at the
true head dim's ``hd ** -0.5`` and writes the first ``hd`` columns back. Zero
columns add nothing to q . k or q . rel, and the extra output columns (and
those of d rel_h / d rel_w) are dropped, so the result is the same function.
Views the kernels cannot read in place (rows not 16-byte aligned, a strided
head dim) go through the same staging. Above 256 both raise. The plain
versions take any head dim.

Key rectangles: the rows / general variants keep a u table of H + W entries
a q row in shared memory, which outgrows a block above H + W of about 600
(the 64 x 64 and 14 x 14 grids of every SAM ViT at ``img_size`` 1024 are far
below; a 336 x 336 grid is not). Both directions take a key rectangle (first
row, first column, rows, columns), whose u tables hold its own entries;
``forward_plan`` / ``backward_plan`` split a map whose tables would not fit
into the fewest rectangles that do (``key_rects``), one launch (of each
stage) a rectangle. The forward merges the rectangles' partial outputs by
their log-sum-exps in the kernel (each launch after the first reads the
joint lse so far and the output, and writes both); the backward, with the
forward's global lse and D, writes each rectangle's dk and dv and adds its
dq and table gradients into the ones before. A grid that fits takes one
rectangle, the whole map, and the launches it always took.

Spatial mode (``relpos_attention_spatial``): the forward over the w x w
windows of padded (B, Hp, Wp) token maps, reading q, k, v from the map's rows
and writing the output into them, for ``fused_window_block_spatial`` (the
TPU's spatial window kernel).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _cuda

HEAD_DIMS = _cuda.RELPOS_HEAD_DIMS  # the forward's instantiated head dims
BWD_HEAD_DIMS = _cuda.RELPOS_BWD_HEAD_DIMS  # the backward's: the same
MAX_HEAD_DIM = HEAD_DIMS[-1]
MAX_BWD_HEAD_DIM = BWD_HEAD_DIMS[-1]


def kernel_head_dim(hd: int, dims: Tuple[int, ...] = HEAD_DIMS) -> int:
    """The instantiated head dim a head dim ``hd`` runs in: the smallest of
    ``dims`` at least as large. Raises above the largest."""
    for d in dims:
        if d >= hd:
            return d
    raise ValueError(f"the rel-pos attention kernels (forward and backward) take head dims up "
                     f"to {dims[-1]}, not {hd}")


# the forward kernel's variants (VAR_* in csrc/relpos_attention.cu)
VARIANT_CODES = {"rows": 0, "general": 1, "window": 2}
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on the H100 (227 KB)


class KeyRect(NamedTuple):
    """The keys one launch attends over: map rows [ky0, ky0 + kh), columns
    [kx0, kx0 + kw)."""
    ky0: int
    kx0: int
    kh: int
    kw: int


class ForwardPlan(NamedTuple):
    """The bf16 forward kernel's ``variant`` for a grid, its kernel ``code``,
    and the key rectangles it is launched over (one: the whole map), each
    with the variant code of its launch."""
    variant: str
    code: int
    rects: Tuple[Tuple[KeyRect, int], ...]


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _uw_len(kw: int) -> int:
    """The u_w entries a u row keeps over a key rectangle kw columns wide
    (``tiling_of``'s uwl): kw padded to 8, then to 64-slot segments above 64."""
    wp = -(-kw // 8) * 8
    return wp if wp <= 64 else -(-wp // 64) * 64


def _out_cols(hd: int) -> int:
    return 128 if hd > 128 else hd


def _tiled_smem(H: int, W: int, hd: int, kh: int, kw: int) -> int:
    """Bytes of shared memory the bf16 forward's rows / general variants take
    (``bf16_smem`` in the kernel) on an H x W map over a kh x kw key
    rectangle: the q patch (16 or 8 map rows of 8 cells), the k / v ring,
    the f32 u rows of the rectangle (odd pitch)."""
    ldk, ldv = hd + 8, _out_cols(hd) + 8
    qr = 8 * (16 if hd <= 128 and H <= 64 and W <= 64 else 8)
    ring = 3 if hd <= 80 else 2
    uwl = _uw_len(kw)
    return _align128(2 * (qr * ldk + ring * 64 * (ldk + ldv))) + 4 * qr * ((kh + uwl) | 1)


def _f32_smem(hd: int, kh: int, kw: int) -> int:
    """Bytes of shared memory the f32 forward takes (``f32_smem``) over a kh
    x kw key rectangle."""
    qr, nv = (32 if hd > 128 else 64), _out_cols(hd)
    head = _align128(4 * (qr * (hd + 8) + 64 * (hd + 8) + 64 * (nv + 8) + 2 * qr * 68
                          + qr * (nv + 4)))
    return head + 4 * qr * (kh + kw + 1)


def key_rects(H: int, W: int, fits: Callable[[int, int], bool]) -> Tuple[KeyRect, ...]:
    """The fewest key rectangles that cover the H x W map, each key once, for
    which ``fits(kh, kw)`` holds: the whole map where it fits, else bands of
    kh rows crossed with segments of kw columns (the last band and segment
    may be shorter; ``fits`` grows with kh and kw), fewest bands on a tie."""
    if fits(H, W):
        return (KeyRect(0, 0, H, W),)
    best = None
    for ny in range(1, H + 1):
        kh = -(-H // ny)
        if best is not None and -(-H // kh) > best[0]:
            break
        for nx in range(1, W + 1):
            kw = -(-W // nx)
            if fits(kh, kw):
                n = (-(-H // kh), -(-W // kw))
                if best is None or n[0] * n[1] < best[0] * best[1]:
                    best = (n[0], n[1], kh, kw)
                break
    if best is None:
        raise ValueError(f"rel-pos attention: no key rectangle of an {H} x {W} map fits")
    _, _, kh, kw = best
    return tuple(KeyRect(y, x, min(kh, H - y), min(kw, W - x))
                 for y in range(0, H, kh) for x in range(0, W, kw))


def _tiled_code(rect: KeyRect) -> int:
    return VARIANT_CODES["rows" if rect.kw <= 64 else "general"]


def _window_smem(N: int, H: int, W: int, hd: int) -> int:
    """Bytes of shared memory the window variant takes (``bf16_smem`` in the
    kernel): k and v of the window's padded key slots, its q rows and their
    f32 u tables, all resident."""
    wp = -(-W // 8) * 8
    ld = hd + 8
    slots, rows = (H * wp + 8 + 15) // 16 * 16, -(-N // 16) * 16
    return _align128(2 * (slots * 2 * ld + rows * ld)) + 4 * rows * ((H + wp) | 1)


@functools.lru_cache(maxsize=256)
def forward_plan(N: int, H: int, W: int, hd: int) -> ForwardPlan:
    """The forward variant for an (H, W) grid (N = H * W) at kernel head dim
    ``hd`` (the kernel checks the same rule):

    - ``"window"``: hd <= 128, W <= 64, the keys padded to rows of W rounded
      up to 8 fit 256 slots and the whole window fits shared memory (the 14 x 14
      windows of every SAM ViT): one block per (batch, head), keys resident;
    - ``"rows"``: W <= 64 otherwise: a block per patch of q cells, key tiles
      of whole map rows (the global grid: one row a tile);
    - ``"general"``: W > 64: key tiles of 64-slot row segments.

    Where the rows / general variants' u tables would not fit shared memory
    over the whole map, the keys are split into ``key_rects`` that fit, each
    launched in the variant its columns take (rows up to 64, else general)."""
    wp = -(-W // 8) * 8
    if hd <= 128 and wp <= 64 and H * wp <= 256 and _window_smem(N, H, W, hd) <= SMEM_LIMIT:
        return ForwardPlan("window", VARIANT_CODES["window"], ((KeyRect(0, 0, H, W), 2),))
    rects = key_rects(H, W, lambda kh, kw: _tiled_smem(H, W, hd, kh, kw) <= SMEM_LIMIT)
    variant = "rows" if rects[0].kw <= 64 else "general"
    return ForwardPlan(variant, VARIANT_CODES[variant], tuple((r, _tiled_code(r)) for r in rects))


@functools.lru_cache(maxsize=256)
def f32_forward_rects(H: int, W: int, hd: int) -> Tuple[KeyRect, ...]:
    """The f32 forward's key rectangles (its u rows, of kh + kw + 1 entries,
    within shared memory)."""
    return key_rects(H, W, lambda kh, kw: _f32_smem(hd, kh, kw) <= SMEM_LIMIT)


class BackwardPlan(NamedTuple):
    """The bf16 backward's variants of its dk/dv stage (1) and its dq stage
    (2), and the kernel code of each of the four stages (stages 0 and 3 have
    one form); with the key rectangles it runs over (one: the whole map),
    each with the four stages' codes of its launches."""
    dkdv: str
    dq: str
    codes: Tuple[int, int, int, int]
    rects: Tuple[Tuple[KeyRect, Tuple[int, int, int, int]], ...]


UHC = 20  # u_h columns a stage-1 block of the rows / general variants keeps a q row


def _bwd_tiled_smem(stage: int, H: int, W: int, hd: int, kh: int, kw: int) -> int:
    """Bytes of shared memory stage 0 (prep), 1 (dk/dv) or 2 (dq) of the bf16
    backward takes in its rows / general variant (``prep_bf16_smem``,
    ``dkdv_bf16_smem``, ``dq_bf16_smem``) on an H x W map over a kh x kw key
    rectangle; a u row is u_h (kh to a multiple of 4) then u_w (uwl)."""
    ldk, nv = hd + 8, _out_cols(hd)
    uwl = _uw_len(kw)
    ug = -(-kh // 4) * 4 + uwl
    if stage == 0:
        return _align128(2 * 64 * ldk) + 4 * 64 * _pitch_4mod8(ug)
    if stage == 1:
        qb, ring, tpb = (32, 2, 1) if hd > 128 else (64, 3 if hd <= 80 else 2, 2)
        p = _pitch_4mod16(UHC + uwl)
        slot = _align128(2 * 2 * qb * ldk + 4 * qb * (p + 2))
        return _align128(2 * 2 * 64 * tpb * ldk) + ring * slot
    py = 4 if hd > 128 else (16 if H <= 64 and W <= 64 else 8)
    qr = 8 * py
    ring = 2 * (3 if hd <= 96 else 2) * 64 * 2 * ldk
    stage_bytes = 4 * qr * (nv + 4)
    return (_align128(2 * 2 * qr * ldk) + _align128(max(ring, stage_bytes))
            + 4 * qr * (_pitch_4mod8(ug) + (uwl if kw > 64 else 0)))


def _bwd_f32_smem(stage: int, hd: int, kh: int, kw: int) -> int:
    """Bytes of shared memory the f32 backward's stage 1 or 2 takes
    (``dkdv_f32_smem`` / ``dq_f32_smem``) over a kh x kw key rectangle."""
    fr = 32 if hd > 128 else 64
    uwl = _uw_len(kw)
    ug = -(-kh // 4) * 4 + uwl
    tiles = _align128(4 * (4 * fr * (hd + 8) + (3 - stage) * fr * (fr + 4)))
    return tiles + 4 * fr * ((ug + 2) if stage == 1 else (2 * ug + 2))


def _pitch_4mod8(n: int) -> int:
    return n if n % 8 else n + 4


def _pitch_4mod16(n: int) -> int:
    while n % 16 not in (4, 12):
        n += 4
    return n


def _bwd_window_smem(stage: int, N: int, H: int, W: int, hd: int) -> int:
    """Bytes of shared memory the backward's window variant of stage 1 (dk/dv)
    or 2 (dq) takes (``dkdv_bf16_smem`` / ``dq_bf16_smem`` in the kernel): k,
    v, q and dO of the whole window and its f32 u rows (stage 1 also lse and
    D), resident."""
    wp = -(-W // 8) * 8
    ld = hd + 8
    slots, rows = (H * wp + 8 + 15) // 16 * 16, -(-N // 16) * 16
    ug = -(-H // 4) * 4 + wp  # a u row: u_h to a multiple of 4, then u_w
    per_row = _pitch_4mod16(ug) + 2 if stage == 1 else _pitch_4mod8(ug)
    return _align128(2 * (2 * slots + 2 * rows) * ld) + 4 * rows * per_row


@functools.lru_cache(maxsize=256)
def backward_plan(N: int, H: int, W: int, hd: int) -> BackwardPlan:
    """The bf16 backward's variants for an (H, W) grid (N = H * W) at kernel
    head dim ``hd`` (the kernel checks the same rule), for its dk/dv stage and
    its dq stage each:

    - ``"window"``: hd <= 128, W <= 64, the keys padded to rows of W rounded up
      to 8 fit 256 slots and the stage's resident window fits shared memory
      (the 14 x 14 windows up to head dim 96); for the dq stage also rows of
      16 slots (9 <= W <= 16): one block per (batch, head);
    - ``"rows"``: W <= 64 otherwise: key tiles of whole map rows;
    - ``"general"``: W > 64: key tiles of 64-slot row segments.

    Where a rows / general stage (or stage 0) would not fit shared memory
    over the whole map, the keys are split into ``key_rects`` in which the
    prep, dk/dv and dq stages all fit, each rectangle's stages 1 and 2 in the
    variant its columns take."""
    wp = -(-W // 8) * 8
    names = []
    for stage in (1, 2):
        if (hd <= 128 and wp <= 64 and H * wp <= 256 and (stage == 1 or wp == 16)
                and _bwd_window_smem(stage, N, H, W, hd) <= SMEM_LIMIT):
            names.append("window")
        else:
            names.append("rows" if W <= 64 else "general")
    codes = (0, VARIANT_CODES[names[0]], VARIANT_CODES[names[1]], 0)

    def fits(kh, kw):
        whole = (kh, kw) == (H, W)
        return all((stage > 0 and whole and names[stage - 1] == "window")
                   or _bwd_tiled_smem(stage, H, W, hd, kh, kw) <= SMEM_LIMIT
                   for stage in (0, 1, 2))
    rects = key_rects(H, W, fits)
    if len(rects) == 1:
        return BackwardPlan(names[0], names[1], codes, ((rects[0], codes),))
    tiled = tuple((r, (0, _tiled_code(r), _tiled_code(r), 0)) for r in rects)
    name = "rows" if rects[0].kw <= 64 else "general"
    return BackwardPlan(name, name, tiled[0][1], tiled)


@functools.lru_cache(maxsize=256)
def f32_backward_rects(H: int, W: int, hd: int) -> Tuple[KeyRect, ...]:
    """The f32 backward's key rectangles (its dk/dv and dq stages' u rows
    within shared memory)."""
    return key_rects(H, W, lambda kh, kw: max(_bwd_f32_smem(1, hd, kh, kw),
                                              _bwd_f32_smem(2, hd, kh, kw)) <= SMEM_LIMIT)


def _in_place(t: torch.Tensor) -> bool:
    """Whether a kernel reads (or writes) ``t`` where it lies: a contiguous
    last axis and 16-byte aligned rows."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * item) % 16 == 0 for s in t.stride()[:-1]))


def _staged(t: torch.Tensor, hdp: int, ok: Callable[[torch.Tensor], bool] = _in_place,
            fill: bool = True) -> torch.Tensor:
    """``t`` itself when its last axis is ``hdp`` long and ``ok(t)``; else a
    contiguous buffer with ``hdp`` columns, its first ``t.shape[-1]`` columns
    a copy of ``t`` (with ``fill``) and the rest zero (an output buffer when
    not ``fill``)."""
    if t.shape[-1] == hdp and ok(t):
        return t
    if not fill:
        return torch.empty(t.shape[:-1] + (hdp,), device=t.device, dtype=t.dtype)
    buf = t.new_zeros(t.shape[:-1] + (hdp,))
    buf[..., :t.shape[-1]].copy_(t)
    return buf


def _tables(rel_h: torch.Tensor, rel_w: torch.Tensor, dt: torch.dtype, hdp: int):
    """The rel-pos tables as the kernels read them: contiguous (H, H, hdp) /
    (W, W, hdp) in ``dt``."""
    return tuple(_staged(t.to(dt).contiguous(), hdp) for t in (rel_h, rel_w))


def _launch_forward(q, k, v, rel_h, rel_w, out, dims, geo, ok, strides_of, lse=None) -> int:
    """The forward kernel's launches for one call (one a key rectangle);
    returns their count. ``dims`` = (B, nH, N, H, W) as the kernel sees
    them, ``geo`` = (window, nwy, nwx) (zeros: the plain mode); ``ok`` /
    ``strides_of``: whether the kernel takes a tensor where it lies, and its
    (batch, head, token) element strides; ``lse``: None or the (B, nH, N)
    f32 buffer the rows' log-sum-exps go to."""
    B, nH, N, H, W = dims
    hd = q.shape[-1]
    hdp = kernel_head_dim(hd)
    for t in (k, v, out):
        if t.dtype != q.dtype or t.device != q.device or t.shape != q.shape:
            raise ValueError("relpos_attention: q, k, v, out share shape, dtype and device")
    if rel_h.shape != (H, H, hd) or rel_w.shape != (W, W, hd):
        raise ValueError("relpos_attention: rel tables must be (H, H, hd) and (W, W, hd)")
    rh, rw = _tables(rel_h, rel_w, q.dtype, hdp)
    qs, ks, vs = (_staged(t, hdp, ok) for t in (q, k, v))
    os_ = _staged(out, hdp, ok, fill=False)
    strides = [x for t in (qs, ks, vs, os_) for x in strides_of(t)]
    n = _forward_launches(qs, ks, vs, rh, rw, os_, dims, hdp, float(hd ** -0.5), geo, strides, lse)
    if os_ is not out:
        out.copy_(os_[..., :hd])
    return n


def _forward_launches(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides, lse=None) -> int:
    """``_forward_kernel`` over the key rectangles of the plan (the bf16
    ``forward_plan``'s, or ``f32_forward_rects``): one launch for a map
    that fits, as it always was; else one a rectangle, each after the first
    merging into the output by the log-sum-exps of those before, which go
    back and forth between ``lse`` (or a buffer of its own) and a second
    buffer so that the last launch writes them into ``lse``. Returns the
    launches."""
    B, nH, N, H, W = dims
    if q.dtype == torch.bfloat16:
        rects = forward_plan(N, H, W, hdp).rects
    else:
        rects = tuple((r, 0) for r in f32_forward_rects(H, W, hdp))
    if len(rects) == 1:
        _forward_kernel(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides, lse)
        return 1
    if geo[0]:
        raise ValueError("relpos_attention_spatial: a window too large for one key rectangle")
    final = lse if lse is not None else torch.empty((B, nH, N), device=q.device,
                                                    dtype=torch.float32)
    bufs = (final, torch.empty_like(final))
    for i, (rect, code) in enumerate(rects):
        _forward_kernel(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides,
                        bufs[(len(rects) - 1 - i) % 2], rect=rect, code=code,
                        lse_prev=None if i == 0 else bufs[(len(rects) - i) % 2])
    return len(rects)


def _forward_kernel(q, k, v, rh, rw, out, dims, hdp, scale, geo, strides, lse=None, rect=None,
                    code=None, lse_prev=None) -> None:
    """One launch of ``csrc/relpos_attention.cu`` on operands it takes as they
    are (head dim ``hdp``, one of ``HEAD_DIMS``), ``scale`` the true head
    dim's, in the variant ``forward_plan`` picks; with ``lse``, the rows'
    log-sum-exps into it. ``rect`` (default the whole map): the keys it
    attends over, in the variant ``code``; ``lse_prev``: the log-sum-exps of
    the rectangles launched before, whose output in ``out`` it merges into."""
    B, nH, N, H, W = dims
    if rect is None:
        rect, code = KeyRect(0, 0, H, W), forward_plan(N, H, W, hdp).code
    name = f"relpos_attention_hd{hdp}"
    rc = _cuda.library(name).msam_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), 0 if lse_prev is None else lse_prev.data_ptr(),
        B, nH, N, H, W, hdp, (_cuda._LL * 12)(*strides), scale, *geo, code, *rect,
        _cuda.dtype_code(q), _cuda.stream_ptr(q))
    _cuda.check(name, rc)


def _logits_plain(qf, kf, rel_h, rel_w, hw):
    """The (B, nH, N, N) f32 logits of f32 q, k: scaled q . k plus the bias."""
    B, nH, N, hd = qf.shape
    H, W = hw
    logits = (qf * hd ** -0.5) @ kf.transpose(-1, -2)
    r_q = qf.reshape(B, nH, H, W, hd)
    rh = torch.einsum("bnijc,ikc->bnijk", r_q, rel_h.float())
    rw = torch.einsum("bnijc,jkc->bnijk", r_q, rel_w.float())
    return (logits.view(B, nH, H, W, H, W) + rh[..., :, None] + rw[..., None, :]).view(B, nH, N, N)


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           hw: Tuple[int, int], lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, nH, N, hd) (any strides); rel_h (H, H, hd), rel_w (W, W, hd).
    Returns (B, nH, N, hd) in q.dtype, computed in f32. ``lse``, when given,
    a (B, nH, N) f32 tensor, takes each row's log-sum-exp of the logits."""
    logits = _logits_plain(q.float(), k.float(), rel_h, rel_w, hw)
    if lse is not None:
        lse.copy_(torch.logsumexp(logits, dim=-1))
    w = torch.softmax(logits, dim=-1)
    return (w @ v.float()).to(q.dtype)


def _logits_rows(qf, kf, rel_h, rel_w, hw, rows):
    """The f32 logits of q rows ``rows`` (a 1-d index tensor) against every
    key: (B, nH, R, N)."""
    B, nH, N, hd = kf.shape
    H, W = hw
    qs = qf[:, :, rows]
    R = qs.shape[2]
    logits = (qs * hd ** -0.5) @ kf.transpose(-1, -2)
    bh = torch.einsum("bnrc,rkc->bnrk", qs, rel_h.float()[rows // W])
    bw = torch.einsum("bnrc,rkc->bnrk", qs, rel_w.float()[rows % W])
    return (logits.view(B, nH, R, H, W) + bh[..., :, None] + bw[..., None, :]).view(B, nH, R, N)


def relpos_attention_plain_rows(q, k, v, rel_h, rel_w, hw, rows):
    """``relpos_attention_plain`` for the q rows ``rows`` only (a 1-d index
    tensor), against all keys: (out rows (B, nH, R, hd) in f32, their
    log-sum-exps (B, nH, R)). For holding the kernels to the plain version
    on maps whose N x N logits would not fit."""
    logits = _logits_rows(q.float(), k.float(), rel_h, rel_w, hw, rows)
    return torch.softmax(logits, dim=-1) @ v.float(), torch.logsumexp(logits, dim=-1)


def relpos_attention_backward_plain_rows(q, k, v, out, dout, rel_h, rel_w, hw, rows):
    """``relpos_attention_backward_plain`` (f32) where ``dout`` is zero outside
    the q rows ``rows``: only those rows' probabilities and dS are formed
    (R x N, not N x N). Returns (dq, dk, dv, d rel_h, d rel_w) in f32: dq is
    zero outside ``rows``; dk, dv and the table gradients come from those
    rows alone, which is all of them when dout is zero elsewhere."""
    B, nH, N, hd = q.shape
    H, W = hw
    s = hd ** -0.5
    qf, kf, vf = (t.float() for t in (q, k, v))
    gs, os_ = dout.float()[:, :, rows], out.float()[:, :, rows]
    rh, rw = rel_h.float(), rel_w.float()
    p = torch.softmax(_logits_rows(qf, kf, rh, rw, hw, rows), dim=-1)  # (B, nH, R, N)
    dv = p.transpose(-1, -2) @ gs
    ds = p * (gs @ vf.transpose(-1, -2) - (gs * os_).sum(-1, keepdim=True))
    qs = qf[:, :, rows]
    dk = s * (ds.transpose(-1, -2) @ qs)
    R = qs.shape[2]
    ds5 = ds.view(B, nH, R, H, W)
    ds_rows, ds_cols = ds5.sum(-1), ds5.sum(-2)  # (B, nH, R, H), (B, nH, R, W)
    ys, xs = rows // W, rows % W
    dq = torch.zeros_like(qf)
    dq[:, :, rows] = (s * (ds @ kf) + torch.einsum("bnrk,rkc->bnrc", ds_rows, rh[ys])
                      + torch.einsum("bnrk,rkc->bnrc", ds_cols, rw[xs]))
    drh = torch.zeros_like(rh).index_put_(
        (ys,), torch.einsum("bnrk,bnrc->rkc", ds_rows, qs), accumulate=True)
    drw = torch.zeros_like(rw).index_put_(
        (xs,), torch.einsum("bnrk,bnrc->rkc", ds_cols, qs), accumulate=True)
    return dq, dk, dv, drh, drw


def _check_lse(lse: Optional[torch.Tensor], q: torch.Tensor, who: str) -> None:
    B, nH, N, _ = q.shape
    if lse is not None and (lse.shape != (B, nH, N) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{who}: lse must be a contiguous (B, nH, N) float32 tensor on "
                         f"q's device")


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor, hw: Tuple[int, int],
                     out: Optional[torch.Tensor] = None,
                     lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention with the decomposed rel-pos bias over strided (B, nH, N, hd)
    views. ``out``, when given, is a (B, nH, N, hd) view the result is written
    into (and returned); ``lse``, when given, a contiguous (B, nH, N) f32
    tensor that takes each row's log-sum-exp of the logits (what the backward
    reads). A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, for any head dim up to ``MAX_HEAD_DIM`` (256)."""
    B, nH, N, hd = q.shape
    H, W = hw
    if N != H * W or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"relpos_attention: shapes {tuple(q.shape)} over grid {hw}")
    _check_lse(lse, q, "relpos_attention")
    if q.device.type == "cpu":
        res = relpos_attention_plain(q, k, v, rel_h, rel_w, hw, lse)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention: unsupported device {q.device}")
    if out is None:
        out = torch.empty((B, nH, N, hd), device=q.device, dtype=q.dtype)
    relpos_attention.launches += _launch_forward(q, k, v, rel_h, rel_w, out, (B, nH, N, H, W),
                                                 (0, 0, 0), _in_place, lambda t: t.stride()[:3],
                                                 lse)
    return out


relpos_attention.launches = 0


def _windows(m: torch.Tensor, w: int) -> torch.Tensor:
    """(B, Hp, Wp, nH, hd) maps -> their (B * nW, nH, w * w, hd) windows (a copy)."""
    B, Hp, Wp, nH, hd = m.shape
    m = m.reshape(B, Hp // w, w, Wp // w, w, nH, hd).permute(0, 1, 3, 5, 2, 4, 6)
    return m.reshape(-1, nH, w * w, hd)


def _unwindows(o: torch.Tensor, B: int, Hp: int, Wp: int, w: int) -> torch.Tensor:
    """(B * nW, nH, w * w, hd) windows -> (B, Hp, Wp, nH, hd) maps."""
    nH, hd = o.shape[1], o.shape[3]
    o = o.reshape(B, Hp // w, Wp // w, nH, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(B, Hp, Wp, nH, hd)


def relpos_attention_spatial_plain(q, k, v, rel_h, rel_w, window: int) -> torch.Tensor:
    """The spatial mode's plain version: partition the (B, Hp, Wp, nH, hd)
    maps into windows, ``relpos_attention_plain`` over each, and back."""
    B, Hp, Wp, _, _ = q.shape
    res = relpos_attention_plain(*(_windows(t, window) for t in (q, k, v)), rel_h, rel_w,
                                 (window, window))
    return _unwindows(res, B, Hp, Wp, window)


def relpos_attention_spatial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel_h: torch.Tensor, rel_w: torch.Tensor, window: int,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relpos_attention`` over each ``window`` x ``window`` window of padded
    token maps, straight from the maps: q, k, v and ``out`` (written into and
    returned when given) are (B, Hp, Wp, nH, hd) views, Hp and Wp multiples
    of ``window``, with rel_h / rel_w the (window, window, hd) tables. The
    kernel's spatial mode reads each window's tokens from the map rows by
    index arithmetic (the qkv product's rows in, the proj product's rows
    out), with no partition copy. A CPU tensor takes the plain version."""
    B, Hp, Wp, nH, hd = q.shape
    w = window
    if Hp % w or Wp % w or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"relpos_attention_spatial: shapes {tuple(q.shape)}, window {w}")
    if q.device.type == "cpu":
        res = relpos_attention_spatial_plain(q, k, v, rel_h, rel_w, w)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention_spatial: unsupported device {q.device}")
    if out is None:
        out = torch.empty((B, Hp, Wp, nH, hd), device=q.device, dtype=q.dtype)
    nwy, nwx = Hp // w, Wp // w

    def ok(t):  # map rows: row (y, x) at (y * Wp + x) * token stride
        return _in_place(t) and t.stride(1) == Wp * t.stride(2) and t.stride(0) == Hp * t.stride(1)
    relpos_attention_spatial.launches += _launch_forward(
        q, k, v, rel_h, rel_w, out, (B * nwy * nwx, nH, w * w, w, w), (w, nwy, nwx), ok,
        lambda t: (0, t.stride(3), t.stride(2)))
    return out


relpos_attention_spatial.launches = 0


def relpos_attention_backward_plain(q, k, v, out, dout, rel_h, rel_w, hw, lse=None):
    """The VJP of ``relpos_attention_plain`` written out, in f32.

    q, k, v, out, dout: (B, nH, N, hd) (any strides); rel_h (H, H, hd), rel_w
    (W, W, hd). Returns (dq, dk, dv) in q.dtype and (d rel_h, d rel_w) in f32.
    ``out`` is the forward's output (D = rowsum(dout * out)); ``lse``, when
    given, the forward's (B, nH, N) row log-sum-exps, from which the
    probabilities are taken (P = exp(S - lse)) instead of a softmax."""
    B, nH, N, hd = q.shape
    H, W = hw
    s = hd ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    rh, rw = rel_h.float(), rel_w.float()
    r_q = qf.reshape(B, nH, H, W, hd)
    logits = _logits_plain(qf, kf, rh, rw, hw)
    if lse is None:
        p = torch.softmax(logits, dim=-1)
    else:
        p = torch.exp(logits - lse.float()[..., None])
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    ds = p * (dp - (gf * of).sum(-1, keepdim=True))
    dk = s * (ds.transpose(-1, -2) @ qf)
    ds6 = ds.view(B, nH, H, W, H, W)
    ds_rows = ds6.sum(-1)  # (B, nH, H, W, H): per key row y(j)
    ds_cols = ds6.sum(-2)  # (B, nH, H, W, W): per key column x(j)
    dq = s * (ds @ kf) + (torch.einsum("bnijk,ikc->bnijc", ds_rows, rh)
                          + torch.einsum("bnijk,jkc->bnijc", ds_cols, rw)).reshape(B, nH, N, hd)
    drh = torch.einsum("bnijk,bnijc->ikc", ds_rows, r_q)
    drw = torch.einsum("bnijk,bnijc->jkc", ds_cols, r_q)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), drh, drw


def _bwd_scratch_floats(B: int, nH: int, N: int, H: int, W: int) -> int:
    """Length of the backward's f32 scratch (``scratch_floats`` in the source)
    for N q rows over an H x W key rectangle (the whole map, or one of its
    key rectangles): per (batch, head) and token the u row (u_h to a
    multiple of 4 entries, then u_w to the key tiles' width), lse in log2
    units, D, and the per-key-row and per-key-column sums of dS (H and W
    rounded up to 16)."""
    wp = -(-W // 8) * 8
    uwl = wp if wp <= 64 else -(-wp // 64) * 64
    UG = -(-H // 4) * 4 + uwl
    return B * nH * N * (UG + 2 + -(-H // 16) * 16 + -(-W // 16) * 16)


def relpos_attention_backward(q, k, v, out, dout, rel_h, rel_w, hw: Tuple[int, int],
                              dq: Optional[torch.Tensor] = None,
                              dk: Optional[torch.Tensor] = None,
                              dv: Optional[torch.Tensor] = None,
                              lse: Optional[torch.Tensor] = None):
    """Gradients of ``relpos_attention``: (dq, dk, dv, d rel_h, d rel_w).

    q, k, v, out, dout, and dq / dk / dv when given, are (B, nH, N, hd) views;
    the gradients are written into the given views (e.g. the rows of the qkv
    product's gradient). rel_h / rel_w are the tables the forward used;
    ``lse`` the (B, nH, N) f32 row log-sum-exps the forward stored (on a CUDA
    tensor without it, one forward launch computes them first). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel's four stages,
    for any head dim up to ``MAX_BWD_HEAD_DIM`` (256; staged as the
    forward's, the table gradients cut back to ``hd``); above it, it raises."""
    B, nH, N, hd = q.shape
    H, W = hw
    if N != H * W or any(t.shape != q.shape for t in (k, v, out, dout)):
        raise ValueError(f"relpos_attention_backward: shapes {tuple(q.shape)} over grid {hw}")
    _check_lse(lse, q, "relpos_attention_backward")
    if q.device.type == "cpu":
        res = relpos_attention_backward_plain(q, k, v, out, dout, rel_h, rel_w, hw, lse)
        grads = []
        for dst, src in zip((dq, dk, dv), res[:3]):
            grads.append(src if dst is None else dst.copy_(src))
        return (*grads, res[3], res[4])
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention_backward: unsupported device {q.device}")
    return _backward_staged(q, k, v, out, dout, rel_h, rel_w, hw, dq, dk, dv, lse)


def _backward_staged(q, k, v, out, dout, rel_h, rel_w, hw, dq, dk, dv, lse=None):
    """The kernel path of ``relpos_attention_backward``: operands staged to an
    instantiated head dim where needed, the row log-sum-exps by a forward
    launch where not given, the four stages in ``backward_plan``'s variants,
    the results cut back to ``hd``."""
    B, nH, N, hd = q.shape
    H, W = hw
    hdp = kernel_head_dim(hd, BWD_HEAD_DIMS)
    grads = [torch.empty((B, nH, N, hd), device=q.device, dtype=q.dtype) if t is None else t
             for t in (dq, dk, dv)]
    for t in (k, v, out, dout, *grads):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("relpos_attention_backward: q, k, v, out, dout and the gradients "
                             "share shape, dtype and device")
    if rel_h.shape != (H, H, hd) or rel_w.shape != (W, W, hd):
        raise ValueError("relpos_attention_backward: rel tables must be (H, H, hd) and (W, W, hd)")
    rh, rw = _tables(rel_h, rel_w, q.dtype, hdp)
    ins = [_staged(t, hdp) for t in (q, k, v, out, dout)]
    outs = [_staged(t, hdp, fill=False) for t in grads]
    if q.dtype == torch.bfloat16:
        rects = backward_plan(N, H, W, hdp).rects
    else:
        rects = tuple((r, (0, 0, 0, 0)) for r in f32_backward_rects(H, W, hdp))
    # split keys: each rectangle adds its table gradients into these
    alloc = torch.zeros if len(rects) > 1 else torch.empty
    drh = alloc((H, H, hdp), device=q.device, dtype=torch.float32)
    drw = alloc((W, W, hdp), device=q.device, dtype=torch.float32)
    dims, scale = (B, nH, N, H, W), float(hd ** -0.5)
    if lse is None:
        lse = torch.empty((B, nH, N), device=q.device, dtype=torch.float32)
        fwd = ins[:3] + [torch.empty_like(ins[0])]
        relpos_attention.launches += _forward_launches(
            *fwd[:3], rh, rw, fwd[3], dims, hdp, scale, (0, 0, 0),
            [x for t in fwd for x in t.stride()[:3]], lse)
    kh, kw = max(r.kh for r, _ in rects), max(r.kw for r, _ in rects)
    scratch = torch.empty(_bwd_scratch_floats(B, nH, N, kh, kw), device=q.device,
                          dtype=torch.float32)
    for i, (rect, codes) in enumerate(rects):
        extra = {} if len(rects) == 1 else dict(rect=rect, acc=(1 if i else 0) | 2)
        for stage in range(4):
            _backward_kernel(stage, codes[stage], ins, lse, rh, rw, outs, drh, drw, scratch,
                             dims, hdp, scale, **extra)
            relpos_attention_backward.launches += 1
    for dst, src in zip(grads, outs):
        if src is not dst:
            dst.copy_(src[..., :hd])
    if hdp != hd:
        drh, drw = drh[..., :hd].contiguous(), drw[..., :hd].contiguous()
    return (*grads, drh, drw)


relpos_attention_backward.launches = 0


def _backward_kernel(stage, code, ins, lse, rh, rw, outs, drh, drw, scratch, dims, hdp,
                     scale, rect=None, acc=0) -> None:
    """One stage of ``csrc/relpos_attention_bwd.cu`` (built for head dim
    ``hdp``) in the variant ``code`` on operands it takes as they are: ``ins``
    q, k, v, out, dout, ``lse`` the forward's row log-sum-exps, ``outs`` dq,
    dk, dv; ``scratch`` f32, ``_bwd_scratch_floats`` long, shared by the four
    stages; ``scale`` the true head dim's. ``rect`` (default the whole map):
    the keys of the launch; ``acc``: 1, the dq stage adds into dq; 2, the
    table stage adds into drh / drw."""
    B, nH, N, H, W = dims
    q = ins[0]
    rect = KeyRect(0, 0, H, W) if rect is None else rect
    strides = (_cuda._LL * 24)(*(x for t in (*ins, *outs) for x in t.stride()[:3]))
    name = f"relpos_attention_bwd_hd{hdp}"
    rc = _cuda.library(name).msam_relpos_attention_bwd(
        stage, code, *(t.data_ptr() for t in ins), lse.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        *(g.data_ptr() for g in outs), drh.data_ptr(), drw.data_ptr(), scratch.data_ptr(),
        scratch.numel(), B, nH, N, H, W, hdp, strides, scale, *rect, acc, _cuda.dtype_code(q),
        _cuda.stream_ptr(q))
    _cuda.check(name, rc)


class RelPosAttentionFn(torch.autograd.Function):
    """Differentiable rel-pos attention over a fused (B, 3, nH, N, hd) qkv view:
    the forward is ``relpos_attention``, the backward
    ``relpos_attention_backward`` (the plain versions for CPU tensors).

    Counterpart of ``flash_attention_qkv_core``'s custom_vjp: saves qkv, the
    tables, the output and the rows' log-sum-exps (which the TPU kernel
    recomputes in its backward). The output is a (B, nH, N, hd) view of a
    (B, N, nH, hd) buffer, so the proj product reads its rows as they are; the
    qkv gradient has qkv's own strides, so for qkv viewed out of the qkv
    product's (B, N, 3, nH, hd) rows its gradient is those rows. The tables'
    gradients come back in their dtype (f32 from the kernel)."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, hw):
        B, three, nH, N, hd = qkv.shape
        if three != 3:
            raise ValueError(f"RelPosAttentionFn: qkv shape {tuple(qkv.shape)}")
        dt = qkv.dtype
        out = torch.empty((B, N, nH, hd), device=qkv.device, dtype=dt).transpose(1, 2)
        lse = torch.empty((B, nH, N), device=qkv.device, dtype=torch.float32)
        relpos_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], rel_h.to(dt), rel_w.to(dt), hw, out=out,
                         lse=lse)
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        ctx.hw = tuple(hw)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dt = qkv.dtype
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dqkv = torch.empty_like(qkv)
        _, _, _, drh, drw = relpos_attention_backward(
            qkv[:, 0], qkv[:, 1], qkv[:, 2], out, dout.to(dt), rel_h.to(dt), rel_w.to(dt),
            ctx.hw, dq=dqkv[:, 0], dk=dqkv[:, 1], dv=dqkv[:, 2], lse=lse)
        return dqkv, drh.to(rel_h.dtype), drw.to(rel_w.dtype), None
