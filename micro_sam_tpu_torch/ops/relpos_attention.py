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
values moved: a vit_b global block is 52 GFLOP). One block per (64-row q tile,
head, batch) walks k/v in 64-key tiles with an online softmax; the bias is
built in the kernel from 64 x (H + W) per-row dot products, so neither N x N
logits nor the bias touch device memory. In bf16 both products run on the
tensor cores (``mma.sync``) with logits, probabilities and output in
registers; f32 is a plain SIMT loop. q, k, v and out are strided views (the
head dim contiguous), so the kernel reads the qkv product's rows and writes
the proj product's rows in place.

Backward: four launches (row statistics, dk/dv, dq with the per-key-row and
per-key-column sums of dS, the table gradients), about 10 N^2 hd flops per
head; see the source for the design.

Head dims: both kernels are built for 64 (vit_b, vit_l) and 80 (vit_h),
``HEAD_DIMS`` for the forward and ``BWD_HEAD_DIMS`` for the backward; a CUDA
tensor of another head dim raises before any launch. The plain versions take
any.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

HEAD_DIMS = (64, 80)  # the forward: vit_b and vit_l (64), vit_h (80)
BWD_HEAD_DIMS = (64, 80)  # the backward kernel: vit_b / vit_l and vit_h finetuning


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           hw: Tuple[int, int]) -> torch.Tensor:
    """q, k, v: (B, nH, N, hd) (any strides); rel_h (H, H, hd), rel_w (W, W, hd).
    Returns (B, nH, N, hd) in q.dtype, computed in f32."""
    B, nH, N, hd = q.shape
    H, W = hw
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = (qf * hd ** -0.5) @ kf.transpose(-1, -2)
    r_q = qf.reshape(B, nH, H, W, hd)
    rh = torch.einsum("bnijc,ikc->bnijk", r_q, rel_h.float())
    rw = torch.einsum("bnijc,jkc->bnijk", r_q, rel_w.float())
    logits = logits.view(B, nH, H, W, H, W) + rh[..., :, None] + rw[..., None, :]
    w = torch.softmax(logits.view(B, nH, N, N), dim=-1)
    return (w @ vf).to(q.dtype)


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor, hw: Tuple[int, int],
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention with the decomposed rel-pos bias over strided (B, nH, N, hd)
    views. ``out``, when given, is a (B, nH, N, hd) view the result is written
    into (and returned). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    B, nH, N, hd = q.shape
    H, W = hw
    if N != H * W or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"relpos_attention: shapes {tuple(q.shape)} over grid {hw}")
    if q.device.type == "cpu":
        res = relpos_attention_plain(q, k, v, rel_h, rel_w, hw)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention: unsupported device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"relpos_attention: head dim {hd} not in {HEAD_DIMS}")
    if out is None:
        out = torch.empty((B, nH, N, hd), device=q.device, dtype=q.dtype)
    rh, rw = (t.to(q.dtype).contiguous() for t in (rel_h, rel_w))
    rh, rw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (rh, rw))
    if rh.shape != (H, H, hd) or rw.shape != (W, W, hd):
        raise ValueError("relpos_attention: rel tables must be (H, H, hd) and (W, W, hd)")
    item = q.element_size()
    strides = []
    for t in (q, k, v, out):
        if t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError("relpos_attention: q, k, v, out share dtype and device, "
                             "with a contiguous head dim")
        st = t.stride()[:3]
        if t.data_ptr() % 16 or any((s * item) % 16 for s in st):
            raise ValueError("relpos_attention: rows must be 16-byte aligned")
        strides.extend(st)
    st_arr = (_cuda._LL * 12)(*strides)
    lib = _cuda.library("relpos_attention")
    rc = lib.msam_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(),
        B, nH, N, H, W, hd, st_arr, float(hd ** -0.5), _cuda.dtype_code(q),
        _cuda.stream_ptr(q))
    _cuda.check("relpos_attention", rc)
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0


def relpos_attention_backward_plain(q, k, v, out, dout, rel_h, rel_w, hw):
    """The VJP of ``relpos_attention_plain`` written out, in f32.

    q, k, v, out, dout: (B, nH, N, hd) (any strides); rel_h (H, H, hd), rel_w
    (W, W, hd). Returns (dq, dk, dv) in q.dtype and (d rel_h, d rel_w) in f32.
    ``out`` is the forward's output (D = rowsum(dout * out))."""
    B, nH, N, hd = q.shape
    H, W = hw
    s = hd ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    rh, rw = rel_h.float(), rel_w.float()
    r_q = qf.reshape(B, nH, H, W, hd)
    logits = (qf * s) @ kf.transpose(-1, -2)
    uh = torch.einsum("bnijc,ikc->bnijk", r_q, rh)
    uw = torch.einsum("bnijc,jkc->bnijk", r_q, rw)
    logits = logits.view(B, nH, H, W, H, W) + uh[..., :, None] + uw[..., None, :]
    p = torch.softmax(logits.view(B, nH, N, N), dim=-1)
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
    """Length of the backward's f32 scratch (``scratch_floats`` in the source):
    per (batch, head) the u rows, lse and D over N padded to 64, then the
    per-key-row and per-key-column sums of dS."""
    NP = -(-N // 64) * 64
    UG = -(-(H + W) // 4) * 4
    return B * nH * NP * (UG + 2) + B * nH * N * (H + W)


def relpos_attention_backward(q, k, v, out, dout, rel_h, rel_w, hw: Tuple[int, int],
                              dq: Optional[torch.Tensor] = None,
                              dk: Optional[torch.Tensor] = None,
                              dv: Optional[torch.Tensor] = None):
    """Gradients of ``relpos_attention``: (dq, dk, dv, d rel_h, d rel_w).

    q, k, v, out, dout, and dq / dk / dv when given, are (B, nH, N, hd) views
    with a contiguous head dim; the gradients are written into the given views
    (e.g. the rows of the qkv product's gradient). rel_h / rel_w are the
    tables the forward used. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel's four stages."""
    B, nH, N, hd = q.shape
    H, W = hw
    if N != H * W or any(t.shape != q.shape for t in (k, v, out, dout)):
        raise ValueError(f"relpos_attention_backward: shapes {tuple(q.shape)} over grid {hw}")
    if q.device.type == "cpu":
        res = relpos_attention_backward_plain(q, k, v, out, dout, rel_h, rel_w, hw)
        grads = []
        for dst, src in zip((dq, dk, dv), res[:3]):
            grads.append(src if dst is None else dst.copy_(src))
        return (*grads, res[3], res[4])
    if q.device.type != "cuda":
        raise RuntimeError(f"relpos_attention_backward: unsupported device {q.device}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"relpos_attention_backward: the backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, not {hd}")
    grads = [torch.empty((B, nH, N, hd), device=q.device, dtype=q.dtype) if t is None else t
             for t in (dq, dk, dv)]
    rh, rw = (t.to(q.dtype).contiguous() for t in (rel_h, rel_w))
    rh, rw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (rh, rw))
    if rh.shape != (H, H, hd) or rw.shape != (W, W, hd):
        raise ValueError("relpos_attention_backward: rel tables must be (H, H, hd) and (W, W, hd)")
    item = q.element_size()
    strides = []
    for t in (q, k, v, out, dout, *grads):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError("relpos_attention_backward: q, k, v, out, dout and the gradients "
                             "share shape, dtype and device, with a contiguous head dim")
        st = t.stride()[:3]
        if t.data_ptr() % 16 or any((x * item) % 16 for x in st):
            raise ValueError("relpos_attention_backward: rows must be 16-byte aligned")
        strides.extend(st)
    st_arr = (_cuda._LL * 24)(*strides)
    drh = torch.empty((H, H, hd), device=q.device, dtype=torch.float32)
    drw = torch.empty((W, W, hd), device=q.device, dtype=torch.float32)
    n_scratch = _bwd_scratch_floats(B, nH, N, H, W)
    scratch = torch.empty(n_scratch, device=q.device, dtype=torch.float32)
    lib = _cuda.library("relpos_attention_bwd")
    for stage in range(4):
        rc = lib.msam_relpos_attention_bwd(
            stage, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            rh.data_ptr(), rw.data_ptr(), *(g.data_ptr() for g in grads), drh.data_ptr(),
            drw.data_ptr(), scratch.data_ptr(), n_scratch, B, nH, N, H, W, hd, st_arr,
            float(hd ** -0.5), _cuda.dtype_code(q), _cuda.stream_ptr(q))
        _cuda.check("relpos_attention_bwd", rc)
        relpos_attention_backward.launches += 1
    return (*grads, drh, drw)


relpos_attention_backward.launches = 0


class RelPosAttentionFn(torch.autograd.Function):
    """Differentiable rel-pos attention over a fused (B, 3, nH, N, hd) qkv view:
    the forward is ``relpos_attention``, the backward
    ``relpos_attention_backward`` (the plain versions for CPU tensors).

    Counterpart of ``flash_attention_qkv_core``'s custom_vjp: saves qkv, the
    tables and the output. The output is a (B, nH, N, hd) view of a
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
        relpos_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], rel_h.to(dt), rel_w.to(dt), hw, out=out)
        ctx.save_for_backward(qkv, rel_h, rel_w, out)
        ctx.hw = tuple(hw)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_h, rel_w, out = ctx.saved_tensors
        dt = qkv.dtype
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dqkv = torch.empty_like(qkv)
        _, _, _, drh, drw = relpos_attention_backward(
            qkv[:, 0], qkv[:, 1], qkv[:, 2], out, dout.to(dt), rel_h.to(dt), rel_w.to(dt),
            ctx.hw, dq=dqkv[:, 0], dk=dqkv[:, 1], dv=dqkv[:, 2])
        return dqkv, drh.to(rel_h.dtype), drw.to(rel_w.dtype), None
