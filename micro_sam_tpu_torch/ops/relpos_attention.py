"""Rel-pos flash attention kernel (``csrc/relpos_attention.cu``) and its plain
PyTorch version.

Computes, per (batch, head), over an (H, W) token grid with N = H * W:

    out = softmax((q * hd^-0.5) k^T + bias) v
    bias[i, j] = q_i . rel_h[y(i), y(j)] + q_i . rel_w[x(i), x(j)]   (unscaled q)

Replaces ``micro_sam_tpu/ops/flash_attention.py::_flash_kernel_qkv`` (reached
through ``flash_attention_qkv``) and the attention stage inside
``ops/fused_window_block.py::_fused_block_kernel`` / ``::_fused_global_kernel``.

Bound on the H100: operations (4 N^2 hd flops per head against 4 N hd values
moved: a vit_b global block is 52 GFLOP). One block per (64-row q tile, head,
batch) walks k/v in 64-key tiles with an online softmax; the bias is built in
the kernel from 64 x (H + W) per-row dot products, so neither N x N logits nor
the bias touch device memory. In bf16 both products run on the tensor cores
(``mma.sync``) with logits, probabilities and output in registers; f32 is a
plain SIMT loop. q, k, v and out are strided views (the head dim
contiguous), so the kernel reads the qkv product's rows and writes the proj
product's rows in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

HEAD_DIMS = (64,)  # vit_b and vit_l


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
