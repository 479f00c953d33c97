"""SAM ViT image encoder (vit_b / vit_l / vit_h).

Counterpart of ``micro_sam_tpu/models/image_encoder.py``: a space-to-depth
patch embed, an absolute position embedding, transformer blocks with 14 x 14
windowed attention and decomposed relative-position bias (plus a few global
blocks), and a conv neck to 256 channels. Layout is NHWC. Every transformer
block runs as the kernel chain of ``ops/fused_window_block.py``; consecutive
windowed blocks stay in window layout, with the pad positions of the LN1
output zeroed, so only one partition / unpartition is made per run of blocks.
The blocks' four product weights are held in the compute dtype, the dtype the
chain runs in; every other parameter is float32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import common as cm
from ..ops.fused_window_block import (fused_global_block, fused_global_block_plain,
                                      fused_window_block, fused_window_block_plain)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Per-offset relative positional embeddings: (q_size, k_size, head_dim).
    Linearly interpolates the table when its length is not 2 * max(q, k) - 1."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.float().t()[None], size=max_rel_dist,
                                mode="linear")[0].t()
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.as_tensor(rel.astype(np.int64), device=rel_pos.device)
    return rel_pos[idx]


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, win, win, C), zero-padding H / W to multiples."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % window, (-W) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(x: torch.Tensor, window: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // ((Hp // window) * (Wp // window))
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def partition_tokens(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (windows (B * nWin, win * win, C), valid, pad_hw).

    ``valid`` is the (B * nWin, win * win, 1) float32 pad mask, or None when
    nothing was padded."""
    B, H, W, C = x.shape
    xw, pad_hw = window_partition(x, window)
    valid = None
    if pad_hw != (H, W):
        ones = torch.ones((B, H, W, 1), device=x.device)
        valid = window_partition(ones, window)[0].reshape(-1, window * window, 1)
    return xw.reshape(-1, window * window, C), valid, pad_hw


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = cm.Linear(dim, dim * 3)
        self.proj = cm.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        self._rel_cache = None

    def rel_tables(self, hw: Tuple[int, int], dtype: torch.dtype):
        """``get_rel_pos`` over H and over W, in ``dtype``. Without autograd the
        pair is kept until the tables change (an in-place write, a state-dict
        load or a move), so the encoder gathers them once, not per call."""
        H, W = hw
        key = (H, W, dtype, self.rel_pos_h._version, self.rel_pos_w._version)
        if self._rel_cache is not None and self._rel_cache[0] == key:
            return self._rel_cache[1]
        pair = (get_rel_pos(H, H, self.rel_pos_h).to(dtype),
                get_rel_pos(W, W, self.rel_pos_w).to(dtype))
        self._rel_cache = None if torch.is_grad_enabled() else (key, pair)
        return pair

    def _apply(self, fn, *args, **kwargs):
        self._rel_cache = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        self._rel_cache = None
        # a rel-pos table of another length loads as it is: get_rel_pos
        # interpolates it to the token grid at use
        for name in ("rel_pos_h", "rel_pos_w"):
            t = state_dict.get(prefix + name)
            if t is not None and t.shape != getattr(self, name).shape:
                setattr(self, name, nn.Parameter(torch.empty_like(t, device=self.qkv.weight.device)))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def init_(self, g: torch.Generator) -> None:
        # small random tables (upstream SAM starts them at zero) so that a
        # random-weight model carries signal through the rel-pos bias
        with torch.no_grad():
            self.rel_pos_h.normal_(0.0, 0.02, generator=g)
            self.rel_pos_w.normal_(0.0, 0.02, generator=g)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 input_size: Tuple[int, int]):
        super().__init__()
        self.window_size = window_size
        self.norm1 = cm.LayerNorm(dim)
        self.attn = Attention(dim, num_heads, input_size)
        self.norm2 = cm.LayerNorm(dim)
        self.mlp = cm.MLPBlock(dim, int(dim * mlp_ratio))

    def hold_weights_in_(self, dtype: torch.dtype) -> "Block":
        """Keep the qkv, proj, lin1 and lin2 weights in ``dtype``, the dtype
        the kernel chain runs in (their biases stay float32)."""
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.lin1, self.mlp.lin2):
            lin.weight = nn.Parameter(lin.weight.detach().to(dtype),
                                      requires_grad=lin.weight.requires_grad)
        return self


def apply_block(block: Block, x: torch.Tensor) -> torch.Tensor:
    """One block in its plain version, with one partition per block
    (x: (B, H, W, C)); the encoder runs the kernel chain instead."""
    B, H, W, C = x.shape
    nH = block.attn.num_heads
    ws = block.window_size
    if ws > 0:
        xw, valid, pad_hw = partition_tokens(x, ws)
        out = fused_window_block_plain(xw, valid, block, (ws, ws), nH)
        return window_unpartition(out.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
    return fused_global_block_plain(x.reshape(B, H * W, C), block, (H, W), nH).reshape(x.shape)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = cm.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 dtype: torch.dtype = torch.float32):
        """``dtype``: the compute dtype, in which the blocks' product weights
        are held."""
        super().__init__()
        grid = img_size // patch_size
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.window_size = window_size
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList()
        for i in range(depth):
            ws = 0 if i in self.global_attn_indexes else window_size
            self.blocks.append(Block(embed_dim, num_heads, mlp_ratio, ws,
                                     (grid, grid) if ws == 0 else (ws, ws)).hold_weights_in_(dtype))
        self.neck = nn.Sequential(
            cm.Conv2d(embed_dim, out_chans, 1, bias=False),
            cm.LayerNorm(out_chans),
            cm.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            cm.LayerNorm(out_chans),
        )

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) preprocessed pixels in the compute dtype ->
        (B, H / 16, W / 16, 256) embeddings."""
        # patch embed as space-to-depth + one product (the stride-16 conv on
        # non-overlapping patches)
        B, H, W, _ = x.shape
        ps = self.patch_size
        dt = x.dtype
        w = self.patch_embed.proj.weight  # (D, 3, ps, ps)
        xp = x.reshape(B, H // ps, ps, W // ps, ps, 3).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(B, H // ps, W // ps, ps * ps * 3)
        x = xp @ w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(dt)
        x = x + self.patch_embed.proj.bias.to(dt)
        x = x + self.pos_embed.to(dt)

        glob = set(self.global_attn_indexes)
        depth = len(self.blocks)
        nH, ws = self.num_heads, self.window_size
        B, H, W, C = x.shape
        i = 0
        while i < depth:
            if i in glob or ws <= 0:
                x = fused_global_block(x.reshape(B, H * W, C), self.blocks[i], (H, W), nH)
                x = x.reshape(B, H, W, C)
                i += 1
                continue
            j = i
            while j < depth and j not in glob:
                j += 1
            xw, valid, pad_hw = partition_tokens(x, ws)
            for k in range(i, j):
                xw = fused_window_block(xw, valid, self.blocks[k], (ws, ws), nH)
            x = window_unpartition(xw.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
            i = j
        return self.neck(x)
