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

Two opt-in routes for the runs of windowed blocks, read at each forward under
the JAX package's knob names: ``MSAM_TPU_SPATIAL_WINDOW=1`` pads the run's
input once, runs each block as ``fused_window_block_spatial`` (K9) on the
padded map and crops once; ``MSAM_TPU_WINDOW_STACK=1`` (which takes
precedence, as in JAX) runs each block as ``fused_window_stack`` (K11) over
the batch's window stacks. Both compute what the default route computes.
``forward_train`` always partitions.

A block that PEFT changed (``models/peft_sam.py``: LoRA, FacT, SSF, an
AdaptFormer adapter, int4 storage) runs the same chains in every route, the
PEFT terms added around their products (``ops/fused_window_block.py``); in
training ``train_block`` adds the same terms around ``RelPosAttentionFn``
(K1 / K4). The encoder's shared FacT core (``fact_u`` / ``fact_v``) is handed
to every block. Split over a model axis, the PEFT terms split with their
products (``parallel/mesh.py``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common as cm
from ..ops import fused_window_block as fwb
from ..ops.relpos_attention import RelPosAttentionFn
from ..parallel.mesh import CopyToModel, ReduceFromModel


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Per-offset relative positional embeddings: (q_size, k_size, head_dim).
    Linearly interpolates the table when its length is not 2 * max(q, k) - 1.
    The sizes are taken as ints (under ``torch.jit.trace`` they arrive as
    0-dim tensors; the index table is a constant of the trace)."""
    q_size, k_size = int(q_size), int(k_size)
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.float().t()[None], size=max_rel_dist,
                                mode="linear")[0].t()
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    idx = torch.from_numpy(rel.astype(np.int64))  # a host index: no device constant in a trace
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
        ones = torch.ones_like(x[..., :1], dtype=torch.float32)  # no device constant in a trace
        valid = window_partition(ones, window)[0].reshape(-1, window * window, 1)
    return xw.reshape(-1, window * window, C), valid, pad_hw


class Attention(cm.KeepsDerived):
    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads  # all of the block's heads, split or not
        self.head_dim = hd = dim // num_heads
        self.qkv = cm.Linear(dim, dim * 3)
        self.proj = cm.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        # PEFT (models/peft_sam.py): LoRA pairs on q / k / v (a ModuleDict),
        # FacT's per-block scales of the encoder's shared core
        self.register_module("lora", None)
        self.register_module("fact", None)

    def qkv_deltas(self, a: torch.Tensor, fact, shared=None) -> Optional[torch.Tensor]:
        """The PEFT updates of the qkv product of ``a`` (..., C): LoRA's on
        q / k / v, FacT's ``(a (u * s)) v`` on q and v with the encoder's
        shared core ``fact`` = (u, v), placed in the [q | k | v] thirds of the
        qkv columns; None without either (``micro_sam_tpu/models/
        image_encoder.py::apply_attention``). Split over a model axis, each
        ``b`` and ``v`` hold the shard's heads' columns, so the updates are
        the shard's; ``shared`` wraps the factors every shard reads whole
        (LoRA's ``a``, ``u * s``: ``CopyToModel`` in training)."""
        dt = a.dtype
        keep = (lambda t: t) if shared is None else shared
        parts = [None, None, None]
        if self.lora is not None:
            for i, name in enumerate("qkv"):
                if name in self.lora:
                    lora = self.lora[name]
                    parts[i] = (a @ keep(lora.a).to(dt)) @ lora.b.to(dt)
        if self.fact is not None:
            u, v = fact
            for i, s in ((0, self.fact.q_scale), (2, self.fact.v_scale)):
                d = (a @ keep(u * s).to(dt)) @ v.to(dt)
                parts[i] = d if parts[i] is None else parts[i] + d
        given = [p for p in parts if p is not None]
        if not given:
            return None
        zero = a.new_zeros(a.shape[:-1] + given[0].shape[-1:])
        return torch.cat([zero if p is None else p for p in parts], dim=-1)

    def rel_tables(self, hw: Tuple[int, int], dtype: torch.dtype):
        """``get_rel_pos`` over H and over W, in ``dtype``; kept per (H, W,
        dtype) until the tables change (``KeepsDerived``)."""
        H, W = hw
        return self.derived((H, W, dtype), (self.rel_pos_h, self.rel_pos_w),
                            lambda: (get_rel_pos(H, H, self.rel_pos_h).to(dtype),
                                     get_rel_pos(W, W, self.rel_pos_w).to(dtype)))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        self._derived = {}
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
        # the depth adapters of the 3d wrapper (models/sam_3d_wrapper.py)
        self.register_module("adapter_pre", None)
        self.register_module("adapter_post", None)
        # the model group of a block split over a mesh's model axis
        # (parallel/mesh.shard_sam_), None for a whole block
        self.tp = None

    def hold_weights_in_(self, dtype: torch.dtype) -> "Block":
        """Keep the qkv, proj, lin1 and lin2 weights in ``dtype``, the dtype
        the kernel chain runs in (their biases stay float32)."""
        for lin in (self.attn.qkv, self.attn.proj, self.mlp.lin1, self.mlp.lin2):
            lin.hold_weight_in_(dtype)
        return self


def _block_tokens(block: Block, xt: torch.Tensor, valid, hw: Tuple[int, int], fact,
                  plain: bool) -> torch.Tensor:
    """One block over tokens (Bn, N, C) without autograd: the kernel chain, or
    its plain version with ``plain``."""
    nH = block.attn.num_heads
    if block.window_size > 0:
        attn = fwb.fused_window_attn_plain if plain else fwb.fused_window_attn
        xt = attn(xt, valid, block, hw, nH, fact)
    else:
        attn = fwb.fused_global_attn_plain if plain else fwb.fused_global_attn
        xt = attn(xt, block, hw, nH, fact)
    return fwb.mlp_half_plain(xt, block) if plain else fwb.mlp_half(xt, block)


def run_block(block: Block, x: torch.Tensor, fact=None, plain: bool = False) -> torch.Tensor:
    """One block with one partition of its own (x: (B, H, W, C)). In autograd
    ``train_block`` (K1 forward, K4 backward); without, the kernel chain, or
    with ``plain`` its plain version. ``fact`` is the
    encoder's shared FacT core (u, v) where FacT is on."""
    B, H, W, C = x.shape
    ws = block.window_size
    if ws > 0:
        xt, valid, pad_hw = partition_tokens(x, ws)
        hw = (ws, ws)
    else:
        xt, valid, hw = x.reshape(B, H * W, C), None, (H, W)
    if torch.is_grad_enabled() and not plain:
        out = checkpoint(train_block, block, xt, valid, hw, fact, use_reentrant=False)
    else:
        out = _block_tokens(block, xt, valid, hw, fact, plain)
    if ws > 0:
        return window_unpartition(out.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
    return out.reshape(x.shape)


def apply_block(block: Block, x: torch.Tensor, fact=None) -> torch.Tensor:
    """One block in its plain version, with one partition per block
    (x: (B, H, W, C)); the encoder runs the kernel chain instead."""
    return run_block(block, x, fact, plain=True)


def train_block(block: Block, x: torch.Tensor, valid, hw: Tuple[int, int],
                fact=None) -> torch.Tensor:
    """One block for training, in autograd: x (Bn, N, C) tokens in the compute
    dtype (windows or whole images); ``valid`` the (Bn, N, 1) pad mask of
    windows, or None. LN and the products are ``F.layer_norm`` / ``F.linear``
    (the JAX package leaves them to XLA in training), each with its PEFT
    terms; the attention is ``RelPosAttentionFn`` on the qkv product's rows
    (plus the LoRA / FacT updates), the tables' gradient flowing back through
    ``get_rel_pos``. A block split over a model axis (``tp``) runs Megatron's
    layout: ``CopyToModel`` before the products split on their output rows
    (and on the shared rel-pos tables and the PEFT factors every shard reads
    whole), ``ReduceFromModel`` after those split on their input columns
    (``parallel/mesh.py``); an AdaptFormer adapter reads LN2's output before
    the copy, as it runs whole on every rank."""
    Bn, N, C = x.shape
    attn = block.attn
    tp = block.tp
    nH = attn.num_heads if tp is None else attn.num_heads // tp.size
    shared = None if tp is None else (lambda t: CopyToModel.apply(t, tp.group))
    a = block.norm1(x)
    if valid is not None:
        a = a * valid.to(a.dtype)
    if tp is not None:
        a = CopyToModel.apply(a, tp.group)
    qkv = attn.qkv(a, shared)
    d = attn.qkv_deltas(a, fact, shared)
    if d is not None:
        qkv = qkv + d
    qkv = qkv.view(Bn, N, 3, nH, attn.head_dim).permute(0, 2, 3, 1, 4)
    rel_h = get_rel_pos(hw[0], hw[0], attn.rel_pos_h)
    rel_w = get_rel_pos(hw[1], hw[1], attn.rel_pos_w)
    if tp is not None:  # every shard's heads read the tables: their gradients sum
        rel_h, rel_w = CopyToModel.apply(rel_h, tp.group), CopyToModel.apply(rel_w, tp.group)
    o = RelPosAttentionFn.apply(qkv, rel_h, rel_w, tuple(hw))  # (Bn, nH, N, hd) view
    o = o.transpose(1, 2).reshape(Bn, N, nH * attn.head_dim)
    if tp is None:
        x = x + attn.proj(o)
        return x + block.mlp(block.norm2(x))
    x = x + _reduced_product(o, attn.proj, tp)
    ln2 = block.norm2(x)
    b = CopyToModel.apply(ln2, tp.group)
    y = _reduced_product(cm.gelu(block.mlp.lin1(b, shared)), block.mlp.lin2, tp)
    if block.mlp.adapter is not None:
        y = y + block.mlp.adapter(ln2)
    return x + y


def _reduced_product(x: torch.Tensor, lin, tp) -> torch.Tensor:
    """lin(x) for a product split on its input columns: the partial products
    (the shard's LoRA term added, its ``a`` rows the shard's, ``b`` read whole)
    summed in float32 over the model group, the bias added once to the sum,
    then the SSF scale and shift."""
    part = cm.linear(x, lin.dense_weight(), None)
    if lin.lora is not None:
        b = CopyToModel.apply(lin.lora.b, tp.group)
        part = part.float() + ((x @ lin.lora.a.to(x.dtype)) @ b.to(x.dtype)).float()
    out = ReduceFromModel.apply(part, tp.group) + lin.bias
    if lin.ssf_scale is not None:
        out = out * lin.ssf_scale + lin.ssf_shift
    return out.to(x.dtype)


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
        """``dtype``: the dtype the blocks' product weights are held in (the
        compute dtype for serving, float32 for training)."""
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
                                     (grid, grid) if ws == 0 else (ws, ws)))
        self.hold_weights_in_(dtype)
        self.neck = nn.Sequential(
            cm.Conv2d(embed_dim, out_chans, 1, bias=False),
            cm.LayerNorm(out_chans),
            cm.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            cm.LayerNorm(out_chans),
        )
        # FacT's core shared by the blocks (models/peft_sam.py)
        self.register_parameter("fact_u", None)
        self.register_parameter("fact_v", None)

    def hold_weights_in_(self, dtype: torch.dtype) -> None:
        """Keep the blocks' product weights in ``dtype`` (int4 storage stays)."""
        for blk in self.blocks:
            blk.hold_weights_in_(dtype)

    @property
    def fact(self):
        """The shared FacT core (u, v), or None."""
        return None if self.fact_u is None else (self.fact_u, self.fact_v)

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
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
        return x + self.pos_embed.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) preprocessed pixels in the compute dtype ->
        (B, H / 16, W / 16, 256) embeddings. Each block is its attention half
        (``fused_window_attn``, K10, or ``fused_global_attn``, K5) and then its
        MLP half (``mlp_half``), called through the module
        ``ops/fused_window_block``; a windowed block is ``fused_window_block_spatial``
        or ``fused_window_stack`` under the routes' knobs (module docstring).
        Each is handed the encoder's shared FacT core, for a block that PEFT
        changed."""
        x = self._patch_embed(x)
        glob = set(self.global_attn_indexes)
        depth = len(self.blocks)
        nH, ws = self.num_heads, self.window_size
        B, H, W, C = x.shape
        fact = self.fact
        stack = os.environ.get("MSAM_TPU_WINDOW_STACK", "0") == "1"
        spatial = not stack and os.environ.get("MSAM_TPU_SPATIAL_WINDOW", "0") == "1"
        i = 0
        while i < depth:
            if i in glob or ws <= 0:
                blk = self.blocks[i]
                xt = fwb.fused_global_attn(x.reshape(B, H * W, C), blk, (H, W), nH, fact)
                x = fwb.mlp_half(xt, blk).reshape(B, H, W, C)
                i += 1
                continue
            j = i
            while j < depth and j not in glob:
                j += 1
            if spatial:
                pad_h, pad_w = (-H) % ws, (-W) % ws
                xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if pad_h or pad_w else x
                for blk in self.blocks[i:j]:
                    xp = fwb.fused_window_block_spatial(xp, blk, ws, (H, W), nH, fact)
                x = xp[:, :H, :W].contiguous() if pad_h or pad_w else xp
                i = j
                continue
            xw, valid, pad_hw = partition_tokens(x, ws)
            for blk in self.blocks[i:j]:
                if stack:
                    xw = fwb.fused_window_stack(xw, valid, blk, (ws, ws), nH, B, fact)
                else:
                    xw = fwb.fused_window_attn(xw, valid, blk, (ws, ws), nH, fact)
                    xw = fwb.mlp_half(xw, blk)
            x = window_unpartition(xw.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
            i = j
        return self.neck(x)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward (``apply_image_encoder(..., remat=True)``):
        x (B, H, W, 3) preprocessed pixels in the compute dtype -> (B, H / 16,
        W / 16, 256). Each block is checkpointed (its activations recomputed in
        backward); runs of windowed blocks stay in window layout, with the LN1
        output zeroed at the pad positions."""
        x = self._patch_embed(x)
        glob = set(self.global_attn_indexes)
        depth = len(self.blocks)
        ws = self.window_size
        B, H, W, C = x.shape
        fact = self.fact
        i = 0
        while i < depth:
            if i in glob or ws <= 0:
                t = checkpoint(train_block, self.blocks[i], x.reshape(B, H * W, C), None, (H, W),
                               fact, use_reentrant=False)
                x = t.reshape(B, H, W, C)
                i += 1
                continue
            j = i
            while j < depth and j not in glob:
                j += 1
            xw, valid, pad_hw = partition_tokens(x, ws)
            for k in range(i, j):
                xw = checkpoint(train_block, self.blocks[k], xw, valid, (ws, ws), fact,
                                use_reentrant=False)
            x = window_unpartition(xw.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
            i = j
        return self.neck(x)
