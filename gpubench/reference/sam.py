"""Plain float32 SAM, as facebookresearch/segment-anything writes it.

Kirillov et al. 2023 (arXiv:2304.02643), ``segment_anything/modeling``: the
ViT image encoder (patch embed, absolute position embedding, blocks with 14 x
14 windowed or global attention and the decomposed relative-position bias,
the conv neck), the prompt encoder and the two-way-transformer mask decoder
(ReLU in its MLPs, as upstream's ``TwoWayTransformer`` default). The modules'
``state_dict()`` keys are the published layout, so a zoo checkpoint loads
with ``load_state_dict``. Activations are NCHW / token-major as upstream.

Every product (linear, matrix product, convolution) goes through a
``Precision``: ``Precision("float32")`` is the reference, run with TF32 off
(``no_tf32``); ``Precision("fp8")`` is the control, each product's two
operands rounded to float8 e4m3 with a per-tensor scale and multiplied in
float32. Nothing here imports ``jax``, ``micro_sam_tpu`` or
``micro_sam_tpu_torch``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


class Precision:
    """How the reference multiplies: ``float32``, or ``fp8`` (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as the product sees it: itself in float32, or rounded
        to float8 e4m3 under a per-tensor scale that maps its largest
        magnitude to 448."""
        t = t.float()
        if self.name == "float32":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.round(x), self.round(w), None if b is None else b.float())

    def matmul(self, a, b):
        return torch.matmul(self.round(a), self.round(b))

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.round(x), self.round(w), None if b is None else b.float(),
                        stride=stride, padding=padding)

    def conv_transpose2d(self, x, w, b=None, stride=2):
        return F.conv_transpose2d(self.round(x), self.round(w), None if b is None else b.float(),
                                  stride=stride)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Linear(nn.Linear):
    def forward(self, x, prec: Precision):
        return prec.linear(x, self.weight, self.bias)


class LayerNorm2d(nn.Module):
    """Upstream's LayerNorm2d: over the channels of an NCHW map, eps 1e-6."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)
        self.act = act

    def forward(self, x, prec):
        return self.lin2(self.act(self.lin1(x, prec)), prec)


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        rel_pos = rel_pos.reshape(-1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, dim // num_heads))

    def forward(self, x, prec):
        B, H, W, _ = x.shape
        nH = self.num_heads
        qkv = self.qkv(x, prec).reshape(B, H * W, 3, nH, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nH, H * W, -1).unbind(0)
        attn = prec.matmul(q * self.scale, k.transpose(-2, -1))
        # add_decomposed_rel_pos: the bias reads the unscaled q
        Rh, Rw = get_rel_pos(H, H, self.rel_pos_h), get_rel_pos(W, W, self.rel_pos_w)
        r_q = q.reshape(B * nH, H, W, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", prec.round(r_q), prec.round(Rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", prec.round(r_q), prec.round(Rw))
        attn = (attn.view(B * nH, H, W, H, W) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(B * nH, H * W, H * W)
        attn = attn.softmax(dim=-1)
        x = prec.matmul(attn, v).view(B, nH, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x, prec)


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads,
                              input_size if window_size == 0 else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), F.gelu)
        self.window_size = window_size

    def forward(self, x, prec):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x, prec)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x), prec)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x, prec):  # (B, 3, H, W) -> (B, H/16, W/16, C)
        p = self.proj
        return prec.conv2d(x, p.weight, p.bias, stride=p.stride).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int,
                 num_heads: int, mlp_ratio: float, out_chans: int, window_size: int,
                 global_attn_indexes: Sequence[int]):
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size, (grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(nn.Conv2d(embed_dim, out_chans, 1, bias=False),
                                  LayerNorm2d(out_chans),
                                  nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
                                  LayerNorm2d(out_chans))

    def forward(self, x, prec):
        x = self.patch_embed(x, prec) + self.pos_embed
        for blk in self.blocks:
            x = blk(x, prec)
        x = x.permute(0, 3, 1, 2)
        n = self.neck
        x = n[1](prec.conv2d(x, n[0].weight))
        return n[3](prec.conv2d(x, n[2].weight, padding=1))


# ---------------------------------------------------------------------------
# prompt encoder and mask decoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def _pe_encoding(self, coords, prec):
        coords = 2 * coords - 1
        coords = 2 * math.pi * prec.matmul(coords, self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense(self, hw, prec):  # (C, h, w)
        h, w = hw
        grid = torch.ones((h, w), device=self.positional_encoding_gaussian_matrix.device)
        y = (grid.cumsum(dim=0) - 0.5) / h
        x = (grid.cumsum(dim=1) - 0.5) / w
        return self._pe_encoding(torch.stack([x, y], dim=-1), prec).permute(2, 0, 1)

    def forward_with_coords(self, coords, image_size, prec):
        c = coords.clone()
        c[:, :, 0] = c[:, :, 0] / image_size[1]
        c[:, :, 1] = c[:, :, 1] / image_size[0]
        return self._pe_encoding(c, prec)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int, image_embedding_size, input_image_size,
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2), LayerNorm2d(mask_in_chans // 4),
            nn.GELU(), nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def embed_points(self, points, labels, pad: bool, prec):
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros((points.shape[0], 1, 2))], dim=1)
            labels = torch.cat([labels, -labels.new_ones((labels.shape[0], 1))], dim=1)
        emb = self.pe_layer.forward_with_coords(points, self.input_image_size, prec)
        emb = torch.where((labels == -1)[..., None], self.not_a_point_embed.weight[0], emb)
        for i in range(4):
            emb = emb + (labels == i)[..., None] * self.point_embeddings[i].weight[0]
        return emb

    def embed_masks(self, masks, prec):
        m = self.mask_downscaling
        x = m[2](m[1](prec.conv2d(masks, m[0].weight, m[0].bias, stride=2)))
        x = m[5](m[4](prec.conv2d(x, m[3].weight, m[3].bias, stride=2)))
        return prec.conv2d(x, m[6].weight, m[6].bias)

    def forward(self, points, labels, boxes, masks, prec):
        """points (B, P, 2) xy with labels (B, P), boxes (B, 4) xyxy or None,
        masks (B, 1, 256, 256) or None -> (sparse (B, T, C), dense (B, C, h, w))."""
        B = points.shape[0] if points is not None else boxes.shape[0]
        sparse = torch.empty((B, 0, self.embed_dim), device=self.no_mask_embed.weight.device)
        if points is not None:
            sparse = torch.cat([sparse, self.embed_points(points, labels, boxes is None, prec)], 1)
        if boxes is not None:
            corners = self.pe_layer.forward_with_coords((boxes + 0.5).reshape(-1, 2, 2),
                                                        self.input_image_size, prec)
            corners[:, 0] += self.point_embeddings[2].weight[0]
            corners[:, 1] += self.point_embeddings[3].weight[0]
            sparse = torch.cat([sparse, corners], dim=1)
        if masks is not None:
            dense = self.embed_masks(masks, prec)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(B, -1, h, w)
        return sparse, dense


class DecAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj, self.k_proj = Linear(dim, inner), Linear(dim, inner)
        self.v_proj, self.out_proj = Linear(dim, inner), Linear(inner, dim)

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v, prec):
        q = self._split(self.q_proj(q, prec))
        k = self._split(self.k_proj(k, prec))
        v = self._split(self.v_proj(v, prec))
        attn = prec.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = prec.matmul(torch.softmax(attn, dim=-1), v)
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c), prec)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, act, skip_first_layer_pe):
        super().__init__()
        self.self_attn = DecAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, act)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe, prec):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, prec)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, prec)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys, prec))
        queries = self.norm3(queries + self.mlp(queries, prec))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries, prec))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth, dim, num_heads, mlp_dim, act):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(dim, num_heads, mlp_dim, act, i == 0)
                                    for i in range(depth))
        self.final_attn_token_to_image = DecAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding, prec):
        keys = image_embedding.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe, prec)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys, prec))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, in_dim, hidden, out_dim, depth):
        super().__init__()
        dims = [in_dim] + [hidden] * (depth - 1) + [out_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, prec):
        for i, layer in enumerate(self.layers):
            x = layer(x, prec)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


class MaskDecoder(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, mlp_dim: int,
                 num_multimask_outputs: int, iou_head_depth: int, iou_head_hidden_dim: int,
                 mlp_activation: str):
        super().__init__()
        self.num_mask_tokens = num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(depth, dim, num_heads, mlp_dim,
                                             ACTIVATIONS[mlp_activation])
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense, prec):
        """All mask outputs and IoU predictions: ((B, 4, 256, 256), (B, 4))."""
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(sparse.shape[0], -1, -1), sparse], dim=1)
        src = torch.repeat_interleave(image_embeddings, tokens.shape[0] // image_embeddings.shape[0],
                                      dim=0) + dense
        pos_src = image_pe.expand(tokens.shape[0], -1, -1, -1)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos_src, tokens, prec)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + self.num_mask_tokens]
        up = self.output_upscaling
        src = src.transpose(1, 2).reshape(b, c, h, w)
        x = up[2](up[1](prec.conv_transpose2d(src, up[0].weight, up[0].bias)))
        x = up[4](prec.conv_transpose2d(x, up[3].weight, up[3].bias))
        hyper = torch.stack([m(mask_out[:, i], prec)
                             for i, m in enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = x.shape
        masks = prec.matmul(hyper, x.view(b, c, h * w)).view(b, -1, h, w)
        return masks, self.iou_prediction_head(iou_out, prec)


class Sam(nn.Module):
    def __init__(self, cfg: dict):
        """``cfg``: a configuration file's dict (``build_sam.py``'s
        arguments)."""
        super().__init__()
        size, patch, dim = cfg["image_size"], cfg["vit_patch_size"], cfg["prompt_embed_dim"]
        dec = cfg["decoder"]
        self.image_encoder = ImageEncoderViT(
            size, patch, cfg["encoder_embed_dim"], cfg["encoder_depth"],
            cfg["encoder_num_heads"], cfg["mlp_ratio"], dim, cfg["window_size"],
            cfg["encoder_global_attn_indexes"])
        self.prompt_encoder = PromptEncoder(dim, (size // patch, size // patch), (size, size))
        self.mask_decoder = MaskDecoder(
            dim, dec["transformer_depth"], dec["transformer_num_heads"], dec["transformer_mlp_dim"],
            dec["num_multimask_outputs"], dec["iou_head_depth"], dec["iou_head_hidden_dim"],
            dec["mlp_activation"])
        self.img_size = size

    def preprocess(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 3) pixel values -> normalized, zero-padded (B, 3, S, S)."""
        mean = torch.tensor(PIXEL_MEAN, device=pixels.device)
        std = torch.tensor(PIXEL_STD, device=pixels.device)
        x = ((pixels.float() - mean) / std).permute(0, 3, 1, 2)
        h, w = x.shape[-2:]
        return F.pad(x, (0, self.img_size - w, 0, self.img_size - h))

    def embed(self, pixels: torch.Tensor, prec: Precision) -> torch.Tensor:
        """(B, h, w, 3) pixels -> (B, 256, 64, 64) image embeddings."""
        return self.image_encoder(self.preprocess(pixels), prec)

    def decode(self, embeddings, points, labels, boxes, masks, prec: Precision):
        """Image embeddings (B, C, h, w) and per-image prompts -> all masks
        (B, 4, 256, 256) and IoU predictions (B, 4)."""
        sparse, dense = self.prompt_encoder(points, labels, boxes, masks, prec)
        pe = self.prompt_encoder.pe_layer.dense(self.prompt_encoder.image_embedding_size, prec)
        return self.mask_decoder(embeddings, pe[None], sparse, dense, prec)
