"""ONNX-traceable torch module for the SAM decode path (the port's copy of
``micro_sam_tpu/bioimageio/onnx_decoder.py``).

The BioEngine / Triton deployment splits SAM into a server-side image encoder
and a client-side (ONNX runtime) decode step, as micro-sam exports
segment_anything's SamOnnxModel. This module rebuilds that decode contract in
plain torch from a SAM state dict in segment_anything's key layout, which is
the layout of the port's ``Sam.state_dict()`` (``prompt_encoder.*`` /
``mask_decoder.*`` under upstream's names, so no key is mapped):

inputs:
    image_embeddings (1, 256, E, E) float32
    point_coords     (1, N, 2) float32, (x, y) in resized-input pixels
    point_labels     (1, N) float32    (-1 pad, 0 neg, 1 pos, 2/3 box corners)
    mask_input       (1, 1, 4E, 4E) float32 logits
    has_mask_input   (1,) float32
    orig_im_size     (2,) float32      (H, W) of the original image
outputs:
    masks            (1, M, H, W)   upscaled logits
    iou_predictions  (1, M)
    low_res_masks    (1, M, 4E, 4E)

Everything is trace-friendly: no data-dependent Python control flow; the
dynamic point count N and the dynamic output size ride ONNX dynamic axes.
"""
from __future__ import annotations

# GELU used throughout the traced decoder. set_gelu_approximate switches to
# the tanh approximation for ONNX backends without an Erf op
# (SamOnnxModel's gelu_approximate flag).
_GELU_APPROXIMATE = "none"


def set_gelu_approximate(approximate: str = "tanh") -> None:
    global _GELU_APPROXIMATE
    _GELU_APPROXIMATE = approximate


def _gelu(x):
    return F.gelu(x, approximate=_GELU_APPROXIMATE)


import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _t(sd, key):
    v = sd[key]
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


class _LayerNorm2d(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = nn.Parameter(w), nn.Parameter(b)

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + 1e-6)
        return self.w[:, None, None] * x + self.b[:, None, None]


class _Attention(nn.Module):
    """Downscaled decoder attention (segment_anything's TwoWayTransformer attention)."""

    def __init__(self, sd, pre, num_heads=8):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w, b = _t(sd, f"{pre}.{name}.weight"), _t(sd, f"{pre}.{name}.bias")
            lin = nn.Linear(w.shape[1], w.shape[0])
            lin.weight, lin.bias = nn.Parameter(w), nn.Parameter(b)
            setattr(self, name, lin)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, N, C = q.shape
        hd = C // self.num_heads
        q = q.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        k = k.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        v = v.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        attn = ((q / math.sqrt(hd)) @ k.transpose(-2, -1)).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, -1, C)
        return self.out_proj(out)


def _linear(sd, pre):
    w, b = _t(sd, f"{pre}.weight"), _t(sd, f"{pre}.bias")
    lin = nn.Linear(w.shape[1], w.shape[0])
    lin.weight, lin.bias = nn.Parameter(w), nn.Parameter(b)
    return lin


def _norm(sd, pre):
    w = _t(sd, f"{pre}.weight")
    n = nn.LayerNorm(w.shape[0], eps=1e-5)
    n.weight, n.bias = nn.Parameter(w), nn.Parameter(_t(sd, f"{pre}.bias"))
    return n


class _TwoWayBlock(nn.Module):
    def __init__(self, sd, pre, skip_first_pe):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = _Attention(sd, f"{pre}.self_attn")
        self.t2i = _Attention(sd, f"{pre}.cross_attn_token_to_image")
        self.i2t = _Attention(sd, f"{pre}.cross_attn_image_to_token")
        self.norm1, self.norm2 = _norm(sd, f"{pre}.norm1"), _norm(sd, f"{pre}.norm2")
        self.norm3, self.norm4 = _norm(sd, f"{pre}.norm3"), _norm(sd, f"{pre}.norm4")
        self.lin1, self.lin2 = _linear(sd, f"{pre}.mlp.lin1"), _linear(sd, f"{pre}.mlp.lin2")

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        queries = queries + self.t2i(queries + query_pe, keys + key_pe, keys)
        queries = self.norm2(queries)
        queries = self.norm3(queries + self.lin2(_gelu(self.lin1(queries))))
        keys = keys + self.i2t(keys + key_pe, queries + query_pe, queries)
        return queries, self.norm4(keys)


class _Mlp3(nn.Module):
    def __init__(self, sd, pre):
        super().__init__()
        self.layers = nn.ModuleList(
            [_linear(sd, f"{pre}.layers.{j}") for j in range(3)])

    def forward(self, x):
        for j, lin in enumerate(self.layers):
            x = lin(x)
            if j < 2:
                x = F.relu(x)
        return x


class OnnxSamDecoder(nn.Module):
    """Prompt encoder + mask decoder with the SAM ONNX model's IO contract."""

    def __init__(self, sd: Dict[str, torch.Tensor], img_size: int = 1024,
                 embedding_size: int = 64, return_single_mask: bool = False,
                 use_stability_score: bool = False,
                 return_extra_metrics: bool = False,
                 stability_score_offset: float = 1.0):
        super().__init__()
        self.img_size = img_size
        self.embedding_size = embedding_size
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.return_extra_metrics = return_extra_metrics
        self.stability_score_offset = stability_score_offset

        pe = "prompt_encoder"
        self.register_buffer(
            "pe_matrix", _t(sd, f"{pe}.pe_layer.positional_encoding_gaussian_matrix"))
        self.register_buffer("not_a_point", _t(sd, f"{pe}.not_a_point_embed.weight")[0])
        self.register_buffer("point_embeds", torch.stack(
            [_t(sd, f"{pe}.point_embeddings.{i}.weight")[0] for i in range(4)]))
        self.register_buffer("no_mask_embed", _t(sd, f"{pe}.no_mask_embed.weight")[0])

        # mask-input downscaling convs (PromptEncoder.mask_downscaling)
        self.mask_down = nn.ModuleList()
        self.mask_down_ln = nn.ModuleList()
        for i, ln_i in ((0, 1), (3, 4)):
            w = _t(sd, f"{pe}.mask_downscaling.{i}.weight")
            conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], stride=2)
            conv.weight = nn.Parameter(w)
            conv.bias = nn.Parameter(_t(sd, f"{pe}.mask_downscaling.{i}.bias"))
            self.mask_down.append(conv)
            self.mask_down_ln.append(_LayerNorm2d(
                _t(sd, f"{pe}.mask_downscaling.{ln_i}.weight"),
                _t(sd, f"{pe}.mask_downscaling.{ln_i}.bias")))
        w = _t(sd, f"{pe}.mask_downscaling.6.weight")
        final = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2])
        final.weight = nn.Parameter(w)
        final.bias = nn.Parameter(_t(sd, f"{pe}.mask_downscaling.6.bias"))
        self.mask_down_final = final

        md = "mask_decoder"
        self.register_buffer("iou_token", _t(sd, f"{md}.iou_token.weight"))
        self.register_buffer("mask_tokens", _t(sd, f"{md}.mask_tokens.weight"))
        self.blocks = nn.ModuleList([
            _TwoWayBlock(sd, f"{md}.transformer.layers.{i}", skip_first_pe=(i == 0))
            for i in range(2)])
        self.final_t2i = _Attention(sd, f"{md}.transformer.final_attn_token_to_image")
        self.norm_final = _norm(sd, f"{md}.transformer.norm_final_attn")

        for i, name in ((0, "up1"), (3, "up2")):
            w = _t(sd, f"{md}.output_upscaling.{i}.weight")
            tc = nn.ConvTranspose2d(w.shape[0], w.shape[1], w.shape[2], stride=2)
            tc.weight = nn.Parameter(w)
            tc.bias = nn.Parameter(_t(sd, f"{md}.output_upscaling.{i}.bias"))
            setattr(self, name, tc)
        self.up_ln = _LayerNorm2d(_t(sd, f"{md}.output_upscaling.1.weight"),
                                  _t(sd, f"{md}.output_upscaling.1.bias"))
        self.hyper_mlps = nn.ModuleList([
            _Mlp3(sd, f"{md}.output_hypernetworks_mlps.{i}") for i in range(4)])
        self.iou_head = _Mlp3(sd, f"{md}.iou_prediction_head")

    # -- prompt encoding ---------------------------------------------------
    def _pe_encode(self, coords):
        coords = 2.0 * coords - 1.0
        coords = coords @ self.pe_matrix
        coords = 2.0 * np.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def _embed_points(self, coords, labels):
        coords = (coords + 0.5) / self.img_size
        pe = self._pe_encode(coords)
        out = torch.where(labels[..., None] == -1.0,
                          self.not_a_point.to(pe.dtype), pe)
        zero = pe.new_zeros(1)  # device-safe (buffers follow .to()/.cuda())
        for val in range(4):
            out = out + torch.where(
                labels[..., None] == float(val),
                self.point_embeds[val].to(pe.dtype), zero)
        return out

    def _embed_mask(self, mask_input, has_mask_input):
        x = mask_input
        for conv, ln_ in zip(self.mask_down, self.mask_down_ln):
            x = _gelu(ln_(conv(x)))
        dense = self.mask_down_final(x)
        no_mask = self.no_mask_embed.reshape(1, -1, 1, 1)
        return has_mask_input * dense + (1.0 - has_mask_input) * no_mask

    def _dense_pe(self):
        e = self.embedding_size
        grid = self.pe_matrix.new_ones((e, e))
        y = (grid.cumsum(dim=0) - 0.5) / e
        x = (grid.cumsum(dim=1) - 0.5) / e
        return self._pe_encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)

    # -- decode ------------------------------------------------------------
    def _decode(self, image_embeddings, sparse, dense):
        tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        B = sparse.shape[0]
        tokens = torch.cat([tokens.unsqueeze(0).expand(B, -1, -1), sparse], dim=1)

        src = image_embeddings + dense
        b, c, h, w = src.shape
        keys = src.flatten(2).permute(0, 2, 1)
        pe_f = self._dense_pe().reshape(c, h * w).permute(1, 0)[None].expand(B, -1, -1)

        queries = tokens
        for blk in self.blocks:
            queries, keys = blk(queries, keys, tokens, pe_f)
        queries = queries + self.final_t2i(queries + tokens, keys + pe_f, keys)
        queries = self.norm_final(queries)

        iou_out = queries[:, 0]
        mask_tokens_out = queries[:, 1:5]

        src_out = keys.transpose(1, 2).reshape(b, c, h, w)
        up = _gelu(self.up_ln(self.up1(src_out)))
        up = _gelu(self.up2(up))

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.hyper_mlps)], dim=1)
        bb, cc, hh, ww = up.shape
        masks = (hyper_in @ up.reshape(bb, cc, hh * ww)).reshape(bb, -1, hh, ww)
        return masks, self.iou_head(iou_out)

    def forward(self, image_embeddings, point_coords, point_labels,
                mask_input, has_mask_input, orig_im_size):
        sparse = self._embed_points(point_coords, point_labels)
        dense = self._embed_mask(mask_input, has_mask_input)
        low_res_masks, iou_predictions = self._decode(
            image_embeddings, sparse, dense)

        if self.use_stability_score:
            # replace model scores with the stability score
            # (SamOnnxModel's behaviour)
            iou_predictions = self._stability_scores(low_res_masks)

        if self.return_single_mask:
            # best-of-multimask selection, trace-friendly (argmax over scores
            # ignoring the whole-object slot 0, as SamOnnxModel does)
            best = torch.argmax(iou_predictions[:, 1:], dim=1) + 1
            low_res_masks = low_res_masks[
                torch.arange(low_res_masks.shape[0]), best][:, None]
            iou_predictions = iou_predictions[
                torch.arange(iou_predictions.shape[0]), best][:, None]

        # upscale to the padded model input, crop the pre-padding region,
        # then resize to the original image size
        masks = F.interpolate(
            low_res_masks, size=(self.img_size, self.img_size),
            mode="bilinear", align_corners=False)
        scale = self.img_size / torch.max(orig_im_size)
        pre_pad = torch.floor(orig_im_size * scale + 0.5).to(torch.int64)
        masks = masks[..., : pre_pad[0], : pre_pad[1]]
        size = orig_im_size.to(torch.int64)
        masks = F.interpolate(
            masks, size=(size[0], size[1]), mode="bilinear", align_corners=False)
        if self.return_extra_metrics:
            stability = self._stability_scores(low_res_masks)
            areas = (masks > 0.0).to(torch.float32).sum(dim=(-2, -1))
            return masks, iou_predictions, stability, areas, low_res_masks
        return masks, iou_predictions, low_res_masks

    def _stability_scores(self, masks):
        """Stability score: IoU between thresholds +-offset around 0
        (segment_anything amg convention)."""
        o = self.stability_score_offset
        hi = (masks > o).to(torch.float32).sum(dim=(-2, -1))
        lo = (masks > -o).to(torch.float32).sum(dim=(-2, -1))
        return hi / torch.clamp(lo, min=1.0)
