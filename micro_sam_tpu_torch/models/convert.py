"""Weights for the port: zoo checkpoints and the JAX package's parameter trees.

The port's modules use the segment_anything key layout, so a zoo ``.pt`` /
``.pth`` state dict (or a micro-sam training checkpoint holding one under
``model_state`` with a ``sam.`` prefix) loads with ``load_state_dict``.
``params_from_jax`` maps the JAX package's parameter tree (nested dicts and
lists of numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives them) to
the same layout:

- Linear ``w`` (in, out)              -> ``weight`` (out, in)
- Conv ``w`` (kh, kw, I, O)           -> ``weight`` (O, I, kh, kw)
- ConvTranspose ``w`` (kh, kw, O, I)  -> ``weight`` (I, O, kh, kw)
- LayerNorm ``scale`` / ``bias``      -> ``weight`` / ``bias``
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .build_sam import get_config
from .sam import SamConfig


def normalize_state_dict(state) -> Tuple[Dict, Optional[Dict]]:
    """Raw SAM state dict or micro-sam training checkpoint -> (sam_state,
    decoder_state or None), with the ``sam.`` prefix stripped."""
    decoder_state = None
    if isinstance(state, dict) and "model_state" in state:
        decoder_state = state.get("decoder_state")
        state = state["model_state"]
    if any(k.startswith("sam.") for k in state):
        state = {k[len("sam."):]: v for k, v in state.items() if k.startswith("sam.")}
    return state, decoder_state


def infer_model_type(sam_state: Dict) -> str:
    if any(k.startswith("image_encoder.layers") for k in sam_state):
        return "vit_t"
    embed_dim = sam_state["image_encoder.patch_embed.proj.weight"].shape[0]
    return {768: "vit_b", 1024: "vit_l", 1280: "vit_h"}[int(embed_dim)]


def load_torch_checkpoint(path: str, model_type: Optional[str] = None):
    """Read a zoo ``.pt`` / ``.pth``. Returns (config, state_dict, decoder_state)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    sam_state, decoder_state = normalize_state_dict(state)
    config = get_config(model_type or infer_model_type(sam_state))
    return config, sam_state, decoder_state


def params_from_jax(params: dict, config: SamConfig) -> Dict[str, torch.Tensor]:
    """JAX package parameter tree (numpy leaves) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def conv(name, p):  # both conv layouts map by the same transpose
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def attn_ds(name, p):
        for part, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            lin(f"{name}.{key}", p[part])

    if config.encoder != "vit":
        raise NotImplementedError("the TinyViT encoder is not ported yet")
    enc = params["image_encoder"]
    conv("image_encoder.patch_embed.proj", enc["patch_embed"])
    if "pos_embed" in enc:
        sd["image_encoder.pos_embed"] = np.asarray(enc["pos_embed"])
    for i, b in enumerate(enc["blocks"]):
        pre = f"image_encoder.blocks.{i}"
        ln(f"{pre}.norm1", b["norm1"])
        lin(f"{pre}.attn.qkv", b["attn"]["qkv"])
        lin(f"{pre}.attn.proj", b["attn"]["proj"])
        sd[f"{pre}.attn.rel_pos_h"] = np.asarray(b["attn"]["rel_pos_h"])
        sd[f"{pre}.attn.rel_pos_w"] = np.asarray(b["attn"]["rel_pos_w"])
        ln(f"{pre}.norm2", b["norm2"])
        lin(f"{pre}.mlp.lin1", b["mlp"]["lin1"])
        lin(f"{pre}.mlp.lin2", b["mlp"]["lin2"])
    conv("image_encoder.neck.0", enc["neck"]["conv1"])
    ln("image_encoder.neck.1", enc["neck"]["ln1"])
    conv("image_encoder.neck.2", enc["neck"]["conv2"])
    ln("image_encoder.neck.3", enc["neck"]["ln2"])

    pr = params["prompt_encoder"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(pr["pe_gaussian"])
    for i, p in enumerate(pr["point_embeddings"]):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = np.asarray(p["w"])
    sd["prompt_encoder.not_a_point_embed.weight"] = np.asarray(pr["not_a_point_embed"]["w"])
    sd["prompt_encoder.no_mask_embed.weight"] = np.asarray(pr["no_mask_embed"]["w"])
    mdn = pr["mask_downscaling"]
    conv("prompt_encoder.mask_downscaling.0", mdn["conv1"])
    ln("prompt_encoder.mask_downscaling.1", mdn["ln1"])
    conv("prompt_encoder.mask_downscaling.3", mdn["conv2"])
    ln("prompt_encoder.mask_downscaling.4", mdn["ln2"])
    conv("prompt_encoder.mask_downscaling.6", mdn["conv3"])

    de = params["mask_decoder"]
    for i, lp in enumerate(de["transformer"]["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}"
        attn_ds(f"{pre}.self_attn", lp["self_attn"])
        ln(f"{pre}.norm1", lp["norm1"])
        attn_ds(f"{pre}.cross_attn_token_to_image", lp["cross_attn_t2i"])
        ln(f"{pre}.norm2", lp["norm2"])
        lin(f"{pre}.mlp.lin1", lp["mlp"]["lin1"])
        lin(f"{pre}.mlp.lin2", lp["mlp"]["lin2"])
        ln(f"{pre}.norm3", lp["norm3"])
        attn_ds(f"{pre}.cross_attn_image_to_token", lp["cross_attn_i2t"])
        ln(f"{pre}.norm4", lp["norm4"])
    attn_ds("mask_decoder.transformer.final_attn_token_to_image", de["transformer"]["final_attn"])
    ln("mask_decoder.transformer.norm_final_attn", de["transformer"]["norm_final"])
    sd["mask_decoder.iou_token.weight"] = np.asarray(de["iou_token"]["w"])
    sd["mask_decoder.mask_tokens.weight"] = np.asarray(de["mask_tokens"]["w"])
    conv("mask_decoder.output_upscaling.0", de["upscale_conv1"])
    ln("mask_decoder.output_upscaling.1", de["upscale_ln"])
    conv("mask_decoder.output_upscaling.3", de["upscale_conv2"])
    for i, hp in enumerate(de["hyper_mlps"]):
        for j, lp in enumerate(hp["layers"]):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", lp)
    for j, lp in enumerate(de["iou_head"]["layers"]):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}", lp)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def load_native_checkpoint(path: str, model_type: Optional[str] = None,
                           config: Optional[SamConfig] = None
                           ) -> Tuple[SamConfig, Dict[str, torch.Tensor]]:
    """The JAX package's native ``.npz`` / ``.msam`` checkpoint (flat npz whose
    keys are '/'-joined parameter-tree paths) -> (config, state dict). The
    config is the named model type's unless one is given."""
    data = np.load(path, allow_pickle=False)
    if config is None:
        config = get_config(model_type or str(data["__model_type__"]))

    tree: dict = {}
    for key in data.files:
        if key.startswith("__"):
            continue
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return config, params_from_jax(listify(tree), config)
