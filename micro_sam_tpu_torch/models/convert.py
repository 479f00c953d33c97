"""Weights for the port: zoo checkpoints and the JAX package's parameter trees.

The port's modules use the segment_anything key layout, so a zoo ``.pt`` /
``.pth`` state dict (or a micro-sam training checkpoint holding one under
``model_state`` with a ``sam.`` prefix) loads with ``load_state_dict``.
``params_from_jax`` maps the JAX package's parameter tree (nested dicts and
lists of numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives them) to
the same layout, and ``params_to_jax`` maps it back (the trainer's checkpoints
hold the JAX tree, so they load in either package):

- Linear ``w`` (in, out)              -> ``weight`` (out, in)
- Conv ``w`` (kh, kw, I, O)           -> ``weight`` (O, I, kh, kw)
- ConvTranspose ``w`` (kh, kw, O, I)  -> ``weight`` (I, O, kh, kw)
- LayerNorm ``scale`` / ``bias``      -> ``weight`` / ``bias``
- conv + BatchNorm ``{conv: {w}, bn: {scale, bias, mean, var}}``
                                      -> ``c.weight``, ``bn.{weight, bias, running_mean, running_var}``

The TinyViT (vit_t) qkv product is the one place where the layouts differ
by more than a transpose: the JAX package splits its 3C output channels into
global thirds [q | k | v], upstream TinyViT (and the port) per head, [q_h |
k_h | v_h] for h = 0..nH-1. Row h * 3hd + p * hd + d of the port's weight is
column p * C + h * hd + d of the JAX weight; ``params_from_jax`` /
``params_to_jax`` permute, so both packages compute the same function on one
JAX tree. A MobileSAM-layout state dict (``load_torch_checkpoint``) is
upstream's order already and loads unchanged.

PEFT parameters (``models/peft_sam.py``) and the 3d wrapper's depth adapters
(``models/sam_3d_wrapper.py``) carry across under the same names in both
directions: LoRA ``a`` / ``b``, FacT's ``fact_u`` / ``fact_v`` and scales, SSF's
``ssf_scale`` / ``ssf_shift``, the AdaptFormer ``adapter`` (JAX orientation
each); a depth conv ``w`` (3, 1, 1, 1, C) -> ``weight`` (C, 1, 3, 1, 1).
int4 storage: the JAX package's ``w_q4`` (in, out) int4 (``ml_dtypes``, read
through int8) <-> the port's ``w_q4`` (out, in / 2) uint8, two values a byte
(``common.pack_int4``); ``w_scale`` (in / 64, out) stays bf16 in the port and
is float32 in the tree the port writes (numpy has no bf16).

The UNETR decoder of AIS keeps torch_em's keys; ``unetr_params_from_jax`` /
``unetr_params_to_jax`` map the JAX package's decoder pytree to them and back
with the same transposes (its upsamplers told apart by structure).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .build_sam import get_config
from .common import pack_int4, unpack_int4
from .sam import SamConfig
from .tiny_vit import NUM_HEADS as TINY_NUM_HEADS


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


# keys of a MobileSAM TinyViT state dict that the encoder does not use: the
# ImageNet classifier head, BatchNorm's batch counters, the derived bias index
_TINY_UNUSED_PREFIXES = ("image_encoder.norm_head.", "image_encoder.head.")
_TINY_UNUSED_SUFFIXES = (".num_batches_tracked", ".attention_bias_idxs")


def load_torch_checkpoint(path: str, model_type: Optional[str] = None):
    """Read a zoo ``.pt`` / ``.pth`` (for vit_t, MobileSAM's layout, as it is).
    Returns (config, state_dict, decoder_state)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    sam_state, decoder_state = normalize_state_dict(state)
    config = get_config(model_type or infer_model_type(sam_state))
    if config.encoder == "tiny_vit":
        sam_state = {k: v for k, v in sam_state.items()
                     if not k.startswith(_TINY_UNUSED_PREFIXES)
                     and not k.endswith(_TINY_UNUSED_SUFFIXES)}
    return config, sam_state, decoder_state


Layer = Tuple  # (port key prefix, JAX tree path, kind[, heads])


def _vit_encoder_layers(n_blocks: int) -> List[Layer]:
    enc = ("image_encoder",)
    L: List[Layer] = [("image_encoder.patch_embed.proj", enc + ("patch_embed",), "conv"),
                      ("image_encoder.pos_embed", enc + ("pos_embed",), "array")]
    for i in range(n_blocks):
        pre, bp = f"image_encoder.blocks.{i}", enc + ("blocks", i)
        L += [(f"{pre}.norm1", bp + ("norm1",), "ln"),
              (f"{pre}.attn.qkv", bp + ("attn", "qkv"), "lin"),
              (f"{pre}.attn.proj", bp + ("attn", "proj"), "lin"),
              (f"{pre}.attn.rel_pos_h", bp + ("attn", "rel_pos_h"), "array"),
              (f"{pre}.attn.rel_pos_w", bp + ("attn", "rel_pos_w"), "array"),
              (f"{pre}.norm2", bp + ("norm2",), "ln"),
              (f"{pre}.mlp.lin1", bp + ("mlp", "lin1"), "lin"),
              (f"{pre}.mlp.lin2", bp + ("mlp", "lin2"), "lin")]
    return L + _neck_layers()


def _tiny_vit_encoder_layers(depths: Sequence[int]) -> List[Layer]:
    """MobileSAM's TinyViT keys against the JAX package's tiny_vit tree:
    ``layers.0`` is the MBConv stage (``stage0``), ``layers.1..3`` the
    attention stages; ``layers.i.downsample`` is ``merge{i}``."""
    enc = ("image_encoder",)
    L: List[Layer] = [("image_encoder.patch_embed.seq.0", enc + ("patch_embed", "conv1"), "conv_bn"),
                      ("image_encoder.patch_embed.seq.2", enc + ("patch_embed", "conv2"), "conv_bn")]

    def merge(stage):
        return [(f"image_encoder.layers.{stage}.downsample.{c}", enc + (f"merge{stage}", c),
                 "conv_bn") for c in ("conv1", "conv2", "conv3")]

    for i in range(depths[0]):
        L += [(f"image_encoder.layers.0.blocks.{i}.{c}", enc + ("stage0", i, c), "conv_bn")
              for c in ("conv1", "conv2", "conv3")]
    L += merge(0)
    for stage in (1, 2, 3):
        for i in range(depths[stage]):
            pre, bp = f"image_encoder.layers.{stage}.blocks.{i}", enc + (f"stage{stage}", i)
            L += [(f"{pre}.attn.norm", bp + ("attn", "norm"), "ln"),
                  (f"{pre}.attn.qkv", bp + ("attn", "qkv"), "qkv", TINY_NUM_HEADS[stage]),
                  (f"{pre}.attn.proj", bp + ("attn", "proj"), "lin"),
                  (f"{pre}.attn.attention_biases", bp + ("attn", "attention_biases"), "array"),
                  (f"{pre}.local_conv", bp + ("local_conv",), "conv_bn"),
                  (f"{pre}.mlp.norm", bp + ("mlp", "norm"), "ln"),
                  (f"{pre}.mlp.fc1", bp + ("mlp", "lin1"), "lin"),
                  (f"{pre}.mlp.fc2", bp + ("mlp", "lin2"), "lin")]
        if stage < 3:
            L += merge(stage)
    return L + _neck_layers()


def _neck_layers() -> List[Layer]:
    return [(f"image_encoder.neck.{port}", ("image_encoder", "neck", jax_name), kind)
            for port, jax_name, kind in (("0", "conv1", "conv"), ("1", "ln1", "ln"),
                                         ("2", "conv2", "conv"), ("3", "ln2", "ln"))]


def _qkv_thirds_to_heads(a: np.ndarray, heads: int) -> np.ndarray:
    """(3C, ...) rows in the JAX package's [q | k | v] order -> per head [q_h | k_h | v_h]."""
    return a.reshape(3, heads, -1, *a.shape[1:]).swapaxes(0, 1).reshape(a.shape)


def _qkv_heads_to_thirds(a: np.ndarray, heads: int) -> np.ndarray:
    return a.reshape(heads, 3, -1, *a.shape[1:]).swapaxes(0, 1).reshape(a.shape)


def _layers(encoder: List[Layer], n_decoder_layers: int, n_hyper: int, n_hyper_layers: int,
            n_iou_layers: int) -> List[Layer]:
    """(port key prefix, JAX tree path, kind[, heads]) of every parameter of
    the SAM, the encoder's first. kind: "lin", "qkv" (a linear whose output
    rows are permuted, see the module docstring), "conv" (either conv
    layout), "conv_bn", "ln", "emb" (a ``w`` table) or "array" (a bare leaf)."""
    L: List[Layer] = list(encoder)
    pr = ("prompt_encoder",)
    L.append(("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
              pr + ("pe_gaussian",), "array"))
    L += [(f"prompt_encoder.point_embeddings.{i}", pr + ("point_embeddings", i), "emb")
          for i in range(4)]
    L += [("prompt_encoder.not_a_point_embed", pr + ("not_a_point_embed",), "emb"),
          ("prompt_encoder.no_mask_embed", pr + ("no_mask_embed",), "emb")]
    for port, jax_name, kind in (("0", "conv1", "conv"), ("1", "ln1", "ln"), ("3", "conv2", "conv"),
                                 ("4", "ln2", "ln"), ("6", "conv3", "conv")):
        L.append((f"prompt_encoder.mask_downscaling.{port}", pr + ("mask_downscaling", jax_name),
                  kind))

    de = ("mask_decoder",)
    attn_parts = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out"))

    def attn_ds(port, path):
        return [(f"{port}.{a}", path + (b,), "lin") for a, b in attn_parts]

    for i in range(n_decoder_layers):
        pre, lp = f"mask_decoder.transformer.layers.{i}", de + ("transformer", "layers", i)
        L += attn_ds(f"{pre}.self_attn", lp + ("self_attn",))
        L.append((f"{pre}.norm1", lp + ("norm1",), "ln"))
        L += attn_ds(f"{pre}.cross_attn_token_to_image", lp + ("cross_attn_t2i",))
        L += [(f"{pre}.norm2", lp + ("norm2",), "ln"),
              (f"{pre}.mlp.lin1", lp + ("mlp", "lin1"), "lin"),
              (f"{pre}.mlp.lin2", lp + ("mlp", "lin2"), "lin"),
              (f"{pre}.norm3", lp + ("norm3",), "ln")]
        L += attn_ds(f"{pre}.cross_attn_image_to_token", lp + ("cross_attn_i2t",))
        L.append((f"{pre}.norm4", lp + ("norm4",), "ln"))
    L += attn_ds("mask_decoder.transformer.final_attn_token_to_image",
                 de + ("transformer", "final_attn"))
    L += [("mask_decoder.transformer.norm_final_attn", de + ("transformer", "norm_final"), "ln"),
          ("mask_decoder.iou_token", de + ("iou_token",), "emb"),
          ("mask_decoder.mask_tokens", de + ("mask_tokens",), "emb"),
          ("mask_decoder.output_upscaling.0", de + ("upscale_conv1",), "conv"),
          ("mask_decoder.output_upscaling.1", de + ("upscale_ln",), "ln"),
          ("mask_decoder.output_upscaling.3", de + ("upscale_conv2",), "conv")]
    for i in range(n_hyper):
        L += [(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
               de + ("hyper_mlps", i, "layers", j), "lin") for j in range(n_hyper_layers)]
    L += [(f"mask_decoder.iou_prediction_head.layers.{j}", de + ("iou_head", "layers", j), "lin")
          for j in range(n_iou_layers)]
    return L


_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))

_BLOCK_LINEARS = (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                  ("mlp.lin1", ("mlp", "lin1")), ("mlp.lin2", ("mlp", "lin2")))


def _int4_from_jax(node: dict) -> Dict[str, torch.Tensor]:
    """A quantized linear's JAX ``w_q4`` / ``w_scale`` -> the port's packed
    uint8 ``w_q4`` and bf16 ``w_scale``."""
    q = torch.from_numpy(np.asarray(node["w_q4"]).astype(np.int8))
    scale = torch.from_numpy(np.asarray(node["w_scale"]).astype(np.float32))
    return {"w_q4": pack_int4(q.t()), "w_scale": scale.to(torch.bfloat16)}


def _peft_leaves(enc: dict):
    """(port key, JAX path under ``image_encoder``, kind) of the PEFT and
    depth-adapter leaves present in a JAX encoder tree; kind: "array" (as it
    is), "lin_w" (transposed), "depth_w" (a depth conv's kernel)."""
    out = []
    if "fact_u" in enc:
        out += [("image_encoder.fact_u", ("fact_u",), "array"),
                ("image_encoder.fact_v", ("fact_v",), "array")]
    for i, bp in enumerate(enc["blocks"]):
        pre, bpath = f"image_encoder.blocks.{i}", ("blocks", i)
        attn, mlp = bp["attn"], bp["mlp"]
        for part in attn.get("lora", {}):
            out += [(f"{pre}.attn.lora.{part}.{m}", bpath + ("attn", "lora", part, m), "array")
                    for m in ("a", "b")]
        for m in attn.get("fact", {}):
            if not m.startswith("_"):
                out.append((f"{pre}.attn.fact.{m}", bpath + ("attn", "fact", m), "array"))
        for port, jpath in _BLOCK_LINEARS:
            node = bp[jpath[0]][jpath[1]]
            if "lora" in node:
                out += [(f"{pre}.{port}.lora.{m}", bpath + jpath + ("lora", m), "array")
                        for m in ("a", "b")]
            out += [(f"{pre}.{port}.{m}", bpath + jpath + (m,), "array")
                    for m in ("ssf_scale", "ssf_shift") if m in node]
        for m in mlp.get("adapter", {}):
            out.append((f"{pre}.mlp.adapter.{m}", bpath + ("mlp", "adapter", m), "array"))
        for ad in ("adapter_pre", "adapter_post"):
            if ad in bp:
                ap = bpath + (ad,)
                out += [(f"{pre}.{ad}.depth_conv.weight", ap + ("depth_conv", "w"), "depth_w"),
                        (f"{pre}.{ad}.norm.weight", ap + ("norm", "scale"), "array"),
                        (f"{pre}.{ad}.norm.bias", ap + ("norm", "bias"), "array"),
                        (f"{pre}.{ad}.point.weight", ap + ("point", "w"), "lin_w"),
                        (f"{pre}.{ad}.point.bias", ap + ("point", "b"), "array")]
    return out


_PEFT_KEY_PARTS = (".lora.", ".fact.", ".ssf_", ".adapter.", ".adapter_pre.", ".adapter_post.",
                   "image_encoder.fact_")


def is_peft_key(key: str) -> bool:
    """Whether a state-dict name is a PEFT parameter or a depth adapter's
    (what a checkpoint of the base model lacks)."""
    return any(p in key for p in _PEFT_KEY_PARTS)


def _peft_tree_from_state(sd: Dict[str, np.ndarray]) -> dict:
    """The inverse of ``_peft_leaves``: the PEFT and depth-adapter entries of
    a port state dict (numpy) as an ``image_encoder`` subtree to merge."""
    tree: dict = {}

    def put(path, leaf):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    for key, val in sd.items():
        if not is_peft_key(key):
            continue
        parts = key.split(".")[1:]   # without "image_encoder"
        if parts[0] != "blocks":
            put((parts[0],), val)
            continue
        i, rest = int(parts[1]), parts[2:]
        if rest[0] in ("adapter_pre", "adapter_post"):
            sub, leaf = rest[1], rest[2]
            if sub == "depth_conv":
                put(("blocks", i, rest[0], "depth_conv", "w"), val.transpose(2, 3, 4, 1, 0))
            elif sub == "norm":
                put(("blocks", i, rest[0], "norm", "scale" if leaf == "weight" else "bias"), val)
            else:
                put(("blocks", i, rest[0], "point", "w" if leaf == "weight" else "b"),
                    val.T if leaf == "weight" else val)
        else:
            put(("blocks", i) + tuple(rest), val)
    return tree


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def params_from_jax(params: dict, config: SamConfig) -> Dict[str, torch.Tensor]:
    """JAX package parameter tree (numpy leaves) -> the port's state dict."""
    de, enc = params["mask_decoder"], params["image_encoder"]
    if config.encoder == "tiny_vit":
        encoder = _tiny_vit_encoder_layers([len(enc[f"stage{i}"]) for i in range(4)])
    else:
        encoder = _vit_encoder_layers(len(enc["blocks"]))
    layers = _layers(encoder, len(de["transformer"]["layers"]), len(de["hyper_mlps"]),
                     len(de["hyper_mlps"][0]["layers"]), len(de["iou_head"]["layers"]))
    sd: Dict[str, np.ndarray] = {}
    packed: Dict[str, torch.Tensor] = {}   # int4 storage, not float32
    for key, path, kind, *heads in layers:
        node = params
        for part in path[:-1]:
            node = node[part]
        if isinstance(path[-1], str) and path[-1] not in node:
            continue  # pos_embed of a model without one
        node = node[path[-1]]
        if kind == "lin" and "w" not in node and "w_q4" in node:
            packed.update({f"{key}.{k}": v for k, v in _int4_from_jax(node).items()})
            sd[f"{key}.bias"] = np.asarray(node["b"])
        elif kind == "array":
            sd[key] = np.asarray(node)
        elif kind == "emb":
            sd[f"{key}.weight"] = np.asarray(node["w"])
        elif kind == "ln":
            sd[f"{key}.weight"] = np.asarray(node["scale"])
            sd[f"{key}.bias"] = np.asarray(node["bias"])
        elif kind == "conv_bn":
            sd[f"{key}.c.weight"] = np.asarray(node["conv"]["w"]).transpose(3, 2, 0, 1)
            for port, jax_name in _BN:
                sd[f"{key}.bn.{port}"] = np.asarray(node["bn"][jax_name])
        else:  # lin / qkv / conv: both conv layouts map by the same transpose
            w = np.asarray(node["w"])
            sd[f"{key}.weight"] = w.transpose(3, 2, 0, 1) if kind == "conv" else w.T
            if "b" in node:
                sd[f"{key}.bias"] = np.asarray(node["b"])
            if kind == "qkv":
                for name in ("weight", "bias"):
                    sd[f"{key}.{name}"] = _qkv_thirds_to_heads(sd[f"{key}.{name}"], heads[0])
    if config.encoder != "tiny_vit":
        for key, path, kind in _peft_leaves(enc):
            node = enc
            for part in path:
                node = node[part]
            a = np.asarray(node)
            sd[key] = a.T if kind == "lin_w" else a.transpose(4, 3, 0, 1, 2) \
                if kind == "depth_w" else a
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}
    out.update(packed)
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor], config: SamConfig) -> dict:
    """The port's state dict -> the JAX package's parameter tree (nested dicts
    and lists of float32 numpy arrays): the inverse of ``params_from_jax``."""
    sd = {k: (unpack_int4(v.detach().cpu()).t().numpy() if k.endswith(".w_q4")
              else v.detach().float().cpu().numpy()) for k, v in state_dict.items()}
    n_dec = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("mask_decoder.transformer.layers."))
    if config.encoder == "tiny_vit":
        depths = [1 + max(int(k.split(".")[4]) for k in sd
                          if k.startswith(f"image_encoder.layers.{i}.blocks.")) for i in range(4)]
        encoder = _tiny_vit_encoder_layers(depths)
    else:
        encoder = _vit_encoder_layers(config.depth)
    layers = _layers(encoder, n_dec, 4, 3, 3)
    tree: dict = {}
    for key, path, kind, *heads in layers:
        if kind == "array":
            if key not in sd:
                continue
            leaf = sd[key]
        elif kind == "emb":
            leaf = {"w": sd[f"{key}.weight"]}
        elif kind == "ln":
            leaf = {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}
        elif kind == "conv_bn":
            leaf = {"conv": {"w": sd[f"{key}.c.weight"].transpose(2, 3, 1, 0)},
                    "bn": {jax_name: sd[f"{key}.bn.{port}"] for port, jax_name in _BN}}
        elif f"{key}.w_q4" in sd:   # int4 storage: int8 values (in, out), f32 scales
            leaf = {"w_q4": sd[f"{key}.w_q4"], "w_scale": sd[f"{key}.w_scale"],
                    "b": sd[f"{key}.bias"]}
        else:
            w = sd[f"{key}.weight"]
            if kind == "qkv":
                w = _qkv_heads_to_thirds(w, heads[0])
            leaf = {"w": w.transpose(2, 3, 1, 0) if kind == "conv" else w.T}
            if f"{key}.bias" in sd:
                b = sd[f"{key}.bias"]
                leaf["b"] = _qkv_heads_to_thirds(b, heads[0]) if kind == "qkv" else b
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    tree = listify(tree)
    if config.encoder != "tiny_vit":
        peft = _peft_tree_from_state(sd)
        blocks = peft.pop("blocks", {})
        _merge(tree["image_encoder"], peft)
        for i, sub in blocks.items():
            _merge(tree["image_encoder"]["blocks"][i], sub)
    return tree


def _unflatten(data) -> dict:
    """A flat npz whose keys are '/'-joined parameter-tree paths
    (``a/b/0/c``) -> the nested tree, lists where the keys are indices.
    Keys starting with ``__`` (metadata) are left out."""
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

    return listify(tree)


def load_native_checkpoint(path: str, model_type: Optional[str] = None,
                           config: Optional[SamConfig] = None
                           ) -> Tuple[SamConfig, Dict[str, torch.Tensor]]:
    """The JAX package's native ``.npz`` / ``.msam`` checkpoint (flat npz whose
    keys are '/'-joined parameter-tree paths) -> (config, state dict). The
    config is the named model type's unless one is given."""
    data = np.load(path, allow_pickle=False)
    if config is None:
        config = get_config(model_type or str(data["__model_type__"]))
    return config, params_from_jax(_unflatten(data), config)


def params_from_flat_npz(path: str, compute_dtype: str = "float32"
                         ) -> Tuple[SamConfig, Dict[str, torch.Tensor]]:
    """A flat npz of a parameter tree with its config as JSON under
    ``__config__`` (the layout of the trained AMG fixture,
    ``tests/fixtures/bench_sam_tiny1024.npz``: model_type, embed_dim, depth,
    num_heads, global_attn_indexes, img_size, window_size) -> (config, the
    port's state dict, float32)."""
    import json
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__config__"]))
    config = SamConfig(model_type=meta["model_type"], embed_dim=meta["embed_dim"],
                       depth=meta["depth"], num_heads=meta["num_heads"],
                       global_attn_indexes=tuple(meta["global_attn_indexes"]),
                       img_size=meta["img_size"], window_size=meta["window_size"],
                       compute_dtype=compute_dtype)
    return config, params_from_jax(_unflatten(data), config)


# ---------------------------------------------------------------------------
# the UNETR decoder (AIS): the JAX package's pytree <-> torch_em's keys
# ---------------------------------------------------------------------------

def _unetr_layers(params_or_state, from_jax: bool):
    """(JAX path, torch_em prefix, kind) of every leaf module of the decoder;
    kind: conv / conv_t / bn / norm. Upsamplers are told apart by structure
    (a ``conv`` child in the pytree, a ``.conv.`` key in the state dict)."""
    def has_conv_child(path, prefix):
        if from_jax:
            node = params_or_state
            for part in path:
                node = node[part]
            return "conv" in node
        return f"{prefix}conv.weight" in params_or_state

    def upsampler(path, prefix):
        if has_conv_child(path, prefix):
            return [(path + ("conv",), f"{prefix}conv.", "conv")]
        return [(path, f"{prefix}block.", "conv_t")]

    def conv_block(path, prefix):
        return [(path + ("norm1",), f"{prefix}block.0.", "norm"),
                (path + ("conv1",), f"{prefix}block.1.", "conv"),
                (path + ("norm2",), f"{prefix}block.3.", "norm"),
                (path + ("conv2",), f"{prefix}block.4.", "conv")]

    layers = []
    for i in (1, 2, 3, 4):
        d, p = (f"deconv{i}",), f"deconv{i}.block."
        layers += upsampler(d + ("up",), f"{p}0.")
        layers += [(d + ("conv",), f"{p}1.block.", "conv"), (d + ("bn",), f"{p}2.", "bn")]
    layers += conv_block(("base",), "base.")
    for i in range(3):
        layers += upsampler(("decoder", "samplers", i), f"decoder.samplers.{i}.")
        layers += conv_block(("decoder", "blocks", i), f"decoder.blocks.{i}.")
    layers += upsampler(("deconv_out",), "deconv_out.")
    layers += conv_block(("decoder_head",), "decoder_head.")
    layers.append((("out_conv",), "out_conv.", "conv"))
    return layers


def unetr_params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's UNETR pytree (numpy leaves; ``micro_sam_tpu/models/unetr.py``)
    -> the port's decoder state dict, torch_em's keys. A conv is HWIO ->
    OIHW, a conv-transpose (kh, kw, O, I) -> (I, O, kh, kw) (both the same
    transpose), BN scale / bias / mean / var -> weight / bias / running_mean /
    running_var; norm scale / bias (present only when affine) -> weight / bias."""
    sd: Dict[str, np.ndarray] = {}
    for path, prefix, kind in _unetr_layers(params, from_jax=True):
        node = params
        for part in path[:-1]:
            node = node[part]
        if kind == "norm" and path[-1] not in node:  # an affine-free norm
            continue
        node = node[path[-1]]
        if kind == "bn":
            for port, jax_name in _BN:
                sd[prefix + port] = np.asarray(node[jax_name])
        elif kind == "norm":
            sd[prefix + "weight"] = np.asarray(node["scale"])
            sd[prefix + "bias"] = np.asarray(node["bias"])
        else:
            sd[prefix + "weight"] = np.asarray(node["w"]).transpose(3, 2, 0, 1)
            if "b" in node:
                sd[prefix + "bias"] = np.asarray(node["b"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def unetr_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's decoder state dict -> the JAX package's UNETR pytree
    (float32 numpy leaves): the inverse of ``unetr_params_from_jax``."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    tree: dict = {}
    for path, prefix, kind in _unetr_layers(sd, from_jax=False):
        if kind == "bn":
            leaf = {jax_name: sd[prefix + port] for port, jax_name in _BN}
        elif kind == "norm":
            if prefix + "weight" not in sd:
                continue
            leaf = {"scale": sd[prefix + "weight"], "bias": sd[prefix + "bias"]}
        else:
            leaf = {"w": sd[prefix + "weight"].transpose(2, 3, 1, 0)}
            if prefix + "bias" in sd:
                leaf["b"] = sd[prefix + "bias"]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    dec = tree["decoder"]
    for name in ("samplers", "blocks"):
        dec[name] = [dec[name][i] for i in range(len(dec[name]))]
    return tree
