"""Model loading, image normalization and the embedding precompute / cache.

Counterpart of ``micro_sam_tpu/util.py`` for the untiled 2d and 3d paths. The
cache is a zarr store (``utils/zarr_lite``) with the same layout and signature
attributes as the JAX package's, so a cache written by either package loads
in the other.
"""
from __future__ import annotations

import hashlib
import os
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import __version__
from .models.build_sam import build_sam, default_compute_dtype, get_config, resolve_device
from .models.convert import load_native_checkpoint, load_torch_checkpoint
from .models.sam import Sam
from .predictor import SamPredictor
from .utils import zarr_lite
from .utils.transforms import get_preprocess_shape

ImageEmbeddings = Dict[str, Any]

_DEFAULT_MODEL = "vit_b_lm"


# -----------------------------------------------------------------------------
# Model loading
# -----------------------------------------------------------------------------

def _compute_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def get_sam_model(model_type: str = _DEFAULT_MODEL, device: Optional[str] = None,
                  checkpoint_path: Optional[str] = None, return_sam: bool = False,
                  return_state: bool = False, compute_dtype: Optional[str] = None,
                  seed: int = 0) -> Union[SamPredictor, Tuple]:
    """Build a SamPredictor.

    ``device=None`` means the GPU (``"cuda"``); without one this raises. Weights
    come from ``checkpoint_path`` (a zoo ``.pt`` / ``.pth``, or the JAX
    package's ``.npz`` / ``.msam``), else are drawn at random from ``seed``.
    ``compute_dtype=None`` is bfloat16 on the GPU and float32 on the CPU."""
    dev = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = default_compute_dtype(dev)
    state: Dict[str, Any] = {}
    decoder_state = None
    model_hash = None
    if checkpoint_path is not None:
        path = str(checkpoint_path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint {path} does not exist.")
        if path.endswith((".npz", ".msam")):
            cfg, sd = load_native_checkpoint(path, model_type)
        else:
            cfg, sd, decoder_state = load_torch_checkpoint(path, model_type)
        from dataclasses import replace
        sam = Sam(replace(cfg, compute_dtype=compute_dtype))
        sam.load_state_dict(sd)
        sam = sam.to(dev).eval()
        state["checkpoint_path"] = path
        model_hash = f"sha256:{_compute_hash(path)}"
    else:
        get_config(model_type)  # validates the name
        sam = build_sam(model_type, seed=seed, compute_dtype=compute_dtype, device=dev)
    predictor = SamPredictor(sam)
    predictor.model_type = model_type
    predictor.model_name = model_type
    predictor._hash = model_hash  # rides the embedding-cache signature
    state["model_state"] = sam.state_dict()
    if decoder_state is not None:
        state["decoder_state"] = decoder_state
    if return_sam and return_state:
        return predictor, sam, state
    if return_sam:
        return predictor, sam
    if return_state:
        return predictor, state
    return predictor


# -----------------------------------------------------------------------------
# Image normalization
# -----------------------------------------------------------------------------

def _to_image(input_: np.ndarray) -> np.ndarray:
    """Normalize to (H, W, 3) uint8: channels to 3, then per-channel min-max to
    [0, 255] for every dtype (float32 math, truncating cast)."""
    input_ = np.asarray(input_)
    if input_.ndim == 2:
        input_ = input_[..., None]
    if input_.ndim != 3:
        raise ValueError(f"Invalid image dimensions {input_.shape}")
    if input_.shape[-1] > 3:
        input_ = input_[..., :3]
    if input_.shape[-1] == 1:
        input_ = np.repeat(input_, 3, axis=-1)
    elif input_.shape[-1] == 2:
        input_ = np.concatenate(
            [input_, np.zeros(input_.shape[:2] + (1,), dtype=input_.dtype)], axis=-1)
    x = input_.astype(np.float32)
    x -= x.min(axis=(0, 1))[None, None]
    x /= x.max(axis=(0, 1))[None, None] + 1e-7
    return np.array((x * 255).astype(np.uint8))


# -----------------------------------------------------------------------------
# Embedding precompute & cache
# -----------------------------------------------------------------------------

def _compute_data_signature(input_: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(input_).tobytes()).hexdigest()


def _embedding_signature(predictor: SamPredictor, input_: np.ndarray) -> Dict[str, Any]:
    return {
        "data_signature": _compute_data_signature(input_),
        "model_type": predictor.model_type,
        "model_name": predictor.model_name or predictor.model_type,
        "micro_sam_version": __version__,
        "model_hash": predictor._hash,
        "backend": "torch",
    }


def _check_saved_embeddings(f, signature: Dict[str, Any]) -> bool:
    """True if the cache holds matching, complete embeddings. A cache is
    complete once ``input_size`` (or this package's ``done``) is in its attrs."""
    if "features" not in f:
        return False
    if not (f.attrs.get("done", False) or "input_size" in f.attrs):
        return False
    hard_keys = ("data_signature", "tile_shape", "halo")
    soft_keys = ("model_type", "model_name", "micro_sam_version", "model_hash")
    for key, val in signature.items():
        saved = f.attrs.get(key)
        if saved is None or val is None:
            continue
        if key in hard_keys and saved != val:
            raise RuntimeError(f"Embedding cache mismatch for '{key}': got {saved}, expected {val}.")
        if key in soft_keys and saved != val:
            warnings.warn(f"Embedding cache '{key}' mismatch: {saved} (saved) vs {val} (current).")
    return True


def handle_pbar(verbose: bool, pbar_init=None, pbar_update=None):
    """Returns (pbar_init, pbar_update, pbar_close); verbose progress is a plain print."""
    if pbar_init is not None and pbar_update is not None:
        return pbar_init, pbar_update, (lambda: None)
    if verbose:
        state = {"done": 0, "total": 0, "desc": ""}

        def init(total, description):
            state.update(total=total, desc=description, done=0)

        def update(n=1):
            state["done"] += n
            print(f"{state['desc']}: {state['done']}/{state['total']}", flush=True)
        return init, update, (lambda: None)
    return (lambda total, desc: None), (lambda n=1: None), (lambda: None)


def _features_to_cache_layout(feats: torch.Tensor) -> np.ndarray:
    """(B, 64, 64, 256) NHWC -> (B, 256, 64, 64) float32 numpy (cache layout)."""
    return feats.permute(0, 3, 1, 2).float().cpu().numpy()


def _resize_for_encoder(predictor: SamPredictor, image: np.ndarray) -> np.ndarray:
    return predictor.transform.apply_image(_to_image(image))


def precompute_image_embeddings(
    predictor: SamPredictor, input_: np.ndarray, save_path: Optional[str] = None,
    lazy_loading: bool = False, ndim: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None, halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True, batch_size: int = 1, pbar_init=None, pbar_update=None,
) -> ImageEmbeddings:
    """Compute (or load cached) image embeddings of a 2d image or a 3d volume.

    Embeddings are cached at ``save_path`` with the signature attributes of the
    JAX package (data signature, model type and name, version, model hash).
    Tiled precompute is not ported yet."""
    if tile_shape is not None:
        raise NotImplementedError("tiled precompute is not ported yet")
    ndim = input_.ndim if ndim is None else ndim
    zarr_format = int(os.environ.get("MICROSAM_ZARR_FORMAT", "2"))
    if save_path is None:
        f = zarr_lite.open(zarr_lite.MemoryStore(), zarr_format=zarr_format)
    else:
        f = zarr_lite.open(str(save_path), mode="a", zarr_format=zarr_format)

    signature = _embedding_signature(predictor, input_)
    if _check_saved_embeddings(f, signature):
        return _load_cached_embeddings(f, lazy_loading)

    pbar_init, pbar_update, pbar_close = handle_pbar(verbose, pbar_init, pbar_update)
    if ndim == 2:
        embeddings = _compute_2d(predictor, input_, f, pbar_init, pbar_update)
    elif ndim == 3:
        embeddings = _compute_3d(predictor, input_, f, batch_size, pbar_init, pbar_update)
    else:
        raise ValueError(f"Invalid dimensionality {ndim}; expected 2 or 3.")
    f.attrs.update(signature)
    f.attrs["input_size"] = list(embeddings["input_size"])
    f.attrs["original_size"] = list(embeddings["original_size"])
    f.attrs["done"] = True
    pbar_close()
    if lazy_loading and save_path is not None:
        return _load_cached_embeddings(f, lazy_loading)
    return embeddings


def _compute_2d(predictor, input_, f, pbar_init, pbar_update) -> ImageEmbeddings:
    pbar_init(1, "compute image embeddings")
    resized = _resize_for_encoder(predictor, input_)
    features = _features_to_cache_layout(predictor.encode_batch(resized[None]))
    f.create_dataset("features", data=features, chunks=features.shape, overwrite=True)
    pbar_update(1)
    return {"features": features, "input_size": tuple(resized.shape[:2]),
            "original_size": tuple(input_.shape[:2])}


def _compute_3d(predictor, input_, f, batch_size, pbar_init, pbar_update) -> ImageEmbeddings:
    cfg = predictor.model.config
    n_slices = input_.shape[0]
    C, E = cfg.prompt_embed_dim, cfg.embedding_size
    pbar_init(n_slices, "compute image embeddings for the volume")
    original_size = tuple(input_.shape[1:3])
    input_size = get_preprocess_shape(original_size[0], original_size[1], cfg.img_size)
    ds = f.require_dataset("features", shape=(n_slices, 1, C, E, E), chunks=(1, 1, C, E, E),
                           dtype="float32")
    out = np.zeros((n_slices, 1, C, E, E), dtype=np.float32)
    done = set(f.attrs.get("slices_done", []))  # resume: skip slices already written
    pending = []

    def flush():
        if not pending:
            return
        feats = _features_to_cache_layout(
            predictor.encode_batch(np.stack([b for _, b in pending])))
        for j, (z, _) in enumerate(pending):
            out[z, 0] = feats[j]
            ds[z, 0] = feats[j]
            pbar_update(1)
        pending.clear()

    for z in range(n_slices):
        if z in done:
            out[z] = ds[z]
            pbar_update(1)
            continue
        pending.append((z, _resize_for_encoder(predictor, input_[z])))
        if len(pending) == batch_size:
            flush()
    flush()
    f.attrs["slices_done"] = list(range(n_slices))
    return {"features": out, "input_size": input_size, "original_size": original_size}


def _load_cached_embeddings(f, lazy_loading: bool) -> ImageEmbeddings:
    features = f["features"]
    if not hasattr(features, "shape"):
        raise NotImplementedError("tiled embedding caches are not ported yet")
    input_size = f.attrs.get("input_size")
    original_size = f.attrs.get("original_size")
    return {
        "features": features if lazy_loading else features[...],
        "input_size": tuple(input_size) if input_size else None,
        "original_size": tuple(original_size) if original_size else None,
    }


def set_precomputed(predictor: SamPredictor, image_embeddings: ImageEmbeddings,
                    i: Optional[int] = None) -> SamPredictor:
    """Install precomputed embeddings (slice ``i`` of a volume) on the predictor."""
    features = image_embeddings["features"]
    if isinstance(features, dict) or not hasattr(features, "ndim"):
        raise NotImplementedError("tiled embeddings are not ported yet")
    if i is not None:
        features = features[i]
    predictor.set_features(np.asarray(features), image_embeddings["original_size"],
                           image_embeddings["input_size"])
    return predictor
