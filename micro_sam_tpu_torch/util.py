"""Model loading, image normalization and the embedding precompute / cache.

Counterpart of ``micro_sam_tpu/util.py`` for the 2d and 3d paths, untiled and
tiled. The cache is a zarr store (``utils/zarr_lite``) with the same layout
and signature attributes as the JAX package's, so a cache written by either
package loads in the other.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import warnings
from concurrent import futures
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import __version__
from .models.build_sam import default_compute_dtype, get_config, make_sam, resolve_device
from .models.convert import (load_native_checkpoint, load_torch_checkpoint, params_from_jax,
                             params_to_jax)
from .models.sam import SamConfig
from .predictor import SamPredictor
from .utils import zarr_lite
from .utils.blocking import Blocking
from .utils.transforms import get_preprocess_shape

ImageEmbeddings = Dict[str, Any]

_DEFAULT_MODEL = "vit_b_lm"


# -----------------------------------------------------------------------------
# Cache directory & registry
# -----------------------------------------------------------------------------

def microsam_cachedir() -> str:
    """Cache dir; override with MICROSAM_CACHEDIR (reference util.py:62-86)."""
    cache_dir = os.environ.get("MICROSAM_CACHEDIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "micro_sam_tpu"
    )
    return cache_dir


def get_cache_directory() -> str:
    """The micro-sam cache directory (reference util.py:62); honors the
    MICROSAM_CACHEDIR environment variable."""
    return microsam_cachedir()


# Known xxh128 content hashes of the zoo checkpoints (same artifacts the
# reference distributes; values from micro_sam/util.py:102-141). Used to
# validate locally cached model files before loading.
_MODEL_HASHES: Dict[str, str] = {
    "vit_l": "xxh128:a82beb3c660661e3dd38d999cc860e9a",
    "vit_h": "xxh128:97698fac30bd929c2e6d8d8cc15933c2",
    "vit_b": "xxh128:6923c33df3637b6a922d7682bfc9a86b",
    "vit_t": "xxh128:8eadbc88aeb9d8c7e0b4b60c3db48bd0",
    "vit_l_lm": "xxh128:017f20677997d628426dec80a8018f9d",
    "vit_b_lm": "xxh128:fe9252a29f3f4ea53c15a06de471e186",
    "vit_t_lm": "xxh128:72ec5074774761a6e5c05a08942f981e",
    "vit_l_em_organelles": "xxh128:810b084b6e51acdbf760a993d8619f2d",
    "vit_b_em_organelles": "xxh128:f3bf2ed83d691456bae2c3f9a05fb438",
    "vit_t_em_organelles": "xxh128:253474720c497cce605e57c9b1d18fd9",
    "vit_b_histopathology": "xxh128:ffd1a2cd84570458b257bd95fdd8f974",
    "vit_l_histopathology": "xxh128:b591833c89754271023e901281dee3f2",
    "vit_h_histopathology": "xxh128:bd1856dafc156a43fb3aa705f1a6e92e",
    "vit_b_medical_imaging": "xxh128:40169f1e3c03a4b67bff58249c176d92",
    "vit_l_lm_decoder": "xxh128:2faeafa03819dfe03e7c46a44aaac64a",
    "vit_b_lm_decoder": "xxh128:708b15ac620e235f90bb38612c4929ba",
    "vit_t_lm_decoder": "xxh128:3e914a5f397b0312cdd36813031f8823",
    "vit_l_em_organelles_decoder": "xxh128:334877640bfdaaabce533e3252a17294",
    "vit_b_em_organelles_decoder": "xxh128:bb6398956a6b0132c26b631c14f95ce2",
    "vit_t_em_organelles_decoder": "xxh128:8f897c7bb93174a4d1638827c4dd6f44",
    "vit_b_histopathology_decoder": "xxh128:6a66194dcb6e36199cbee2214ecf7213",
    "vit_l_histopathology_decoder": "xxh128:46aab7765d4400e039772d5a50b55c04",
    "vit_h_histopathology_decoder": "xxh128:3ed9f87e46ad5e16935bd8d722c8dc47",
    "vit_b_medical_imaging_decoder": "xxh128:9e498b12f526f119b96c88be76e3b2ed",
}

_SAM_BASE = "https://dl.fbaipublicfiles.com/segment_anything/"
_BIOIMAGEIO = "https://uk1s3.embassy.ebi.ac.uk/public-datasets/bioimage.io/"
_MODEL_URLS: Dict[str, str] = {
    "vit_h": _SAM_BASE + "sam_vit_h_4b8939.pth",
    "vit_l": _SAM_BASE + "sam_vit_l_0b3195.pth",
    "vit_b": _SAM_BASE + "sam_vit_b_01ec64.pth",
    "vit_t": "https://owncloud.gwdg.de/index.php/s/TuDzuwVDHd1ZDnQ/download",
    "vit_l_lm": _BIOIMAGEIO + "idealistic-rat/1.2/files/vit_l.pt",
    "vit_b_lm": _BIOIMAGEIO + "diplomatic-bug/1.2/files/vit_b.pt",
    "vit_t_lm": _BIOIMAGEIO + "faithful-chicken/1.1/files/vit_t.pt",
    "vit_l_em_organelles": _BIOIMAGEIO + "humorous-crab/1.2/files/vit_l.pt",
    "vit_b_em_organelles": _BIOIMAGEIO + "noisy-ox/1.2/files/vit_b.pt",
    "vit_t_em_organelles": _BIOIMAGEIO + "greedy-whale/1/files/vit_t.pt",
    "vit_l_lm_decoder": _BIOIMAGEIO + "idealistic-rat/1.2/files/vit_l_decoder.pt",
    "vit_b_lm_decoder": _BIOIMAGEIO + "diplomatic-bug/1.2/files/vit_b_decoder.pt",
    "vit_t_lm_decoder": _BIOIMAGEIO + "faithful-chicken/1.1/files/vit_t_decoder.pt",
    "vit_l_em_organelles_decoder": _BIOIMAGEIO + "humorous-crab/1.2/files/vit_l_decoder.pt",
    "vit_b_em_organelles_decoder": _BIOIMAGEIO + "noisy-ox/1.2/files/vit_b_decoder.pt",
    "vit_t_em_organelles_decoder": _BIOIMAGEIO + "greedy-whale/1/files/vit_t_decoder.pt",
}


def models() -> Dict[str, Dict[str, Optional[str]]]:
    """Model registry: the reference zoo names (micro_sam/util.py:89-181),
    each entry carrying the download url (unusable offline) and the known
    xxh128 hash for local-file validation.

    Checkpoints are torch ``.pt`` files converted on load (models/convert.py).
    """
    registry: Dict[str, Dict[str, Optional[str]]] = {}
    for name in _MODEL_HASHES:
        registry[name] = {
            "url": _MODEL_URLS.get(name), "hash": _MODEL_HASHES[name],
        }
    return registry


def _resolve_cached_model(model_type: str) -> Optional[str]:
    """Locate a pre-seeded zoo checkpoint under <cachedir>/models/<name> and
    validate its content hash (reference downloads via pooch, which validates
    the same xxh128 registry at fetch time)."""
    path = os.path.join(microsam_cachedir(), "models", model_type)
    if not os.path.exists(path):
        return None
    expected = _MODEL_HASHES.get(model_type)
    if expected is not None:
        got = f"xxh128:{_xxh128(path)}"
        if got != expected:
            raise RuntimeError(
                f"Cached model file {path} is corrupt: hash {got} does not "
                f"match the registry entry {expected}. Delete the file and "
                "re-seed the cache."
            )
    return path


def get_model_names() -> List[str]:
    """The registry's model names, in its order."""
    return list(models().keys())


# -----------------------------------------------------------------------------
# Devices
# -----------------------------------------------------------------------------

def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The torch device to run on: the GPU for None or "auto" (raising
    without one), else the device named, "cpu" on request."""
    return resolve_device(None if device == "auto" else device)


def _available_devices() -> List[str]:
    """The device choices of the annotator widgets: "cuda" where a GPU is
    present, and "cpu"."""
    return (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]


# -----------------------------------------------------------------------------
# Model loading
# -----------------------------------------------------------------------------

def _xxh128(path: str) -> str:
    """The xxh128 hex digest of a file, as the registry states it. ``xxhash``
    is imported here: without it a cached zoo file cannot be checked, and is
    not loaded."""
    try:
        import xxhash
    except ImportError as e:
        raise RuntimeError(
            f"The cached model file {path} is checked against the registry's xxh128 hash "
            "before it loads, which needs the package 'xxhash'. Install it, or pass the "
            "file as checkpoint_path.") from e
    h = xxhash.xxh128()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _compute_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _try_load_native_pickle(path: str) -> Optional[Dict[str, Any]]:
    """A trainer checkpoint (a plain pickle holding the JAX-layout parameter
    tree under ``model_state``, as ``SamTrainer`` of either package writes it),
    or None for a torch checkpoint (zip ``PK`` magic) or anything else. Like
    any checkpoint, load only files you trust: unpickling runs code."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":  # torch.save zip container
            return None
        f.seek(0)
        try:
            state = pickle.load(f)
        except (pickle.UnpicklingError, EOFError, AttributeError, ImportError, IndexError):
            return None
    if (isinstance(state, dict) and isinstance(state.get("model_state"), dict)
            and "image_encoder" in state["model_state"]):
        return state
    return None


def load_sam(model_type: str = _DEFAULT_MODEL, device: Optional[str] = None,
             checkpoint_path: Optional[str] = None, compute_dtype: Optional[str] = None,
             seed: int = 0, weight_dtype: Optional[torch.dtype] = None,
             peft_kwargs: Optional[Dict[str, Any]] = None):
    """(Sam on the device in eval mode, state, model hash) for ``get_sam_model``
    and the trainer. Weights come from ``checkpoint_path`` (a zoo ``.pt`` /
    ``.pth``, the JAX package's ``.npz`` / ``.msam``, or a trainer's ``.pkl``),
    else are drawn at random from ``seed``. ``weight_dtype`` as in ``Sam``.
    ``peft_kwargs`` applies a PEFT surgery (``models/peft_sam.apply_peft``)
    before the checkpoint loads. Every case is built by ``make_sam``.

    Without ``checkpoint_path`` the zoo cache is looked up first, as in the
    JAX package: ``<cachedir>/models/<model_type>`` loads once its xxh128
    hash matches the registry's, and the model hash is then the registry's
    ``xxh128:...`` string (the JAX package's cache signature)."""
    dev = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = default_compute_dtype(dev)
    state: Dict[str, Any] = {}
    model_hash = None
    if checkpoint_path is None:
        checkpoint_path = _resolve_cached_model(model_type)
        model_hash = None if checkpoint_path is None else _MODEL_HASHES.get(model_type)
    if checkpoint_path is None:
        cfg = get_config(model_type, compute_dtype)  # validates the name
        return make_sam(cfg, None, seed, weight_dtype, peft_kwargs).to(dev).eval(), state, None
    path = str(checkpoint_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint {path} does not exist.")
    if path.endswith((".npz", ".msam")):
        cfg, sd = load_native_checkpoint(path, model_type)
    elif (native := _try_load_native_pickle(path)) is not None:
        if "model_config" in native:
            mc = dict(native["model_config"])
            mc["global_attn_indexes"] = tuple(mc["global_attn_indexes"])
            cfg = SamConfig(**mc)
        else:
            cfg = get_config(native.get("model_type") or model_type)
        sd = params_from_jax(native["model_state"], cfg)
        if native.get("decoder_state") is not None:
            state["decoder_state"] = native["decoder_state"]
    else:
        cfg, sd, decoder_state = load_torch_checkpoint(path, model_type)
        if decoder_state is not None:
            state["decoder_state"] = decoder_state
    sam = make_sam(replace(cfg, compute_dtype=compute_dtype), sd, seed, weight_dtype, peft_kwargs)
    state["checkpoint_path"] = path
    return sam.to(dev).eval(), state, model_hash or f"sha256:{_compute_hash(path)}"


def get_sam_model(model_type: str = _DEFAULT_MODEL, device: Optional[str] = None,
                  checkpoint_path: Optional[str] = None, return_sam: bool = False,
                  return_state: bool = False, compute_dtype: Optional[str] = None,
                  seed: int = 0, peft_kwargs: Optional[Dict[str, Any]] = None,
                  decoder_path: Optional[str] = None, mesh=None) -> Union[SamPredictor, Tuple]:
    """Build a SamPredictor.

    ``device=None`` means the GPU (``"cuda"``); without one this raises. Weights
    come from ``checkpoint_path`` (a zoo ``.pt`` / ``.pth``, the JAX
    package's ``.npz`` / ``.msam``, or a trainer checkpoint ``.pkl`` of either
    package), else are drawn at random from ``seed``. ``compute_dtype=None`` is
    bfloat16 on the GPU and float32 on the CPU. ``peft_kwargs`` (e.g.
    ``{"rank": 4}``, ``{"peft_module": "fact"}``, ``{"rank": 4, "quantize":
    True}``) applies that PEFT surgery and then loads the checkpoint, its
    PEFT parameters included where it has them. ``decoder_path``: a separate
    decoder checkpoint (a torch_em UNETR state, or a training checkpoint
    holding one under ``model_state``), returned as the state's
    ``decoder_state``. ``mesh`` (``parallel.mesh.make_mesh``): the predictor
    runs on this rank's share of the mesh (``SamPredictor.shard_on_mesh``),
    on the mesh's device unless ``device`` names it; the returned state then
    holds this rank's shards."""
    if mesh is not None and device is None:
        device = mesh.device
    sam, state, model_hash = load_sam(model_type, device, checkpoint_path, compute_dtype, seed,
                                      peft_kwargs=peft_kwargs)
    if decoder_path is not None:
        loaded = torch.load(str(decoder_path), map_location="cpu", weights_only=False)
        if isinstance(loaded, dict) and "model_state" in loaded:
            loaded = loaded["model_state"]
        state["decoder_state"] = loaded
    predictor = SamPredictor(sam, mesh=mesh)
    predictor.model_type = model_type
    predictor.model_name = model_type
    predictor._hash = model_hash  # rides the embedding-cache signature
    state["model_state"] = sam.state_dict()
    if return_sam and return_state:
        return predictor, sam, state
    if return_sam:
        return predictor, sam
    if return_state:
        return predictor, state
    return predictor


def save_native_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], config: SamConfig
                           ) -> None:
    """Write a SAM's weights as the JAX package's native checkpoint: a flat
    compressed npz whose keys are the '/'-joined paths of its parameter tree
    (``params_to_jax``), the model type under ``__model_type__``. The file is
    written at exactly ``path`` (no ``.npz`` is appended)."""
    flat: Dict[str, np.ndarray] = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                if not k.startswith("_"):
                    rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", params_to_jax(state_dict, config))
    with open(path, "wb") as f:
        np.savez_compressed(f, __model_type__=np.array(config.model_type), **flat)


def export_custom_sam_model(checkpoint_path: str, model_type: str, save_path: str,
                            with_segmentation_decoder: bool = False, prefix: str = "sam.") -> None:
    """A checkpoint -> a plain segment_anything-layout SAM state dict of
    float32 tensors, written with ``torch.save`` (the keys and values the JAX
    package's export writes). As in the JAX package, the decoder is not
    exported whatever ``with_segmentation_decoder`` says, and ``prefix`` is
    only warned about. A conversion of the weights on the host."""
    if prefix != "sam.":
        warnings.warn(f"Non-default prefix {prefix!r} is ignored: checkpoint key prefixes are "
                      "normalized automatically on load.")
    sam, _, _ = load_sam(model_type, "cpu", checkpoint_path, "float32", weight_dtype=torch.float32)
    torch.save({k: v.detach().float().contiguous() for k, v in sam.state_dict().items()},
               save_path)


def export_custom_qlora_model(checkpoint_path: Optional[str], finetuned_path: str,
                              model_type: str, save_path: str) -> None:
    """A QLoRA-finetuned trainer checkpoint -> a LoRA checkpoint for
    ``get_sam_model(peft_kwargs=...)``: every int4 base weight (``w_q4`` /
    ``w_scale``, the port's int8 values or the JAX package's int4) dequantized
    to a dense float32 ``w``, every floating leaf float32, the LoRA
    parameters kept; written as the JAX package's pickle
    (``model_state``, ``model_type``, ``peft_module``). The JAX package's
    export keeps the int4 storage, which its docstring says it removes.
    ``checkpoint_path`` (the base model) is accepted for the reference's
    signature: the finetuned checkpoint holds every weight. A host-side file
    conversion: a trusted pickle in, a pickle out."""
    with open(finetuned_path, "rb") as f:
        state = pickle.load(f)
    params = state["model_state"] if "model_state" in state else state

    def dense(node):
        if isinstance(node, dict):
            out = {k: dense(v) for k, v in node.items() if k not in ("w_q4", "w_scale")}
            if "w_q4" in node:
                q = np.asarray(node["w_q4"]).astype(np.int8).astype(np.float32)
                s = np.asarray(node["w_scale"]).astype(np.float32)
                out["w"] = (q.reshape(s.shape[0], -1, q.shape[1]) * s[:, None, :]).reshape(q.shape)
            return out
        if isinstance(node, (list, tuple)):
            return [dense(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype.kind == "f" or str(arr.dtype) == "bfloat16":
            return arr.astype(np.float32)
        return arr

    out = {"model_state": dense(params), "model_type": model_type, "peft_module": "lora"}
    with open(save_path, "wb") as f:
        pickle.dump(out, f)


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


def _embedding_signature(predictor: SamPredictor, input_: np.ndarray,
                         tile_shape=None, halo=None) -> Dict[str, Any]:
    sig = {
        "data_signature": _compute_data_signature(input_),
        "model_type": predictor.model_type,
        "model_name": predictor.model_name or predictor.model_type,
        "micro_sam_version": __version__,
        "model_hash": predictor._hash,
        "backend": "torch",
    }
    if tile_shape is not None:
        sig["tile_shape"] = list(tile_shape)
        sig["halo"] = list(halo)
    return sig


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


def get_block_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Default tile shape: up to 2048 a side (per slice for 3d)."""
    if len(shape) == 2:
        return tuple(min(s, 2048) for s in shape)
    return (1,) + tuple(min(s, 2048) for s in shape[1:])


def _tile_grid(shape_2d, tile_shape) -> Blocking:
    return Blocking((0, 0), tuple(shape_2d), tuple(tile_shape))


class _EmbeddingWriter:
    """Writes tiles to the cache on a thread pool while the card encodes."""

    def __init__(self):
        self._pool = futures.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
        self._futures: List[futures.Future] = []

    def submit(self, fn, *args):
        self._futures.append(self._pool.submit(fn, *args))

    def finish(self):
        try:
            for f in self._futures:
                f.result()
        finally:
            self._pool.shutdown()


def precompute_image_embeddings(
    predictor: SamPredictor, input_: np.ndarray, save_path: Optional[str] = None,
    lazy_loading: bool = False, ndim: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None, halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True, batch_size: int = 1, pbar_init=None, pbar_update=None,
    mask: Optional[np.ndarray] = None, tile_subset: Optional[Sequence[int]] = None,
    finalize: bool = True,
) -> ImageEmbeddings:
    """Compute (or load cached) image embeddings of a 2d image or a 3d volume,
    whole or in tiles.

    Dispatch by (ndim, tile_shape): 2d, tiled 2d, 3d, tiled 3d. A tiled
    computation encodes each tile grown by ``halo`` (clipped to the image),
    resized to the model's input size; same-shape tiles (2d) or slices (3d)
    go through the encoder ``batch_size`` at a time. ``mask`` restricts it to
    the tiles the mask touches, ``tile_subset`` to the given tile ids; tiles
    already in the cache under the same signature are taken as they are
    (resume), and ``finalize=False`` leaves the cache unmarked as complete.
    Embeddings are cached at ``save_path`` with the signature attributes of
    the JAX package (data signature, model type and name, version, model
    hash; tile shape and halo for tiles)."""
    ndim = input_.ndim if ndim is None else ndim
    if tile_shape is not None and halo is None:
        halo = tuple(0 for _ in tile_shape)
    if tile_subset is not None and tile_shape is None:
        raise ValueError("tile_subset requires a tiled computation (tile_shape).")
    zarr_format = int(os.environ.get("MICROSAM_ZARR_FORMAT", "2"))
    # a meshed predictor in a world of several ranks: every rank encodes its
    # share of each batch, mesh rank 0 alone reads and writes save_path (the
    # others keep their copy in memory), and a partial cache is recomputed,
    # not resumed, so that every rank makes the same encode calls
    mesh = getattr(predictor, "mesh", None)
    shared = save_path is not None and mesh is not None and mesh.world is not None \
        and mesh.size > 1
    if save_path is None or (shared and mesh.rank != 0):
        f = zarr_lite.open(zarr_lite.MemoryStore(), zarr_format=zarr_format)
    else:
        f = zarr_lite.open(str(save_path), mode="a", zarr_format=zarr_format)

    signature = _embedding_signature(predictor, input_, tile_shape, halo)
    if _agreed_cache_check(f, signature, mesh if shared else None):
        if shared and mesh.rank != 0:
            f = zarr_lite.open(str(save_path), mode="r")
        return _load_cached_embeddings(f, tile_shape, lazy_loading)

    pbar_init, pbar_update, pbar_close = handle_pbar(verbose, pbar_init, pbar_update)
    tiled_args = (tile_shape, halo, batch_size, mask, pbar_init, pbar_update, tile_subset,
                  None if shared else signature)
    if ndim == 2 and tile_shape is None:
        embeddings = _compute_2d(predictor, input_, f, pbar_init, pbar_update)
    elif ndim == 2:
        embeddings = _compute_tiled_2d(predictor, input_, f, *tiled_args)
    elif ndim == 3 and tile_shape is None:
        embeddings = _compute_3d(predictor, input_, f, batch_size, pbar_init, pbar_update,
                                 resume=not shared)
    elif ndim == 3:
        embeddings = _compute_tiled_3d(predictor, input_, f, *tiled_args)
    else:
        raise ValueError(f"Invalid dimensionality {ndim}; expected 2 or 3.")
    if not finalize:
        pbar_close()
        if shared:
            mesh.barrier()
        return embeddings
    f.attrs.update(signature)
    f.attrs["input_size"] = (list(embeddings["input_size"]) if embeddings["input_size"]
                             else None)
    f.attrs["original_size"] = (list(embeddings["original_size"])
                                if embeddings["original_size"] else None)
    f.attrs["done"] = True
    pbar_close()
    if shared:
        mesh.barrier()  # save_path is complete when any rank returns
        if lazy_loading and mesh.rank != 0:
            f = zarr_lite.open(str(save_path), mode="r")
    if lazy_loading and save_path is not None:
        return _load_cached_embeddings(f, tile_shape, lazy_loading)
    return embeddings


def _agreed_cache_check(f, signature: Dict[str, Any], mesh) -> bool:
    """``_check_saved_embeddings``; on a ``mesh`` its rank 0 reads the cache and
    every rank takes its verdict, or raises its error."""
    if mesh is None:
        return _check_saved_embeddings(f, signature)
    verdict = None
    if mesh.rank == 0:
        try:
            verdict = _check_saved_embeddings(f, signature)
        except RuntimeError as e:
            verdict = e
    verdict = mesh.broadcast_object(verdict)
    if isinstance(verdict, Exception):
        raise verdict
    return verdict


def _compute_2d(predictor, input_, f, pbar_init, pbar_update) -> ImageEmbeddings:
    pbar_init(1, "compute image embeddings")
    resized = _resize_for_encoder(predictor, input_)
    features = _features_to_cache_layout(predictor.encode_batch(resized[None]))
    f.create_dataset("features", data=features, chunks=features.shape, overwrite=True)
    pbar_update(1)
    return {"features": features, "input_size": tuple(resized.shape[:2]),
            "original_size": tuple(input_.shape[:2])}


def _compute_3d(predictor, input_, f, batch_size, pbar_init, pbar_update,
                resume: bool = True) -> ImageEmbeddings:
    cfg = predictor.model.config
    n_slices = input_.shape[0]
    C, E = cfg.prompt_embed_dim, cfg.embedding_size
    pbar_init(n_slices, "compute image embeddings for the volume")
    original_size = tuple(input_.shape[1:3])
    input_size = get_preprocess_shape(original_size[0], original_size[1], cfg.img_size)
    ds = f.require_dataset("features", shape=(n_slices, 1, C, E, E), chunks=(1, 1, C, E, E),
                           dtype="float32")
    out = np.zeros((n_slices, 1, C, E, E), dtype=np.float32)
    done = set(f.attrs.get("slices_done", []) if resume else [])  # skip slices already written
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


def _get_tiles_in_mask(blocking: Blocking, mask: Optional[np.ndarray]) -> List[int]:
    if mask is None:
        return list(range(len(blocking)))
    mask = np.asarray(mask)
    return [t for t in range(len(blocking)) if mask[blocking.get_block(t).slicing].any()]


def _restrict_tiles(tile_ids: List[int], tile_subset) -> List[int]:
    if tile_subset is None:
        return tile_ids
    keep = {int(t) for t in tile_subset}
    return [t for t in tile_ids if t in keep]


def _update_group_attrs(group, meta: Dict[str, Any]) -> None:
    """Write group attrs only when they differ (several writers of one cache
    pass here with the same metadata)."""
    if any(group.attrs.get(k) != v for k, v in meta.items()):
        group.attrs.update(meta)


def _mark_partial_signature(features, signature) -> bool:
    """Record which computation the partial (not yet finalized) tiles of this
    cache belong to. True when the tiles already there carry the same
    signature and may be taken as they are (resume), False when they are
    leftovers of another computation and must be recomputed."""
    marker = dict(signature)
    if features.attrs.get("partial_signature") == marker:
        return True
    features.attrs["partial_signature"] = marker
    return False


def _load_existing_tile(features, tile_id: int):
    """A tile already written to the cache as an in-memory entry, or None."""
    key = str(tile_id)
    try:
        if key not in features:
            return None
        ds = features[key]
        return {"features": ds[...], "input_size": tuple(ds.attrs["input_size"]),
                "original_size": tuple(ds.attrs["original_size"])}
    except (KeyError, OSError, ValueError):
        return None


def _write_tile(features, tile_id, tf, chunks, in_size, orig_size) -> None:
    ds = features.create_dataset(str(tile_id), data=tf, chunks=chunks, overwrite=True)
    ds.attrs.update({"input_size": list(in_size), "original_size": list(orig_size)})


def _tiled_result(features, mem, tile_shape, halo, shape) -> ImageEmbeddings:
    return {"features": mem if mem else features, "input_size": None, "original_size": None,
            "tile_shape": tuple(tile_shape), "halo": tuple(halo), "shape": tuple(shape)}


def _compute_tiled_2d(predictor, input_, f, tile_shape, halo, batch_size, mask, pbar_init,
                      pbar_update, tile_subset=None, signature=None) -> ImageEmbeddings:
    shape_2d = input_.shape[:2]
    blocking = _tile_grid(shape_2d, tile_shape)
    tile_ids = _restrict_tiles(_get_tiles_in_mask(blocking, mask), tile_subset)
    pbar_init(len(tile_ids), "compute tiled image embeddings")
    features = f.require_group("features")
    _update_group_attrs(features, {"shape": list(shape_2d), "tile_shape": list(tile_shape),
                                   "halo": list(halo)})
    adopt = signature is not None and _mark_partial_signature(features, signature)
    writer = _EmbeddingWriter()
    mem: Dict[int, Dict[str, Any]] = {}
    pending: List[Tuple[int, np.ndarray, Tuple[int, int]]] = []

    def flush():
        if not pending:
            return
        feats = _features_to_cache_layout(
            predictor.encode_batch(np.stack([p[1] for p in pending])))
        for j, (tile_id, resized, orig_size) in enumerate(pending):
            tf = feats[j:j + 1]
            in_size = tuple(resized.shape[:2])
            mem[tile_id] = {"features": tf, "input_size": in_size, "original_size": orig_size}
            writer.submit(_write_tile, features, tile_id, tf, tf.shape, in_size, orig_size)
            pbar_update(1)
        pending.clear()

    try:
        for tile_id in tile_ids:
            existing = _load_existing_tile(features, tile_id) if adopt else None
            if existing is not None:
                mem[tile_id] = existing
                pbar_update(1)
                continue
            tile = blocking.get_block_with_halo(tile_id, halo).outer_block
            tile_input = input_[tile.slicing]
            resized = _resize_for_encoder(predictor, tile_input)
            if pending and pending[-1][1].shape != resized.shape:
                flush()  # a batch holds tiles of one shape (border tiles differ)
            pending.append((tile_id, resized, tuple(tile_input.shape[:2])))
            if len(pending) == batch_size:
                flush()
        flush()
    finally:
        writer.finish()
    return _tiled_result(features, mem, tile_shape, halo, shape_2d)


def _compute_tiled_3d(predictor, input_, f, tile_shape, halo, batch_size, mask, pbar_init,
                      pbar_update, tile_subset=None, signature=None) -> ImageEmbeddings:
    n_slices = input_.shape[0]
    cfg = predictor.model.config
    C, E = cfg.prompt_embed_dim, cfg.embedding_size
    blocking = _tile_grid(input_.shape[1:3], tile_shape)
    tile_ids = _restrict_tiles(
        _get_tiles_in_mask(blocking, None if mask is None else np.max(mask, axis=0)),
        tile_subset)
    pbar_init(len(tile_ids) * n_slices, "compute tiled embeddings for the volume")
    features = f.require_group("features")
    _update_group_attrs(features, {"shape": list(input_.shape[:3]),
                                   "tile_shape": list(tile_shape), "halo": list(halo)})
    adopt = signature is not None and _mark_partial_signature(features, signature)
    writer = _EmbeddingWriter()
    mem: Dict[int, Dict[str, Any]] = {}
    try:
        for tile_id in tile_ids:
            existing = _load_existing_tile(features, tile_id) if adopt else None
            if existing is not None:
                mem[tile_id] = existing
                pbar_update(n_slices)
                continue
            tile = blocking.get_block_with_halo(tile_id, halo).outer_block
            tile_feats = np.zeros((n_slices, 1, C, E, E), dtype=np.float32)
            orig_size = tuple(tile.shape)
            in_size = get_preprocess_shape(orig_size[0], orig_size[1], cfg.img_size)
            for z0 in range(0, n_slices, batch_size):
                zs = range(z0, min(z0 + batch_size, n_slices))
                batch = np.stack([_resize_for_encoder(predictor, input_[(z,) + tile.slicing])
                                  for z in zs])
                tile_feats[z0:z0 + len(zs), 0] = _features_to_cache_layout(
                    predictor.encode_batch(batch))
                pbar_update(len(zs))
            mem[tile_id] = {"features": tile_feats, "input_size": in_size,
                            "original_size": orig_size}
            writer.submit(_write_tile, features, tile_id, tile_feats, (1, 1, C, E, E), in_size,
                          orig_size)
    finally:
        writer.finish()
    return _tiled_result(features, mem, tile_shape, halo, input_.shape[:3])


def _load_cached_embeddings(f, tile_shape, lazy_loading: bool) -> ImageEmbeddings:
    features = f["features"]
    if tile_shape is not None or not hasattr(features, "shape"):
        # tiled: a group of per-tile datasets
        if hasattr(features, "shape"):
            raise RuntimeError("Cache does not contain tiled features.")
        tiles = features if lazy_loading else {
            int(k): {"features": features[k][...],
                     "input_size": tuple(features[k].attrs["input_size"]),
                     "original_size": tuple(features[k].attrs["original_size"])}
            for k in features.keys()}
        ga = features.attrs
        return {"features": tiles, "input_size": None, "original_size": None,
                "tile_shape": tuple(ga["tile_shape"]), "halo": tuple(ga["halo"]),
                "shape": tuple(ga["shape"])}
    input_size = f.attrs.get("input_size")
    original_size = f.attrs.get("original_size")
    return {
        "features": features if lazy_loading else features[...],
        "input_size": tuple(input_size) if input_size else None,
        "original_size": tuple(original_size) if original_size else None,
    }


def _get_tile_features(image_embeddings: ImageEmbeddings, tile_id: int) -> Dict[str, Any]:
    feats = image_embeddings["features"]
    if isinstance(feats, dict):
        return feats[int(tile_id)]
    ds = feats[str(tile_id)]  # a lazily loaded cache: the zarr group
    return {"features": ds[...], "input_size": tuple(ds.attrs["input_size"]),
            "original_size": tuple(ds.attrs["original_size"])}


def set_precomputed(predictor: SamPredictor, image_embeddings: ImageEmbeddings,
                    i: Optional[int] = None, tile_id: Optional[int] = None) -> SamPredictor:
    """Install precomputed embeddings (slice ``i`` of a volume; tile
    ``tile_id`` of tiled embeddings) on the predictor."""
    if tile_id is not None:
        tile = _get_tile_features(image_embeddings, tile_id)
        feats = tile["features"] if i is None else tile["features"][i]
        predictor.set_features(feats, tile["original_size"], tile["input_size"])
        return predictor
    features = image_embeddings["features"]
    if isinstance(features, dict) or not hasattr(features, "ndim"):
        raise ValueError("These are tiled embeddings: pass tile_id to select the tile.")
    if i is not None:
        features = features[i]
    predictor.set_features(np.asarray(features), image_embeddings["original_size"],
                           image_embeddings["input_size"])
    return predictor


# -----------------------------------------------------------------------------
# Object centers and boxes
# -----------------------------------------------------------------------------

def get_centers_and_bounding_boxes(segmentation: np.ndarray
                                   ) -> Tuple[Dict[int, Tuple], Dict[int, Tuple]]:
    """Center of mass and bounding box ((y0, y1), (x0, x1)) of every object of
    a 2d instance segmentation, keyed by id."""
    from scipy import ndimage
    if segmentation.ndim != 2:
        raise ValueError(f"expected a 2d segmentation, got shape {segmentation.shape}")
    ids = np.unique(segmentation)
    ids = ids[ids != 0]
    centers = ndimage.center_of_mass(np.ones_like(segmentation), segmentation, ids) \
        if len(ids) else []
    center_coordinates = {int(i): tuple(c) for i, c in zip(ids, centers)}
    bbox_coordinates = {}
    for i, sl in enumerate(ndimage.find_objects(segmentation), start=1):
        if sl is not None:
            bbox_coordinates[i] = tuple((s.start, s.stop) for s in sl)
    return center_coordinates, bbox_coordinates


def compute_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """Intersection over union of the pixels equal to 1 in two masks."""
    overlap = np.logical_and(mask1 == 1, mask2 == 1).sum()
    union = np.logical_or(mask1 == 1, mask2 == 1).sum()
    eps = 1e-7
    return float(overlap) / (float(union) + eps)


# -----------------------------------------------------------------------------
# Image files
# -----------------------------------------------------------------------------

def load_image_data(path: str, key: Optional[str] = None, lazy_loading: bool = False):
    """An image from a file: ``imageio`` without ``key``, the dataset ``key``
    of an HDF5 file with it. Both are imported here, at the call; where one is
    missing its ImportError is raised. With ``lazy_loading=True`` the h5py
    dataset is returned, its file left open, so that a large volume is not
    read up front."""
    if key is None:
        import imageio.v3 as imageio
        return imageio.imread(path)
    import h5py
    if lazy_loading:
        return h5py.File(path, "r")[key]
    with h5py.File(path, "r") as fh:
        return fh[key][...]


def segmentation_to_one_hot(segmentation: np.ndarray,
                            segmentation_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 1, H, W) float32 masks of the objects ``segmentation_ids`` (default:
    every non-zero id, ascending); ids absent from the segmentation raise."""
    if segmentation_ids is None:
        ids = np.unique(segmentation)
        ids = ids[ids != 0]
    else:
        ids = np.asarray(segmentation_ids)
        matched = np.isin(ids, np.unique(segmentation))
        if not matched.all():
            raise RuntimeError(f"Segmentation ids not found: {ids[~matched]}")
    return (segmentation[None] == ids[:, None, None]).astype(np.float32)[:, None]


# -----------------------------------------------------------------------------
# Mask records -> instance segmentation, NMS over records
# -----------------------------------------------------------------------------

def mask_data_to_segmentation(
    masks: List[Dict[str, Any]],
    shape: Optional[Tuple[int, int]] = None,
    min_object_size: int = 0,
    max_object_size: Optional[int] = None,
    label_masks: bool = True,
    with_background: bool = False,
    merge_exclusively: bool = True,
) -> np.ndarray:
    """Paint mask records (from AMG or batched inference) into an instance
    segmentation, the largest first: exclusively (a mask takes only free
    pixels) or on top. Records need "segmentation" (a binary mask) and
    "area", optionally "seg_id", and "bbox" + "global_bbox" (XYWH) for masks
    that live in a tile's frame. Then connected components, the components
    under ``min_object_size`` dropped (and with ``with_background`` the
    largest), ids made consecutive."""
    from . import native

    def xywh_to_slices(box):
        x, y, w, h = (int(v) for v in box)
        return np.s_[y:y + h, x:x + w]

    def size_ok(area):
        if area < min_object_size:
            return False
        return max_object_size is None or area <= max_object_size

    by_area = sorted(masks, key=lambda rec: rec["area"], reverse=True)
    if shape is None:
        shape = by_area[0]["segmentation"].shape
    canvas = np.zeros(shape, dtype="uint32")

    next_id = 1
    for record in by_area:
        if not size_ok(record["area"]):
            continue
        write_id = record.get("seg_id", next_id)
        binary = np.asarray(record["segmentation"])
        if "global_bbox" in record:
            # a mask in its tile's frame: its bbox crop goes to the global bbox
            binary = binary[xywh_to_slices(record["bbox"])]
            target = canvas[xywh_to_slices(record["global_bbox"])]
        else:
            target = canvas
        if merge_exclusively:
            binary = binary & (target == 0)
        target[binary] = write_id
        next_id = write_id + 1

    if label_masks:
        canvas = native.label(canvas)
    ids, counts = native.unique(canvas, return_counts=True)
    discard = list(ids[counts < min_object_size])
    if with_background:
        discard.append(ids[np.argmax(counts)])
    if discard:
        canvas[native.isin(canvas, np.asarray(discard))] = 0
    return native.relabel_consecutive(canvas)[0]


def _overlap_matrix(boxes: np.ndarray) -> np.ndarray:
    """Pairwise "the XYXY boxes intersect"."""
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    return (np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)) > 0


def _calculate_ious_between_pred_masks(masks, boxes, diagonal_value=1.0):
    """Pairwise mask IoU, over the pairs whose boxes intersect."""
    n = masks.shape[0]
    m = np.zeros((n, n), dtype=np.float64)
    overlap_m = _overlap_matrix(boxes)
    masks = np.asarray(masks, dtype=bool)
    for i in range(n):
        js = np.nonzero(overlap_m[i])[0]
        js = js[js > i]
        if len(js) > 0:
            inter = np.logical_and(masks[i], masks[js]).sum(axis=(1, 2))
            union = np.logical_or(masks[i], masks[js]).sum(axis=(1, 2))
            m[i, js] = inter / np.maximum(union, 1)
    m = m + m.T
    np.fill_diagonal(m, diagonal_value)
    return m


def _calculate_iomin_between_pred_masks(masks, boxes, eps=1e-6):
    """Pairwise intersection over the smaller mask's area."""
    overlap_m = _overlap_matrix(boxes)
    n = masks.shape[0]
    flat = np.asarray(masks, dtype=np.float32).reshape(n, -1)
    areas = flat.sum(axis=1)
    iomin = (flat @ flat.T) / (np.minimum(areas[:, None], areas[None, :]) + eps)
    iomin[~overlap_m] = 0
    return iomin


def _pairwise_overlap_varshape(masks, offsets, boxes, intersection_over_min, eps=1e-6):
    """Pairwise mask IoU / IoMin of masks in different frames (the tiles of a
    tiled prediction, border tiles smaller). offsets: (N, 2) the global (x, y)
    of each mask's frame; boxes: (N, 4) global XYXY. Each pair is compared on
    its boxes' intersection, which lies inside both frames."""
    n = len(masks)
    out = np.eye(n)
    candidates = _overlap_matrix(boxes)
    areas = np.array([int(np.count_nonzero(m)) for m in masks], dtype=np.float64)
    for i in range(n):
        for j in np.nonzero(candidates[i])[0]:
            if j <= i:
                continue
            x1, y1 = int(max(boxes[i, 0], boxes[j, 0])), int(max(boxes[i, 1], boxes[j, 1]))
            x2, y2 = int(min(boxes[i, 2], boxes[j, 2])), int(min(boxes[i, 3], boxes[j, 3]))
            win_i = masks[i][y1 - offsets[i, 1]:y2 - offsets[i, 1],
                             x1 - offsets[i, 0]:x2 - offsets[i, 0]]
            win_j = masks[j][y1 - offsets[j, 1]:y2 - offsets[j, 1],
                             x1 - offsets[j, 0]:x2 - offsets[j, 0]]
            inter = float(np.count_nonzero(win_i & win_j))
            denom = (min(areas[i], areas[j]) if intersection_over_min
                     else areas[i] + areas[j] - inter) + eps
            out[i, j] = out[j, i] = inter / denom
    return out


def _batched_mask_nms(masks, boxes, scores, nms_thresh, intersection_over_min, offsets=None):
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if offsets is not None:
        iou_matrix = _pairwise_overlap_varshape(masks, offsets, boxes, intersection_over_min)
    elif intersection_over_min:
        iou_matrix = _calculate_iomin_between_pred_masks(np.asarray(masks), boxes)
    else:
        iou_matrix = _calculate_ious_between_pred_masks(np.asarray(masks), boxes)
    sorted_indices = np.argsort(-scores, kind="stable")
    keep = []
    while len(sorted_indices) > 0:
        i = sorted_indices[0]
        keep.append(int(i))
        if len(sorted_indices) == 1:
            break
        iou_values = iou_matrix[i, sorted_indices[1:]]
        sorted_indices = sorted_indices[1:][iou_values <= nms_thresh]
    return np.asarray(keep, dtype=np.int64)


def apply_nms(
    predictions: List[Dict[str, Any]],
    min_size: int,
    shape: Optional[Tuple[int, int]] = None,
    perform_box_nms: bool = False,
    nms_thresh: float = 0.9,
    max_size: Optional[int] = None,
    intersection_over_min: bool = False,
) -> np.ndarray:
    """Mask (or box) NMS over prediction records, scored by predicted IoU x
    stability, then painted into an instance segmentation."""
    from .ops.amg_utils import MaskData, batched_nms

    if len(predictions) == 0:
        return np.zeros(shape if shape is not None else (1, 1), dtype="uint32")

    mask_list = [np.asarray(pred["segmentation"]) for pred in predictions]
    uniform = len({m.shape for m in mask_list}) == 1
    data = MaskData(
        # masks of unequal (border) tiles do not stack: a list, compared by frame offsets
        masks=np.stack(mask_list) if uniform else mask_list,
        iou_preds=np.array([pred["predicted_iou"] for pred in predictions]),
    )
    data["boxes"] = np.array([pred["bbox"] for pred in predictions])
    data["area"] = [int(np.asarray(m).sum()) for m in data["masks"]]
    data["stability_scores"] = np.array([pred["stability_score"] for pred in predictions])

    is_tiled = "global_bbox" in predictions[0]
    if is_tiled:
        if shape is None:
            raise ValueError("The output shape 'shape' has to be passed for tiled predictions.")
        data["global_boxes"] = np.array([pred["global_bbox"] for pred in predictions])

    if min_size > 0:
        data.filter(np.array([i for i, a in enumerate(data["area"]) if a > min_size],
                             dtype=np.int64))
    if max_size is not None:
        data.filter(np.array([i for i, a in enumerate(data["area"]) if a < max_size],
                             dtype=np.int64))
    if len(data) == 0:
        return np.zeros(shape if shape is not None else predictions[0]["segmentation"].shape,
                        dtype="uint32")

    def xywh_to_xyxy(b):
        b = np.asarray(b, dtype=np.float64).copy()
        b[:, 2] += b[:, 0]
        b[:, 3] += b[:, 1]
        return b

    scores = data["iou_preds"] * data["stability_scores"]
    nms_boxes = xywh_to_xyxy(data["global_boxes"] if is_tiled else data["boxes"])
    if perform_box_nms:
        assert not intersection_over_min  # not implemented
        keep_by_nms = batched_nms(nms_boxes, scores, None, iou_threshold=nms_thresh)
    else:
        offsets = None
        if is_tiled:  # compare the tiles' masks at global coordinates
            offsets = (np.asarray(data["global_boxes"])[:, :2]
                       - np.asarray(data["boxes"])[:, :2]).astype(np.int64)
        keep_by_nms = _batched_mask_nms(
            masks=data["masks"], boxes=nms_boxes, scores=scores, nms_thresh=nms_thresh,
            intersection_over_min=intersection_over_min, offsets=offsets)
    data.filter(keep_by_nms)

    mask_data = [{"segmentation": m, "area": a, "bbox": b}
                 for m, a, b in zip(data["masks"], data["area"], data["boxes"])]
    if is_tiled:
        for rec, gb in zip(mask_data, data["global_boxes"]):
            rec["global_bbox"] = gb
    if shape is None:
        shape = predictions[0]["segmentation"].shape
    if not mask_data:
        return np.zeros(shape, dtype="uint32")
    return mask_data_to_segmentation(mask_data, shape=shape, min_object_size=min_size)
