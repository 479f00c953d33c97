"""bioimage.io-style model export (counterpart of
``micro_sam_tpu/bioimageio/model_export.py``).

A self-contained model package: a zip of ``rdf.yaml`` (JSON, a subset of
YAML), the SAM weights as ``model.pt`` in segment_anything's torch state-dict
layout (``{"model_state", "decoder_state"}`` when a decoder state is given),
the ``test_*.npy`` tensors of one box-prompted run, and ``cover.png`` where
matplotlib is installed. The format is the JAX package's, so each package's
``load_sam_package`` / ``test_model_package`` reads the other's zip: the
architecture travels as the ``config.micro_sam_tpu.model_config`` record, and
a package whose weights are the JAX package's ``native_npz`` form (its flat
parameter-tree npz) loads here too.

vit_t: the JAX package's TinyViT splits the qkv product's rows into global
thirds [q | k | v] where upstream's (and the port's) go per head, and its
state-dict converter keeps its own order. So a vit_t package holds the qkv
rows in thirds, as the JAX package writes them (``pytorch_state_dict``,
whose config record the JAX loader honours, where it reads a ``native_npz``
at the model type's default size): the port permutes them on the way out and
back (``_tiny_qkv_rows``).
"""
from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from dataclasses import fields
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import __version__, util
from .predictor_adaptor import PredictorAdaptor


class _ParameterizedSize:
    """Offline stand-in for bioimageio.spec's ParameterizedSize: an axis size
    of min + n * step for any n >= 0."""

    def __init__(self, min: int = 1, step: int = 1):
        self.min = min
        self.step = step

    def __repr__(self):
        return f"ParameterizedSize(min={self.min}, step={self.step})"


# arbitrary spatial axis size of the exported rdf's axis specs
ARBITRARY_SIZE = _ParameterizedSize(min=1, step=1)

DEFAULTS = {
    "authors": [{"name": "micro_sam_tpu"}],
    "description": "Segment Anything for Microscopy (PyTorch / CUDA build)",
    "cite": [{
        "text": "Archit et al. Segment Anything for Microscopy.",
        "doi": "10.1038/s41592-024-02580-4",
    }],
    "tags": ["segment-anything", "instance-segmentation", "microscopy"],
}


def _create_test_inputs_and_outputs(predictor, image, box, tmp_dir):
    """Run the PredictorAdaptor once on a box prompt; save its tensors."""
    adaptor = PredictorAdaptor(predictor)
    input_ = image[None, None] if image.ndim == 2 else image[None]
    boxes = np.asarray(box, dtype=np.float64)[None, None]
    masks, scores, embeddings = adaptor(input_, box_prompts=boxes)

    paths = {}
    for name, arr in [
        ("test_input", input_), ("test_box", boxes), ("test_mask", masks),
        ("test_score", scores), ("test_embeddings", embeddings),
    ]:
        path = os.path.join(tmp_dir, f"{name}.npy")
        np.save(path, np.asarray(arr))
        paths[name] = path
    return paths


def _tiny_qkv_rows(sd: Dict[str, torch.Tensor], to_thirds: bool) -> Dict[str, torch.Tensor]:
    """A TinyViT state dict with its qkv rows permuted per head -> thirds
    (``to_thirds``) or back."""
    from ..models.convert import _qkv_heads_to_thirds, _qkv_thirds_to_heads
    from ..models.tiny_vit import NUM_HEADS
    permute = _qkv_heads_to_thirds if to_thirds else _qkv_thirds_to_heads
    out = dict(sd)
    for key, v in sd.items():
        parts = key.split(".")
        if key.startswith("image_encoder.layers.") and parts[-2] == "qkv":
            out[key] = torch.from_numpy(permute(v.numpy(), NUM_HEADS[int(parts[2])]))
    return out


def _model_config_record(config) -> dict:
    """The architecture record of the package: the config's plain fields, the
    JAX package's SamConfig field names (the two configs share them)."""
    return {f.name: (list(v) if isinstance(v, tuple) else v)
            for f in fields(config)
            if isinstance(v := getattr(config, f.name), (int, float, str, bool, tuple, type(None)))}


def export_sam_model(
    image: np.ndarray,
    label_image: Optional[np.ndarray],
    model_type: str,
    name: str,
    output_path: Union[str, os.PathLike],
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    predictor=None,
    decoder_state=None,
    device=None,
    **kwargs,
) -> str:
    """Export a SAM model as a bioimage.io-style package.

    Args:
        image: Test image of the package's round trip.
        label_image: Optional labels; the test box is their first object's
            bounding box (else the central half of the image).
        model_type: The SAM model type.
        name: The model's name in the package metadata.
        output_path: Where to write the package (``.zip`` is set as suffix).
        checkpoint_path: Optional checkpoint to load (without ``predictor``).
        predictor: A predictor to export instead of loading one.
        decoder_state: Optional decoder state stored beside the weights.
        device: Where the test run computes (the GPU by default; "cpu").
        kwargs: Extra metadata fields (authors, description, ...).

    Returns:
        The path of the written package.
    """
    if predictor is None:
        predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                       device=device)

    # the test box from the labels (or a central box)
    if label_image is not None and label_image.max() > 0:
        oid = np.unique(label_image)[1]
        ys, xs = np.where(label_image == oid)
        box = [xs.min(), ys.min(), xs.max(), ys.max()]
    else:
        h, w = image.shape[:2]
        box = [w // 4, h // 4, 3 * w // 4, 3 * h // 4]

    meta = dict(DEFAULTS)
    meta.update({k: v for k, v in kwargs.items() if v is not None})
    meta.update({
        "format_version": "0.5.3",
        "type": "model",
        "name": name,
        "version": "1",
        "license": "CC-BY-4.0",
        "attachments": [],
        "inputs": [{
            "id": "image", "axes": ["batch", "channel", "y", "x"],
            "test_tensor": "test_input.npy",
        }],
        "outputs": [
            {"id": "masks", "test_tensor": "test_mask.npy"},
            {"id": "scores", "test_tensor": "test_score.npy"},
            {"id": "embeddings", "test_tensor": "test_embeddings.npy"},
        ],
        "weights": {"pytorch_state_dict": {"source": "model.pt"}},
        "config": {
            "micro_sam_tpu": {
                "model_type": model_type, "version": __version__,
                # the whole architecture, so the loader rebuilds the config
                # without inferring shapes
                "model_config": _model_config_record(predictor.model.config),
            },
        },
    })

    with tempfile.TemporaryDirectory() as tmp_dir:
        tensors = _create_test_inputs_and_outputs(
            predictor, util._to_image(image)[..., 0] if image.ndim == 2 else image, box, tmp_dir)

        # weights in segment_anything's layout, float32 on the host
        model_path = os.path.join(tmp_dir, "model.pt")
        sd = {k: v.detach().float().cpu().contiguous()
              for k, v in predictor.model.state_dict().items()}
        if predictor.model.config.encoder == "tiny_vit":
            sd = _tiny_qkv_rows(sd, to_thirds=True)
        torch.save(sd if decoder_state is None else
                   {"model_state": sd, "decoder_state": decoder_state}, model_path)

        # cover image: the input with the test mask overlaid
        cover_path = _write_cover(tmp_dir, util._to_image(image), np.load(tensors["test_mask"]))
        if cover_path:
            meta["covers"] = ["cover.png"]

        rdf_path = os.path.join(tmp_dir, "rdf.yaml")
        with open(rdf_path, "w") as f:
            json.dump(meta, f, indent=2)

        output_path = str(Path(output_path).with_suffix(".zip"))
        with zipfile.ZipFile(output_path, "w", zipfile.ZIP_DEFLATED) as z:
            z.write(rdf_path, "rdf.yaml")
            # float32 weights barely deflate, and deflating them is most of
            # the export's time: stored
            z.write(model_path, os.path.basename(model_path), zipfile.ZIP_STORED)
            for path in tensors.values():
                z.write(path, os.path.basename(path))
            if cover_path:
                z.write(cover_path, "cover.png")

    return output_path


def load_sam_package(package_path: Union[str, os.PathLike], compute_dtype: str = "float32",
                     device=None):
    """Load a package of either package's export into a predictor on
    ``device`` (the GPU by default; "cpu"). Returns (predictor, rdf metadata)."""
    from ..models.build_sam import get_config, make_sam, resolve_device
    from ..models.convert import load_native_checkpoint, normalize_state_dict
    from ..models.sam import SamConfig
    from ..predictor import SamPredictor

    dev = resolve_device(device)
    with zipfile.ZipFile(str(package_path)) as z:
        meta = json.loads(z.read("rdf.yaml"))
        ms_meta = meta["config"]["micro_sam_tpu"]
        model_type = ms_meta["model_type"]
        if "model_config" in ms_meta:
            cfg_kwargs = {k: tuple(v) if isinstance(v, list) else v
                          for k, v in ms_meta["model_config"].items()}
            cfg = SamConfig(**{**cfg_kwargs, "compute_dtype": compute_dtype})
        else:
            cfg = get_config(model_type, compute_dtype)

        weights = meta["weights"]
        if "pytorch_state_dict" in weights:
            src = io.BytesIO(z.read(weights["pytorch_state_dict"]["source"]))
            state, _ = normalize_state_dict(torch.load(src, map_location="cpu",
                                                       weights_only=False))
            sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                  for k, v in state.items()}
            if cfg.encoder == "tiny_vit":
                sd = _tiny_qkv_rows(sd, to_thirds=False)
        else:
            src = io.BytesIO(z.read(weights["native_npz"]["source"]))
            _, sd = load_native_checkpoint(src, model_type, config=cfg)

    predictor = SamPredictor(make_sam(cfg, sd).to(dev).eval())
    predictor.model_type = model_type
    predictor.model_name = meta.get("name", model_type)
    return predictor, meta


def test_model_package(package_path: Union[str, os.PathLike], atol: float = 1e-2,
                       device=None) -> Dict[str, object]:
    """Round trip of a package: reload its weights on ``device``, run the
    packaged test input and box, and compare with the packaged outputs (the
    offline counterpart of ``bioimageio.core.test_model``)."""
    predictor, meta = load_sam_package(package_path, device=device)
    adaptor = PredictorAdaptor(predictor)

    with zipfile.ZipFile(str(package_path)) as z:
        input_, boxes, ref_mask, ref_score, ref_emb = (
            np.load(io.BytesIO(z.read(f"test_{name}.npy")))
            for name in ("input", "box", "mask", "score", "embeddings"))

    masks, scores, embeddings = adaptor(input_, box_prompts=boxes)

    mask_agree = float(np.mean(np.asarray(masks) == ref_mask))
    emb_err = float(np.max(np.abs(np.asarray(embeddings) - ref_emb)))
    score_err = float(np.max(np.abs(np.asarray(scores) - ref_score)))
    passed = mask_agree > 0.999 and emb_err < atol and score_err < atol
    return {
        "passed": passed,
        "name": meta.get("name"),
        "mask_agreement": mask_agree,
        "embedding_max_err": emb_err,
        "score_max_err": score_err,
    }



def _write_cover(tmp_dir, image, masks) -> Optional[str]:
    """The cover image, or None where matplotlib is missing (or fails)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(image[..., 0] if image.ndim == 3 else image, cmap="gray")
        mask = np.squeeze(masks)
        while mask.ndim > 2:
            mask = mask[0]
        ax.imshow(np.ma.masked_where(mask == 0, mask), alpha=0.5, cmap="autumn")
        ax.axis("off")
        path = os.path.join(tmp_dir, "cover.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
    except Exception:
        return None
