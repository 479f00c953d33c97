"""BioEngine / Triton export (counterpart of
``micro_sam_tpu/bioimageio/bioengine_export.py``).

- ``export_image_encoder``: the image encoder as TorchScript (``model.pt``,
  Triton's ``pytorch_libtorch`` platform), what upstream micro-sam writes.
  The JAX package writes StableHLO here, a TPU-native artifact.
- ``export_onnx_model``: the prompt-decode path as ONNX, through the legacy
  TorchScript exporter (``onnx_decoder.OnnxSamDecoder``).
- ``export_bioengine_model``: the Triton model-repository layout with the
  ``config.pbtxt`` of both parts.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import torch
import torch.nn as nn

from .. import util

ENCODER_CONFIG = """name: "%s"
backend: "%s"
platform: "%s"

max_batch_size : 1
input [
  {
    name: "input0__0"
    data_type: TYPE_FP32
    dims: [3, -1, -1]
  }
]
output [
  {
    name: "output0__0"
    data_type: TYPE_FP32
    dims: [256, 64, 64]
  }
]

parameters: {
  key: "INFERENCE_MODE"
  value: {
    string_value: "true"
  }
}
"""

DECODER_CONFIG = """name: "%s"
backend: "onnxruntime"
platform: "onnxruntime_onnx"

parameters: {
  key: "INFERENCE_MODE"
  value: {
    string_value: "true"
  }
}
"""


class ImageEncoderModule(nn.Module):
    """The traced encoder's contract, as its ``config.pbtxt`` declares it:
    (1, 3, h, w) float32 pixels in [0, 255], resized so that the longer side
    is the model's input size -> (1, 256, 64, 64) float32 embeddings.
    Normalizes, zero-pads to the input size, encodes."""

    def __init__(self, sam):
        super().__init__()
        from ..models.sam import PIXEL_MEAN, PIXEL_STD
        self.image_encoder = sam.image_encoder
        self.img_size = sam.config.img_size
        self.register_buffer("mean", torch.tensor(PIXEL_MEAN).reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(PIXEL_STD).reshape(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.mean) / self.std
        x = nn.functional.pad(x, (0, self.img_size - x.shape[3], 0, self.img_size - x.shape[2]))
        return self.image_encoder(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _host_f32_copy(predictor):
    """A float32 copy of the predictor's SAM on the CPU."""
    from dataclasses import replace

    from ..models.build_sam import make_sam
    sam = predictor.model
    sd = {k: v.detach().float().cpu() for k, v in sam.state_dict().items()}
    return make_sam(replace(sam.config, compute_dtype="float32"), sd).eval()


def export_image_encoder(
    model_type: str,
    output_root: Union[str, os.PathLike],
    export_name: str = "image-encoder",
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    device=None,
) -> str:
    """Export the image encoder as TorchScript (``<output_root>/<export_name>/
    1/model.pt`` and its ``config.pbtxt``).

    The model loads on ``device`` (the GPU by default; "cpu"), and what is
    traced is a float32 copy of it on the CPU: there every op of the encoder
    is its plain PyTorch version (the port's kernels are launched through
    ctypes, which ``torch.jit.trace`` cannot record), so the traced graph is
    plain ATen and runs on any libtorch device. This is an artifact for
    other runtimes, not a path the port serves through."""
    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                   device=device)
    module = ImageEncoderModule(_host_f32_copy(predictor)).eval()
    size = module.img_size
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        traced = torch.jit.trace(module, torch.zeros(1, 3, size, size), check_trace=False)

    output_root = str(output_root)
    model_dir = os.path.join(output_root, export_name, "1")
    os.makedirs(model_dir, exist_ok=True)
    out_path = os.path.join(model_dir, "model.pt")
    traced.save(out_path)

    config_path = os.path.join(output_root, export_name, "config.pbtxt")
    with open(config_path, "w") as f:
        f.write(ENCODER_CONFIG % (export_name, "pytorch", "pytorch_libtorch"))
    return out_path


def export_onnx_model(
    model_type: str,
    output_root: Union[str, os.PathLike],
    opset: int = 17,
    export_name: str = "onnx",
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    return_path: bool = False,
    quantize_model: bool = False,
    return_single_mask: bool = False,
    gelu_approximate: bool = False,
    use_stability_score: bool = False,
    return_extra_metrics: bool = False,
    device=None,
) -> Optional[str]:
    """Export the prompt-decode path to ONNX.

    The decode module (``onnx_decoder.OnnxSamDecoder``) is built from the
    model's state dict and traced with the legacy TorchScript exporter. The
    exporter's final ``_add_onnxscript_fn`` pass, which only injects
    onnxscript custom functions this model does not contain, needs the
    ``onnx`` package, so it is bypassed with an identity patch; the
    serialized ModelProto before that pass is already complete."""
    import unittest.mock as mock

    from .onnx_decoder import OnnxSamDecoder

    predictor = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                   device=device)
    cfg = predictor.model.config
    sd = {k: v.detach().float().cpu() for k, v in predictor.model.state_dict().items()}
    if gelu_approximate:
        # tanh-approximated GELU for ONNX backends without an Erf op
        from .onnx_decoder import set_gelu_approximate
        set_gelu_approximate("tanh")
    decoder = OnnxSamDecoder(
        sd, img_size=cfg.img_size, embedding_size=cfg.embedding_size,
        return_single_mask=return_single_mask,
        use_stability_score=use_stability_score,
        return_extra_metrics=return_extra_metrics,
    ).eval()

    e = cfg.embedding_size
    example = (
        torch.randn(1, cfg.prompt_embed_dim, e, e),
        torch.randint(0, cfg.img_size, (1, 5, 2)).float(),
        torch.tensor([[1., 0., 2., 3., -1.]]),
        torch.randn(1, 1, 4 * e, 4 * e),
        torch.ones(1),
        torch.tensor([720., 960.]),
    )
    dynamic_axes = {
        "point_coords": {1: "num_points"},
        "point_labels": {1: "num_points"},
    }

    output_root = str(output_root)
    os.makedirs(os.path.join(output_root, export_name), exist_ok=True)
    weight_path = os.path.join(output_root, export_name, "model.onnx")

    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    with torch.no_grad(), warnings.catch_warnings(), mock.patch.object(
            onnx_proto_utils, "_add_onnxscript_fn", lambda b, c: b):
        warnings.simplefilter("ignore")
        torch.onnx.export(
            decoder, example, weight_path,
            export_params=True, opset_version=opset, do_constant_folding=True,
            input_names=["image_embeddings", "point_coords", "point_labels",
                         "mask_input", "has_mask_input", "orig_im_size"],
            output_names=["masks", "iou_predictions", "low_res_masks"],
            dynamic_axes=dynamic_axes, dynamo=False,
        )

    if quantize_model:
        try:
            from onnxruntime.quantization import QuantType, quantize_dynamic
            quantized_path = os.path.join(output_root, export_name, "model_quantized.onnx")
            quantize_dynamic(
                model_input=weight_path, model_output=quantized_path,
                per_channel=False, reduce_range=False, weight_type=QuantType.QUInt8,
            )
            weight_path = quantized_path
        except ImportError:
            warnings.warn("onnxruntime is not available; skipping quantization.")

    return weight_path if return_path else None


def export_bioengine_model(
    model_type: str,
    output_root: Union[str, os.PathLike],
    opset: int = 17,
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    export_name: str = "onnx",
    return_single_mask: bool = True,
    gelu_approximate: bool = False,
    use_stability_score: bool = False,
    return_extra_metrics: bool = False,
    device=None,
) -> str:
    """Write the Triton model-repository layout: ``image-encoder/``
    (TorchScript) and ``<model_type>-decoder/`` (ONNX), each with its
    ``config.pbtxt``."""
    output_root = str(output_root)
    export_image_encoder(model_type, output_root, "image-encoder", checkpoint_path, device)

    decoder_name = f"{model_type}-decoder"
    decoder_dir = os.path.join(output_root, decoder_name, "1")
    os.makedirs(decoder_dir, exist_ok=True)
    with open(os.path.join(output_root, decoder_name, "config.pbtxt"), "w") as f:
        f.write(DECODER_CONFIG % decoder_name)
    export_onnx_model(
        model_type, os.path.join(output_root, decoder_name), opset,
        export_name="1", checkpoint_path=checkpoint_path, device=device,
    )
    return output_root
