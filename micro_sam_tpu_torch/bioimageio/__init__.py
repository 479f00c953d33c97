"""Model export: the bioimage.io package (``model_export``), the one-call
predictor (``predictor_adaptor``), and the BioEngine / Triton layout with a
TorchScript encoder and an ONNX decoder (``bioengine_export``)."""
from .model_export import export_sam_model
from .predictor_adaptor import PredictorAdaptor
from .bioengine_export import (
    export_image_encoder, export_onnx_model, export_bioengine_model,
)
