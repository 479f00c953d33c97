"""Simple per-slice 3d SAM wrapper (``micro_sam_tpu/models/simple_sam_3d_wrapper.py``).
The implementation lives in ``sam_3d_wrapper``; this module mirrors the
reference's import layout."""
from .sam_3d_wrapper import (  # noqa: F401
    BasicBlock,
    SegmentationHead,
    SimpleSam3DWrapper,
    get_simple_sam_3d_model,
)
