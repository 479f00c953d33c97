"""micro_sam_tpu_torch: Segment Anything for Microscopy in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of the JAX package ``micro_sam_tpu``, slice by slice. Its entry points
(``util.get_sam_model``, ``util.precompute_image_embeddings``,
``predictor.SamPredictor``) run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
