"""Multi-GPU execution over ``torch.distributed``: the data x model mesh
(``mesh``), the meshed encoder and AMG decoder (``embed``, ``decode``), the
training step (``train_step``) and the multi-process precompute
(``distributed``). Counterpart of ``micro_sam_tpu/parallel/``."""
