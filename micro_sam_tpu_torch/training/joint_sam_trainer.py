"""Joint training of SAM (iterative prompting) and the UNETR instance decoder.

Counterpart of ``micro_sam_tpu/training/joint_sam_trainer.py``, with its
semantics: per training batch that carries distance targets, the SAM step
runs first; then the decoder step encodes the batch again without autograd,
with the SAM weights as that step left them, runs the decoder in autograd,
resizes its whole sigmoid output bilinearly to the targets' size and takes
the loss mean(1 - dice) over the batch and the three channels (foreground,
center and boundary distances; of four channels, the last three). Its own
AdamW (lr 1e-5, optax's defaults) updates the decoder's parameters; the
decoder's BatchNorm statistics are buffers and stay as they are. Validation
runs the SAM loss only, which also picks ``best``.

The checkpoints add ``decoder_state``, the decoder as the JAX package's
parameter tree, so either package's ``get_predictor_and_decoder`` loads them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.convert import unetr_params_from_jax, unetr_params_to_jax
from ..models.unetr import UNETRDecoder
from .sam_trainer import SamLogger, SamTrainer, adamw, dice_score
from .trainable_sam import resize_bilinear

DECODER_LR = 1e-5


def unetr_loss(unetr: UNETRDecoder, features: torch.Tensor, targets: torch.Tensor
               ) -> torch.Tensor:
    """mean(1 - dice) of the decoder's output on (B, e, e, C) NHWC
    ``features``, resized over its whole extent to the (B, 3, H, W)
    ``targets``; the resize and the dice in float32 (float64 in float64)."""
    out = unetr(features.permute(0, 3, 1, 2))
    pred = resize_bilinear(out.to(torch.promote_types(out.dtype, torch.float32)),
                           tuple(targets.shape[-2:]))
    return (1.0 - dice_score(pred, targets)).mean()


class JointSamTrainer(SamTrainer):
    """``SamTrainer`` and the UNETR decoder's training.

    Args:
        unetr: the decoder (``instance_segmentation.get_unetr``), float32
            parameters on the model's device.
        instance_loss / instance_metric: accepted for the reference's
            signature; the dice loss over the distance channels is built in.
    """

    def __init__(self, *args, unetr: Optional[UNETRDecoder] = None, instance_loss=None,
                 instance_metric=None, **kwargs):
        if kwargs.get("mesh") is not None:
            raise NotImplementedError("the joint trainer's decoder step is not meshed; train "
                                      "SAM on a mesh with SamTrainer")
        super().__init__(*args, **kwargs)
        if unetr is None:
            raise ValueError("JointSamTrainer needs the decoder: unetr=get_unetr(...)")
        self.unetr = unetr
        self.unetr_optimizer = adamw(list(unetr.parameters()), DECODER_LR)
        self._instance_losses: list = []

    def instance_step(self, images: torch.Tensor, targets) -> torch.Tensor:
        """One decoder update on (B, h, w, 3) images (the prepared batch's)
        and (B, 3 or 4, H, W) distance targets; returns the loss."""
        targets = torch.as_tensor(np.asarray(targets)[:, -3:], dtype=torch.float32)
        with torch.no_grad():
            features = self.model.image_embeddings_oft(images)
        self.unetr_optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = unetr_loss(self.unetr, features, targets.to(features.device))
            loss.backward()
        self.unetr_optimizer.step()
        return loss.detach()

    def _after_train_step(self, prepared, batch) -> None:
        if len(batch) > 2:
            self._instance_losses.append(float(self.instance_step(prepared[0], batch[2])))

    def _run_epoch(self, train: bool = True):
        self._instance_losses = []
        out = super()._run_epoch(train)
        if train and self._instance_losses and self._tb is not None:
            self._tb.add_scalar("train/instance_loss", float(np.mean(self._instance_losses)),
                                self._iteration)
        return out

    def _checkpoint_state(self) -> Dict:
        state = super()._checkpoint_state()
        state["decoder_state"] = unetr_params_to_jax(self.unetr.state_dict())
        return state

    def load_checkpoint(self, name: str = "latest", checkpoint: Optional[str] = None) -> Dict:
        """Load one of this run's checkpoints, the decoder with it;
        ``checkpoint`` is the reference's name for ``name``."""
        state = super().load_checkpoint(checkpoint or name)
        if "decoder_state" in state:
            self.unetr.load_state_dict(unetr_params_from_jax(state["decoder_state"]))
        return state


class JointSamLogger(SamLogger):
    """The joint trainer's TensorBoard logger: ``SamLogger``'s surface."""
