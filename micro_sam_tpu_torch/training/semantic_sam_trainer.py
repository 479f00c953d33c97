"""Semantic segmentation trainers: SAM decodes without prompts and its first
``num_classes`` mask logits are class maps (counterpart of
``micro_sam_tpu/training/semantic_sam_trainer.py``)."""
from __future__ import annotations

import numpy as np
import torch

from .sam_trainer import SamTrainer, dice_score
from .util import ConvertToSemanticSamInputs


def one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) integer class maps -> (B, num_classes, H, W) float32; a class
    out of range gives a zero row (``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=targets.device).view(1, -1, 1, 1)
    return (targets.long()[:, None] == classes).float()


class CustomDiceLoss:
    """Mean (1 - dice) of the (softmaxed) ``(B, num_classes, H, W)`` logits
    against one-hot ``(B, 1, H, W)`` or ``(B, H, W)`` integer targets."""

    def __init__(self, num_classes: int, softmax: bool = True) -> None:
        self.num_classes = num_classes
        self.softmax = softmax

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.softmax:
            pred = torch.softmax(pred, dim=1)
        target = target[:, 0] if target.dim() == 4 else target
        return (1.0 - dice_score(pred, one_hot(target, self.num_classes))).mean()


class SemanticSamTrainer(SamTrainer):
    """Trains SAM for class maps: the promptless decode's logits
    ``[:, :num_classes]`` at the patch size, loss ``dice_weight`` x softmax
    dice + (1 - ``dice_weight``) x cross-entropy. Loaders yield (image,
    class map) batches."""

    def __init__(self, *args, num_classes: int = 3, convert_inputs=None,
                 dice_weight: float = 0.5, **kwargs):
        if kwargs.get("mesh") is not None:
            raise NotImplementedError("SemanticSamTrainer is not meshed; use SamTrainer(mesh=)")
        kwargs.setdefault("n_objects_per_batch", 1)
        super().__init__(*args, **kwargs)
        if num_classes < 2:
            raise ValueError(f"num_classes must be > 1, got {num_classes}")
        self.num_classes = num_classes
        self.dice_weight = dice_weight
        self.convert_inputs = convert_inputs or ConvertToSemanticSamInputs()

    def _logits(self, images: torch.Tensor, hw) -> torch.Tensor:
        """The promptless decode: zero points, no box, no mask; the first
        ``num_classes`` upscaled logits (B, C, H, W)."""
        model = self.model
        feats = model.image_embeddings_oft(images)
        B = feats.shape[0]
        points = torch.zeros((B, 0, 2), device=feats.device)
        labels = torch.zeros((B, 0), dtype=torch.int64, device=feats.device)
        low_res, _ = model.forward_decoder(feats, points, labels)
        return model.upscale_masks(low_res, hw)[:, :self.num_classes].float()

    def semantic_loss(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = self._logits(images, tuple(targets.shape[-2:]))
        oh = one_hot(targets, self.num_classes)
        dice = (1.0 - dice_score(torch.softmax(logits, dim=1), oh)).mean()
        ce = -(oh * torch.log_softmax(logits, dim=1)).sum(dim=1).mean()
        return self.dice_weight * dice + (1.0 - self.dice_weight) * ce

    def _step(self, images, targets, train: bool) -> torch.Tensor:
        """The loss of one batch; in training also the optimizer step (the
        forward only where no SAM parameter trains)."""
        if not train or self.optimizer is None:
            with torch.no_grad():
                loss = self.semantic_loss(images, targets)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.semantic_loss(images, targets)
            loss.backward()
            self.optimizer.step()
        if train:
            self._iteration += 1
        return loss.detach()

    def _run_epoch(self, train: bool = True):
        loader = self.train_loader if train else self.val_loader
        losses = []
        for batch in loader:
            images, targets = self.convert_inputs(batch[0], batch[1])
            losses.append(float(self._step(images.to(self.device), targets.to(self.device),
                                           train)))
        return (float(np.mean(losses)) if losses else np.inf), 0.0


class SemanticMapsSamTrainer(SemanticSamTrainer):
    """Continuous target maps: loss mean(1 - dice) of the sigmoid of the
    logits against (B, H, W) or (B, C, H, W) maps."""

    def semantic_loss(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        pred = torch.sigmoid(self._logits(images, tuple(targets.shape[-2:])))
        targets = targets[:, None] if targets.dim() == 3 else targets
        return (1.0 - dice_score(pred, targets.float())).mean()
