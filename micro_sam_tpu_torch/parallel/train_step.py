"""A SAM training step over a mesh (data ranks x the encoder split over the
model axis), and the dryruns that drive the production paths on one.

Counterpart of ``micro_sam_tpu/parallel/train_step.py``. There the step is one
jit program that XLA partitions over the mesh. Here each rank runs the step on
its share: the encoder's blocks exchange their partial products over the
model group (``parallel/mesh.py``), the loss's batch sums are all-reduced
over the data group (the forward sees the global batch's loss; the backward
of each rank carries its own samples' part), and the gradients are summed
over the data group before the AdamW update. The optimizer state lives with
the local shards: AdamW's moments take each Parameter's local shape at the
first step (``_opt_state_shardings`` of the JAX package).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.sam import SamConfig, preprocess
from .mesh import Mesh, ReduceFromModel, all_reduce_gradients_, shard_sam_

#: the dryruns' SAM: vit_b's layout at a tiny size
DRYRUN_CONFIG = dict(model_type="vit_b", embed_dim=64, depth=2, num_heads=4,
                     global_attn_indexes=(1,), window_size=4, img_size=128,
                     compute_dtype="float32")


def _dice_losses(pred_logits: torch.Tensor, target: torch.Tensor, eps: float = 1e-7
                 ) -> torch.Tensor:
    """1 - soft dice of sigmoid(logits) against target over the last two axes."""
    pred = torch.sigmoid(pred_logits)
    num = 2.0 * (pred * target).sum(dim=(-2, -1))
    den = (pred * pred).sum(dim=(-2, -1)) + (target * target).sum(dim=(-2, -1))
    return 1.0 - num / (den + eps)


def dice_loss(pred_logits: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Soft dice over sigmoid(logits); reduces over the spatial dims, mean over the rest."""
    return _dice_losses(pred_logits, target, eps).mean()


def make_train_step(sam, optimizer, mesh: Optional[Mesh] = None):
    """The training step of ``sam`` (float32 weights) under ``optimizer``:
    ``step(pixels (b, S, S, 3) raw, points (b, P, 2), labels (b, P), target_masks
    (b, 4e, 4e))`` -> (loss, (mask_loss, iou_loss)), detached, the parameters
    updated. On ``mesh`` each data rank passes its contiguous share of the
    global batch and gets the global batch's losses. The loss: the least over
    the three multimask outputs of their dice loss, plus the MSE of their
    predicted IoU against their actual IoU."""
    group = None if mesh is None else mesh.data_group
    d = 1 if mesh is None else mesh.shape["data"]

    def global_sum(t):
        return t if group is None else ReduceFromModel.apply(t, group)

    def loss_fn(pixels, points, labels, target):
        feats = sam.encode_image_train(preprocess(pixels, sam.config.img_size))
        mask_logits, iou_pred = sam.decode(feats, points, labels)
        logits, iou_pred = mask_logits[:, 1:].float(), iou_pred[:, 1:].float()
        B = logits.shape[0] * d
        t = target[:, None]
        per_mask = global_sum(_dice_losses(logits, t).sum(dim=0)) / B  # (3,) over the batch
        mask_loss = per_mask.min()
        with torch.no_grad():
            pred_bin = (logits > 0).float()
            inter = (pred_bin * t).sum(dim=(-2, -1))
            union = torch.maximum(pred_bin, t).sum(dim=(-2, -1))
            actual_iou = inter / (union + 1e-7)
        iou_loss = global_sum(((iou_pred - actual_iou) ** 2).sum()) / (B * 3)
        return mask_loss + iou_loss, (mask_loss, iou_loss)

    def train_step(pixels, points, labels, target_masks):
        optimizer.zero_grad(set_to_none=True)
        loss, (mask_loss, iou_loss) = loss_fn(pixels, points, labels, target_masks)
        loss.backward()
        if group is not None:  # each rank's backward carried its samples' part
            all_reduce_gradients_(sam.parameters(), group, op="sum")
        optimizer.step()
        return loss.detach(), (mask_loss.detach(), iou_loss.detach())

    return train_step


def dryrun_sam(seed: int, device):
    """The dryruns' SAM from ``seed`` on ``device``: float32 weights, eval mode."""
    from ..models.build_sam import make_sam
    cfg = SamConfig(**DRYRUN_CONFIG)
    return make_sam(cfg, None, seed, torch.float32).to(device).eval()


def _dryrun_batch(B: int, cfg: SamConfig, seed: int = 0):
    """Deterministic (pixels, points, labels, targets) numpy arrays of B samples."""
    rng = np.random.RandomState(seed)
    size = cfg.img_size
    pixels = (rng.rand(B, size, size, 3) * 255).astype(np.float32)
    points = (rng.rand(B, 2, 2) * size).astype(np.float32)
    labels = np.tile(np.array([[1, -1]], np.int64), (B, 1))
    targets = (rng.rand(B, cfg.embedding_size * 4, cfg.embedding_size * 4) > 0.7
               ).astype(np.float32)
    return pixels, points, labels, targets


def dryrun_training_step(mesh: Mesh, global_batch: Optional[int] = None):
    """One training step of a tiny SAM over ``mesh`` (``make_mesh()`` for this
    process's GPU alone), one sample a data rank unless ``global_batch`` says;
    returns the loss."""
    from ..training.sam_trainer import adamw
    d = mesh.shape["data"]
    sam = shard_sam_(dryrun_sam(0, mesh.device), mesh)
    step = make_train_step(sam, adamw(sam.parameters(), 1e-5), mesh)
    B = global_batch or d
    per = B // d
    sl = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    arrays = _dryrun_batch(B, sam.config)
    loss, (mask_loss, iou_loss) = step(*(torch.as_tensor(a[sl], device=mesh.device)
                                         for a in arrays))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    print(f"dryrun_training_step: mesh={mesh.shape} loss={loss:.4f} "
          f"mask={float(mask_loss):.4f} iou={float(iou_loss):.4f}")
    return loss


def dryrun_production(mesh: Mesh, workdir: Optional[str] = None) -> dict:
    """Drive the production multi-GPU paths on ``mesh`` at a tiny size, as a
    user calls them on every rank: ``SamTrainer(mesh=)`` for one epoch (one
    image a data rank), the tiled precompute of a meshed predictor against
    the single process's, and a meshed ``predict``. Returns the trainer's loss
    and the precompute's largest difference."""
    import tempfile

    from .. import util
    from ..predictor import SamPredictor
    from ..training.sam_trainer import SamTrainer
    from ..training.trainable_sam import TrainableSAM

    d = mesh.shape["data"]
    dev = mesh.device
    rng = np.random.RandomState(0)
    imgs = (rng.rand(d, 128, 128, 3) * 255).astype(np.float32)
    labels = np.zeros((d, 128, 128), np.int64)
    for b in range(d):  # a few square objects an image
        for i in range(3):
            y, x = rng.randint(0, 100, 2)
            labels[b, y:y + 24, x:x + 24] = i + 1
    i = mesh.data_index
    loader = [(imgs[i:i + 1], labels[i:i + 1])]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        trainer = SamTrainer(name="dryrun", train_loader=loader, val_loader=loader,
                             model=TrainableSAM(dryrun_sam(0, dev)), n_sub_iteration=2,
                             n_objects_per_batch=2, save_root=tmp, mesh=mesh, logger=False)
        trainer.fit(epochs=1, verbose=False)
        mesh.barrier()  # rank 0's files are written before the directory goes
    loss = trainer.train_metrics[0]["train_loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite meshed train loss {loss}")

    image = (rng.rand(200, 200) * 255).astype(np.uint8)
    ref = util.precompute_image_embeddings(SamPredictor(dryrun_sam(1, dev)), image,
                                           tile_shape=(128, 128), halo=(16, 16), verbose=False)
    meshed = SamPredictor(dryrun_sam(1, dev), mesh=mesh)
    got = util.precompute_image_embeddings(meshed, image, tile_shape=(128, 128), halo=(16, 16),
                                           verbose=False, batch_size=d)
    err = max(float(np.abs(np.asarray(ref["features"][t]["features"])
                           - np.asarray(got["features"][t]["features"])).max())
              for t in ref["features"])
    if err >= 1e-4:
        raise RuntimeError(f"meshed tiled precompute differs from the single process by {err}")

    meshed.set_image(np.stack([image] * 3, axis=-1))
    masks, _, _ = meshed.predict(point_coords=np.array([[100.0, 100.0]]),
                                 point_labels=np.array([1]))
    if masks.shape[-2:] != image.shape:
        raise RuntimeError(f"meshed predict gave masks of {masks.shape}")
    print(f"dryrun_production: mesh={mesh.shape} trainer loss={loss:.4f}, tiled precompute "
          f"meshed == single ({err:.2e}), predict ok")
    return {"trainer_loss": loss, "precompute_err": err}
