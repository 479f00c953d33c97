"""SAM trainer with iterative prompting (counterpart of
``micro_sam_tpu/training/sam_trainer.py``, upstream micro_sam's SamTrainer).

One step: the encoder runs once over the batch of images (blocks checkpointed,
attention through the K1 / K4 kernels), then ``n_sub_iteration`` rounds decode
every sampled object. The first round of a point step is multimask (the best
of the three masks by dice counts); each later round adds one positive point
from the false-negative region and one negative point from the false-positive
region, drawn on the device by a Gumbel argmax from an explicit
``torch.Generator``, and with probability ``mask_prob`` (one coin for the
batch) feeds the last low-resolution logits back as a mask prompt. The loss
is dice + ``mse_loss_weight`` * (predicted IoU - actual IoU)^2, averaged over
the rounds. Each round is checkpointed, as the JAX trainer remats it.

Prompts grow as upstream micro-sam grows them: the initial points (or the box
corners), then two points per round, and the one padding point upstream SAM
appends when there is no box. The JAX trainer instead gives every object a
fixed-capacity array whose unused slots carry label -1; each such token takes
part in the decoder's attention, so its rounds differ from these.

On a mesh (``mesh=``, ``parallel/mesh.py``; one process a rank) each data rank
trains on its share of the global batch: its loader yields that share, the
encoder's blocks are split over the model axis, and after backward the
gradients are averaged over the data group in float32 buckets. A step is then
the single process's step on the global batch: each image's sampling is
seeded by its global index, the object axis is padded to the data group's
largest, the loss is normalized by the group's count of objects, and the
corrective points' Gumbel field and the mask coin are the global batch's draws,
of which each rank keeps its rows. The checkpoint holds the whole tensors
under the single-process keys, written by mesh rank 0 alone.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import pickle
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.convert import params_from_jax, params_to_jax
from ..ops.amg_utils import batched_mask_to_box
from ..parallel.mesh import (all_gather_cat, all_reduce_f32, all_reduce_gradients_,
                             gather_state_dict, shard_params, shard_sam_)
from .trainable_sam import TrainableSAM, resize_bilinear
from .util import ConvertToSamInputs


def dice_score(pred_sigmoid: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Soft dice over the trailing two axes; the sums accumulate in float32
    (float64 inputs in float64)."""
    acc = torch.promote_types(torch.promote_types(pred_sigmoid.dtype, target.dtype), torch.float32)
    num = 2.0 * (pred_sigmoid * target).sum(dim=(-2, -1), dtype=acc)
    den = (pred_sigmoid ** 2).sum(dim=(-2, -1), dtype=acc) + (target ** 2).sum(dim=(-2, -1), dtype=acc)
    return num / (den + eps)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1), on the generator's device."""
    e = torch.empty(shape, device=generator.device).exponential_(generator=generator)
    return -torch.log(e)


def _gumbel_pick2(gumbel: torch.Tensor, region_a: torch.Tensor, region_b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One uniform pick from each of two DISJOINT (N, H, W) regions sharing one
    (N, H * W) Gumbel field: argmaxes over disjoint subsets of an iid field
    are independent. Returns xy (N, 2) float32 each; (0, 0) for an empty row."""
    N, H, W = region_a.shape

    def pick(region):
        flat = region.reshape(N, H * W)
        idx = torch.where(flat, gumbel, float("-inf")).argmax(dim=-1)
        idx = torch.where(flat.any(dim=-1), idx, torch.zeros_like(idx))
        return torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)

    return pick(region_a > 0), pick(region_b > 0)


def _bbox_ring(gt: torch.Tensor, df: int = 3) -> torch.Tensor:
    """(N, H, W) masks -> the part of each df-dilated bounding box outside the
    object (the negative points' fallback region)."""
    N, H, W = gt.shape
    boxes = batched_mask_to_box(gt > 0).long()
    ys = torch.arange(H, device=gt.device)[None, :, None]
    xs = torch.arange(W, device=gt.device)[None, None, :]
    x0 = (boxes[:, 0] - df).clamp_min(0)[:, None, None]
    y0 = (boxes[:, 1] - df).clamp_min(0)[:, None, None]
    x1 = (boxes[:, 2] + df).clamp_max(W)[:, None, None]
    y1 = (boxes[:, 3] + df).clamp_max(H)[:, None, None]
    in_box = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return in_box & (gt <= 0)


def adamw(params, lr: float = 1e-5) -> torch.optim.AdamW:
    """AdamW with optax.adamw's defaults (torch's own weight decay is 1e-2)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_optimizer(model: TrainableSAM, lr: float = 1e-5) -> Optional[torch.optim.AdamW]:
    """``adamw`` over the SAM parameters that train; frozen parameters are
    left out, so they get no update and no decay. None when nothing trains."""
    params = [p for p in model.sam.parameters() if p.requires_grad]
    return adamw(params, lr) if params else None


class SamTrainer:
    """Iterative-prompting trainer.

    Args:
        name: Checkpoint / run name.
        train_loader / val_loader: Iterables of (image, labels) numpy batches:
            image (B, H, W, C) raw, labels (B, H, W) instance masks.
        model: TrainableSAM.
        optimizer: a torch optimizer over the model's trainable parameters
            (default ``make_optimizer(model, lr)``; with no trainable
            parameter, none: each step then runs the forward only, so the
            loss is logged and the sampling streams advance as in training).
        n_sub_iteration: Prompting rounds per step.
        n_objects_per_batch: Objects sampled per image.
        convert_inputs: Ground truth -> prompts converter.
        mse_loss_weight: Weight of the IoU-regression loss.
        mask_prob: Probability of feeding the predicted logits back as a mask
            prompt in the later rounds.
        save_root: Directory for checkpoints.
        seed: Seeds the object / prompt sampling and the device generator of
            the corrective points and the mask coin.
        logger: "tensorboard" or None (TensorBoard when
            ``torch.utils.tensorboard`` imports), a ``SamLogger`` (class or
            instance) whose writer takes the scalars, or False for none.
        mesh: a ``parallel.mesh.Mesh`` to train on (the model on its device);
            each rank's loaders yield its data rank's share of every batch.
    """

    def __init__(self, name: str, train_loader, val_loader, model: TrainableSAM, optimizer=None,
                 n_sub_iteration: int = 8, n_objects_per_batch: Optional[int] = 25,
                 convert_inputs: Optional[ConvertToSamInputs] = None,
                 mse_loss_weight: float = 1.0, mask_prob: float = 0.5,
                 save_root: Optional[str] = None, lr: float = 1e-5, seed: int = 0, logger=None,
                 mesh=None):
        if n_sub_iteration < 1:
            raise ValueError(f"n_sub_iteration must be >= 1, got {n_sub_iteration}")
        self.name = name
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.model = model
        self.mesh = None
        if mesh is not None:
            self._setup_mesh(mesh)
        self.optimizer = optimizer or make_optimizer(model, lr)
        self.n_sub_iteration = n_sub_iteration
        self.n_objects_per_batch = n_objects_per_batch or 25
        self.convert_inputs = convert_inputs or ConvertToSamInputs(box_distortion_factor=0.025)
        self.mse_loss_weight = mse_loss_weight
        self.mask_prob = mask_prob
        self.save_root = save_root or "./checkpoints"
        self.seed = int(seed)
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._iteration = 0
        self._epoch = 0
        self._best_metric = np.inf
        self.train_metrics: list = []
        self._tb = None
        if isinstance(logger, type) and issubclass(logger, SamLogger):
            logger = logger(self, self.save_root)
        if isinstance(logger, SamLogger):
            self._tb = logger.tb
        elif logger in ("tensorboard", None):
            self._tb = _summary_writer(os.path.join(self.save_root, self.name, "logs"))
        if not self._writes:
            self._tb = None

    def _setup_mesh(self, mesh) -> None:
        """Split the encoder over the mesh's model axis (in place: an
        optimizer given keeps its Parameters, and AdamW's moments take the
        local shards' shapes at the first step); batches go over its data
        axis."""
        if self.model.device != mesh.device:
            raise ValueError(f"the model is on {self.model.device}, the mesh's rank on "
                             f"{mesh.device}")
        shard_sam_(self.model.sam, mesh)
        self.mesh = mesh

    @property
    def _writes(self) -> bool:
        """Whether this process writes the run's files (mesh rank 0 does)."""
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------
    # prompt schedule (upstream sam_trainer.py)
    # ------------------------------------------------------------------
    def _get_prompt_and_multimasking_choices(self, iteration: int):
        """(use_points, use_box, multimask, n_pos, n_neg)."""
        if iteration % 2 == 0:
            return True, False, True, 1, 0  # one positive point, multimask
        return False, True, False, 0, 0     # box

    _VAL_POINT_BUCKETS = ((1, 1), (2, 2), (4, 4))

    def _get_prompt_and_multimasking_choices_for_val(self, iteration: int):
        """%4 == 0 one point, 1 box, 2 several points without box, 3 box and a point."""
        if iteration % 4 == 0:
            return True, False, True, 1, 0
        if iteration % 4 == 1:
            return False, True, False, 0, 0
        if iteration % 4 == 2:
            n_pos, n_neg = self._VAL_POINT_BUCKETS[(iteration // 4) % len(self._VAL_POINT_BUCKETS)]
            return True, False, False, n_pos, n_neg
        return True, True, False, 1, 0

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def _round(self, feats, points, labels, mask_input, has_mask, gt_c, gt_bin, valid, denom,
               first_multimask: bool):
        """Decode, upscale and score one round. Returns (round loss, mean
        predicted IoU, selected upscaled logits, selected low-res logits); the
        last three carry no gradient."""
        model = self.model
        dt = model.config.dtype
        N = gt_c.shape[0]
        hw = tuple(gt_c.shape[-2:])
        rows = torch.arange(N, device=gt_c.device)
        low_res, iou_pred = model.forward_decoder(feats, points, labels, mask_input, has_mask)
        if first_multimask:  # only the first round of a point step reads all four masks
            up = model.upscale_masks(low_res.to(dt), hw)
            d3 = (1.0 - dice_score(torch.sigmoid(up), gt_c[:, None]))[:, 1:]
            sel = d3.argmin(dim=1)
            mask_loss = d3.gather(1, sel[:, None])[:, 0]
            sel = sel + 1
            up_sel = up[rows, sel]
        else:
            up_sel = model.upscale_masks(low_res[:, :1].to(dt), hw)[:, 0]
            mask_loss = 1.0 - dice_score(torch.sigmoid(up_sel), gt_c)
            sel = torch.zeros(N, dtype=torch.long, device=gt_c.device)
        with torch.no_grad():
            pred = up_sel > 0
            inter = (pred & gt_bin).sum(dim=(-2, -1), dtype=torch.float32)
            union = (pred | gt_bin).sum(dim=(-2, -1), dtype=torch.float32)
            actual_iou = inter / union.clamp_min(1e-7)
        iou_sel = iou_pred[rows, sel]
        iou_loss = (iou_sel - actual_iou) ** 2
        loss = ((mask_loss + self.mse_loss_weight * iou_loss) * valid).sum() / denom
        miou = (iou_sel.detach() * valid).sum() / denom
        return loss, miou, up_sel.detach(), low_res[rows, sel].detach()

    def _loss(self, images, gt, obj_valid, points0, labels0, boxes0, use_points: bool,
              use_box: bool, multimask: bool):
        """The step's loss (with autograd when enabled) and mean predicted IoU."""
        model = self.model
        cfg = model.config
        dt = cfg.dtype
        B, O, S1, S2 = gt.shape
        N = B * O
        dev = gt.device
        scale = cfg.img_size / max(S1, S2)
        gt_flat = gt.reshape(N, S1, S2)
        valid = obj_valid.reshape(N).float()
        gt_c = gt_flat.to(dt)
        gt_bin = gt_c > 0.5
        mask_hw = cfg.embedding_size * 4

        feats = model.image_embeddings_oft(images).repeat_interleave(O, dim=0)
        pts, lbls = [], []
        if use_points:
            P0 = points0.shape[2]
            pts.append(points0.reshape(N, P0, 2) * scale)
            lbls.append(labels0.reshape(N, P0).to(torch.int64))
        if use_box:
            pts.append(boxes0.reshape(N, 2, 2) * scale)
            lbls.append(torch.tensor([[2, 3]], device=dev).expand(N, 2))
        points, labels = torch.cat(pts, dim=1), torch.cat(lbls, dim=1)
        pad_pt = torch.zeros((N, 1, 2), device=dev)
        pad_lbl = torch.full((N, 1), -1, dtype=torch.int64, device=dev)
        new_lbl = torch.tensor([[1, 0]], device=dev).expand(N, 2)
        ring = _bbox_ring(gt_flat)
        neg_fallback = torch.where(ring.any(dim=(1, 2))[:, None, None], ring, ~gt_bin)
        d = 1 if self.mesh is None else self.mesh.shape["data"]
        if d == 1:
            denom = valid.sum().clamp_min(1.0)
        else:  # the global batch's count of objects, shared out over the data ranks
            denom = all_reduce_f32(valid.sum(), self.mesh.data_group).clamp_min(1.0) / d

        mask_input = has_mask = None
        losses, ious = [], []
        for r in range(self.n_sub_iteration):
            p_in, l_in = points, labels
            if not use_box:  # upstream SAM's one padding point
                p_in, l_in = torch.cat([p_in, pad_pt], 1), torch.cat([l_in, pad_lbl], 1)
            loss, miou, up_sel, low_sel = checkpoint(
                self._round, feats, p_in, l_in, mask_input, has_mask, gt_c, gt_bin, valid, denom,
                multimask and r == 0, use_reentrant=False)
            losses.append(loss)
            ious.append(miou)
            if r + 1 == self.n_sub_iteration:
                break
            with torch.no_grad():  # corrective prompts for the next round
                pred = up_sel > 0
                pos_region = gt_bin & ~pred
                neg_region = pred & ~gt_bin
                pos_src = torch.where(pos_region.any(dim=(1, 2))[:, None, None], pos_region,
                                      gt_bin & pred)
                neg_src = torch.where(neg_region.any(dim=(1, 2))[:, None, None], neg_region,
                                      neg_fallback)
                # the global batch's field; a data rank keeps its rows
                gumbel = gumbel_noise((N * d, S1 * S2), self.generator)
                i = 0 if self.mesh is None else self.mesh.data_index
                pos_xy, neg_xy = _gumbel_pick2(gumbel[i * N:(i + 1) * N], pos_src, neg_src)
                points = torch.cat([points, torch.stack([pos_xy, neg_xy], dim=1) * scale], 1)
                labels = torch.cat([labels, new_lbl], 1)
                use_mask = torch.rand((), generator=self.generator, device=dev) < self.mask_prob
                mask_input = resize_bilinear(low_sel[:, None], (mask_hw, mask_hw)).permute(0, 2, 3, 1)
                has_mask = use_mask.expand(N)
        return torch.stack(losses).sum() / self.n_sub_iteration, \
            torch.stack(ious).sum() / self.n_sub_iteration

    def _prepare_batch(self, image, labels, use_points, use_box, n_pos=1, n_neg=0,
                       train=True, batch_idx=0):
        """Objects and initial prompts of a numpy batch, each image keyed by
        (seed, train / val, epoch, batch, sample) as in the JAX trainer; the
        tensors moved to the model's device."""
        kwargs = {}
        local_b = np.asarray(labels).shape[0]
        offset = 0 if self.mesh is None else self.mesh.data_index * local_b
        if getattr(self.convert_inputs, "supports_sample_seeds", False):
            base = (self.seed, 0 if train else 1, self._epoch, batch_idx)
            kwargs["sample_seeds"] = [
                np.random.SeedSequence(base + (offset + b,)).generate_state(1)[0]
                for b in range(local_b)]
        batch = self.convert_inputs(image, labels, n_objects=self.n_objects_per_batch, n_pos=n_pos,
                                    n_neg=n_neg, get_points=use_points, get_boxes=use_box, **kwargs)
        if self.mesh is not None:
            batch = self._global_batch_share(batch, image, local_b,
                                             (max(n_pos, 1) if use_points else 1) + n_neg)
        if batch is None:
            return None
        return tuple(t.to(self.device) for t in batch)

    def _global_batch_share(self, batch, image, local_b: int, n_prompt_points: int):
        """This data rank's share of the global batch, its object axis padded
        to the data group's largest (invalid objects; None when no rank has
        one). Raises when the shares differ in size or the global batch does
        not divide by the data axis."""
        d = self.mesh.shape["data"]
        n_obj = 0 if batch is None else batch[1].shape[1]
        sizes = all_gather_cat(torch.tensor([[local_b, n_obj]], device=self.device),
                               self.mesh.data_group).tolist()
        global_b = sum(b for b, _ in sizes)
        if global_b % d:
            raise ValueError(f"Global batch size {global_b} must be divisible by the mesh data "
                             f"axis ({d}) — size your loader batches to the mesh.")
        if any(b != local_b for b, _ in sizes):
            raise ValueError(f"the data ranks' batches differ in size ({[b for b, _ in sizes]}); "
                             "each data rank feeds an equal share of the global batch")
        O = max(o for _, o in sizes)
        if O == 0:
            return None
        if batch is None:
            x = torch.from_numpy(self.convert_inputs.images(image).astype(np.float32))
            H, W = x.shape[1], x.shape[2]
            P = n_prompt_points
            batch = (x, torch.zeros((local_b, 0, H, W)), torch.zeros((local_b, 0), dtype=torch.bool),
                     torch.zeros((local_b, 0, P, 2)), torch.zeros((local_b, 0, P), dtype=torch.int32),
                     torch.zeros((local_b, 0, 4)))
        images, gt, valid, points, plabels, boxes = batch
        pad = O - gt.shape[1]
        if pad:
            def grow(t, fill=0):
                return torch.cat([t, t.new_full((t.shape[0], pad) + tuple(t.shape[2:]), fill)], 1)
            gt, valid, points, boxes = grow(gt), grow(valid, False), grow(points), grow(boxes)
            plabels = grow(plabels, -1)
        return images, gt, valid, points, plabels, boxes

    def _over_data(self, loss: torch.Tensor, miou: torch.Tensor):
        """The global batch's loss and mean IoU: each rank's share averaged
        over the data group (a rank's share is normalized by the global
        count, shared out)."""
        if self.mesh is None:
            return loss, miou
        both = all_reduce_f32(torch.stack([loss.detach().float(), miou.float()]),
                              self.mesh.data_group) / self.mesh.shape["data"]
        return both[0], both[1]

    def train_step(self, batch, use_points: bool, use_box: bool, multimask: bool):
        """One optimizer step on a prepared batch; returns (loss, mean IoU)
        tensors. Without an optimizer (no SAM parameter trains) the forward
        only, without autograd."""
        if self.optimizer is None:
            with torch.no_grad():
                loss, miou = self._loss(*batch, use_points, use_box, multimask)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            loss, miou = self._loss(*batch, use_points, use_box, multimask)
            loss.backward()
            if self.mesh is not None:
                all_reduce_gradients_(self.model.sam.parameters(), self.mesh.data_group)
            self.optimizer.step()
        self._iteration += 1
        return self._over_data(loss.detach(), miou)

    def _after_train_step(self, prepared, batch) -> None:
        """Called after each training step with the prepared batch and the
        loader's batch (a subclass trains more on them); nothing here."""

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------
    def _run_epoch(self, train: bool = True):
        """One pass over a loader of (image, labels) batches; a third element
        (the decoder's targets) is left to ``_after_train_step``."""
        loader = self.train_loader if train else self.val_loader
        losses, ious = [], []
        for batch_idx, loader_batch in enumerate(loader):
            image, labels = loader_batch[0], loader_batch[1]
            choose = (self._get_prompt_and_multimasking_choices if train
                      else self._get_prompt_and_multimasking_choices_for_val)
            use_points, use_box, multimask, n_pos, n_neg = choose(self._iteration)
            batch = self._prepare_batch(image, labels, use_points, use_box, n_pos, n_neg,
                                        train=train, batch_idx=batch_idx)
            if batch is None:
                continue
            if train:
                loss, miou = self.train_step(batch, use_points, use_box, multimask)
                self._after_train_step(batch, loader_batch)
            else:
                with torch.no_grad():
                    loss, miou = self._over_data(*self._loss(*batch, use_points, use_box,
                                                             multimask))
            losses.append(float(loss))
            ious.append(float(miou))
        return (float(np.mean(losses)) if losses else np.inf,
                float(np.mean(ious)) if ious else 0.0)

    def fit(self, epochs: Optional[int] = None, iterations: Optional[int] = None,
            save_every_kth_epoch: Optional[int] = None, verbose: bool = True):
        """Train for ``epochs`` (or enough epochs for ``iterations`` steps),
        validating and checkpointing (latest, best) after each epoch."""
        if epochs is None and iterations is None:
            raise ValueError("Pass epochs or iterations")
        if epochs is None:
            try:
                steps_per_epoch = len(self.train_loader)
            except TypeError:
                steps_per_epoch = 1
            epochs = max(1, int(np.ceil(iterations / max(steps_per_epoch, 1))))
        os.makedirs(os.path.join(self.save_root, self.name), exist_ok=True)
        for epoch in range(epochs):
            t0 = time.time()
            self.model.sam.train()
            train_loss, train_iou = self._run_epoch(train=True)
            self.model.sam.eval()
            val_loss, val_iou = self._run_epoch(train=False)
            self._epoch = epoch + 1
            self.train_metrics.append({"epoch": epoch, "train_loss": train_loss,
                                       "val_loss": val_loss, "train_model_iou": train_iou,
                                       "val_model_iou": val_iou})
            if self._tb is not None:
                for tag, val in (("train/loss", train_loss), ("validation/loss", val_loss),
                                 ("train/model_iou", train_iou), ("validation/model_iou", val_iou)):
                    self._tb.add_scalar(tag, val, self._iteration)
            if self._writes:
                with open(os.path.join(self.save_root, self.name, "metrics.csv"), "w",
                          newline="") as f:
                    w = csv.DictWriter(f, fieldnames=list(self.train_metrics[0]))
                    w.writeheader()
                    w.writerows(self.train_metrics)
            if verbose and self._writes:
                print(f"[{self.name}] epoch {epoch + 1}/{epochs}: train_loss={train_loss:.4f} "
                      f"val_loss={val_loss:.4f} model_iou={val_iou:.3f} ({time.time() - t0:.1f}s)")
            self.save_checkpoint("latest")
            if val_loss < self._best_metric:
                self._best_metric = val_loss
                self.save_checkpoint("best")
            if save_every_kth_epoch and (epoch + 1) % save_every_kth_epoch == 0:
                self.save_checkpoint(f"epoch-{epoch + 1}")

    # ------------------------------------------------------------------
    # checkpoints: the JAX trainer's pickle, the parameters as its tree
    # ------------------------------------------------------------------
    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(self.save_root, self.name, f"{name}.pkl")

    def _checkpoint_state(self) -> Dict:
        """The checkpoint; on a mesh with a model axis the shards are gathered
        into whole tensors first (a collective: every rank calls it)."""
        cfg = self.model.config
        sd = (self.model.sam.state_dict() if self.mesh is None
              else gather_state_dict(self.model.sam, self.mesh))
        return {"model_state": params_to_jax(sd, cfg),
                "model_type": cfg.model_type, "model_config": dataclasses.asdict(cfg),
                "iteration": self._iteration, "epoch": self._epoch,
                "metrics": self.train_metrics}

    def save_checkpoint(self, name: str) -> None:
        state = self._checkpoint_state()
        if self._writes:
            with open(self._checkpoint_path(name), "wb") as f:
                pickle.dump(state, f)
        if self.mesh is not None:
            self.mesh.barrier()  # the file is whole when any rank returns

    def load_checkpoint(self, name: str = "latest") -> Dict:
        """Load one of this run's own checkpoints (a trusted pickle)."""
        with open(self._checkpoint_path(name), "rb") as f:
            state = pickle.load(f)
        sd = params_from_jax(state["model_state"], self.model.config)
        if self.mesh is not None:
            sd = shard_params(sd, self.mesh, self.model.config)
        self.model.sam.load_state_dict(sd)
        self._iteration = state.get("iteration", 0)
        self._epoch = state.get("epoch", 0)
        return state


def _summary_writer(log_dir: str):
    """A TensorBoard writer on ``log_dir``, or None where tensorboard does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class SamLogger:
    """TensorBoard logging with the reference's surface: ``add_image``,
    ``log_train``, ``log_validation``. Pass the class or an instance as
    ``SamTrainer(logger=...)``; the trainer then writes its scalars through
    this writer (``tb``, None without tensorboard). Takes numpy or torch
    arrays."""

    def __init__(self, trainer, save_root, **unused_kwargs):
        root = "./logs" if save_root is None else os.path.join(save_root, "logs")
        self.log_dir = os.path.join(root, getattr(trainer, "name", "sam"))
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_image_interval = getattr(trainer, "log_image_interval", 100)
        self.tb = _summary_writer(self.log_dir)

    @staticmethod
    def _chw(img):
        img = np.asarray(img.detach().cpu() if torch.is_tensor(img) else img, dtype=np.float32)
        return img[None] if img.ndim == 2 else img

    def add_image(self, x, y, samples, name, step):
        if self.tb is None or x is None:
            return
        self.tb.add_image(f"{name}/input", self._chw(x[0]), step)
        if y is not None:
            self.tb.add_image(f"{name}/target", self._chw(y[0]), step)
        for i, sample in enumerate((samples or [])[:4]):
            self.tb.add_image(f"{name}/samples/{i}", self._chw(sample[0]), step)

    def _scalars(self, prefix, step, **values):
        for tag, value in values.items():
            if value is not None:
                self.tb.add_scalar(f"{prefix}/{tag}", float(value), step)

    def log_train(self, step, loss, lr, x=None, y=None, samples=None,
                  mask_loss=None, iou_regression_loss=None, model_iou=None):
        if self.tb is None:
            return
        self._scalars("train", step, loss=loss, mask_loss=mask_loss, iou_loss=iou_regression_loss,
                      model_iou=model_iou, learning_rate=lr)
        if step % self.log_image_interval == 0:
            self.add_image(x, y, samples, "train", step)

    def log_validation(self, step, metric, loss, x=None, y=None, samples=None,
                       mask_loss=None, iou_regression_loss=None, model_iou=None):
        if self.tb is None:
            return
        self._scalars("validation", step, loss=loss, metric=metric, mask_loss=mask_loss,
                      iou_loss=iou_regression_loss, model_iou=model_iou)
