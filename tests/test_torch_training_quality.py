"""The SA50 quality gate of finetuning on the port (the JAX package's
tests/test_training.py::test_training_quality_threshold): a small SAM trained
from random weights with the port's SamTrainer on synthetic cells, its best
checkpoint exported, reloaded through ``get_sam_model`` and scored by the
port's iterative-prompting evaluation on held-out images; SA50 must exceed
0.7 at ``iteration00`` (one point a cell).

Upstream finetunes a pretrained vit_t one epoch and asks for SA50 > 0.8 at
``iteration02``; no pretrained checkpoint is in the repository, so the gate
trains the JAX package's small config (96 wide, 2 blocks, window 8, 128 px)
for 60 epochs with its schedule (optax's warmup_cosine_decay_schedule(0,
6e-4, 100, 1500, 1e-5) over AdamW). The JAX gate measured SA50 about 0.83 at
``iteration00``; trainer or prompt-loop faults measure about 0.05. The CPU
case is slow (minutes of training); the card case runs under the ``cuda``
marker and imports no JAX, so ``tests/test_torch_cuda.py`` runs it there.
"""
import math
import time

import numpy as np
import pytest
import torch

S = 128
SA50_BAR = 0.7


def warmup_cosine(step, init=0.0, peak=6e-4, warmup=100, decay=1500, end=1e-5):
    """optax.warmup_cosine_decay_schedule at ``step``."""
    if step < warmup:
        return init + (peak - init) * step / warmup
    t = min(step - warmup, decay - warmup) / (decay - warmup)
    return end + (peak - end) * 0.5 * (1 + math.cos(math.pi * t))


class ScheduledAdamW(torch.optim.AdamW):
    """The port's AdamW (optax's defaults) with ``warmup_cosine`` set before
    each step, as optax applies a schedule."""

    def __init__(self, params):
        super().__init__(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        self.count = 0

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = warmup_cosine(self.count)
        self.count += 1
        return super().step(closure)


def train_gate(device, root, epochs=60, seed=0):
    """The gate's training on ``device``: returns (the trainer, training
    seconds). ``seed`` seeds the initial weights (the gate's is 0)."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    from micro_sam_tpu_torch.training.training import default_sam_loader
    cfg = SamConfig(model_type="vit_b", embed_dim=96, depth=2, num_heads=2,
                    global_attn_indexes=(1,), img_size=S, window_size=8)
    sam = Sam(cfg).init_(torch.Generator().manual_seed(seed)).to(device)
    model = TrainableSAM(sam)
    train = [synthetic_data(shape=(S, S), seed=i, n_objects=6) for i in range(8)]
    loader = default_sam_loader(raw_paths=[im for im, _ in train], raw_key=None,
                                label_paths=[seg for _, seg in train], label_key=None,
                                patch_shape=(S, S), with_segmentation_decoder=False,
                                batch_size=1, n_samples=24)
    val_im, val_seg = synthetic_data(shape=(S, S), seed=100, n_objects=6)
    val_loader = default_sam_loader(raw_paths=[val_im], raw_key=None, label_paths=[val_seg],
                                    label_key=None, patch_shape=(S, S),
                                    with_segmentation_decoder=False, batch_size=1, n_samples=2)
    trainer = SamTrainer(name="quality", train_loader=loader, val_loader=val_loader, model=model,
                         optimizer=ScheduledAdamW([p for p in sam.parameters()
                                                   if p.requires_grad]),
                         n_sub_iteration=3, n_objects_per_batch=4, save_root=str(root),
                         mask_prob=0.5, logger=False)
    t0 = time.perf_counter()
    with torch.enable_grad():
        trainer.fit(epochs=epochs, verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


def sa50_gate(device, root, epochs=60, seed=0):
    """Train (``train_gate``), export, reload on ``device`` and score;
    returns (SA50 per iteration, mSA per iteration, training seconds)."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.evaluation import mean_segmentation_accuracy
    from micro_sam_tpu_torch.evaluation.inference import iterative_prompting_segmentations
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training.training import export_instance_segmentation_model
    _, seconds = train_gate(device, root, epochs, seed)
    exported = str(root / "exported.pkl")
    export_instance_segmentation_model(str(root / "quality" / "best.pkl"), exported)
    predictor = util.get_sam_model(checkpoint_path=exported, device=str(device))
    n_iterations, sa50, msa = 3, np.zeros(3), np.zeros(3)
    np.random.seed(0)
    tests = [synthetic_data(shape=(S, S), seed=200 + i, n_objects=6) for i in range(2)]
    for image, gt in tests:
        util.set_precomputed(predictor, util.precompute_image_embeddings(predictor, image,
                                                                         verbose=False))
        segs = iterative_prompting_segmentations(predictor, gt.astype(np.uint32), False,
                                                 n_iterations=n_iterations)
        for it, seg in enumerate(segs):
            m, accs = mean_segmentation_accuracy(seg, gt, return_accuracies=True)
            sa50[it] += accs[0] / len(tests)
            msa[it] += m / len(tests)
    return sa50.tolist(), msa.tolist(), seconds


def test_warmup_cosine_matches_optax():
    import optax
    schedule = optax.warmup_cosine_decay_schedule(0.0, 6e-4, 100, 1500, 1e-5)
    for step in (0, 1, 50, 99, 100, 101, 800, 1499, 1500, 1600):
        assert abs(warmup_cosine(step) - float(schedule(step))) <= 1e-9


@pytest.mark.slow
def test_training_quality_threshold(tmp_path):
    sa50, msa, seconds = sa50_gate(torch.device("cpu"), tmp_path)
    print(f"SA50 per iteration: {[round(s, 4) for s in sa50]}; mSA {[round(m, 4) for m in msa]}; "
          f"training {seconds:.1f} s")
    assert sa50[0] > SA50_BAR, sa50
