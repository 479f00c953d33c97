"""Training entry points: the patch dataset and loaders, ``train_sam`` and
the hardware presets.

Counterpart of ``micro_sam_tpu/training/training.py`` for SAM finetuning
without the segmentation decoder. A numpy patch-sampling dataset stands in for
the torch_em data stack: patches with a minimum number of instances, 8-bit raw.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .. import util
from .sam_trainer import SamTrainer
from .util import ConvertToSamInputs, get_trainable_sam_model, require_8bit


def relabel_consecutive(segmentation: np.ndarray, start_label: int = 1):
    """Relabel to consecutive ids from ``start_label``, 0 staying background.
    Returns (relabeled, max_id, mapping); ``micro_sam_tpu.native.relabel_consecutive``."""
    seg = np.asarray(segmentation)
    if seg.dtype == bool:
        seg = seg.astype(np.uint32)
    ids = np.unique(seg)
    ids = ids[ids != 0]
    new_ids = np.arange(start_label, start_label + len(ids), dtype=seg.dtype)
    lookup = np.zeros(int(seg.max()) + 1 if seg.size else 1, dtype=seg.dtype)
    lookup[ids] = new_ids
    mapping = {0: 0}
    mapping.update({int(i): int(n) for i, n in zip(ids, new_ids)})
    return lookup[seg], (int(new_ids[-1]) if len(new_ids) else 0), mapping


class MinInstanceSampler:
    """Accept patches with at least ``min_num_instances`` objects (of at least
    ``min_size`` pixels)."""

    def __init__(self, min_num_instances: int = 2, min_size: Optional[int] = None):
        self.min_num_instances = min_num_instances
        self.min_size = min_size

    def __call__(self, raw, labels) -> bool:
        ids, sizes = np.unique(labels, return_counts=True)
        if self.min_size is not None:
            ids = ids[sizes >= self.min_size]
        return len(ids[ids != 0]) >= self.min_num_instances


class SamDataset:
    """Random patches of in-memory image / label arrays, relabeled
    consecutively, drawn until the sampler accepts one (at most
    ``max_sampling_attempts``). Items are (raw float32, labels)."""

    def __init__(self, raw_images: List[np.ndarray], label_images: List[np.ndarray],
                 patch_shape: Tuple[int, int], n_samples: Optional[int] = None,
                 raw_transform=None, sampler: Optional[MinInstanceSampler] = None,
                 max_sampling_attempts: int = 50, seed: int = 0):
        if len(raw_images) != len(label_images):
            raise ValueError("one label image per raw image")
        self.raw_images = [np.asarray(r) for r in raw_images]
        self.label_images = [np.asarray(lb) for lb in label_images]
        self.patch_shape = tuple(patch_shape)
        self.raw_transform = raw_transform or require_8bit
        self.sampler = sampler or MinInstanceSampler(2)
        self.max_sampling_attempts = max_sampling_attempts
        self._rng = np.random.RandomState(seed)
        self.n_samples = n_samples or max(1, sum(
            int(np.prod([max(1, s - p + 1) for s, p in zip(im.shape[:2], self.patch_shape)])
                ** 0.25) for im in self.raw_images))

    def __len__(self):
        return self.n_samples

    def _sample_patch(self):
        ph, pw = self.patch_shape
        for _ in range(self.max_sampling_attempts):
            idx = self._rng.randint(len(self.raw_images))
            raw, labels = self.raw_images[idx], self.label_images[idx]
            H, W = labels.shape[-2], labels.shape[-1]
            if H < ph or W < pw:
                continue
            y0 = self._rng.randint(0, H - ph + 1)
            x0 = self._rng.randint(0, W - pw + 1)
            raw_p = raw[..., y0:y0 + ph, x0:x0 + pw] if raw.ndim == 3 and raw.shape[0] in (1, 3) \
                else raw[y0:y0 + ph, x0:x0 + pw]
            lab_p = relabel_consecutive(labels[y0:y0 + ph, x0:x0 + pw])[0]
            if self.sampler(raw_p, lab_p):
                return raw_p, lab_p
        return raw_p, lab_p  # the last sample

    def __getitem__(self, i):
        raw, labels = self._sample_patch()
        return self.raw_transform(raw.astype(np.float32)), labels


class SamLoader:
    """Mini-batches (raw (B, ...), labels (B, H, W)) over a SamDataset (its
    patches are drawn at random, so there is nothing to shuffle)."""

    def __init__(self, dataset: SamDataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return max(1, len(self.dataset) // self.batch_size)

    def __iter__(self):
        for b in range(len(self)):
            items = [self.dataset[b * self.batch_size + k] for k in range(self.batch_size)]
            yield np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def _load_stack(paths, key) -> List[np.ndarray]:
    """Images as a list of arrays: an array or a list of arrays as they are; a
    directory with a glob pattern as ``key`` (every match, sorted), or file
    paths with an HDF5 ``key`` or none, through ``util.load_image_data``."""
    if isinstance(paths, np.ndarray):
        return [paths]
    if isinstance(paths, (list, tuple)) and isinstance(paths[0], np.ndarray):
        return list(paths)
    if isinstance(paths, (str, os.PathLike)):
        if os.path.isdir(paths):
            pattern = key or "*"
            files = sorted(glob.glob(os.path.join(str(paths), pattern)))
            if not files:
                raise ValueError(f"No files matching {pattern!r} in {paths}.")
            return [util.load_image_data(p) for p in files]
        paths = [paths]
    return [util.load_image_data(str(p), key) for p in paths]


def default_sam_dataset(raw_paths, raw_key, label_paths, label_key, patch_shape: Tuple[int, ...],
                        with_segmentation_decoder: bool = True, with_channels: bool = False,
                        sampler=None, raw_transform=None, n_samples: Optional[int] = None,
                        is_train: bool = True, min_size: int = 25,
                        max_sampling_attempts: Optional[int] = None, **kwargs) -> SamDataset:
    """The dataset for SAM training: patches of the last two dims of
    ``patch_shape``, at least two objects of ``min_size`` pixels each, drawn
    from seed 0 for training and 1 for validation. ``with_segmentation_decoder
    =True`` (distance targets for the UNETR decoder) is not ported and raises."""
    if with_segmentation_decoder:
        raise NotImplementedError(
            "with_segmentation_decoder=True needs the distance targets of the UNETR decoder, "
            "which is not ported yet; pass with_segmentation_decoder=False")
    return SamDataset(_load_stack(raw_paths, raw_key), _load_stack(label_paths, label_key),
                      tuple(patch_shape[-2:]), n_samples=n_samples, raw_transform=raw_transform,
                      sampler=sampler or MinInstanceSampler(2, min_size=min_size),
                      max_sampling_attempts=max_sampling_attempts or 50,
                      seed=0 if is_train else 1)


def default_sam_loader(batch_size: int = 1, shuffle: bool = True, **ds_kwargs) -> SamLoader:
    """A loader over ``default_sam_dataset(**ds_kwargs)``. ``shuffle`` is
    accepted for the reference's signature: the patches are drawn at random."""
    return SamLoader(default_sam_dataset(**ds_kwargs), batch_size=batch_size)


def _check_loader(loader, name: str) -> None:
    """Look at the first two batches: (raw, labels) pairs of 8-bit raw data
    with instances."""
    for n, batch in enumerate(loader):
        if len(batch) != 2:
            raise ValueError(f"the {name} loader must yield (raw, labels)")
        x, y = batch
        if np.asarray(x).max() <= 1.0 + 1e-6:
            raise ValueError("The raw data does not look like 8-bit images; normalize to [0, 255].")
        if len(np.unique(y[0])) <= 1:
            raise ValueError("A batch without instances was sampled.")
        if n >= 1:
            break


def train_sam(name: str, model_type: str, train_loader, val_loader, n_epochs: int = 100,
              n_objects_per_batch: Optional[int] = 25,
              checkpoint_path: Optional[Union[str, os.PathLike]] = None,
              with_segmentation_decoder: bool = True, freeze: Optional[List[str]] = None,
              device: Optional[str] = None, lr: float = 1e-5, n_sub_iteration: int = 8,
              save_root: Optional[str] = None, mask_prob: float = 0.5,
              n_iterations: Optional[int] = None, save_every_kth_epoch: Optional[int] = None,
              verify_n_labels_in_loader: Optional[int] = 50,
              box_distortion_factor: Optional[float] = 0.025, overwrite_training: bool = True,
              compute_dtype: Optional[str] = None) -> None:
    """Finetune SAM with iterative prompting; checkpoints go to
    ``<save_root>/<name>/{latest,best}.pkl`` (the JAX trainer's format).

    ``device=None`` is the GPU and raises without one (the tests pass
    ``device="cpu"``). ``with_segmentation_decoder=True`` (joint training of
    the UNETR instance decoder) is not ported yet and raises."""
    if with_segmentation_decoder:
        raise NotImplementedError(
            "with_segmentation_decoder=True needs the UNETR decoder and the joint trainer, "
            "which are not ported yet; pass with_segmentation_decoder=False")
    t_start = time.time()
    if verify_n_labels_in_loader:
        _check_loader(train_loader, "train")
        _check_loader(val_loader, "val")
    save_dir = os.path.join(save_root or "./checkpoints", name)
    if not overwrite_training and os.path.exists(os.path.join(save_dir, "best.pkl")):
        print(f"Training {name} is already finished; skipping (overwrite_training=False).")
        return
    model = get_trainable_sam_model(model_type=model_type, device=device,
                                    checkpoint_path=checkpoint_path, freeze=freeze,
                                    compute_dtype=compute_dtype)
    trainer = SamTrainer(
        name=name, train_loader=train_loader, val_loader=val_loader, model=model,
        n_sub_iteration=n_sub_iteration,
        n_objects_per_batch=n_objects_per_batch,
        convert_inputs=ConvertToSamInputs(box_distortion_factor=box_distortion_factor),
        mask_prob=mask_prob, save_root=save_root, lr=lr)
    if n_iterations is not None:
        trainer.fit(iterations=n_iterations, save_every_kth_epoch=save_every_kth_epoch)
    else:
        trainer.fit(epochs=n_epochs, save_every_kth_epoch=save_every_kth_epoch)
    print(f"Training took {time.time() - t_start:.1f}s")


# Hardware presets: the JAX package's table (its TPU entries included, so that
# a configuration name means the same in both packages).
CONFIGURATIONS: Dict[str, Dict[str, Any]] = {
    "Minimal": {"model_type": "vit_t", "n_objects_per_batch": 4, "n_sub_iteration": 4},
    "CPU": {"model_type": "vit_b", "n_objects_per_batch": 10},
    "gtx1080": {"model_type": "vit_t", "n_objects_per_batch": 5},
    "rtx5000": {"model_type": "vit_b", "n_objects_per_batch": 10},
    "V100": {"model_type": "vit_b", "n_objects_per_batch": 10},
    "A100": {"model_type": "vit_h", "n_objects_per_batch": 25},
    "v5e": {"model_type": "vit_b", "n_objects_per_batch": 25},
    "v5p": {"model_type": "vit_h", "n_objects_per_batch": 25},
}


def _find_best_configuration() -> str:
    """"A100" where a GPU is available, else "CPU" (the JAX package's choice
    for those platforms)."""
    import torch
    return "A100" if torch.cuda.is_available() else "CPU"


def train_sam_for_configuration(name: str, configuration: str, train_loader, val_loader,
                                checkpoint_path=None, with_segmentation_decoder: bool = True,
                                model_type: Optional[str] = None, **kwargs) -> None:
    """``train_sam`` with a hardware preset of ``CONFIGURATIONS``: its model
    type (unless ``model_type`` is given) and its settings, which ``kwargs``
    override."""
    if configuration not in CONFIGURATIONS:
        raise ValueError(f"Invalid configuration {configuration} expect one of "
                         f"{list(CONFIGURATIONS)}")
    train_kwargs = dict(CONFIGURATIONS[configuration])
    preset_model = train_kwargs.pop("model_type")
    train_kwargs.update(**kwargs)
    train_sam(name=name, train_loader=train_loader, val_loader=val_loader,
              checkpoint_path=checkpoint_path, with_segmentation_decoder=with_segmentation_decoder,
              model_type=model_type or preset_model, **train_kwargs)
