"""Training entry points: the patch dataset and loaders, the distance
targets of the segmentation decoder, ``train_sam``, the hardware presets, the
export of a trained model and the ``micro_sam_tpu_torch.train`` command line.

Counterpart of ``micro_sam_tpu/training/training.py``. A numpy patch-sampling
dataset stands in for the torch_em data stack: patches with a minimum number
of instances, 8-bit raw, and per-object distance targets for joint training
of the UNETR decoder (the JAX package's ``PerObjectDistanceTransform``).
"""
from __future__ import annotations

import glob
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
from scipy import ndimage

from .. import util
from .joint_sam_trainer import JointSamTrainer
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


class PerObjectDistanceTransform:
    """Per-object target channels [foreground, center distance, boundary
    distance] (with ``instances`` the labels first). Within each object of at
    least ``min_size`` pixels: the center distance is the Euclidean distance
    to the object's innermost point (the first argmax of its distance
    transform), divided by its largest value in the object; the boundary
    distance is 1 - edt / max(edt), 0 at the innermost point. Both are 1
    outside the objects. The other arguments are accepted for the reference's
    signature."""

    def __init__(self, distances=True, boundary_distances=True, directed_distances=False,
                 foreground=True, instances=False, min_size: int = 25):
        self.min_size = min_size
        self.instances = instances

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels).astype(np.int64)
        fg = (labels > 0).astype(np.float32)
        center_dist = np.ones(labels.shape, dtype=np.float32)
        boundary_dist = np.ones(labels.shape, dtype=np.float32)
        for sl, label_id in _iter_objects(labels, self.min_size):
            mask = labels[sl] == label_id
            edt = ndimage.distance_transform_edt(mask)
            m = edt.max()
            bdist = 1.0 - edt / m if m > 0 else np.zeros_like(edt)
            cy, cx = np.unravel_index(np.argmax(edt), edt.shape)
            yy, xx = np.meshgrid(np.arange(mask.shape[0]), np.arange(mask.shape[1]), indexing="ij")
            cdist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            cdist = cdist / max(cdist[mask].max(), 1e-7)
            center_dist[sl][mask] = cdist[mask].astype(np.float32)
            boundary_dist[sl][mask] = bdist[mask].astype(np.float32)
        out = [fg, center_dist, boundary_dist]
        if self.instances:
            out = [labels.astype(np.float32)] + out
        return np.stack(out)


def _iter_objects(labels, min_size):
    """(bounding-box slice, id) of every object of at least ``min_size`` pixels."""
    for label_id, sl in enumerate(ndimage.find_objects(labels), start=1):
        if sl is not None and (labels[sl] == label_id).sum() >= min_size:
            yield sl, label_id


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
    ``max_sampling_attempts``). Items are (raw float32, labels), with
    ``with_segmentation_decoder`` (raw, labels, targets): ``label_transform``
    of the labels, by default ``PerObjectDistanceTransform()``."""

    def __init__(self, raw_images: List[np.ndarray], label_images: List[np.ndarray],
                 patch_shape: Tuple[int, int], n_samples: Optional[int] = None,
                 with_segmentation_decoder: bool = False, raw_transform=None,
                 label_transform=None, sampler: Optional[MinInstanceSampler] = None,
                 max_sampling_attempts: int = 50, seed: int = 0):
        if len(raw_images) != len(label_images):
            raise ValueError("one label image per raw image")
        self.raw_images = [np.asarray(r) for r in raw_images]
        self.label_images = [np.asarray(lb) for lb in label_images]
        self.patch_shape = tuple(patch_shape)
        self.with_segmentation_decoder = with_segmentation_decoder
        self.raw_transform = raw_transform or require_8bit
        self.label_transform = label_transform or (
            PerObjectDistanceTransform() if with_segmentation_decoder else None)
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
        raw = self.raw_transform(raw.astype(np.float32))
        if self.with_segmentation_decoder:
            return raw, labels, self.label_transform(labels)
        return raw, labels

    def split(self, n_val: int):
        """(train, val) datasets over the same images, ``n_val`` samples (at
        least 1, at most all but one) to validation, which draws from seed 1
        (the training widget's split, as the JAX package's)."""
        import copy
        n_val = max(1, min(n_val, len(self) - 1))
        train = copy.copy(self)
        val = copy.copy(self)
        train.n_samples = len(self) - n_val
        val.n_samples = n_val
        val._rng = np.random.RandomState(1)
        return train, val


class SamLoader:
    """Mini-batches (raw (B, ...), labels (B, H, W)[, targets (B, C, H, W)])
    over a SamDataset (its patches are drawn at random, so there is nothing to
    shuffle)."""

    def __init__(self, dataset: SamDataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return max(1, len(self.dataset) // self.batch_size)

    def __iter__(self):
        for b in range(len(self)):
            items = [self.dataset[b * self.batch_size + k] for k in range(self.batch_size)]
            yield tuple(np.stack(parts) for parts in zip(*items))


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
    from seed 0 for training and 1 for validation; with
    ``with_segmentation_decoder`` each item carries the distance targets of
    the UNETR decoder."""
    return SamDataset(_load_stack(raw_paths, raw_key), _load_stack(label_paths, label_key),
                      tuple(patch_shape[-2:]), n_samples=n_samples,
                      with_segmentation_decoder=with_segmentation_decoder,
                      raw_transform=raw_transform,
                      sampler=sampler or MinInstanceSampler(2, min_size=min_size),
                      max_sampling_attempts=max_sampling_attempts or 50,
                      seed=0 if is_train else 1)


def default_sam_loader(batch_size: int = 1, shuffle: bool = True, **ds_kwargs) -> SamLoader:
    """A loader over ``default_sam_dataset(**ds_kwargs)``. ``shuffle`` is
    accepted for the reference's signature: the patches are drawn at random."""
    return SamLoader(default_sam_dataset(**ds_kwargs), batch_size=batch_size)


def _check_loader(loader, with_segmentation_decoder: bool, name: str) -> None:
    """Look at the first two batches: (raw, labels) pairs, or with the
    segmentation decoder (raw, labels, targets) with 3 or 4 target channels,
    of 8-bit raw data with instances."""
    for n, batch in enumerate(loader):
        if with_segmentation_decoder:
            if len(batch) != 3:
                raise ValueError(f"the {name} loader must yield (raw, labels, distance_targets) "
                                 "for training with the segmentation decoder")
            x, y, t = batch
            if np.asarray(t).shape[1] not in (3, 4):
                raise ValueError(f"Expected 3 or 4 target channels, got {np.asarray(t).shape[1]}.")
        else:
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
              compute_dtype: Optional[str] = None, peft_kwargs: Optional[Dict] = None) -> None:
    """Finetune SAM with iterative prompting; checkpoints go to
    ``<save_root>/<name>/{latest,best}.pkl`` (the JAX trainer's format).

    With ``with_segmentation_decoder`` (the default) the UNETR instance
    decoder trains beside SAM (``JointSamTrainer``), from the checkpoint's
    decoder state where it has one, and the loaders must yield (raw, labels,
    targets). ``device=None`` is the GPU and raises without one (the tests
    pass ``device="cpu"``). ``peft_kwargs`` finetunes with that PEFT surgery
    (``get_trainable_sam_model``): the encoder's base weights stay frozen."""
    t_start = time.time()
    if verify_n_labels_in_loader:
        _check_loader(train_loader, with_segmentation_decoder, "train")
        _check_loader(val_loader, with_segmentation_decoder, "val")
    save_dir = os.path.join(save_root or "./checkpoints", name)
    if not overwrite_training and os.path.exists(os.path.join(save_dir, "best.pkl")):
        print(f"Training {name} is already finished; skipping (overwrite_training=False).")
        return
    model, state = get_trainable_sam_model(model_type=model_type, device=device,
                                           checkpoint_path=checkpoint_path, freeze=freeze,
                                           compute_dtype=compute_dtype, return_state=True,
                                           peft_kwargs=peft_kwargs)
    trainer_kwargs = dict(
        name=name, train_loader=train_loader, val_loader=val_loader, model=model,
        n_sub_iteration=n_sub_iteration,
        n_objects_per_batch=n_objects_per_batch,
        convert_inputs=ConvertToSamInputs(box_distortion_factor=box_distortion_factor),
        mask_prob=mask_prob, save_root=save_root, lr=lr)
    if with_segmentation_decoder:
        from ..instance_segmentation import get_unetr
        unetr = get_unetr(decoder_state=state.get("decoder_state"), device=model.device,
                          flexible_load_checkpoint=True)
        trainer = JointSamTrainer(unetr=unetr, **trainer_kwargs)
    else:
        trainer = SamTrainer(**trainer_kwargs)
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


def train_instance_segmentation(name: str, model_type: str, train_loader, val_loader,
                                **kwargs) -> None:
    """Train the UNETR instance decoder alone: ``train_sam`` with the
    segmentation decoder and SAM's three parts frozen (unless ``freeze`` is
    given). A frozen parameter stays as it is, to the bit."""
    kwargs.setdefault("freeze", ["image_encoder", "prompt_encoder", "mask_decoder"])
    train_sam(name=name, model_type=model_type, train_loader=train_loader,
              val_loader=val_loader, with_segmentation_decoder=True, **kwargs)


def export_instance_segmentation_model(checkpoint_path: Optional[str] = None,
                                       output_path: Optional[str] = None,
                                       model_type: Optional[str] = None,
                                       trained_model_path: Optional[str] = None,
                                       initial_checkpoint_path: Optional[str] = None) -> None:
    """A trainer checkpoint -> the standalone pickle that ``get_sam_model``
    and ``get_predictor_and_segmenter`` load: ``model_state``, ``model_type``,
    ``model_config`` and ``decoder_state`` where the checkpoint has them.
    ``trained_model_path`` is the reference's name for ``checkpoint_path``;
    ``initial_checkpoint_path`` is accepted for the reference's signature
    (the export holds every weight). A host-side file conversion: a trusted
    pickle in, a pickle out."""
    checkpoint_path = checkpoint_path or trained_model_path
    if checkpoint_path is None or output_path is None:
        raise ValueError("checkpoint_path/trained_model_path and output_path are required")
    with open(checkpoint_path, "rb") as f:
        state = pickle.load(f)
    out = {"model_state": state["model_state"], "model_type": state.get("model_type", model_type)}
    for key in ("model_config", "decoder_state"):
        if key in state:
            out[key] = state[key]
    with open(output_path, "wb") as f:
        pickle.dump(out, f)


def _export_helper(save_root, checkpoint_name, output_path, model_type,
                   with_segmentation_decoder, val_loader=None):
    """Export ``<save_root>/<checkpoint_name>/best.pkl`` to ``output_path``."""
    checkpoint_path = os.path.join(save_root or "./checkpoints", checkpoint_name, "best.pkl")
    export_instance_segmentation_model(checkpoint_path, output_path, model_type)
    return output_path


def main(argv: Optional[List[str]] = None):
    """The ``micro_sam_tpu_torch.train`` command line: finetune SAM (with the
    segmentation decoder unless told otherwise) on image / label files and
    optionally export the best checkpoint. ``-d cpu`` trains on the CPU;
    without it the GPU."""
    import argparse

    parser = argparse.ArgumentParser(description="Finetune SAM models on microscopy data.")
    parser.add_argument("--name", "--trained_model_name", dest="name", default="sam_model",
                        help="Checkpoint name of the finetuned model.")
    parser.add_argument("--images", required=True, nargs="+", help="Image file paths or glob.")
    parser.add_argument("--labels", required=True, nargs="+", help="Label file paths or glob.")
    parser.add_argument("--image_key", default=None)
    parser.add_argument("--label_key", default=None)
    parser.add_argument("--val_images", nargs="*", default=None,
                        help="Validation image paths (default: a fraction of --images).")
    parser.add_argument("--val_labels", nargs="*", default=None)
    parser.add_argument("--val_image_key", default=None)
    parser.add_argument("--val_label_key", default=None)
    parser.add_argument("--val_fraction", type=float, default=0.1)
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL)
    parser.add_argument("-c", "--checkpoint_path", default=None)
    parser.add_argument("--patch_shape", nargs="+", type=int, default=[512, 512])
    parser.add_argument("--n_epochs", type=int, default=100)
    parser.add_argument("--num_workers", type=int, default=1,
                        help="Accepted for the reference's flag set; loading is in-process.")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--preprocess", default=None,
                        choices=("normalize_minmax", "normalize_percentile"),
                        help="Raw-data normalization before training.")
    parser.add_argument("--n_objects_per_batch", type=int, default=25)
    parser.add_argument("--segmentation_decoder", default="instances",
                        help="'instances' trains the extra decoder, 'none' disables it.")
    parser.add_argument("--without_segmentation_decoder", action="store_true")
    parser.add_argument("--configuration", default=None)
    parser.add_argument("-s", "--save_root", default=None)
    parser.add_argument("-d", "--device", default=None,
                        help="'cuda' (the default) or 'cpu'.")
    parser.add_argument("--export_path", "--output_path", dest="export_path", default=None,
                        help="Where to export the trained model.")
    args = parser.parse_args(argv)

    def expand(paths):
        out = []
        for p in paths:
            out.extend(sorted(glob.glob(p)) if any(c in p for c in "*?[") else [p])
        return out

    image_paths, label_paths = expand(args.images), expand(args.labels)
    if len(image_paths) != len(label_paths):
        raise ValueError(f"{len(image_paths)} images but {len(label_paths)} label images")
    if args.val_images:
        train_images, train_labels = image_paths, label_paths
        val_images, val_labels = expand(args.val_images), expand(args.val_labels)
        val_keys = dict(raw_key=args.val_image_key or args.image_key,
                        label_key=args.val_label_key or args.label_key)
    else:
        n_val = max(1, int(len(image_paths) * args.val_fraction))
        train_images, val_images = image_paths[:-n_val] or image_paths, image_paths[-n_val:]
        train_labels, val_labels = label_paths[:-n_val] or label_paths, label_paths[-n_val:]
        val_keys = dict(raw_key=args.image_key, label_key=args.label_key)

    with_decoder = (not args.without_segmentation_decoder
                    and str(args.segmentation_decoder).lower() not in ("none", ""))
    loader_kwargs = dict(patch_shape=tuple(args.patch_shape),
                         with_segmentation_decoder=with_decoder, batch_size=args.batch_size)
    if args.preprocess is not None:
        from .util import get_raw_transform
        loader_kwargs["raw_transform"] = get_raw_transform(args.preprocess)
    train_loader = default_sam_loader(raw_paths=train_images, label_paths=train_labels,
                                      raw_key=args.image_key, label_key=args.label_key,
                                      **loader_kwargs)
    val_loader = default_sam_loader(raw_paths=val_images, label_paths=val_labels, **val_keys,
                                    **loader_kwargs)
    common = dict(name=args.name, train_loader=train_loader, val_loader=val_loader,
                  checkpoint_path=args.checkpoint_path, with_segmentation_decoder=with_decoder,
                  n_epochs=args.n_epochs, save_root=args.save_root, device=args.device)
    if args.configuration:
        train_sam_for_configuration(configuration=args.configuration, **common)
    else:
        train_sam(model_type=args.model_type, n_objects_per_batch=args.n_objects_per_batch,
                  **common)
    if args.export_path:
        _export_helper(args.save_root, args.name, args.export_path, args.model_type,
                       with_decoder)


if __name__ == "__main__":
    main()
