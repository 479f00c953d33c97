"""Training utilities: the trainable model, ground truth -> prompts, raw
transforms (counterpart of ``micro_sam_tpu/training/util.py``)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import util
from ..prompt_generators import PointAndBoxPromptGenerator
from .trainable_sam import TrainableSAM

FREEZABLE = ("image_encoder", "prompt_encoder", "mask_decoder")


def identity(x):
    """The identity transform."""
    return x


def require_8bit(x):
    """Scale data in [0, 1) to the 8-bit range."""
    if x.max() < 1:
        x = x * 255
    return x


def normalize(raw, minval=None, maxval=None):
    raw = raw.astype("float32")
    minval = raw.min() if minval is None else minval
    maxval = raw.max() if maxval is None else maxval
    raw -= minval
    scale = maxval - minval
    if scale > 0:
        raw /= scale
    return raw


def normalize_to_8bit(raw):
    return normalize(raw) * 255


def normalize_percentile(raw, lower=1.0, upper=99.0):
    v_lower, v_upper = np.percentile(raw, [lower, upper])
    return normalize(raw, v_lower, v_upper)


def to_rgb(image: np.ndarray) -> np.ndarray:
    """A channel-first 3-channel image: a 2d or 1-channel image repeated."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[None]
    if image.shape[0] == 1:
        image = np.concatenate([image] * 3, axis=0)
    return image


def _percentile_to_8bit(raw):
    return np.clip(normalize_percentile(raw), 0, 1) * 255


def get_raw_transform(preprocess: Optional[str] = None):
    """The raw-data transform: ``None`` passes 8-bit data through
    (``require_8bit``), ``normalize_minmax`` / ``normalize_percentile``
    rescale to [0, 255]."""
    if preprocess is None:
        return require_8bit
    if preprocess == "normalize_minmax":
        return normalize_to_8bit
    if preprocess == "normalize_percentile":
        return _percentile_to_8bit
    raise ValueError(f"'{preprocess}' is not a supported preprocessing.")


def _center_pad_width(desired_shape, shape):
    """Per axis (before, after): the larger half of the gap before."""
    out = []
    for want, have in zip(desired_shape, shape):
        gap = max(want - have, 0)
        out.append((int(np.ceil(gap / 2)), gap // 2))
    return out


class ResizeRawTrafo:
    """Raw data padded (and with ``do_rescaling`` rescaled to [0, 255] by
    percentiles) to ``desired_shape``; 3 channels first when ``ensure_rgb``."""

    def __init__(self, desired_shape: Tuple[int, ...], do_rescaling: bool = False,
                 valid_channels=None, padding: str = "constant", ensure_rgb: bool = True):
        self.desired_shape = tuple(desired_shape)
        self.do_rescaling = do_rescaling
        self.valid_channels = valid_channels
        self.padding = padding
        self.ensure_rgb = ensure_rgb

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw)
        if self.ensure_rgb:
            raw = to_rgb(raw)
        if self.do_rescaling:
            raw = normalize(normalize_percentile(raw)) * 255
        raw = np.pad(raw, _center_pad_width(self.desired_shape, raw.shape), mode=self.padding)
        if raw.shape != self.desired_shape:
            raise ValueError(f"raw data of shape {raw.shape} does not pad to {self.desired_shape}")
        return raw


class ResizeLabelTrafo:
    """Labels -> the four channels of ``PerObjectDistanceTransform(instances=
    True)`` (instances, foreground, center and boundary distances), padded to
    the 2d ``desired_shape``."""

    def __init__(self, desired_shape: Tuple[int, ...], min_size: int = 0,
                 padding: str = "constant"):
        self.desired_shape = tuple(desired_shape)
        self.min_size = min_size
        self.padding = padding

    def __call__(self, labels: np.ndarray) -> np.ndarray:
        from .training import PerObjectDistanceTransform
        channels = PerObjectDistanceTransform(instances=True, min_size=self.min_size)(labels)
        pad = [(0, 0)] + _center_pad_width(self.desired_shape, channels.shape[1:])
        channels = np.pad(channels, pad, mode=self.padding)
        if channels.shape[1:] != self.desired_shape:
            raise ValueError(f"targets of shape {channels.shape} do not pad to "
                             f"{self.desired_shape}")
        return channels


def get_trainable_sam_model(model_type: str = util._DEFAULT_MODEL, device: Optional[str] = None,
                            checkpoint_path=None, freeze: Optional[List[str]] = None,
                            return_state: bool = False, compute_dtype: Optional[str] = None,
                            seed: int = 0, peft_kwargs: Optional[Dict] = None
                            ) -> Union[TrainableSAM, Tuple[TrainableSAM, Dict]]:
    """A SAM to finetune: every parameter float32 (int4 storage aside),
    compute in ``compute_dtype`` (bfloat16 on the GPU, float32 on the CPU by
    default). ``device=None`` is the GPU and raises without one. ``freeze``
    lists parts to freeze (of ``FREEZABLE``): their parameters stop requiring
    grad, so the optimizer neither updates nor decays them. ``peft_kwargs``
    applies a PEFT surgery (``util.get_sam_model``) and freezes the encoder's
    base weights by ``models.peft_sam.get_peft_mask``, as upstream's
    ``PEFT_Sam`` does (the JAX trainer trains them)."""
    bad = set(freeze or []) - set(FREEZABLE)
    if bad:
        raise ValueError(f"cannot freeze {sorted(bad)}; options: {FREEZABLE}")
    sam, state, _ = util.load_sam(model_type, device, checkpoint_path, compute_dtype, seed,
                                  weight_dtype=torch.float32, peft_kwargs=peft_kwargs)
    if peft_kwargs:
        from ..models.peft_sam import freeze_peft_, get_peft_mask
        freeze_peft_(sam, get_peft_mask(sam, peft_kwargs.get("peft_module", "lora"),
                                        peft_kwargs.get("unfreeze_blocks")))
    for part in freeze or []:
        getattr(sam, part).requires_grad_(False)
    trainable = TrainableSAM(sam.train())
    return (trainable, state) if return_state else trainable


def freeze_mask(sam, freeze: Optional[List[str]]) -> Dict[str, bool]:
    """Which of ``sam``'s state-dict entries train under ``freeze``: {name:
    bool}, False under each frozen top-level part (the JAX package's optax
    mask under the converter's names). ``freeze`` itself is realized as
    ``requires_grad_(False)`` (``get_trainable_sam_model``)."""
    frozen = set(freeze or [])
    return {k: k.split(".")[0] not in frozen for k in sam.state_dict()}


class ConvertToSamInputs:
    """Ground-truth instance segmentation -> object masks and prompts.

    Called with a numpy batch (image (B, H, W, C) or (B, C, H, W), labels
    (B, H, W)); returns torch tensors on the CPU:
    (images (B, H, W, 3) f32, gt (B, O, H, W) f32, obj_valid (B, O) bool,
    points (B, O, P, 2) xy f32, point_labels (B, O, P) int32, boxes (B, O, 4) xyxy f32).
    With ``sample_seeds`` each image draws from its own ``RandomState``, so the
    objects and prompts of an image do not depend on the batch around it.
    """

    supports_sample_seeds = True

    def __init__(self, dilation_strength: int = 10, box_distortion_factor: Optional[float] = 0.025,
                 rng: Optional[np.random.RandomState] = None):
        self.dilation_strength = dilation_strength
        self.box_distortion_factor = box_distortion_factor
        self._rng = rng or np.random.RandomState()

    def _distort_boxes(self, bbox_coordinates, shape, rng):
        out = []
        sf = self.box_distortion_factor
        for bbox in bbox_coordinates:  # (y0, x0, y1, x1)
            length = [bbox[3] - bbox[1], bbox[2] - bbox[0]]
            y0 = min(shape[0], max(0, bbox[0] + rng.uniform(-sf, sf) * length[1]))
            x0 = min(shape[1], max(0, bbox[1] + rng.uniform(-sf, sf) * length[0]))
            y1 = min(shape[0], max(0, bbox[2] + rng.uniform(-sf, sf) * length[1]))
            x1 = min(shape[1], max(0, bbox[3] + rng.uniform(-sf, sf) * length[0]))
            out.append([y0, x0, y1, x1])
        return out

    def _get_prompt_lists(self, gt, n_samples, prompt_generator, rng):
        centers_all, bboxes_all = util.get_centers_and_bounding_boxes(gt)
        cell_ids = np.unique(gt)[1:]
        if n_samples is not None and len(cell_ids) > n_samples:
            cell_ids = np.sort(rng.choice(cell_ids, size=n_samples, replace=False))
        centers = [centers_all.get(int(i)) for i in cell_ids]
        bboxes = [(bboxes_all[int(i)][0][0], bboxes_all[int(i)][1][0],
                   bboxes_all[int(i)][0][1], bboxes_all[int(i)][1][1]) for i in cell_ids]
        if self.box_distortion_factor is not None:
            bboxes = self._distort_boxes(bboxes, shape=gt.shape[-2:], rng=rng)
        object_masks = np.stack([gt == i for i in cell_ids])[:, None].astype(np.float32)
        point_coords, point_labels, box_prompts, _ = prompt_generator(
            object_masks, [tuple(int(v) for v in b) for b in bboxes], centers)
        if box_prompts is None and bboxes:
            box_prompts = np.array(bboxes)[:, [1, 0, 3, 2]]
        return cell_ids, object_masks[:, 0], point_coords, point_labels, box_prompts

    @staticmethod
    def images(x) -> np.ndarray:
        """A batch of images as (B, H, W, 3): a channel axis added, NCHW moved
        to NHWC, one channel repeated to three."""
        x = np.asarray(x)
        if x.ndim == 3:
            x = x[..., None]
        if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
            x = np.moveaxis(x, 1, -1)  # NCHW -> NHWC
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        return x

    def __call__(self, x, y, n_pos: int = 1, n_neg: int = 0, get_boxes: bool = False,
                 n_samples: Optional[int] = None, n_objects: Optional[int] = None,
                 get_points: bool = True, sample_seeds: Optional[Sequence[int]] = None):
        n_samples = n_objects if n_samples is None else n_samples
        x, y = self.images(x), np.asarray(y)
        B, H, W = y.shape[0], y.shape[-2], y.shape[-1]
        y2d = y.reshape(B, H, W)
        if sample_seeds is not None and len(sample_seeds) != B:
            raise ValueError(f"sample_seeds must have one entry per image "
                             f"({len(sample_seeds)} given for batch {B})")

        def make_generator(rng):
            return PointAndBoxPromptGenerator(
                n_positive_points=max(n_pos, 1) if get_points else 1, n_negative_points=n_neg,
                dilation_strength=self.dilation_strength, get_point_prompts=True,
                get_box_prompts=True, rng=rng)

        shared = make_generator(self._rng)
        per_image = []
        for b in range(B):
            gt = y2d[b]
            if len(np.unique(gt)) <= 1:
                per_image.append(None)
                continue
            if sample_seeds is None:
                rng, generator = self._rng, shared
            else:
                rng = np.random.RandomState(int(sample_seeds[b]) & 0xFFFFFFFF)
                generator = make_generator(rng)
            per_image.append(self._get_prompt_lists(gt, n_samples, generator, rng))
        max_o = max((len(r[0]) for r in per_image if r is not None), default=0)
        if max_o == 0:
            return None
        O = min(max_o, n_samples) if n_samples else max_o
        P = (max(n_pos, 1) if get_points else 1) + n_neg
        gt_out = np.zeros((B, O, H, W), np.float32)
        valid = np.zeros((B, O), bool)
        points = np.zeros((B, O, P, 2), np.float32)
        plabels = -np.ones((B, O, P), np.int32)
        boxes = np.zeros((B, O, 4), np.float32)
        for b, res in enumerate(per_image):
            if res is None:
                continue
            ids, masks, pc, pl, bx = res
            k = min(len(ids), O)
            gt_out[b, :k] = masks[:k]
            valid[b, :k] = True
            if pc is not None:
                points[b, :k, :pc.shape[1]] = pc[:k]
                plabels[b, :k, :pl.shape[1]] = pl[None, :].repeat(k, 0) if pl.ndim == 1 else pl[:k]
            if bx is not None:
                boxes[b, :k] = np.asarray(bx)[:k]
        return tuple(torch.from_numpy(a) for a in
                     (x.astype(np.float32), gt_out, valid, points, plabels, boxes))


class ConvertToSemanticSamInputs:
    """Inputs of semantic training: no prompts, the labels are per-pixel class
    maps. Returns (images (B, H, W, 3) float32, labels) torch tensors on the
    CPU."""

    def __call__(self, x, y):
        x = np.asarray(x)
        if x.ndim == 3:
            x = x[..., None]
        if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
            x = np.moveaxis(x, 1, -1)  # NCHW -> NHWC
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)), \
            torch.from_numpy(np.asarray(y))
