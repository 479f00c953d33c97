"""Qualitative side-by-side comparison of two/three models: counterpart of
the JAX package's ``evaluation/model_comparison.py`` (upstream
micro_sam/evaluation/model_comparison.py).

Workflow: ``generate_data_for_model_comparison`` runs identical per-object
point and box prompts through each model and stores everything in per-sample
h5 files; ``model_comparison`` scores every object (IoU vs ground truth per
model), ranks objects by each model's ADVANTAGE (its IoU minus the other's)
and renders square crops of the most discriminative objects with the prompts
overlaid; ``model_comparison_with_napari`` browses the raw per-object masks
interactively (requires napari).

h5 layout per sample file:
    image                  raw image
    gt                     full ground-truth label image
    <model>/points|box     full per-model label images (quick-look)
    objects/<gt_id>/gt_mask
    objects/<gt_id>/points/mask<k>, box/mask<k>   per-model object masks
    objects/<gt_id>.attrs: point_coords, point_labels, box

``h5py`` and ``matplotlib`` are imported at the call. The models are built
on the card unless ``device`` is given.
"""
from __future__ import annotations

import os
from functools import partial
from glob import glob
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from .. import util
from ..prompt_based_segmentation import segment_from_box, segment_from_points
from ..prompt_generators import PointAndBoxPromptGenerator
from .matching import mean_segmentation_accuracy


def _load_predictors(model_types, checkpoints, peft_kwargs=None, device=None):
    predictors, names = [], []
    peft_kwargs = peft_kwargs or (None,) * len(model_types)
    for model_type, ckpt, peft in zip(model_types, checkpoints, peft_kwargs):
        if model_type is None:
            continue
        predictors.append(util.get_sam_model(
            model_type=model_type, checkpoint_path=ckpt, peft_kwargs=peft, device=device))
        names.append(model_type)
    return predictors, names


def _segment_object(predictor, emb, center, box):
    """One object with a point and a box prompt; returns (point_mask, box_mask)."""
    mask_point = segment_from_points(
        predictor, np.array([center]), np.array([1]), image_embeddings=emb)
    mask_box = segment_from_box(predictor, box, image_embeddings=emb)
    return np.asarray(mask_point[0]), np.asarray(mask_box[0])


def generate_data_for_model_comparison(
    loader,
    output_folder: Union[str, os.PathLike],
    model_type1: str,
    model_type2: str,
    n_samples: int,
    model_type3: Optional[str] = None,
    checkpoint1: Optional[str] = None,
    checkpoint2: Optional[str] = None,
    checkpoint3: Optional[str] = None,
    peft_kwargs1: Optional[Dict] = None,
    peft_kwargs2: Optional[Dict] = None,
    peft_kwargs3: Optional[Dict] = None,
    device: Optional[str] = None,
) -> None:
    """Predict identical prompts with 2-3 models into per-sample h5 files
    (reference model_comparison.py:117)."""
    import h5py
    os.makedirs(output_folder, exist_ok=True)
    # kept for API parity; prompts here are object centers + gt boxes
    PointAndBoxPromptGenerator(
        n_positive_points=1, n_negative_points=0, dilation_strength=3,
        get_point_prompts=True, get_box_prompts=True,
    )
    predictors, names = _load_predictors(
        (model_type1, model_type2, model_type3),
        (checkpoint1, checkpoint2, checkpoint3),
        (peft_kwargs1, peft_kwargs2, peft_kwargs3), device,
    )

    for sample_idx, (image, gt) in enumerate(loader):
        if sample_idx >= n_samples:
            break
        image = np.asarray(image[0] if image.ndim == 4 else image)
        gt = np.asarray(gt[0] if np.asarray(gt).ndim == 3 and gt.shape[0] == 1 else gt)

        gt_ids = np.unique(gt)[1:]
        if len(gt_ids) == 0:
            continue
        centers, bboxes = util.get_centers_and_bounding_boxes(gt)
        embeddings = [
            util.precompute_image_embeddings(pred, image, ndim=2, verbose=False)
            for pred in predictors
        ]

        with h5py.File(os.path.join(output_folder, f"sample{sample_idx}.h5"), "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("gt", data=gt)
            full_point = [np.zeros_like(gt, dtype="uint32") for _ in predictors]
            full_box = [np.zeros_like(gt, dtype="uint32") for _ in predictors]

            for gt_id in gt_ids:
                center = centers[int(gt_id)]
                bb = bboxes[int(gt_id)]
                box = np.array([bb[0][0], bb[1][0], bb[0][1], bb[1][1]])

                obj = f.create_group(f"objects/{int(gt_id)}")
                obj.create_dataset("gt_mask", data=(gt == gt_id), compression="gzip")
                obj.attrs["point_coords"] = np.array([center], dtype="float64")
                obj.attrs["point_labels"] = np.array([1], dtype="int64")
                obj.attrs["box"] = box.astype("float64")

                for k, (pred, emb) in enumerate(zip(predictors, embeddings), start=1):
                    m_pt, m_bx = _segment_object(pred, emb, center, box)
                    obj.create_dataset(f"points/mask{k}", data=m_pt, compression="gzip")
                    obj.create_dataset(f"box/mask{k}", data=m_bx, compression="gzip")
                    full_point[k - 1][m_pt] = int(gt_id)
                    full_box[k - 1][m_bx] = int(gt_id)

            for k, name in enumerate(names):
                group_name = name.replace("/", "_")
                if group_name in f:  # same model_type compared against itself
                    group_name = f"{group_name}-{k + 1}"
                g = f.create_group(group_name)
                g.create_dataset("points", data=full_point[k], compression="gzip")
                g.create_dataset("box", data=full_box[k], compression="gzip")


def _score_objects(f, prefix, min_size, have_model3):
    """Per-object IoUs of each model + pairwise advantage columns
    (reference model_comparison.py:171)."""
    import pandas as pd

    n_models = 3 if have_model3 else 2
    rows = []
    for gt_id, obj in f["objects"].items():
        gt_mask = obj["gt_mask"][:]
        if gt_mask.sum() < min_size:
            continue
        row = {"gt_id": gt_id}
        for k in range(1, n_models + 1):
            row[f"score{k}"] = util.compute_iou(gt_mask, obj[f"{prefix}/mask{k}"][:])
        rows.append(row)
    scores = pd.DataFrame(rows)
    if len(scores):
        scores["advantage1"] = scores["score1"] - scores["score2"]
        scores["advantage2"] = scores["score2"] - scores["score1"]
    return scores


def _square_crop(bb, shape):
    """Expand a 2d slice tuple to a square window within the image."""
    heights = [sl.stop - sl.start for sl in bb]
    side = max(heights)
    pads = [(side - h) // 2 for h in heights]
    return tuple(
        slice(max(sl.start - pad, 0), min(sl.stop + pad, size))
        for sl, pad, size in zip(bb, pads, shape)
    )


def _to_rgb(image):
    im = np.asarray(image, dtype="float64")
    lo, hi = im.min(), im.max()
    im = (im - lo) / max(hi - lo, 1e-6)
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    return im


def _paint_outline(rgb, mask, color, dilation=0):
    from scipy import ndimage
    outline = mask & ~ndimage.binary_erosion(mask)
    if dilation > 0:
        outline = ndimage.binary_dilation(outline, iterations=dilation)
    rgb = rgb.copy()
    rgb[outline] = color
    return rgb


def _paint_prompt(rgb, obj_attrs, is_box, point_radius, offset):
    # attrs store points as (y, x) and boxes as (y0, x0, y1, x1) — the same
    # conventions segment_from_points / segment_from_box consume
    if is_box:
        y0, x0, y1, x1 = (obj_attrs["box"]
                          - np.array([offset[0], offset[1], offset[0], offset[1]]))
        box_mask = np.zeros(rgb.shape[:2], dtype=bool)
        yy = np.clip([int(y0), int(y1)], 0, rgb.shape[0] - 1)
        xx = np.clip([int(x0), int(x1)], 0, rgb.shape[1] - 1)
        box_mask[yy[0]:yy[1] + 1, xx[0]] = True
        box_mask[yy[0]:yy[1] + 1, xx[1]] = True
        box_mask[yy[0], xx[0]:xx[1] + 1] = True
        box_mask[yy[1], xx[0]:xx[1] + 1] = True
        rgb = rgb.copy()
        rgb[box_mask] = (0.0, 1.0, 0.0)
        return rgb
    ys, xs = np.ogrid[:rgb.shape[0], :rgb.shape[1]]
    rgb = rgb.copy()
    for (py, px), label in zip(obj_attrs["point_coords"],
                               obj_attrs.get("point_labels", [1])):
        cy, cx = py - offset[0], px - offset[1]
        disk = (ys - cy) ** 2 + (xs - cx) ** 2 <= point_radius ** 2
        rgb[disk] = (0.0, 1.0, 0.0) if label == 1 else (1.0, 0.0, 0.0)
    return rgb


def _enhance_image(im):
    """Contrast-enhance a crop for display (reference model_comparison.py:218
    uses CLAHE; adaptive histogram equalization via skimage when available,
    min-max stretch otherwise)."""
    im = np.asarray(im, dtype="float32")
    im -= im.min()
    im /= (im.max() + 1e-6)
    try:
        from skimage import exposure
        im = exposure.equalize_adapthist(im)
    except Exception:
        pass
    return (im * 255).astype("uint8")


def _plot_advantage_gallery(f, scores, advantage_column, n_rows, prefix,
                            sample_name, plot_folder, point_radius,
                            outline_dilation, have_model3,
                            enhance_image=True):
    """Crops of the objects where one model most outperforms the other
    (reference model_comparison.py:267 _compare_eval)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import ndimage

    top = scores.sort_values(advantage_column, ascending=False).iloc[:n_rows]
    if not len(top):
        return
    image = f["image"][:]
    if enhance_image:
        image = _enhance_image(image)
    n_models = 3 if have_model3 else 2
    n_cols = 1 + n_models
    fig, axes = plt.subplots(len(top), n_cols,
                             figsize=(3 * n_cols, 3 * len(top)))
    axes = np.atleast_2d(axes)

    colors = [(1.0, 1.0, 0.0), (0.0, 0.5, 1.0), (1.0, 0.0, 1.0)]
    for r, (_, row) in enumerate(top.iterrows()):
        obj = f[f"objects/{row.gt_id}"]
        gt_mask = obj["gt_mask"][:]
        masks = [obj[f"{prefix}/mask{k}"][:] for k in range(1, n_models + 1)]
        union = gt_mask.copy()
        for m in masks:
            union |= m > 0
        bb = _square_crop(ndimage.find_objects(union.astype("uint8"))[0], union.shape)
        offset = (bb[0].start, bb[1].start)

        crop = _to_rgb(image[bb])
        prompt_panel = _paint_prompt(
            _paint_outline(crop, gt_mask[bb], colors[0], outline_dilation),
            obj.attrs, is_box=prefix == "box", point_radius=point_radius,
            offset=offset)
        axes[r, 0].imshow(prompt_panel)
        axes[r, 0].set_title(f"gt + prompt ({row.gt_id})", fontsize=8)
        for k, m in enumerate(masks):
            panel = _paint_outline(crop, m[bb] > 0, colors[min(k + 1, 2)],
                                   outline_dilation)
            axes[r, k + 1].imshow(panel)
            axes[r, k + 1].set_title(
                f"model{k + 1} IoU={row[f'score{k + 1}']:.2f}", fontsize=8)
        for ax in axes[r]:
            ax.axis("off")

    target = os.path.join(
        str(plot_folder), f"{sample_name}-{prefix}-{advantage_column}.png")
    fig.tight_layout()
    fig.savefig(target, dpi=120)
    plt.close(fig)


def model_comparison(
    output_folder: Union[str, os.PathLike],
    n_images_per_sample: int,
    min_size: int,
    plot_folder: Optional[Union[str, os.PathLike]] = None,
    point_radius: int = 4,
    outline_dilation: int = 0,
    have_model3: bool = False,
    enhance_image: bool = True,
) -> None:
    """Render comparison galleries ranked by per-object IoU advantage
    (reference model_comparison.py:414)."""
    import h5py
    files = sorted(glob(os.path.join(str(output_folder), "sample*.h5")))
    if plot_folder is None:
        plot_folder = os.path.join(str(output_folder), "plots")
    os.makedirs(plot_folder, exist_ok=True)

    for path in files:
        sample_name = Path(path).stem
        with h5py.File(path, "r") as f:
            if "objects" not in f:
                continue
            for prefix in ("points", "box"):
                scores = _score_objects(f, prefix, min_size, have_model3)
                if not len(scores):
                    continue
                for advantage in ("advantage1", "advantage2"):
                    _plot_advantage_gallery(
                        f, scores, advantage, n_images_per_sample, prefix,
                        sample_name, plot_folder, point_radius,
                        outline_dilation, have_model3,
                        enhance_image=enhance_image,
                    )


def _browse_object_in_napari(obj, image, show_points):
    import napari

    prefix = "points" if show_points else "box"
    viewer = napari.Viewer()
    viewer.add_image(image)
    viewer.add_labels(obj["gt_mask"][:])
    k = 1
    while f"{prefix}/mask{k}" in obj:
        viewer.add_labels(obj[f"{prefix}/mask{k}"][:], name=f"model{k}")
        k += 1
    if show_points:
        # attrs store (y, x) — napari's native point order, no flip
        viewer.add_points(
            np.asarray(obj.attrs["point_coords"]),
            symbol="o", face_color="transparent",
            border_color="#00FF00", border_width=0.5, size=12,
        )
    else:
        y0, x0, y1, x1 = obj.attrs["box"]
        viewer.add_shapes(
            np.array([[y0, x0], [y1, x1]]), shape_type="rectangle",
            face_color="transparent", edge_color="green", edge_width=4,
        )
    napari.run()


def model_comparison_with_napari(
    output_folder: Union[str, os.PathLike], show_points: bool = True
) -> None:
    """Browse the per-object comparison masks in napari (reference
    model_comparison.py:487). Requires napari."""
    try:
        import napari  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "model_comparison_with_napari requires napari; render static "
            "galleries with model_comparison(plot_folder=...) instead."
        ) from e
    import h5py
    for path in sorted(glob(os.path.join(str(output_folder), "*.h5"))):
        print("Comparing models in", path)
        with h5py.File(path, "r") as f:
            image = f["image"][:]
            for _, obj in f.get("objects", {}).items():
                _browse_object_in_napari(obj, image, show_points)
