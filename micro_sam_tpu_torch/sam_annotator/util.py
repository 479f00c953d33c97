"""Annotator core: layers to prompts, the interactive nd segmentation and
tracking loops, the AMG / AIS state caches and the clear helpers (the
port's counterpart of ``micro_sam_tpu/sam_annotator/util.py``, over the port's
``prompt_based_segmentation`` and ``multi_dimensional_segmentation``).

All functions are free of napari: they accept napari layers or the
``PointData`` / ``ShapeData`` stand-ins below (anything with the same
``.data`` / ``.properties`` duck type works). Prompt arrays stay on the host;
each segmentation is a decode on the predictor's device.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import shift as ndi_shift

from .. import prompt_based_segmentation as pbs
from .. import util
from ..multi_dimensional_segmentation import _validate_projection


@dataclass
class PointData:
    """Duck-typed stand-in for a napari Points layer."""
    data: np.ndarray                                   # (N, 2|3)
    properties: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class ShapeData:
    """Duck-typed stand-in for a napari Shapes layer."""
    data: List[np.ndarray]                             # list of (K, 2|3) vertex arrays
    shape_type: List[str] = field(default_factory=list)
    properties: Dict[str, np.ndarray] = field(default_factory=dict)


# -----------------------------------------------------------------------------
# Layer -> prompt conversion
# -----------------------------------------------------------------------------

def _property_ints(layer, name: str) -> np.ndarray:
    """An integer property column (napari stores them as str or int)."""
    return np.asarray([int(v) for v in layer.properties[name]])


def _point_rows(layer, i, track_id) -> np.ndarray:
    """Boolean row selector for a points layer: frame ``i`` (rounded leading
    coordinate) intersected with ``track_id`` when given."""
    coords = np.asarray(layer.data)
    keep = np.ones(len(coords), dtype=bool)
    if i is not None:
        keep &= np.round(coords[:, 0]) == i
    if track_id is not None:
        keep &= _property_ints(layer, "track_id") == track_id
    return keep


def point_layer_to_prompts(
    layer, i=None, track_id=None, with_stop_annotation=True,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Extract point prompts from a point layer.

    Returns (points, labels) in (y, x) with labels already numeric
    (1 positive / 0 negative). A lone negative point is the annotator's
    "stop here" marker and yields None when ``with_stop_annotation``.
    """
    coords = np.asarray(layer.data)
    if i is None:
        assert coords.ndim == 2 and coords.shape[1] == 2, f"{coords.shape}"
    else:
        assert coords.ndim == 2 and coords.shape[1] == 3, f"{coords.shape}"
    if track_id is not None:
        assert i is not None, "track_id filtering requires a frame index"

    keep = _point_rows(layer, i, track_id)
    coords = coords[keep][:, 1:] if i is not None else coords[keep]
    labels = (np.asarray(layer.properties["label"])[keep] == "positive").astype(int)

    is_stop = with_stop_annotation and len(coords) == 1 and labels[0] == 0
    return None if is_stop else (coords, labels)


def _rasterize_polygon(vertices: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Rasterize a polygon via matplotlib Path (skimage.draw.polygon equivalent)."""
    from matplotlib.path import Path as MplPath
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
    pts = np.column_stack([ys.ravel(), xs.ravel()])
    return MplPath(vertices).contains_points(pts).reshape(shape)


def _rasterize_ellipse(vertices: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    center = vertices.mean(axis=0)
    radius_r = abs(((vertices[2] - vertices[1]) / 2)[0])
    radius_c = abs(((vertices[1] - vertices[0]) / 2)[1])
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
    return ((ys - center[0]) / max(radius_r, 1e-7)) ** 2 + \
           ((xs - center[1]) / max(radius_c, 1e-7)) ** 2 <= 1


# rectangle prompts stay box-only; ellipses/polygons also carry a mask prompt
_SHAPE_RASTERIZERS = {
    "rectangle": None,
    "ellipse": _rasterize_ellipse,
    "polygon": _rasterize_polygon,
}


def shape_layer_to_prompts(
    layer, shape: Tuple[int, int], i=None, track_id=None,
) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]]]:
    """Extract box (+ mask) prompts from a shape layer.

    Every shape contributes its bounding box; ellipse and polygon shapes also
    contribute their rasterized mask as a dense prompt.
    """
    entries = list(zip(layer.data, layer.shape_type))
    if not entries:
        return [], []
    if i is not None:
        on_frame = lambda verts: (verts[:, 0] == i).all()
        if track_id is None:
            entries = [(v[:, 1:], t) for v, t in entries if on_frame(v)]
        else:
            tids = _property_ints(layer, "track_id")
            entries = [
                (v[:, 1:], t) for (v, t), tid in zip(entries, tids)
                if on_frame(v) and tid == track_id
            ]

    boxes: List[np.ndarray] = []
    masks: List[Optional[np.ndarray]] = []
    for verts, shape_type in entries:
        if shape_type not in _SHAPE_RASTERIZERS:
            warnings.warn(f"Shape type {shape_type} is not supported and will be ignored.")
            continue
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        boxes.append(np.array([lo[0], lo[1], hi[0], hi[1]]))
        rasterize = _SHAPE_RASTERIZERS[shape_type]
        masks.append(None if rasterize is None else rasterize(verts, shape))
    return boxes, masks


# -----------------------------------------------------------------------------
# Tracking state from layers
# -----------------------------------------------------------------------------

def _division_in(states: Sequence[str]) -> str:
    return "division" if any(s == "division" for s in states) else "track"


def prompt_layer_to_state(prompt_layer, i: int) -> str:
    """Track state ("division" / "track") of a frame."""
    coords = np.asarray(prompt_layer.data)
    assert coords.shape[1] == 3, f"{coords.shape}"
    states = np.asarray(prompt_layer.properties["state"])[coords[:, 0] == i]
    return _division_in(states)


def prompt_layers_to_state(point_layer, box_layer, i: int) -> str:
    """Track state combined over point and box layers."""
    coords = np.asarray(point_layer.data)
    assert coords.shape[1] == 3
    states = list(np.asarray(point_layer.properties["state"])[coords[:, 0] == i])
    box_states = box_layer.properties.get("state", [])
    states += [s for verts, s in zip(box_layer.data, box_states)
               if (verts[:, 0] == i).all()]
    return _division_in(states)


# -----------------------------------------------------------------------------
# Interactive nd segmentation
# -----------------------------------------------------------------------------

def _annotated_slices(point_prompts, box_prompts, track_id) -> np.ndarray:
    """Sorted unique frame indices that carry any prompt (optionally for one
    track)."""
    pz = np.round(np.asarray(point_prompts.data)[:, 0]) \
        if len(point_prompts.data) else np.zeros(0)
    bz = np.array([verts[0, 0] for verts in box_prompts.data]) \
        if len(box_prompts.data) else np.zeros(0)

    if track_id is not None:
        ptids = _property_ints(point_prompts, "track_id")
        assert len(ptids) == len(pz)
        pz = pz[ptids == track_id]
        if len(bz) > 0:
            btids = _property_ints(box_prompts, "track_id")
            assert len(btids) == len(bz)
            bz = bz[btids == track_id]

    return np.unique(np.concatenate([pz, bz])).astype("int")


def segment_slices_with_prompts(
    predictor, point_prompts, box_prompts, image_embeddings, shape,
    track_id=None, update_progress=None,
):
    """Per-slice prompt segmentation of all annotated slices. Returns (seg,
    slices, stop_lower, stop_upper): the stop flags record lone-negative-point
    annotations at the slice range's ends."""
    assert len(shape) == 3
    image_shape = shape[1:]
    seg = np.zeros(shape, dtype="uint32")
    if update_progress is None:
        update_progress = lambda *a: None

    slices = _annotated_slices(point_prompts, box_prompts, track_id)
    stop_lower = stop_upper = False

    for i in slices:
        points_i = point_layer_to_prompts(point_prompts, i, track_id)

        if points_i is None:  # lone negative point = stop annotation
            if i == slices[0]:
                stop_lower = True
            elif i == slices[-1]:
                stop_upper = True
            else:
                slices = np.setdiff1d(slices, i)
                print(f"You have provided a stop annotation (single red point) in slice {i},")
                print("but you have annotated slices above or below it. This stop annotation will")
                print(f"be ignored and the slice {i} will be segmented normally.")
            update_progress(1)
            continue

        boxes, masks = shape_layer_to_prompts(box_prompts, image_shape, i=i, track_id=track_id)
        seg_i = prompt_segmentation(
            predictor, *points_i, boxes, masks, image_shape,
            multiple_box_prompts=False, image_embeddings=image_embeddings, i=i,
        )
        if seg_i is None:
            print(f"The prompts at slice or frame {i} are invalid and the segmentation was skipped.")
            continue

        seg[i] = seg_i
        update_progress(1)

    return seg, slices, stop_lower, stop_upper


def _segment_one(predictor, box, points, labels, mask, image_embeddings, i,
                 box_extension=0):
    """Single-object segmentation for whichever prompt combination is given."""
    if mask is not None:
        return pbs.segment_from_mask(
            predictor, mask, box=box, points=points, labels=labels,
            image_embeddings=image_embeddings, i=i, box_extension=box_extension,
        ).squeeze()
    if box is not None and points is not None:
        return pbs.segment_from_box_and_points(
            predictor, box, points, labels, image_embeddings=image_embeddings, i=i,
        ).squeeze()
    if box is not None:
        return pbs.segment_from_box(
            predictor, box, image_embeddings=image_embeddings, i=i,
        ).squeeze()
    return pbs.segment_from_points(
        predictor, points, labels, image_embeddings=image_embeddings, i=i,
    ).squeeze()


def _batched_interactive_segmentation(predictor, points, labels, boxes,
                                      image_embeddings, i, previous_segmentation):
    """Batched mode: one object per positive point and per box, with all
    negative points shared across the objects."""
    prev_seg = previous_segmentation if i is None else previous_segmentation[i]
    seg = np.zeros(prev_seg.shape, dtype="uint32")

    labels = np.asarray(labels)
    positives = [np.asarray(points)[j:j + 1] for j in np.nonzero(labels == 1)[0]]
    neg_idx = np.nonzero(labels != 1)[0]
    neg_points = np.asarray(points)[neg_idx]
    neg_labels = labels[neg_idx]

    # object list: positive points first, then boxes (ids start at 1)
    objects = [(None, p, np.ones(1, dtype=labels.dtype)) for p in positives]
    objects += [(np.asarray(box), None, None) for box in boxes]

    for seg_id, (box, point, label) in enumerate(objects, 1):
        if len(neg_points) > 0:
            point = neg_points if point is None else np.concatenate([point, neg_points])
            label = neg_labels if label is None else np.concatenate([label, neg_labels])
        prediction = _segment_one(
            predictor, box, point, label, None, image_embeddings, i)
        seg[prediction] = seg_id
    return seg


def prompt_segmentation(
    predictor, points, labels, boxes, masks, shape, multiple_box_prompts,
    image_embeddings=None, i=None, box_extension=0, batched=None,
    previous_segmentation=None,
):
    """Dispatch segmentation over the prompt combination: batched per-object
    mode, point + single box (+ mask), points only, or one object per box /
    mask."""
    assert len(points) == len(labels)
    have_points, have_boxes = len(points) > 0, len(boxes) > 0
    if not (have_points or have_boxes):
        return None

    if batched:
        assert previous_segmentation is not None
        return _batched_interactive_segmentation(
            predictor, points, labels, boxes, image_embeddings, i,
            previous_segmentation)

    if have_points and have_boxes:
        if len(boxes) > 1:
            print("You have provided point prompts and more than one box prompt.")
            print("This setting is currently not supported.")
            return None
        return _segment_one(
            predictor, boxes[0], points, labels, masks[0], image_embeddings, i)

    if have_points:
        return _segment_one(predictor, None, points, labels, None,
                            image_embeddings, i)

    # boxes only: one labeled object per box
    if len(boxes) > 1 and not multiple_box_prompts:
        print("You have provided more than one box annotation. "
              "This is not yet supported in the 3d annotator.")
        return None
    seg = np.zeros(shape, dtype="uint32")
    for seg_id, (box, mask) in enumerate(zip(boxes, masks), 1):
        prediction = _segment_one(
            predictor, box, None, None, mask, image_embeddings, i,
            box_extension=box_extension)
        seg[prediction] = seg_id
    return seg


# -----------------------------------------------------------------------------
# Interactive tracking
# -----------------------------------------------------------------------------

def _object_center(frame: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(frame == 1)
    return np.array([ys.mean(), xs.mean()])


def _compute_movement(seg, t0, t1) -> np.ndarray:
    return (_object_center(seg[t1]) - _object_center(seg[t0])).astype("float64")


def _shift_object(mask, motion_model):
    shifted = np.zeros_like(mask)
    ndi_shift(mask, motion_model, output=shifted, order=0, prefilter=False)
    return shifted


def track_from_prompts(
    point_prompts, box_prompts, seg, predictor, slices, image_embeddings,
    stop_upper, threshold, projection, motion_smoothing=0.5, box_extension=0,
    update_progress=None,
):
    """Interactive tracking loop: project the object frame by frame with an
    exponentially-smoothed motion model, stopping on low IOU or a division
    annotation."""
    use_box, use_mask, use_points, use_single_point = _validate_projection(projection)
    if update_progress is None:
        update_progress = lambda *a: None

    def next_motion_model(prev, t, t0):
        if t < t0 + 2:
            return prev
        step = _compute_movement(seg, t - 2, t - 1)
        if t == t0 + 2:
            return step
        return motion_smoothing * prev + (1 - motion_smoothing) * step

    has_division = False
    motion_model = None
    t0 = int(slices.min())
    t = t0 + 1
    while t < seg.shape[0]:
        motion_model = next_motion_model(motion_model, t, t0)

        if t in slices:
            # annotated frame: keep its segmentation, only read the state
            seg_prev, seg_t = None, seg[t]
            track_state = prompt_layer_to_state(point_prompts, t)
        else:
            seg_prev = seg[t - 1]
            if motion_model is not None:
                seg_prev = _shift_object(seg_prev, motion_model)
            seg_t = pbs.segment_from_mask(
                predictor, seg_prev, image_embeddings=image_embeddings, i=t,
                use_mask=use_mask, use_box=use_box, use_points=use_points,
                box_extension=box_extension, use_single_point=use_single_point,
            )
            track_state = "track"
            if t < slices[-1]:
                seg_prev = None  # IOU stop only applies beyond the annotations
            update_progress(1)

        if threshold is not None and seg_prev is not None:
            iou = util.compute_iou(seg_prev, seg_t)
            if iou < threshold:
                print(f"Tracking stopped at frame {t} due to IOU {iou} < {threshold}.")
                break

        if track_state == "division":
            has_division = True
            break

        seg[t] = seg_t
        t += 1
        if t == slices[-1] and stop_upper:
            break

    return seg, has_division


# -----------------------------------------------------------------------------
# AMG / AIS state cache loading
# -----------------------------------------------------------------------------

def _load_amg_state(embedding_path) -> Dict:
    """Load cached per-slice AMG states (pickles under <emb>/amg_state)."""
    import os
    import pickle
    from glob import glob
    from pathlib import Path

    if embedding_path is None or not os.path.exists(str(embedding_path)):
        return {"cache_folder": None}
    cache_folder = os.path.join(str(embedding_path), "amg_state")
    os.makedirs(cache_folder, exist_ok=True)
    amg_state: Dict = {"cache_folder": cache_folder}
    for path in glob(os.path.join(cache_folder, "*.pkl")):
        with open(path, "rb") as f:
            state = pickle.load(f)
        amg_state[int(Path(path).stem.split("-")[-1])] = state
    return amg_state


def _load_is_state(embedding_path) -> Dict:
    """Load cached per-slice AIS decoder maps (<emb>/is_state.h5)."""
    import os

    if embedding_path is None or not os.path.exists(str(embedding_path)):
        return {"cache_path": None}
    import h5py
    cache_path = os.path.join(str(embedding_path), "is_state.h5")
    is_state: Dict = {"cache_path": cache_path}
    with h5py.File(cache_path, "a") as f:
        for name, g in f.items():
            is_state[int(name.split("-")[-1])] = {
                "foreground": g["foreground"][:],
                "boundary_distances": g["boundary_distances"][:],
                "center_distances": g["center_distances"][:],
            }
    return is_state


def toggle_label(prompts) -> None:
    """Toggle the last point-prompt label between positive and negative."""
    prompt_layer = prompts
    labels = prompt_layer.properties.get("label")
    if labels is None or len(labels) == 0:
        return
    labels = np.asarray(labels, dtype=object).copy()
    labels[-1] = "negative" if labels[-1] == "positive" else "positive"
    prompt_layer.properties["label"] = labels
    if hasattr(prompt_layer, "refresh_colors"):
        prompt_layer.refresh_colors()


LABEL_COLOR_CYCLE = ["#00FF00", "#FF0000"]


def clear_annotations(viewer, clear_segmentations: bool = True) -> None:
    """Clear all prompt annotations (and optionally the current object) of a
    viewer."""
    from ._widgets import clear_annotations as _clear_layers

    _clear_layers(viewer.layers.get("point_prompts"), viewer.layers.get("prompts"))
    if not clear_segmentations:
        return
    layer = viewer.layers.get("current_object")
    if layer is not None:
        layer.data = np.zeros_like(layer.data)
        layer.refresh()


def clear_annotations_slice(viewer, i: int, clear_segmentations: bool = True) -> None:
    """Remove the prompts (and optionally the segmentation) of one z-slice /
    timeframe."""
    points_layer = viewer.layers.get("point_prompts") if hasattr(viewer.layers, "get") \
        else viewer.layers["point_prompts"]
    if points_layer is not None:
        coords = np.asarray(points_layer.data)
        if coords.ndim == 2 and coords.shape[1] == 3:
            keep = coords[:, 0] != i
            points_layer.data = coords[keep]
            for key, values in getattr(points_layer, "properties", {}).items():
                values = np.asarray(values)
                if len(values) == len(keep):
                    points_layer.properties[key] = values[keep]
        points_layer.refresh()

    shapes_layer = viewer.layers.get("prompts") if hasattr(viewer.layers, "get") \
        else viewer.layers["prompts"]
    if shapes_layer is not None and isinstance(shapes_layer.data, list):
        shapes_layer.data = [
            s for s in shapes_layer.data
            if not (np.asarray(s).ndim == 2 and np.asarray(s).shape[1] == 3
                    and (np.asarray(s)[:, 0] == i).all())
        ]
        shapes_layer.refresh()

    if not clear_segmentations:
        return
    seg_layer = viewer.layers.get("current_object") if hasattr(viewer.layers, "get") \
        else viewer.layers["current_object"]
    if seg_layer is not None and np.asarray(seg_layer.data).ndim == 3:
        seg_layer.data[i] = 0
        seg_layer.refresh()
