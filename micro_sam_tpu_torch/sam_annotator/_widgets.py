"""Annotator widget logic (counterpart of
``micro_sam_tpu/sam_annotator/_widgets.py``, micro-sam's
sam_annotator/_widgets.py).

The computational cores (segment / commit / automatic segmentation)
come first and run headless, over the port's predictor on the card; the
widget classes below them are built on the form layer of ``_compat`` (real Qt
under napari, plain Python headless).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from . import util as vutil
from ._state import AnnotatorState
from .. import instance_segmentation, util
from ..multi_dimensional_segmentation import merge_instance_segmentation_3d, segment_mask_in_volume


def _require_napari():
    try:
        import napari  # noqa: F401
        import magicgui  # noqa: F401
        return True
    except ImportError as e:
        raise RuntimeError(
            "The napari annotator GUI requires napari and magicgui, which are not "
            "installed in this environment. The computational annotator core "
            "(micro_sam_tpu_torch.sam_annotator.util / _widgets functions) works headless."
        ) from e


# -----------------------------------------------------------------------------
# headless computational cores
# -----------------------------------------------------------------------------

def segment_2d(state: AnnotatorState, point_prompts, shape_prompts, shape,
               batched: bool = False, previous_segmentation=None) -> Optional[np.ndarray]:
    """Interactive 2d segmentation from prompt layers (core of the 'segment'
    widget, micro-sam's _widgets.py:994)."""
    points, labels = (np.zeros((0, 2)), np.zeros(0, dtype=int)) \
        if point_prompts is None else (
            vutil.point_layer_to_prompts(point_prompts, with_stop_annotation=False) or
            (np.zeros((0, 2)), np.zeros(0, dtype=int))
        )
    boxes, masks = ([], []) if shape_prompts is None else \
        vutil.shape_layer_to_prompts(shape_prompts, shape)
    return vutil.prompt_segmentation(
        state.predictor, points, labels, boxes, masks, shape,
        multiple_box_prompts=True, image_embeddings=state.image_embeddings,
        batched=batched, previous_segmentation=previous_segmentation,
    )


def segment_slice(state, point_prompts=None, shape_prompts=None, shape=None,
                  i: int = None, viewer=None) -> Optional[np.ndarray]:
    """Segment one z-slice / frame (micro-sam's _widgets.py:1029).

    Two calling conventions: the headless core
    ``segment_slice(state, point_prompts, shape_prompts, shape, i)`` and the
    micro-sam's viewer-level ``segment_slice(viewer)`` (also accepted as the
    first positional), which reads layers/position from the viewer and writes
    the slice back into 'current_object'."""
    if viewer is None and hasattr(state, "layers"):
        viewer = state
    if viewer is not None:
        if _validate_embeddings(viewer) or _validate_layers(viewer):
            return None
        i = int(viewer.dims.point[0])
        layer = viewer.layers["current_object"]
        seg = segment_slice(
            AnnotatorState(), viewer.layers.get("point_prompts"),
            viewer.layers.get("prompts"), layer.data.shape, i,
        )
        if seg is None:
            print("You either haven't provided any prompts or invalid prompts. "
                  "The segmentation will be skipped.")
            return None
        data = layer.data
        data[i] = seg.astype(data.dtype)
        layer.data = data
        layer.refresh()
        return None
    points_result = vutil.point_layer_to_prompts(point_prompts, i, with_stop_annotation=False)
    points, labels = points_result if points_result is not None else (np.zeros((0, 2)), np.zeros(0))
    boxes, masks = vutil.shape_layer_to_prompts(shape_prompts, shape[1:], i=i)
    return vutil.prompt_segmentation(
        state.predictor, points, labels, boxes, masks, shape[1:],
        multiple_box_prompts=False, image_embeddings=state.image_embeddings, i=i,
    )


def segment_nd(
    state: AnnotatorState, point_prompts, shape_prompts, shape,
    projection: str = "box", iou_threshold: float = 0.8, box_extension: float = 0.05,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Volumetric segmentation: per-slice prompts + projection through the
    volume (core of SegmentNDWidget, micro-sam's _widgets.py:1603)."""
    seg, slices, stop_lower, stop_upper = vutil.segment_slices_with_prompts(
        state.predictor, point_prompts, shape_prompts, state.image_embeddings, shape
    )
    seg, (z_min, z_max) = segment_mask_in_volume(
        seg, state.predictor, state.image_embeddings, slices,
        stop_lower, stop_upper, iou_threshold=iou_threshold,
        projection=projection, box_extension=box_extension,
    )
    state.z_range = (z_min, z_max)
    return seg, (z_min, z_max)


def automatic_segmentation_2d(state: AnnotatorState, image, i=None, **kwargs) -> np.ndarray:
    """Automatic segmentation of the current image/slice (core of
    AutoSegmentWidget, micro-sam's _widgets.py:1717)."""
    if state.amg is None:
        is_tiled = state.image_embeddings["input_size"] is None
        state.amg = instance_segmentation.get_instance_segmentation_generator(
            state.predictor, is_tiled=is_tiled, decoder=state.decoder
        )
    if not getattr(state.amg, "is_initialized", False):
        state.amg.initialize(image, image_embeddings=state.image_embeddings, i=i, verbose=False)
    return state.amg.generate(**kwargs)


def automatic_segmentation_3d(state: AnnotatorState, volume, with_background=True,
                              gap_closing=None, min_z_extent=None, **kwargs) -> np.ndarray:
    """Automatic 3d segmentation: per-slice + multicut merge
    (micro-sam's _widgets.py:1725 apply-to-volume path)."""
    is_tiled = state.image_embeddings["input_size"] is None
    segmenter = instance_segmentation.get_instance_segmentation_generator(
        state.predictor, is_tiled=is_tiled, decoder=state.decoder
    )
    offset = 0
    seg = np.zeros(volume.shape[:3], dtype="uint32")
    for i in range(seg.shape[0]):
        segmenter.initialize(volume[i], image_embeddings=state.image_embeddings,
                             i=i, verbose=False)
        seg_i = segmenter.generate(**kwargs)
        if isinstance(seg_i, list):
            continue
        seg_i = np.asarray(seg_i, dtype="uint32")
        mx = int(seg_i.max())
        if mx == 0:
            continue
        seg_i[seg_i != 0] += offset
        offset += mx
        seg[i] = seg_i
    return merge_instance_segmentation_3d(
        seg, with_background=with_background, gap_closing=gap_closing,
        min_z_extent=min_z_extent, verbose=False,
    )


def _mask_matched_objects(committed, seg, preserve_mode: str = "objects",
                          preservation_threshold: float = 0.5):
    """Which committed pixels/objects to preserve when committing new objects
    over them (micro-sam's _widgets.py:484). A committed object is preserved
    when its best overlap with the new objects stays below
    ``preservation_threshold``."""
    if preserve_mode == "none":
        return np.zeros(committed.shape, dtype=bool)
    if preserve_mode == "pixels":
        return committed != 0
    # "objects": preserve only committed objects that do not overlap new ones
    from .. import native
    keep = np.zeros(committed.shape, dtype=bool)
    ovlp = native.overlap(committed, seg)
    for cid in np.unique(committed):
        if cid == 0:
            continue
        ids, vals = ovlp.overlapArraysNormalized(int(cid), True)
        vals = vals[ids != 0]
        if vals.size == 0 or vals[0] < preservation_threshold:
            keep |= committed == cid
    return keep


def commit_segmentation(
    committed_objects: np.ndarray,
    current_segmentation: np.ndarray,
    preserve_mode: str = "objects",
    z_range: Optional[Tuple[int, int]] = None,
    preservation_threshold: float = 0.5,
) -> np.ndarray:
    """Commit the current (auto or interactive) segmentation into the
    committed-objects layer data (core of the commit widget, micro-sam's
    _widgets.py:499)."""
    committed = np.asarray(committed_objects).copy()
    seg = np.asarray(current_segmentation)

    id_offset = int(committed.max())
    seg_relabeled = np.zeros_like(seg, dtype=committed.dtype)
    fg = seg != 0
    if fg.any():
        from .. import native
        rel, max_id, _ = native.relabel_consecutive(seg)
        seg_relabeled[fg] = rel[fg] + id_offset

    if z_range is not None and committed.ndim == 3:
        bounded = np.zeros_like(seg_relabeled)
        z0, z1 = z_range
        bounded[z0:z1 + 1] = seg_relabeled[z0:z1 + 1]
        seg_relabeled = bounded

    preserve = _mask_matched_objects(committed, seg_relabeled, preserve_mode,
                                     preservation_threshold)
    write = (seg_relabeled != 0) & ~preserve
    committed[write] = seg_relabeled[write]
    return committed


def clear_annotations(*layers) -> None:
    """Clear prompt layers (micro-sam's _widgets.py:434)."""
    for layer in layers:
        if layer is None:
            continue
        if hasattr(layer, "data"):
            if isinstance(layer.data, list):
                layer.data = []
            else:
                layer.data = np.zeros((0,) + np.asarray(layer.data).shape[1:])
        for key in getattr(layer, "properties", {}):
            layer.properties[key] = np.zeros(0, dtype=object)


# -----------------------------------------------------------------------------
# widget classes (render to Qt under napari; pure-Python headless — _compat)
# -----------------------------------------------------------------------------

from ._compat import Button, FormWidget, HAVE_QT, generate_message  # noqa: E402
from .._model_settings import get_model_settings  # noqa: E402


def _validate_embeddings(viewer=None) -> bool:
    """Abort with an error if no embeddings are computed yet
    (micro-sam's _widgets.py:917)."""
    if AnnotatorState().image_embeddings is None:
        return generate_message(
            "error",
            "Image embeddings are not yet computed. "
            "Press 'Compute Embeddings' to compute them for your image.",
        )
    return False


def _validate_layers(viewer, automatic_segmentation: bool = False) -> bool:
    """Abort if no prompts were given (micro-sam's _widgets.py:980)."""
    state = AnnotatorState()
    if state.annotator is not None:
        state.annotator._require_layers()
    if automatic_segmentation:
        return False
    no_prompts = (
        len(viewer.layers["prompts"].data) == 0
        and len(viewer.layers["point_prompts"].data) == 0
    )
    if no_prompts:
        return generate_message(
            "error",
            "No prompts were given. Please provide prompts to run "
            "interactive segmentation.",
        )
    return False


def _process_tiling_inputs(tile_shape_x, tile_shape_y, halo_x, halo_y):
    """Normalize user tile/halo inputs (micro-sam's _widgets.py:1119): zeros mean
    'no tiling'; partial inputs are squared up; tiles are clamped to >= 256."""
    tile_shape = (tile_shape_x, tile_shape_y)
    halo = (halo_x, halo_y)
    if all(item in (0, None) for item in tile_shape):
        tile_shape = None
    elif 0 in tile_shape:
        max_val = max(max(tile_shape), 256)
        tile_shape = (max_val, max_val)
    else:
        tile_shape = (max(tile_shape[0], 256), max(tile_shape[1], 256))

    if all(item in (0, None) for item in halo):
        halo = None if tile_shape is None else (0, 0)
    elif tile_shape is None:
        halo = None
    else:
        max_val = max(halo)
        halo = (max_val, max_val)
    return tile_shape, halo


# model-family <-> zoo-suffix mapping shared by EmbeddingWidget and
# TrainingWidget (micro-sam's _widgets.py:291-343)
MODEL_FAMILIES = {
    "Natural Images (SAM)": "",
    "Light Microscopy": "_lm",
    "Electron Microscopy": "_em_organelles",
    "Medical Imaging": "_medical_imaging",
    "Histopathology": "_histopathology",
}
MODEL_SIZES = {"t": "tiny", "b": "base", "l": "large", "h": "huge"}


class _ModelSelectionMixin:
    """Model family + size dropdowns resolving to a zoo ``model_type``."""

    def _init_model_selection(self, default_model: str):
        suffix = default_model[5:]
        family = {v: k for k, v in MODEL_FAMILIES.items()}.get(suffix, "Natural Images (SAM)")
        self.model_family_field = self._add_choice_param(
            "model_family", family, list(MODEL_FAMILIES.keys()), title="Model:",
            update=self._update_model_type,
        )
        self.model_size_field = self._add_choice_param(
            "model_size", MODEL_SIZES[default_model[4]], self._model_size_options(family),
            title="model size:", update=self._update_model_type,
        )
        self.model_type = default_model

    def _model_size_options(self, family):
        suffix = MODEL_FAMILIES[family]
        zoo = [m for m in util.models() if not m.endswith("decoder")]
        sizes = []
        for key, label in MODEL_SIZES.items():
            name = f"vit_{key}{suffix}"
            if suffix == "" or name in zoo:
                sizes.append(label)
        return sizes

    def _update_model_type(self):
        options = self._model_size_options(self.model_family)
        self.model_size_field.setChoices(options)
        if self.model_size not in options:
            self.model_size_field.blockSignals(True)
            self.model_size_field.set(options[0])
            self.model_size_field.blockSignals(False)
        size_key = next((k for k, v in MODEL_SIZES.items() if v == self.model_size), "b")
        self.model_type = f"vit_{size_key}" + MODEL_FAMILIES[self.model_family]

    def _resolve_model_type(self):
        """Consolidate dropdown state into self.model_type (micro-sam's
        _validate_model_type_and_custom_weights)."""
        self._update_model_type()
        return self.model_type


class EmbeddingWidget(_ModelSelectionMixin, FormWidget):
    """Compute/load image embeddings (micro-sam's _widgets.py:1153).

    Headless usage: set ``widget.image`` (numpy array or duck-typed napari
    image layer) and call the widget. Under napari the annotator wires the
    selected image layer in before calling.
    """

    def __init__(self, parent=None):
        super().__init__(parent)
        self.image = None  # duck-typed image layer or raw array
        self._init_model_selection(util._DEFAULT_MODEL)
        self.device_field = self._add_choice_param(
            "device", "auto", ["auto"] + util._available_devices())
        self.save_path_field = self._add_path_param(
            "embeddings_save_path", None, "directory", title="embeddings save path:")
        self.custom_weights_field = self._add_path_param(
            "custom_weights", None, "file", title="custom weights path:")
        self.tile_x_field, self.tile_y_field = self._add_shape_param(
            ("tile_x", "tile_y"), (0, 0), min_val=0, max_val=2048, step=16)
        self.halo_x_field, self.halo_y_field = self._add_shape_param(
            ("halo_x", "halo_y"), (0, 0), min_val=0, max_val=512)
        self.auto_mode_field = self._add_choice_param(
            "automatic_segmentation_mode", "auto", ["auto", "amg", "ais"],
            title="automatic segmentation mode")
        self.run_button = self._add_button(
            "run", "Compute Embeddings", self.__call__)

    # -- validation ---------------------------------------------------------
    def _image_data(self):
        if self.image is None:
            return None
        return self.image.data if hasattr(self.image, "data") else np.asarray(self.image)

    def _validate_inputs(self) -> bool:
        """Check the save path for existing embeddings; adopt their settings
        or abort on signature mismatch (micro-sam's _widgets.py:1300-1390)."""
        image = self._image_data()
        if image is None:
            return generate_message("error", "No image has been selected.")

        path = self.embeddings_save_path
        if path and os.path.exists(path) and os.listdir(path):
            from ..utils import zarr_lite
            try:
                f = zarr_lite.open(path, mode="a")
                if "input_size" not in f.attrs:
                    return generate_message(
                        "error",
                        f"The embeddings at {path} are incomplete. "
                        "Specify a different path or remove them.",
                    )
                if "data_signature" in f.attrs:
                    img_signature = util._compute_data_signature(image)
                    if img_signature != f.attrs["data_signature"]:
                        return generate_message(
                            "error",
                            "The embeddings don't match with the image: "
                            f"{img_signature} {f.attrs['data_signature']}",
                        )
                # adopt the settings stored with the embeddings
                self.model_type = f.attrs.get("model_name", f.attrs.get("model_type"))
                tile_shape = f.attrs.get("tile_shape")
                if tile_shape:
                    self.tile_x, self.tile_y = tile_shape
                    self.halo_x, self.halo_y = f.attrs.get("halo", (0, 0))
                    msg = (f"Load embeddings for model: {self.model_type} with tile shape: "
                           f"{self.tile_x}, {self.tile_y} and halo: {self.halo_x}, {self.halo_y}.")
                else:
                    self.tile_x = self.tile_y = self.halo_x = self.halo_y = 0
                    msg = f"Load embeddings for model: {self.model_type}."
                return generate_message("info", msg)
            except RuntimeError as e:
                return generate_message("error", f"Failed to load image embeddings: {e}")
        return False

    def _update_model(self, state) -> None:
        """Push the active model's defaults into sibling widgets
        (micro-sam's _widgets.py:1203-1246)."""
        model_type = self.model_type
        if "autosegment" in state.widgets:
            sync_autosegment_widget(
                state.widgets["autosegment"], model_type, self.custom_weights,
                update_decoder=state.decoder is not None,
            )
            auto_widget = state.widgets["autosegment"]
            if getattr(auto_widget, "volumetric", False) and state.embedding_path:
                if state.decoder is not None:
                    state.amg_state = vutil._load_is_state(state.embedding_path)
                else:
                    state.amg_state = vutil._load_amg_state(state.embedding_path)
        if "segment_nd" in state.widgets:
            sync_ndsegment_widget(state.widgets["segment_nd"], model_type, self.custom_weights)

    def __call__(self, skip_validate: bool = False):
        model_type = self._resolve_model_type()
        if not skip_validate and self._validate_inputs():
            return

        image = self.image
        image_data = self._image_data()
        state = AnnotatorState()
        if state.image_embeddings is not None:
            if generate_message(
                "info",
                "Embeddings have already been precomputed. "
                "Press OK to recompute the embeddings.",
            ):
                state.skip_recomputing_embeddings = True
                return
        state.skip_recomputing_embeddings = False
        state.reset_state()

        rgb = image_data.ndim == 3 and image_data.shape[-1] == 3
        ndim = image_data.ndim - 1 if rgb else image_data.ndim
        state.image_shape = image_data.shape[:-1] if rgb else image_data.shape
        state.image_scale = tuple(getattr(image, "scale", None) or (1.0,) * ndim)
        state.image_name = getattr(image, "name", None)

        tile_shape, halo = _process_tiling_inputs(
            self.tile_x, self.tile_y, self.halo_x, self.halo_y)
        save_path = self.embeddings_save_path or None

        state.initialize_predictor(
            image_data, model_type=self.model_type, save_path=save_path, ndim=ndim,
            device=None if self.device == "auto" else self.device,
            checkpoint_path=self.custom_weights or None,
            tile_shape=tile_shape, halo=halo,
            prefer_decoder=self.automatic_segmentation_mode != "amg",
        )
        self._update_model(state)


def sync_embedding_widget(widget, model_type, save_path=None, checkpoint_path=None,
                          device=None, tile_shape=None, halo=None):
    """Reflect externally-chosen settings in the embedding widget (micro-sam's
    sam_annotator/util.py:678 _sync_embedding_widget)."""
    suffix = model_type[5:]
    family = {v: k for k, v in MODEL_FAMILIES.items()}.get(suffix)
    if family is not None:
        widget.model_family_field.blockSignals(True)
        widget.model_family = family
        widget.model_family_field.blockSignals(False)
    widget.model_size = MODEL_SIZES.get(model_type[4], "base")
    widget.model_type = model_type
    if save_path is not None:
        widget.embeddings_save_path = str(save_path)
    if checkpoint_path is not None:
        widget.custom_weights = str(checkpoint_path)
    if device is not None:
        widget.device = str(device)
    if tile_shape is not None:
        widget.tile_x, widget.tile_y = tile_shape
    if halo is not None:
        widget.halo_x, widget.halo_y = halo


def sync_autosegment_widget(widget, model_type, checkpoint_path=None,
                            update_decoder=None):
    """Apply the per-model AIS/AMG defaults (micro-sam's
    sam_annotator/util.py:727 _sync_autosegment_widget)."""
    if update_decoder is not None and hasattr(widget, "_reset_segmentation_mode"):
        widget._reset_segmentation_mode(update_decoder)
    kind = "ais" if getattr(widget, "with_decoder", False) else "amg"
    settings = get_model_settings(model_type, kind)
    for key, value in settings.items():
        if hasattr(widget, key):
            setattr(widget, key, value)


def sync_ndsegment_widget(widget, model_type, checkpoint_path=None):
    """Apply the per-model nd-segmentation defaults (micro-sam's
    sam_annotator/util.py:746 _sync_ndsegment_widget)."""
    settings = get_model_settings(model_type, "nd")
    if "projection_mode" in settings:
        widget.projection = settings["projection_mode"]
    if "iou_threshold" in settings:
        widget.iou_threshold = settings["iou_threshold"]


class SegmentWidget(FormWidget):
    """Interactive 2d segmentation button (micro-sam's magic_factory segment,
    _widgets.py:994)."""

    def __init__(self, viewer, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self._add_bool_param("batched", False, title="batched")
        self.run_button = self._add_button("run", "Segment Object [S]", self.__call__)

    def __call__(self):
        if _validate_embeddings(self._viewer) or _validate_layers(self._viewer):
            return
        state = AnnotatorState()
        seg = segment_2d(
            state, self._viewer.layers["point_prompts"], self._viewer.layers["prompts"],
            self._viewer.layers["current_object"].data.shape, batched=self.batched,
            previous_segmentation=self._viewer.layers["current_object"].data,
        )
        if seg is None:
            return
        self._viewer.layers["current_object"].data = seg.astype("uint32")
        self._viewer.layers["current_object"].refresh()


class SegmentSliceWidget(FormWidget):
    """Segment the current z-slice / frame (micro-sam's segment_slice /
    segment_frame factories, _widgets.py:1029/1070). ``tracking`` switches to
    per-track-id writes."""

    def __init__(self, viewer, tracking: bool = False, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.tracking = tracking
        title = "Segment Frame [S]" if tracking else "Segment Slice [S]"
        self.run_button = self._add_button("run", title, self.__call__)

    def __call__(self):
        if _validate_embeddings(self._viewer) or _validate_layers(self._viewer):
            return
        state = AnnotatorState()
        i = int(self._viewer.dims.point[0])
        shape = self._viewer.layers["current_object"].data.shape
        point_result = vutil.point_layer_to_prompts(
            self._viewer.layers["point_prompts"], i,
            track_id=state.current_track_id if self.tracking else None)
        if point_result is None:  # stop annotation
            return
        points, labels = point_result
        boxes, masks = vutil.shape_layer_to_prompts(
            self._viewer.layers["prompts"], shape[1:], i=i,
            track_id=state.current_track_id if self.tracking else None)
        seg = vutil.prompt_segmentation(
            state.predictor, points, labels, boxes, masks, shape[1:],
            multiple_box_prompts=False, image_embeddings=state.image_embeddings, i=i)
        if seg is None:
            return
        data = self._viewer.layers["current_object"].data
        if self.tracking:
            track_id = state.current_track_id or 1
            frame = data[i]
            frame[frame == track_id] = 0
            frame[seg == 1] = track_id
            data[i] = frame
        else:
            data[i] = seg
        self._viewer.layers["current_object"].data = data
        self._viewer.layers["current_object"].refresh()


class SegmentNDWidget(FormWidget):
    """Project the current object through the volume / the time series
    (micro-sam's _widgets.py:1497)."""

    def __init__(self, viewer, tracking: bool = False, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.tracking = tracking
        from ..multi_dimensional_segmentation import PROJECTION_MODES
        self._add_choice_param("projection", "single_point", list(PROJECTION_MODES))
        self._add_float_param("iou_threshold", 0.5)
        self._add_float_param("box_extension", 0.05)
        if tracking:
            self._add_float_param("motion_smoothing", 0.5)
        title = "Segment All Frames [Shift-S]" if tracking else "Segment All Slices [Shift-S]"
        self.run_button = self._add_button("run", title, self.__call__)

    def _run_volumetric_segmentation(self):
        state = AnnotatorState()
        seg, slices, stop_lower, stop_upper = vutil.segment_slices_with_prompts(
            state.predictor, self._viewer.layers["point_prompts"],
            self._viewer.layers["prompts"], state.image_embeddings, state.image_shape)
        seg, (z_min, z_max) = segment_mask_in_volume(
            seg, state.predictor, state.image_embeddings, slices,
            stop_lower, stop_upper, iou_threshold=self.iou_threshold,
            projection=self.projection, box_extension=self.box_extension)
        state.z_range = (z_min, z_max)
        self._viewer.layers["current_object"].data = seg
        self._viewer.layers["current_object"].refresh()

    def _run_tracking(self):
        state = AnnotatorState()
        shape = state.image_shape
        seg, slices, _, stop_upper = vutil.segment_slices_with_prompts(
            state.predictor, self._viewer.layers["point_prompts"],
            self._viewer.layers["prompts"], state.image_embeddings, shape,
            track_id=state.current_track_id)
        seg, has_division = vutil.track_from_prompts(
            self._viewer.layers["point_prompts"], self._viewer.layers["prompts"], seg,
            state.predictor, slices, state.image_embeddings, stop_upper,
            threshold=self.iou_threshold, projection=self.projection,
            motion_smoothing=self.motion_smoothing, box_extension=self.box_extension)
        if has_division and not state.lineage.get(state.current_track_id):
            _update_lineage(self._viewer)
        data = self._viewer.layers["current_object"].data
        data[data == state.current_track_id] = 0
        data[seg == 1] = state.current_track_id
        self._viewer.layers["current_object"].data = data
        self._viewer.layers["current_object"].refresh()

    def __call__(self):
        if _validate_embeddings(self._viewer) or _validate_layers(self._viewer):
            return
        return self._run_tracking() if self.tracking else self._run_volumetric_segmentation()


def _update_lineage(viewer):
    """Record a division event: spawn two daughter tracks (micro-sam's
    _widgets.py:1477)."""
    state = AnnotatorState()
    mother = state.current_track_id
    daughter1, daughter2 = mother + 1, mother + 2
    state.lineage[mother] = [daughter1, daughter2]
    state.lineage[daughter1] = []
    state.lineage[daughter2] = []
    tracking_widget = state.widgets.get("tracking")
    if tracking_widget is not None and hasattr(tracking_widget, "track_id_field"):
        tracking_widget.track_id_field.setChoices(
            [str(tid) for tid in state.lineage])


def _handle_amg_state(state, i, pbar_init=None, pbar_update=None):
    """Lazy-initialize the AMG/AIS state for 2d or per-slice use, with
    pickle/h5 cache writes (micro-sam's _widgets.py:1664)."""
    if state.amg is None:
        is_tiled = state.image_embeddings["input_size"] is None
        state.amg = instance_segmentation.get_instance_segmentation_generator(
            state.predictor, is_tiled=is_tiled, decoder=state.decoder)
    shape = state.image_shape
    if state.amg_state is not None:
        assert i is not None
        if i in state.amg_state:
            state.amg.set_state(state.amg_state[i])
            return
        dummy_image = np.zeros(shape[-2:], dtype="uint8")
        state.amg.initialize(
            dummy_image, image_embeddings=state.image_embeddings, i=i, verbose=False)
        amg_state_i = state.amg.get_state()
        state.amg_state[i] = amg_state_i
        cache_folder = state.amg_state.get("cache_folder")
        if cache_folder is not None:
            import pickle
            with open(os.path.join(cache_folder, f"state-{i}.pkl"), "wb") as f:
                pickle.dump(amg_state_i, f)
        cache_path = state.amg_state.get("cache_path")
        if cache_path is not None:
            import h5py
            with h5py.File(cache_path, "a") as f:
                g = f.create_group(f"state-{i}")
                for key in ("foreground", "boundary_distances", "center_distances"):
                    g.create_dataset(key, data=amg_state_i[key], compression="gzip")
    elif not getattr(state.amg, "is_initialized", False):
        assert i is None
        dummy_image = np.zeros(shape, dtype="uint8")
        state.amg.initialize(
            dummy_image, image_embeddings=state.image_embeddings, verbose=False)


def _instance_segmentation_impl(min_object_size, i=None, **kwargs):
    state = AnnotatorState()
    _handle_amg_state(state, i)
    seg = state.amg.generate(**kwargs)
    if isinstance(seg, list):
        seg = util.mask_data_to_segmentation(
            seg, with_background=True, min_object_size=min_object_size) \
            if seg else np.zeros(state.image_shape[-2:], dtype="uint32")
    return np.asarray(seg)


class AutoSegmentWidget(FormWidget):
    """Automatic segmentation (AMG or AIS) of the current slice / volume
    (micro-sam's _widgets.py:1725)."""

    def __init__(self, viewer, with_decoder: bool, volumetric: bool, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.with_decoder = with_decoder
        self.volumetric = volumetric
        self._create_widget()

    def _create_widget(self):
        if self.volumetric:
            self._add_bool_param("apply_to_volume", False, title=self._volume_switch_title())
        if self.with_decoder:
            self._add_float_param("center_distance_thresh", 0.5)
            self._add_float_param("boundary_distance_thresh", 0.5)
        else:
            self._add_float_param("pred_iou_thresh", 0.88)
            self._add_float_param("stability_score_thresh", 0.95)
            self._add_float_param("box_nms_thresh", 0.7)
        self._add_int_param("min_object_size", 100, min_val=0, max_val=10000)
        if self.volumetric:
            self._add_int_param("gap_closing", 2, min_val=0, max_val=10)
            self._add_int_param("min_extent", 2, min_val=0, max_val=10)
        self.run_button = self._add_button("run", self._run_title(), self.__call__)

    def _volume_switch_title(self):
        return "Apply to Volume"

    def _run_title(self):
        return "Automatic Segmentation"

    def _reset_segmentation_mode(self, with_decoder: bool):
        """Rebuild the settings when the decoder availability changes
        (micro-sam's _widgets.py:1749)."""
        if with_decoder == self.with_decoder:
            return
        self.with_decoder = with_decoder
        self._fields.clear()
        self._buttons.clear()
        if HAVE_QT:
            layout = self.layout()
            while layout.count():
                child = layout.takeAt(0)
                if child.widget():
                    child.widget().deleteLater()
        self._create_widget()

    def _segmentation_kwargs(self):
        if self.with_decoder:
            return {
                "center_distance_threshold": self.center_distance_thresh,
                "boundary_distance_threshold": self.boundary_distance_thresh,
                "min_size": self.min_object_size,
            }
        return {
            "pred_iou_thresh": self.pred_iou_thresh,
            "stability_score_thresh": self.stability_score_thresh,
            "box_nms_thresh": self.box_nms_thresh,
            "output_mode": "instance_segmentation",
            "min_mask_region_area": self.min_object_size,
        }

    def _empty_segmentation_warning(self):
        msg = ("The automatic segmentation result does not contain any objects. "
               "Setting a smaller value for 'min_object_size' may help.")
        if not self.with_decoder:
            msg += (" Setting smaller values for 'pred_iou_thresh' and "
                    "'stability_score_thresh' may also help.")
        return generate_message("error", msg)

    def _run_segmentation_2d(self, kwargs, i=None):
        _validate_layers(self._viewer, automatic_segmentation=True)
        seg = _instance_segmentation_impl(self.min_object_size, i=i, **kwargs)
        if seg.max() == 0:
            self._empty_segmentation_warning()
        layer = self._viewer.layers["auto_segmentation"]
        if i is None:
            layer.data = seg.astype(layer.data.dtype)
        else:
            data = layer.data
            data[i] = seg
            layer.data = data
        layer.refresh()

    def _allow_segment_3d(self):
        """AMG over a whole volume is only allowed with precomputed state or
        an accelerator (micro-sam's _widgets.py:1906)."""
        if self.with_decoder:
            return True
        state = AnnotatorState()
        if str(getattr(state.predictor, "device", "cpu")) in ("cpu", "mps"):
            n_slices = self._viewer.layers["auto_segmentation"].data.shape[0]
            precomputed = state.amg_state is not None and len(state.amg_state) > n_slices
            return precomputed
        return True

    def _run_segmentation_3d(self, kwargs):
        if not self._allow_segment_3d():
            return generate_message(
                "error", "Volumetric segmentation with AMG is only supported "
                "if you have a GPU.")
        segmentation = np.zeros_like(self._viewer.layers["auto_segmentation"].data)
        offset = 0
        for i in range(segmentation.shape[0]):
            seg = _instance_segmentation_impl(self.min_object_size, i=i, **kwargs)
            seg_max = int(seg.max())
            if seg_max == 0:
                continue
            seg[seg != 0] += offset
            offset += seg_max
            segmentation[i] = seg
        segmentation = merge_instance_segmentation_3d(
            segmentation, beta=0.5, gap_closing=self.gap_closing,
            min_z_extent=self.min_extent, verbose=False)
        if segmentation.max() == 0:
            self._empty_segmentation_warning()
        layer = self._viewer.layers["auto_segmentation"]
        layer.data = segmentation.astype(layer.data.dtype)
        layer.refresh()

    def __call__(self):
        if _validate_embeddings(self._viewer):
            return
        kwargs = self._segmentation_kwargs()
        if self.volumetric and self.apply_to_volume:
            self._run_segmentation_3d(kwargs)
        elif self.volumetric:
            self._run_segmentation_2d(kwargs, i=int(self._viewer.dims.point[0]))
        else:
            self._run_segmentation_2d(kwargs)


class AutoTrackWidget(AutoSegmentWidget):
    """Automatic tracking: per-frame segmentation + greedy linking
    (micro-sam's _widgets.py:2004)."""

    def _volume_switch_title(self):
        return "Track Timeseries"

    def _run_title(self):
        return "Automatic Tracking"

    def _run_segmentation_3d(self, kwargs):
        if not self._allow_segment_3d():
            return generate_message(
                "error", "Tracking with AMG is only supported if you have a GPU.")
        state = AnnotatorState()
        if state.committed_lineages:
            return generate_message(
                "error",
                "Automatic tracking can only be called if you haven't "
                "committed results from interactive tracking yet.")
        from ..multi_dimensional_segmentation import track_across_frames
        image_name = state.image_name
        timeseries = (self._viewer.layers[image_name].data
                      if image_name and image_name in self._viewer.layers else None)
        segmentation = np.zeros_like(self._viewer.layers["auto_segmentation"].data)
        offset = 0
        for i in range(segmentation.shape[0]):
            seg = _instance_segmentation_impl(self.min_object_size, i=i, **kwargs)
            seg_max = int(seg.max())
            if seg_max == 0:
                continue
            seg[seg != 0] += offset
            offset += seg_max
            segmentation[i] = seg
        segmentation, lineages = track_across_frames(
            timeseries, segmentation, verbose=False)
        if segmentation.max() == 0:
            self._empty_segmentation_warning()
        state.lineage = lineages
        layer = self._viewer.layers["auto_segmentation"]
        layer.data = segmentation.astype(layer.data.dtype)
        layer.refresh()


class CommitWidget(FormWidget):
    """Commit segmented objects into 'committed_objects', optionally into a
    persistent zarr commit file (micro-sam's commit magic_factory,
    _widgets.py:729)."""

    def __init__(self, viewer, tracking: bool = False, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.tracking = tracking
        self._add_choice_param("layer", "current_object",
                               ["current_object", "auto_segmentation"])
        self._add_choice_param("preserve_mode", "objects", ["objects", "pixels", "none"])
        self._add_float_param("preservation_threshold", 0.75)
        self._add_path_param("commit_path", None, "directory", title="commit path:")
        self.run_button = self._add_button("run", "Commit [C]", self.__call__)

    def __call__(self):
        state = AnnotatorState()
        if state.annotator is not None:
            state.annotator._require_layers(layer_choices=[self.layer, "committed_objects"])
        committed_layer = self._viewer.layers["committed_objects"]
        source_layer = self._viewer.layers[self.layer]
        committed = commit_segmentation(
            committed_layer.data, source_layer.data,
            preserve_mode=self.preserve_mode, z_range=state.z_range,
            preservation_threshold=self.preservation_threshold,
        )
        if self.commit_path:
            commit_to_file(
                str(self.commit_path), committed_layer.data, source_layer.data,
                point_prompts=self._viewer.layers.get("point_prompts"),
                shape_prompts=self._viewer.layers.get("prompts"),
                data_signature=state.data_signature,
                preserve_mode=self.preserve_mode, z_range=state.z_range,
            )
        committed_layer.data = committed
        committed_layer.refresh()
        if self.tracking and state.lineage is not None:
            if state.committed_lineages is None:
                state.committed_lineages = []
            state.committed_lineages.append(dict(state.lineage))
            _reset_tracking_state(self._viewer)
        # reset the source layer and the prompts
        source_layer.data = np.zeros_like(source_layer.data)
        source_layer.refresh()
        clear_annotations(
            self._viewer.layers.get("point_prompts"), self._viewer.layers.get("prompts"))
        state.z_range = None


def _reset_tracking_state(viewer):
    """Reset lineage/track-id state after committing a track
    (micro-sam's _widgets.py:408)."""
    state = AnnotatorState()
    state.current_track_id = 1
    state.lineage = {1: []}
    tracking_widget = state.widgets.get("tracking")
    if tracking_widget is not None and hasattr(tracking_widget, "track_id_field"):
        tracking_widget.track_id_field.setChoices(["1"])
        tracking_widget.track_id = "1"


class ClearWidget(FormWidget):
    """Clear the prompt layers and the current object
    (micro-sam's clear/clear_volume/clear_track factories)."""

    def __init__(self, viewer, volumetric: bool = False, tracking: bool = False, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.tracking = tracking
        if volumetric or tracking:
            self._add_bool_param("all_slices", True, title="Clear all slices")
        self.run_button = self._add_button(
            "run", "Clear Annotations [Shift-C]", self.__call__)

    def __call__(self):
        if self.tracking:
            _reset_tracking_state(self._viewer)
        clear_annotations(
            self._viewer.layers.get("point_prompts"), self._viewer.layers.get("prompts"))
        layer = self._viewer.layers.get("current_object")
        if layer is not None:
            layer.data = np.zeros_like(layer.data)
            layer.refresh()


class TrackingMenuWidget(FormWidget):
    """Track-id / division-state menu for the tracking annotator (micro-sam's
    annotator_tracking.py:24)."""

    def __init__(self, viewer, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self.track_id_field = self._add_choice_param("track_id", "1", ["1"])
        self.state_field = self._add_choice_param("state", "track", ["track", "division"])
        self.track_id_field.changed.connect(self._on_track_id)

    def _on_track_id(self, value):
        AnnotatorState().current_track_id = int(value)


def commit_to_file(
    path: str,
    committed_objects: np.ndarray,
    current_segmentation: np.ndarray,
    point_prompts=None,
    shape_prompts=None,
    data_signature: Optional[str] = None,
    preserve_mode: str = "objects",
    z_range: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Commit into a persistent zarr commit file (micro-sam's _widgets.py:588):
    committed_objects dataset, per-object prompt groups, commit_history attr
    and a data-signature guard."""
    import json
    from ..utils import zarr_lite

    f = zarr_lite.open(str(path), mode="a")

    # data signature guard: refuse to mix commits from different images
    saved_sig = f.attrs.get("data_signature")
    if saved_sig is not None and data_signature is not None and saved_sig != data_signature:
        raise RuntimeError(
            f"The commit file at {path} was created for data with signature "
            f"{saved_sig}, but the current data has signature {data_signature}."
        )
    if data_signature is not None:
        f.attrs["data_signature"] = data_signature

    committed = commit_segmentation(
        committed_objects, current_segmentation, preserve_mode, z_range
    )

    ds = f.require_dataset(
        "committed_objects", shape=committed.shape, dtype="uint32",
        chunks=(min(512, committed.shape[-2]), min(512, committed.shape[-1]))
        if committed.ndim == 2 else None,
    )
    ds[...] = committed.astype(np.uint32)

    # record the prompts that produced this commit
    new_ids = sorted(
        set(np.unique(committed).tolist()) - set(np.unique(committed_objects).tolist())
    )
    prompt_group = f.require_group("prompts")
    for oid in new_ids:
        g = prompt_group.require_group(f"object-{oid}")
        if point_prompts is not None and len(point_prompts.data):
            g.create_dataset("points", data=np.asarray(point_prompts.data, dtype="float32"),
                             overwrite=True)
            labels = point_prompts.properties.get("label")
            if labels is not None:
                g.attrs["point_labels"] = [str(l) for l in labels]
        if shape_prompts is not None and len(shape_prompts.data):
            for k, box in enumerate(shape_prompts.data):
                g.create_dataset(f"box-{k}", data=np.asarray(box, dtype="float32"),
                                 overwrite=True)

    history = f.attrs.get("commit_history", [])
    history.append({"new_ids": [int(i) for i in new_ids]})
    f.attrs["commit_history"] = history
    return committed


class SettingsWidget(FormWidget):
    """Global settings widget: choose the model/embedding cache directory
    (micro-sam's settings_widget magic_factory, _widgets.py:873)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        from .. import util as _util
        self._add_path_param(
            "cache_directory", _util.microsam_cachedir(), select_type="directory",
            title="cache directory",
            tooltip="Path used for model downloads and embedding caches "
                    "(MICROSAM_CACHEDIR).",
        )
        self.run_button = self._add_button(
            "run", "Update settings", self.__call__)

    def __call__(self):
        import os
        os.environ["MICROSAM_CACHEDIR"] = str(self.cache_directory)
        print(f"micro-sam-tpu cache directory set to: {self.cache_directory}")


def settings_widget(cache_directory=None, parent=None) -> SettingsWidget:
    """Factory for the napari 'Settings' widget contribution. Passing
    ``cache_directory`` applies it immediately (micro-sam's _widgets.py
    settings_widget updates MICROSAM_CACHEDIR)."""
    import os as _os
    if cache_directory is not None:
        _os.environ["MICROSAM_CACHEDIR"] = str(cache_directory)
    return SettingsWidget(parent=parent)


# -----------------------------------------------------------------------------
# Module-level widget surface (micro-sam's _widgets.py:359-1110): micro-sam
# exposes these as magicgui factories / Qt classes; here they are viewer-level
# functions over the same internals, runnable under real napari or headless.
# -----------------------------------------------------------------------------

from ._compat import Signal as _Signal  # noqa: E402


class PBarSignals:
    """Progress-bar signal bundle (micro-sam's _widgets.py:359): connect
    callbacks to ``pbar_total`` / ``pbar_update`` / ``pbar_description`` /
    ``pbar_stop`` / ``pbar_reset`` and pass the emitters into workers."""

    def __init__(self):
        self.pbar_total = _Signal()
        self.pbar_update = _Signal()
        self.pbar_description = _Signal()
        self.pbar_stop = _Signal()
        self.pbar_reset = _Signal()


class InfoDialog:
    """Ok/Cancel message dialog (micro-sam's _widgets.py:367). Renders a real
    QDialog when Qt is available; headless it auto-accepts."""

    def __init__(self, title: str, message: str):
        self.title = title
        self.message = message
        self._dialog = None
        if HAVE_QT:
            try:
                from qtpy import QtWidgets

                dialog = QtWidgets.QDialog()
                dialog.setWindowTitle(title)
                layout = QtWidgets.QVBoxLayout()
                layout.addWidget(QtWidgets.QLabel(message))
                buttons = QtWidgets.QHBoxLayout()
                ok = QtWidgets.QPushButton("OK")
                ok.clicked.connect(dialog.accept)
                buttons.addWidget(ok)
                cancel = QtWidgets.QPushButton("Cancel")
                cancel.clicked.connect(dialog.reject)
                buttons.addWidget(cancel)
                layout.addLayout(buttons)
                dialog.setLayout(layout)
                self._dialog = dialog
            except Exception:
                self._dialog = None

    def exec_(self) -> int:
        if self._dialog is not None:
            return self._dialog.exec_()
        return 1  # headless: accepted

    exec = exec_


def clear(viewer) -> None:
    """Clear the prompt annotations (micro-sam's _widgets.py:435)."""
    import gc

    clear_annotations(viewer.layers.get("point_prompts"), viewer.layers.get("prompts"))
    gc.collect()


def clear_volume(viewer, all_slices: bool = True) -> None:
    """Clear 3d annotations, either all slices or the current one
    (micro-sam's _widgets.py:448)."""
    import gc

    if all_slices:
        clear_annotations(
            viewer.layers.get("point_prompts"), viewer.layers.get("prompts"))
    else:
        vutil.clear_annotations_slice(viewer, i=int(viewer.dims.point[0]))
    gc.collect()


def clear_track(viewer, all_frames: bool = True) -> None:
    """Clear tracking annotations and state (micro-sam's _widgets.py:466)."""
    import gc

    if all_frames:
        _reset_tracking_state(viewer)
        clear_annotations(
            viewer.layers.get("point_prompts"), viewer.layers.get("prompts"))
    else:
        vutil.clear_annotations_slice(viewer, i=int(viewer.dims.point[0]))
    gc.collect()


def segment(viewer, batched: bool = False) -> None:
    """Segment the current object from the prompt layers
    (micro-sam's _widgets.py:995)."""
    if _validate_embeddings(viewer) or _validate_layers(viewer):
        return None
    layer = viewer.layers["current_object"]
    seg = segment_2d(
        AnnotatorState(), viewer.layers.get("point_prompts"),
        viewer.layers.get("prompts"), layer.data.shape, batched=batched,
        previous_segmentation=layer.data,
    )
    if seg is None:
        print("You either haven't provided any prompts or invalid prompts. "
              "The segmentation will be skipped.")
        return None
    layer.data = seg.astype("uint32")
    layer.refresh()


def segment_frame(viewer) -> None:
    """Segment the current track in the current timeframe
    (micro-sam's _widgets.py:1071)."""
    if _validate_embeddings(viewer) or _validate_layers(viewer):
        return None
    state = AnnotatorState()
    t = int(viewer.dims.point[0])
    shape = viewer.layers["current_object"].data.shape[1:]

    point_prompts = vutil.point_layer_to_prompts(
        viewer.layers["point_prompts"], i=t, track_id=state.current_track_id)
    if point_prompts is None:
        return None
    boxes, masks = vutil.shape_layer_to_prompts(
        viewer.layers["prompts"], shape, i=t, track_id=state.current_track_id)
    points, labels = point_prompts

    seg = vutil.prompt_segmentation(
        state.predictor, points, labels, boxes, masks, shape,
        multiple_box_prompts=False, image_embeddings=state.image_embeddings, i=t,
    )
    if seg is None:
        print("You either haven't provided any prompts or invalid prompts. "
              "The segmentation will be skipped.")
        return None

    frame = viewer.layers["current_object"].data[t]
    frame[frame == state.current_track_id] = 0
    frame[np.squeeze(seg) == 1] = state.current_track_id
    viewer.layers["current_object"].data[t] = frame
    viewer.layers["current_object"].refresh()


def commit(viewer, layer: str = "current_object", preserve_mode: str = "objects",
           commit_path=None, preservation_threshold: float = 0.75) -> None:
    """Commit the selected layer into 'committed_objects'
    (micro-sam's _widgets.py:735)."""
    widget = CommitWidget(viewer)
    widget.layer = layer
    widget.preserve_mode = preserve_mode
    widget.commit_path = commit_path
    widget.preservation_threshold = preservation_threshold
    widget()


def commit_track(viewer, layer: str = "current_object",
                 preserve_mode: str = "objects", commit_path=None,
                 preservation_threshold: float = 0.75) -> None:
    """Commit the current track and reset the tracking state
    (micro-sam's _widgets.py:781)."""
    widget = CommitWidget(viewer, tracking=True)
    widget.layer = layer
    widget.preserve_mode = preserve_mode
    widget.commit_path = commit_path
    widget.preservation_threshold = preservation_threshold
    widget()


def create_prompt_menu(points_layer, labels, menu_name: str = "prompt",
                       label_name: str = "label"):
    """Menu for toggling the point-prompt label (micro-sam's _widgets.py:846).
    Returns a FormWidget whose ``label`` field mirrors the points layer's
    current properties in both directions."""
    widget = FormWidget()
    field = widget._add_choice_param(label_name, str(labels[0]), [str(l) for l in labels],
                                     title=menu_name)

    def label_changed(new_label):
        current = dict(getattr(points_layer, "current_properties", {}) or {})
        current[label_name] = np.array([new_label])
        points_layer.current_properties = current
        if hasattr(points_layer, "refresh_colors"):
            points_layer.refresh_colors()

    field.changed.connect(label_changed)

    events = getattr(points_layer, "events", None)
    if events is not None and hasattr(events, "current_properties"):
        def update_menu(event):
            new_label = str(points_layer.current_properties[label_name][0])
            if new_label != field.get():
                field.set(new_label)
        events.current_properties.connect(update_menu)

    return widget
