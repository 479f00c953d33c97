"""The annotator scaffold (counterpart of ``micro_sam_tpu/sam_annotator/_annotator.py``,
micro-sam's sam_annotator/_annotator.py).

Defines the viewer-layer contract (current_object, auto_segmentation,
committed_objects, point_prompts, prompts), the docked widget stack
(embedding, segment, [segment_nd], autosegment, commit, clear) and the
keybindings (S segment, C commit, Shift-S nd-segment, Shift-C clear,
T toggle label).

Works against any viewer implementing the napari duck-type (layers mapping
with .data/.refresh, dims.point, add_labels/add_points/add_shapes, bind_key)
so the whole stack runs headless; the public ``annotator_2d`` etc. entry
points create real napari viewers when given none.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import util as vutil
from . import _widgets as widgets
from ._compat import HAVE_QT, QScrollAreaBase
from ._state import AnnotatorState

# The layer contract every annotator maintains (checked by tests).
ANNOTATOR_LAYERS = (
    "current_object", "auto_segmentation", "committed_objects",
    "point_prompts", "prompts",
)


class _AnnotatorBase(QScrollAreaBase):
    """Base class wiring viewer layers, the widget stack and keybindings
    (micro-sam's _annotator.py:14)."""

    def __init__(self, viewer, ndim: int):
        super().__init__()
        self._viewer = viewer
        self._ndim = ndim
        self._shape = (256, 256) if ndim == 2 else (16, 256, 256)
        self._require_layers()
        self._create_widgets()
        AnnotatorState().widgets = self._widgets
        AnnotatorState().annotator = self
        self._create_keybindings()
        if HAVE_QT:
            self._build_qt_stack()

    # ------------------------------------------------------------------
    # layers
    # ------------------------------------------------------------------
    def _require_layers(self, layer_choices: Optional[List[str]] = None):
        state = AnnotatorState()
        shape = self._shape if state.image_shape is None else state.image_shape
        scale = state.image_scale

        for name in ("current_object", "auto_segmentation", "committed_objects"):
            if name not in self._viewer.layers:
                if layer_choices and name in layer_choices:
                    widgets.generate_message(
                        "error", f"The '{name}' layer was missing and has been re-added. "
                        "Please re-annotate and try again.")
                self._viewer.add_labels(data=np.zeros(shape, dtype="uint32"), name=name)
                if scale is not None:
                    self._viewer.layers[name].scale = scale

        self._point_labels = ["positive", "negative"]
        if "point_prompts" not in self._viewer.layers:
            self._viewer.add_points(
                name="point_prompts",
                property_choices={"label": self._point_labels},
                ndim=self._ndim,
            )
        if "prompts" not in self._viewer.layers:
            self._viewer.add_shapes(name="prompts", ndim=self._ndim)

    # ------------------------------------------------------------------
    # widgets
    # ------------------------------------------------------------------
    def _get_widgets(self) -> dict:
        """Child classes add their plugin-specific widgets here."""
        raise NotImplementedError

    def _create_widgets(self):
        self._embedding_widget = widgets.EmbeddingWidget()
        self._embedding_widget.run_button.clicked.connect(
            lambda *_: self._update_image())
        self._widgets = {"embeddings": self._embedding_widget}
        self._widgets.update(self._get_widgets())

    def _create_keybindings(self):
        viewer = self._viewer
        if not hasattr(viewer, "bind_key"):
            return

        @viewer.bind_key("s", overwrite=True)
        def _segment(v):
            self._widgets["segment"]()

        @viewer.bind_key("c", overwrite=True)
        def _commit(v):
            self._widgets["commit"]()

        @viewer.bind_key("t", overwrite=True)
        def _toggle(v):
            vutil.toggle_label(self._viewer.layers["point_prompts"])

        @viewer.bind_key("Shift-C", overwrite=True)
        def _clear(v):
            self._widgets["clear"]()

        if "segment_nd" in self._widgets:
            @viewer.bind_key("Shift-S", overwrite=True)
            def _seg_nd(v):
                self._widgets["segment_nd"]()

    def _build_qt_stack(self):
        from qtpy import QtWidgets as QtW
        container = QtW.QWidget()
        container.setLayout(QtW.QVBoxLayout())
        for widget in self._widgets.values():
            frame = QtW.QGroupBox()
            layout = QtW.QVBoxLayout()
            layout.addWidget(widget.native if hasattr(widget, "native") else widget)
            frame.setLayout(layout)
            container.layout().addWidget(frame)
        self.setWidgetResizable(True)
        self.setWidget(container)

    # ------------------------------------------------------------------
    # image updates
    # ------------------------------------------------------------------
    def _update_image(self, segmentation_result=None):
        state = AnnotatorState()
        if getattr(state, "skip_recomputing_embeddings", False):
            return
        if state.image_shape is None:
            return
        if state.image_shape != self._shape:
            if len(state.image_shape) != self._ndim:
                raise RuntimeError(
                    f"The dim of the annotator {self._ndim} does not match "
                    f"the image data of shape {state.image_shape}.")
            self._shape = state.image_shape

        self._require_layers()
        scale = state.image_scale
        for name in ("current_object", "auto_segmentation"):
            self._viewer.layers[name].data = np.zeros(self._shape, dtype="uint32")
            if scale is not None:
                self._viewer.layers[name].scale = scale
        if segmentation_result is None or segmentation_result is False:
            self._viewer.layers["committed_objects"].data = np.zeros(
                self._shape, dtype="uint32")
        else:
            self._viewer.layers["committed_objects"].data = segmentation_result
        if scale is not None:
            self._viewer.layers["committed_objects"].scale = scale
        widgets.clear_annotations(
            self._viewer.layers["point_prompts"], self._viewer.layers["prompts"])


class Annotator2d(_AnnotatorBase):
    def __init__(self, viewer, reset_state: bool = True):
        super().__init__(viewer, ndim=2)
        if reset_state:
            AnnotatorState().reset_state()

    def _get_widgets(self):
        state = AnnotatorState()
        return {
            "segment": widgets.SegmentWidget(self._viewer),
            "autosegment": widgets.AutoSegmentWidget(
                self._viewer, with_decoder=state.decoder is not None, volumetric=False),
            "commit": widgets.CommitWidget(self._viewer),
            "clear": widgets.ClearWidget(self._viewer),
        }


class Annotator3d(_AnnotatorBase):
    def __init__(self, viewer, reset_state: bool = True):
        super().__init__(viewer, ndim=3)
        if reset_state:
            AnnotatorState().reset_state()

    def _get_widgets(self):
        state = AnnotatorState()
        return {
            "segment": widgets.SegmentSliceWidget(self._viewer),
            "segment_nd": widgets.SegmentNDWidget(self._viewer, tracking=False),
            "autosegment": widgets.AutoSegmentWidget(
                self._viewer, with_decoder=state.decoder is not None, volumetric=True),
            "commit": widgets.CommitWidget(self._viewer),
            "clear": widgets.ClearWidget(self._viewer, volumetric=True),
        }


class AnnotatorTracking(_AnnotatorBase):
    def __init__(self, viewer, reset_state: bool = True):
        state = AnnotatorState()
        if reset_state:
            state.reset_state()
        state.current_track_id = 1
        state.lineage = {1: []}
        state.committed_lineages = []
        super().__init__(viewer, ndim=3)

    def _get_widgets(self):
        state = AnnotatorState()
        return {
            "tracking": widgets.TrackingMenuWidget(self._viewer),
            "segment": widgets.SegmentSliceWidget(self._viewer, tracking=True),
            "segment_nd": widgets.SegmentNDWidget(self._viewer, tracking=True),
            "autosegment": widgets.AutoTrackWidget(
                self._viewer, with_decoder=state.decoder is not None, volumetric=True),
            "commit": widgets.CommitWidget(self._viewer, tracking=True),
            "clear": widgets.ClearWidget(self._viewer, tracking=True),
        }
