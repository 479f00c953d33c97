"""The object classifier (counterpart of
``micro_sam_tpu/sam_annotator/object_classifier.py``).

Object features from the port's embeddings, labels painted on objects
accumulated over images, a random forest (sklearn) trained on them, its
prediction projected onto the segmentation. Runs on any napari-duck-typed
viewer.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ._state import AnnotatorState
from ._widgets import _require_napari
from .. import util
from ..object_classification import (
    compute_object_features, project_prediction_to_segmentation,
    run_prediction_with_classifier, train_classifier,
)


def _accumulate_labels(segmentation: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """Map brush-stroke annotations to per-object majority labels (micro-sam's
    object_classifier.py:32)."""
    ids = np.unique(segmentation)
    ids = ids[ids != 0]
    labels = np.zeros(len(ids), dtype="int32")
    for k, oid in enumerate(ids):
        ann = annotations[segmentation == oid]
        ann = ann[ann != 0]
        if len(ann) == 0:
            continue
        vals, counts = np.unique(ann, return_counts=True)
        labels[k] = vals[np.argmax(counts)]
    return labels


class ObjectClassifierWorkflow:
    """Headless object-classification workflow over one or more images."""

    def __init__(self, predictor=None, model_type: str = util._DEFAULT_MODEL, device=None):
        self._predictor = predictor
        self._model = (model_type, device)
        self.features: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        self._current = None  # (seg_ids, features, segmentation)
        self.rf = None

    @property
    def predictor(self):
        """The predictor given, or the model loaded on first use (on ``device``:
        the GPU by default; "cpu")."""
        if self._predictor is None:
            model_type, device = self._model
            self._predictor = util.get_sam_model(model_type=model_type, device=device)
        return self._predictor

    def set_image(self, image: np.ndarray, segmentation: np.ndarray,
                  embedding_path: Optional[str] = None,
                  image_embeddings=None) -> None:
        emb = image_embeddings if image_embeddings is not None else \
            util.precompute_image_embeddings(
                self.predictor, image, embedding_path, verbose=False)
        seg_ids, feats = compute_object_features(emb, segmentation)
        self._current = (seg_ids, feats, segmentation)
        self._current_added = False

    def add_annotations(self, annotations: np.ndarray) -> int:
        """Accumulate labels from an annotation (brush) layer; returns the
        number of labeled objects added. Calling again for the same image
        replaces that image's previous contribution (idempotent re-training)."""
        seg_ids, feats, segmentation = self._current
        labels = _accumulate_labels(segmentation, annotations)
        mask = labels != 0
        if getattr(self, "_current_added", False):
            self.features.pop()
            self.labels.pop()
        self.features.append(feats[mask])
        self.labels.append(labels[mask])
        self._current_added = True
        return int(mask.sum())

    def train_and_predict(self) -> np.ndarray:
        """Train the RF on all accumulated labels, predict the current image
        (micro-sam's object_classifier.py:66)."""
        X = np.concatenate(self.features)
        y = np.concatenate(self.labels)
        self.rf = train_classifier(X, y)
        seg_ids, feats, segmentation = self._current
        pred = run_prediction_with_classifier(self.rf, feats)
        return project_prediction_to_segmentation(segmentation, pred.astype(np.uint32), seg_ids)

    def export_rf(self, path: str) -> None:
        import pickle
        with open(path, "wb") as f:
            pickle.dump(self.rf, f)


class ObjectClassifier:
    """Viewer-bound object-classifier widget stack (micro-sam's
    object_classifier.py:63-247): 'annotations' brush layer for object labels,
    'prediction' output layer, train-and-predict + export actions. Duck-typed
    viewer, so the whole stack runs headless."""

    def __init__(self, viewer, workflow: Optional[ObjectClassifierWorkflow] = None):
        from ._compat import FormWidget

        self._viewer = viewer
        # default workflow so the napari widget contribution is constructible
        # from the viewer alone (manifest: object_classifier:ObjectClassifier)
        self._workflow = workflow if workflow is not None else ObjectClassifierWorkflow()
        self._require_layers()

        this = self

        class _TrainWidget(FormWidget):
            def __init__(self):
                super().__init__()
                self.run_button = self._add_button(
                    "run", "Train and predict", this.train_and_predict)

        class _ExportWidget(FormWidget):
            def __init__(self):
                super().__init__()
                self._add_string_param("export_path", "", title="Export Path")
                self.run_button = self._add_button(
                    "run", "Export Classifier", this.export_rf)

        self._widgets = {"train": _TrainWidget(), "export": _ExportWidget()}
        state = AnnotatorState()
        state.annotator = self
        state.widgets = self._widgets

    def _require_layers(self):
        state = AnnotatorState()
        shape = state.image_shape or (256, 256)
        for name in ("annotations", "prediction"):
            if name not in self._viewer.layers:
                self._viewer.add_labels(
                    data=np.zeros(shape, dtype="uint32"), name=name)

    def _update_image(self):
        state = AnnotatorState()
        if state.image_shape is None:
            return
        self._require_layers()
        for name in ("annotations", "prediction"):
            self._viewer.layers[name].data = np.zeros(
                state.image_shape, dtype="uint32")

    def train_and_predict(self):
        """Accumulate the brush labels of the current image, train the RF on
        everything seen so far and write the prediction layer."""
        annotations = np.asarray(self._viewer.layers["annotations"].data)
        self._workflow.add_annotations(annotations)
        if sum(len(l) for l in self._workflow.labels) == 0:
            print("No objects have been labeled yet; paint object labels in "
                  "the 'annotations' layer first.")
            return None
        pred = self._workflow.train_and_predict()
        self._viewer.layers["prediction"].data = pred
        self._viewer.layers["prediction"].refresh()
        return pred

    def export_rf(self):
        path = self._widgets["export"].export_path
        if not path:
            print("Please set an export path for the classifier.")
            return
        if self._workflow.rf is None:
            print("Train the classifier before exporting it.")
            return
        self._workflow.export_rf(str(path))


def object_classifier(
    image: np.ndarray,
    segmentation: np.ndarray,
    embedding_path=None,
    model_type: str = util._DEFAULT_MODEL,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    return_viewer: bool = False,
    viewer=None,
    checkpoint_path: Optional[str] = None,
    device=None,
    ndim: Optional[int] = None,
):
    """Start the object classifier (micro-sam's object_classifier.py:312).

    Works against any napari-duck-typed viewer; ``return_viewer=True``
    returns it instead of entering the napari event loop.
    """
    if ndim is None:
        ndim = image.ndim - 1 if image.shape[-1] == 3 and image.ndim in (3, 4) \
            else image.ndim

    state = AnnotatorState()
    state.image_shape = image.shape[:ndim]
    state.initialize_predictor(
        image, model_type=model_type, save_path=embedding_path,
        halo=halo, tile_shape=tile_shape, precompute_amg_state=False,
        ndim=ndim, checkpoint_path=checkpoint_path, device=device,
        skip_load=False,
    )

    workflow = ObjectClassifierWorkflow(predictor=state.predictor)
    workflow.set_image(image, segmentation,
                       image_embeddings=state.image_embeddings)

    if viewer is None:
        _require_napari()
        import napari
        viewer = napari.Viewer()
    viewer.add_image(image, name="image")
    viewer.add_labels(segmentation, name="segmentation")

    annotator = ObjectClassifier(viewer, workflow)
    annotator._update_image()
    if hasattr(viewer, "window") and hasattr(viewer.window, "add_dock_widget"):
        viewer.window.add_dock_widget(annotator)

    if return_viewer:
        return viewer
    _require_napari()
    import napari
    napari.run()


def image_series_object_classifier(
    images: List[np.ndarray],
    segmentations: List[np.ndarray],
    output_folder: str,
    embedding_paths: Optional[List] = None,
    model_type: str = util._DEFAULT_MODEL,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    checkpoint_path: Optional[str] = None,
    device=None,
    ndim: Optional[int] = None,
    viewer=None,
    return_viewer: bool = False,
):
    """Object classification over an image series (micro-sam's
    object_classifier.py:392): features/labels accumulate across images so
    one random forest trains on all of them; per-image predictions are saved
    to ``output_folder``."""
    import imageio.v3 as imageio

    from ._compat import FormWidget

    if len(images) != len(segmentations):
        raise ValueError(
            "Expect the same number of images and segmentations, "
            f"got {len(images)}, {len(segmentations)}.")
    os.makedirs(output_folder, exist_ok=True)

    viewer = object_classifier(
        image=images[0], segmentation=segmentations[0],
        embedding_path=None if embedding_paths is None else embedding_paths[0],
        model_type=model_type, tile_shape=tile_shape, halo=halo,
        return_viewer=True, viewer=viewer, checkpoint_path=checkpoint_path,
        device=device, ndim=ndim,
    )
    state = AnnotatorState()
    annotator = state.annotator
    workflow = annotator._workflow
    image_id = 0

    def _save_prediction(pred, idx):
        path = os.path.join(output_folder, f"prediction_{idx:05}.tif")
        try:
            imageio.imwrite(path, pred, compression="zlib")
        except TypeError:
            imageio.imwrite(path, pred)

    def next_image(*args):
        nonlocal image_id
        pred = annotator.train_and_predict()
        if pred is not None:
            _save_prediction(pred, image_id)
        image_id += 1
        if image_id >= len(images):
            print("You have annotated the last image.")
            workflow.export_rf(os.path.join(output_folder, "rf.pkl"))
            if hasattr(viewer, "close"):
                viewer.close()
            return None
        image, seg = images[image_id], segmentations[image_id]
        state.image_shape = image.shape[:2 if ndim is None else ndim]
        state.initialize_predictor(
            image, model_type=model_type, ndim=2 if ndim is None else ndim,
            save_path=None if embedding_paths is None else embedding_paths[image_id],
            predictor=workflow.predictor, tile_shape=tile_shape, halo=halo,
            skip_load=False,
        )
        workflow.set_image(image, seg, image_embeddings=state.image_embeddings)
        viewer.layers["image"].data = image
        viewer.layers["segmentation"].data = seg
        annotator._update_image()
        return image_id

    class _NextWidget(FormWidget):
        def __init__(self):
            super().__init__()
            self.run_button = self._add_button("run", "Next Image [N]", next_image)

    if hasattr(viewer, "window") and hasattr(viewer.window, "add_dock_widget"):
        viewer.window.add_dock_widget(_NextWidget())
    viewer.bind_key("n", overwrite=True)(lambda v=None: next_image())

    if return_viewer:
        return viewer
    _require_napari()
    import napari
    napari.run()
