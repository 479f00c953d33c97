"""Annotation of an image series (counterpart of
``micro_sam_tpu/sam_annotator/image_series_annotator.py``).

Embeddings (and state) are precomputed for the series' files, then the 2d or
3d annotator steps through the images, saving each committed segmentation as
a tif (imageio). Runs on any napari-duck-typed viewer.
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ._compat import FormWidget, generate_message
from ._state import AnnotatorState
from ._widgets import _ModelSelectionMixin, _require_napari
from .. import util
from ..precompute_state import _precompute_state_for_file


def _precompute(
    images, model_type, embedding_path, tile_shape, halo, precompute_amg_state,
    checkpoint_path=None, decoder=None, ndim=2, device=None,
):
    """Precompute embeddings (and state) for all images (micro-sam's
    image_series_annotator.py:28)."""
    predictor, state = util.get_sam_model(
        model_type=model_type, checkpoint_path=checkpoint_path, return_state=True,
        device=device,
    )
    if embedding_path is None:
        embedding_paths = [None] * len(images)
    else:
        os.makedirs(embedding_path, exist_ok=True)
        embedding_paths = []
        for image in images:
            name = Path(str(image)).stem if not isinstance(image, np.ndarray) else None
            out = os.path.join(embedding_path, f"{name}.zarr") if name else None
            if out is not None:
                _precompute_state_for_file(
                    predictor, image, out, key=None, ndim=ndim,
                    tile_shape=tile_shape, halo=halo,
                    precompute_amg_state=precompute_amg_state, decoder=decoder,
                    verbose=False,
                )
            embedding_paths.append(out)
    return predictor, embedding_paths


class ImageSeriesWorkflow:
    """Headless series workflow: iterate images, collect committed results."""

    def __init__(self, images: List, output_folder: str, model_type: str = util._DEFAULT_MODEL,
                 embedding_path: Optional[str] = None, is_volumetric: bool = False,
                 skip_segmented: bool = True):
        self.images = images
        self.output_folder = output_folder
        self.model_type = model_type
        self.embedding_path = embedding_path
        self.is_volumetric = is_volumetric
        self.skip_segmented = skip_segmented
        self.index = 0
        os.makedirs(output_folder, exist_ok=True)

    def _out_path(self, index: int) -> str:
        image = self.images[index]
        name = Path(str(image)).stem if not isinstance(image, np.ndarray) else f"seg_{index:05}"
        return os.path.join(self.output_folder, f"{name}.tif")

    def current_image(self) -> np.ndarray:
        image = self.images[self.index]
        return util.load_image_data(str(image)) if not isinstance(image, np.ndarray) else image

    def save_segmentation(self, segmentation: np.ndarray) -> str:
        path = self._out_path(self.index)
        import imageio.v3 as imageio
        try:
            imageio.imwrite(path, segmentation, compression="zlib")
        except TypeError:
            imageio.imwrite(path, segmentation)
        return path

    def next_image(self) -> Optional[int]:
        """Advance to the next (unsegmented) image; returns its index or None."""
        self.index += 1
        while self.skip_segmented and self.index < len(self.images) and \
                os.path.exists(self._out_path(self.index)):
            self.index += 1
        if self.index >= len(self.images):
            return None
        return self.index


def image_series_annotator(
    images: List,
    output_folder: str,
    model_type: str = util._DEFAULT_MODEL,
    embedding_path: Optional[str] = None,
    initial_segmentations: Optional[List] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    viewer=None,
    return_viewer: bool = False,
    precompute_amg_state: bool = False,
    checkpoint_path: Optional[str] = None,
    is_volumetric: bool = False,
    skip_segmented: bool = True,
    **kwargs,
):
    """Annotate a series of images (micro-sam's image_series_annotator.py:133).

    Works against any napari-duck-typed viewer (pass ``viewer=``); with
    ``return_viewer=True`` the configured viewer is returned instead of
    entering the napari event loop. A "Next Image [N]" action saves the
    committed segmentation and steps to the next unsegmented image.
    """
    import imageio.v3 as imageio

    from . import _widgets as widgets
    from ._annotator import Annotator2d, Annotator3d

    if initial_segmentations is not None and len(initial_segmentations) != len(images):
        raise ValueError(
            "The number of images and initial segmentations must match: "
            f"{len(images)} != {len(initial_segmentations)}."
        )
    os.makedirs(output_folder, exist_ok=True)
    ndim = 3 if is_volumetric else 2

    predictor, embedding_paths = _precompute(
        images, model_type, embedding_path, tile_shape, halo,
        precompute_amg_state, checkpoint_path=checkpoint_path, ndim=ndim,
        device=kwargs.get("device"),
    )

    have_arrays = isinstance(images[0], np.ndarray)

    def _save_path(idx: int) -> str:
        if have_arrays:
            return os.path.join(output_folder, f"seg_{idx:05}.tif")
        stem = os.path.splitext(os.path.basename(str(images[idx])))[0]
        return os.path.join(output_folder, stem + ".tif")

    def _load(idx: int):
        image = images[idx] if have_arrays else imageio.imread(str(images[idx]))
        return image, embedding_paths[idx]

    image_id = 0
    if skip_segmented:
        while image_id < len(images) and os.path.exists(_save_path(image_id)):
            image_id += 1
        if image_id == len(images):
            print("All images have already been annotated and 'skip_segmented' "
                  "is set. Nothing to do.")
            return None
    image, image_embedding_path = _load(image_id)

    state = AnnotatorState()
    state.initialize_predictor(
        image, model_type=model_type, ndim=ndim, save_path=image_embedding_path,
        predictor=predictor, tile_shape=tile_shape, halo=halo,
        precompute_amg_state=precompute_amg_state, skip_load=False,
        device=kwargs.get("device"),
        prefer_decoder=kwargs.get("prefer_decoder", True),
    )
    state.image_shape = image.shape[:ndim]

    if viewer is None:
        _require_napari()
        import napari
        viewer = napari.Viewer()
    viewer.add_image(image, name="image")
    annotator = (Annotator3d if is_volumetric else Annotator2d)(
        viewer, reset_state=False)
    initial = None if initial_segmentations is None else initial_segmentations[image_id]
    if initial is not None and not isinstance(initial, np.ndarray):
        initial = imageio.imread(str(initial))
    annotator._update_image(segmentation_result=initial)

    def next_image(*args):
        nonlocal image_id, image
        segmentation = np.asarray(viewer.layers["committed_objects"].data)
        _write_segmentation(_save_path(image_id), segmentation)

        # advance (optionally past already-segmented files)
        image_id += 1
        segmentation_result = None
        while skip_segmented and image_id < len(images) \
                and os.path.exists(_save_path(image_id)):
            image_id += 1
        if image_id >= len(images):
            print("You have annotated the last image.")
            if hasattr(viewer, "close"):
                viewer.close()
            return None
        if not skip_segmented and os.path.exists(_save_path(image_id)):
            segmentation_result = imageio.imread(_save_path(image_id))
        if initial_segmentations is not None and segmentation_result is None:
            init = initial_segmentations[image_id]
            segmentation_result = init if isinstance(init, np.ndarray) or init is None \
                else imageio.imread(str(init))

        image, image_embedding_path = _load(image_id)
        viewer.layers["image"].data = image
        viewer.layers["committed_objects"].data = np.zeros(
            image.shape[:ndim], dtype="uint32")
        if state.amg is not None and hasattr(state.amg, "clear_state"):
            state.amg.clear_state()
        state.initialize_predictor(
            image, model_type=model_type, ndim=ndim,
            save_path=image_embedding_path, predictor=predictor,
            tile_shape=tile_shape, halo=halo,
            precompute_amg_state=precompute_amg_state, skip_load=False,
        )
        state.image_shape = image.shape[:ndim]
        annotator._update_image(segmentation_result=segmentation_result)
        return image_id

    from ._compat import FormWidget

    class _NextImageWidget(FormWidget):
        def __init__(self):
            super().__init__()
            self.run_button = self._add_button(
                "run", "Next Image [N]", next_image)

        __call__ = staticmethod(next_image)

    next_widget = _NextImageWidget()
    if hasattr(viewer, "window") and hasattr(viewer.window, "add_dock_widget"):
        viewer.window.add_dock_widget(next_widget)
    viewer.bind_key("n", overwrite=True)(lambda v=None: next_image())

    if return_viewer:
        return viewer
    _require_napari()
    import napari
    napari.run()


def _write_segmentation(path: str, segmentation: np.ndarray) -> None:
    import imageio.v3 as imageio
    try:
        imageio.imwrite(path, segmentation, compression="zlib")
    except TypeError:
        imageio.imwrite(path, segmentation)


def image_folder_annotator(
    input_folder: str,
    output_folder: str,
    pattern: str = "*",
    **kwargs,
):
    """Annotate all images in a folder (micro-sam's image_series_annotator.py:347)."""
    images = sorted(glob(os.path.join(input_folder, pattern)))
    return image_series_annotator(images, output_folder, **kwargs)


def main():
    """@private CLI."""
    import argparse
    parser = argparse.ArgumentParser(description="Annotate a series of images.")
    parser.add_argument("-i", "--input_folder", required=True)
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("-p", "--pattern", default="*")
    parser.add_argument("--initial_segmentation_folder", default=None,
                        help="Folder with initial segmentations to load.")
    parser.add_argument("--initial_segmentation_pattern", default="*",
                        help="Glob pattern for the initial segmentations.")
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL)
    parser.add_argument("-e", "--embedding_path", default=None)
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("-d", "--device", default=None)
    parser.add_argument("--is_volumetric", action="store_true",
                        help="Use the 3d annotator for a set of volumes.")
    parser.add_argument("--tile_shape", nargs="+", type=int, default=None)
    parser.add_argument("--halo", nargs="+", type=int, default=None)
    parser.add_argument("--precompute_amg_state", action="store_true")
    parser.add_argument("--prefer_decoder", action="store_false")
    parser.add_argument("--skip_segmented", action="store_false")
    args = parser.parse_args()

    initial_segmentations = None
    if args.initial_segmentation_folder is not None:
        initial_segmentations = sorted(glob(os.path.join(
            args.initial_segmentation_folder, args.initial_segmentation_pattern)))

    image_folder_annotator(
        args.input_folder, args.output_folder, args.pattern,
        model_type=args.model_type, embedding_path=args.embedding_path,
        initial_segmentations=initial_segmentations,
        checkpoint_path=args.checkpoint, device=args.device,
        is_volumetric=args.is_volumetric,
        tile_shape=None if args.tile_shape is None else tuple(args.tile_shape),
        halo=None if args.halo is None else tuple(args.halo),
        precompute_amg_state=args.precompute_amg_state,
        prefer_decoder=args.prefer_decoder,
        skip_segmented=args.skip_segmented,
    )


if __name__ == "__main__":
    main()


class ImageSeriesAnnotator(_ModelSelectionMixin, FormWidget):
    """Form widget driving the image-series annotation workflow — the napari
    widget contribution (micro-sam's image_series_annotator.py:391): pick an
    input/output folder, a model, then run the series annotator in the
    current viewer.
    """

    def __init__(self, viewer=None, parent=None):
        super().__init__(parent)
        self._viewer = viewer
        self._add_path_param("folder", None, "directory", title="Input Folder",
                             placeholder="Folder with images ...")
        self._add_path_param("output_folder", None, "directory",
                             title="Output Folder",
                             placeholder="Folder to save the results ...")
        self._init_model_selection(util._DEFAULT_MODEL)
        # settings
        self._add_string_param("pattern", "*", title="pattern")
        self._add_bool_param("is_volumetric", False, title="is_volumetric")
        self._add_path_param("embeddings_save_path", None, "directory",
                             title="embeddings save path")
        self._add_path_param("custom_weights", None, "file",
                             title="custom weights path")
        self._add_shape_param(("tile_x", "tile_y"), (0, 0), min_val=0,
                              max_val=2048, title=("tile size x", "tile size y"))
        self._add_shape_param(("halo_x", "halo_y"), (0, 0), min_val=0,
                              max_val=512, title=("halo x", "halo y"))
        self.run_button = self._add_button(
            "run", "Annotate Images", self.__call__)

    def _validate_inputs(self):
        missing = [name for name in ("folder", "output_folder")
                   if not getattr(self, name)]
        if missing:
            generate_message(
                "error", f"Please fill in: {', '.join(missing)}.")
            return True
        return False

    def __call__(self):
        if self._validate_inputs():
            return
        tile_shape, halo = None, None
        if self.tile_x and self.tile_y:
            tile_shape = (int(self.tile_x), int(self.tile_y))
            halo = (int(self.halo_x), int(self.halo_y))
        return image_folder_annotator(
            input_folder=str(self.folder),
            output_folder=str(self.output_folder),
            pattern=self.pattern or "*",
            model_type=self.model_type,
            checkpoint_path=self.custom_weights,
            embedding_path=self.embeddings_save_path,
            is_volumetric=self.is_volumetric,
            tile_shape=tile_shape, halo=halo,
            viewer=self._viewer,
        )
