"""The 3d annotator (counterpart of ``micro_sam_tpu/sam_annotator/annotator_3d.py``):
as ``annotator_2d``, over a (Z, H, W) volume."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ._state import AnnotatorState
from ._widgets import _require_napari
from .. import util


def annotator_3d(
    image: np.ndarray,
    embedding_path: Optional[Union[str, util.ImageEmbeddings]] = None,
    segmentation_result: Optional[np.ndarray] = None,
    model_type: str = util._DEFAULT_MODEL,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    return_viewer: bool = False,
    viewer=None,
    precompute_amg_state: bool = False,
    checkpoint_path: Optional[str] = None,
    decoder_path: Optional[str] = None,
    device=None,
    prefer_decoder: bool = True,
    predictor=None,
):
    """Start the 3d annotator (micro-sam's annotator_3d.py:50)."""
    state = AnnotatorState()
    state.image_shape = image.shape[:3]

    if isinstance(embedding_path, dict):
        # precomputed embeddings: reuse the caller's predictor when given
        state.image_embeddings = embedding_path
        state.predictor = predictor if predictor is not None else \
            util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                               device=device)
    else:
        state.initialize_predictor(
            image, model_type=model_type, save_path=embedding_path, ndim=3,
            device=device, checkpoint_path=checkpoint_path,
            decoder_path=decoder_path, tile_shape=tile_shape,
            halo=halo, precompute_amg_state=precompute_amg_state,
            prefer_decoder=prefer_decoder,
        )

    from ._annotator import Annotator3d

    if viewer is None:
        _require_napari()
        import napari
        viewer = napari.Viewer()
    viewer.add_image(image, name="image")
    annotator = Annotator3d(viewer, reset_state=False)
    annotator._update_image(segmentation_result=segmentation_result)
    if hasattr(viewer, "window"):
        viewer.window.add_dock_widget(annotator)
    if return_viewer:
        return viewer
    _require_napari()
    import napari
    napari.run()


def main():
    """@private CLI."""
    import argparse
    parser = argparse.ArgumentParser(description="Start the 3d annotator.")
    parser.add_argument("-i", "--input_path", required=True)
    parser.add_argument("-k", "--key", default=None)
    parser.add_argument("-e", "--embedding_path", default=None)
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL)
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("--tile_shape", nargs="+", type=int, default=None)
    parser.add_argument("--halo", nargs="+", type=int, default=None)
    parser.add_argument("--precompute_amg_state", action="store_true")
    parser.add_argument("-d", "--device", default=None, help="'cpu' (default: the GPU).")
    args = parser.parse_args()

    image = util.load_image_data(args.input_path, args.key)
    annotator_3d(
        image, embedding_path=args.embedding_path, model_type=args.model_type,
        tile_shape=None if args.tile_shape is None else tuple(args.tile_shape),
        halo=None if args.halo is None else tuple(args.halo),
        checkpoint_path=args.checkpoint,
        precompute_amg_state=args.precompute_amg_state, device=args.device,
    )


if __name__ == "__main__":
    main()

# napari widget contribution: the manifest registers the class
# (constructible from the viewer alone), as micro-sam's napari.yaml:36-50 does
from ._annotator import Annotator3d  # noqa: E402,F401
