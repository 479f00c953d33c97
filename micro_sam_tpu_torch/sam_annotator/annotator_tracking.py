"""The tracking annotator (counterpart of
``micro_sam_tpu/sam_annotator/annotator_tracking.py``).

The interactive tracking core (motion-model tracking, division handling) is
``sam_annotator.util.track_from_prompts`` and runs headless; this module adds
the track / lineage bookkeeping and the entry point.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ._state import AnnotatorState
from ._widgets import _require_napari
from .. import util

# the tracking state of a frame annotation
STATE_CHOICES = ("track", "division")


def _init_tracking_state(state: AnnotatorState) -> None:
    state.current_track_id = 1
    state.lineage = {1: []}
    state.committed_lineages = []


def add_new_track(state: AnnotatorState) -> int:
    """Start annotating a new track; returns the new track id."""
    track_ids = set(state.lineage.keys())
    for lineage in state.committed_lineages or []:
        track_ids.update(lineage.keys())
    new_id = max(track_ids) + 1 if track_ids else 1
    state.lineage[new_id] = []
    state.current_track_id = new_id
    return new_id


def register_division(state: AnnotatorState, parent_track: int) -> Tuple[int, int]:
    """Register a division: two child tracks branching from the parent."""
    c1 = add_new_track(state)
    c2 = add_new_track(state)
    state.lineage[parent_track] = [c1, c2]
    state.current_track_id = c1
    return c1, c2


def commit_track(state: AnnotatorState, tracking_result: np.ndarray,
                 committed: np.ndarray) -> np.ndarray:
    """Commit the current track segmentation (micro-sam's _widgets.py commit_track)."""
    from ._widgets import commit_segmentation
    out = commit_segmentation(committed, tracking_result, preserve_mode="objects")
    if state.lineage:
        (state.committed_lineages or []).append(dict(state.lineage))
    _init_tracking_state(state)
    return out


def annotator_tracking(
    image: np.ndarray,
    embedding_path: Optional[Union[str, util.ImageEmbeddings]] = None,
    model_type: str = util._DEFAULT_MODEL,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    return_viewer: bool = False,
    viewer=None,
    checkpoint_path: Optional[str] = None,
    device=None,
    precompute_amg_state: bool = False,
    decoder_path: Optional[str] = None,
):
    """Start the tracking annotator (micro-sam's annotator_tracking.py:288)."""
    state = AnnotatorState()
    state.image_shape = image.shape[:3]
    if isinstance(embedding_path, dict):
        # precomputed embeddings passed directly (same contract as
        # annotator_2d/annotator_3d)
        state.image_embeddings = embedding_path
        state.predictor = util.get_sam_model(
            model_type=model_type, checkpoint_path=checkpoint_path, device=device)
    else:
        state.initialize_predictor(
            image, model_type=model_type, save_path=embedding_path, ndim=3,
            device=device, checkpoint_path=checkpoint_path,
            decoder_path=decoder_path, tile_shape=tile_shape, halo=halo,
            precompute_amg_state=precompute_amg_state,
        )
    _init_tracking_state(state)

    from ._annotator import AnnotatorTracking

    if viewer is None:
        _require_napari()
        import napari
        viewer = napari.Viewer()
    viewer.add_image(image, name="image")
    annotator = AnnotatorTracking(viewer, reset_state=False)
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
    parser = argparse.ArgumentParser(description="Start the tracking annotator.")
    parser.add_argument("-i", "--input_path", required=True)
    parser.add_argument("-k", "--key", default=None)
    parser.add_argument("-e", "--embedding_path", default=None)
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL)
    parser.add_argument("-c", "--checkpoint", default=None)
    parser.add_argument("-d", "--device", default=None, help="'cpu' (default: the GPU).")
    args = parser.parse_args()

    image = util.load_image_data(args.input_path, args.key)
    annotator_tracking(
        image, embedding_path=args.embedding_path, model_type=args.model_type,
        checkpoint_path=args.checkpoint, device=args.device,
    )


if __name__ == "__main__":
    main()

# napari widget contribution: the manifest registers the class
# (constructible from the viewer alone), as micro-sam's napari.yaml:36-50 does
from ._annotator import AnnotatorTracking  # noqa: E402,F401


# Color cycle for the track-state (track / division) points display
# (micro-sam's annotator_tracking.py:19).
STATE_COLOR_CYCLE = ["#00FFFF", "#FF00FF"]


def create_tracking_menu(points_layer, box_layer, states, track_ids,
                         tracking_widget=None):
    """Build the track-id / state menu wired to the prompt layers
    (micro-sam's annotator_tracking.py:24). Returns the TrackingMenuWidget."""
    from ._state import AnnotatorState
    from ._widgets import TrackingMenuWidget

    state = AnnotatorState()
    viewer = getattr(state.annotator, "_viewer", None)
    widget = tracking_widget or TrackingMenuWidget(viewer)
    widget.state_field.setChoices([str(s) for s in states])
    widget.track_id_field.setChoices([str(t) for t in track_ids])

    def _sync_from_layer(event=None):
        props = getattr(points_layer, "current_properties", {}) or {}
        if "track_id" in props:
            widget.track_id_field.set(str(props["track_id"][0]))
        if "state" in props:
            widget.state_field.set(str(props["state"][0]))

    events = getattr(points_layer, "events", None)
    if events is not None and hasattr(events, "current_properties"):
        events.current_properties.connect(_sync_from_layer)
    return widget
