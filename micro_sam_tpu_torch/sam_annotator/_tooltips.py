"""Tooltip strings of the annotator widgets (the port's copy of
``micro_sam_tpu/sam_annotator/_tooltips.py``)."""

tooltips = {
    "embedding": {
        "model_family": "Choose the model family for interactive segmentation.",
        "model_size": "Choose the model size: tiny / base / large / huge.",
        "device": "The compute device (GPU / CPU).",
        "embeddings_save_path": "Path to save the computed image embeddings (zarr).",
        "custom_weights": "Path to custom finetuned model weights.",
        "tile_shape": "Tile shape for tiled embedding computation over large images.",
        "halo": "Overlap between tiles for tiled embedding computation.",
    },
    "segmentnd": {
        "projection_dropdown": "Projection mode for propagating masks across slices.",
        "iou_threshold": "Stop projection when slice-to-slice IoU falls below this value.",
        "box_extension": "Factor for enlarging the projected box prompt.",
        "motion_smoothing": "Smoothing of the motion model for tracking.",
    },
    "autosegment": {
        "with_background": "Remove the largest object (background) from the result.",
        "pred_iou_thresh": "Filter threshold on the model's predicted mask quality (AMG).",
        "stability_score_thresh": "Filter threshold on mask stability (AMG).",
        "center_distance_thresh": "Seed threshold on center-distance predictions (AIS).",
        "boundary_distance_thresh": "Seed threshold on boundary-distance predictions (AIS).",
        "min_object_size": "Minimal object size in pixels.",
        "gap_closing": "Close z-gaps of this size when merging 3d segmentation.",
        "min_extent": "Minimal z-extent of objects in 3d segmentation.",
    },
    "prompt_menu": {
        "labels": "Toggle between positive (object) and negative (background) points [T].",
    },
}


def get_tooltip(widget_type: str, name: str) -> str:
    return tooltips.get(widget_type, {}).get(name, "")
