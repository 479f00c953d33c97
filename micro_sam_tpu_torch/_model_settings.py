"""Per-model default hyperparameters of the AIS / AMG / nd-segmentation
widgets (the port's copy of ``micro_sam_tpu/_model_settings.py``). The values
mirror micro-sam's tuned defaults for the corresponding zoo models."""

AIS_SETTINGS = {
    "vit_t_lm": {"center_distance_thresh": 0.4, "boundary_distance_thresh": 0.5},
    "vit_b_lm": {"center_distance_thresh": 0.4, "boundary_distance_thresh": 0.5},
    "vit_l_lm": {"center_distance_thresh": 0.4, "boundary_distance_thresh": 0.5},
    "vit_t_em_organelles": {"center_distance_thresh": 0.5, "boundary_distance_thresh": 0.6},
    "vit_b_em_organelles": {"center_distance_thresh": 0.5, "boundary_distance_thresh": 0.6},
    "vit_l_em_organelles": {"center_distance_thresh": 0.5, "boundary_distance_thresh": 0.6},
}

AMG_SETTINGS = {
    "vit_t": {"pred_iou_thresh": 0.88, "stability_score_thresh": 0.95},
    "vit_b": {"pred_iou_thresh": 0.88, "stability_score_thresh": 0.95},
    "vit_l": {"pred_iou_thresh": 0.88, "stability_score_thresh": 0.95},
    "vit_h": {"pred_iou_thresh": 0.88, "stability_score_thresh": 0.95},
}

ND_SEGMENTATION_SETTINGS = {
    "vit_t_lm": {"projection_mode": "box", "iou_threshold": 0.8},
    "vit_b_lm": {"projection_mode": "box", "iou_threshold": 0.8},
    "vit_l_lm": {"projection_mode": "box", "iou_threshold": 0.8},
    "vit_t_em_organelles": {"projection_mode": "single_point", "iou_threshold": 0.6},
    "vit_b_em_organelles": {"projection_mode": "single_point", "iou_threshold": 0.6},
    "vit_l_em_organelles": {"projection_mode": "single_point", "iou_threshold": 0.6},
}


def get_model_settings(model_type: str, kind: str) -> dict:
    """Widget defaults of a model (``kind``: "ais", "amg" or "nd"), falling
    back to the first entry of the same base model, else {}."""
    table = {"ais": AIS_SETTINGS, "amg": AMG_SETTINGS, "nd": ND_SEGMENTATION_SETTINGS}[kind]
    if model_type in table:
        return dict(table[model_type])
    base = model_type[:5]
    for key, val in table.items():
        if key.startswith(base):
            return dict(val)
    return {}


# micro-sam's name for the nd-segmentation settings table
ND_SEGMENT_SETTINGS = ND_SEGMENTATION_SETTINGS
