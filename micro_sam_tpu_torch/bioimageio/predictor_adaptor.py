"""One call from an image and its prompts to masks, scores and embeddings:
the interface bioimage.io / BioEngine consumers expect (counterpart of
``micro_sam_tpu/bioimageio/predictor_adaptor.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..predictor import SamPredictor


class PredictorAdaptor:
    """A SamPredictor behind a single call with the bioimage.io tensor
    contract: image (1, C, H, W), optional box / point / mask prompts, or the
    image's embeddings instead of the encode."""

    def __init__(self, predictor_or_model_type=None, checkpoint_path: Optional[str] = None,
                 model_type: Optional[str] = None, device=None):
        # micro-sam's convention: PredictorAdaptor(model_type="vit_b")
        if predictor_or_model_type is None:
            predictor_or_model_type = model_type
        if isinstance(predictor_or_model_type, SamPredictor):
            self.sam = predictor_or_model_type
        else:
            from .. import util
            self.sam = util.get_sam_model(model_type=predictor_or_model_type,
                                          checkpoint_path=checkpoint_path, device=device)

    def __call__(
        self,
        image: np.ndarray,                           # (1, C, H, W)
        box_prompts: Optional[np.ndarray] = None,    # (1, N, 4) XYXY
        point_prompts: Optional[np.ndarray] = None,  # (1, N, P, 2)
        point_labels: Optional[np.ndarray] = None,   # (1, N, P)
        mask_prompts: Optional[np.ndarray] = None,   # (1, N, 1, 256, 256)
        embeddings: Optional[np.ndarray] = None,     # (1, 256, 64, 64)
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (masks (1, N, 1, H, W) uint8, scores (1, N, 1), embeddings
        (1, 256, 64, 64))."""
        image_np = np.asarray(image)[0]
        if image_np.shape[0] in (1, 3):
            image_np = np.moveaxis(image_np, 0, -1)
        if image_np.shape[-1] == 1:
            image_np = np.repeat(image_np, 3, axis=-1)

        if embeddings is None:
            self.sam.set_image(image_np.astype(np.uint8))
        else:
            self.sam.set_features(np.asarray(embeddings), image_np.shape[:2])

        boxes = None if box_prompts is None else np.asarray(box_prompts)[0]
        points = None if point_prompts is None else np.asarray(point_prompts)[0]
        labels = None if point_labels is None else np.asarray(point_labels)[0]
        masks_in = None if mask_prompts is None else np.asarray(mask_prompts)[0]

        masks, scores, _ = self.sam.predict(
            point_coords=points, point_labels=labels, box=boxes,
            mask_input=masks_in, multimask_output=False,
        )
        if masks.ndim == 3:  # unbatched prompt -> add the object axis
            masks, scores = masks[None], scores[None]
        out_masks = masks[None].astype(np.uint8)        # (1, N, 1, H, W)
        out_scores = np.asarray(scores)[None]           # (1, N, 1)
        out_embeddings = self.sam.get_image_embedding()  # (1, 256, h, w)
        return out_masks, out_scores, out_embeddings
