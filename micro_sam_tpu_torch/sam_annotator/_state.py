"""The process-wide annotator state (counterpart of
``micro_sam_tpu/sam_annotator/_state.py``): the predictor, the image
embeddings, the AMG / AIS state, the tracking lineage and the widgets. Free of
napari. ``initialize_predictor`` loads the model on the card unless it is
given ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import util as sam_util
from ..instance_segmentation import AMGBase, get_decoder


class Singleton(type):
    """@private"""
    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


def _all_or_none(name: str, parts) -> bool:
    """True when every part is set, False when none is; a partially
    initialized state is a bug worth failing loudly on."""
    n_set = sum(p is not None for p in parts)
    if n_set == len(parts):
        return True
    if n_set == 0:
        return False
    raise RuntimeError(
        f"Invalid AnnotatorState ({name}): {n_set} of {len(parts)} parts "
        "initialized, expected all or none."
    )


@dataclass
class AnnotatorState(metaclass=Singleton):
    """The annotation state, one per process."""

    # predictor, image_embeddings and image shape
    image_embeddings: Optional[sam_util.ImageEmbeddings] = None
    predictor: Optional[sam_util.SamPredictor] = None
    image_shape: Optional[Tuple[int, int]] = None
    image_scale: Optional[Tuple[float, ...]] = None
    image_name: Optional[str] = None
    embedding_path: Optional[str] = None
    data_signature: Optional[str] = None

    # automatic segmentation state
    amg: Optional[AMGBase] = None
    amg_state: Optional[Dict] = None
    decoder: Optional[Any] = None

    # tracking state
    current_track_id: Optional[int] = None
    lineage: Optional[Dict] = None
    committed_lineages: Optional[list] = None

    # widget references (populated by the GUI layer)
    widgets: Dict[str, Any] = field(default_factory=dict)
    z_range: Optional[Tuple[int, int]] = None
    skip_recomputing_embeddings: bool = False

    # object classifier state
    object_features: Optional[np.ndarray] = None
    seg_ids: Optional[np.ndarray] = None
    object_rf: Optional[Any] = None
    previous_features: Optional[np.ndarray] = None
    previous_labels: Optional[np.ndarray] = None

    annotator: Optional[Any] = None

    # fields that survive reset_state (the widget registry is rebuilt by the
    # GUI layer, not the state machine; flags keep their defaults)
    _RESET_KEEP = ("widgets", "skip_recomputing_embeddings", "annotator")

    def initialize_predictor(
        self,
        image_data,
        model_type: str,
        ndim: int,
        save_path: Optional[str] = None,
        device=None,
        predictor=None,
        decoder=None,
        checkpoint_path: Optional[str] = None,
        decoder_path: Optional[str] = None,
        tile_shape: Optional[Tuple[int, int]] = None,
        halo: Optional[Tuple[int, int]] = None,
        precompute_amg_state: bool = False,
        prefer_decoder: bool = True,
        pbar_init=None,
        pbar_update=None,
        skip_load: bool = True,
        use_cli: bool = False,
    ) -> None:
        """Load the model (and the decoder of its checkpoint, unless
        ``prefer_decoder`` is False) on ``device`` (the GPU by default; "cpu"),
        unless a predictor is given, then compute or load the embeddings of
        ``image_data`` (cached at ``save_path``) and, with
        ``precompute_amg_state``, the AMG (no decoder) or AIS state."""
        assert ndim in (2, 3)

        if predictor is None:
            predictor, model_state = sam_util.get_sam_model(
                device=device, model_type=model_type,
                checkpoint_path=checkpoint_path, decoder_path=decoder_path,
                return_state=True,
            )
            if prefer_decoder and "decoder_state" in model_state:
                decoder = get_decoder(
                    decoder_state=model_state["decoder_state"], device=device)
        self.predictor = predictor
        self.decoder = decoder

        self.image_embeddings = sam_util.precompute_image_embeddings(
            predictor=self.predictor, input_=image_data, save_path=save_path,
            ndim=ndim, tile_shape=tile_shape, halo=halo,
            pbar_init=pbar_init, pbar_update=pbar_update,
        )
        self.embedding_path = save_path
        self.data_signature = sam_util._compute_data_signature(np.asarray(image_data))

        if precompute_amg_state:
            self.amg = self._cache_auto_segmentation_state(image_data, save_path)

    def _cache_auto_segmentation_state(self, image_data, save_path):
        """Precompute + persist the AMG (no decoder) or AIS (with decoder)
        state next to the embeddings."""
        from ..precompute_state import cache_amg_state, cache_is_state
        if save_path is None:
            raise RuntimeError(
                "Precomputation of the AMG state is only possible with a save_path."
            )
        if self.decoder is None:
            return cache_amg_state(
                self.predictor, image_data, self.image_embeddings, save_path,
                verbose=False,
            )
        return cache_is_state(
            self.predictor, self.decoder, image_data, self.image_embeddings,
            save_path, verbose=False,
        )

    def initialized_for_interactive_segmentation(self) -> bool:
        """Whether predictor, embeddings and image shape are set."""
        return _all_or_none(
            "interactive segmentation",
            (self.predictor, self.image_embeddings, self.image_shape),
        )

    def initialized_for_tracking(self) -> bool:
        """Whether the tracking state is set."""
        return _all_or_none(
            "tracking", (self.current_track_id, self.lineage))

    def reset_state(self) -> None:
        """Reset every state field to its default."""
        for f in fields(self):
            if f.name in self._RESET_KEEP:
                continue
            setattr(self, f.name, None)
