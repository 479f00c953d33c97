"""The meshed embedding precompute: the tiled fan-out over the data ranks.

Counterpart of ``micro_sam_tpu/parallel/embed.py``. A tile batch is
embarrassingly parallel: each data rank encodes its contiguous slice of the
batch (padded to the batch size, repeating its last tile) through the
encoder split over the model axis, and the slices are all-gathered
(``SamPredictor.encode_batch`` on a mesh).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .mesh import Mesh, make_mesh


class ShardedEncoder:
    """Batched encoder over a mesh: pads the final partial batch to the batch
    size (a multiple of the data axis) and splits it over the data ranks.
    ``sam`` is split over the model axis in place (``shard_sam_``); every
    rank of the mesh makes the same calls."""

    def __init__(self, sam, mesh: Optional[Mesh] = None, batch_size: Optional[int] = None):
        from ..predictor import SamPredictor
        self.sam = sam
        self.mesh = mesh or make_mesh(device=next(sam.parameters()).device)
        data_size = self.mesh.shape["data"]
        self.batch_size = batch_size or data_size
        if self.batch_size % data_size:
            raise ValueError(f"batch size {self.batch_size} must be divisible by data axis "
                             f"{data_size}")
        self.predictor = SamPredictor(sam, mesh=self.mesh)

    def encode_batch(self, batch: np.ndarray) -> np.ndarray:
        """batch: (B, h, w, 3) resized pixels -> (B, e, e, 256) float32."""
        batch = np.asarray(batch, dtype=np.float32)
        n = batch.shape[0]
        if n < self.batch_size:
            batch = np.concatenate([batch, np.repeat(batch[-1:], self.batch_size - n, axis=0)])
        return self.predictor.encode_batch(batch)[:n].float().cpu().numpy()

    def encode_tiles(self, tiles: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Encode a sequence of same-shape tiles in mesh-sized batches."""
        results: List[np.ndarray] = []
        for start in range(0, len(tiles), self.batch_size):
            results.extend(self.encode_batch(np.stack(tiles[start:start + self.batch_size])))
        return results


def precompute_image_embeddings_sharded(
    predictor,
    input_: np.ndarray,
    tile_shape: Tuple[int, int],
    halo: Tuple[int, int],
    save_path: Optional[str] = None,
    mesh: Optional[Mesh] = None,
    batch_size: Optional[int] = None,
    verbose: bool = False,
):
    """Tiled 2d embedding precompute with the encoder over a mesh.

    The mesh is wired into the production precompute (``get_sam_model(mesh=)``
    / ``SamPredictor.shard_on_mesh``), so this puts an unmeshed predictor on
    ``mesh`` (default: the 1 x 1 mesh on the predictor's device) and calls
    ``util.precompute_image_embeddings``: the same ImageEmbeddings and cache
    layout."""
    from .. import util

    if predictor.mesh is None:
        predictor.shard_on_mesh(mesh or make_mesh(device=predictor.device))
    return util.precompute_image_embeddings(
        predictor, input_, save_path=save_path, ndim=2,
        tile_shape=tuple(tile_shape), halo=tuple(halo),
        batch_size=batch_size or predictor.batch_multiple, verbose=verbose,
    )
