"""Precompute embeddings and automatic-segmentation state for later use, and
the command line ``micro_sam_tpu_torch.precompute_embeddings``.

Counterpart of ``micro_sam_tpu/precompute_state.py``, with its cache layouts,
so that state precomputed by either package loads in the other: the AMG state
as a pickle per slice (``<embeddings>.zarr/amg_state/state[-i].pkl``), the AIS
maps as gzip datasets in ``<embeddings>.zarr/is_state.h5`` (groups ``state`` /
``state-i``; ``h5py`` is imported at the call). ``precompute_state`` and the
command line run on the GPU unless ``device="cpu"`` (``-d cpu``) is given.
"""
from __future__ import annotations

import os
import pickle
from glob import glob
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from . import instance_segmentation, util
from .predictor import SamPredictor

# the decoder maps' names, owned by the segmenter class
_AIS_STATE_KEYS = instance_segmentation.InstanceSegmentationWithDecoder._STATE_KEYS


class _PickleStateStore:
    """AMG state cache: one pickle per slice under ``<root>/amg_state/``."""

    def __init__(self, root: str, i: Optional[int]):
        folder = os.path.join(str(root), "amg_state")
        os.makedirs(folder, exist_ok=True)
        self.path = os.path.join(folder, "state.pkl" if i is None else f"state-{i}.pkl")

    def load(self):
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def save(self, state) -> None:
        with open(self.path, "wb") as f:
            pickle.dump(state, f)


class _H5StateStore:
    """AIS state cache: gzip datasets per slice in ``<root>/is_state.h5``."""

    def __init__(self, root: str, i: Optional[int]):
        self.path = os.path.join(str(root), "is_state.h5")
        self.key = "state" if i is None else f"state-{i}"

    def exists(self) -> bool:
        import h5py
        if not os.path.exists(self.path):
            return False
        with h5py.File(self.path, "r") as f:
            return self.key in f

    def load(self):
        import h5py
        if not os.path.exists(self.path):
            return None
        with h5py.File(self.path, "r") as f:
            if self.key not in f:
                return None
            group = f[self.key]
            return {name: group[name][:] for name in _AIS_STATE_KEYS}

    def save(self, state) -> None:
        import h5py
        with h5py.File(self.path, "a") as f:
            group = f.create_group(self.key)
            for name in _AIS_STATE_KEYS:
                group.create_dataset(name, data=state[name], compression="gzip")


def _load_or_initialize(segmenter, store, raw, image_embeddings, i, verbose) -> bool:
    """Restore the segmenter's state from the store, or initialize it from the
    embeddings and store it. True when it was computed."""
    cached = store.load()
    if cached is not None:
        if verbose:
            print("Load the instance segmentation state from", store.path)
        segmenter.set_state(cached)
        return False
    if verbose:
        print("Precomputing the state for instance segmentation.")
    segmenter.initialize(raw, image_embeddings=image_embeddings, i=i, verbose=verbose)
    store.save(segmenter.get_state())
    return True


def cache_amg_state(
    predictor: SamPredictor,
    raw: np.ndarray,
    image_embeddings: util.ImageEmbeddings,
    save_path: Union[str, os.PathLike],
    verbose: bool = True,
    i: Optional[int] = None,
    **kwargs,
) -> instance_segmentation.AMGBase:
    """The AMG segmenter with its state computed and cached, or loaded from
    the cache at ``save_path``."""
    amg = instance_segmentation.get_instance_segmentation_generator(
        predictor, is_tiled=image_embeddings["input_size"] is None, decoder=None, **kwargs)
    _load_or_initialize(amg, _PickleStateStore(save_path, i), raw, image_embeddings, i, verbose)
    return amg


def cache_is_state(
    predictor: SamPredictor,
    decoder,
    raw: np.ndarray,
    image_embeddings: util.ImageEmbeddings,
    save_path: Union[str, os.PathLike],
    verbose: bool = True,
    i: Optional[int] = None,
    skip_load: bool = False,
    **kwargs,
) -> Optional[instance_segmentation.InstanceSegmentationWithDecoder]:
    """The AIS segmenter with its maps computed and cached, or loaded from the
    cache at ``save_path``. ``skip_load``: only make sure the cache holds
    them (returns None)."""
    segmenter = instance_segmentation.get_instance_segmentation_generator(
        predictor, is_tiled=image_embeddings["input_size"] is None, decoder=decoder,
        segmentation_mode="ais", **kwargs)
    store = _H5StateStore(save_path, i)
    if skip_load and store.exists():
        return None
    _load_or_initialize(segmenter, store, raw, image_embeddings, i, verbose)
    return None if skip_load else segmenter


def _precompute_state_for_file(predictor, input_path, output_path, key, ndim, tile_shape, halo,
                               precompute_amg_state, decoder, batch_size: int = 1,
                               verbose: bool = True):
    image_data = (input_path if isinstance(input_path, np.ndarray)
                  else util.load_image_data(input_path, key))
    output_path = Path(output_path).with_suffix(".zarr")
    embeddings = util.precompute_image_embeddings(
        predictor, image_data, str(output_path), ndim=ndim, tile_shape=tile_shape, halo=halo,
        batch_size=batch_size, verbose=verbose)
    if not precompute_amg_state:
        return embeddings

    def cache_one(raw, i=None):
        if decoder is None:
            cache_amg_state(predictor=predictor, raw=raw, image_embeddings=embeddings,
                            save_path=str(output_path), i=i, verbose=verbose)
        else:
            cache_is_state(predictor=predictor, decoder=decoder, raw=raw,
                           image_embeddings=embeddings, save_path=str(output_path), i=i,
                           verbose=verbose)

    if (image_data.ndim if ndim is None else ndim) == 2:
        cache_one(image_data)
    else:
        for z in range(image_data.shape[0]):
            cache_one(image_data[z], i=z)
    return embeddings


def precompute_state(
    input_path: Union[os.PathLike, str],
    output_path: Union[os.PathLike, str],
    pattern: Optional[str] = None,
    model_type: str = util._DEFAULT_MODEL,
    checkpoint_path: Optional[Union[os.PathLike, str]] = None,
    key: Optional[str] = None,
    ndim: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    precompute_amg_state: bool = False,
    batch_size: int = 1,
    verbose: bool = True,
    device: Optional[str] = None,
) -> None:
    """Precompute the embeddings, and with ``precompute_amg_state`` the
    automatic segmentation's state (AIS when the model carries a decoder,
    else AMG), of one file or of every file matching ``pattern``."""
    predictor, state = util.get_sam_model(model_type=model_type, checkpoint_path=checkpoint_path,
                                          device=device, return_state=True)
    decoder = (instance_segmentation.get_decoder(decoder_state=state["decoder_state"],
                                                 device=device)
               if "decoder_state" in state else None)
    if pattern is None:
        jobs = [(input_path, output_path)]
    else:
        os.makedirs(str(output_path), exist_ok=True)
        jobs = [(fp, os.path.join(str(output_path), f"{Path(fp).stem}.zarr"))
                for fp in sorted(glob(os.path.join(str(input_path), pattern)))]
    for in_path, out_path in jobs:
        _precompute_state_for_file(predictor, in_path, out_path, key, ndim=ndim,
                                   tile_shape=tile_shape, halo=halo,
                                   precompute_amg_state=precompute_amg_state, decoder=decoder,
                                   batch_size=batch_size, verbose=verbose)


def main():
    """The command line: ``micro_sam_tpu_torch.precompute_embeddings``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Precompute image embeddings (and optionally the AMG / AIS state).")
    parser.add_argument("-i", "--input_path", required=True)
    parser.add_argument("-e", "--embedding_path", "-o", "--output_path", dest="output_path",
                        required=True, help="Where to save the embeddings.")
    parser.add_argument("--pattern", default=None)
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL)
    parser.add_argument("-c", "--checkpoint_path", "--checkpoint", dest="checkpoint_path",
                        default=None)
    parser.add_argument("-k", "--key", default=None)
    parser.add_argument("-n", "--ndim", type=int, default=None)
    parser.add_argument("--tile_shape", nargs="+", type=int, default=None)
    parser.add_argument("--halo", nargs="+", type=int, default=None)
    parser.add_argument("-p", "--precompute_amg_state", action="store_true")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("-d", "--device", default=None, help="cuda (the default) or cpu.")

    args = parser.parse_args()
    precompute_state(
        args.input_path, args.output_path, args.pattern, args.model_type, args.checkpoint_path,
        key=args.key, ndim=args.ndim,
        tile_shape=None if args.tile_shape is None else tuple(args.tile_shape),
        halo=None if args.halo is None else tuple(args.halo),
        precompute_amg_state=args.precompute_amg_state, batch_size=args.batch_size,
        device=args.device)


if __name__ == "__main__":
    main()
