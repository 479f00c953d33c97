"""Automatic segmentation: model loading, the segmenter, the embeddings, file IO
and the command line ``micro_sam_tpu_torch.automatic_segmentation``.

Counterpart of ``micro_sam_tpu/automatic_segmentation.py``: 2d images (tiled
and untiled, with ``mask``), volumes (``ndim=3``: each slice segmented, then
merged into 3d by ``multi_dimensional_segmentation.automatic_3d_segmentation``)
and timeseries (``automatic_tracking``). ``annotate=True`` opens the result in
the port's napari annotator for corrections (it needs napari).
The entry points run on the GPU unless ``device="cpu"`` (``-d cpu``) is given.
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from . import util
from .instance_segmentation import (DEFAULT_SEGMENTATION_MODE_WITH_DECODER, AMGBase,
                                    InstanceSegmentationWithDecoder, get_decoder,
                                    get_instance_segmentation_generator)
from .multi_dimensional_segmentation import (automatic_3d_segmentation,
                                             automatic_tracking_implementation)
from .predictor import SamPredictor


def get_predictor_and_segmenter(
    model_type: str,
    checkpoint: Optional[Union[os.PathLike, str]] = None,
    device: Optional[str] = None,
    segmentation_mode: Optional[str] = None,
    is_tiled: bool = False,
    predictor: Optional[SamPredictor] = None,
    state: Optional[Dict] = None,
    **kwargs,
) -> Tuple[SamPredictor, Union[AMGBase, InstanceSegmentationWithDecoder]]:
    """The predictor and the automatic segmenter. ``segmentation_mode`` None or
    "auto": AIS when the model carries a decoder state, else AMG. A given
    ``predictor`` comes with its ``state``; the decoder then goes to the
    predictor's device unless ``device`` says otherwise."""
    if predictor is None:
        predictor, state = util.get_sam_model(model_type=model_type, device=device,
                                              checkpoint_path=checkpoint, return_state=True)
    elif state is None:
        raise ValueError("Pass the predictor's state (get_sam_model(..., return_state=True)).")
    if device is None:
        device = predictor.device

    if segmentation_mode in (None, "auto"):
        segmentation_mode = (DEFAULT_SEGMENTATION_MODE_WITH_DECODER if "decoder_state" in state
                             else "amg")
    if segmentation_mode.lower() == "amg":
        decoder = None
    else:
        if "decoder_state" not in state:
            raise RuntimeError(f"You have passed 'segmentation_mode={segmentation_mode}', "
                               "but your model does not contain a decoder.")
        decoder = get_decoder(decoder_state=state["decoder_state"], device=device)
    segmenter = get_instance_segmentation_generator(predictor=predictor, is_tiled=is_tiled,
                                                    decoder=decoder,
                                                    segmentation_mode=segmentation_mode, **kwargs)
    return predictor, segmenter


def _write_tif(path, data):
    import imageio.v3 as imageio
    try:
        imageio.imwrite(path, data, compression="zlib")
    except TypeError:  # a tifffile backend without compression
        imageio.imwrite(path, data)


def _add_suffix_to_output_path(output_path, suffix: str) -> str:
    fpath = Path(output_path).resolve()
    fext = fpath.suffix if fpath.suffix else ".tif"
    return str(fpath.with_name(f"{fpath.stem}{suffix}{fext}"))


def automatic_tracking(
    predictor: SamPredictor,
    segmenter,
    input_path,
    output_path=None,
    embedding_path=None,
    key: Optional[str] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True,
    return_embeddings: bool = False,
    annotate: bool = False,
    batch_size: int = 1,
    **generate_kwargs,
):
    """Automatic tracking of a timeseries (an array or a file): each frame
    segmented, then linked over time. ``gap_closing`` and ``min_time_extent``
    among ``generate_kwargs`` go to the tracking, the rest to ``generate``.
    ``output_path`` is a folder for the cell-tracking-challenge export (it
    needs ``imageio``). Returns (segmentation, lineages)."""
    image_data = (util.load_image_data(input_path, key)
                  if isinstance(input_path, (str, os.PathLike)) else input_path)
    if image_data.ndim != 3 and not (image_data.ndim == 4 and image_data.shape[-1] == 3):
        raise ValueError(f"The inputs does not match the shape expectation of 3d inputs: "
                         f"{image_data.shape}")

    gap_closing = generate_kwargs.pop("gap_closing", None)
    min_time_extent = generate_kwargs.pop("min_time_extent", None)
    segmentation, lineage, image_embeddings = automatic_tracking_implementation(
        image_data, predictor, segmenter, embedding_path=embedding_path,
        gap_closing=gap_closing, min_time_extent=min_time_extent,
        tile_shape=tile_shape, halo=halo, verbose=verbose, batch_size=batch_size,
        return_embeddings=True, output_folder=output_path, **generate_kwargs)
    if annotate:
        raise NotImplementedError("Annotation after running the automated tracking is "
                                  "currently not supported.")
    if return_embeddings:
        return segmentation, lineage, image_embeddings
    return segmentation, lineage


def automatic_instance_segmentation(
    predictor: SamPredictor,
    segmenter,
    input_path,
    output_path=None,
    embedding_path=None,
    mask_path=None,
    key: Optional[str] = None,
    mask_key: Optional[str] = None,
    ndim: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True,
    return_embeddings: bool = False,
    annotate: bool = False,
    batch_size: int = 1,
    **generate_kwargs,
) -> np.ndarray:
    """Automatic instance segmentation of a 2d image or a volume (an array or
    a file): the embeddings (tiled with ``tile_shape`` / ``halo``, cached at
    ``embedding_path``), ``initialize``, then ``generate(**generate_kwargs)``;
    a volume (``ndim=3``) slice by slice, merged into 3d. The result goes to
    ``output_path`` as a tif when given; an existing result there is left as
    it is and None returned. With ``annotate`` the result (written with the
    suffix ``_automatic``) opens in the annotator, and what is committed there
    when it closes is returned (and written to ``output_path``)."""
    if output_path is not None:
        output_path = Path(output_path).with_suffix(".tif")
        if os.path.exists(output_path):
            print(f"The segmentation results are already stored at "
                  f"'{os.path.abspath(output_path)}'.")
            return None

    image_data = (util.load_image_data(input_path, key)
                  if isinstance(input_path, (str, os.PathLike)) else input_path)
    ndim = image_data.ndim if ndim is None else ndim
    mask = (util.load_image_data(mask_path, mask_key)
            if isinstance(mask_path, (str, os.PathLike)) else mask_path)

    if ndim == 2:
        if image_data.ndim != 2 and not (image_data.ndim == 3 and image_data.shape[-1] == 3):
            raise ValueError(f"The inputs does not match the shape expectation of 2d inputs: "
                             f"{image_data.shape}")
        image_embeddings = util.precompute_image_embeddings(
            predictor=predictor, input_=image_data, save_path=embedding_path, ndim=ndim,
            tile_shape=tile_shape, halo=halo, verbose=verbose, batch_size=batch_size, mask=mask)
        initialize_kwargs = dict(image=image_data, image_embeddings=image_embeddings,
                                 verbose=verbose)
        if mask is not None:
            initialize_kwargs["mask"] = mask
        if isinstance(segmenter, InstanceSegmentationWithDecoder) and tile_shape is not None:
            initialize_kwargs["batch_size"] = batch_size
        segmenter.initialize(**initialize_kwargs)
        instances = segmenter.generate(**generate_kwargs)
    else:
        if image_data.ndim != 3 and not (image_data.ndim == 4 and image_data.shape[-1] == 3):
            raise ValueError(f"The inputs does not match the shape expectation of 3d inputs: "
                             f"{image_data.shape}")
        if mask is not None:
            raise NotImplementedError("A mask is supported for 2d inputs only.")
        instances, image_embeddings = automatic_3d_segmentation(
            volume=image_data, predictor=predictor, segmentor=segmenter,
            embedding_path=embedding_path, tile_shape=tile_shape, halo=halo, verbose=verbose,
            return_embeddings=True, batch_size=batch_size, **generate_kwargs)

    if output_path is not None:
        _output_path = (_add_suffix_to_output_path(output_path, "_automatic") if annotate
                        else output_path)
        _write_tif(_output_path, instances)
        if verbose:
            print(f"The automatic segmentation results are stored at "
                  f"'{os.path.abspath(_output_path)}'.")
    if annotate:
        instances = _correct_with_annotator(predictor, image_data, image_embeddings, instances,
                                            ndim, tile_shape, halo)
        if output_path is not None:
            _write_tif(output_path, instances)
    if return_embeddings:
        return instances, image_embeddings
    return instances


def _correct_with_annotator(predictor, image_data, image_embeddings, instances, ndim,
                            tile_shape, halo):
    """Open the annotator on an automatic result for corrections, with the
    predictor that computed it; what is committed when the viewer closes
    replaces the result."""
    try:
        import napari
    except ImportError as e:
        raise RuntimeError("annotate=True needs napari, which is not installed.") from e
    from .sam_annotator import annotator_2d, annotator_3d

    open_annotator = annotator_2d if ndim == 2 else annotator_3d
    viewer = open_annotator(image=image_data, model_type=predictor.model_name,
                            embedding_path=image_embeddings, segmentation_result=instances,
                            tile_shape=tile_shape, halo=halo, return_viewer=True,
                            predictor=predictor)
    napari.run()
    return viewer.layers["committed_objects"].data


def _get_inputs_from_paths(paths, pattern):
    if isinstance(paths, str):
        paths = [paths]
    fpaths = []
    for path in paths:
        if os.path.isfile(path):
            fpaths.append(path)
        else:
            assert pattern is not None, (
                f"You must provide a pattern to search for files in the directory: "
                f"'{os.path.abspath(path)}'.")
            fpaths.extend(sorted(glob(os.path.join(path, pattern))))
    return fpaths


def _split_kwargs(extra_args: List[str]) -> Tuple[Dict, Dict]:
    """Unknown ``--key value`` CLI arguments, routed to the segmenter's
    constructor (the AMG grid settings) or to ``generate``."""
    init_keys = {"points_per_side", "points_per_batch", "crop_n_layers", "crop_overlap_ratio",
                 "crop_n_points_downscale_factor", "stability_score_offset"}

    def parse_value(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        return v

    init_kwargs, generate_kwargs = {}, {}
    key = None
    for token in extra_args:
        if token.startswith("--"):
            key = token[2:]
        elif key is not None:
            (init_kwargs if key in init_keys else generate_kwargs)[key] = parse_value(token)
            key = None
    return init_kwargs, generate_kwargs


def main():
    """The command line: ``micro_sam_tpu_torch.automatic_segmentation``."""
    import argparse

    available_models = ", ".join(util.get_model_names())
    parser = argparse.ArgumentParser(description="Run automatic segmentation for an image.")
    parser.add_argument("-i", "--input_path", required=True, nargs="+",
                        help="The filepath(s) to the image data or a directory.")
    parser.add_argument("-o", "--output_path", required=True,
                        help="The filepath to store the instance segmentation.")
    parser.add_argument("-e", "--embedding_path", default=None,
                        help="An optional path to cache the image embeddings.")
    parser.add_argument("--pattern", default=None, help="Glob pattern for directory inputs.")
    parser.add_argument("-k", "--key", default=None, help="Key for container file formats.")
    parser.add_argument("-m", "--model_type", default=util._DEFAULT_MODEL,
                        help=f"The segment anything model to use. One of: {available_models}.")
    parser.add_argument("-c", "--checkpoint", default=None, help="Checkpoint path.")
    parser.add_argument("--mode", "--segmentation_mode", dest="mode", default="auto",
                        choices=("auto", "amg", "ais", "apg"),
                        help="The automatic segmentation mode.")
    parser.add_argument("--annotate", action="store_true",
                        help="Open the annotator on the result (not ported yet).")
    parser.add_argument("--tile_shape", nargs="+", type=int, default=None)
    parser.add_argument("--halo", nargs="+", type=int, default=None)
    parser.add_argument("-n", "--ndim", type=int, default=None)
    parser.add_argument("--mask_path", default=None)
    parser.add_argument("--mask_key", default=None)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("-d", "--device", default=None,
                        help="cuda (the default) or cpu.")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--tracking", action="store_true",
                        help="Run automatic tracking instead of segmentation.")

    args, extra = parser.parse_known_args()
    init_kwargs, generate_kwargs = _split_kwargs(extra)
    predictor, segmenter = get_predictor_and_segmenter(
        model_type=args.model_type, checkpoint=args.checkpoint, device=args.device,
        segmentation_mode=args.mode, is_tiled=args.tile_shape is not None, **init_kwargs)

    input_paths = _get_inputs_from_paths(args.input_path, args.pattern)
    multiple = len(input_paths) > 1
    for path in input_paths:
        if multiple:
            out = os.path.join(args.output_path, Path(path).stem + ".tif")
            emb = None if args.embedding_path is None else os.path.join(
                args.embedding_path, Path(path).stem + ".zarr")
            os.makedirs(args.output_path, exist_ok=True)
        else:
            out, emb = args.output_path, args.embedding_path
        run = automatic_tracking if args.tracking else automatic_instance_segmentation
        extra_kwargs = {} if args.tracking else dict(
            ndim=args.ndim, mask_path=args.mask_path, mask_key=args.mask_key,
            annotate=args.annotate)
        run(predictor=predictor, segmenter=segmenter, input_path=path, output_path=out,
            embedding_path=emb, key=args.key,
            tile_shape=None if args.tile_shape is None else tuple(args.tile_shape),
            halo=None if args.halo is None else tuple(args.halo), verbose=args.verbose,
            batch_size=args.batch_size, **extra_kwargs, **generate_kwargs)


if __name__ == "__main__":
    main()
