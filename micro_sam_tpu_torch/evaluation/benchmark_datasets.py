"""Benchmarking suite over microscopy datasets: counterpart of the JAX
package's ``evaluation/benchmark_datasets.py`` (upstream
micro_sam/evaluation/benchmark_datasets.py:111-897).

Upstream enumerates ~30 torch_em-downloadable datasets; here datasets must
already exist on disk (torch_em stays an optional import) under
``<input_folder>/<dataset>/`` either as paired file folders
(``images/``+``labels/``; tif/png/npy) or as container files (h5/zarr/n5 with
per-dataset keys, mirroring DATASET_CONTAINER_KEYS). The evaluation series is
the reference's, end to end:

1. crop extraction — most-instances-first 512^2 (2d) / 32x512x512 (3d) crops,
   plus per-slice 2d crops from 3d volumes (reference :259-501),
2. automatic segmentation (decoder-default mode + optional explicit
   amg/ais/apg) in 2d and 3d (reference :510-575),
3. interactive segmentation — 2d iterative prompting from box/points with and
   without mask feedback; 3d per-object middle-slice prompting + volume
   projection via ``segment_slices_from_ground_truth`` (reference :577-668),
4. results as csv under ``<output_folder>/<dataset>/results/`` and staged
   cleanup via ``retain`` (reference :705-742).

The result tables are pandas DataFrames and the crops TIFF files, so pandas
and imageio are imported at the call. The runners build their models on the
card unless given ``device``.
"""
from __future__ import annotations

import os
import time
import warnings
from contextlib import contextmanager
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import util
from ..automatic_segmentation import (
    automatic_instance_segmentation,
    get_predictor_and_segmenter,
)
from ..utils.blocking import Blocking
from . import inference as inference_mod
from .evaluation import run_evaluation, run_evaluation_for_iterative_prompting
from .inference import run_inference_with_iterative_prompting
from .multi_dimensional_segmentation import segment_slices_from_ground_truth

# Dataset inventory mirrors the reference's benchmark matrix
# (reference benchmark_datasets.py:24-80); locally each is a folder of pairs.
LM_2D_DATASETS = [
    # in-domain
    "livecell", "deepbacs", "tissuenet", "neurips_cellseg", "cellpose",
    "dynamicnuclearnet", "orgasegment", "yeaz",
    # out-of-domain
    "arvidsson", "bitdepth_nucseg", "cellbindb", "covid_if", "deepseas",
    "hpa", "ifnuclei", "lizard", "organoidnet", "toiam", "vicar",
]
LM_3D_DATASETS = [
    "plantseg_root", "plantseg_ovules", "gonuclear", "mouse_embryo", "cellseg_3d",
]
EM_2D_DATASETS = ["mitolab_tem"]
EM_3D_DATASETS = [
    "lucchi", "platynereis_cilia", "uro_cell", "vnc", "sponge_em",
    "mitolab_3d", "nuc_mm_mouse", "nuc_mm_zebrafish", "asem_mito",
]
DATASETS = LM_2D_DATASETS + LM_3D_DATASETS + EM_2D_DATASETS + EM_3D_DATASETS

# Container-file datasets: {dataset: (raw_key(s), label_key)}
# (reference benchmark_datasets.py:87-108)
DATASET_CONTAINER_KEYS = {
    "tissuenet": ("raw/rgb", "labels/cell"),
    "covid_if": ("raw/serum_IgG/s0", "labels/cells/s0"),
    "dynamicnuclearnet": ("raw", "labels"),
    "hpa": (["raw/protein", "raw/microtubules", "raw/er"], "labels"),
    "lizard": ("image", "labels/segmentation"),
    "plantseg_root": ("raw", "label"),
    "plantseg_ovules": ("raw", "label"),
    "gonuclear": ("raw/nuclei", "labels/nuclei"),
    "mouse_embryo": ("raw", "label"),
    "lucchi": ("raw", "labels"),
    "nuc_mm_mouse": ("raw", "labels"),
    "nuc_mm_zebrafish": ("raw", "labels"),
    "asem_mito": ("raw", "labels"),
}

# Datasets whose fetchers return a folder of per-image files rather than
# path lists; the glob selects the images (reference benchmark_datasets.py:82).
DATASET_RETURNS_FOLDER = {
    "deepbacs": "*.tif",
    "mitolab_tem": "*.tiff",
}

DEFAULT_SEGMENTATION_MODE_WITH_DECODER = "ais"

# torch_em downloader spec: {dataset: (module, getter, subdir, kwargs)} —
# the per-dataset plumbing of reference benchmark_datasets.py:122-242,
# table-driven instead of 30 lambdas. Only used when torch_em is importable;
# otherwise local data is discovered instead.
_TORCH_EM_DOWNLOADERS = {
    "livecell": ("livecell", "get_livecell_data", "livecell", {}),
    "deepbacs": ("deepbacs", "get_deepbacs_data", "deepbacs", {"bac_type": "mixed"}),
    "tissuenet": ("tissuenet", "get_tissuenet_data", "tissuenet", {"split": "test"}),
    "neurips_cellseg": ("neurips_cell_seg", "get_neurips_cellseg_data",
                        "neurips_cellseg", {"split": "test", "_root_arg": True}),
    "cellpose": ("cellpose", "get_cellpose_data", "cellpose",
                 {"split": "train", "choice": "cyto2"}),
    "dynamicnuclearnet": ("dynamicnuclearnet", "get_dynamicnuclearnet_data",
                          "dynamicnuclearnet", {"split": "test"}),
    "orgasegment": ("orgasegment", "get_orgasegment_data", "orgasegment", {"split": "eval"}),
    "yeaz": ("yeaz", "get_yeaz_data", "yeaz", {"choice": "bf"}),
    "arvidsson": ("arvidsson", "get_arvidsson_data", "arvidsson", {"split": "test"}),
    "bitdepth_nucseg": ("bitdepth_nucseg", "get_bitdepth_nucseg_data", "bitdepth_nucseg", {}),
    "cellbindb": ("cellbindb", "get_cellbindb_data", "cellbindb", {}),
    "covid_if": ("covid_if", "get_covid_if_data", "covid_if", {}),
    "deepseas": ("deepseas", "get_deepseas_data", "deepseas",
                 {"split": "test", "_no_download": True}),
    "hpa": ("hpa", "get_hpa_segmentation_data", "hpa", {}),
    "ifnuclei": ("ifnuclei", "get_ifnuclei_data", "ifnuclei", {}),
    "lizard": ("lizard", "get_lizard_data", "lizard", {"split": "test"}),
    "organoidnet": ("organoidnet", "get_organoidnet_data", "organoidnet", {"split": "Test"}),
    "toiam": ("toiam", "get_toiam_data", "toiam", {}),
    "vicar": ("vicar", "get_vicar_data", "vicar", {}),
    "plantseg_root": ("plantseg", "get_plantseg_data", "plantseg_root",
                      {"split": "test", "name": "root"}),
    "plantseg_ovules": ("plantseg", "get_plantseg_data", "plantseg_ovules",
                        {"split": "test", "name": "ovules"}),
    "gonuclear": ("gonuclear", "get_gonuclear_data", "gonuclear", {}),
    "mouse_embryo": ("mouse_embryo", "get_mouse_embryo_data", "mouse_embryo", {}),
    "cellseg_3d": ("cellseg_3d", "get_cellseg_3d_data", "cellseg_3d", {}),
    "mitolab_tem": ("cem", "get_benchmark_data", "mitolab", {"dataset_id": 7}),
    "lucchi": ("lucchi", "get_lucchi_data", "lucchi", {"split": "test"}),
    "uro_cell": ("uro_cell", "get_uro_cell_data", "uro_cell", {}),
    "vnc": ("vnc", "get_vnc_data", "vnc", {}),
    "sponge_em": ("sponge_em", "get_sponge_em_data", "sponge_em", {}),
    "nuc_mm_mouse": ("nuc_mm", "get_nuc_mm_data", "nuc_mm", {"sample": "mouse"}),
    "nuc_mm_zebrafish": ("nuc_mm", "get_nuc_mm_data", "nuc_mm", {"sample": "zebrafish"}),
    "platynereis_cilia": ("platynereis", "get_platynereis_data", "platynereis",
                          {"name": "cilia"}),
}


def ensure_benchmark_datasets(path: str, dataset_choice: List[str]) -> None:
    """Fetch datasets through torch_em when it is installed; otherwise this
    is a no-op and local data is validated at discovery time (reference
    _download_benchmark_datasets, benchmark_datasets.py:111)."""
    try:
        from torch_em.data import datasets as te_datasets
    except ImportError:
        return
    for choice in dataset_choice:
        spec = _TORCH_EM_DOWNLOADERS.get(choice)
        if spec is None:
            continue
        module_name, getter, subdir, kwargs = spec
        kwargs = dict(kwargs)
        target = os.path.join(path, subdir)
        call_kwargs = {}
        if not kwargs.pop("_no_download", False):
            call_kwargs["download"] = True
        root_arg = kwargs.pop("_root_arg", False)
        call_kwargs["root" if root_arg else "path"] = target
        call_kwargs.update(kwargs)
        if choice == "mitolab_3d":
            continue  # multi-id dataset handled below
        getattr(getattr(te_datasets, module_name), getter)(**call_kwargs)
    if "mitolab_3d" in dataset_choice:
        for dataset_id in (1, 2, 3, 4, 5, 6):
            te_datasets.cem.get_benchmark_data(
                path=os.path.join(path, "mitolab"), dataset_id=dataset_id,
                download=True)
    if "asem_mito" in dataset_choice:
        te_datasets.asem.get_asem_data(
            path=os.path.join(path, "asem"),
            volume_ids=te_datasets.asem.ORGANELLES["mito"], download=True)


@contextmanager
def _filter_warnings(ignore_warnings):
    if ignore_warnings:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    else:
        yield


def _dataset_ndim(dataset_choice: str) -> int:
    return 2 if dataset_choice in (*LM_2D_DATASETS, *EM_2D_DATASETS) else 3


# ---------------------------------------------------------------------------
# Local data discovery (replaces the reference's torch_em downloaders)
# ---------------------------------------------------------------------------

_PAIR_EXTS = (".tif", ".tiff", ".png", ".npy", ".h5", ".hdf5", ".zarr", ".n5")


def _discover_local_pairs(data_path: str, dataset_choice: str):
    """(image_path, gt_path_or_key) pairs from a local dataset folder.

    Two layouts are accepted: ``images/``+``labels/`` paired folders, or (for
    DATASET_CONTAINER_KEYS datasets) container files directly in the folder,
    each holding both raw and labels under the configured keys.
    """
    img_dir = os.path.join(data_path, "images")
    gt_dir = os.path.join(data_path, "labels")
    if os.path.isdir(img_dir) and os.path.isdir(gt_dir):
        image_paths = sorted(
            p for p in glob(os.path.join(img_dir, "*")) if p.endswith(_PAIR_EXTS))
        gt_paths = sorted(
            p for p in glob(os.path.join(gt_dir, "*")) if p.endswith(_PAIR_EXTS))
        assert len(image_paths) == len(gt_paths), \
            f"#images != #labels under {data_path}"
        return list(zip(image_paths, gt_paths)), False

    if dataset_choice in DATASET_CONTAINER_KEYS:
        containers = sorted(
            p for p in glob(os.path.join(data_path, "*"))
            if p.endswith((".h5", ".hdf5", ".zarr", ".n5")))
        if containers:
            return [(p, p) for p in containers], True

    raise RuntimeError(
        f"Dataset '{dataset_choice}' not found under {data_path}. Expected "
        "either images/ + labels/ paired folders or container files "
        "(datasets are not downloaded)."
    )


def _load_pair(image_path, gt_path, dataset_choice, is_container):
    if not is_container:
        return util.load_image_data(image_path), util.load_image_data(gt_path)
    raw_key, label_key = DATASET_CONTAINER_KEYS[dataset_choice]
    gt = util.load_image_data(image_path, label_key)
    if isinstance(raw_key, list):  # multi-channel stack (e.g. hpa)
        image = np.stack(
            [util.load_image_data(image_path, k) for k in raw_key], axis=-1)
    else:
        image = util.load_image_data(image_path, raw_key)
    return image, gt


# ---------------------------------------------------------------------------
# Crop extraction (reference :259-501)
# ---------------------------------------------------------------------------

def _get_crops_for_input(image, gt, ndim, tile_shape, skip_smaller_shape,
                         crops_per_input):
    """Most-instances-first crops on the tile grid (reference :450-483)."""
    blocking = Blocking((0,) * ndim, gt.shape[:ndim], tile_shape)
    crop_boxes = [blocking.get_block(i).slicing for i in range(len(blocking))]
    n_instances = [len(np.unique(gt[box])) for box in crop_boxes]

    is_rgb = image.ndim == ndim + 1 and image.shape[-1] == 3
    full_shape = (*tile_shape, 3) if is_rgb else tuple(tile_shape)

    image_crops, gt_crops = [], []
    order = sorted(zip(n_instances, range(len(crop_boxes))), reverse=True)
    for i, (per_n_instance, box_id) in enumerate(order, start=1):
        if per_n_instance <= 1:  # background only from here on
            break
        box = crop_boxes[box_id]
        crop_image, crop_gt = image[box], gt[box]
        if skip_smaller_shape and crop_image.shape != full_shape:
            continue
        image_crops.append(crop_image)
        gt_crops.append(crop_gt)
        if image_crops and i >= crops_per_input:
            break
    return image_crops, gt_crops


def _save_image_label_crops(image_crops, gt_crops, dataset_choice, ndim,
                            image_counter, save_image_dir, save_gt_dir):
    import imageio.v3 as imageio

    for image_crop, gt_crop in zip(image_crops, gt_crops):
        fname = f"{dataset_choice}_{image_counter:05}.tif"
        if image_crop.ndim == gt_crop.ndim + 1 and image_crop.shape[-1] == 3:
            assert image_crop.shape[:-1] == gt_crop.shape
        else:
            assert image_crop.shape == gt_crop.shape
        imageio.imwrite(os.path.join(save_image_dir, fname), image_crop)
        imageio.imwrite(os.path.join(save_gt_dir, fname),
                        gt_crop.astype("uint32"))
        image_counter += 1
    return image_counter


def _extract_slices_from_dataset(path, dataset_choice, crops_per_input=10):
    """Extract the evaluation crops for one dataset into
    ``<path>/roi_{ndim}d/{inputs,labels}`` (+ roi_2d for volumes);
    returns ndim (reference :259-446)."""
    from ..native import label as connected_components

    ndim = _dataset_ndim(dataset_choice)
    tile_shape = (512, 512) if ndim == 2 else (32, 512, 512)
    extract_2d_from_volumes = ndim == 3

    save_image_dir = [os.path.join(path, f"roi_{ndim}d", "inputs")]
    save_gt_dir = [os.path.join(path, f"roi_{ndim}d", "labels")]
    if extract_2d_from_volumes:
        save_image_dir.append(os.path.join(path, "roi_2d", "inputs"))
        save_gt_dir.append(os.path.join(path, "roi_2d", "labels"))

    if all(os.path.exists(i) and os.path.exists(g)
           for i, g in zip(save_image_dir, save_gt_dir)):
        return ndim
    for d in save_image_dir + save_gt_dir:
        os.makedirs(d, exist_ok=True)

    pairs, is_container = _discover_local_pairs(path, dataset_choice)

    image_counter = 1
    for image_path, gt_path in pairs:
        image, gt = _load_pair(image_path, gt_path, dataset_choice, is_container)

        # channels-last for channel-first RGB-style rasters (reference :409-411)
        if ndim == 2 and image.ndim == 3 and image.shape[0] == 3:
            image = image.transpose(1, 2, 0)

        is_rgb = image.ndim == ndim + 1 and image.shape[-1] == 3
        target = (*tile_shape, 3) if is_rgb else tile_shape
        skip_smaller_shape = (np.array(image.shape) >= np.array(target)).all()

        # ensure instance labels (semantic/binary gt -> connected components)
        gt = connected_components(gt.astype("uint32"))
        if len(np.unique(gt)) == 1:
            continue

        image_crops, gt_crops = _get_crops_for_input(
            image, gt, ndim, tile_shape, skip_smaller_shape, crops_per_input)
        image_counter = _save_image_label_crops(
            image_crops, gt_crops, dataset_choice, ndim, image_counter,
            save_image_dir[0], save_gt_dir[0])

        if extract_2d_from_volumes:
            tile_2d = tile_shape[1:]
            crops_i, crops_g = [], []
            for z_im, z_gt in zip(image, gt):
                skip_z = (np.array(z_im.shape[:2]) >= np.array(tile_2d)).all()
                ic, gc = _get_crops_for_input(
                    z_im, z_gt, 2, tile_2d, skip_z, crops_per_input)
                crops_i.extend(ic)
                crops_g.extend(gc)
            image_counter = _save_image_label_crops(
                crops_i, crops_g, dataset_choice, 2, image_counter,
                save_image_dir[1], save_gt_dir[1])

    return ndim


def _get_image_label_paths(path, ndim):
    image_paths = sorted(glob(os.path.join(path, f"roi_{ndim}d", "inputs", "*")))
    gt_paths = sorted(glob(os.path.join(path, f"roi_{ndim}d", "labels", "*")))
    return image_paths, gt_paths


# ---------------------------------------------------------------------------
# Per-dataset evaluation runners (reference :510-668)
# ---------------------------------------------------------------------------

def _run_automatic_segmentation_per_dataset(
    image_paths, gt_paths, model_type, output_folder, ndim=None,
    checkpoint_path=None, segmentation_mode="ais", device=None, **auto_seg_kwargs,
):
    """Automatic segmentation (amg/ais/apg) over all crops + evaluation csv
    (reference :510-575)."""
    if segmentation_mode is None:  # default by decoder presence
        _, state = util.get_sam_model(
            model_type=model_type, checkpoint_path=checkpoint_path,
            return_state=True, device=device)
        segmentation_mode = (DEFAULT_SEGMENTATION_MODE_WITH_DECODER
                             if "decoder_state" in state else "amg")

    fname = f"{segmentation_mode}_{ndim}d"
    result_path = os.path.join(output_folder, "results", f"{fname}.csv")
    if os.path.exists(result_path):
        return

    prediction_dir = os.path.join(output_folder, fname, "inference")
    os.makedirs(prediction_dir, exist_ok=True)

    predictor, segmenter = get_predictor_and_segmenter(
        model_type=model_type, checkpoint=checkpoint_path,
        segmentation_mode=segmentation_mode, is_tiled=False, device=device,
    )
    for image_path in image_paths:
        output_path = os.path.join(prediction_dir, os.path.basename(image_path))
        if os.path.exists(output_path):
            continue
        automatic_instance_segmentation(
            predictor=predictor, segmenter=segmenter, input_path=image_path,
            output_path=output_path, ndim=ndim, verbose=False,
            **auto_seg_kwargs,
        )

    prediction_paths = sorted(glob(os.path.join(prediction_dir, "*")))
    run_evaluation(gt_paths=gt_paths[:len(prediction_paths)],
                   prediction_paths=prediction_paths, save_path=result_path)


def _run_interactive_segmentation_per_dataset(
    image_paths, gt_paths, output_folder, model_type, prompt_choice,
    ndim=None, checkpoint_path=None, use_masks=False, device=None,
):
    """Interactive segmentation series: 2d iterative prompting, or 3d
    per-object middle-slice prompting + volume projection (reference
    :577-668)."""
    import imageio.v3 as imageio
    import pandas as pd

    if ndim == 2:
        predictor = util.get_sam_model(
            model_type=model_type, checkpoint_path=checkpoint_path, device=device)
        prediction_root = os.path.join(
            output_folder, "interactive_segmentation_2d",
            f"start_with_{prompt_choice}",
            "iterative_prompting_" + ("with_masks" if use_masks
                                      else "without_masks"))
        run_inference_with_iterative_prompting(
            predictor=predictor, image_paths=image_paths, gt_paths=gt_paths,
            embedding_dir=None, prediction_dir=prediction_root,
            start_with_box_prompt=(prompt_choice == "box"), use_masks=use_masks,
        )
        run_evaluation_for_iterative_prompting(
            gt_paths=gt_paths, prediction_root=prediction_root,
            experiment_folder=output_folder,
            start_with_box_prompt=(prompt_choice == "box"), use_masks=use_masks,
        )
        return

    save_path = os.path.join(
        output_folder, "results",
        f"interactive_segmentation_3d_with_{prompt_choice}.csv")
    if os.path.exists(save_path):
        return

    results = []
    prediction_dir = os.path.join(
        output_folder, "interactive_segmentation_3d", f"{prompt_choice}")
    os.makedirs(prediction_dir, exist_ok=True)
    for image_path, gt_path in zip(image_paths, gt_paths):
        prediction_path = os.path.join(
            prediction_dir, os.path.basename(image_path))
        per_vol_result = segment_slices_from_ground_truth(
            volume=imageio.imread(image_path),
            ground_truth=imageio.imread(gt_path),
            model_type=model_type,
            checkpoint_path=checkpoint_path,
            save_path=prediction_path,
            interactive_seg_mode=prompt_choice,
            min_size=10,
            device=device,
        )
        results.append(pd.DataFrame([per_vol_result]))

    results = pd.concat(results)
    results = results.groupby(results.index).mean()
    results.to_csv(save_path)


def _run_benchmark_evaluation_series(
    image_paths, gt_paths, model_type, output_folder, ndim, checkpoint_path,
    segmentation_mode, evaluation_methods, device=None,
):
    """The full per-crop-set series matrix (reference :669-704)."""
    seg_kwargs = dict(
        image_paths=image_paths, gt_paths=gt_paths,
        output_folder=output_folder, ndim=ndim, model_type=model_type,
        checkpoint_path=checkpoint_path, device=device,
    )
    if evaluation_methods != "interactive":
        # default mode (AIS if a decoder exists, else AMG) ...
        _run_automatic_segmentation_per_dataset(
            segmentation_mode=None, **seg_kwargs)
        # ... plus an explicitly requested mode on top
        if segmentation_mode is not None:
            _run_automatic_segmentation_per_dataset(
                segmentation_mode=segmentation_mode, **seg_kwargs)

    if evaluation_methods != "automatic":
        _run_interactive_segmentation_per_dataset(prompt_choice="box", **seg_kwargs)
        _run_interactive_segmentation_per_dataset(
            prompt_choice="box", use_masks=True, **seg_kwargs)
        _run_interactive_segmentation_per_dataset(prompt_choice="points", **seg_kwargs)
        _run_interactive_segmentation_per_dataset(
            prompt_choice="points", use_masks=True, **seg_kwargs)


def _clear_cached_items(retain, path, output_folder):
    """Remove cached crops and predictions, keeping the results csvs; the
    categories in ``retain`` are kept: 'data', 'crops', 'automatic',
    'interactive' (reference :705-742).

    DELIBERATE deviation from upstream, as in the JAX package: source 'data'
    is NEVER removed by default here. Upstream re-downloads datasets on
    demand; without a download, deleting the input images/labels would be
    unrecoverable. Pass ``retain=[]`` explicitly to also remove the data.
    """
    import shutil

    REMOVE_LIST = ["data", "crops", "automatic", "interactive"]
    if retain is None:
        remove_list = ["crops", "automatic", "interactive"]  # keep source data
    else:
        remove_list = list(set(REMOVE_LIST) - set(retain))

    paths = []
    if "data" in remove_list or "crops" in remove_list:
        all_paths = glob(os.path.join(path, "*"))
        if "data" in remove_list and "crops" in remove_list:
            paths.extend(all_paths)
        else:
            for curr_path in all_paths:
                is_crop = os.path.basename(curr_path).startswith("roi")
                if is_crop and "crops" in remove_list:
                    paths.append(curr_path)
                elif not is_crop and "data" in remove_list:
                    paths.append(curr_path)

    if "automatic" in remove_list:
        for mode in ("amg", "ais", "apg"):
            paths.extend(glob(os.path.join(output_folder, f"{mode}_*")))
    if "interactive" in remove_list:
        paths.extend(glob(os.path.join(output_folder, "interactive_segmentation_*")))

    for p in paths:
        if Path(p).is_dir():
            shutil.rmtree(p, ignore_errors=True)
        else:
            os.remove(p)


def run_benchmark_evaluations(
    input_folder: Union[os.PathLike, str],
    dataset_choice: Union[str, List[str], None],
    model_type: str = util._DEFAULT_MODEL,
    output_folder: Optional[Union[str, os.PathLike]] = None,
    checkpoint_path: Optional[Union[str, os.PathLike]] = None,
    segmentation_mode: Optional[str] = None,
    retain: Optional[List[str]] = None,
    evaluation_methods: str = "all",
    ignore_warnings: bool = False,
    device: Optional[str] = None,
) -> None:
    """Run the full benchmark evaluation series over local datasets
    (reference benchmark_datasets.py:744-828).

    For 3d datasets the series runs twice: on 3d crops (automatic 3d +
    interactive per-object volume segmentation) and again on the per-slice
    2d crops.
    """
    start = time.time()
    assert output_folder is not None, "output_folder is required"
    if dataset_choice is None:
        dataset_choice = DATASETS
    elif isinstance(dataset_choice, str):
        dataset_choice = [dataset_choice]
    ensure_benchmark_datasets(str(input_folder), dataset_choice)

    with _filter_warnings(ignore_warnings):
        for choice in dataset_choice:
            dataset_output = os.path.join(output_folder, choice)
            os.makedirs(os.path.join(dataset_output, "results"), exist_ok=True)
            data_path = os.path.join(input_folder, choice)

            ndim = _extract_slices_from_dataset(
                path=data_path, dataset_choice=choice, crops_per_input=10)

            series_kwargs = dict(
                model_type=model_type, output_folder=dataset_output,
                checkpoint_path=checkpoint_path,
                segmentation_mode=segmentation_mode,
                evaluation_methods=evaluation_methods, device=device,
            )
            image_paths, gt_paths = _get_image_label_paths(data_path, ndim)
            _run_benchmark_evaluation_series(
                image_paths, gt_paths, ndim=ndim, **series_kwargs)

            if ndim == 3:
                image_paths, gt_paths = _get_image_label_paths(data_path, 2)
                _run_benchmark_evaluation_series(
                    image_paths, gt_paths, ndim=2, **series_kwargs)

            _clear_cached_items(
                retain=retain, path=data_path, output_folder=dataset_output)

    diff = time.time() - start
    hours, rest = divmod(diff, 3600)
    minutes, seconds = divmod(rest, 60)
    print("Time taken for running benchmarks: ",
          f"{int(hours)}h {int(minutes)}m {int(seconds)}s")


# ---------------------------------------------------------------------------
# Back-compat simple runner (pre-series API; kept for scripted use)
# ---------------------------------------------------------------------------

def run_benchmark_evaluation(
    dataset_root: str,
    dataset: str,
    model_type: str,
    output_folder: str,
    checkpoint_path: Optional[str] = None,
    run_amg: bool = True,
    run_ais: bool = True,
    run_interactive: bool = True,
    n_val: int = 5,
    retain: bool = False,
    device: Optional[str] = None,
):
    """Single-dataset evaluation without crop extraction: automatic (AIS if a
    decoder is present, AMG) + interactive box/point iterative prompting over
    raw (image, gt) pairs."""
    import pandas as pd
    pairs, _ = _discover_local_pairs(os.path.join(dataset_root, dataset), dataset)
    image_paths = [p for p, _ in pairs]
    gt_paths = [p for _, p in pairs]
    val_images, val_gts = image_paths[:n_val], gt_paths[:n_val]
    test_images, test_gts = image_paths[n_val:], gt_paths[n_val:]
    if not test_images:
        test_images, test_gts = image_paths, gt_paths

    experiment_folder = os.path.join(output_folder, dataset, model_type)
    os.makedirs(experiment_folder, exist_ok=True)
    results = {}

    predictor, state = util.get_sam_model(
        model_type=model_type, checkpoint_path=checkpoint_path, return_state=True,
        device=device,
    )
    has_decoder = "decoder_state" in state

    if run_ais and has_decoder:
        pred_dir = inference_mod.run_instance_segmentation_with_decoder(
            checkpoint_path, model_type, experiment_folder,
            val_images, val_gts, test_images, device=device,
        )
        preds = sorted(glob(os.path.join(pred_dir, "*.tif")))
        res = run_evaluation(test_gts[:len(preds)], preds, save_path=None)
        results["ais"] = res.iloc[0].to_dict()

    if run_amg:
        pred_dir = inference_mod.run_amg(
            checkpoint_path, model_type, experiment_folder,
            val_images, val_gts, test_images, device=device,
        )
        preds = sorted(glob(os.path.join(pred_dir, "*.tif")))
        res = run_evaluation(test_gts[:len(preds)], preds, save_path=None)
        results["amg"] = res.iloc[0].to_dict()

    if run_interactive:
        for start_with_box in (False, True):
            pred_root = os.path.join(
                experiment_folder,
                "start_with_box" if start_with_box else "start_with_point",
            )
            run_inference_with_iterative_prompting(
                predictor, test_images, test_gts,
                embedding_dir=None, prediction_dir=pred_root,
                start_with_box_prompt=start_with_box, n_iterations=3,
            )
            res = run_evaluation_for_iterative_prompting(
                test_gts, pred_root, experiment_folder,
                start_with_box_prompt=start_with_box,
            )
            key = "interactive_box" if start_with_box else "interactive_point"
            results[key] = res.iloc[-1].to_dict()

    df = pd.DataFrame(results).T
    df.to_csv(os.path.join(experiment_folder, "benchmark_results.csv"))
    if not retain:
        import shutil
        for sub in ("embeddings",):
            shutil.rmtree(os.path.join(experiment_folder, sub), ignore_errors=True)
    return df


def main(argv: Optional[List[str]] = None):
    """The command line: ``python -m micro_sam_tpu_torch.evaluation.benchmark_datasets``
    (reference :830-897)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Run evaluation for benchmarking SAM models on microscopy "
        "datasets (local data; there is no download).")
    parser.add_argument("-i", "--input_folder", type=str, required=True,
                        help="Directory holding the datasets.")
    parser.add_argument("-m", "--model_type", type=str, default=util._DEFAULT_MODEL)
    parser.add_argument("-c", "--checkpoint_path", type=str, default=None)
    parser.add_argument("-d", "--dataset_choice", type=str, nargs="*", default=None)
    parser.add_argument("-o", "--output_folder", type=str, required=True)
    parser.add_argument("--amg", action="store_true",
                        help="Run automatic segmentation in AMG mode "
                        "(reference --amg flag; same as --segmentation_mode amg).")
    parser.add_argument("--segmentation_mode", type=str, default=None,
                        choices=(None, "amg", "ais", "apg"),
                        help="Explicit automatic mode to run in addition to "
                        "the decoder-dependent default.")
    parser.add_argument("--retain", nargs="*", default=None,
                        choices=("data", "crops", "automatic", "interactive"))
    parser.add_argument("--evaluate", type=str, default="all",
                        choices=("all", "automatic", "interactive"))
    parser.add_argument("-D", "--device", default=None,
                        help="The device to run on: the GPU by default, 'cpu' on request.")
    args = parser.parse_args(argv)
    if args.amg:
        args.segmentation_mode = "amg"

    run_benchmark_evaluations(
        input_folder=args.input_folder,
        dataset_choice=args.dataset_choice,
        model_type=args.model_type,
        output_folder=args.output_folder,
        checkpoint_path=args.checkpoint_path,
        segmentation_mode=args.segmentation_mode,
        retain=args.retain,
        evaluation_methods=args.evaluate,
        ignore_warnings=True,
        device=args.device,
    )


if __name__ == "__main__":
    main()
