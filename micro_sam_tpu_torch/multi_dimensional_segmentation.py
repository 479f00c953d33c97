"""Multi-dimensional segmentation: projection of a mask through a volume, the
multicut merge of per-slice segmentations into 3d, and tracking over time.

Counterpart of ``micro_sam_tpu/multi_dimensional_segmentation.py``, with its
public names and signatures. The device work is the encoder, once per slice
or frame (``util.precompute_image_embeddings(ndim=3)``), and the decodes of
the prompt layer and of the automatic segmenters on the predictor's device;
the walk from slice to slice, the merge and the linking are host numpy and
scipy, with the multicut in the native C++ library (``native.greedy_multicut``).
Tracking links frame to frame with the greedy overlap linker, or with the
learned linker of ``learned_tracking`` when a ``tracker`` is given;
Trackastra, an optional external package, takes precedence over the greedy
linker where it is installed.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import warnings
from concurrent import futures
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy import ndimage

from . import native, util
from .instance_segmentation import AMGBase
from .ops.host_ops import regionprops
from .predictor import SamPredictor
from .prompt_based_segmentation import segment_from_mask

PROJECTION_MODES = ("box", "mask", "points", "points_and_mask", "single_point")

# projection mode -> (use_box, use_mask, use_points, use_single_point)
_PROJECTION_TABLE = {
    "box": (True, False, False, False),
    "mask": (True, True, False, False),
    "points": (False, False, True, False),
    "points_and_mask": (False, True, True, False),
    "single_point": (False, False, True, True),
}


def _validate_projection(projection):
    if isinstance(projection, dict):
        if set(projection) != {"use_box", "use_mask", "use_points"}:
            raise ValueError(
                "A projection dict needs exactly the keys "
                f"use_box / use_mask / use_points, got {sorted(projection)}."
            )
        return (projection["use_box"], projection["use_mask"],
                projection["use_points"], False)
    try:
        return _PROJECTION_TABLE[projection]
    except (KeyError, TypeError):
        raise ValueError(
            f"Invalid projection {projection!r}; choose one of "
            f"{sorted(_PROJECTION_TABLE)} or pass a flag dict."
        ) from None


def segment_mask_in_volume(
    segmentation: np.ndarray,
    predictor: SamPredictor,
    image_embeddings: util.ImageEmbeddings,
    segmented_slices: np.ndarray,
    stop_lower: bool,
    stop_upper: bool,
    iou_threshold: float,
    projection: Union[str, dict],
    update_progress=None,
    box_extension: float = 0.0,
    verbose: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Project an object mask through the volume slice by slice. Each slice
    is decoded on the predictor's device from slice ``i``'s embeddings; the
    walk is sequential (each slice's prompt is the previous slice's mask), so
    the host drives it.

    Structure: ``walk`` propagates outward or into gaps one slice at a time
    (optionally IoU-gated), ``seed_between`` segments a lone middle slice from
    the union of its two neighbors, and ``bridge`` fills the interior between
    two user-segmented slices by walking inward from both ends.
    """
    use_box, use_mask, use_points, use_single_point = _validate_projection(projection)
    notify = update_progress if update_progress is not None else (lambda *a: None)
    n_slices = segmentation.shape[0]

    def project(z, prompt_mask, return_all=False):
        return segment_from_mask(
            predictor, prompt_mask, image_embeddings=image_embeddings, i=z,
            use_mask=use_mask, use_box=use_box, use_points=use_points,
            box_extension=box_extension, return_all=return_all,
            use_single_point=use_single_point,
        )

    def walk(z_from, z_last, threshold=None):
        """Propagate from the (already segmented) z_from through z_last
        inclusive; each slice prompts from its predecessor. Returns the last
        slice actually written (z_from if the first IoU gate fails)."""
        step = 1 if z_last >= z_from else -1
        written = z_from
        for z in range(z_from + step, z_last + step, step):
            if verbose:
                print(f"Projecting object onto slice {z} (towards {z_last})")
            prompt = segmentation[z - step]
            seg_z, _, _ = project(z, prompt, return_all=True)
            if threshold is not None:
                overlap = util.compute_iou(prompt, seg_z)
                if overlap < threshold:
                    if verbose:
                        print(f"Stopping at slice {z}: IoU {overlap} < {threshold}")
                    break
            segmentation[z] = seg_z
            written = z
            if z != z_last:
                notify(1)
        return written

    def seed_between(z):
        """Segment slice z from the union of its two segmented neighbors."""
        joint = (segmentation[z - 1] == 1) | (segmentation[z + 1] == 1)
        segmentation[z] = project(z, joint)
        notify(1)

    def bridge(z_lo, z_hi):
        """Fill the unsegmented slices strictly between z_lo and z_hi."""
        gap = z_hi - z_lo
        if gap == 2:
            seed_between(z_lo + 1)
            return
        mid = (z_lo + z_hi) // 2
        even = gap % 2 == 0
        walk(z_lo, mid - 1 if even else mid)
        walk(z_hi, mid + 1)
        if even:
            # the center slice is equidistant from both walks: prompt it
            # from the union of the two freshly segmented neighbors
            seed_between(mid)

    anchors = np.sort(np.asarray(segmented_slices).astype(int))
    z0, z1 = int(anchors[0]), int(anchors[-1])

    # extend below the lowest / above the highest segmented slice
    z_min = z0 if (z0 == 0 or stop_lower) else walk(z0, 0, iou_threshold)
    z_max = z1 if (z1 == n_slices - 1 or stop_upper) else \
        walk(z1, n_slices - 1, iou_threshold)

    # fill every interior gap between consecutive user-segmented slices
    for z_lo, z_hi in zip(anchors[:-1], anchors[1:]):
        if z_hi - z_lo <= 1:
            continue
        if z_lo == z0 and stop_lower:
            walk(z_hi, z_lo + 1)        # only approach from above
        elif z_hi == z1 and stop_upper:
            walk(z_lo, z_hi - 1)        # only approach from below
        else:
            bridge(int(z_lo), int(z_hi))

    return segmentation, (z_min, z_max)


def _relabel_sequential(seg, offset=1):
    out, max_id, _ = native.relabel_consecutive(seg, start_label=offset)
    return out, max_id


def _coverage_counts(components: np.ndarray, labels: np.ndarray):
    """For each component id, how many distinct nonzero labels it covers and
    which ones. Vectorized via pair encoding (no per-id loop)."""
    fg = components > 0
    comp_f = components[fg].astype(np.int64)
    lab_f = labels[fg].astype(np.int64)
    base = int(labels.max()) + 1
    pairs = np.unique(comp_f * base + lab_f)
    comp_of_pair = pairs // base
    label_of_pair = pairs % base
    keep = label_of_pair != 0
    comp_of_pair, label_of_pair = comp_of_pair[keep], label_of_pair[keep]
    n_covered = np.bincount(comp_of_pair, minlength=int(components.max()) + 1)
    return n_covered, comp_of_pair, label_of_pair


def _merge_closed_components(seg_z, closed_fg):
    """One slice of the gap-closing merge: connected components of the closed
    foreground replace the original labels where that is unambiguous; a
    component spanning several original objects would fuse them, so those
    keep their original shapes instead."""
    components, _ = ndimage.label(closed_fg)
    n_covered, comp_of_pair, label_of_pair = _coverage_counts(components, seg_z)

    ambiguous_components = np.nonzero(n_covered > 1)[0]
    originals_to_keep = label_of_pair[np.isin(comp_of_pair, ambiguous_components)]

    merged = np.where(np.isin(components, ambiguous_components), 0, components)
    if originals_to_keep.size:
        keep_mask = np.isin(seg_z, originals_to_keep)
        shifted, _ = _relabel_sequential(
            np.where(keep_mask, seg_z, 0), offset=int(merged.max()) + 1
        )
        merged[keep_mask] = shifted[keep_mask]
    return merged


def _preprocess_closing(slice_segmentation, gap_closing, pbar_update):
    """Close holes along z, then reconcile the closed foreground with the
    original per-slice labels (adopt closed components unless they would fuse
    distinct objects). Labels come out globally unique across slices via a
    running offset."""
    along_z = np.zeros((3, 1, 1))
    along_z[:, 0, 0] = 1
    closed_fg = ndimage.binary_closing(
        slice_segmentation > 0, iterations=gap_closing, structure=along_z
    )

    n_slices = slice_segmentation.shape[0]
    out = np.zeros_like(slice_segmentation)
    next_label = 1
    for z in range(n_slices):
        # border slices can't be part of a closed z-gap: keep them as-is
        in_interior = gap_closing <= z < n_slices - gap_closing
        merged = (_merge_closed_components(slice_segmentation[z], closed_fg[z])
                  if in_interior else slice_segmentation[z])
        out[z], top = _relabel_sequential(merged, offset=next_label)
        next_label = max(next_label, int(top) + 1)
        pbar_update(1)
    return out


def _filter_z_extent(segmentation, min_z_extent):
    """Drop objects spanning fewer than min_z_extent slices."""
    too_flat = []
    for label_idx, obj_slices in enumerate(ndimage.find_objects(segmentation)):
        if obj_slices is None:
            continue
        z_span = obj_slices[0].stop - obj_slices[0].start
        if z_span < min_z_extent:
            too_flat.append(label_idx + 1)
    if too_flat:
        segmentation[np.isin(segmentation, too_flat)] = 0
    return segmentation


def compute_edges_from_overlap(slice_segmentation: np.ndarray, verbose=False) -> List[Dict]:
    """Overlap edges between objects in adjacent slices; score = IoU of the
    object footprints."""
    edges = []
    n_slices = slice_segmentation.shape[0]
    for z in range(n_slices - 1):
        a, b = slice_segmentation[z], slice_segmentation[z + 1]
        both = (a > 0) | (b > 0)
        if not both.any():
            continue
        av, bv = a[both].astype(np.int64), b[both].astype(np.int64)
        pairs = av.astype(np.uint64) << np.uint64(32) | bv.astype(np.uint64)
        uniq, counts = np.unique(pairs, return_counts=True)
        ids_a = (uniq >> np.uint64(32)).astype(np.int64)
        ids_b = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int64)
        sizes_a = np.bincount(av)
        sizes_b = np.bincount(bv)
        for ia, ib, c in zip(ids_a, ids_b, counts):
            if ia == 0 and ib == 0:
                continue
            union = sizes_a[ia] + sizes_b[ib] - c if (ia != 0 and ib != 0) else max(c, 1)
            if ia == 0 or ib == 0:
                continue
            edges.append({
                "source": int(ia), "target": int(ib),
                "score": float(c) / float(union),
            })
    return edges


def merge_instance_segmentation_3d(
    slice_segmentation: np.ndarray,
    beta: float = 0.5,
    with_background: bool = True,
    gap_closing: Optional[int] = None,
    min_z_extent: Optional[int] = None,
    verbose: bool = True,
    pbar_init=None,
    pbar_update=None,
) -> np.ndarray:
    """Merge stacked 2d instance segmentations into a consistent 3d segmentation
    via multicut over overlap edges (the graph solved by native.greedy_multicut)."""
    pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)

    if gap_closing is not None and gap_closing > 0:
        pbar_init(slice_segmentation.shape[0] + 1, "Merge segmentation")
        slice_segmentation = _preprocess_closing(slice_segmentation, gap_closing, pbar_update)
    else:
        pbar_init(1, "Merge segmentation")

    edges = compute_edges_from_overlap(slice_segmentation, verbose=False)
    if len(edges) == 0:
        pbar_close()
        return slice_segmentation

    uv_ids = np.array([[edge["source"], edge["target"]] for edge in edges])
    overlaps = np.clip(np.array([edge["score"] for edge in edges]), 1e-6, 1 - 1e-6)

    n_nodes = int(slice_segmentation.max() + 1)

    # logit costs with boundary bias beta: positive = attractive (merge)
    costs = np.log(overlaps / (1.0 - overlaps)) + np.log((1.0 - beta) / beta)
    if with_background:
        bg_edges = (uv_ids == 0).any(axis=1)
        costs[bg_edges] = -8.0

    node_labels = native.greedy_multicut(n_nodes, uv_ids, costs)
    # keep background mapped to 0
    bg_label = node_labels[0]
    remap = node_labels.copy()
    remap[node_labels == bg_label] = 0
    remap[node_labels != bg_label] += 1

    segmentation = remap[slice_segmentation]
    segmentation, _, _ = native.relabel_consecutive(segmentation)

    if min_z_extent is not None and min_z_extent > 0:
        segmentation = _filter_z_extent(segmentation, min_z_extent)

    pbar_update(1)
    pbar_close()
    return segmentation.astype("uint32")


def _segment_slices(
    data, predictor, segmentor, embedding_path, verbose, tile_shape, halo, batch_size=1, **kwargs
):
    assert data.ndim == 3

    image_embeddings = util.precompute_image_embeddings(
        predictor=predictor, input_=data, save_path=embedding_path, ndim=3,
        tile_shape=tile_shape, halo=halo, verbose=verbose, batch_size=batch_size,
    )

    offset = 0
    segmentation = np.zeros(data.shape, dtype="uint32")

    for i in range(segmentation.shape[0]):
        segmentor.initialize(data[i], image_embeddings=image_embeddings, verbose=False, i=i)
        seg = segmentor.generate(**kwargs)
        max_z = int(seg.max())
        if max_z == 0:
            continue
        seg = np.asarray(seg, dtype="uint32")
        seg[seg != 0] += offset
        offset = max_z + offset
        segmentation[i] = seg

    return segmentation, image_embeddings


def automatic_3d_segmentation(
    volume: np.ndarray,
    predictor: SamPredictor,
    segmentor: AMGBase,
    embedding_path=None,
    with_background: bool = True,
    gap_closing: Optional[int] = None,
    min_z_extent: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True,
    return_embeddings: bool = False,
    batch_size: int = 1,
    **kwargs,
) -> np.ndarray:
    """Per-slice automatic segmentation + 3d multicut merge."""
    segmentation, image_embeddings = _segment_slices(
        data=volume, predictor=predictor, segmentor=segmentor,
        embedding_path=embedding_path, verbose=verbose,
        tile_shape=tile_shape, halo=halo, batch_size=batch_size, **kwargs,
    )
    segmentation = merge_instance_segmentation_3d(
        segmentation, beta=0.5, with_background=with_background,
        gap_closing=gap_closing, min_z_extent=min_z_extent, verbose=verbose,
    )
    if return_embeddings:
        return segmentation, image_embeddings
    return segmentation


#
# Tracking
#

def _greedy_link_tracks(segmentation: np.ndarray, iou_threshold: float = 0.1):
    """Greedy overlap tracker: link objects frame to frame by IoU;
    two children claiming one parent = division. Returns
    (node_id -> track_id mapping, parent_graph {child_track: parent_track})."""
    n_frames = segmentation.shape[0]
    next_track = 1
    node_to_track: Dict[int, int] = {}
    parent_graph: Dict[int, int] = {}

    prev_ids: List[int] = []
    for z in range(n_frames):
        ids = [int(i) for i in np.unique(segmentation[z]) if i != 0]
        if z == 0:
            for i in ids:
                node_to_track[i] = next_track
                next_track += 1
            prev_ids = ids
            continue

        # candidate links from overlaps between frame z-1 and z
        ovlp = native.overlap(segmentation[z], segmentation[z - 1])
        sizes_prev = {int(p): int((segmentation[z - 1] == p).sum()) for p in prev_ids}
        candidates = []  # (iou, child_id, parent_id)
        for cid in ids:
            size_c = int((segmentation[z] == cid).sum())
            o_ids, o_vals = ovlp.overlapArrays(cid, sorted_=True)
            for oid, oval in zip(o_ids, o_vals):
                if oid == 0:
                    continue
                union = size_c + sizes_prev.get(int(oid), 0) - oval
                iou = oval / max(union, 1)
                if iou > iou_threshold:
                    candidates.append((float(iou), cid, int(oid)))

        candidates.sort(reverse=True)
        matched_children = set()
        parent_match_count: Dict[int, int] = {}
        for iou, cid, pid in candidates:
            if cid in matched_children:
                continue
            count = parent_match_count.get(pid, 0)
            if count >= 2:
                continue  # a cell divides into at most 2
            matched_children.add(cid)
            parent_match_count[pid] = count + 1
            if count == 0:
                # continuation: the best-matching child inherits the track
                node_to_track[cid] = node_to_track[pid]
            else:
                # division: the second child starts a new track with a parent link
                parent_track = node_to_track[pid]
                new_track = next_track
                next_track += 1
                node_to_track[cid] = new_track
                parent_graph[new_track] = parent_track

        for cid in ids:
            if cid not in matched_children:
                node_to_track[cid] = next_track
                next_track += 1
        prev_ids = ids

    return node_to_track, parent_graph


def track_across_frames(
    timeseries: np.ndarray,
    segmentation: np.ndarray,
    gap_closing: Optional[int] = None,
    min_time_extent: Optional[int] = None,
    verbose: bool = True,
    pbar_init=None,
    pbar_update=None,
    output_folder=None,
    tracker=None,
    device: Optional[str] = None,
) -> Tuple[np.ndarray, List[Dict]]:
    """Track segmented objects over time.

    Linker precedence: an explicit ``tracker`` (a
    ``learned_tracking.LearnedTracker`` instance, the string "learned", or
    "auto" = regime-aware selection between the learned and the greedy
    overlap linker from the sequence's motion statistics, with the learned
    scorer's confidence as a safety net — see doc/tracking_robustness.md),
    then the external Trackastra package if installed, then the greedy
    overlap linker. ``device`` places the learned scorer when ``tracker`` is
    a name (None: the GPU)."""
    pbar_init, pbar_update, pbar_close = util.handle_pbar(verbose, pbar_init, pbar_update)

    if gap_closing is not None and gap_closing > 0:
        segmentation = _preprocess_closing(segmentation, gap_closing, pbar_update)

    if tracker is not None:
        auto = tracker == "auto"
        if isinstance(tracker, str):
            from .learned_tracking import LearnedTracker
            tracker = LearnedTracker.from_pretrained(
                "default" if auto else tracker, device=device)
        if auto:
            tracking_result, parent_graph, used_greedy = \
                tracker.track_with_fallback(timeseries, segmentation)
            if used_greedy and verbose:
                print("track_across_frames: motion regime / confidence "
                      "selected the greedy overlap linker for this sequence "
                      "(see learned_tracking.choose_linker)")
        else:
            tracking_result, parent_graph = tracker.track(timeseries, segmentation)
        lineages = _lineages_from_parent_graph(parent_graph, tracking_result)
        if min_time_extent is not None and min_time_extent > 0:
            tracking_result = _filter_tracks(tracking_result, min_time_extent)
            lineages = _filter_lineages(lineages, tracking_result)
        if output_folder is not None:
            _export_ctc(tracking_result, lineages, output_folder)
        pbar_close()
        return tracking_result, lineages

    try:
        from trackastra.model import Trackastra  # noqa: F401
        has_trackastra = True
    except ImportError:
        has_trackastra = False

    if has_trackastra:
        segmentation, lineages = _trackastra_impl(
            timeseries, segmentation, min_time_extent, output_folder
        )
    else:
        node_to_track, parent_graph = _greedy_link_tracks(segmentation)
        tracking_result = _recolor_segmentation(segmentation, node_to_track)
        lineages = _lineages_from_parent_graph(parent_graph, tracking_result)

        if min_time_extent is not None and min_time_extent > 0:
            tracking_result = _filter_tracks(tracking_result, min_time_extent)
            lineages = _filter_lineages(lineages, tracking_result)
        if output_folder is not None:
            _export_ctc(tracking_result, lineages, output_folder)
        segmentation = tracking_result

    pbar_close()
    return segmentation, lineages


def _recolor_segmentation(segmentation, node_to_track):
    max_id = int(segmentation.max())
    lut = np.zeros(max_id + 1, dtype=np.uint32)
    for node, track in node_to_track.items():
        if node <= max_id:
            lut[node] = track
    return lut[segmentation]


def _connected_components(edges: List[Tuple[int, int]]) -> List[List[int]]:
    """Connected components of the graph of ``edges``, in networkx's order
    (``nx.connected_components`` of a graph built by ``add_edge`` in this
    order): nodes in the order they first appear, each component listed
    when its first node comes up."""
    nodes: Dict[int, None] = {}
    parent: Dict[int, int] = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in edges:
        for n in (u, v):
            if n not in nodes:
                nodes[n] = None
                parent[n] = n
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[rv] = ru
    members: Dict[int, List[int]] = {}
    for n in nodes:
        members.setdefault(find(n), []).append(n)
    return list(members.values())  # keyed in the order of each component's first node


def _lineages_from_parent_graph(parent_graph: Dict[int, int], tracking_result) -> List[Dict]:
    """Build the lineage representation: list of {parent_track: [children]}."""
    children_of: Dict[int, List[int]] = {}
    for child, parent in parent_graph.items():
        children_of.setdefault(parent, []).append(child)

    lineages = []
    for component in _connected_components([(p, c) for c, p in parent_graph.items()]):
        lineage_dict = {t: sorted(children_of.get(t, [])) for t in sorted(component)}
        lineages.append(lineage_dict)

    all_tracks = set(int(t) for t in np.unique(tracking_result) if t != 0)
    in_lineage = set()
    for lineage in lineages:
        in_lineage.update(lineage.keys())
        for v in lineage.values():
            in_lineage.update(v)
    lineages.extend([{t: []} for t in sorted(all_tracks - in_lineage)])
    return lineages


def _filter_tracks(tracking_result, min_track_length):
    props = regionprops(tracking_result)
    discard_ids = []
    for prop in props:
        z_start, z_stop = prop.bbox[0], prop.bbox[3]
        if z_stop - z_start < min_track_length:
            discard_ids.append(prop.label)
    tracking_result[np.isin(tracking_result, discard_ids)] = 0
    tracking_result, _, _ = native.relabel_consecutive(tracking_result)
    return tracking_result


def _filter_lineages(lineages, tracking_result):
    track_ids = set(np.unique(tracking_result)) - {0}
    filtered_lineages = []
    for lineage in lineages:
        filtered_lineage = {k: v for k, v in lineage.items() if k in track_ids}
        if filtered_lineage:
            filtered_lineages.append(filtered_lineage)
    return filtered_lineages


def _export_ctc(tracking_result, lineages, output_folder):
    """Cell-tracking-challenge style export: per-frame tifs + res_track.txt.
    Needs ``imageio``, imported here at the call."""
    os.makedirs(output_folder, exist_ok=True)
    import imageio.v3 as imageio
    for t in range(tracking_result.shape[0]):
        imageio.imwrite(
            os.path.join(output_folder, f"mask{t:03d}.tif"),
            tracking_result[t].astype(np.uint16),
        )
    # res_track.txt: track_id t_start t_end parent
    parent_of = {}
    for lineage in lineages:
        for parent, children in lineage.items():
            for c in children:
                parent_of[c] = parent
    lines = []
    for track_id in sorted(set(np.unique(tracking_result)) - {0}):
        zs = np.nonzero((tracking_result == track_id).any(axis=(1, 2)))[0]
        lines.append(f"{track_id} {zs.min()} {zs.max()} {parent_of.get(int(track_id), 0)}")
    with open(os.path.join(output_folder, "res_track.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _trackastra_impl(timeseries, segmentation, min_time_extent, output_folder):
    """The optional external Trackastra linker (its "general_2d" model in
    greedy mode), taken by ``track_across_frames`` where ``trackastra`` is
    importable. Trackastra is installed neither where the port's tests run
    nor on the GPU machine, so this branch is untested; it is kept as the JAX
    package has it."""
    from trackastra.model import Trackastra
    from trackastra.tracking import graph_to_ctc, graph_to_napari_tracks
    model = Trackastra.from_pretrained("general_2d", device="cpu")
    result = model.track(timeseries, segmentation, mode="greedy")
    try:
        lineage_graph, _ = result
    except ValueError:
        lineage_graph = result
    track_data, parent_graph, _ = graph_to_napari_tracks(lineage_graph)
    if track_data.size == 0:
        warnings.warn("Tracking result is empty.")
        return np.zeros_like(segmentation), []
    node_to_track, lineages = _extract_tracks_and_lineages(segmentation, track_data, parent_graph)
    tracking_result = _recolor_segmentation(segmentation, node_to_track)
    if output_folder is not None:
        graph_to_ctc(lineage_graph, segmentation, outdir=output_folder)
    lineages = _filter_lineages(lineages, tracking_result)
    return tracking_result, lineages


def _extract_tracks_and_lineages(segmentations, track_data, parent_graph):
    """napari track_data (track_id, t, y, x rows) + child->parent links ->
    (segmentation id -> track id map, lineage dicts).

    The lineage representation reuses _lineages_from_parent_graph (the same
    helper the native linker uses); segmentation ids are read off the label
    image at each track point's (t, y, x).
    """
    track_ids = track_data[:, 0].astype("int32")
    coords = np.round(track_data[:, 1:]).astype("int32")
    seg_ids_at_points = segmentations[tuple(coords.T)]

    node_to_track = dict(zip(seg_ids_at_points, track_ids))
    # any object no track point landed on maps to background
    for orphan in np.setdiff1d(np.unique(segmentations), seg_ids_at_points):
        node_to_track[orphan] = 0

    recolored = track_ids  # the tracks present, for singleton completion
    lineages = _lineages_from_parent_graph(dict(parent_graph), recolored)
    return node_to_track, lineages


def automatic_tracking_implementation(
    timeseries: np.ndarray,
    predictor: SamPredictor,
    segmentor,
    embedding_path=None,
    gap_closing: Optional[int] = None,
    min_time_extent: Optional[int] = None,
    tile_shape: Optional[Tuple[int, int]] = None,
    halo: Optional[Tuple[int, int]] = None,
    verbose: bool = True,
    return_embeddings: bool = False,
    batch_size: int = 1,
    output_folder=None,
    **kwargs,
) -> Tuple[np.ndarray, List[Dict]]:
    """Per-frame automatic segmentation + tracking."""
    segmentation, image_embeddings = _segment_slices(
        timeseries, predictor, segmentor, embedding_path, verbose,
        tile_shape=tile_shape, halo=halo, batch_size=batch_size, **kwargs,
    )
    segmentation, lineage = track_across_frames(
        timeseries=timeseries, segmentation=segmentation, gap_closing=gap_closing,
        min_time_extent=min_time_extent, verbose=verbose, output_folder=output_folder,
    )
    if return_embeddings:
        return segmentation, lineage, image_embeddings
    return segmentation, lineage


def get_napari_track_data(
    segmentation: np.ndarray, lineages: List[Dict], n_threads: Optional[int] = None
) -> Tuple[np.ndarray, Dict[int, List]]:
    """Derive napari tracking-layer inputs (track_id, t, y, x) + parent dict."""
    if n_threads is None:
        n_threads = mp.cpu_count()

    def compute_props(t):
        props = regionprops(segmentation[t])
        return np.array([[prop.label, t] + list(prop.centroid) for prop in props])

    with futures.ThreadPoolExecutor(n_threads) as tp:
        track_data = list(tp.map(compute_props, range(segmentation.shape[0])))
    track_data = [data for data in track_data if data.size > 0]
    track_data = np.concatenate(track_data) if track_data else np.zeros((0, 4))

    parent_graph = {
        child: [parent] for lineage in lineages
        for parent, children in lineage.items() for child in children
    }
    return track_data, parent_graph
