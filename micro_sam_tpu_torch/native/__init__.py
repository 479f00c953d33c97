"""Host-side postprocessing in C++: connected components, RLE, label bookkeeping.

The port's counterpart of ``micro_sam_tpu/native``. ``src/postprocess.cpp`` is
a copy of the JAX package's source, whole. It is compiled at first use
with ``g++ -O3 -shared -fPIC`` into ``build/native-<hash>/`` at the root of the
checkout (the hash covers the source and the command, so an edited source
rebuilds), to a temporary name first and then renamed, so that processes
building at the same time never load a half-written library. A failed build
or load raises: nothing stands in for the library.

Each wrapper backed by the library has a numpy twin, ``<name>_plain``, with
the same results; the tests hold one against the other. The main path never
selects a twin. ``unique``, ``isin``, ``relabel_consecutive``, ``size_filter``,
``distance_transform`` and ``overlap`` are numpy / scipy in both packages.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "postprocess.cpp")
COMMAND = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# pixel count from which label() takes the strip-parallel kernel and
# seeded_watershed the multithreaded union-find flood
_PARALLEL_MIN_SIZE = 1 << 22

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "label_multilabel_2d": ([_P, _P, _I64, _I64], _I64),
    "label_multilabel_2d_par": ([_P, _P, _I64, _I64, _I64], _I64),
    "rle_encode_colmajor": ([_P, _P, _I64, _I64], _I64),
    "rle_encode_packed": ([_P, _I64, _P], _I64),
    "rle_encode_packed_cropped": ([_P, _I64, _I64, _I64, _I64, _I64, _I64, _P], _I64),
    "seeded_watershed_2d": ([_P, _P, _P, _I64, _I64], None),
    "seeded_watershed_3d": ([_P, _P, _P, _I64, _I64, _I64], None),
    "watershed_unionfind_2d": ([_P, _P, _P, _I64, _I64, _I64], None),
    "watershed_unionfind_3d": ([_P, _P, _P, _I64, _I64, _I64, _I64], None),
    "greedy_multicut": ([_I64, _P, _P, _I64, _P], None),
}


def build_dir() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(COMMAND + (platform.machine(),)).encode())
    root = os.path.dirname(os.path.dirname(_HERE))  # the checkout
    return os.path.join(root, "build", f"native-{h.hexdigest()[:16]}")


def library_path() -> str:
    """The built library, compiling it first if it is not there yet."""
    out_dir = build_dir()
    path = os.path.join(out_dir, "libpostprocess.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([*COMMAND, SOURCE, "-o", tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (rc {res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# Connected components and label bookkeeping
# ---------------------------------------------------------------------------

def label(segmentation: np.ndarray, block_shape=None, with_background: bool = True) -> np.ndarray:
    """Connected components (4-adjacency) of a multi-label segmentation: two
    touching regions of different ids stay apart. Ids count from 1 in raster
    order of each component's first pixel; 0 stays background. 2d runs in
    the library; the library has no 3d labelling, so a volume takes the
    numpy version (the same semantics, face adjacency)."""
    seg = np.asarray(segmentation)
    if seg.ndim != 2:
        return label_plain(seg)
    lib = library()
    out = np.zeros(seg.shape, dtype=np.uint32)
    seg32 = np.ascontiguousarray(seg, dtype=np.uint32)
    if seg.size >= _PARALLEL_MIN_SIZE:
        lib.label_multilabel_2d_par(_ptr(seg32), _ptr(out), seg.shape[0], seg.shape[1], 0)
    else:
        lib.label_multilabel_2d(_ptr(seg32), _ptr(out), seg.shape[0], seg.shape[1])
    return out


def label_plain(segmentation: np.ndarray) -> np.ndarray:
    """numpy / scipy twin of ``label``: each id's components on their own."""
    seg = np.asarray(segmentation)
    ids, dense = np.unique(seg, return_inverse=True)
    dense = dense.reshape(seg.shape) + (1 if ids[0] != 0 else 0)  # 0 stays background
    structure = ndimage.generate_binary_structure(seg.ndim, 1)
    out = np.zeros(seg.shape, dtype=np.int64)
    n_total = 0
    for idx, sl in enumerate(ndimage.find_objects(dense), start=1):
        if sl is None:
            continue
        cc, n = ndimage.label(dense[sl] == idx, structure=structure)
        out[sl][cc > 0] = cc[cc > 0] + n_total
        n_total += n
    # number the components by their first pixel in raster order
    flat = out.ravel()
    keys, first = np.unique(flat, return_index=True)
    rank = np.zeros(n_total + 1, dtype=np.uint32)
    fg = keys != 0
    rank[keys[fg][np.argsort(first[fg], kind="stable")]] = \
        np.arange(1, int(fg.sum()) + 1, dtype=np.uint32)
    return rank[out]


def unique(segmentation: np.ndarray, return_counts: bool = False, block_shape=None):
    return np.unique(np.asarray(segmentation), return_counts=return_counts)


def isin(segmentation: np.ndarray, ids, out: Optional[np.ndarray] = None, block_shape=None):
    res = np.isin(np.asarray(segmentation), np.asarray(ids))
    if out is not None:
        out[...] = res
        return out
    return res


def relabel_consecutive(segmentation: np.ndarray, start_label: int = 1, block_shape=None):
    """Relabel to consecutive ids from ``start_label``, in the order of the ids;
    0 stays background. Returns (relabeled, max_id, mapping)."""
    seg = np.asarray(segmentation)
    if seg.dtype == bool:
        seg = seg.astype(np.uint32)
    ids = np.unique(seg)
    ids = ids[ids != 0]
    mapping = {0: 0}
    new_ids = np.arange(start_label, start_label + len(ids), dtype=seg.dtype)
    lookup = np.zeros(int(seg.max()) + 1 if seg.size else 1, dtype=seg.dtype)
    lookup[ids] = new_ids
    out = lookup[seg]
    mapping.update({int(i): int(n) for i, n in zip(ids, new_ids)})
    return out, (int(new_ids[-1]) if len(new_ids) else 0), mapping


def size_filter(segmentation: np.ndarray, min_size: int = 0,
                max_size: Optional[int] = None, relabel: bool = True) -> np.ndarray:
    """Objects under ``min_size`` (or over ``max_size``) pixels set to 0; with
    ``relabel`` the ids then made consecutive."""
    seg = np.asarray(segmentation).copy()
    ids, counts = np.unique(seg, return_counts=True)
    remove = ids[(counts < min_size) & (ids != 0)]
    if max_size is not None:
        remove = np.concatenate([remove, ids[(counts > max_size) & (ids != 0)]])
    if len(remove):
        seg[np.isin(seg, remove)] = 0
    if relabel:
        seg, _, _ = relabel_consecutive(seg)
    return seg


def distance_transform(mask: np.ndarray, sampling=None) -> np.ndarray:
    """Euclidean distance of each foreground pixel to the nearest background one."""
    return ndimage.distance_transform_edt(mask, sampling=sampling)


class overlap:
    """Pairwise pixel overlap of two segmentations (the nifty.ground_truth
    ``overlap`` surface the tiled stitching reads)."""

    def __init__(self, seg_a: np.ndarray, seg_b: np.ndarray):
        a = np.asarray(seg_a).ravel()
        b = np.asarray(seg_b).ravel()
        pairs = (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)
        uniq, counts = np.unique(pairs, return_counts=True)
        ids_a = (uniq >> np.uint64(32)).astype(np.int64)
        ids_b = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int64)
        self._table: Dict[int, List[Tuple[int, int]]] = {}
        for ia, ib, c in zip(ids_a, ids_b, counts):
            self._table.setdefault(int(ia), []).append((int(ib), int(c)))
        self._sizes_a = np.bincount(a.astype(np.int64))

    def overlapArrays(self, seg_id: int, sorted_: bool = True):
        entries = self._table.get(int(seg_id), [])
        ids = np.array([e[0] for e in entries], dtype=np.int64)
        vals = np.array([e[1] for e in entries], dtype=np.float64)
        if sorted_ and len(vals):
            order = np.argsort(-vals)
            ids, vals = ids[order], vals[order]
        return ids, vals

    def overlapArraysNormalized(self, seg_id: int, sorted_: bool = True):
        ids, vals = self.overlapArrays(seg_id, sorted_)
        size = self._sizes_a[seg_id] if seg_id < len(self._sizes_a) else 0
        if size > 0:
            vals = vals / float(size)
        return ids, vals


# ---------------------------------------------------------------------------
# RLE (uncompressed COCO: column-major, counts start with the run of zeros)
# ---------------------------------------------------------------------------

def compute_rle_batch(masks: np.ndarray) -> List[Dict]:
    """RLE records of a (N, H, W) batch of binary masks."""
    lib = library()
    out = []
    for m in masks:
        m = np.ascontiguousarray(m, dtype=np.uint8)
        h, w = m.shape
        counts = np.zeros(h * w + 2, dtype=np.int64)
        n = lib.rle_encode_colmajor(_ptr(m), _ptr(counts), h, w)
        out.append({"size": [h, w], "counts": counts[:n].tolist()})
    return out


def compute_rle_batch_plain(masks: np.ndarray) -> List[Dict]:
    """numpy twin of ``compute_rle_batch``."""
    from ..ops.amg_utils import mask_to_rle
    return [mask_to_rle(m) for m in np.asarray(masks, dtype=bool)]


def rle_from_packed(packed: np.ndarray, h: int, w: int) -> List[Dict]:
    """RLE records from packed masks.

    packed: (N, W, ceil(H/8)) uint8, ``packbits`` of the *transposed* (w, h)
    mask along its last axis, most significant bit first. When h is a
    multiple of 8 the bytes are the column-major bitstream itself and one scan
    reads it; otherwise each column's pad bits are skipped column by column
    (the cropped encoder with the crop at the origin)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n = len(packed)
    if n == 0:
        return []
    if packed.size != n * w * -(-h // 8):
        raise ValueError(f"packed {packed.shape} is not {n} masks of {w} columns of "
                         f"{-(-h // 8)} bytes")
    if h % 8:
        return rle_from_packed_cropped(packed.reshape(n, w, -1), np.zeros((n, 2), np.int64),
                                       (h, w), h, w)
    lib = library()
    n_bits = h * w
    counts = np.zeros(n_bits + 2, dtype=np.int64)
    out = []
    for row in packed.reshape(n, -1):
        cnt = lib.rle_encode_packed(_ptr(row), n_bits, _ptr(counts))
        out.append({"size": [h, w], "counts": counts[:cnt].copy()})
    return out


def _unpack(packed: np.ndarray, rows: int) -> np.ndarray:
    """(N, C, ceil(rows/8)) packed columns -> (N, rows, C) bool masks."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=-1)[..., :rows] \
        .transpose(0, 2, 1).astype(bool)


def rle_from_packed_plain(packed: np.ndarray, h: int, w: int) -> List[Dict]:
    """numpy twin of ``rle_from_packed``."""
    from ..ops.amg_utils import mask_to_rle
    packed = np.asarray(packed, np.uint8)
    return [mask_to_rle(m) for m in _unpack(packed.reshape(len(packed), w, -1), h)]


def rle_from_packed_cropped(packed: np.ndarray, origins: np.ndarray, crop_hw: Tuple[int, int],
                            h: int, w: int) -> List[Dict]:
    """Full-frame (h, w) RLE records from packed windows.

    packed: (N, crop_w, ceil(crop_h/8)) uint8, each window packed as in
    ``rle_from_packed``; origins: (N, 2) the (x0, y0) of each window in the
    frame; everything outside a window is background. The records come out
    without the full mask ever being built on the host."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    origins = np.asarray(origins, dtype=np.int64).reshape(-1, 2)
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    n = len(packed)
    if n == 0:
        return []
    if packed.size != n * cw * -(-ch // 8) or origins.shape[0] != n:
        raise ValueError(f"packed {packed.shape} / origins {origins.shape} are not {n} windows "
                         f"of {cw} columns of {-(-ch // 8)} bytes")
    if (origins < 0).any() or (origins[:, 0] + cw > w).any() or (origins[:, 1] + ch > h).any():
        raise ValueError(f"a {ch} x {cw} window at {origins.tolist()} leaves the {h} x {w} frame")
    lib = library()
    counts = np.zeros(ch * cw + 2 * cw + 4, dtype=np.int64)
    flat = packed.reshape(n, -1)
    out = []
    for i in range(n):
        cnt = lib.rle_encode_packed_cropped(_ptr(flat[i]), cw, ch, int(origins[i, 0]),
                                            int(origins[i, 1]), h, w, _ptr(counts))
        out.append({"size": [h, w], "counts": counts[:cnt].copy()})
    return out


def rle_from_packed_cropped_plain(packed: np.ndarray, origins: np.ndarray,
                                  crop_hw: Tuple[int, int], h: int, w: int) -> List[Dict]:
    """numpy twin of ``rle_from_packed_cropped``: paste each window into a
    full frame and encode that."""
    from ..ops.amg_utils import mask_to_rle
    origins = np.asarray(origins, dtype=np.int64).reshape(-1, 2)
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    windows = _unpack(np.asarray(packed, np.uint8).reshape(len(origins), cw, -1), ch)
    out = []
    full = np.zeros((h, w), dtype=bool)
    for (x0, y0), win in zip(origins, windows):
        full[:] = False
        full[y0:y0 + ch, x0:x0 + cw] = win
        out.append(mask_to_rle(full))
    return out


# ---------------------------------------------------------------------------
# Seeded watershed
# ---------------------------------------------------------------------------

def _watershed_inputs(heightmap, seeds, mask):
    hm = np.ascontiguousarray(heightmap, dtype=np.float32)
    sd = np.ascontiguousarray(seeds, dtype=np.uint32)
    msk = (np.ones(hm.shape, dtype=np.uint8) if mask is None
           else np.ascontiguousarray(mask, dtype=np.uint8))
    if hm.ndim not in (2, 3) or sd.shape != hm.shape or msk.shape != hm.shape:
        raise ValueError(f"heightmap {hm.shape}, seeds {sd.shape}, mask {msk.shape}: "
                         "one 2d or 3d shape expected")
    return hm, sd, msk


def seeded_watershed(heightmap: np.ndarray, seeds: np.ndarray, mask: Optional[np.ndarray] = None,
                     n_threads: Optional[int] = None, method: Optional[str] = None) -> np.ndarray:
    """Seeded watershed of integer ``seeds`` over ``heightmap``, restricted to
    ``mask`` (4- / 6-adjacency). Pixels outside the mask stay 0.

    method:
      - "priority": the serial priority flood (ties broken first in, first out);
      - "unionfind": the multithreaded union-find over (height, index)-sorted
        pixels; the same result for any thread count, and the flood's except
        on exact height ties;
      - None: "unionfind" from 4M pixels on, else "priority".
    """
    hm, sd, msk = _watershed_inputs(heightmap, seeds, mask)
    if method is None:
        method = "unionfind" if hm.size >= _PARALLEL_MIN_SIZE else "priority"
    if method not in ("priority", "unionfind"):
        raise ValueError(f"Unknown watershed method {method!r}: 'priority' or 'unionfind'.")
    lib = library()
    out = sd.copy()
    if method == "unionfind":
        fn = lib.watershed_unionfind_2d if hm.ndim == 2 else lib.watershed_unionfind_3d
        fn(_ptr(hm), _ptr(out), _ptr(msk), *hm.shape, 0 if n_threads is None else n_threads)
    else:
        fn = lib.seeded_watershed_2d if hm.ndim == 2 else lib.seeded_watershed_3d
        fn(_ptr(hm), _ptr(out), _ptr(msk), *hm.shape)
    return out


def seeded_watershed_plain(heightmap: np.ndarray, seeds: np.ndarray,
                           mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Python twin of ``seeded_watershed(method="priority")``: the same
    priority flood (heap keyed by height, then by push order; neighbours
    pushed in the order -y, +y, -x, +x, z first in 3d)."""
    import heapq
    hm, sd, msk = _watershed_inputs(heightmap, seeds, mask)
    out = sd.copy()
    shape = hm.shape
    visited = (sd != 0) | (msk == 0)
    offsets = []
    for d in range(hm.ndim):
        for s in (-1, 1):
            off = [0] * hm.ndim
            off[d] = s
            offsets.append(tuple(off))
    heap = []
    counter = 0

    def push_neighbours(coord, lbl):
        nonlocal counter
        for off in offsets:
            nb = tuple(c + o for c, o in zip(coord, off))
            if all(0 <= c < n for c, n in zip(nb, shape)) and not visited[nb]:
                heapq.heappush(heap, (hm[nb], counter, nb, lbl))
                counter += 1

    for coord in np.column_stack(np.nonzero(sd)):
        coord = tuple(int(c) for c in coord)
        push_neighbours(coord, out[coord])
    while heap:
        _, _, coord, lbl = heapq.heappop(heap)
        if visited[coord]:
            continue
        visited[coord] = True
        out[coord] = lbl
        push_neighbours(coord, lbl)
    return out


# ---------------------------------------------------------------------------
# Greedy multicut (the 3d merge)
# ---------------------------------------------------------------------------

def _multicut_inputs(n_nodes, uv_ids, costs):
    uv = np.ascontiguousarray(uv_ids, dtype=np.int64).reshape(-1, 2)
    cs = np.ascontiguousarray(costs, dtype=np.float64).reshape(-1)
    if len(uv) != len(cs):
        raise ValueError(f"{len(uv)} edges, {len(cs)} costs")
    if len(uv) and (uv.min() < 0 or uv.max() >= n_nodes):
        raise ValueError(f"edge ids outside [0, {n_nodes})")
    return uv, cs


def greedy_multicut(n_nodes: int, uv_ids: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """Greedy additive edge contraction over a graph of ``n_nodes`` nodes:
    duplicate edges are summed; the attractive edges (cost > 0) are taken
    from the highest cost down, and each joins its two clusters if the summed
    cost of all edges between them is still positive. Returns (n_nodes,)
    int64 labels, consecutive from 0 in the order of each cluster's smallest
    node."""
    uv, cs = _multicut_inputs(n_nodes, uv_ids, costs)
    out = np.zeros(int(n_nodes), dtype=np.int64)
    library().greedy_multicut(int(n_nodes), _ptr(uv), _ptr(cs), len(uv), _ptr(out))
    return out


def greedy_multicut_plain(n_nodes: int, uv_ids: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """Python twin of ``greedy_multicut``: the same contraction on a heap of
    (-cost, u, v). A cluster's root is its smallest node, so the labels come
    in the same order as the library's."""
    import heapq
    uv, cs = _multicut_inputs(n_nodes, uv_ids, costs)
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    edge_costs: Dict[Tuple[int, int], float] = {}
    for (u, v), c in zip(uv.tolist(), cs.tolist()):
        key = (min(u, v), max(u, v))
        edge_costs[key] = edge_costs.get(key, 0.0) + c
    heap = [(-c, u, v) for (u, v), c in edge_costs.items() if c > 0]
    heapq.heapify(heap)
    while heap:
        _, u, v = heapq.heappop(heap)
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        cost = sum(c for (a, b), c in edge_costs.items() if {find(a), find(b)} == {ru, rv})
        if cost <= 0:
            continue
        parent[max(ru, rv)] = min(ru, rv)
    roots = np.array([find(i) for i in range(n_nodes)], dtype=np.int64)
    return np.unique(roots, return_inverse=True)[1].reshape(-1).astype(np.int64)
