"""Learned frame-to-frame association for tracking.

Counterpart of ``micro_sam_tpu/learned_tracking.py``, with its public names
and signatures. Per-object region features (centroid, size, shape, intensity)
are paired between consecutive frames on the host; a small MLP scores each
candidate link on the scorer's device (one copy of the logits back per frame
transition) and a bipartite assignment (scipy Hungarian) selects links above
a threshold. Unmatched objects may attach to an already-matched parent as a
second child, which records a division. The scorer is an ``nn.Module``
(``LinkScorer``) computing in f32; its weights ride a plain ``.npz`` in the
JAX package's layout (``w1`` (23, 64), ``b1``, ``w2``, ``b2``, ``w3``,
``b3``, ``mu``, ``sigma``), which ``scorer_state_from_params`` /
``params_from_scorer`` turn into the module's state and back.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

FEATURE_DIM = 9          # per-object descriptor
PAIR_DIM = 2 * FEATURE_DIM + 5   # both descriptors + interaction terms


# -----------------------------------------------------------------------------
# Region features
# -----------------------------------------------------------------------------

def extract_frame_features(frame_seg: np.ndarray,
                           frame_image: Optional[np.ndarray] = None,
                           ) -> Tuple[np.ndarray, np.ndarray, List[Tuple]]:
    """Per-object descriptors of one labeled frame.

    Returns (object_ids, features (n, FEATURE_DIM), bboxes). Features:
    centroid y/x, sqrt(area), bbox height/width, fill ratio, mean/std
    intensity, aspect ratio — scale kept in pixels so motion offsets stay
    meaningful across frames.
    """
    ids = np.unique(frame_seg)
    ids = ids[ids != 0]
    feats = np.zeros((len(ids), FEATURE_DIM), dtype="float32")
    bboxes = []
    for row, oid in enumerate(ids):
        ys, xs = np.nonzero(frame_seg == oid)
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        area = float(len(ys))
        h, w = float(y1 - y0), float(x1 - x0)
        if frame_image is not None:
            vals = frame_image[ys, xs].astype("float64")
            mean_i, std_i = float(vals.mean()), float(vals.std())
        else:
            mean_i = std_i = 0.0
        feats[row] = [
            ys.mean(), xs.mean(), np.sqrt(area), h, w,
            area / max(h * w, 1.0), mean_i, std_i, h / max(w, 1.0),
        ]
        bboxes.append((y0, y1, x0, x1))
    return ids, feats, bboxes


def _bbox_iou(a, b) -> float:
    y0 = max(a[0], b[0]); y1 = min(a[1], b[1])
    x0 = max(a[2], b[2]); x1 = min(a[3], b[3])
    inter = max(y1 - y0, 0) * max(x1 - x0, 0)
    area_a = (a[1] - a[0]) * (a[3] - a[2])
    area_b = (b[1] - b[0]) * (b[3] - b[2])
    return inter / max(area_a + area_b - inter, 1)


def pair_features(f0: np.ndarray, f1: np.ndarray, b0, b1) -> np.ndarray:
    """Candidate-pair descriptors for all (n0, n1) pairs.

    Interaction terms: centroid offset dy/dx, distance, log size ratio and
    bbox IoU — the learned signal the greedy IoU tracker cannot express."""
    n0, n1 = len(f0), len(f1)
    out = np.zeros((n0, n1, PAIR_DIM), dtype="float32")
    for i in range(n0):
        dy = f1[:, 0] - f0[i, 0]
        dx = f1[:, 1] - f0[i, 1]
        dist = np.hypot(dy, dx)
        size_ratio = np.log((f1[:, 2] + 1.0) / (f0[i, 2] + 1.0))
        ious = np.array([_bbox_iou(b0[i], bb) for bb in b1], dtype="float32")
        out[i, :, :FEATURE_DIM] = f0[i]
        out[i, :, FEATURE_DIM:2 * FEATURE_DIM] = f1
        out[i, :, 2 * FEATURE_DIM:] = np.stack(
            [dy, dx, dist, size_ratio, ious], axis=-1)
    return out


# -----------------------------------------------------------------------------
# Scorer model
# -----------------------------------------------------------------------------

class LinkScorer(nn.Module):
    """x (..., PAIR_DIM) -> link logits (...,): the input normalized by the
    frozen buffers ``mu`` / ``sigma``, then three linear layers with tanh
    between them, in f32."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.register_buffer("mu", torch.zeros(PAIR_DIM))
        self.register_buffer("sigma", torch.ones(PAIR_DIM))
        self.fc1 = nn.Linear(PAIR_DIM, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = (x.float() - self.mu) / self.sigma
        h = torch.tanh(self.fc1(h))
        h = torch.tanh(self.fc2(h))
        return self.fc3(h)[..., 0]


_LAYERS = (("fc1", "1"), ("fc2", "2"), ("fc3", "3"))


def scorer_state_from_params(params) -> Dict[str, torch.Tensor]:
    """The npz layout (``w<k>`` (in, out), ``b<k>``, ``mu``, ``sigma``) ->
    ``LinkScorer``'s state dict (a Linear's weight is (out, in)), in f32."""
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))  # noqa: E731
    state = {"mu": t(params["mu"]), "sigma": t(params["sigma"])}
    for layer, k in _LAYERS:
        state[f"{layer}.weight"] = t(np.asarray(params[f"w{k}"]).T).contiguous()
        state[f"{layer}.bias"] = t(params[f"b{k}"]).reshape(-1)
    return state


def params_from_scorer(scorer: LinkScorer) -> Dict[str, np.ndarray]:
    """``LinkScorer`` -> the npz layout, float32 numpy."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in scorer.state_dict().items()}
    params = {"mu": sd["mu"], "sigma": sd["sigma"]}
    for layer, k in _LAYERS:
        params[f"w{k}"] = np.ascontiguousarray(sd[f"{layer}.weight"].T)
        params[f"b{k}"] = sd[f"{layer}.bias"]
    return params


def scorer_from_params(params, device="cpu") -> LinkScorer:
    """A ``LinkScorer`` holding ``params`` (the npz layout) on ``device``."""
    scorer = LinkScorer(hidden=np.asarray(params["w1"]).shape[1])
    scorer.load_state_dict(scorer_state_from_params(params))
    return scorer.to(device).eval()


def init_linker_params(generator: torch.Generator, hidden: int = 64):
    """Random scorer parameters in the npz layout: each weight N(0, 1) /
    sqrt(fan_in) from ``generator``, zero biases, an identity normalization."""
    scale = lambda fan_in, shape: (torch.randn(shape, generator=generator)  # noqa: E731
                                   / np.sqrt(fan_in)).numpy()
    return {
        "w1": scale(PAIR_DIM, (PAIR_DIM, hidden)), "b1": np.zeros(hidden, np.float32),
        "w2": scale(hidden, (hidden, hidden)), "b2": np.zeros(hidden, np.float32),
        "w3": scale(hidden, (hidden, 1)), "b3": np.zeros(1, np.float32),
        # per-feature input normalization, fit from training data
        "mu": np.zeros(PAIR_DIM, np.float32), "sigma": np.ones(PAIR_DIM, np.float32),
    }


def linker_apply(params, x):
    """x: (..., PAIR_DIM) -> link logits (...,), numpy, on the CPU; ``params``
    in the npz layout or a ``LinkScorer`` (then on its device)."""
    scorer = params if isinstance(params, LinkScorer) else scorer_from_params(params)
    device = scorer.mu.device
    with torch.no_grad():
        return scorer(torch.as_tensor(np.asarray(x, np.float32), device=device)).cpu().numpy()


def train_linker(pairs: np.ndarray, labels: np.ndarray, n_steps: int = 500,
                 hidden: int = 64, learning_rate: float = 1e-2, seed: int = 0,
                 verbose: bool = False, generator: Optional[torch.Generator] = None,
                 device: Optional[str] = None):
    """Fit the scorer on (n, PAIR_DIM) candidate pairs with binary link
    labels: full-batch Adam (lr ``learning_rate``, betas (0.9, 0.999), eps
    1e-8, no weight decay) on the mean sigmoid cross-entropy, the
    normalization ``mu`` / ``sigma`` fit from ``pairs`` and frozen. The
    initial weights come from ``generator`` (default: seeded with ``seed``).
    Runs on ``device`` (None: the GPU). Returns the params in the npz layout."""
    from .models.build_sam import resolve_device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params = init_linker_params(generator, hidden)
    params["mu"] = pairs.mean(axis=0).astype("float32")
    params["sigma"] = (pairs.std(axis=0) + 1e-6).astype("float32")
    scorer = scorer_from_params(params, dev).train()

    x = torch.as_tensor(np.asarray(pairs, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    opt = torch.optim.Adam(scorer.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    with torch.enable_grad():
        for it in range(n_steps):
            opt.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(scorer(x), y)
            loss.backward()
            opt.step()
            if verbose and it % 100 == 0:
                print(f"linker step {it}: loss {float(loss):.4f}")
    return params_from_scorer(scorer)


def save_linker(path: str, params) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_linker(path: str):
    data = np.load(path)
    return {k: data[k] for k in data.files}


# -----------------------------------------------------------------------------
# Synthetic training data (moving objects with divisions)
# -----------------------------------------------------------------------------

def synthetic_tracking_sequence(n_frames=8, shape=(128, 128), n_objects=5,
                                division_prob=0.05, seed=0):
    """A labeled timeseries of drifting disks with occasional divisions.
    Returns (images, segs, gt_links): gt_links[t] maps frame-t+1 object id ->
    parent id in frame t."""
    rng = np.random.RandomState(seed)
    h, w = shape
    objs = []  # (id, y, x, r, vy, vx, intensity)
    next_id = 1
    for _ in range(n_objects):
        objs.append([next_id, rng.uniform(20, h - 20), rng.uniform(20, w - 20),
                     rng.uniform(5, 10), rng.uniform(-3, 3), rng.uniform(-3, 3),
                     rng.uniform(0.4, 1.0)])
        next_id += 1

    yy, xx = np.mgrid[0:h, 0:w]
    images = np.zeros((n_frames, h, w), dtype="float32")
    segs = np.zeros((n_frames, h, w), dtype="uint32")
    gt_links: List[Dict[int, int]] = []

    for t in range(n_frames):
        frame_links: Dict[int, int] = {}
        new_objs = []
        for obj in objs:
            oid, y, x, r, vy, vx, inten = obj
            mask = (yy - y) ** 2 + (xx - x) ** 2 <= r ** 2
            segs[t][mask] = oid
            images[t][mask] = inten
            # advance
            ny, nx = y + vy + rng.normal(0, 0.7), x + vx + rng.normal(0, 0.7)
            ny = np.clip(ny, 10, h - 10)
            nx = np.clip(nx, 10, w - 10)
            if rng.rand() < division_prob and r > 6:
                for dy, dx in ((-r, 0), (r, 0)):
                    child = [next_id, np.clip(ny + dy, 10, h - 10),
                             np.clip(nx + dx, 10, w - 10), r * 0.7,
                             vy + rng.normal(0, 1), vx + rng.normal(0, 1), inten]
                    frame_links[next_id] = oid
                    next_id += 1
                    new_objs.append(child)
            else:
                child = [next_id, ny, nx, r, vy, vx, inten]
                frame_links[next_id] = oid
                next_id += 1
                new_objs.append(child)
        objs = new_objs
        gt_links.append(frame_links)

    images += rng.normal(0, 0.03, images.shape).astype("float32")
    return images, segs, gt_links[:-1]


def build_training_pairs(images, segs, gt_links):
    """(pairs, labels) over all consecutive frames of a synthetic sequence."""
    all_pairs, all_labels = [], []
    for t in range(len(segs) - 1):
        ids0, f0, b0 = extract_frame_features(segs[t], images[t])
        ids1, f1, b1 = extract_frame_features(segs[t + 1], images[t + 1])
        if len(ids0) == 0 or len(ids1) == 0:
            continue
        pf = pair_features(f0, f1, b0, b1).reshape(-1, PAIR_DIM)
        links = gt_links[t]
        lab = np.array(
            [[1.0 if links.get(int(j)) == int(i) else 0.0 for j in ids1]
             for i in ids0], dtype="float32").reshape(-1)
        all_pairs.append(pf)
        all_labels.append(lab)
    return np.concatenate(all_pairs), np.concatenate(all_labels)


def train_default_linker(n_sequences: int = 6, seed: int = 0, n_steps: int = 600,
                         verbose: bool = False, device: Optional[str] = None):
    """Train the scorer on generated synthetic motion data (the shipped
    fallback when no user-trained weights are given), on ``device``."""
    pairs, labels = [], []
    for s in range(n_sequences):
        images, segs, links = synthetic_tracking_sequence(
            seed=seed + s, n_objects=4 + s % 3, division_prob=0.08)
        p, l = build_training_pairs(images, segs, links)
        pairs.append(p)
        labels.append(l)
    return train_linker(np.concatenate(pairs), np.concatenate(labels),
                        n_steps=n_steps, verbose=verbose, device=device)


# -----------------------------------------------------------------------------
# Tracker
# -----------------------------------------------------------------------------

class LearnedTracker:
    """Frame-to-frame tracker with a learned association scorer.

    API mirrors the Trackastra surface used by micro_sam
    (``.track(timeseries, segmentation)``), returning the same
    (node_to_track, parent_graph) contract as the native greedy linker so it
    drops into ``track_across_frames``. The scorer runs on ``device`` (None:
    the GPU; raises without one).
    """

    def __init__(self, params, link_threshold: float = 0.0,
                 division_threshold: float = 1.0, device: Optional[str] = None):
        from .models.build_sam import resolve_device
        self.params = params
        self.device = resolve_device(device)
        self.scorer = scorer_from_params(params, self.device)
        self.link_threshold = link_threshold        # logit threshold for links
        self.division_threshold = division_threshold  # stricter bar for 2nd child
        #: linking confidence of the last ``link`` call: (mean sigmoid score
        #: of accepted links) x (fraction of objects after frame 0 that got
        #: linked at all). The second factor is the discriminative
        #: out-of-regime signal — a scorer facing motion it never saw keeps
        #: HIGH scores on the links it does accept but fails to link a
        #: growing fraction of objects (measured: unmatched 7%% at training
        #: drift, 26-46%% at drift 10-16 where greedy overtakes it). None
        #: before any call / when no links were attempted.
        self.last_confidence: Optional[float] = None

    @classmethod
    def from_pretrained(cls, path_or_name: str = "default", device: Optional[str] = None,
                        **kwargs):
        if os.path.exists(str(path_or_name)):
            return cls(load_linker(str(path_or_name)), device=device, **kwargs)
        if path_or_name in ("default", "learned", "general_2d"):
            # packaged weights (trained on HeLa-like deformable-cell
            # sequences); training from scratch is the fallback if the
            # asset is missing
            if os.path.exists(_PACKAGED_WEIGHTS):
                return cls(load_linker(_PACKAGED_WEIGHTS), device=device, **kwargs)
            return cls(train_default_linker(device=device), device=device, **kwargs)
        raise ValueError(f"Unknown pretrained linker: {path_or_name}")

    def score_frames(self, seg0, seg1, img0=None, img1=None,
                     features0=None, features1=None):
        """(ids0, ids1, logits (n0, n1)) for one frame transition.

        features0/features1: optional precomputed (ids, feats, bboxes)
        triples — ``link`` passes the previous frame's triple forward so each
        frame is featurized exactly once."""
        ids0, f0, b0 = features0 if features0 is not None \
            else extract_frame_features(seg0, img0)
        ids1, f1, b1 = features1 if features1 is not None \
            else extract_frame_features(seg1, img1)
        if len(ids0) == 0 or len(ids1) == 0:
            return ids0, ids1, np.zeros((len(ids0), len(ids1)), "float32")
        pf = pair_features(f0, f1, b0, b1)
        with torch.no_grad():
            logits = self.scorer(torch.from_numpy(pf).to(self.device)).cpu().numpy()
        return ids0, ids1, logits

    def link(self, segmentation: np.ndarray,
             timeseries: Optional[np.ndarray] = None,
             ) -> Tuple[Dict[Tuple[int, int], int], Dict[int, int]]:
        """Assign track ids over a labeled timeseries.

        Returns (node_to_track {(frame, object_id): track_id},
        parent_graph {child_track: parent_track})."""
        from scipy.optimize import linear_sum_assignment

        n_frames = segmentation.shape[0]
        node_to_track: Dict[Tuple[int, int], int] = {}
        parent_graph: Dict[int, int] = {}
        next_track = 1
        accepted_scores: List[float] = []
        n_linkable = 0   # objects in frames > 0 (they could have a parent)
        n_linked = 0

        prev_tracks: Dict[int, int] = {}
        prev_features = None
        for t in range(n_frames):
            img_curr = None if timeseries is None else timeseries[t]
            curr_features = extract_frame_features(segmentation[t], img_curr)
            if t == 0:
                ids = curr_features[0]
                logits = np.zeros((0, len(ids)), "float32")
                prev = np.zeros(0, "int64")
            else:
                prev, ids, logits = self.score_frames(
                    segmentation[t - 1], segmentation[t],
                    features0=prev_features, features1=curr_features)
            prev_features = curr_features

            assigned: Dict[int, int] = {}
            if logits.size:
                # maximize total link score over one-to-one assignments
                rows, cols = linear_sum_assignment(-logits)
                # children per parent: 1 = continued track, 2 = division
                children: Dict[int, int] = {}
                for r, c in zip(rows, cols):
                    if logits[r, c] > self.link_threshold:
                        assigned[int(ids[c])] = int(prev[r])
                        children[int(prev[r])] = 1
                        accepted_scores.append(
                            1.0 / (1.0 + float(np.exp(-logits[r, c]))))
                # second children: unmatched current objects may join an
                # already-linked parent above the (stricter) division bar;
                # a parent takes at most TWO children (binary divisions, as
                # in the greedy linker)
                for c, oid in enumerate(ids):
                    if int(oid) in assigned:
                        continue
                    if logits.shape[0] == 0:
                        continue
                    r = int(np.argmax(logits[:, c]))
                    parent = int(prev[r])
                    if logits[r, c] > self.division_threshold \
                            and children.get(parent, 0) == 1:
                        assigned[int(oid)] = -parent  # division marker
                        children[parent] = 2

            if t > 0:
                n_linkable += len(ids)
                n_linked += len(assigned)
            curr_tracks: Dict[int, int] = {}
            for oid in ids:
                oid = int(oid)
                parent = assigned.get(oid)
                if parent is None:
                    track = next_track
                    next_track += 1
                elif parent < 0:  # division: new track with recorded parent
                    track = next_track
                    next_track += 1
                    parent_graph[track] = prev_tracks[-parent]
                else:
                    track = prev_tracks[parent]
                node_to_track[(t, oid)] = track
                curr_tracks[oid] = track
            prev_tracks = curr_tracks

        self.last_confidence = (
            float(np.mean(accepted_scores)) * (n_linked / n_linkable)
            if accepted_scores and n_linkable else None)
        return node_to_track, parent_graph

    def track(self, timeseries, segmentation, mode: str = "greedy"):
        """Trackastra-style entry: relabel the segmentation by track id.

        Returns (tracked_segmentation, parent_graph)."""
        node_to_track, parent_graph = self.link(segmentation, timeseries)
        return recolor_by_tracks(segmentation, node_to_track), parent_graph

    #: below this mean accepted-link score the scorer is extrapolating and
    #: the greedy overlap linker is the safer choice (see evaluate_regimes)
    MIN_CONFIDENCE = 0.75

    def link_auto(self, segmentation, timeseries=None,
                  min_confidence: Optional[float] = None):
        """Pick the better linker for the sequence's motion regime, then run it.

        Two-stage selection (doc/tracking_robustness.md):
        1. ``choose_linker`` reads cheap geometric signals (overlap viability,
           estimated drift, churn) off the segmentation and picks the linker
           that WINS in that regime — greedy when frame-to-frame overlap is
           reliable (slow or heavy drift on large objects), learned where its
           feature model earns its keep (churn/occlusions in-regime, or
           overlap-free small fast objects).
        2. If the learned linker is chosen, its ``last_confidence`` still
           gates a greedy fallback (the safety net for inputs the signals
           misjudge).

        Returns (node_to_track, parent_graph, chosen_linker_str).
        """
        choice, _signals = choose_linker(segmentation)
        if choice == "greedy":
            n2t, pg = greedy_node_to_track(segmentation)
            return n2t, pg, "greedy"
        min_confidence = self.MIN_CONFIDENCE if min_confidence is None \
            else min_confidence
        n2t, pg = self.link(segmentation, timeseries)
        if (self.last_confidence is not None
                and self.last_confidence < min_confidence):
            n2t, pg = greedy_node_to_track(segmentation)
            return n2t, pg, "greedy"
        return n2t, pg, "learned"

    def track_with_fallback(self, timeseries, segmentation,
                            min_confidence: Optional[float] = None):
        """``track`` with regime-aware linker selection (``link_auto``).

        Returns (tracked_segmentation, parent_graph, used_greedy)."""
        node_to_track, parent_graph, choice = self.link_auto(
            segmentation, timeseries, min_confidence)
        return (recolor_by_tracks(segmentation, node_to_track), parent_graph,
                choice == "greedy")


def estimate_linking_signals(segs: np.ndarray, max_transitions: int = 8
                             ) -> Dict[str, float]:
    """Cheap geometric statistics of a labeled timeseries that predict which
    linker wins (no ground truth needed; pure numpy, one pass per transition).

    - ``overlap_frac``: fraction of frame-t+1 objects sharing ANY pixels with
      a frame-t object. Low = frame-to-frame overlap linking is inviable
      (small/fast objects), the learned feature model's win regime.
    - ``drift_px``: median centroid displacement of best-overlap pairs.
      Beyond the learned scorer's training drift (~3 px/frame) its division
      decisions degrade before greedy's do.
    - ``churn_frac``: fraction of t+1 objects with no overlap candidate
      (births/reappearances) among sequences where overlap is otherwise
      viable — the regime where the learned scorer beats greedy's
      force-nothing geometry.
    - ``median_radius_px``: equivalent-circle radius, for context.
    """
    n = segs.shape[0]
    take = range(max(n - 1, 0)) if n - 1 <= max_transitions else \
        np.linspace(0, n - 2, max_transitions).astype(int)
    disps: List[float] = []
    n_next, n_overlapped = 0, 0
    radii: List[float] = []
    for t in take:
        a, b = segs[t], segs[t + 1]
        ids_b, counts_b = np.unique(b[b > 0], return_counts=True)
        if len(ids_b) == 0:
            continue
        radii += list(np.sqrt(counts_b / np.pi))
        n_next += len(ids_b)
        both = (a > 0) & (b > 0)
        if not both.any():
            continue
        pairs = a[both].astype(np.int64) * (int(b.max()) + 1) + b[both]
        pair_ids, pair_counts = np.unique(pairs, return_counts=True)
        pa = pair_ids // (int(b.max()) + 1)
        pb = pair_ids % (int(b.max()) + 1)
        # best-overlap parent per t+1 object
        order = np.argsort(pair_counts)
        best: Dict[int, int] = {}
        for i in order:  # ascending: the last write per child is the max
            best[int(pb[i])] = int(pa[i])
        n_overlapped += len(best)
        # centroids of the involved objects only
        ys, xs = np.nonzero(a > 0)
        va = a[ys, xs]
        cy_a = {int(i): ys[va == i].mean() for i in np.unique(pa)}
        cx_a = {int(i): xs[va == i].mean() for i in np.unique(pa)}
        ys, xs = np.nonzero(b > 0)
        vb = b[ys, xs]
        for child, parent in best.items():
            sel = vb == child
            dy = ys[sel].mean() - cy_a[parent]
            dx = xs[sel].mean() - cx_a[parent]
            disps.append(float(np.hypot(dy, dx)))
    overlap_frac = n_overlapped / max(n_next, 1)
    return {
        "overlap_frac": overlap_frac,
        "drift_px": float(np.median(disps)) if disps else float("inf"),
        "churn_frac": 1.0 - overlap_frac,
        "median_radius_px": float(np.median(radii)) if radii else 0.0,
    }


#: selection thresholds, calibrated on TRACKING_REGIMES
#: (development/calibrate_tracker_choice.py; see doc/tracking_robustness.md)
OVERLAP_VIABLE = 0.60    # below: overlap linking inviable -> learned
SMALL_OBJECT_RADIUS = 10.0  # px; smaller objects' division children barely
#                             overlap their parent -> learned
DRIFT_OUT_OF_REGIME = 4.5  # px/frame beyond the scorer's training drift -> greedy
STABLE_SCENE_CHURN = 0.02  # below, with slow drift: pure geometry wins -> greedy
STABLE_SCENE_DRIFT = 2.5


def choose_linker(segs: np.ndarray) -> Tuple[str, Dict[str, float]]:
    """Regime-aware linker selection from ``estimate_linking_signals``.

    Decision (calibrated against the adversarial regimes, where each rule's
    winner is measured — see the table in doc/tracking_robustness.md):
    overlap inviable OR small objects -> learned (a division child of a
    ~6 px-radius object shares few/no pixels with its parent, so greedy's
    overlap geometry cannot attach it; the feature scorer is size-agnostic);
    drift beyond the scorer's training regime -> greedy; a stable low-churn
    slow scene -> greedy (overlap geometry is near-perfect there, incl.
    divisions); otherwise (in-regime churn / occlusions / dense touching) ->
    learned.
    """
    s = estimate_linking_signals(segs)
    if s["overlap_frac"] < OVERLAP_VIABLE:
        return "learned", s
    if s["median_radius_px"] < SMALL_OBJECT_RADIUS:
        return "learned", s
    if s["drift_px"] >= DRIFT_OUT_OF_REGIME:
        return "greedy", s
    if s["churn_frac"] <= STABLE_SCENE_CHURN \
            and s["drift_px"] <= STABLE_SCENE_DRIFT:
        return "greedy", s
    return "learned", s


def recolor_by_tracks(segmentation: np.ndarray,
                      node_to_track: Dict[Tuple[int, int], int]) -> np.ndarray:
    """Relabel a per-frame segmentation by track id using a
    {(frame, object_id): track_id} mapping."""
    by_frame: Dict[int, Dict[int, int]] = {}
    for (t, oid), track in node_to_track.items():
        by_frame.setdefault(t, {})[oid] = track
    out = np.zeros_like(segmentation, dtype="uint32")
    for t in range(segmentation.shape[0]):
        frame = segmentation[t]
        lut = np.zeros(int(frame.max()) + 1, dtype="uint32")
        for oid, track in by_frame.get(t, {}).items():
            lut[oid] = track
        out[t] = lut[frame]
    return out


# -----------------------------------------------------------------------------
# HeLa-like synthetic sequences + tracker evaluation (the CTC DIC-C2DH-HeLa
# stand-in: the environment has no cached CTC data, so training/evaluation
# run on deformation-augmented sequences that mimic its statistics — large
# touching cells, irregular boundaries, slow drift, binary divisions)
# -----------------------------------------------------------------------------

def hela_like_tracking_sequence(n_frames=10, shape=(256, 256), n_cells=6,
                                division_prob=0.04, seed=0, drift_scale=1.0,
                                occlusion_prob=0.0, occlusion_len=2,
                                birth_prob=0.0, death_prob=0.0,
                                return_events=False):
    """Labeled timeseries of large deformable cells (DIC-C2DH-HeLa-like).

    Each cell is a star-convex region whose radius varies over angle through
    low-order Fourier coefficients that evolve smoothly frame to frame
    (elastic deformation); cells drift slowly, touch (contested pixels go to
    the nearest center) and occasionally divide along a random axis.
    Returns (images, segs, gt_links) in the same contract as
    synthetic_tracking_sequence.

    Adversarial regimes (see the failure-mode table in ``evaluate_regimes``):
    - occlusion_prob/occlusion_len: a visible cell disappears for
      ``occlusion_len`` frames and reappears WITH A NEW ID and no gt link —
      frame-to-frame linkers (this one and the greedy/Trackastra contract)
      cannot bridge gaps, so correct behavior is "start a new track", and a
      link of the reappearance to any live cell is a false positive.
    - birth_prob: spontaneous new cells (no parent) test that unmatched
      detections are not force-linked to existing tracks.
    - death_prob: permanent disappearances test that orphaned tracks are not
      re-attached to other cells.
    With return_events=True additionally returns an events dict
    {"occlusions": [(t_hidden, t_visible_again, new_id)], "births":
    [(t, id)], "deaths": [(t, id)]}.
    """
    rng = np.random.RandomState(seed)
    h, w = shape
    n_modes = 4

    def new_cell(cid, y, x, r):
        return {
            "id": cid, "y": y, "x": x, "r": r,
            "vy": drift_scale * rng.uniform(-1.5, 1.5),
            "vx": drift_scale * rng.uniform(-1.5, 1.5),
            "amp": rng.uniform(0.04, 0.16, n_modes),
            "phase": rng.uniform(0, 2 * np.pi, n_modes),
            "dphase": rng.normal(0, 0.25, n_modes),
            "tex": rng.uniform(0.35, 0.9),
        }

    cells = []
    next_id = 1
    margin = 40
    for _ in range(n_cells):
        cells.append(new_cell(next_id, rng.uniform(margin, h - margin),
                              rng.uniform(margin, w - margin),
                              rng.uniform(18, 30)))
        next_id += 1

    yy, xx = np.mgrid[0:h, 0:w]
    images = np.zeros((n_frames, h, w), dtype="float32")
    segs = np.zeros((n_frames, h, w), dtype="uint32")
    gt_links: List[Dict[int, int]] = []

    events = {"occlusions": [], "births": [], "deaths": []}
    for t in range(n_frames):
        # rasterize: each cell claims pixels inside its angular radius
        # profile; overlaps go to the cell with the larger interior margin
        claim = np.full((h, w), -np.inf, dtype="float64")
        frame_seg = np.zeros((h, w), dtype="uint32")
        for cell in cells:
            if cell.get("hidden", 0) > 0:
                continue
            dy, dx = yy - cell["y"], xx - cell["x"]
            dist = np.sqrt(dy ** 2 + dx ** 2)
            theta = np.arctan2(dy, dx)
            radius = cell["r"] * (1.0 + sum(
                a * np.cos((k + 2) * theta + p)
                for k, (a, p) in enumerate(zip(cell["amp"], cell["phase"]))
            ))
            inside = radius - dist        # >0 inside, larger = deeper
            sel = (inside > 0) & (inside > claim)
            claim[sel] = inside[sel]
            frame_seg[sel] = cell["id"]
            # DIC-ish texture: bright rim, darker interior gradient
            images[t][sel] = cell["tex"] * (0.55 + 0.45 * np.clip(
                1.0 - inside[sel] / max(cell["r"], 1), 0, 1))
        segs[t] = frame_seg

        # evolve
        frame_links: Dict[int, int] = {}
        evolved = []
        for cell in cells:
            jitter = 0.8 * drift_scale
            ny = float(np.clip(cell["y"] + cell["vy"] + rng.normal(0, jitter),
                               margin / 2, h - margin / 2))
            nx = float(np.clip(cell["x"] + cell["vx"] + rng.normal(0, jitter),
                               margin / 2, w - margin / 2))
            was_hidden = cell.get("hidden", 0) > 0
            if not was_hidden and death_prob and rng.rand() < death_prob:
                events["deaths"].append((t, cell["id"]))
                continue
            if was_hidden or (occlusion_prob and rng.rand() < occlusion_prob):
                nxt = dict(cell)
                nxt["y"], nxt["x"] = ny, nx
                if not was_hidden:
                    nxt["hidden"] = occlusion_len + 1  # hides starting next frame
                nxt["hidden"] -= 1
                if nxt["hidden"] == 0:
                    # reappearance: new id, NO link (gap not bridgeable
                    # frame-to-frame; linking it anywhere is a false positive)
                    nxt["id"] = next_id
                    events["occlusions"].append((t + 1, next_id))
                    next_id += 1
                evolved.append(nxt)
                continue
            if rng.rand() < division_prob and cell["r"] > 16:
                axis = rng.uniform(0, 2 * np.pi)
                off = cell["r"] * 0.6
                for sign in (-1, 1):
                    child = new_cell(
                        next_id,
                        float(np.clip(ny + sign * off * np.sin(axis), 10, h - 10)),
                        float(np.clip(nx + sign * off * np.cos(axis), 10, w - 10)),
                        cell["r"] * 0.72,
                    )
                    frame_links[next_id] = cell["id"]
                    next_id += 1
                    evolved.append(child)
            else:
                nxt = dict(cell)
                nxt["id"] = next_id
                nxt["y"], nxt["x"] = ny, nx
                nxt["phase"] = cell["phase"] + cell["dphase"]
                nxt["amp"] = np.clip(
                    cell["amp"] + rng.normal(0, 0.01, n_modes), 0.0, 0.2)
                nxt["r"] = float(np.clip(cell["r"] * rng.uniform(0.97, 1.03), 12, 36))
                frame_links[next_id] = cell["id"]
                next_id += 1
                evolved.append(nxt)
        if birth_prob and rng.rand() < birth_prob:
            cell = new_cell(next_id, rng.uniform(margin, h - margin),
                            rng.uniform(margin, w - margin),
                            rng.uniform(18, 30))
            events["births"].append((t + 1, next_id))
            next_id += 1
            evolved.append(cell)   # no gt link: spontaneous appearance
        cells = evolved
        gt_links.append(frame_links)

    images += rng.normal(0, 0.04, images.shape).astype("float32")
    if return_events:
        return images, segs, gt_links[:-1], events
    return images, segs, gt_links[:-1]


def evaluate_tracking(segs, gt_links, node_to_track, parent_graph):
    """Link/division scores of a tracking result against ground-truth links.

    node_to_track: {(frame, object_id): track_id}. A gt link (parent p@t ->
    child c@t+1) counts as recovered when both objects exist in the result and
    either share a track id (continuation) or the child's track descends from
    the parent's (division). Returns dict with link precision/recall/f1 and
    division recall/precision/f1.
    """
    # predicted continuation links: same track in consecutive frames
    predicted = set()
    by_frame: Dict[int, Dict[int, int]] = {}
    first_frame: Dict[int, int] = {}
    for (t, oid), track in node_to_track.items():
        by_frame.setdefault(t, {})[int(oid)] = int(track)
        first_frame[int(track)] = min(first_frame.get(int(track), t), t)
    n_frames = max(by_frame) + 1 if by_frame else 0
    for t in range(n_frames - 1):
        tracks_next = {trk: oid for oid, trk in by_frame.get(t + 1, {}).items()}
        for oid, trk in by_frame.get(t, {}).items():
            child = tracks_next.get(trk)
            if child is not None:
                predicted.add((t, oid, child))
            # division links count only at the frame the child track STARTS
            for child_trk, parent_trk in parent_graph.items():
                if (parent_trk == trk and child_trk in tracks_next
                        and first_frame.get(child_trk) == t + 1):
                    predicted.add((t, oid, tracks_next[child_trk]))

    actual = set()
    division_parents = set()
    for t, links in enumerate(gt_links):
        counts: Dict[int, int] = {}
        for child, parent in links.items():
            actual.add((t, int(parent), int(child)))
            counts[parent] = counts.get(parent, 0) + 1
        division_parents.update(
            (t, p) for p, n in counts.items() if n > 1)

    tp = len(predicted & actual)
    link_precision = tp / max(len(predicted), 1)
    link_recall = tp / max(len(actual), 1)
    link_f1 = 2 * link_precision * link_recall / max(
        link_precision + link_recall, 1e-9)

    # divisions: a gt division is recovered if BOTH child links are present
    div_tp = 0
    for (t, parent) in division_parents:
        children = [c for (tt, p, c) in actual if tt == t and p == parent]
        if all((t, parent, c) in predicted for c in children):
            div_tp += 1
    # predicted divisions = parents with 2 predicted children
    pred_parents: Dict[Tuple[int, int], int] = {}
    for (t, p, c) in predicted:
        pred_parents[(t, p)] = pred_parents.get((t, p), 0) + 1
    n_pred_div = sum(1 for n in pred_parents.values() if n > 1)
    div_recall = div_tp / max(len(division_parents), 1)
    div_precision = div_tp / max(n_pred_div, 1)
    div_f1 = 2 * div_precision * div_recall / max(
        div_precision + div_recall, 1e-9)
    return {
        "link_precision": link_precision, "link_recall": link_recall,
        "link_f1": link_f1, "n_links": len(actual),
        "division_recall": div_recall, "division_precision": div_precision,
        "division_f1": div_f1, "n_divisions": len(division_parents),
    }


def greedy_node_to_track(segs):
    """Run the greedy overlap linker and convert its per-object mapping into
    the {(frame, object_id): track} contract (ids are globally unique in the
    synthetic sequences, so the flat map lifts directly)."""
    from .multi_dimensional_segmentation import _greedy_link_tracks
    flat, parent_graph = _greedy_link_tracks(segs)
    node_to_track = {}
    for t in range(segs.shape[0]):
        for oid in np.unique(segs[t]):
            if oid != 0 and int(oid) in flat:
                node_to_track[(t, int(oid))] = flat[int(oid)]
    return node_to_track, parent_graph


_PACKAGED_WEIGHTS = os.path.join(
    os.path.dirname(__file__), "assets", "learned_tracker.npz")


#: the adversarial validation regimes: name -> generator kwargs
TRACKING_REGIMES = {
    "slow_drift": dict(drift_scale=1.0, division_prob=0.05),
    "fast_drift": dict(drift_scale=6.0, division_prob=0.05),
    "occlusion_gap2": dict(drift_scale=2.0, occlusion_prob=0.08,
                           occlusion_len=2, division_prob=0.03),
    "birth_death_churn": dict(drift_scale=2.0, birth_prob=0.5,
                              death_prob=0.06, division_prob=0.03),
    "dense_touching": dict(drift_scale=3.0, n_cells=10, division_prob=0.05),
}


def evaluate_regimes(n_seeds: int = 4, n_frames: int = 12,
                     regimes: Optional[Dict] = None, verbose: bool = False,
                     device: Optional[str] = None):
    """Adversarial tracker validation: learned vs greedy vs auto-fallback
    across the TRACKING_REGIMES. For occlusion regimes additionally reports
    ``false_bridge`` — the fraction of reappearing (post-gap) objects whose
    track existed before the gap ended, i.e. wrongly linked across or to a
    neighbor (gap bridging is OUT of contract for every frame-to-frame
    linker here; correct behavior is a fresh track).

    Returns {regime: {linker: {metric: value}}} averaged over seeds. The
    scorer runs on ``device`` (None: the GPU).
    """
    regimes = TRACKING_REGIMES if regimes is None else regimes
    tracker = LearnedTracker.from_pretrained("default", device=device)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, kwargs in regimes.items():
        per_linker: Dict[str, List[Dict[str, float]]] = {
            "learned": [], "greedy": [], "auto": []}
        fallbacks = 0
        for s in range(n_seeds):
            images, segs, links, events = hela_like_tracking_sequence(
                n_frames=n_frames, seed=1000 + s, return_events=True, **kwargs)

            def false_bridge(n2t):
                reapp = events["occlusions"] + events["births"]
                if not reapp:
                    return 0.0
                bad = 0
                seen_before = {}
                for (t, oid), trk in n2t.items():
                    seen_before.setdefault(trk, t)
                for (t, oid) in reapp:
                    trk = n2t.get((t, int(oid)))
                    if trk is not None and seen_before.get(trk, t) < t:
                        bad += 1
                return bad / len(reapp)

            n2t_l, pg_l = tracker.link(segs, images)
            conf = tracker.last_confidence
            n2t_g, pg_g = greedy_node_to_track(segs)
            n2t_a, pg_a, auto_choice = tracker.link_auto(segs, images)
            fallbacks += int(auto_choice == "greedy")
            for linker, (n2t, pg) in (("learned", (n2t_l, pg_l)),
                                      ("greedy", (n2t_g, pg_g)),
                                      ("auto", (n2t_a, pg_a))):
                m = evaluate_tracking(segs, links, n2t, pg)
                m["false_bridge"] = false_bridge(n2t)
                if linker == "learned":
                    m["confidence"] = conf if conf is not None else 1.0
                per_linker[linker].append(m)
        out[name] = {
            linker: {k: round(float(np.mean([r[k] for r in runs])), 3)
                     for k in runs[0]}
            for linker, runs in per_linker.items()
        }
        out[name]["auto"]["fallback_rate"] = round(fallbacks / n_seeds, 2)
        if verbose:
            print(name, out[name])
    return out


def train_hela_like_linker(n_sequences: int = 8, seed: int = 0,
                           n_steps: int = 800, verbose: bool = False,
                           device: Optional[str] = None):
    """Train the association scorer on HeLa-like deformable-cell sequences
    (fills the role of Trackastra's pretrained 'general_2d'), on ``device``."""
    pairs, labels = [], []
    for s in range(n_sequences):
        # mixed motion regimes: slow deformation through fast drift, plus
        # small fast disks — the regime where overlap-based linking fails
        images, segs, links = hela_like_tracking_sequence(
            seed=seed + s, n_cells=4 + s % 4, division_prob=0.05,
            drift_scale=(1.0, 2.0, 4.0, 6.0)[s % 4])
        p, l = build_training_pairs(images, segs, links)
        pairs.append(p)
        labels.append(l)
        images, segs, links = synthetic_tracking_sequence(
            seed=seed + 100 + s, n_objects=4 + s % 3, division_prob=0.06)
        p, l = build_training_pairs(images, segs, links)
        pairs.append(p)
        labels.append(l)
    return train_linker(np.concatenate(pairs), np.concatenate(labels),
                        n_steps=n_steps, verbose=verbose, device=device)
