"""Trackastra's branch of track_across_frames (``_trackastra_impl``), taken
where the ``trackastra`` package is importable. Trackastra is installed
neither here nor on the GPU machine, so a stub package stands in for it in
``sys.modules``: ``model.Trackastra`` (``from_pretrained``, ``track``) and
``tracking.graph_to_ctc`` / ``graph_to_napari_tracks``. The test holds the
port's side of the call: the branch is taken instead of the greedy linker,
the stub's tracks recolor the segmentation, its parent links become the
lineages, and both packages give the same result on the same stub."""
import sys
import types

import numpy as np
import pytest


def _sequence():
    """3 frames of 32 x 32: object 1 moves, divides into 3 and 4 at t=2;
    object 2 is alone; object 5 appears at t=2 and no track lands on it."""
    seg = np.zeros((3, 32, 32), np.uint32)
    seg[0, 2:8, 2:8] = 1
    seg[1, 3:9, 3:9] = 1
    seg[2, 2:6, 2:6] = 3
    seg[2, 7:11, 7:11] = 4
    for t in range(3):
        seg[t, 20:26, 20:26] = 2
    seg[2, 28:31, 2:5] = 5
    return seg


def _stub_trackastra(calls):
    """A stub trackastra: the graph is a token; napari's track data are
    (track_id, t, y, x) rows at object centers, daughter tracks 7 and 8 of
    track 6 (object 1), track 9 for object 2."""
    class Trackastra:
        @classmethod
        def from_pretrained(cls, name, device=None):
            calls.append(("from_pretrained", name, device))
            return cls()

        def track(self, timeseries, segmentation, mode=None):
            calls.append(("track", timeseries.shape, segmentation.shape, mode))
            return "graph", segmentation

    def graph_to_napari_tracks(graph):
        calls.append(("graph_to_napari_tracks", graph))
        rows = [(6, 0, 5, 5), (6, 1, 6, 6), (7, 2, 4, 4), (8, 2, 9, 9),
                (9, 0, 23, 23), (9, 1, 23, 23), (9, 2, 23, 23)]
        return np.array(rows, np.float64), {7: 6, 8: 6}, {}

    def graph_to_ctc(graph, segmentation, outdir=None):
        calls.append(("graph_to_ctc", graph, outdir))

    pkg = types.ModuleType("trackastra")
    model = types.ModuleType("trackastra.model")
    tracking = types.ModuleType("trackastra.tracking")
    model.Trackastra = Trackastra
    tracking.graph_to_ctc = graph_to_ctc
    tracking.graph_to_napari_tracks = graph_to_napari_tracks
    pkg.model, pkg.tracking = model, tracking
    return {"trackastra": pkg, "trackastra.model": model, "trackastra.tracking": tracking}


@pytest.fixture
def stub(monkeypatch):
    calls = []
    for name, mod in _stub_trackastra(calls).items():
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def test_track_across_frames_takes_trackastra(stub, monkeypatch, tmp_path):
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds

    def no_greedy(*a, **k):
        raise AssertionError("the greedy linker ran though trackastra is importable")
    monkeypatch.setattr(mds, "_greedy_link_tracks", no_greedy)
    seg = _sequence()
    frames = np.zeros(seg.shape, np.uint8)
    result, lineages = mds.track_across_frames(frames, seg, verbose=False,
                                               output_folder=str(tmp_path))
    assert stub == [("from_pretrained", "general_2d", "cpu"),
                    ("track", seg.shape, seg.shape, "greedy"),
                    ("graph_to_napari_tracks", "graph"),
                    ("graph_to_ctc", "graph", str(tmp_path))]
    expect = np.zeros_like(seg)
    for obj, track in ((1, 6), (3, 7), (4, 8), (2, 9)):
        expect[seg == obj] = track
    assert np.array_equal(result, expect)          # object 5 had no track point: background
    assert lineages == [{6: [7, 8], 7: [], 8: []}, {9: []}]


def test_trackastra_branch_matches_jax(stub):
    from micro_sam_tpu import multi_dimensional_segmentation as jmds
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds
    seg = _sequence()
    frames = np.zeros(seg.shape, np.uint8)
    got = mds.track_across_frames(frames, seg, verbose=False)
    ref = jmds.track_across_frames(frames, seg, verbose=False)
    assert np.array_equal(got[0], ref[0]) and got[1] == ref[1]


def test_trackastra_empty_result_warns(stub, monkeypatch):
    from micro_sam_tpu_torch import multi_dimensional_segmentation as mds
    empty = lambda graph: (np.zeros((0, 4)), {}, {})  # noqa: E731
    monkeypatch.setattr(sys.modules["trackastra.tracking"], "graph_to_napari_tracks", empty)
    seg = _sequence()
    with pytest.warns(UserWarning, match="empty"):
        result, lineages = mds.track_across_frames(np.zeros(seg.shape, np.uint8), seg,
                                                   verbose=False)
    assert not result.any() and lineages == []
