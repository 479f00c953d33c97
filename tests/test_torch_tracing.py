"""The port's spans (``micro_sam_tpu_torch.tracing``) on the CPU: off without a
profiler session, and under one the spans of ``encode_batch``, the copy out
and a 3d precompute with their parents, roots and byte counts."""
import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from micro_sam_tpu_torch import tracing, util
from micro_sam_tpu_torch.models.sam import Sam, SamConfig
from micro_sam_tpu_torch.predictor import SamPredictor
from tests.torch_port_util import one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores (ROADMAP.md, Budgets)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def predictor():
    cfg = SamConfig(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=(1,), img_size=128)
    return SamPredictor(Sam(cfg).init_(torch.Generator().manual_seed(3)).eval())


def _new_since(before):
    last = max((s.id for s in before), default=0)  # a root ends last, with the least id
    return [s for s in tracing.spans() if s.id > last]


def _traced(fn):
    """fn() under a CPU profiler session; (its result, the spans it recorded)."""
    before = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, _new_since(before)


def _batch(n, side=128, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def test_without_a_profiler_nothing_is_recorded(predictor):
    before = tracing.spans()
    assert tracing.span("encode_batch", images=1) is tracing._OFF
    with tracing.span("x") as s:
        s.count(bytes=1)
    util._features_to_cache_layout(predictor.encode_batch(_batch(2)))
    assert _new_since(before) == []


def test_encode_batch_and_copy_out_spans(predictor):
    batch = _batch(2)
    feats, spans = _traced(lambda: [util._features_to_cache_layout(predictor.encode_batch(batch))
                                    for _ in range(2)])
    assert [s.name for s in spans] == ["encode_batch.cast", "encode_batch.copy_in",
                                       "encode_batch.launch", "encode_batch", "copy_out"] * 2
    roots = [s for s in spans if s.name == "encode_batch"]
    assert len({r.root for r in roots}) == 2
    for root in roots:
        assert root.parent is None and root.root == root.id and root.counts == {"images": 2}
        children = [s for s in spans if s.parent == root.id]
        assert [s.name for s in children] == ["encode_batch.cast", "encode_batch.copy_in",
                                              "encode_batch.launch"]
        assert all(s.root == root.id and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in children)
        made = np.asarray(batch, dtype=np.float32)
        assert children[0].counts == {"bytes": made.nbytes}
        assert children[1].counts == {"bytes": made.nbytes}
        assert children[2].counts == {}
    for out, s in zip(feats, [s for s in spans if s.name == "copy_out"]):
        assert s.parent is None and s.counts == {"bytes": out.nbytes}


def test_a_float32_batch_is_cast_without_bytes_made(predictor):
    batch = _batch(1).astype(np.float32)
    _, spans = _traced(lambda: predictor.encode_batch(batch))
    cast = next(s for s in spans if s.name == "encode_batch.cast")
    assert cast.counts == {"bytes": 0}


def test_set_image_is_a_root_of_one_image(predictor):
    _, spans = _traced(lambda: predictor.set_image(_batch(1, side=100)[0]))
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["encode_batch"] and roots[0].counts == {"images": 1}
    assert {s.root for s in spans} == {roots[0].id}


def test_precompute_3d_spans(predictor):
    volume = np.random.default_rng(1).integers(0, 4096, (3, 128, 128)).astype(np.uint16)
    emb, spans = _traced(lambda: util.precompute_image_embeddings(
        predictor, volume, save_path=None, ndim=3, batch_size=2, verbose=False))
    root = spans[-1]
    assert root.name == "precompute" and root.parent is None and root.counts == {"slices": 3}
    assert {s.root for s in spans} == {root.id}
    under_root = [s.name for s in spans if s.parent == root.id]
    assert under_root == ["precompute.signature"] + ["precompute.to_image", "precompute.resize"] * 2 \
        + ["encode_batch", "copy_out", "precompute.store", "precompute.to_image",
           "precompute.resize", "encode_batch", "copy_out", "precompute.store"]
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    assert by["precompute.signature"][0].counts == {"bytes": volume.nbytes}
    slice_bytes = emb["features"][0, 0].nbytes
    assert [s.counts["bytes"] for s in by["precompute.store"]] == [2 * slice_bytes, slice_bytes]
    assert [s.counts["bytes"] for s in by["copy_out"]] == [2 * slice_bytes, slice_bytes]
    # at the model's side the resize is a float32 conversion: encode_batch casts nothing
    assert [s.counts["bytes"] for s in by["encode_batch.cast"]] == [0, 0]


def test_spans_show_in_the_profile(predictor):
    batch = _batch(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor.encode_batch(batch)
    names = {e.key for e in prof.key_averages()}
    assert {"encode_batch", "encode_batch.cast", "encode_batch.copy_in",
            "encode_batch.launch"} <= names


def test_each_thread_has_its_own_parents():
    seen = {}

    def other():
        with tracing.span("other") as s:
            seen["other"] = s.parent

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer") as outer:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
            with tracing.span("inner") as inner:
                pass
    assert not t.is_alive()
    assert seen["other"] is None and inner.parent == outer.id and inner.root == outer.id


def test_the_store_is_bounded(monkeypatch):
    assert tracing._SPANS.maxlen == tracing.CAPACITY == 2 ** 20
    monkeypatch.setattr(tracing, "_SPANS", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span(f"s{i}", i=i):
                pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
