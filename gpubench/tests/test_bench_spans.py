"""The port's spans in a traced window (``harness/spans.py``): each idle gap
split exactly at span and stage boundaries, the parts adding up to the idle
share, and the span metrics' readers, None where the port records no span."""
import glob
import os

import pytest

import benchtiny
from harness import readers, spans
from harness.trace import Trace
from micro_sam_tpu_torch.tracing import Span

METRICS = ("embed.cast_idle_share", "embed.copy_in_gbps", "precompute.normalize_idle_share",
           "precompute.store_idle_share")


def _trace():
    # device = host + 10; busy 100-200 and 600-700 of a 0-1000 window
    return Trace(ops=[("k", 100, 200), ("k", 600, 700)], start_ns=0, end_ns=1000, offset_ns=10,
                 stages=[("slice_prep", -10, 290), ("encode_batch", 290, 990)])


def _port_spans():
    # host clock: encode_batch 300-700 holding cast 300-400 and copy_in 400-500;
    # one span of an earlier (lost) attempt, before the window
    return [Span(1, None, 1, "encode_batch.cast", -900, -800, {"bytes": 7}),
            Span(3, 2, 2, "encode_batch.cast", 300, 400, {"bytes": 4000}),
            Span(4, 2, 2, "encode_batch.copy_in", 400, 500, {"bytes": 1000}),
            Span(2, None, 2, "encode_batch", 300, 700, {"images": 8})]


@pytest.fixture()
def run(monkeypatch):
    monkeypatch.setattr(spans, "port_spans", _port_spans)
    return {"trace": _trace(), "window": {"seconds": 1e-6, "images": 8}}


def _reader(name):
    return benchtiny.run.load_file(benchtiny.spec.metric_file(name), f"test_{name}")


def test_a_gap_over_two_stages_is_split_at_their_boundary():
    trace = _trace()
    split = spans.idle_split(trace, spans.in_window(trace, _port_spans()))
    # gaps 0-100, 200-600, 700-1000; the stages on the device: slice_prep 0-300,
    # encode_batch 300-1000; the spans: cast 310-410, copy_in 410-510, encode_batch 310-710
    assert split == {("stage", "slice_prep"): 200, ("stage", "encode_batch"): 300,
                     ("span", "encode_batch.cast"): 100, ("span", "encode_batch.copy_in"): 100,
                     ("span", "encode_batch"): 100}
    # the middle of the 200-600 gap lies in encode_batch: the whole gap went there
    assert dict(map(tuple, trace.idle_gaps())) == {"encode_batch": 7e-7, "slice_prep": 1e-7}


def test_the_parts_add_up_to_the_idle_share(run):
    trace = run["trace"]
    split = spans.idle_split(trace, spans.in_window(trace))
    window_ns = trace.end_ns - trace.start_ns
    assert abs(100.0 * sum(split.values()) / window_ns - readers.idle_share(run)) < 1e-9
    summary = spans.summary(trace)
    parts = sum(r["idle_s"] for r in summary["spans"].values()) + \
        sum(summary["outside_spans"].values())
    assert abs(parts - summary["idle_s"]) < 1e-15


def test_where_no_span_or_stage_ran_the_gap_is_the_harness():
    trace = Trace(ops=[("k", 400, 500)], start_ns=0, end_ns=1000, offset_ns=0,
                  stages=[("x", 100, 300)])
    assert spans.idle_split(trace, []) == {spans.HARNESS: 700, ("stage", "x"): 200}


def test_self_times_and_counts(run):
    rows = spans.summary(run["trace"])["spans"]
    assert rows["encode_batch"]["n"] == 1 and rows["encode_batch"]["counts"] == {"images": 8}
    assert rows["encode_batch"]["s"] == pytest.approx(4e-7)
    assert rows["encode_batch"]["self_s"] == pytest.approx(2e-7)
    assert rows["encode_batch.cast"]["n"] == 1  # the lost attempt's span is left out
    assert rows["encode_batch.cast"]["idle_s"] == pytest.approx(1e-7)


def test_the_readers(run):
    assert _reader("embed.cast_idle_share").read(run) == pytest.approx(10.0)
    assert _reader("embed.copy_in_gbps").read(run) == pytest.approx(10.0)  # 1000 B in 100 ns
    assert _reader("precompute.normalize_idle_share").read(run) is None
    assert _reader("precompute.store_idle_share").read(run) is None


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_finds_nothing_without_spans(monkeypatch, name):
    monkeypatch.setattr(spans, "port_spans", lambda: [])
    assert _reader(name).read({"trace": _trace(), "window": {}}) is None
    assert _reader(name).read({"trace": None, "window": {}}) is None


def test_every_span_metric_reads_the_spans_helper():
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    found = {os.path.basename(f)[:-3] for f in glob.glob(os.path.join(bench, "metrics", "*.py"))
             if "harness.spans" in open(f).read()}
    assert found == set(METRICS)
