"""The port's own spans in a traced window, and the window's idle device
time split exactly among them.

The port (``micro_sam_tpu_torch.tracing``) records a span at each layer
boundary of its embedding path while a profiler session runs, on
``perf_counter_ns``: the clock of the harness's ``StageLog``, which
``Trace.offset_ns`` maps onto the profiler's device clock. ``in_window``
keeps the spans that overlap the traced window, clipped to it (the spans of
a lost attempt lie before it). ``idle_split`` cuts every idle gap of the
card at each span and stage boundary inside it and puts each piece under the
innermost port span over it, else under the harness stage over it, else
under ``harness``; no gap is named by its middle alone, so the parts add up
to the window's idle time. A port without the tracing module records no
span: every reader here then returns None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from . import port  # noqa: F401  (puts the checkout, and so the port, on the path)

HARNESS = ("harness", "harness")


def port_spans() -> list:
    """Every span the port has recorded in this process (none from a port
    that has no tracing module)."""
    try:
        from micro_sam_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def in_window(trace, spans: Optional[Iterable] = None) -> List[tuple]:
    """(span, start, end) of each port span overlapping the window, its
    start and end on the device clock and clipped to the window."""
    spans = port_spans() if spans is None else spans
    out = []
    for s in spans:
        a, b = s.start_ns + trace.offset_ns, s.end_ns + trace.offset_ns
        if b > trace.start_ns and a < trace.end_ns:
            out.append((s, max(a, trace.start_ns), min(b, trace.end_ns)))
    return out


Label = Tuple[str, str]  # ("span", port span name), ("stage", harness stage name), HARNESS


def _segments(trace, window_spans: List[tuple]) -> List[Tuple[int, int, Label]]:
    """(start, end, label) pieces covering the window in order: the innermost
    port span over each (the latest started), else the harness stage, else
    ``HARNESS``."""
    items = [(a, b, 1, (s.start_ns, s.id), ("span", s.name)) for s, a, b in window_spans if b > a]
    for name, t0, t1 in trace.stages:
        a = max(t0 + trace.offset_ns, trace.start_ns)
        b = min(t1 + trace.offset_ns, trace.end_ns)
        if b > a:
            items.append((a, b, 0, (t0, 0), ("stage", name)))
    items.sort(key=lambda it: it[0])
    points = sorted({trace.start_ns, trace.end_ns} | {t for it in items for t in it[:2]})
    out: List[Tuple[int, int, Label]] = []
    active: list = []
    nxt = 0
    for p, q in zip(points, points[1:]):
        active = [it for it in active if it[1] > p]
        while nxt < len(items) and items[nxt][0] <= p:
            if items[nxt][1] > p:
                active.append(items[nxt])
            nxt += 1
        name = max(active, key=lambda it: (it[2], it[3]))[4] if active else HARNESS
        if out and out[-1][2] == name and out[-1][1] == p:
            out[-1] = (out[-1][0], q, name)
        else:
            out.append((p, q, name))
    return out


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The window's idle intervals on the device clock, as ``Trace.idle_gaps``
    finds them."""
    busy = trace.busy_intervals()
    edges = [trace.start_ns] + [t for iv in busy for t in iv] + [trace.end_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_split(trace, window_spans: List[tuple]) -> Dict[Label, int]:
    """Idle device ns of the window under each label: a port span's name, a
    harness stage's, or ``HARNESS`` (see the module's docstring). The values
    add up to the window's idle time."""
    segs = _segments(trace, window_spans)
    by: Dict[Label, int] = defaultdict(int)
    if not segs:
        return {}
    j = 0
    for s, e in idle_gaps(trace):
        while segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b, label = segs[k]
            by[label] += min(b, e) - max(a, s)
            k += 1
        j = max(j, k - 1)
    return dict(by)


def self_times(window_spans: List[tuple]) -> Dict[str, dict]:
    """By span name: how many, their seconds in the window, their self
    seconds (each span's less the part its children cover) and their
    summed counts."""
    child_ns: Dict[int, int] = defaultdict(int)
    for s, a, b in window_spans:
        if s.parent is not None:
            child_ns[s.parent] += b - a
    by: Dict[str, dict] = {}
    for s, a, b in window_spans:
        row = by.setdefault(s.name, {"n": 0, "s": 0.0, "self_s": 0.0, "counts": defaultdict(int)})
        row["n"] += 1
        row["s"] += (b - a) / 1e9
        row["self_s"] += (b - a - child_ns[s.id]) / 1e9
        for k, v in s.counts.items():
            row["counts"][k] += v
    for row in by.values():
        row["counts"] = dict(row["counts"])
    return by


def idle_share_under(run: dict, names: Tuple[str, ...]) -> Optional[float]:
    """Idle device time under the port spans ``names`` over the traced
    window, in %; None when the window holds no such span."""
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    spans = in_window(trace)
    if not any(s.name in names for s, _, _ in spans):
        return None
    split = idle_split(trace, spans)
    return 100.0 * sum(split.get(("span", n), 0) for n in names) / (trace.end_ns - trace.start_ns)


def rate_gbps(run: dict, name: str, count: str = "bytes") -> Optional[float]:
    """The summed ``count`` of the port spans ``name`` that overlap the
    window over their summed (whole) seconds, in GB/s (1e9 a second); None
    without such a span."""
    trace = run.get("trace")
    if trace is None:
        return None
    picked = [s for s, _, _ in in_window(trace) if s.name == name]
    ns = sum(s.end_ns - s.start_ns for s in picked)
    if not picked or ns <= 0:
        return None
    return sum(s.counts.get(count, 0) for s in picked) / ns  # bytes a ns are GB/s


def summary(trace, spans: Optional[Iterable] = None) -> dict:
    """A traced window by the port's spans: for each span name its
    ``self_times`` row and the idle seconds under it (``idle_s``); the idle
    seconds under each harness stage where no span ran (``outside_spans``);
    the window's seconds and its idle seconds, which those parts add up to."""
    window_spans = in_window(trace, spans)
    split = idle_split(trace, window_spans)
    rows = self_times(window_spans)
    for name, row in rows.items():
        row["idle_s"] = split.get(("span", name), 0) / 1e9
    return {"window_s": trace.window_s, "idle_s": trace.window_s - trace.busy_s, "spans": rows,
            "outside_spans": {n: t / 1e9 for (kind, n), t in split.items() if kind != "span"}}
