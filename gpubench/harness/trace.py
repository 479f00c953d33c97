"""The traced window: device activity from the profiler, the host's stages,
and the kernel calls the program makes.

``traced`` runs a window under ``torch.profiler`` with CUDA activities only
(CPU activities slow the host down and would inflate its share), keeps the
events in memory (no trace file) and clips them to the window between two
marker kernels (``torch.cuda._sleep``). A profiler session can lose the
launches of its first milliseconds, so the window starts only after a
pre-roll of markers. The host's clock is tied to the device's at the start
marker, launched on an idle card, so each idle gap can be named by the host
stage (``StageLog``) that was running at its middle. A session whose
buffers overflow drops its latest events, the end marker with them; such a
window is reported lost (``TraceLost``) and not read.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
PREROLL = 3
TOP = 10


class TraceLost(RuntimeError):
    """The profiler kept not all of the window's events."""


class StageLog:
    """Host stages of a window: (name, start ns, end ns) on ``perf_counter_ns``,
    one after another (they do not nest). Off, ``stage`` costs one attribute
    test."""

    def __init__(self, on: bool = False):
        self.on = on
        self.entries: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.entries.append((name, t0, time.perf_counter_ns()))


def _shape_of(fn_name: str, a: tuple, kw: dict) -> Optional[tuple]:
    """The shapes ``work.call_ms`` reads, from one call's arguments."""
    x = a[0]
    s = x.element_size()
    if fn_name == "gemm":
        epilogue = a[3] if len(a) > 3 else kw.get("epilogue", "none")
        residual = a[4] if len(a) > 4 else kw.get("residual")
        return ("gemm", x.shape[0], x.shape[1], a[1].shape[0], s,
                residual is not None or epilogue.startswith("residual"))
    if fn_name == "relpos_attention":
        B, nH, N, hd = x.shape
        H, W = a[5]
        return ("relpos_attention", B, nH, N, hd, H, W, s)
    if fn_name == "layernorm":
        masked = len(a) > 4 and a[4] is not None
        return ("layernorm", x.shape[0], x.shape[1], s, masked)
    return None


class KernelCalls:
    """Records the shapes of every kernel call the ViT block chains make, by
    wrapping the kernel table of ``micro_sam_tpu_torch.ops.fused_window_block``
    (the lookup its chain functions make at each call); each call still
    launches its kernel as before. Only shapes are kept, no tensor."""

    MODULE = "micro_sam_tpu_torch.ops.fused_window_block"

    def __init__(self):
        self.calls: List[tuple] = []

    def __enter__(self):
        self.module = importlib.import_module(self.MODULE)
        self.saved = self.module._KERNELS

        def wrap(fn):
            def call(*a, **kw):
                shape = _shape_of(fn.__name__, a, kw)
                if shape is not None:
                    self.calls.append(shape)
                return fn(*a, **kw)
            return call
        self.module._KERNELS = tuple(wrap(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        self.module._KERNELS = self.saved

    def of(self, name: str) -> List[tuple]:
        return [c for c in self.calls if c[0] == name]


@dataclass
class Trace:
    """Device operations (name, start ns, end ns) inside the window, on the
    profiler's clock; ``offset_ns`` maps ``perf_counter_ns`` onto it."""
    ops: List[Tuple[str, int, int]]
    start_ns: int
    end_ns: int
    offset_ns: int
    stages: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ms(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(device ms, count) of the operations whose name ``match`` accepts."""
        picked = [e - s for n, s, e in self.ops if match(n)]
        return sum(picked) / 1e6, len(picked)

    def top_ops(self) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e in self.ops:
            by[n] += e - s
        return [[n[:200], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """Idle device time, summed by the host stage running at each gap's
        middle (``harness`` where no stage was)."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [t for iv in busy for t in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        stages = sorted(self.stages, key=lambda s: s[1])
        starts = [t0 for _, t0, _ in stages]
        by: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2 - self.offset_ns
            i = bisect.bisect_right(starts, mid) - 1
            name = stages[i][0] if i >= 0 and stages[i][2] >= mid else "harness"
            by[name] += e - s
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _events(prof):
    """The profiler's raw events, without building its Python event tree."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        return [(e.name(), e.start_ns(), e.end_ns(), e.device_type())
                for e in results.events()]
    return [(e.name, e.time_range.start * 1000, e.time_range.end * 1000, e.device_type)
            for e in prof.events()]


def traced(window: Callable[[], object], stages: StageLog):
    """Run ``window()`` under the profiler; returns (its result, Trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL):  # pre-roll: launches lost at a session's start
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        t_mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)  # start marker, on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        result = window()
        torch.cuda.synchronize()
        host_ns = time.perf_counter_ns() - t0
        torch.cuda._sleep(1000)  # end marker
        torch.cuda.synchronize()
    dev = [(n, s, e) for n, s, e, d in _events(prof) if d == DeviceType.CUDA]
    marks = sorted((s, e) for n, s, e in dev if MARKER in n)
    if len(marks) < 2 or marks[-1][0] - marks[-2][1] < 0.9 * host_ns:
        raise TraceLost(f"the profiler kept {len(marks)} of {PREROLL + 2} markers and "
                        f"{len(dev)} device events; the window's end is lost")
    (m0s, m0e), (m1s, _) = marks[-2], marks[-1]
    ops = [(n, max(s, m0e), min(e, m1s)) for n, s, e in dev
           if MARKER not in n and e > m0e and s < m1s]
    return result, Trace(ops=ops, start_ns=m0e, end_ns=m1s, offset_ns=m0s - t_mark,
                         stages=list(stages.entries))
