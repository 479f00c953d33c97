"""Spans at the layer boundaries of the port, recorded while a
``torch.profiler`` session runs.

``span(name, **counts)`` is a context manager. With no profiler session
running it tests one flag (``torch.autograd.profiler._is_profiler_enabled``,
which torch keeps for fast Python checks) and returns one shared object that
does nothing, so nothing is recorded. While a session runs, it records one
``Span``: its id, its parent's (the innermost span open on the same thread)
and its root's (the top-level span of the call: every span of one call
shares it), its name, its start and end on ``time.perf_counter_ns`` and its
integer counts (``bytes``, ``images``, ...; ``count`` sets those known only
inside the span). No setting or environment variable turns it on: a
profiler session does.

Each recorded span also opens a ``torch.profiler.record_function`` of its
name, so an operator's ordinary profile shows the spans beside the
operators and kernels they enqueue::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.encode_batch(batch)
    print(prof.key_averages().table(sort_by="cpu_time_total"))
    tracing.spans()  # the same spans with their ids and counts

The last ``CAPACITY`` spans are kept in memory (``spans()``); nothing is
written out. ``perf_counter_ns`` is the clock of the benchmark's host
stages, which it maps onto the profiler's device clock, so the benchmark's
readers (``gpubench/harness/spans.py``) put each idle gap of the card under
the span that was running.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 2 ** 20


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


_SPANS: Deque[Span] = collections.deque(maxlen=CAPACITY)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the spans open on this thread, innermost last


class _Off:
    """The span returned while no profiler session runs: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **counts: int) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def count(self, **counts: int) -> None:
        """Set counts known only inside the span."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _OPEN.stack.pop()
        _SPANS.append(Span(self.id, self.parent, self.root, self.name, self.start_ns, end_ns,
                           self.counts))
        return None


def span(name: str, **counts: int):
    """A span named ``name`` with integer ``counts``, recorded only while a
    profiler session runs (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, counts)


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``CAPACITY``)."""
    return list(_SPANS)
