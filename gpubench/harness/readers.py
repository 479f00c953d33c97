"""Arithmetic that several per-layer metrics share."""
from __future__ import annotations

from typing import Optional, Sequence

from .trace import TraceLost
from .work import PEAK_BF16, bound_ms, vit_encode_flops


def encoder_mfu(run: dict, images: int) -> Optional[float]:
    """The encoder's model operations in the window per second over the
    card's bf16 peak, in %."""
    win = run["window"]
    if not images or win["seconds"] <= 0:
        return None
    return 100.0 * vit_encode_flops(run["cell"].config) * images / win["seconds"] / PEAK_BF16


def idle_share(run: dict) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or set ran, in %."""
    trace = run["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def roofline(run: dict, kernel: str, names: Sequence[str]) -> Optional[float]:
    """The least time of the window's ``kernel`` calls (their recorded
    shapes at the peaks) over the device time of the kernels named
    ``names``, in %. A trace that holds fewer of those kernels than the
    port's launch counter counted has lost events: ``TraceLost``, and the
    window is run again."""
    calls = run["calls"].of(kernel)
    ms, found = run["trace"].device_ms(lambda n: any(k in n for k in names))
    if not calls or not found:
        return None
    launched = run["launches"].get(kernel, found)
    if launched > found:
        raise TraceLost(f"{kernel}: {found} kernels in the trace of {launched} launched")
    return 100.0 * bound_ms(calls) / ms
