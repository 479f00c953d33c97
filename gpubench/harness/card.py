"""The card, the process, and the modules a run may not hold."""
from __future__ import annotations

import os
import subprocess
import sys
from typing import List

import torch

# top-level module names, compared whole: the JAX package's name is a prefix
# of the port's, which is allowed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "micro_sam_tpu")


def forbidden_modules() -> List[str]:
    """The forbidden top-level packages that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, without ``n`` CUDA cards. There is
    no CPU fallback: every number of a run is a device number."""
    if not torch.cuda.is_available():
        sys.exit("gpubench: no CUDA card (torch.cuda.is_available() is false); no result")
    if torch.cuda.device_count() < n:
        sys.exit(f"gpubench: the cell needs {n} cards, {torch.cuda.device_count()} visible; "
                 "no result")


def process_start_epoch() -> float:
    """When this process started, in seconds since the epoch (from /proc:
    the boot time and the process's start in clock ticks)."""
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or ``unknown``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "unknown"


def device_line(count: int, memory_peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}
