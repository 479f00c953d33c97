"""Run one cell of the benchmark of ``micro_sam_tpu_torch`` on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix, and the mix its driver
(``gpubench/drivers/<driver>.py``), which makes the inputs and weights from
the seed, builds the port and warms up every shape the window uses (all of
it set-up), then drives the window for ``--seconds``. After the window the
program is freed and the plain reference checks a seeded sample of the
window's answers. With ``--trace 0`` the result line holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under the profiler
and the line holds its per-layer metrics (``gpubench/metrics/<name>.py``),
the device's busy and window seconds and a breakdown. The numbers compared
are printed, each beside its limit, as the last lines on standard error
and under the result line's last key, ``checks``. Without the cards the cell
asks for, the run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

from harness import card, spec  # noqa: E402
from harness.trace import KernelCalls, StageLog, TraceLost, traced  # noqa: E402

# The traced window (``--trace 1``) is at most this long: a profiler session
# over 20 s of batch-1 vit_h encodes (some 200,000 kernels and copies) once
# lost every event after its start, its buffers full; 10 s halves the events.
# A window that lost events (its end, or kernels the launch counters counted)
# is run again, up to TRACE_ATTEMPTS windows.
TRACE_SECONDS = 10.0
TRACE_ATTEMPTS = 3


class Context:
    """What a driver is handed: the cell, the seed, the card and the stage log."""

    def __init__(self, cell: spec.Cell, seed: int, device, stages: StageLog):
        self.cell, self.seed, self.device, self.stages = cell, seed, device, stages
        self.marks = [("start", time.time())]

    def mark(self, name: str) -> None:
        """Note the end of a set-up phase (printed on standard error)."""
        self.marks.append((name, time.time()))


def load_file(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = module  # dataclasses look their module up there
    mod_spec.loader.exec_module(module)
    return module


def per_layer(cell: spec.Cell, run: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something for."""
    out = {}
    for i, m in enumerate(cell.per_layer):
        reader = load_file(spec.metric_file(m["name"], cell.root), f"gpubench_metric_{i}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device,
             t_process: float) -> dict:
    """Set-up, window and check of one run; the result line as a dict. Takes
    the card it is given (the tests drive it on the CPU at a small size)."""
    stages = StageLog(on=trace_on)
    ctx = Context(cell, seed, device, stages)
    driver = load_file(spec.driver_file(cell.driver, cell.root), "gpubench_driver")
    state = driver.setup(ctx)
    sync(device)
    setup_s = time.time() - t_process
    stages.entries.clear()
    from harness import port
    if trace_on:
        seconds = min(seconds, TRACE_SECONDS)
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            launches0 = port.launch_counts()
            stages.entries.clear()
            try:
                with KernelCalls() as calls:
                    win, trace = traced(lambda: driver.window(state, seconds), stages)
                launches = {k: v - launches0[k] for k, v in port.launch_counts().items()}
                run = {"cell": cell, "window": win, "trace": trace, "calls": calls,
                       "launches": launches}
                metrics = per_layer(cell, run)
                break
            except TraceLost as lost:
                print(f"gpubench: traced window {attempt} lost: {lost}", file=sys.stderr)
                if attempt == TRACE_ATTEMPTS:
                    raise
    else:
        trace = None
        launches0 = port.launch_counts()
        win = driver.window(state, seconds)
        sync(device)
        launches = {k: v - launches0[k] for k, v in port.launch_counts().items()}
        e2e = {**driver.end_to_end(state, win), "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    device_line = card.device_line(cell.chips, memory_peak) if device.type == "cuda" else \
        {"platform": device.type, "count": 0, "memory_peak_bytes": 0}
    if trace is not None:
        device_line.update(busy_s=trace.busy_s, window_s=trace.window_s)

    t_check = time.perf_counter()
    driver.release(state)
    numbers = driver.compared(state, win)
    ctx.mark("check")
    t_check = time.perf_counter() - t_check
    checks = {k: {"value": float(v), "limit": cell.limits[k]} for k, v in numbers.items()}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": int(win["attempted"]), "failed": int(win["failed"]),
              "metrics": metrics, "device": device_line}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    phases = ", ".join(f"{n} {t1 - t0:.3f}" for (_, t0), (n, t1) in zip(ctx.marks, ctx.marks[1:]))
    print(f"gpubench: {cell.name} seed {seed} set-up s: imports {ctx.marks[0][1] - t_process:.3f}, "
          f"{phases}; kernel build {port.build_seconds():.3f} s; launches in the window "
          f"{launches}; the check {t_check:.3f} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    t_process = card.process_start_epoch()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    card.require_cards(cell.chips)
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t_process)
    found = card.forbidden_modules()
    if found:
        print(f"gpubench: the run holds {found}, which it may not import; no result",
              file=sys.stderr)
        return 3
    print(f"gpubench: power limit {card.power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
