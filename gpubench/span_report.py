"""Where a cell's traced window went, by the port's own spans.

    python3 gpubench/span_report.py --workload <cell> --seed <n> [--seconds 10]

from the root of a checkout, on the card. Makes one traced run of the cell
as ``run.py --trace 1`` does and prints its result line, then one JSON line
(``harness/spans.summary``): for each span of the port, how many ran in the
window, their seconds, their self seconds (less their children's), their
summed counts and the card's idle seconds under them; the idle seconds under
each harness stage where no span ran; the window's idle seconds, which those
parts add up to; and the window's images a second under the profiler (beside
``run.py --trace 0``'s, the cost of tracing).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

import run  # noqa: E402
from harness import card, spans, spec  # noqa: E402


def main(argv=None) -> int:
    t_process = card.process_start_epoch()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=run.TRACE_SECONDS)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    card.require_cards(cell.chips)
    torch.cuda.set_device(0)
    kept = []
    traced = run.traced

    def keep(window, stages):  # the window's counts and Trace, which the result line lacks
        win, trace = traced(window, stages)
        kept.append((win, trace))
        return win, trace

    run.traced = keep
    result = run.run_cell(cell, args.seed, args.seconds, True, torch.device("cuda", 0), t_process)
    print(json.dumps(result), flush=True)
    win, trace = kept[-1]
    rate = win["images"] / win["seconds"] if "images" in win else None
    print(json.dumps({"cell": cell.name, "seed": args.seed, "images_per_s": rate,
                      **spans.summary(trace)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
