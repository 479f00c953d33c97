"""Readings of a cell's correctness control on the card.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

For each seed, the numbers the cell's check compares, with the plain
reference computed one precision below the configuration's (fp8 products
for bfloat16) put in the program's place, at the cell's own size and on the
inputs its window would take first. The smallest of them over the seeds is
the upper reading of each number's limit (``PERF.md``, section 2). The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

from harness import card, spec  # noqa: E402
from run import Context, load_file  # noqa: E402
from harness.trace import StageLog  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    card.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    driver = load_file(spec.driver_file(cell.driver, cell.root), "gpubench_driver")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = driver.control(Context(cell, seed, device, StageLog()))
        print(json.dumps({"cell": cell.name, "seed": seed, "control": numbers,
                          "limits": cell.limits, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
