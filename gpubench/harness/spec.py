"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) is found by its name alone: its entry
names the configuration (``configs/<file>``) and the traffic mix
(``traffic/<traffic>.json``, which names its driver, ``drivers/<driver>.py``);
its own file, ``workloads/<cell>.json``, holds the limits of the numbers
its correctness check compares. A per-layer metric is ``metrics/<name>.py``.
So a later cell, configuration, traffic mix or metric is a set of new files
and new entries, and no file here changes.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a name (letters, digits, _ . -, at most 64)")
    return name


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    why: str
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: str = ROOT

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    bench_dir = os.path.join(root, "gpubench")
    traffic = read_json(os.path.join(bench_dir, "traffic", check_name(w["traffic"], "traffic")
                                     + ".json"))
    check_name(traffic["driver"], "driver")
    own = read_json(os.path.join(bench_dir, "workloads", check_name(name, "cell") + ".json"))
    return Cell(name=name, config_name=conf["name"], config=read_json(os.path.join(root, conf["file"])),
                traffic_name=w["traffic"], traffic=traffic, chips=int(w["chips"]), why=w["why"],
                limits={k: float(v) for k, v in own["limits"].items()},
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def metric_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "gpubench", "metrics", check_name(name, "metric") + ".py")


def driver_file(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "gpubench", "drivers", check_name(name, "driver") + ".py")
