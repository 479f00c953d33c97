"""The benchmark's files: ``BENCHMARK.json`` against the contract's shapes, every
configuration, traffic, cell and metric file, and a cell found by name alone."""
import json
import math
import os
import re
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from harness import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_KEYS = ("_dim", "_rank")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.endswith("_torch")
    for word in b["command"][1:]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    rs = bench()["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    b = bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(WIDTH_KEYS) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        others = [n for n, m in e2e.items() if n != "setup_s" and cell in m.get("workloads", cells)]
        layers = [m for m in b["per_layer"] if cell in m.get("workloads", cells)]
        assert others and layers, cell
    for m in b["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads", "metrics"])
def test_every_file_parses_and_is_named_by_a_name(kind):
    folder = os.path.join(BENCH, kind)
    files = sorted(os.listdir(folder))
    assert files
    for f in files:
        stem, ext = os.path.splitext(f)
        assert NAME.match(stem), f
        if ext == ".json":
            with open(os.path.join(folder, f)) as fh:
                json.load(fh)
        else:
            assert ext == ".py"
            compile(open(os.path.join(folder, f)).read(), f, "exec")


def test_configurations_state_their_source_and_cuts():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["encoder_embed_dim"] % cfg["encoder_num_heads"] == 0


def test_every_cell_loads_with_its_limits_and_metrics():
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
        assert os.path.exists(spec.driver_file(cell.driver))
        for m in cell.per_layer:
            assert os.path.exists(spec.metric_file(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A later cell, traffic mix and metric are new files and entries only."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, root / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "vit_h.embed_b4", "config": "sam_vit_h", "traffic": "embed_b4",
                           "chips": 1, "why": "a smaller batch"})
    b["per_layer"].append({"name": "embed.launches", "unit": "kernels", "better": "lower",
                           "source": "program_counter", "layer": "kernels",
                           "moves": "embed_images_per_s", "workloads": ["vit_h.embed_b4"]})
    for m in b["end_to_end"]:
        if m["name"] == "embed_images_per_s":
            m["workloads"].append("vit_h.embed_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((root / "gpubench/traffic/embed_b8.json").read_text())
    (root / "gpubench/traffic/embed_b4.json").write_text(json.dumps({**traffic, "batch": 4}))
    (root / "gpubench/workloads/vit_h.embed_b4.json").write_text(
        json.dumps({"limits": {"embed_rel_err": 0.05}}))
    (root / "gpubench/metrics/embed.launches.py").write_text("def read(run):\n    return 1\n")
    cell = spec.load_cell("vit_h.embed_b4", root=str(root))
    assert cell.traffic["batch"] == 4 and cell.driver == "embed_batch"
    assert cell.config["encoder_embed_dim"] == 1280
    assert [m["name"] for m in cell.per_layer] == ["embed.launches"]
    assert os.path.exists(spec.metric_file("embed.launches", str(root)))
    with pytest.raises(KeyError):
        spec.load_cell("vit_h.absent", root=str(root))
