"""The port's napari plugin manifest (micro_sam_tpu_torch/napari.yaml): the
JAX package's contributions, each ``python_name`` resolving to an object of
the port; widget contributions construct from a viewer alone (napari passes
nothing else), headless through the port's FakeViewer, and load no model."""
import importlib
import inspect
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).parent.parent
PORT_MANIFEST = ROOT / "micro_sam_tpu_torch" / "napari.yaml"
JAX_MANIFEST = ROOT / "micro_sam_tpu" / "napari.yaml"


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def manifest():
    return _load(PORT_MANIFEST)


def _resolve(python_name):
    module_name, attr = python_name.split(":")
    module = importlib.import_module(module_name)
    assert hasattr(module, attr), f"{module_name} has no attribute {attr}"
    return getattr(module, attr)


def test_manifest_structure(manifest):
    assert manifest["name"] == "micro-sam-tpu-torch"
    contrib = manifest["contributions"]
    command_ids = {c["id"] for c in contrib["commands"]}
    for section in ("widgets", "sample_data"):
        for entry in contrib[section]:
            assert entry["command"] in command_ids, entry
    for cid in command_ids:
        assert cid.startswith("micro-sam-tpu-torch."), cid


def test_manifest_mirrors_the_jax_manifest(manifest):
    """The same commands, titles, widgets and sample data, each command's
    python_name the JAX one's with the port's package."""
    ref = _load(JAX_MANIFEST)["contributions"]
    got = manifest["contributions"]

    def rename(text):
        return text.replace("micro-sam-tpu.", "micro-sam-tpu-torch.").replace(
            "micro_sam_tpu.", "micro_sam_tpu_torch.")

    for section in ("commands", "widgets", "sample_data"):
        assert got[section] == [{k: rename(v) for k, v in e.items()} for e in ref[section]]


def test_manifest_commands_resolve_to_port_objects(manifest):
    for command in manifest["contributions"]["commands"]:
        obj = _resolve(command["python_name"])
        assert callable(obj), command["id"]
        assert obj.__module__.startswith("micro_sam_tpu_torch."), (command["id"], obj.__module__)


def test_widget_contributions_construct_headless(manifest, monkeypatch):
    """Built from a viewer alone (or nothing); no model is loaded, so the
    widgets construct without a GPU."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch._test_util import FakeViewer
    from micro_sam_tpu_torch.sam_annotator._state import AnnotatorState

    def no_model(*args, **kwargs):
        raise AssertionError("a widget contribution loaded a model at construction")

    monkeypatch.setattr(util, "get_sam_model", no_model)
    contrib = manifest["contributions"]
    by_id = {c["id"]: c for c in contrib["commands"]}
    try:
        for entry in contrib["widgets"]:
            target = _resolve(by_id[entry["command"]]["python_name"])
            params = [p for p in inspect.signature(target).parameters.values()
                      if p.default is inspect.Parameter.empty
                      and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            names = [p.name for p in params if p.name != "self"]
            assert names in ([], ["viewer"]), (entry["command"], names)
            widget = target(FakeViewer()) if names == ["viewer"] else target()
            assert widget is not None
    finally:
        state = AnnotatorState()
        state.reset_state()
        state.widgets, state.annotator = {}, None


def test_sample_data_command_returns_layer_data(manifest):
    contrib = manifest["contributions"]
    by_id = {c["id"]: c for c in contrib["commands"]}
    entry = next(e for e in contrib["sample_data"] if e["key"] == "segmentation")
    layers = _resolve(by_id[entry["command"]]["python_name"])()
    assert isinstance(layers, list) and len(layers) >= 1
    data, meta = layers[0][0], layers[0][1]
    assert hasattr(data, "shape") and "name" in meta
