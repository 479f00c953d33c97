"""A headless stand-in for the napari viewer (the port's copy of
``micro_sam_tpu/_test_util.py``): ``FakeViewer`` implements the duck type the
annotators use (layers, dims, ``add_*``, ``bind_key``) and ``press`` fires a
key binding, so the annotator stack runs without a display, in the CPU tests
and on the card alike."""
from __future__ import annotations

import numpy as np


class FakeLayer:
    """Duck-typed napari layer (Image / Labels / Points / Shapes)."""

    def __init__(self, data, name="", properties=None, property_choices=None,
                 shape_type=None, scale=None):
        self.data = data
        self.name = name
        self.properties = {} if properties is None else properties
        self.property_choices = {} if property_choices is None else property_choices
        self.shape_type = [] if shape_type is None else shape_type
        self.scale = scale
        self.refreshed = 0

    def refresh(self):
        self.refreshed += 1

    def refresh_colors(self):
        pass

    def world_to_data(self, position):
        return position

    def bind_key(self, key, overwrite=False):
        def deco(fn):
            return fn
        return deco


class _LayerList:
    def __init__(self):
        self._layers = {}

    def __contains__(self, name):
        return name in self._layers

    def __getitem__(self, name):
        return self._layers[name]

    def __len__(self):
        return len(self._layers)

    def __iter__(self):
        return iter(self._layers.values())

    def get(self, name, default=None):
        return self._layers.get(name, default)

    def add(self, layer):
        self._layers[layer.name] = layer


class _Dims:
    def __init__(self):
        self.point = (0,)
        self.current_step = (0,)


class FakeViewer:
    """Headless ``napari.Viewer`` stand-in (layers, dims, add_*, bind_key)."""

    def __init__(self):
        self.layers = _LayerList()
        self.dims = _Dims()
        self._keybindings = {}

    def add_image(self, data, name="image", **kwargs):
        layer = FakeLayer(np.asarray(data), name=name)
        self.layers.add(layer)
        return layer

    def add_labels(self, data, name="labels", **kwargs):
        layer = FakeLayer(np.asarray(data), name=name)
        self.layers.add(layer)
        return layer

    def add_points(self, data=None, name="points", properties=None,
                   property_choices=None, ndim=2, **kwargs):
        layer = FakeLayer(
            np.zeros((0, ndim)) if data is None else np.asarray(data), name=name,
            properties={"label": np.zeros(0, dtype=object)} if properties is None else properties,
            property_choices=property_choices,
        )
        self.layers.add(layer)
        return layer

    def add_shapes(self, data=None, name="shapes", ndim=2, **kwargs):
        layer = FakeLayer([] if data is None else data, name=name, shape_type=[])
        self.layers.add(layer)
        return layer

    def bind_key(self, key, overwrite=False):
        def deco(fn):
            self._keybindings[key] = fn
            return fn
        return deco

    def press(self, key):
        """Fire a key binding."""
        self._keybindings[key](self)


def check_layer_initialization(viewer, expected_shape):
    """The annotator's layer contract on a viewer: the image and every
    annotator layer present, the three label layers of ``expected_shape``."""
    from .sam_annotator._annotator import ANNOTATOR_LAYERS

    assert len(viewer.layers) >= 6
    expected_layer_names = ("image",) + ANNOTATOR_LAYERS
    for name in expected_layer_names:
        assert name in viewer.layers

    for layer_name in ("current_object", "auto_segmentation", "committed_objects"):
        assert viewer.layers[layer_name].data.shape == expected_shape
