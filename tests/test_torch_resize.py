"""The port's resize (``utils/transforms.py::resize_uint8``, torch integer
arithmetic, no Pillow) against PIL's ``Image.resize(..., Image.BILINEAR)``
and against the JAX predictor's ``_resize_longest_host`` (which calls PIL).

Tolerance: none. Every pixel equals PIL's (maximum difference 0).
"""
from types import SimpleNamespace

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
from PIL import Image

from micro_sam_tpu_torch.utils.transforms import (ResizeLongestSide, get_preprocess_shape,
                                                  resize_uint8)

# (input shape, output (h, w)): down, up, non-square, one axis unchanged,
# odd sizes, strong reductions, 1 and 3 channels, grey (H, W)
CASES = [
    ((512, 512, 3), (1024, 1024)),
    ((2048, 2048, 3), (1024, 1024)),
    ((1536, 1536, 3), (1024, 1024)),
    ((700, 900, 3), (796, 1024)),
    ((1000, 1333, 3), (768, 1024)),
    ((300, 200, 3), (256, 171)),
    ((90, 70, 1), (256, 199)),
    ((37, 1000, 3), (37, 513)),
    ((999, 31, 1), (1024, 31)),
    ((5000, 123, 3), (1024, 25)),
    ((257, 129, 3), (131, 67)),
    ((63, 65), (128, 131)),
    ((1, 9, 3), (3, 17)),
]


def _pil(image: np.ndarray, hw) -> np.ndarray:
    """PIL's bilinear resize of each channel (one band at a time for grey)."""
    h, w = hw
    if image.ndim == 2:
        return np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR))
    if image.shape[-1] == 3:
        return np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR))
    return np.stack([_pil(image[..., c], hw) for c in range(image.shape[-1])], axis=-1)


@pytest.mark.parametrize("shape,hw", CASES, ids=[f"{s}->{hw}" for s, hw in CASES])
def test_resize_equals_pil_to_the_bit(shape, hw):
    image = np.random.RandomState(sum(shape)).randint(0, 256, size=shape).astype(np.uint8)
    got = resize_uint8(image, hw)
    ref = _pil(image, hw)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() == 0


def test_resize_of_smooth_image_equals_pil():
    """A smooth ramp (rounding ties are likelier than in noise) down and up."""
    yy, xx = np.mgrid[0:333, 0:517]
    image = np.stack([(yy * 255 // 332), (xx * 255 // 516), ((yy + xx) % 256)], -1).astype(np.uint8)
    for hw in ((199, 309), (660, 1024), (333, 1024)):
        assert np.abs(resize_uint8(image, hw) - _pil(image, hw)).max() == 0


@pytest.mark.parametrize("shape", [(300, 200, 3), (90, 70, 3), (1500, 1100, 3), (256, 100, 3)],
                         ids=["down", "up", "down_large", "one_axis_kept"])
def test_apply_image_equals_jax_predictor_resize(shape):
    """``ResizeLongestSide.apply_image`` against the JAX predictor's host
    resize to the longest side (``img_size`` 256), on the same images."""
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    image = np.random.RandomState(shape[0]).randint(0, 256, size=shape).astype(np.uint8)
    jax_like = SimpleNamespace(model=SimpleNamespace(config=SimpleNamespace(img_size=256)))
    ref = JaxPredictor._resize_longest_host(jax_like, image)
    got = ResizeLongestSide(256).apply_image(image)
    assert got.shape == ref.shape == get_preprocess_shape(*shape[:2], 256) + (3,)
    assert np.abs(got - ref).max() == 0
