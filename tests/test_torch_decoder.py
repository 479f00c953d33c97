"""The port's prompt encoder + mask decoder against the JAX package's
``Sam.decode_masks`` and the golden fixture.

f32 on the CPU. Against JAX: rel <= 1e-4 of max|ref| for the mask logits,
abs <= 1e-4 for the IoU predictions (the JAX decoder folds the positional
encodings through the projections and block-diagonalizes cross attention,
exact rewrites that differ in rounding only). Golden (independent torch
oracle): rel < 1e-3 for the logits, abs < 1e-3 for the IoU, as
tests/test_golden.py holds the JAX package.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import abs_err, jax_params, port_sam, rel_err, tiny_jax_config


@pytest.fixture(scope="module")
def models():
    from micro_sam_tpu.models.sam import Sam as JaxSam
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    return JaxSam(cfg, params), port_sam(cfg, params)


CASES = {
    # name: (points, labels, with_mask, has_mask)
    "points": ([[[60., 90.], [150., 40.], [0., 0.]]], [[1, 0, -1]], False, None),
    "box": ([[[20., 30.], [200., 180.]]], [[2, 3]], False, None),
    "box+point": ([[[20., 30.], [200., 180.], [90., 90.]]], [[2, 3, 1]], False, None),
    "mask": ([[[60., 90.], [0., 0.]]], [[1, -1]], True, [True]),
    "mask_only": (np.zeros((1, 0, 2)), np.zeros((1, 0)), True, [True]),
    "has_mask_mixed": ([[[60., 90.], [0., 0.]], [[120., 30.], [0., 0.]]], [[1, -1], [0, -1]],
                       True, [True, False]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decoder_matches_jax(models, case):
    jsam, psam = models
    pts, lab, with_mask, has_mask = CASES[case]
    pts = np.asarray(pts, np.float32)
    lab = np.asarray(lab, np.int32)
    B = pts.shape[0]
    rng = np.random.RandomState(1)
    feats = rng.randn(1, 16, 16, 256).astype(np.float32)
    mask = (rng.randn(B, 64, 64, 1) * 3).astype(np.float32) if with_mask else None
    hm = None if has_mask is None else np.asarray(has_mask)
    jf = jnp.broadcast_to(jnp.asarray(feats), (B, 16, 16, 256))
    jm, ji = jsam.decode_masks(jsam.params, jf, jnp.asarray(pts), jnp.asarray(lab),
                               None if mask is None else jnp.asarray(mask),
                               None if hm is None else jnp.asarray(hm))
    t = torch.from_numpy
    pm, pi = psam.decode_masks(t(feats), t(pts), t(lab.astype(np.int64)),
                               None if mask is None else t(mask), None if hm is None else t(hm))
    assert rel_err(pm.numpy(), jm) <= 1e-4
    assert abs_err(pi.numpy(), ji) <= 1e-4


def test_golden_vit_b224_decoder():
    from tests.make_golden import build_config, build_params, fixed_inputs
    cfg = build_config()
    sam = port_sam(cfg, build_params())
    _, points, labels = fixed_inputs(cfg)
    golden = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden_vit_b224.npz"))
    masks, iou = sam.decode_masks(torch.from_numpy(golden["embedding"]), torch.from_numpy(points),
                                  torch.from_numpy(labels.astype(np.int64)))
    assert rel_err(masks.numpy(), golden["mask_logits"]) < 1e-3
    assert abs_err(iou.numpy(), golden["iou"]) < 1e-3
