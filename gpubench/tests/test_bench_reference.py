"""The plain reference against the port's plain CPU path at a small size, on
the same weights (drawn by ``harness.weights`` in the published layout)."""
import pytest
import torch

import benchtiny
from harness import check, port
from harness.weights import make_reference, make_state_dict
from reference.sam import Precision

CPU = torch.device("cpu")


def test_published_layout_loads_into_the_port():
    cfg = benchtiny.tiny_config()
    sd = make_state_dict(cfg, 5, CPU)
    predictor = port.build_predictor(cfg, sd, CPU)
    ours = predictor.model.state_dict()
    assert set(ours) == set(sd)
    for k, v in sd.items():
        assert torch.equal(ours[k].float(), v), k


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    cfg = benchtiny.tiny_config()
    a, b, c = (make_state_dict(cfg, s, CPU) for s in (2 ** 31 + 3, 2 ** 31 + 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_encoder.pos_embed"], c["image_encoder.pos_embed"])


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_reference_encoder_matches_the_port(seed):
    cfg = benchtiny.tiny_config()
    predictor = port.build_predictor(cfg, make_state_dict(cfg, seed, CPU), CPU)
    g = torch.Generator().manual_seed(seed)
    images = (torch.rand((3, 256, 256, 3), generator=g) * 255).to(torch.uint8).numpy()
    got = predictor.encode_batch(images).permute(0, 3, 1, 2)
    refs = check.reference_embeddings(make_reference(cfg, seed, CPU), list(images), CPU)
    for i, ref in enumerate(refs):
        assert check.rel_err(got[i], ref) < 1e-5


def _decode(seed, activation):
    cfg = benchtiny.tiny_config()
    ref_cfg = {**cfg, "decoder": {**cfg["decoder"], "mlp_activation": activation}}
    predictor = port.build_predictor(cfg, make_state_dict(cfg, seed, CPU), CPU)
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(2, 256, 16, 16, generator=g)
    points = torch.rand(2, 3, 2, generator=g) * 256
    labels = torch.tensor([[1, 0, 1], [1, 1, 0]])
    pad_p = torch.cat([points, torch.zeros(2, 1, 2)], 1)  # upstream's padding point
    pad_l = torch.cat([labels, -torch.ones(2, 1, dtype=torch.long)], 1)
    with torch.no_grad():
        got = predictor.model.decode_masks(emb.permute(0, 2, 3, 1), pad_p, pad_l)
        ref = make_reference(ref_cfg, seed, CPU).decode(
            emb, points, labels, None, None, Precision())
    return [check.rel_err(a, b) for a, b in zip(got, ref)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_decoder_with_the_ports_activation_matches_the_port(seed):
    """The prompt encoder and the decoder agree with the port's once the
    reference's two-way-transformer MLP takes GELU, the port's activation."""
    assert max(_decode(seed, "gelu")) < 1e-5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_port_decoder_departs_from_the_published_relu(seed):
    """The published decoder (ReLU in the two-way transformer's MLPs, as
    segment-anything's ``TwoWayTransformer`` default) and the port's (GELU)
    differ by far more than rounding: the open fault that keeps the
    finetuning cell out of the benchmark (``PERF.md``, Open questions). When
    the port takes ReLU, this test fails and the cell can come in."""
    masks, iou = _decode(seed, "relu")
    assert masks > 1e-2


def test_fp8_control_rounds_each_product():
    prec = Precision("fp8")
    x = torch.linspace(-3, 3, 1001)
    r = prec.round(x)
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -4 + 3 / 448 * 2 ** -9)
    assert not torch.equal(r, x)
    assert torch.equal(Precision().round(x), x)
