"""The port's UNETR decoder (models/unetr.py) and its weight conversion
(models/convert.py) against the JAX package's decoder and the torch_em
oracle (tests/torch_em_unetr_ref.py), on the CPU.

Tolerances: f32 decoder outputs atol 2e-5, rtol 1e-4 (as
tests/test_unetr_conversion.py); the golden file rel drift < 1e-3 (as
tests/test_golden.py); the resize <= 1e-5; conversions exact. bf16: this
decoder with random weights is ill-conditioned in bf16 (activations that
shrink layer by layer under BN shifts and conv biases, then re-normalized by
the InstanceNorms, amplify rounding), so the JAX package's own bf16 output
lies several per cent (of max) from its f32 output. The port's bf16 output is held to
max(2e-2, 1.5 x that drift) of the JAX bf16 output, and its own distance
from the f32 output to the same bound.
"""
import numpy as np
import pytest
import torch

from tests.torch_port_util import NARROW_UNETR, one_thread, port_unetr, unetr_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


def _features(shape=(2, 8, 8, 256), seed=3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_port(model, x_nhwc, dtype=torch.float32):
    with torch.no_grad():
        out = model(torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2))
    return out.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("affine", [False, True], ids=["plain_norms", "affine_norms"])
@pytest.mark.parametrize("use_conv_transpose", [True, False], ids=["conv_transpose", "bilinear"])
def test_decoder_matches_jax(use_conv_transpose, affine):
    from micro_sam_tpu.models.unetr import apply_unetr_decoder
    p = unetr_jax_params(use_conv_transpose, affine)
    model = port_unetr(p)
    assert model.geometry["affine_norms"] == affine
    assert model.geometry["use_conv_transpose"] == use_conv_transpose
    x = _features()
    ref = np.asarray(apply_unetr_decoder(p, x))
    got = _run_port(model, x)
    assert got.shape == ref.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    # the decoder's NHWC input as the port hands it over: a channels-last view
    with torch.no_grad():
        view = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert view.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("use_conv_transpose", [True, False], ids=["conv_transpose", "bilinear"])
def test_torch_em_state_loads_strictly(use_conv_transpose):
    from tests.torch_em_unetr_ref import UnetrDecoder
    from micro_sam_tpu_torch.instance_segmentation import get_unetr
    from micro_sam_tpu_torch.models.unetr import UNETRDecoder, clean_torch_em_state
    torch.manual_seed(5)
    ref = UnetrDecoder(embed_dim=32, out_channels=3, features=NARROW_UNETR,
                       use_conv_transpose=use_conv_transpose).eval()
    g = torch.Generator().manual_seed(6)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    sd = dict(ref.state_dict())
    sd["encoder.patch_embed.proj.weight"] = torch.zeros(3)  # a UNETR checkpoint's encoder
    model = UNETRDecoder(embed_dim=32, features=NARROW_UNETR, use_conv_transpose=use_conv_transpose)
    missing, unexpected = model.load_state_dict(clean_torch_em_state(sd), strict=True)
    assert not missing and not unexpected
    x = torch.randn(2, 32, 12, 10, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = ref(x)
        np.testing.assert_allclose(model.eval()(x).numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
        loaded = get_unetr(decoder_state=sd, device="cpu")  # widths from the state
        assert loaded.geometry["embed_dim"] == 32 and loaded.geometry["features"] == NARROW_UNETR
        np.testing.assert_allclose(loaded(x).numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


def test_golden_unetr():
    """The full-width torch_em decoder's committed output (embed 256,
    features 512 / 256 / 128 / 64), through the port."""
    import os
    from tests.make_golden import build_unetr_torch, unetr_fixed_input
    from micro_sam_tpu_torch.models.unetr import clean_torch_em_state, decoder_from_state
    model = decoder_from_state(clean_torch_em_state(build_unetr_torch().state_dict()))
    assert model.geometry["features"] == (512, 256, 128, 64)
    with torch.no_grad():
        out = model(torch.from_numpy(unetr_fixed_input())).numpy()
    golden = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                  "golden_unetr.npz"))["output"].astype(np.float64)
    rel = float(np.abs(out - golden).max() / np.abs(golden).max())
    assert rel < 1e-3, rel


@pytest.mark.parametrize("affine", [False, True], ids=["plain_norms", "affine_norms"])
@pytest.mark.parametrize("use_conv_transpose", [True, False], ids=["conv_transpose", "bilinear"])
def test_conversion_round_trip_is_exact(use_conv_transpose, affine):
    import jax
    from micro_sam_tpu_torch.models.convert import unetr_params_from_jax, unetr_params_to_jax
    p = unetr_jax_params(use_conv_transpose, affine)
    sd = unetr_params_from_jax(p)
    back = unetr_params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    again = unetr_params_from_jax(back)
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k
    # a conv-transpose is (I, O, kh, kw), a conv (O, I, kh, kw)
    key = "deconv1.block.0.block.weight" if use_conv_transpose else "deconv1.block.0.conv.weight"
    assert sd[key].shape == ((256, 32, 2, 2) if use_conv_transpose else (32, 256, 1, 1))


@pytest.mark.parametrize("input_size,original_size", [
    ((128, 128), (200, 200)),   # up
    ((128, 96), (100, 75)),     # down
    ((128, 80), (150, 60)),     # one axis up, the other down, not square
    ((120, 128), (120, 128)),   # the crop alone
], ids=["up", "down", "mixed", "crop"])
def test_postprocess_matches_jax(input_size, original_size):
    import jax.numpy as jnp
    from micro_sam_tpu.models.unetr import postprocess_decoder_output as jax_post
    from micro_sam_tpu_torch.models.unetr import postprocess_decoder_output
    out = np.random.RandomState(4).rand(2, 128, 128, 3).astype(np.float32)
    ref = np.asarray(jax_post(jnp.asarray(out), input_size, original_size))
    got = postprocess_decoder_output(torch.from_numpy(out).permute(0, 3, 1, 2), input_size,
                                     original_size).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2,) + original_size + (3,)
    assert float(np.abs(got - ref).max()) <= 1e-5


@pytest.mark.parametrize("use_conv_transpose", [True, False], ids=["conv_transpose", "bilinear"])
def test_bf16_matches_jax_bf16(use_conv_transpose):
    """bf16 runs the decoder in bf16 (weights cast at use, InstanceNorm in
    f32): as close to the JAX package's bf16 output as that one is to its own
    f32 output, allowing 1.5x."""
    import jax.numpy as jnp
    from micro_sam_tpu.models.unetr import apply_unetr_decoder
    p = unetr_jax_params(use_conv_transpose)
    model = port_unetr(p)
    x = _features((1, 16, 16, 256))
    ref32 = np.asarray(apply_unetr_decoder(p, x))
    ref16 = np.asarray(apply_unetr_decoder(p, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got16 = _run_port(model, x, torch.bfloat16)
    scale = np.abs(ref32).max()
    jax_drift = float(np.abs(ref16 - ref32).max() / scale)
    bound = max(2e-2, 1.5 * jax_drift)
    assert np.isfinite(got16).all()
    assert float(np.abs(got16 - ref16).max() / scale) <= bound, (jax_drift, bound)
    assert float(np.abs(got16 - ref32).max() / scale) <= bound, (jax_drift, bound)


def test_decoder_adapter_layouts_and_output():
    """NHWC and NCHW features give the same maps: (B, 3, H, W) float32 numpy in
    (0, 1), cropped to the input size and resized to the original size."""
    from micro_sam_tpu_torch.instance_segmentation import DecoderAdapter
    dec = DecoderAdapter(port_unetr(unetr_jax_params(True)))
    x = _features((1, 16, 16, 256))
    a = dec(torch.from_numpy(x), (256, 200), (300, 234))
    b = dec(np.transpose(x, (0, 3, 1, 2)), (256, 200), (300, 234))
    assert a.shape == (1, 3, 300, 234) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert (a > 0).all() and (a < 1).all()


def test_get_unetr_random_init_and_unknown_states():
    from micro_sam_tpu_torch.instance_segmentation import get_decoder, get_unetr
    a, b = get_unetr(device="cpu", seed=3), get_unetr(device="cpu", seed=3)
    c = get_unetr(device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["base.block.1.weight"], sc["base.block.1.weight"])
    assert a.geometry["features"] == (512, 256, 128, 64) and a.geometry["embed_dim"] == 256
    assert not get_unetr(device="cpu", final_activation=None).final_activation
    with pytest.raises(ValueError, match="Unrecognized decoder state"):
        get_decoder(decoder_state={"something": np.zeros(3)}, device="cpu")
    with pytest.warns(UserWarning, match="random initialization"):
        model = get_unetr(decoder_state={"something": np.zeros(3)}, device="cpu",
                          flexible_load_checkpoint=True)
    assert model.geometry["features"] == (512, 256, 128, 64)
    # a JAX-layout pytree (a native checkpoint's decoder_state)
    p = unetr_jax_params(False)
    assert get_unetr(decoder_state=p, device="cpu").geometry["use_conv_transpose"] is False
