"""The port's model export (micro_sam_tpu_torch/bioimageio) against the JAX
package's, on the tiny config of tests/torch_port_util.py (f32, CPU).

Tolerances: ``PredictorAdaptor`` masks agree on >= 0.999 of the pixels and
scores within 1e-4 (both packages encode the same pixels, or read the same
embeddings; the JAX predictor's power-of-two prompt buckets are turned off).
Each package's zip loads and passes ``test_model_package`` in the other, for
the tiny ViT and a vit_t (TinyViT at 64 px). The port's ``OnnxSamDecoder``
matches the port's mask decoder within rel 1e-4; the TorchScript encoder the
port's encoder within rel 1e-5 and the JAX encode within rel 1e-4. The
BioEngine layouts are equal file for file but for the encoder's format.
"""
import dataclasses
import os
import zipfile

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_params, one_thread, port_sam, rel_err, tiny_jax_config

SIZE = 256
VIT_T_SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX params, JAX predictor, the port's predictor) of one set of
    weights, the hypernetworks' last layers scaled for sharp masks."""
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.predictor import SamPredictor
    cfg = tiny_jax_config(img_size=SIZE)
    params = jax_params(cfg)
    for h in params["mask_decoder"]["hyper_mlps"]:
        h["layers"][2]["w"] = h["layers"][2]["w"] * 30.0
        h["layers"][2]["b"] = h["layers"][2]["b"] * 30.0
    jp, pp = JaxPredictor(JaxSam(cfg, params)), SamPredictor(port_sam(cfg, params))
    jp.transform.apply_image = pp.transform.apply_image  # the same pixels into both encoders
    jp.model_type = pp.model_type = "vit_b"
    return cfg, params, jp, pp


@pytest.fixture
def exact_prompts(monkeypatch):
    """The JAX predictor without its power-of-two prompt buckets."""
    import micro_sam_tpu.predictor as jpred
    monkeypatch.setattr(jpred, "_next_pow2", lambda n: n)


@pytest.fixture(scope="module")
def image():
    from micro_sam_tpu_torch.sample_data import synthetic_data
    image, seg = synthetic_data(shape=(SIZE, SIZE), seed=42)
    return image, seg


def _patch_models(monkeypatch, jp, pp):
    """Both packages' get_sam_model return the tiny predictors."""
    from micro_sam_tpu import util as jutil
    from micro_sam_tpu_torch import util
    monkeypatch.setattr(jutil, "get_sam_model", lambda *a, **kw: jp)
    monkeypatch.setattr(util, "get_sam_model", lambda *a, **kw: pp)


PROMPTS = {
    "points": dict(point_prompts=np.array([[[[128.0, 120.0], [60.0, 60.0]]]]),
                   point_labels=np.array([[[1, 0]]])),
    "boxes": dict(box_prompts=np.array([[[40.0, 50.0, 150.0, 170.0],
                                         [100.0, 20.0, 220.0, 90.0]]])),
    "mask": dict(box_prompts=np.array([[[40.0, 50.0, 150.0, 170.0]]]),
                 mask_prompts=np.random.RandomState(3).randn(1, 1, 1, 64, 64)  # 4 x 16 tokens
                 .astype(np.float32)),
}


@pytest.mark.parametrize("case", ["points", "boxes", "mask", "embeddings"])
def test_predictor_adaptor_matches_jax(models, image, exact_prompts, case):
    from micro_sam_tpu.bioimageio import PredictorAdaptor as JaxAdaptor
    from micro_sam_tpu_torch.bioimageio import PredictorAdaptor
    _, _, jp, pp = models
    img = image[0][None, None].astype(np.float32)
    prompts = dict(PROMPTS["boxes" if case == "embeddings" else case])
    port = PredictorAdaptor(pp)
    if case == "embeddings":  # both read the port's embeddings
        emb = port(img, **prompts)[2]
        prompts["embeddings"] = emb
    got = port(img, **prompts)
    ref = JaxAdaptor(jp)(img, **prompts)
    assert got[0].shape == ref[0].shape and got[0].shape[-2:] == image[0].shape
    assert float(np.mean(got[0] == ref[0])) >= 0.999
    assert np.abs(got[1] - np.asarray(ref[1])).max() <= 1e-4
    if case != "embeddings":
        assert rel_err(got[2], ref[2]) <= 1e-4


def _vit_t_models():
    """A TinyViT (vit_t at 64 px) in both packages, one set of weights (the
    port's draw, seed 0)."""
    from micro_sam_tpu.models import build_sam as jbuild
    from micro_sam_tpu.models.sam import Sam as JaxSam
    from micro_sam_tpu.predictor import SamPredictor as JaxPredictor
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.convert import params_to_jax
    from micro_sam_tpu_torch.predictor import SamPredictor
    pcfg = dataclasses.replace(build_sam.get_config("vit_t", "float32"), img_size=VIT_T_SIZE)
    pp = SamPredictor(build_sam.make_sam(pcfg, seed=0).eval())
    jcfg = dataclasses.replace(jbuild.get_config("vit_t"), img_size=VIT_T_SIZE)
    jp = JaxPredictor(JaxSam(jcfg, params_to_jax(pp.model.state_dict(), pcfg)))
    jp.transform.apply_image = pp.transform.apply_image
    return jp, pp


@pytest.mark.parametrize("model", ["vit_b_tiny", "vit_t"])
def test_packages_load_across_packages(models, image, monkeypatch, tmp_path, model):
    """Each package's zip passes test_model_package in the other package."""
    from micro_sam_tpu.bioimageio import export_sam_model as jax_export
    from micro_sam_tpu.bioimageio.model_export import test_model_package as jax_test
    from micro_sam_tpu_torch.bioimageio import export_sam_model
    from micro_sam_tpu_torch.bioimageio.model_export import (load_sam_package,
                                                             test_model_package)
    if model == "vit_t":
        jp, pp = _vit_t_models()
        img, seg = image[0][:VIT_T_SIZE, :VIT_T_SIZE], image[1][:VIT_T_SIZE, :VIT_T_SIZE]
        model_type = "vit_t"
    else:
        _, _, jp, pp = models
        img, seg = image
        model_type = "vit_b"
    port_zip = export_sam_model(img, seg, model_type, "port-model", tmp_path / "port.zip",
                                predictor=pp)
    jax_zip = jax_export(img, seg, model_type=model_type, name="jax-model",
                         output_path=str(tmp_path / "jax.zip"), predictor=jp)
    with zipfile.ZipFile(port_zip) as z:
        assert sorted(n for n in z.namelist() if n != "cover.png") == [
            "model.pt", "rdf.yaml", "test_box.npy", "test_embeddings.npy", "test_input.npy",
            "test_mask.npy", "test_score.npy"]
    report = jax_test(port_zip)
    assert report["passed"] and report["name"] == "port-model", report
    ppred, meta = load_sam_package(jax_zip, device="cpu")
    assert meta["name"] == "jax-model" and ppred.model.config == dataclasses.replace(
        pp.model.config, compute_dtype="float32")
    report = test_model_package(jax_zip, device="cpu")
    assert report["passed"], report
    assert test_model_package(port_zip, device="cpu")["passed"]


def test_package_reads_native_npz_weights(models, image, tmp_path):
    """A package whose weights are the JAX package's native npz loads in the
    port with the same weights."""
    import json
    from micro_sam_tpu.util import save_native_checkpoint
    from micro_sam_tpu_torch.bioimageio import export_sam_model
    from micro_sam_tpu_torch.bioimageio.model_export import load_sam_package
    cfg, params, _, pp = models
    path = export_sam_model(*image, "vit_b", "npz-model", tmp_path / "m.zip", predictor=pp)
    with zipfile.ZipFile(path) as z:
        files = {n: z.read(n) for n in z.namelist() if n != "model.pt"}
    meta = json.loads(files["rdf.yaml"])
    meta["weights"] = {"native_npz": {"source": "model.npz"}}
    files["rdf.yaml"] = json.dumps(meta).encode()
    save_native_checkpoint(str(tmp_path / "model.npz"), params, cfg)
    files["model.npz"] = (tmp_path / "model.npz").read_bytes()
    out = tmp_path / "npz.zip"
    with zipfile.ZipFile(out, "w") as z:
        for n, data in files.items():
            z.writestr(n, data)
    loaded, _ = load_sam_package(out, device="cpu")
    ref = pp.model.state_dict()
    for k, v in loaded.model.state_dict().items():
        assert torch.equal(v.float(), ref[k].float()), k


def test_onnx_decoder_matches_port_decoder(models):
    from micro_sam_tpu_torch.bioimageio.onnx_decoder import OnnxSamDecoder
    cfg, _, _, pp = models
    e = cfg.embedding_size
    sd = {k: v.float() for k, v in pp.model.state_dict().items()}
    dec = OnnxSamDecoder(sd, img_size=cfg.img_size, embedding_size=e).eval()
    rng = np.random.RandomState(0)
    emb = torch.from_numpy(rng.rand(1, cfg.prompt_embed_dim, e, e).astype("float32"))
    coords = torch.tensor([[[40., 60.], [100., 30.], [10., 200.], [90., 180.], [0., 0.]]])
    labels = torch.tensor([[1., 0., 2., 3., -1.]])
    mask_in = torch.from_numpy(rng.randn(1, 1, 4 * e, 4 * e).astype("float32"))
    for has_mask in (0.0, 1.0):
        with torch.no_grad():
            _, iou, low = dec(emb, coords, labels, mask_in, torch.tensor([has_mask]),
                              torch.tensor([float(cfg.img_size)] * 2))
            ref_low, ref_iou = pp.model.decode_masks(
                emb.permute(0, 2, 3, 1), coords, labels.long(),
                mask_in.permute(0, 2, 3, 1) if has_mask else None,
                torch.tensor([True]) if has_mask else None)
        assert rel_err(low, ref_low) <= 1e-4 and rel_err(iou, ref_iou) <= 1e-4


def test_export_onnx_model(models, tmp_path, monkeypatch):
    from micro_sam_tpu_torch.bioimageio.bioengine_export import export_onnx_model
    _, _, jp, pp = models
    _patch_models(monkeypatch, jp, pp)
    path = export_onnx_model("vit_b", str(tmp_path), export_name="onnx", return_path=True,
                             device="cpu")
    data = open(path, "rb").read()
    assert len(data) > 10_000 and data[0] == 0x08  # ModelProto: ir_version first
    for name in (b"image_embeddings", b"point_coords", b"point_labels", b"mask_input",
                 b"has_mask_input", b"orig_im_size", b"iou_predictions", b"low_res_masks"):
        assert name in data, name
    with pytest.warns(UserWarning, match="onnxruntime"):
        export_onnx_model("vit_b", str(tmp_path), export_name="q", quantize_model=True,
                          device="cpu")


def test_torchscript_encoder_matches_port_and_jax(models, image, tmp_path, monkeypatch):
    """The traced encoder takes what its config declares, (1, 3, h, w)
    pixels resized to the input size's longer side, and gives the port's
    and the JAX package's embedding of the image."""
    from micro_sam_tpu_torch.bioimageio.bioengine_export import export_image_encoder
    from micro_sam_tpu_torch.util import _to_image
    _, _, jp, pp = models
    _patch_models(monkeypatch, jp, pp)
    path = export_image_encoder("vit_b", str(tmp_path), device="cpu")
    assert path.endswith(os.path.join("image-encoder", "1", "model.pt"))
    config = (tmp_path / "image-encoder" / "config.pbtxt").read_text()
    assert 'platform: "pytorch_libtorch"' in config and "dims: [3, -1, -1]" in config
    traced = torch.jit.load(path, map_location="cpu")
    rgb = _to_image(image[0][:, :192])  # a (256, 192) image: the pad is traced too
    x = torch.from_numpy(pp.transform.apply_image(rgb).astype(np.float32)).permute(2, 0, 1)[None]
    with torch.no_grad():
        got = traced(x).numpy()
    assert got.shape == (1, 256, 16, 16)
    pp.set_image(rgb)
    jp.set_image(rgb)
    assert rel_err(got, pp.get_image_embedding()) <= 1e-5
    assert rel_err(got, np.asarray(jp.get_image_embedding())) <= 1e-4


def test_bioengine_layout_matches_jax(models, tmp_path, monkeypatch):
    from micro_sam_tpu.bioimageio import bioengine_export as jbe
    from micro_sam_tpu_torch.bioimageio import bioengine_export as be
    _, _, jp, pp = models
    _patch_models(monkeypatch, jp, pp)
    port_root = be.export_bioengine_model("vit_b", str(tmp_path / "port"), device="cpu")
    jax_root = jbe.export_bioengine_model("vit_b", str(tmp_path / "jax"))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    encoder_formats = {os.path.join("image-encoder", "1", "model.pt"),
                       os.path.join("image-encoder", "1", "model.stablehlo")}
    assert [f for f in files(port_root) if f not in encoder_formats] == \
        [f for f in files(jax_root) if f not in encoder_formats]
    assert os.path.exists(os.path.join(port_root, "image-encoder", "1", "model.pt"))
    for rel in files(jax_root):
        if rel.endswith("config.pbtxt"):
            port_cfg = open(os.path.join(port_root, rel)).read()
            jax_cfg = open(os.path.join(jax_root, rel)).read()
            if rel.startswith("image-encoder"):
                jax_cfg = jax_cfg.replace('backend: "stablehlo"\nplatform: "stablehlo"',
                                          'backend: "pytorch"\nplatform: "pytorch_libtorch"')
            assert port_cfg == jax_cfg, rel


def test_export_entry_points_want_the_gpu(image, tmp_path, monkeypatch):
    """No fallback: without a GPU the export entry points raise unless
    device="cpu" is passed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from micro_sam_tpu_torch.bioimageio import (PredictorAdaptor, export_image_encoder,
                                                export_sam_model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_image_encoder("vit_b", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_sam_model(*image, "vit_b", "m", tmp_path / "m.zip")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PredictorAdaptor(model_type="vit_b")
