"""The port's PEFT (LoRA, FacT, SSF, AdaptFormer, the selective surgeries,
int4 QLoRA) against the JAX package, f32 on the CPU.

One JAX parameter tree of the tiny config (``tests/torch_port_util.py``) gets
the JAX package's surgery (``apply_peft``); its PEFT leaves are then redrawn
with numpy (a fresh LoRA's ``b`` is zero and would hide the update), and the
tree is carried into a port SAM given the same surgery, through
``params_from_jax``. Encoder outputs agree within 1e-4 (absolute, the neck's
LayerNorm puts them near 1), LoRA gradients within rel 1e-4 of each
tensor's max of ``jax.grad``, the masks exactly, int4 values and scales to
the bit.

The reference faults the port does not copy are pinned, each showing the JAX
package's behaviour beside the port's: a reloaded LoRA checkpoint (JAX draws
``b`` anew), the frozen base of a LoRA ``train_sam`` step, FacT's zero
gradients, the QLoRA export's int4 leaves, and SSF's proj terms, which the
JAX forward ignores.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_params, one_thread, rel_err, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE = 128
TOL = 1e-4
CASES = {
    "lora_qv": dict(rank=4),
    "lora_qkv": dict(rank=4, update_matrices=("q", "k", "v")),
    "lora_mlp": dict(rank=3, update_matrices=("q", "v", "mlp")),
    "fact": dict(rank=4, peft_module="fact"),
    "ssf": dict(peft_module="ssf"),
    "adaptformer": dict(peft_module="adaptformer", projection_size=16),
    "int4_lora": dict(rank=4, quantize=True),
}


def _cfg():
    return tiny_jax_config(SIZE)


def _redraw(tree, rng, keep_proj_ssf=True):
    """Random values in every PEFT leaf of a JAX encoder tree (in place).
    The proj's SSF terms stay at the identity where ``keep_proj_ssf``: the JAX
    forward ignores them (``test_jax_ignores_proj_ssf``)."""
    def noise(a, scale):
        return (rng.randn(*np.shape(a)) * scale).astype(np.float32)

    enc = tree["image_encoder"]
    for k in ("fact_u", "fact_v"):
        if k in enc:
            enc[k] = noise(enc[k], 0.2)
    for bp in enc["blocks"]:
        for pair in bp["attn"].get("lora", {}).values():
            pair["a"], pair["b"] = noise(pair["a"], 0.3), noise(pair["b"], 0.3)
        for k in bp["attn"].get("fact", {}):
            bp["attn"]["fact"][k] = 1 + noise(bp["attn"]["fact"][k], 0.5)
        for name, node in (("qkv", bp["attn"]["qkv"]), ("proj", bp["attn"]["proj"]),
                           ("lin1", bp["mlp"]["lin1"]), ("lin2", bp["mlp"]["lin2"])):
            if "lora" in node:
                node["lora"] = {"a": noise(node["lora"]["a"], 0.3),
                                "b": noise(node["lora"]["b"], 0.3)}
            if "ssf_scale" in node:
                scale, shift = 1 + noise(node["ssf_scale"], 0.2), noise(node["ssf_shift"], 0.2)
                if not (keep_proj_ssf and name == "proj"):
                    node["ssf_scale"], node["ssf_shift"] = scale, shift
        if "adapter" in bp["mlp"]:
            ad = bp["mlp"]["adapter"]
            ad["down"], ad["up"] = noise(ad["down"], 0.3), noise(ad["up"], 0.3)
            ad["scale"] = np.asarray(0.7, np.float32)
    return tree


def jax_peft_tree(case, seed=0, keep_proj_ssf=True):
    from micro_sam_tpu.models.peft_sam import apply_peft
    cfg = _cfg()
    tree = apply_peft(jax_params(cfg, seed=seed), cfg, **CASES[case])
    tree = jax.tree.map(np.asarray, tree)
    return _redraw(tree, np.random.RandomState(seed + 7), keep_proj_ssf)


def port_peft_sam(tree, peft_kwargs, weight_dtype=None):
    """A port SAM given the surgery ``peft_kwargs`` (none where empty),
    holding ``tree``'s weights."""
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.peft_sam import apply_peft
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    pcfg = SamConfig(**dataclasses.asdict(_cfg()))
    sam = Sam(pcfg, weight_dtype)
    if peft_kwargs:
        apply_peft(sam, **peft_kwargs)
    sam.load_state_dict(params_from_jax(tree, pcfg))
    return sam.eval()


def _jax_encoder(enc, px):
    from micro_sam_tpu.models.image_encoder import apply_image_encoder
    cfg = _cfg()
    return apply_image_encoder(enc, px, cfg.num_heads, cfg.window_size, cfg.global_attn_indexes)


def jax_encode(tree, px):
    """The JAX package's encoder (its CPU path, jitted) on ``tree``."""
    return np.asarray(jax.jit(_jax_encoder)(jax.tree.map(jnp.asarray, tree["image_encoder"]),
                                            jnp.asarray(px)))


def _pixels(seed=1, n=1):
    return np.random.RandomState(seed).randn(n, SIZE, SIZE, 3).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_encoder_matches_jax(case):
    """Serving: every block runs the encoder's chain (its plain version on the
    CPU) with the surgery's terms, the encoder output within 1e-4 of the JAX
    package's."""
    tree = jax_peft_tree(case)
    sam = port_peft_sam(tree, CASES[case])
    px = _pixels()
    got = sam.encode_image(torch.from_numpy(px)).numpy()
    ref = jax_encode(tree, px)
    assert got.shape == ref.shape == (1, SIZE // 16, SIZE // 16, 256)
    assert np.abs(got - ref).max() <= TOL
    base = jax_encode(jax.tree.map(np.asarray, jax_params(_cfg())), px)
    assert np.abs(ref - base).max() > 1e-2  # the PEFT terms change the output


@pytest.mark.parametrize("route", ["MSAM_TPU_SPATIAL_WINDOW", "MSAM_TPU_WINDOW_STACK"])
@pytest.mark.parametrize("case", ["lora_mlp", "fact", "ssf", "adaptformer", "int4_lora"])
def test_window_routes_apply_peft(case, route, monkeypatch):
    """The spatial window route (K9) and the window-stack route (K11) give a
    PEFT encoder's output of the default route, PEFT terms and all."""
    tree = jax_peft_tree(case)
    sam = port_peft_sam(tree, CASES[case])
    px = torch.from_numpy(_pixels(11))
    want = sam.encode_image(px)
    monkeypatch.setenv(route, "1")
    got = sam.encode_image(px)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("case", ["lora_qv", "lora_mlp"])
def test_lora_gradients_match_jax(case):
    """forward_train (K1 / K4's plain versions on the CPU, blocks
    checkpointed) against jax.grad of the same scalar, every LoRA tensor
    within rel 1e-4 of its max."""
    tree = jax_peft_tree(case)
    sam = port_peft_sam(tree, CASES[case], torch.float32)
    px = _pixels(2)
    w = np.random.RandomState(3).randn(1, SIZE // 16, SIZE // 16, 256).astype(np.float32)
    with one_thread():
        out = sam.image_encoder.forward_train(torch.from_numpy(px))
        (out * torch.from_numpy(w)).sum().backward()
    g = jax.jit(jax.grad(lambda enc: jnp.sum(_jax_encoder(enc, jnp.asarray(px)) * w)))(
        jax.tree.map(jnp.asarray, tree["image_encoder"]))
    n = 0
    for i, bp in enumerate(g["blocks"]):
        pairs = [(f"attn.lora.{p}", bp["attn"]["lora"][p]) for p in bp["attn"]["lora"]]
        pairs += [(f"mlp.{lin}.lora", bp["mlp"][lin]["lora"]) for lin in ("lin1", "lin2")
                  if "lora" in bp["mlp"][lin]]
        mods = dict(sam.image_encoder.blocks[i].named_modules())
        for name, ref in pairs:
            for m in ("a", "b"):
                got = getattr(mods[name], m).grad.numpy()
                assert rel_err(got, np.asarray(ref[m])) <= TOL, (i, name, m)
                n += 1
    assert n == len(g["blocks"]) * (4 if case == "lora_qv" else 8)


def test_int4_matches_jax_bitwise():
    """quantize_int4 / dequantize_int4 equal the JAX package's to the bit;
    the port's storage is packed, in * out / 2 bytes, and survives the
    state-dict round trip through the JAX tree."""
    from micro_sam_tpu.models import peft_sam as jps
    from micro_sam_tpu_torch.models import common as cm
    from micro_sam_tpu_torch.models import peft_sam as pps
    w = np.random.RandomState(4).randn(192, 96).astype(np.float32) * 0.05
    w[5, 3] = 0.0  # a block with a zero
    w[:64, 7] = 0.0  # an all-zero block column (scale 1e-12)
    jq = jps.quantize_int4(w)
    q, scale = pps.quantize_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq["w_q4"]).astype(np.int8))
    np.testing.assert_array_equal(scale.float().numpy(), np.asarray(jq["w_scale"]).astype(np.float32))
    dense = pps.dequantize_int4(q, scale)
    np.testing.assert_array_equal(dense.float().numpy(),
                                  np.asarray(jps.dequantize_int4(jq)).astype(np.float32))
    packed = cm.pack_int4(q.t())
    assert packed.dtype == torch.uint8 and packed.numel() == 192 * 96 // 2
    assert torch.equal(cm.unpack_int4(packed).t(), q)
    assert int(q.min()) >= -7 and int(q.max()) <= 7

    tree = jax_peft_tree("int4_lora")
    sam = port_peft_sam(tree, CASES["int4_lora"])
    sd = sam.state_dict()
    qkv = sam.image_encoder.blocks[0].attn.qkv
    assert qkv.quantized and "image_encoder.blocks.0.attn.qkv.weight" not in sd
    C = qkv.in_features
    assert sd["image_encoder.blocks.0.attn.qkv.w_q4"].numel() == C * 3 * C // 2
    jw = tree["image_encoder"]["blocks"][0]["attn"]["qkv"]
    np.testing.assert_array_equal(qkv.dense_weight().float().numpy().T,
                                  np.asarray(jps.dequantize_int4(jw)).astype(np.float32))
    from micro_sam_tpu_torch.models.convert import params_to_jax
    back = params_to_jax(sd, sam.config)["image_encoder"]["blocks"][0]["attn"]["qkv"]
    np.testing.assert_array_equal(back["w_q4"], np.asarray(jw["w_q4"]).astype(np.int8))
    # the port's own surgery quantizes what the JAX package quantizes
    base = jax.tree.map(np.asarray, jax_params(_cfg()))
    fresh = port_peft_sam(base, {})
    from micro_sam_tpu_torch.models.peft_sam import quantize_encoder_int4
    quantize_encoder_int4(fresh.image_encoder)
    jenc = jps.quantize_encoder_int4(base["image_encoder"])
    lin2 = fresh.image_encoder.blocks[1].mlp.lin2
    np.testing.assert_array_equal(cm.unpack_int4(lin2.w_q4).t().numpy(),
                                  np.asarray(jenc["blocks"][1]["mlp"]["lin2"]["w_q4"]).astype(np.int8))


SURGERIES = [("lora", {}), ("lora", {"update_matrices": ("q", "k", "v", "mlp")}), ("fact", {}),
             ("ssf", {}), ("adaptformer", {}), ("attention_tuning", {}), ("bias_tuning", {}),
             ("layernorm_tuning", {}), ("classical", {}), ("classical", {"unfreeze_blocks": 1})]


@pytest.mark.parametrize("name,kw", SURGERIES,
                         ids=[f"{n}{'_' + '_'.join(map(str, k.values())) if k else ''}"
                              for n, k in SURGERIES])
def test_peft_mask_matches_jax(name, kw):
    """get_peft_mask equals the JAX package's optax mask under the
    converter's names, entry for entry; freeze_peft_ realizes it."""
    from micro_sam_tpu.models import peft_sam as jps
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.peft_sam import freeze_peft_, get_peft_mask
    cfg = _cfg()
    surgery = {k: v for k, v in kw.items() if k != "unfreeze_blocks"}
    tree = jax.tree.map(np.asarray, jps.apply_peft(jax_params(cfg), cfg, peft_module=name,
                                                   **surgery))
    jmask = jps.get_peft_mask(tree, name, unfreeze_blocks=kw.get("unfreeze_blocks"))
    flags = jax.tree.map(lambda m, p: np.full(np.shape(p), bool(m)), jmask, tree)
    want = {k: bool(v.all()) for k, v in params_from_jax(flags, cfg).items()}
    assert all(bool(v.all()) == bool(v.any()) for v in params_from_jax(flags, cfg).values())
    sam = port_peft_sam(tree, dict(peft_module=name, **surgery))
    got = get_peft_mask(sam, name, unfreeze_blocks=kw.get("unfreeze_blocks"))
    assert set(got) == set(want)
    assert got == want
    freeze_peft_(sam, got)
    for key, p in sam.named_parameters():
        assert p.requires_grad == want[key]
    trains = [k for k, v in got.items() if v and k.startswith("image_encoder.")]
    assert trains or name == "classical" and not kw


@pytest.mark.parametrize("freeze", [None, ["image_encoder"], ["prompt_encoder", "mask_decoder"]],
                         ids=["none", "encoder", "prompt_decoder"])
def test_freeze_mask_matches_jax(freeze, monkeypatch):
    """training.util.freeze_mask equals the JAX package's under the
    converter's names, entry for entry, and get_trainable_sam_model(freeze=)
    realizes it with requires_grad_."""
    from micro_sam_tpu.training.util import freeze_mask as jax_freeze_mask
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.training.util import freeze_mask, get_trainable_sam_model
    cfg = _cfg()
    tree = jax.tree.map(np.asarray, jax_params(cfg))
    flags = jax.tree.map(lambda m, p: np.full(np.shape(p), bool(m)),
                         jax_freeze_mask(tree, freeze), tree)
    want = {k: bool(v.all()) for k, v in params_from_jax(flags, cfg).items()}
    got = freeze_mask(port_peft_sam(tree, {}), freeze)
    assert got == want
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(cfg)))
    sam = get_trainable_sam_model("vit_b", device="cpu", freeze=freeze).sam
    for key, p in sam.named_parameters():
        assert p.requires_grad == want[key], key


def test_peft_sam_class_and_vit_t():
    """PEFT_Sam takes the selector classes and freezes the encoder's base;
    PEFT on vit_t raises a ValueError that says why."""
    from micro_sam_tpu_torch.models.build_sam import build_sam
    from micro_sam_tpu_torch.models.peft_sam import FacTSurgery, LoRASurgery, PEFT_Sam
    base = jax.tree.map(np.asarray, jax_params(_cfg()))
    sam = port_peft_sam(base, {})
    wrapped = PEFT_Sam(sam, rank=2, peft_module=LoRASurgery)
    assert wrapped.peft_module == "lora" and wrapped.config.embed_dim == 64
    enc = sam.image_encoder
    assert not enc.blocks[0].attn.qkv.weight.requires_grad
    assert enc.blocks[0].attn.lora["q"].a.requires_grad and enc.blocks[0].attn.lora["q"].a.shape == (64, 2)
    assert all(p.requires_grad for p in sam.mask_decoder.parameters())
    fact = PEFT_Sam(port_peft_sam(base, {}), rank=2, peft_module=FacTSurgery)
    assert fact.image_encoder.fact_u.requires_grad and fact.peft_module == "fact"
    with pytest.raises(ValueError, match="TinyViT"):
        PEFT_Sam(build_sam("vit_t", device="cpu"), rank=2)


def _checkpoint(sam, path):
    from micro_sam_tpu_torch.models.convert import params_to_jax
    cfg = sam.config
    with open(path, "wb") as f:
        pickle.dump({"model_state": params_to_jax(sam.state_dict(), cfg), "model_type": "vit_b",
                     "model_config": dataclasses.asdict(cfg)}, f)
    return str(path)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_peft_and_plain_models_share_their_base(tmp_path, monkeypatch, compute_dtype):
    """get_sam_model builds every SAM through one construction (make_sam):
    with a fresh LoRA (b = 0) the PEFT model holds the plain model's base
    weights bitwise and gives its embedding bitwise, drawn from the seed or
    loaded from a checkpoint."""
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.util import get_sam_model
    cfg = _cfg()
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(cfg)))
    ckpt = _checkpoint(port_peft_sam(jax.tree.map(np.asarray, jax_params(cfg, seed=3)), {}),
                       tmp_path / "base.pkl")
    px = torch.from_numpy(_pixels(12))
    for path in (None, ckpt):
        kw = dict(device="cpu", checkpoint_path=path, compute_dtype=compute_dtype, seed=0)
        plain = get_sam_model("vit_b", **kw).model
        lora = get_sam_model("vit_b", peft_kwargs={"rank": 4}, **kw).model
        sd = lora.state_dict()
        for k, v in plain.state_dict().items():
            assert torch.equal(sd[k], v), (path, k)
        assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("lora.q.b"))
        assert torch.equal(lora.encode_image(px), plain.encode_image(px))


def test_reloaded_lora_keeps_its_training(tmp_path):
    """Reference fault 1: micro_sam_tpu.util.get_sam_model(peft_kwargs=...)
    runs apply_peft after loading, so a trained LoRA reloads with b = 0. The
    port loads the checkpoint's LoRA: the same tensors and the same
    embedding as the trained model."""
    from micro_sam_tpu.util import get_sam_model as jax_get
    from micro_sam_tpu_torch.util import get_sam_model
    tree = jax_peft_tree("lora_qv")
    trained = port_peft_sam(tree, CASES["lora_qv"])
    path = _checkpoint(trained, tmp_path / "lora.pkl")
    pp = get_sam_model("vit_b", device="cpu", checkpoint_path=path, peft_kwargs={"rank": 4})
    for (k, v), (k2, v2) in zip(trained.state_dict().items(), pp.model.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    px = torch.from_numpy(_pixels(5))
    assert torch.equal(pp.model.encode_image(px), trained.encode_image(px))
    jp = jax_get(model_type="vit_b", checkpoint_path=path, compute_dtype="float32",
                 peft_kwargs={"rank": 4})
    jb = [np.asarray(bp["attn"]["lora"][p]["b"]) for bp in jp.model.params["image_encoder"]["blocks"]
          for p in ("q", "v")]
    assert all((b == 0).all() for b in jb)
    assert all(np.abs(np.asarray(bp["attn"]["lora"]["q"]["b"])).max() > 0
               for bp in tree["image_encoder"]["blocks"])


def test_lora_train_sam_keeps_the_base_frozen(tmp_path, monkeypatch):
    """Reference fault 2: the JAX train_sam hands its trainer an unmasked
    optax.adamw when only peft_kwargs is given (training.py:347-352), so the
    encoder's base weights get updates. The port's LoRA train_sam step
    leaves every base encoder tensor bitwise as it was and moves the LoRA."""
    from micro_sam_tpu.training import training as jtr
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training import train_sam
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    from micro_sam_tpu_torch.util import get_sam_model
    cfg = _cfg()
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(cfg)))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no logger
    start = port_peft_sam(jax.tree.map(np.asarray, jax_params(cfg, seed=2)), {})
    ckpt = _checkpoint(start, tmp_path / "start.pkl")
    image, seg = synthetic_data((160, 160), seed=9)
    loader = SamLoader(SamDataset([image], [seg], (96, 96), n_samples=2), batch_size=1)
    with one_thread():
        train_sam("lora", "vit_b", loader, loader, with_segmentation_decoder=False, n_iterations=1,
                  n_sub_iteration=2, n_objects_per_batch=2, device="cpu", save_root=str(tmp_path),
                  checkpoint_path=ckpt, peft_kwargs={"rank": 4}, lr=1e-3)
    got = get_sam_model("vit_b", device="cpu", checkpoint_path=str(tmp_path / "lora" / "latest.pkl"),
                        peft_kwargs={"rank": 4}).model.state_dict()
    base = start.state_dict()
    for k, v in base.items():
        if k.startswith("image_encoder."):
            assert torch.equal(got[k], v), k
    assert any(not torch.equal(got[k], v) for k, v in base.items() if k.startswith("mask_decoder."))
    assert all(float(got[f"image_encoder.blocks.{i}.attn.lora.q.b"].abs().max()) > 0
               for i in range(cfg.depth))
    # the JAX train_sam of the same call: the optimizer it hands its trainer
    # updates the base leaves
    seen = {}

    class Seen:
        def __init__(self, **kw):
            seen.update(kw)

        def fit(self, **kw):
            pass

    monkeypatch.setattr(jtr, "SamTrainer", Seen)
    jtr.train_sam("lora", "vit_b", loader, loader, with_segmentation_decoder=False,
                  n_iterations=1, checkpoint_path=ckpt, peft_kwargs={"rank": 4},
                  verify_n_labels_in_loader=None, compute_dtype="float32")
    params, tx = seen["model"].params, seen["optimizer"]
    assert "lora" in params["image_encoder"]["blocks"][0]["attn"]
    updates = jax.jit(lambda p: tx.update(jax.tree.map(jnp.ones_like, p), tx.init(p), p)[0])(params)
    assert float(jnp.abs(updates["image_encoder"]["blocks"][0]["attn"]["qkv"]["w"]).min()) > 0


def test_fact_trains(monkeypatch):
    """Reference fault 3: the JAX package draws FacT's v as zeros and its
    scales as zeros, so every FacT gradient is exactly zero. The port keeps v
    zero but starts the scales at one: v has a gradient, and after an AdamW
    step every FacT parameter the step reaches has moved."""
    from micro_sam_tpu.models import peft_sam as jps
    from micro_sam_tpu_torch.models.peft_sam import apply_peft
    from micro_sam_tpu_torch.training.sam_trainer import adamw
    cfg = _cfg()
    tree = jax.tree.map(jnp.asarray, jps.apply_peft(jax_params(cfg), cfg, rank=4,
                                                    peft_module="fact"))
    px = _pixels(7)
    w = np.random.RandomState(8).randn(1, SIZE // 16, SIZE // 16, 256).astype(np.float32)
    g = jax.jit(jax.grad(lambda enc: jnp.sum(w * _jax_encoder(enc, jnp.asarray(px)))))(
        tree["image_encoder"])
    fact = [g["fact_u"], g["fact_v"]] + [bp["attn"]["fact"][k] for bp in g["blocks"]
                                         for k in ("q_scale", "v_scale")]
    assert all(float(jnp.abs(t).max()) == 0.0 for t in fact)

    sam = port_peft_sam(jax.tree.map(np.asarray, jax_params(cfg)), {}, torch.float32)
    apply_peft(sam, rank=4, peft_module="fact")
    enc = sam.image_encoder
    assert float(enc.fact_v.detach().abs().max()) == 0.0
    assert torch.equal(enc.blocks[0].attn.fact.q_scale, torch.ones(4))
    params = [enc.fact_u, enc.fact_v] + [p for blk in enc.blocks for p in blk.attn.fact.parameters()]
    before = [p.detach().clone() for p in params]
    opt = adamw(params, 1e-3)
    with one_thread():
        (enc.forward_train(torch.from_numpy(px)) * torch.from_numpy(w)).sum().backward()
    assert float(enc.fact_v.grad.abs().max()) > 0
    opt.step()
    assert not torch.equal(enc.fact_v, before[1])
    with one_thread():  # the second step reaches u and the scales through v
        opt.zero_grad()
        (enc.forward_train(torch.from_numpy(px)) * torch.from_numpy(w)).sum().backward()
        opt.step()
    assert all(not torch.equal(p, b) for p, b in zip(params, before))


def test_qlora_export_is_dense(tmp_path, monkeypatch):
    """Reference fault 5: the JAX export_custom_qlora_model keeps the int4
    w_q4 leaves, though its docstring says it dequantizes. The port's export
    holds no int4 leaf (every floating leaf float32, LoRA kept), loads into
    get_sam_model(peft_kwargs=...) and gives the embedding of the JAX
    package's export within 1e-4. The port's loader also reads the JAX
    export as it is: its int4 storage stays int4 with bf16 scales (the
    QLoRA model's dequantization, values rounded to bf16), so it gives the
    finetuned QLoRA model's embedding."""
    from micro_sam_tpu import util as ju
    from micro_sam_tpu_torch import util as pu
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    cfg = _cfg()
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(cfg)))
    tree = jax_peft_tree("int4_lora")
    finetuned = str(tmp_path / "qlora.pkl")
    with open(finetuned, "wb") as f:
        pickle.dump({"model_state": tree, "model_type": "vit_b"}, f)
    paths = {n: str(tmp_path / f"{n}.pkl") for n in ("jax", "port")}
    ju.export_custom_qlora_model(None, finetuned, "vit_b", paths["jax"])
    pu.export_custom_qlora_model(None, finetuned, "vit_b", paths["port"])
    states = {}
    for n, p in paths.items():
        with open(p, "rb") as f:
            states[n] = pickle.load(f)
    leaves = {n: jax.tree_util.tree_leaves_with_path(s["model_state"]) for n, s in states.items()}
    assert any("w_q4" in jax.tree_util.keystr(k) for k, _ in leaves["jax"])
    assert not any("w_q4" in jax.tree_util.keystr(k) for k, _ in leaves["port"])
    assert all(np.asarray(v).dtype == np.float32 for _, v in leaves["port"])
    lora = states["port"]["model_state"]["image_encoder"]["blocks"][0]["attn"]["lora"]["q"]["b"]
    np.testing.assert_array_equal(lora, tree["image_encoder"]["blocks"][0]["attn"]["lora"]["q"]["b"])
    px = _pixels(9)
    ref = jax_encode(states["jax"]["model_state"], px)
    refs = {"port": ref, "jax": jax_encode(tree, px)}
    for n in ("port", "jax"):
        pp = pu.get_sam_model("vit_b", device="cpu", checkpoint_path=paths[n],
                              peft_kwargs={"rank": 4})
        assert pp.model.image_encoder.blocks[0].attn.qkv.quantized == (n == "jax")
        got = pp.model.encode_image(torch.from_numpy(px)).numpy()
        assert np.abs(got - refs[n]).max() <= TOL, n


def test_jax_ignores_proj_ssf():
    """A sixth divergence: the JAX forward reads the proj product's weight
    and bias only (apply_attention), so SSF's proj scale and shift change
    nothing there. The port applies them, as it does the other three
    products'; with them at the identity both agree (test_encoder_matches_jax)."""
    tree = jax_peft_tree("ssf", keep_proj_ssf=False)
    same = jax_peft_tree("ssf", keep_proj_ssf=True)
    px = _pixels(10)
    jax_out = jax_encode(tree, px)
    assert np.array_equal(jax_out, jax_encode(same, px))
    sam = port_peft_sam(tree, CASES["ssf"])
    got = sam.encode_image(torch.from_numpy(px)).numpy()
    assert np.abs(got - jax_out).max() > 1e-2
    sam_same = port_peft_sam(same, CASES["ssf"])
    assert np.abs(sam_same.encode_image(torch.from_numpy(px)).numpy() - jax_out).max() <= TOL


def test_predictor_and_decoder_with_peft(tmp_path, monkeypatch):
    """get_predictor_and_decoder(peft_kwargs=...) no longer raises: a LoRA
    checkpoint with a decoder state gives the trained LoRA's predictor."""
    from micro_sam_tpu_torch.instance_segmentation import get_predictor_and_decoder
    from micro_sam_tpu_torch.models import build_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from torch_port_util import unetr_jax_params
    cfg = _cfg()
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_b", SamConfig(**dataclasses.asdict(cfg)))
    trained = port_peft_sam(jax_peft_tree("lora_qv"), CASES["lora_qv"])
    path = _checkpoint(trained, tmp_path / "lora.pkl")
    with open(path, "rb") as f:
        state = pickle.load(f)
    state["decoder_state"] = unetr_jax_params(True)
    with open(path, "wb") as f:
        pickle.dump(state, f)
    predictor, decoder = get_predictor_and_decoder("vit_b", path, device="cpu",
                                                   peft_kwargs={"rank": 4})
    assert torch.equal(predictor.model.image_encoder.blocks[1].attn.lora["v"].b,
                       trained.image_encoder.blocks[1].attn.lora["v"].b)
    assert decoder is not None
