"""vit_t (TinyViT) finetuning in the port against the JAX package, f32 on the CPU.

The TinyViT training forward runs each kernel chain (K7 MBConv, K6 window
attention, K8 block tail) as its ``torch.autograd.Function``: the chain
forward, the plain chain's gradient backward (``ops/chain_grad.py``), as the
JAX package's ``custom_vjp``s. On CPU tensors the chains are their plain
versions, so here the functions' plumbing and the whole encoder's gradients
are held: against ``jax.grad`` of ``apply_tiny_vit`` on the JAX package's
unfused path (``MSAM_TPU_FUSED_TINY=0``), every tensor within rel 1e-4 of
its max. The vit_t presets train, and a trainer step leaves the BatchNorm
statistics bitwise as they were while the BN affine terms move.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tiny_vit import _jax_tree
from torch_port_util import one_thread, rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


SIZE = 64
TOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    return _jax_tree(SIZE, seed=3)


def _train_sam(tree):
    """The port's vit_t with float32 product weights (the training preset)."""
    from micro_sam_tpu_torch.models.build_sam import get_config
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam
    cfg = dataclasses.replace(get_config("vit_t", "float32"), img_size=SIZE)
    sam = Sam(cfg, torch.float32)
    sam.load_state_dict(params_from_jax(tree, cfg))
    return sam


def test_encoder_gradients_match_jax(tree, monkeypatch):
    """forward_train's gradients of sum(w * encoder(x)) in every encoder
    tensor (the BN weight and bias included, through the fold) against
    jax.grad; the statistics get none."""
    from micro_sam_tpu.models.tiny_vit import apply_tiny_vit
    from micro_sam_tpu_torch.models.convert import params_to_jax
    monkeypatch.setenv("MSAM_TPU_FUSED_TINY", "0")
    sam = _train_sam(tree)
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 3).astype(np.float32)
    w = np.random.RandomState(2).randn(2, SIZE // 16, SIZE // 16, 256).astype(np.float32)
    with one_thread():
        out = sam.image_encoder.forward_train(torch.from_numpy(x))
        (out * torch.from_numpy(w)).sum().backward()
    enc = sam.image_encoder
    assert enc.layers[0].blocks[0].conv1.bn.running_mean.grad is None
    grads = {f"image_encoder.{k}": (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in enc.named_parameters()}
    grads.update({f"image_encoder.{k}": torch.zeros_like(b) for k, b in enc.named_buffers()})
    grads.update({k: torch.zeros_like(v) for k, v in sam.state_dict().items()
                  if not k.startswith("image_encoder.")})
    got = params_to_jax(grads, sam.config)["image_encoder"]
    ref = jax.jit(jax.grad(lambda p: jnp.sum(w * apply_tiny_vit(p, jnp.asarray(x)))))(
        jax.tree.map(jnp.asarray, tree["image_encoder"]))
    pairs = jax.tree_util.tree_leaves_with_path(ref)
    n = 0
    for path, r in pairs:
        key = jax.tree_util.keystr(path)
        node = got
        for part in path:
            node = node[part.key if hasattr(part, "key") else part.idx]
        if key.endswith("['mean']") or key.endswith("['var']"):
            assert float(jnp.abs(r).max()) == 0.0
            continue
        assert rel_err(node, np.asarray(r)) <= TOL, key
        n += 1
    assert n == sum(1 for _ in enc.parameters())


@pytest.mark.parametrize("chain", ["mbconv", "tiny_attention", "tiny_tail"])
def test_chain_functions_take_autograd(tree, chain):
    """Each chain goes through its autograd function exactly where autograd
    needs it, and its gradients equal autograd through the plain chain
    (the two are one computation on the CPU; the card holds the kernels)."""
    from micro_sam_tpu_torch.ops import fused_mbconv as fm
    from micro_sam_tpu_torch.ops import fused_tiny_attention as fa
    from micro_sam_tpu_torch.ops import fused_tiny_tail as ft
    sam = _train_sam(tree)
    enc = sam.image_encoder
    rng = np.random.RandomState(4)
    if chain == "mbconv":
        mods = (enc.layers[0].blocks[0],)
        x = rng.randn(1, 16, 16, 64)
        fn, plain, fcls = fm.fused_mbconv, fm.fused_mbconv_plain, fm.FusedMBConvFn
    elif chain == "tiny_attention":
        mods = (enc.layers[1].blocks[0].attn,)
        x = rng.randn(1, 14, 14, 128)
        fn, plain, fcls = fa.fused_tiny_attention, fa.fused_tiny_attention_plain, \
            fa.FusedTinyAttentionFn
    else:
        blk = enc.layers[2].blocks[0]
        mods = (blk.local_conv, blk.mlp)
        x = rng.randn(1, 8, 8, 160)
        fn, plain, fcls = ft.fused_tiny_tail, ft.fused_tiny_tail_plain, ft.FusedTinyTailFn
    params = [p for m in mods for p in m.parameters()]
    xs = [torch.tensor(x, dtype=torch.float32, requires_grad=True) for _ in range(2)]
    with torch.no_grad():
        assert fn(xs[0], *mods).grad_fn is None
    a = fn(xs[0], *mods)
    assert type(a.grad_fn).__name__ == f"{fcls.__name__}Backward"
    g = torch.from_numpy(rng.randn(*a.shape).astype(np.float32))
    ga = torch.autograd.grad(a, [xs[0]] + params, g)
    gb = torch.autograd.grad(plain(xs[1], *mods), [xs[1]] + params, g)
    for u, v in zip(ga, gb):
        assert torch.allclose(u, v, rtol=1e-6, atol=1e-7)


@pytest.fixture()
def vit_t_small(monkeypatch):
    from micro_sam_tpu_torch.models import build_sam
    monkeypatch.setitem(build_sam.SAM_CONFIGS, "vit_t",
                        dataclasses.replace(build_sam.SAM_CONFIGS["vit_t"], img_size=128))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no logger


def _loader():
    from micro_sam_tpu_torch.sample_data import synthetic_data
    from micro_sam_tpu_torch.training.training import SamDataset, SamLoader
    image, seg = synthetic_data((160, 160), seed=9)
    return SamLoader(SamDataset([image], [seg], (96, 96), n_samples=2), batch_size=1)


def test_trainer_step_keeps_bn_statistics(vit_t_small, tmp_path):
    """One SamTrainer step on vit_t: every BN running mean and variance
    bitwise unchanged, the BN weights and the encoder's products moved."""
    from micro_sam_tpu_torch.training import get_trainable_sam_model
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    model = get_trainable_sam_model("vit_t", device="cpu", seed=1)
    enc = model.sam.image_encoder
    stats = {k: b.clone() for k, b in enc.named_buffers()}
    bn_w = enc.layers[0].blocks[0].conv1.bn.weight.detach().clone()
    qkv = enc.layers[1].blocks[0].attn.qkv.weight.detach().clone()
    assert qkv.dtype == torch.float32
    trainer = SamTrainer("t", _loader(), _loader(), model, n_sub_iteration=2,
                         n_objects_per_batch=2, save_root=str(tmp_path), lr=1e-3, logger=False)
    with one_thread():
        trainer.fit(iterations=1, verbose=False)
    for k, b in enc.named_buffers():
        assert torch.equal(b, stats[k]), k
    assert not torch.equal(enc.layers[0].blocks[0].conv1.bn.weight, bn_w)
    assert not torch.equal(enc.layers[1].blocks[0].attn.qkv.weight, qkv)


@pytest.mark.parametrize("configuration", ["Minimal", "gtx1080"])
def test_vit_t_presets_train(vit_t_small, tmp_path, configuration):
    """The two vit_t presets run end to end (without the segmentation
    decoder, for time) and write a vit_t checkpoint that loads."""
    import pickle
    from micro_sam_tpu_torch.training.training import (CONFIGURATIONS,
                                                       train_sam_for_configuration)
    from micro_sam_tpu_torch.util import get_sam_model
    assert CONFIGURATIONS[configuration]["model_type"] == "vit_t"
    with one_thread():
        train_sam_for_configuration(configuration, configuration, _loader(), _loader(),
                                    with_segmentation_decoder=False, n_iterations=1,
                                    n_sub_iteration=2, device="cpu", save_root=str(tmp_path))
    path = tmp_path / configuration / "best.pkl"
    with open(path, "rb") as f:
        assert pickle.load(f)["model_type"] == "vit_t"
    pp = get_sam_model("vit_t", device="cpu", checkpoint_path=str(path))
    assert pp.model.config.encoder == "tiny_vit"
