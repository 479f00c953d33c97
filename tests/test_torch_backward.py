"""The training slice's gradients on the CPU against the JAX package.

K4's plain backward and ``RelPosAttentionFn`` against ``jax.grad`` through
``micro_sam_tpu.ops.attention.attention_qkv_with_rel_pos`` (the JAX package's
CPU route, its einsum reference), and the port's training encoder against
``jax.grad`` of ``apply_image_encoder(..., remat=True)``. All f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import jax_params, one_thread, port_sam, rel_err, tiny_jax_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: tier-1's six test processes share the
    machine's cores, and small tensors gain nothing from more (ROADMAP.md,
    Budgets)."""
    with one_thread():
        yield


def _qkv_case(H, W, hd, padded, seed):
    """Fused (B, 3, nH, N, hd) qkv, tables and an upstream gradient. With
    ``padded`` the window's last rows and columns are pad tokens: their qkv
    rows are the product's bias alone, as after the zeroed LN1 output."""
    rng = np.random.RandomState(seed)
    B, nH, N = 2, 2, H * W
    qkv = rng.randn(B, 3, nH, N, hd).astype(np.float32)
    if padded:
        pad = np.zeros((H, W), bool)
        pad[-3:, :] = pad[:, -4:] = True
        bias = rng.randn(3, nH, hd).astype(np.float32)
        qkv[:, :, :, pad.reshape(-1)] = bias[None, :, :, None]
    rh = (rng.randn(H, H, hd) * 0.3).astype(np.float32)
    rw = (rng.randn(W, W, hd) * 0.3).astype(np.float32)
    g = rng.randn(B, nH, N, hd).astype(np.float32)
    return qkv, rh, rw, g


def _jax_grads(qkv, rh, rw, g, hw):
    from micro_sam_tpu.ops.attention import attention_qkv_with_rel_pos
    def f(q_, h_, w_):
        out = attention_qkv_with_rel_pos(q_, hw, h_, w_)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(qkv, rh, rw)
    return [np.asarray(out)] + [np.asarray(a) for a in grads]


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("H,W,padded", [(14, 14, True), (64, 32, False), (8, 8, False)],
                         ids=["window14_padded", "grid64x32", "grid8"])
def test_relpos_backward_plain_matches_jax_grad(H, W, padded, hd):
    """relpos_attention_backward_plain (q / k / v read as the fused tensor's
    strided views) against jax.grad: rel <= 2e-5 of each tensor's max."""
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward)
    qkv, rh, rw, g = _qkv_case(H, W, hd, padded, seed=H + W + hd)
    ref = _jax_grads(qkv, rh, rw, g, (H, W))
    t = torch.from_numpy(qkv)
    q, k, v = t[:, 0], t[:, 1], t[:, 2]
    trh, trw = torch.from_numpy(rh), torch.from_numpy(rw)
    out = relpos_attention(q, k, v, trh, trw, (H, W))
    dqkv = torch.empty_like(t)
    dq, dk, dv, drh, drw = relpos_attention_backward(q, k, v, out, torch.from_numpy(g), trh, trw,
                                                     (H, W), dqkv[:, 0], dqkv[:, 1], dqkv[:, 2])
    assert dq.data_ptr() == dqkv[:, 0].data_ptr()  # written into the given views
    for got, want in zip((out, dqkv, drh, drw), (ref[0], ref[1], ref[2], ref[3])):
        assert rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("H,W", [(14, 14), (8, 16)])
def test_relpos_attention_fn_matches_jax_grad(H, W):
    """The autograd function over a (B, N, 3, nH, hd) row view: its qkv
    gradient is those rows, its table gradients f32."""
    from micro_sam_tpu_torch.ops.flash_attention import flash_attention_qkv
    qkv, rh, rw, g = _qkv_case(H, W, 64, False, seed=3)
    ref = _jax_grads(qkv, rh, rw, g, (H, W))
    rows = torch.from_numpy(np.ascontiguousarray(qkv.transpose(0, 3, 1, 2, 4))).requires_grad_()
    trh, trw = (torch.from_numpy(a).requires_grad_() for a in (rh, rw))
    out = flash_attention_qkv(rows.permute(0, 2, 3, 1, 4), (H, W), trh, trw, 2)
    out.backward(torch.from_numpy(g))
    assert rows.grad.is_contiguous()
    assert rel_err(out.detach(), ref[0]) <= 2e-5
    assert rel_err(rows.grad.permute(0, 2, 3, 1, 4), ref[1]) <= 2e-5
    assert trh.grad.dtype == torch.float32
    assert rel_err(trh.grad, ref[2]) <= 2e-5 and rel_err(trw.grad, ref[3]) <= 2e-5


def test_training_encoder_matches_jax_remat():
    """forward_train (checkpointed blocks, RelPosAttentionFn) against
    apply_image_encoder(remat=True) at the tiny config (16 x 16 tokens, 14 x 14
    windows padded): output rel <= 1e-4, every parameter gradient rel <= 1e-3
    of its max."""
    from micro_sam_tpu.models.image_encoder import apply_image_encoder
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    import dataclasses
    cfg = tiny_jax_config()
    params = jax_params(cfg, seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(1, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    gout = rng.randn(1, 16, 16, 256).astype(np.float32)
    enc = params["image_encoder"]

    def f(p):
        y = apply_image_encoder(p, x, num_heads=cfg.num_heads, window_size=cfg.window_size,
                                global_attn_indexes=cfg.global_attn_indexes, remat=True)
        return jnp.sum(y * gout), y

    (_, y_ref), g_ref = jax.jit(jax.value_and_grad(f, has_aux=True))(enc)
    g_sd = params_from_jax(jax.tree.map(np.asarray, {**params, "image_encoder": g_ref}), cfg)

    sam = Sam(SamConfig(**dataclasses.asdict(cfg)), torch.float32)
    sam.load_state_dict(port_sam(cfg, params).state_dict())
    y = sam.encode_image_train(torch.from_numpy(x))
    (y * torch.from_numpy(gout)).sum().backward()
    assert rel_err(y.detach(), y_ref) <= 1e-4
    n = 0
    for name, p in sam.image_encoder.named_parameters():
        assert rel_err(p.grad, g_sd[f"image_encoder.{name}"]) <= 1e-3, name
        n += 1
    assert n == 3 + 2 * 14 + 6  # patch embed, pos embed, 2 blocks of 14, neck
