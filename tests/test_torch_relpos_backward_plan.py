"""The rel-pos backward's dispatch and the row statistics it takes from the
forward, on the CPU against the JAX package.

``backward_plan`` pinned at the shapes that matter; the port's backward at
head dims above 128 (the plain path on the CPU, the kernels on the card take
the same head dims) against ``jax.grad`` of ``attention_qkv_with_rel_pos``;
the plain forward's lse against JAX's log-sum-exp of the same logits; and
``RelPosAttentionFn`` backing its backward with the lse it saved. All f32,
held to 2e-5 of each tensor's max (the plain versions against JAX's einsum
reference, in f32 both).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import rel_err


@pytest.mark.parametrize("N,H,W,hd,dkdv,dq", [
    (196, 14, 14, 64, "window", "window"),   # vit_b / vit_l windows
    (196, 14, 14, 80, "window", "window"),   # vit_h windows
    (196, 14, 14, 96, "window", "window"),   # the largest window that fits
    (196, 14, 14, 128, "rows", "rows"),      # k, v, q and dO of a window exceed 227 KB
    (196, 14, 14, 256, "rows", "rows"),      # a 128-column slice a block
    (4096, 64, 64, 64, "rows", "rows"),      # vit_b / vit_l global grid
    (4096, 64, 64, 80, "rows", "rows"),      # vit_h global grid
    (960, 24, 40, 64, "rows", "rows"),       # rows of 40 slots, one a tile
    (768, 8, 96, 64, "general", "general"),  # W > 64: row segments
    (6, 2, 3, 64, "window", "rows"),         # fewer than 16 tokens; dq: rows of 8 slots
    (64, 1, 64, 64, "window", "rows"),       # one map row of 64 slots
    (100, 10, 10, 64, "window", "window"),   # rows of 16 slots
])
def test_backward_plan(N, H, W, hd, dkdv, dq):
    from micro_sam_tpu_torch.ops.relpos_attention import VARIANT_CODES, backward_plan
    plan = backward_plan(N, H, W, hd)
    assert (plan.dkdv, plan.dq) == (dkdv, dq)
    assert plan.codes == (0, VARIANT_CODES[dkdv], VARIANT_CODES[dq], 0)


def test_backward_window_shared_memory():
    """The window variant is taken only where its resident window fits the
    227 KB a block may take, by the kernel's own arithmetic (mirrored in
    ``_bwd_window_smem``): 14 x 14 at head dim 96 fits, at 128 it does not."""
    from micro_sam_tpu_torch.ops.relpos_attention import SMEM_LIMIT, _bwd_window_smem
    for stage in (1, 2):
        assert _bwd_window_smem(stage, 196, 14, 14, 96) <= SMEM_LIMIT
        assert _bwd_window_smem(stage, 196, 14, 14, 128) > SMEM_LIMIT
    # k, v (240 slots), q, dO (208 rows) at pitch 72, f32 u rows of 32 at pitch 36 (+ lse, D)
    assert _bwd_window_smem(1, 196, 14, 14, 64) == 2 * (2 * 240 + 2 * 208) * 72 + 4 * 208 * 38
    assert _bwd_window_smem(2, 196, 14, 14, 64) == 2 * (2 * 240 + 2 * 208) * 72 + 4 * 208 * 36


def _qkv_case(H, W, hd, seed):
    rng = np.random.RandomState(seed)
    B, nH, N = 2, 2, H * W
    qkv = rng.randn(B, 3, nH, N, hd).astype(np.float32)
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


def _jax_lse(qkv, rh, rw, hw):
    """JAX's log-sum-exp over the keys of the logits that
    ``_einsum_attention_rel_pos`` forms, (B, nH, N)."""
    H, W = hw
    q, k = (jnp.transpose(jnp.asarray(qkv[:, i]), (0, 2, 1, 3)) for i in range(2))
    B, N, nH, hd = q.shape
    logits = jnp.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
    r_q = q.reshape(B, H, W, nH, hd)
    uh = jnp.einsum("bijnc,ikc->bnijk", r_q, jnp.asarray(rh))
    uw = jnp.einsum("bijnc,jkc->bnijk", r_q, jnp.asarray(rw))
    logits = (logits.reshape(B, nH, H, W, H, W) + uh[..., :, None]
              + uw[..., None, :]).reshape(B, nH, N, N)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1))


@pytest.mark.parametrize("hd", [160, 256])
@pytest.mark.parametrize("H,W", [(4, 4), (3, 5)])
def test_backward_above_hd128_matches_jax_grad(H, W, hd):
    """relpos_attention_backward at head dims the backward now takes above
    128 (its plain path here), with and without the forward's lse, against
    jax.grad of attention_qkv_with_rel_pos: rel <= 2e-5."""
    from micro_sam_tpu_torch.ops.relpos_attention import (relpos_attention,
                                                          relpos_attention_backward)
    qkv, rh, rw, g = _qkv_case(H, W, hd, seed=hd + H)
    ref = _jax_grads(qkv, rh, rw, g, (H, W))
    t = torch.from_numpy(qkv)
    q, k, v = t[:, 0], t[:, 1], t[:, 2]
    trh, trw = torch.from_numpy(rh), torch.from_numpy(rw)
    lse = torch.empty(q.shape[:3])
    out = relpos_attention(q, k, v, trh, trw, (H, W), lse=lse)
    assert rel_err(out, ref[0]) <= 2e-5
    for given in (None, lse):
        dq, dk, dv, drh, drw = relpos_attention_backward(q, k, v, out, torch.from_numpy(g), trh,
                                                         trw, (H, W), lse=given)
        assert rel_err(torch.stack((dq, dk, dv), 1), ref[1]) <= 2e-5
        assert rel_err(drh, ref[2]) <= 2e-5 and rel_err(drw, ref[3]) <= 2e-5


@pytest.mark.parametrize("H,W,hd", [(14, 14, 64), (8, 16, 80), (4, 4, 256)])
def test_plain_forward_lse_matches_jax(H, W, hd):
    """The plain forward's lse output against JAX's log-sum-exp of the same
    logits (rel <= 2e-5 of its max), and the output unchanged by asking for
    it."""
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention_plain
    qkv, rh, rw, _ = _qkv_case(H, W, hd, seed=11)
    t = torch.from_numpy(qkv)
    trh, trw = torch.from_numpy(rh), torch.from_numpy(rw)
    lse = torch.full(t[:, 0].shape[:3], float("nan"))
    out = relpos_attention_plain(t[:, 0], t[:, 1], t[:, 2], trh, trw, (H, W), lse=lse)
    assert rel_err(lse, _jax_lse(qkv, rh, rw, (H, W))) <= 2e-5
    assert torch.equal(out, relpos_attention_plain(t[:, 0], t[:, 1], t[:, 2], trh, trw, (H, W)))


def test_relpos_attention_fn_backs_its_backward_with_the_saved_lse(monkeypatch):
    """RelPosAttentionFn keeps the forward's row log-sum-exps (JAX's, within
    2e-5) and hands them to the backward, whose gradients match jax.grad."""
    from micro_sam_tpu_torch.ops import relpos_attention as rpa
    H, W, hd = 14, 14, 64
    qkv, rh, rw, g = _qkv_case(H, W, hd, seed=12)
    ref = _jax_grads(qkv, rh, rw, g, (H, W))
    seen = []
    backward = rpa.relpos_attention_backward

    def spy(*a, **kw):
        seen.append(kw.get("lse"))
        return backward(*a, **kw)
    monkeypatch.setattr(rpa, "relpos_attention_backward", spy)
    t = torch.from_numpy(qkv).requires_grad_()
    trh, trw = (torch.from_numpy(a).requires_grad_() for a in (rh, rw))
    out = rpa.RelPosAttentionFn.apply(t, trh, trw, (H, W))
    saved = out.grad_fn.saved_tensors[-1]
    assert saved.shape == (2, 2, H * W) and saved.dtype == torch.float32
    assert rel_err(saved, _jax_lse(qkv, rh, rw, (H, W))) <= 2e-5
    out.backward(torch.from_numpy(g))
    assert len(seen) == 1 and seen[0] is not None and torch.equal(seen[0], saved)
    assert rel_err(out.detach(), ref[0]) <= 2e-5
    assert rel_err(t.grad, ref[1]) <= 2e-5
    assert rel_err(trh.grad, ref[2]) <= 2e-5 and rel_err(trw.grad, ref[3]) <= 2e-5
