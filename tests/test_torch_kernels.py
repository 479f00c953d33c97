"""The port's kernel modules against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, or its einsum composition) and the port's function, which on a
CPU tensor runs the kernel's plain version. f32 throughout, tolerance
abs <= 5e-5 (as tests/test_fused_block.py holds the Pallas kernels). The CUDA
kernels themselves are held against their plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import abs_err, jax_block, port_block

TOL = 5e-5


def _qkv_and_tables(B, nH, H, W, hd, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, 3, nH, H * W, hd).astype(np.float32)
    rh = (rng.randn(H, H, hd) * 0.2).astype(np.float32)
    rw = (rng.randn(W, W, hd) * 0.2).astype(np.float32)
    return qkv, rh, rw


@pytest.mark.parametrize("B,H", [(3, 7), (1, 16)], ids=["window7", "global16"])
def test_relpos_attention_matches_jax_flash(B, H):
    from micro_sam_tpu.ops.flash_attention import flash_attention_qkv as jax_flash
    from micro_sam_tpu_torch.ops.flash_attention import flash_attention_qkv

    nH, hd = 2, 32
    qkv, rh, rw = _qkv_and_tables(B, nH, H, H, hd)
    ref = np.asarray(jax_flash(jnp.asarray(qkv), (H, H), jnp.asarray(rh), jnp.asarray(rw), nH))
    got = flash_attention_qkv(torch.from_numpy(qkv), (H, H), torch.from_numpy(rh),
                              torch.from_numpy(rw), nH).numpy()
    assert abs_err(got, ref) < TOL


@pytest.mark.parametrize("with_rel", [True, False])
def test_relpos_attention_matches_jax_einsum(with_rel):
    from micro_sam_tpu.ops.attention import _einsum_attention_rel_pos as jax_einsum
    from micro_sam_tpu_torch.ops.attention import _einsum_attention_rel_pos
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention

    B, nH, H, W, hd = 2, 3, 5, 6, 16
    qkv, rh, rw = _qkv_and_tables(B, nH, H, W, hd, seed=1)
    q, k, v = (np.ascontiguousarray(qkv[:, i].transpose(0, 2, 1, 3)) for i in range(3))
    rh_j, rw_j = (jnp.asarray(rh), jnp.asarray(rw)) if with_rel else (None, None)
    ref = np.asarray(jax_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), (H, W), rh_j, rw_j))
    t = torch.from_numpy
    got = _einsum_attention_rel_pos(t(q), t(k), t(v), (H, W), t(rh) if with_rel else None,
                                    t(rw) if with_rel else None).numpy()
    assert abs_err(got, ref) < TOL
    if with_rel:  # the kernel's plain version, fed head-major views
        qkv_t = t(qkv)
        got2 = relpos_attention(qkv_t[:, 0], qkv_t[:, 1], qkv_t[:, 2], t(rh), t(rw), (H, W))
        assert abs_err(got2.transpose(1, 2).numpy(), ref) < TOL


@pytest.mark.parametrize("masked", [False, True])
def test_window_block_matches_jax_fused_window_block(masked):
    from micro_sam_tpu.ops.fused_window_block import fused_window_block as jax_fwb
    from micro_sam_tpu_torch.ops.fused_window_block import fused_window_block

    C, nH, W, BW = 64, 2, 7, 3
    bp = jax_block(C, nH, (W, W))
    rng = np.random.RandomState(3)
    x = rng.randn(BW, W * W, C).astype(np.float32)
    valid = (rng.rand(BW, W * W, 1) > 0.2).astype(np.float32) if masked else None
    ref = np.asarray(jax_fwb(jnp.asarray(x), None if valid is None else jnp.asarray(valid),
                             bp, (W, W), nH))
    blk = port_block(bp, C, nH, W, (W, W))
    with torch.no_grad():
        got = fused_window_block(torch.from_numpy(x),
                                 None if valid is None else torch.from_numpy(valid),
                                 blk, (W, W), nH).numpy()
    assert abs_err(got, ref) < TOL


def test_global_block_matches_jax_fused_global_block():
    from micro_sam_tpu.ops.fused_window_block import fused_global_block as jax_fgb
    from micro_sam_tpu.ops.fused_window_block import global_block_config
    from micro_sam_tpu_torch.ops.fused_window_block import fused_global_block

    C, nH, H, B = 64, 2, 16, 1
    assert global_block_config(H, H, jnp.float32, channels=C, mlp_hidden=4 * C,
                               num_heads=nH) is not None  # the Pallas kernel runs
    bp = jax_block(C, nH, (H, H), seed=5)
    x = np.random.RandomState(6).randn(B, H * H, C).astype(np.float32)
    ref = np.asarray(jax_fgb(jnp.asarray(x), bp, (H, H), nH))
    blk = port_block(bp, C, nH, 0, (H, H))
    with torch.no_grad():
        got = fused_global_block(torch.from_numpy(x), blk, (H, H), nH).numpy()
    assert abs_err(got, ref) < TOL
