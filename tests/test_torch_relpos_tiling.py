"""The rel-pos attention forward's variant choice and its head dims above
128, on the CPU.

``forward_plan`` is the pure function of (N, H, W, head dim) that picks the
bf16 kernel's variant (``csrc/relpos_attention.cu`` checks the same rule).
The kernel itself runs only on the card (tests/test_torch_cuda.py, which
holds each variant's tiling against the plain version); here the choice is
pinned, with the window variant's shared memory, and the forward's plain version
at head dims 160 and 256 is held against the JAX package's einsum
composition (f32, abs <= 5e-5, as tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import abs_err

TOL = 5e-5


@pytest.mark.parametrize("grid,want", [
    # every SAM ViT's 14 x 14 windows, at every built head dim up to 128
    ((196, 14, 14, 32), "window"),
    ((196, 14, 14, 64), "window"),
    ((196, 14, 14, 80), "window"),
    ((196, 14, 14, 96), "window"),
    ((196, 14, 14, 128), "window"),
    # the global grid: key tiles of one map row
    ((4096, 64, 64, 64), "rows"),
    ((4096, 64, 64, 80), "rows"),
    # W dividing 64 and not, past the window's 256 slots
    ((960, 24, 40, 64), "rows"),
    ((512, 16, 32, 64), "rows"),
    # W > 64: 64-slot row segments, also where the padded row alone fits 256
    ((768, 8, 96, 64), "general"),
    ((200, 1, 200, 64), "general"),
    # a tiny grid
    ((6, 2, 3, 64), "window"),
    # windows that fit 256 slots but not the shared memory of one block
    ((256, 16, 16, 96), "window"),
    ((256, 16, 16, 128), "rows"),
    ((225, 15, 15, 128), "rows"),
    ((256, 4, 64, 96), "rows"),
    # above head dim 128: never the window variant
    ((196, 14, 14, 256), "rows"),
    ((4096, 64, 64, 256), "rows"),
], ids=["window_hd32", "window", "window_hd80", "window_hd96", "window_hd128", "global",
        "global_hd80", "w40", "w32", "w96", "w200", "tiny", "w16_hd96", "w16_hd128",
        "w15_hd128", "w4x64_hd96", "window_hd256", "global_hd256"])
def test_forward_plan(grid, want):
    """(N, H, W, kernel head dim) -> the bf16 forward's variant and its
    kernel code."""
    from micro_sam_tpu_torch.ops.relpos_attention import VARIANT_CODES, forward_plan
    plan = forward_plan(*grid)
    assert plan.variant == want
    assert plan.code == VARIANT_CODES[want]


@pytest.mark.parametrize("grid,smem,fits", [
    ((196, 14, 14, 64), 124864, True), ((196, 14, 14, 128), 212928, True),
    ((256, 16, 16, 128), 251392, False), ((256, 4, 64, 96), 237056, False),
], ids=["window", "window_hd128", "w16_hd128", "w4x64_hd96"])
def test_window_shared_memory(grid, smem, fits):
    """The window variant's shared memory (``bf16_smem`` of the kernel: k, v
    and q rows of pitch hd + 8, f32 u rows of odd pitch) against the limit of
    one block, 232448 bytes."""
    from micro_sam_tpu_torch.ops.relpos_attention import SMEM_LIMIT, _window_smem
    assert _window_smem(*grid) == smem
    assert (smem <= SMEM_LIMIT) == fits


@pytest.mark.parametrize("hd", [160, 256])
def test_forward_above_hd128_matches_jax_einsum(hd):
    """Head dims above 128: the port's forward (its plain version on a CPU
    tensor, the kernel on the card) against JAX's einsum composition, which
    takes every head dim."""
    from micro_sam_tpu.ops.attention import _einsum_attention_rel_pos as jax_einsum
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention

    B, nH, H, W = 2, 2, 4, 5
    rng = np.random.RandomState(hd)
    qkv = rng.randn(B, 3, nH, H * W, hd).astype(np.float32) * 0.5
    rh = (rng.randn(H, H, hd) * 0.1).astype(np.float32)
    rw = (rng.randn(W, W, hd) * 0.1).astype(np.float32)
    q, k, v = (np.ascontiguousarray(qkv[:, i].transpose(0, 2, 1, 3)) for i in range(3))
    ref = np.asarray(jax_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), (H, W),
                                jnp.asarray(rh), jnp.asarray(rw)))
    t = torch.from_numpy
    got = relpos_attention(t(qkv)[:, 0], t(qkv)[:, 1], t(qkv)[:, 2], t(rh), t(rw), (H, W))
    assert got.shape == (B, nH, H * W, hd)
    assert abs_err(got.transpose(1, 2).numpy(), ref) < TOL
