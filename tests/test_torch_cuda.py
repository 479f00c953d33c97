"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU (the
kernels have no CPU mode). This file imports neither jax nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 relative error <= 1e-4 of max|ref| with TF32 off; bf16
<= 2e-2 of max|ref|, the plain version run in f32 on the same bf16 inputs.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _held(got, ref, dtype):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_layernorm_matches_plain(dev, dtype, masked):
    from micro_sam_tpu_torch.ops.layernorm import layernorm, layernorm_plain
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4900, 768, generator=g) * 3).to(dev, dtype)
    w = (torch.randn(768, generator=g) * 0.5 + 1).to(dev)
    b = (torch.randn(768, generator=g) * 0.1).to(dev)
    v = (torch.rand(4900, generator=g) > 0.2).float().to(dev) if masked else None
    n = layernorm.launches
    got = layernorm(x, w, b, 1e-6, v)
    torch.cuda.synchronize()
    assert layernorm.launches == n + 1
    _held(got, layernorm_plain(x.float(), w, b, 1e-6, v), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual"])
@pytest.mark.parametrize("M,K,N", [(4900, 768, 2304), (37, 72, 40), (130, 3072, 768)],
                         ids=["vit_b_qkv", "ragged", "vit_b_lin2"])
def test_gemm_matches_plain(dev, dtype, epilogue, M, K, N):
    from micro_sam_tpu_torch.ops.gemm import gemm, gemm_plain
    g = torch.Generator().manual_seed(1)
    x = torch.randn(M, K, generator=g).to(dev, dtype)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dev, dtype)
    b = (torch.randn(N, generator=g) * 0.1).to(dev)
    r = torch.randn(M, N, generator=g).to(dev, dtype) if epilogue == "residual" else None
    got = gemm(x, w, b, epilogue, r)
    torch.cuda.synchronize()
    _held(got, gemm_plain(x.float(), w.float(), b, epilogue, None if r is None else r.float()),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,hd", [(25, 14, 14, 64), (1, 64, 64, 64), (3, 10, 7, 64)],
                         ids=["window", "global", "ragged"])
def test_relpos_attention_matches_plain(dev, dtype, B, H, W, hd):
    from micro_sam_tpu_torch.ops.relpos_attention import relpos_attention, relpos_attention_plain
    nH, N = 12, H * W
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(B * N, 3, nH, hd, generator=g).to(dev, dtype)
    q5 = qkv.view(B, N, 3, nH, hd)
    q, k, v = (q5[:, :, i].transpose(1, 2) for i in range(3))  # token-major strided views
    rh = (torch.randn(H, H, hd, generator=g) * 0.3).to(dev, dtype)
    rw = (torch.randn(W, W, hd, generator=g) * 0.3).to(dev, dtype)
    out = torch.empty(B, N, nH, hd, device=dev, dtype=dtype)
    got = relpos_attention(q, k, v, rh, rw, (H, W), out=out.transpose(1, 2))
    torch.cuda.synchronize()
    ref = relpos_attention_plain(q.float(), k.float(), v.float(), rh.float(), rw.float(), (H, W))
    _held(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["window", "global"])
def test_block_chain_matches_plain(dev, dtype, kind):
    from micro_sam_tpu_torch.models.common import init_module_
    from micro_sam_tpu_torch.models.image_encoder import Block, window_partition
    from micro_sam_tpu_torch.ops import fused_window_block as fwb
    C, nH = 128, 2
    g = torch.Generator().manual_seed(3)
    if kind == "window":
        blk = Block(C, nH, 4.0, 7, (7, 7))
        x = torch.randn(2, 10, 10, C, generator=g)  # pads to 14: masked windows
        xw, _ = window_partition(x, 7)
        valid, _ = window_partition(torch.ones(2, 10, 10, 1), 7)
        xw, valid = xw.reshape(-1, 49, C).to(dev, dtype), valid.reshape(-1, 49, 1).to(dev)
    else:
        blk = Block(C, nH, 4.0, 0, (16, 16))
        xw, valid = torch.randn(2, 256, C, generator=g).to(dev, dtype), None
    init_module_(blk, g)
    blk = blk.hold_weights_in_(dtype).to(dev)
    hw = (7, 7) if kind == "window" else (16, 16)
    with torch.no_grad():
        if kind == "window":
            got = fwb.fused_window_block(xw, valid, blk, hw, nH)
            ref = fwb.fused_window_block_plain(xw.float(), valid, blk, hw, nH)
        else:
            got = fwb.fused_global_block(xw, blk, hw, nH)
            ref = fwb.fused_global_block_plain(xw.float(), blk, hw, nH)
    torch.cuda.synchronize()
    _held(got, ref, dtype)


def test_encoder_on_card_matches_cpu(dev):
    """A small ViT (2 blocks, 128 wide, 16 x 16 tokens padded to 21 for 7 x 7
    windows) through the whole encoder: card f32 against CPU f32."""
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig, preprocess
    cfg = SamConfig(embed_dim=128, depth=2, num_heads=2, window_size=7,
                    global_attn_indexes=(1,), img_size=256)
    sam = Sam(cfg).init_(torch.Generator().manual_seed(4)).eval()
    img = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(5)) * 255
    ref = sam.encode_image(preprocess(img, 256))
    got = sam.to(dev).encode_image(preprocess(img.to(dev), 256))
    torch.cuda.synchronize()
    rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-4, rel


def test_get_sam_model_defaults_to_the_card(dev):
    from micro_sam_tpu_torch.util import get_sam_model
    p = get_sam_model("vit_b")
    assert p.device.type == "cuda" and p.model.config.compute_dtype == "bfloat16"
