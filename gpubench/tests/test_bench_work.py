"""The operation and byte counters against values worked by hand."""
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from harness import work  # noqa: E402


def config(name):
    with open(os.path.join(BENCH, "configs", f"sam_{name}.json")) as f:
        return json.load(f)


# per image, term by term: patch embed 2 T 768 C; a windowed block's qkv and
# proj on the 70 x 70 padded map (2 4900 C 4C), its attention on 25 windows
# of 196 (4 N^2 hd + 2 N (14 + 14) hd a head) and its MLP on 64 x 64
# (2 T C 4C 2); a global block the same on T = 4096 rows with N = 4096 and
# tables of 64 + 64; the neck 2 T C 256 + 2 T 256 256 9
VIT_B = (4_831_838_208 + 8 * (23_121_100_800 + 3_161_088_000 + 38_654_705_664)
         + 4 * (19_327_352_832 + 52_344_913_920 + 38_654_705_664)
         + 1_610_612_736 + 4_831_838_208)
VIT_H = (8_053_063_680 + 28 * (64_225_280_000 + 5_268_480_000 + 107_374_182_400)
         + 4 * (53_687_091_200 + 87_241_523_200 + 107_374_182_400)
         + 2_684_354_560 + 4_831_838_208)


@pytest.mark.parametrize("name, flops", [("vit_b", VIT_B), ("vit_h", VIT_H)])
def test_encoder_flops(name, flops):
    assert work.vit_encode_flops(config(name)) == flops


def test_vit_h_encode_is_about_six_teraflop():
    assert 5.9e12 < VIT_H < 6.0e12


def test_gemm_call():
    # vit_h's qkv product of one image's 4096 rows: 2 M N K operations; the
    # x, w and y tiles in bf16 once each and the f32 bias
    ops_ms, bytes_ms = work.call_ms(("gemm", 4096, 1280, 3840, 2, False))
    assert ops_ms == pytest.approx(2 * 4096 * 3840 * 1280 / 989e12 * 1e3)
    assert bytes_ms == pytest.approx(51_788_800 / 3.35e12 * 1e3)
    _, with_residual = work.call_ms(("gemm", 4096, 1280, 3840, 2, True))
    assert with_residual == pytest.approx((51_788_800 + 4096 * 3840 * 2) / 3.35e12 * 1e3)


def test_relpos_attention_calls():
    # one vit_h global block at batch 1: 16 heads of 80 over 4096 tokens
    ops_ms, bytes_ms = work.call_ms(("relpos_attention", 1, 16, 4096, 80, 64, 64, 2))
    assert ops_ms == pytest.approx(16 * (4 * 4096 ** 2 * 80 + 2 * 4096 * 128 * 80) / 989e12 * 1e3)
    assert bytes_ms == pytest.approx((4 * 16 * 4096 * 80 * 2 + 2 * 64 * 64 * 80 * 2)
                                     / 3.35e12 * 1e3)
    b_ops, _ = work.call_ms(("relpos_attention_backward", 1, 16, 4096, 80, 64, 64, 2))
    assert b_ops == pytest.approx(16 * (10 * 4096 ** 2 * 80 + 6 * 4096 * 128 * 80) / 989e12 * 1e3)


def test_bound_sums_each_calls_larger_term():
    calls = [("gemm", 4096, 1280, 3840, 2, False), ("layernorm", 4096, 1280, 2, False)]
    assert work.bound_ms(calls) == pytest.approx(sum(max(work.call_ms(c)) for c in calls))
    with pytest.raises(ValueError):
        work.call_ms(("conv", 1))
