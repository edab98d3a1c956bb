"""The counts from shapes equal the hand counts."""
import json
import os

import pytest

from conftest import ROOT

from chipbench.counts import h100, shapes


def _conf(name):
    with open(os.path.join(ROOT, "chipbench", "configs", f"{name}.json"),
              encoding="utf-8") as f:
        return json.load(f)


def test_gpt2l_model_flops():
    m = _conf("gpt2-l")
    assert sum(shapes.leaves(m)) == 1_072_469_760
    assert shapes.active_params(m) == 1_072_469_760 - 64_328_960
    # 6 N T + 12 L d S T at 4 x 1024
    want = 6 * 1_008_140_800 * 4096 + 12 * 36 * 1280 * 1024 * 4096
    assert shapes.model_flops(m, 4, 1024) == want
    assert want == pytest.approx(2.709e13, rel=1e-3)
    assert want / h100.PEAK_BF16_FLOPS == pytest.approx(27.4e-3, rel=1e-2)


def test_dsmoe_model_flops():
    m = _conf("deepseek-moe-16b-l2")
    per_layer = (4 * 2048 * 2048 + 6 * 3 * 2048 * 1408
                 + 2 * 3 * 2048 * 1408 + 2048 * 64 + 2 * 2048)
    n = 2 * per_layer + 2048 * 102400 + 2048
    assert shapes.active_params(m) == n
    assert shapes.model_flops(m, 2, 4096) == pytest.approx(2.04e13,
                                                           rel=2e-3)


def test_kernel_bytes_of_full_gpt2l():
    m = _conf("gpt2-l")
    state = 12 * 1_072_469_760          # f32 params and both moments
    assert 2 * state == 2 * 12_869_637_120
    payload = 1_047_336 * 11 * (4 + 4)  # f32 values, int32 indices
    assert shapes.k4_bytes(m, 0.01) == 2 * 12_869_637_120 + payload \
        == 25_831_439_808
    # the kernel table's bounds: K4 7.7109 ms, K1 1.3081 ms, K3 8.9639 ms
    assert shapes.k4_bytes(m, 0.01) / h100.HBM_BW * 1e3 == \
        pytest.approx(7.7109, abs=1e-4)
    assert shapes.k1_bytes(m, 0.01) / h100.HBM_BW * 1e3 == \
        pytest.approx(1.3081, abs=1e-4)
    assert shapes.k3_bytes(m) / h100.HBM_BW * 1e3 == \
        pytest.approx(8.9639, abs=1e-4)


def test_wire_bytes_of_a_differential():
    """The store keeps indices at 2 B: 69,124,176 B a gpt2-l step."""
    from chipbench.reference.optim import BLOCK, k_for
    m = _conf("gpt2-l")
    nb = sum(-(-n // BLOCK) for n in shapes.leaves(m))
    assert nb == 1_047_336
    assert nb * k_for(0.01) * (4 + 2) == 69_124_176


#: the weight layouts the two configurations' families give, pinned:
#: every name, shape and init, in order
LAYOUTS = {
    "gpt2-l": {
        "embed": ((50257, 1280), "embed"),
        "final_norm": ((1280,), "ones"),
        "layers.attn.wk": ((36, 1280, 1280), "normal"),
        "layers.attn.wo": ((36, 1280, 1280), "normal"),
        "layers.attn.wq": ((36, 1280, 1280), "normal"),
        "layers.attn.wv": ((36, 1280, 1280), "normal"),
        "layers.attn_norm": ((36, 1280), "ones"),
        "layers.ffn.wd": ((36, 5120, 1280), "normal"),
        "layers.ffn.wg": ((36, 1280, 5120), "normal"),
        "layers.ffn.wu": ((36, 1280, 5120), "normal"),
        "layers.ffn_norm": ((36, 1280), "ones"),
        "lm_head": ((1280, 50257), "normal"),
    },
    "deepseek-moe-16b-l2": {
        "embed": ((102400, 2048), "embed"),
        "final_norm": ((2048,), "ones"),
        "layers.attn.wk": ((2, 2048, 2048), "normal"),
        "layers.attn.wo": ((2, 2048, 2048), "normal"),
        "layers.attn.wq": ((2, 2048, 2048), "normal"),
        "layers.attn.wv": ((2, 2048, 2048), "normal"),
        "layers.attn_norm": ((2, 2048), "ones"),
        "layers.ffn_norm": ((2, 2048), "ones"),
        "layers.moe.router": ((2, 2048, 64), "normal"),
        "layers.moe.we_d": ((2, 64, 1408, 2048), "normal"),
        "layers.moe.we_g": ((2, 64, 2048, 1408), "normal"),
        "layers.moe.we_u": ((2, 64, 2048, 1408), "normal"),
        "layers.moe.ws_d": ((2, 2816, 2048), "normal"),
        "layers.moe.ws_g": ((2, 2048, 2816), "normal"),
        "layers.moe.ws_u": ((2, 2048, 2816), "normal"),
        "lm_head": ((2048, 102400), "normal"),
    },
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_weight_layout_pinned(name):
    from chipbench.reference import decoder
    got = decoder.param_shapes(_conf(name))
    assert list(got.items()) == list(LAYOUTS[name].items())
