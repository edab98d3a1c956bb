"""Attention's blocked kernels on the card (``kernels/attention.py``,
``kernels/csrc/attention_triton.py``) against their plain versions
(``ref.attention_blocked_ref`` and ``attention_blocked_bwd_ref``, the
same tiles, run on the card in f32 products), at the benchmark cells'
shapes and at the other families': Qwen2's GQA, Hymba's window and
group of 5, Seamless's non-causal encoder and cross-attention, Pixtral's
head of 160, and lengths no tile divides. Repeated runs give the same
bits (no float atomics), and one training step of each cell's
configuration launches each kernel the counted number of times. Every
test here skips without a card:

    python3 -m pytest -m card tests/test_torch_attention_card.py
"""
import json
import os
import sys

import pytest
import torch

from repro_torch.core import steps
from repro_torch.kernels import attention as ka
from repro_torch.kernels import build, ref
from repro_torch.models import ops
from repro_torch.models.registry import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (B, Sq, Sk, H, KV, D, Dv, causal, window)
SHAPES = {
    "gpt2l": (4, 1024, 1024, 20, 20, 64, 64, True, 0),
    "dsmoe": (1, 4096, 4096, 16, 16, 128, 128, True, 0),
    "dsv2lite": (1, 4096, 4096, 16, 16, 192, 128, True, 0),
    "qwen2_gqa": (1, 2048, 2048, 12, 2, 128, 128, True, 0),
    "hymba_window": (1, 2048, 2048, 25, 5, 64, 64, True, 1024),
    "seamless_encoder": (4, 16, 16, 16, 16, 64, 64, False, 0),
    "seamless_cross": (4, 64, 16, 16, 16, 64, 64, False, 0),
    "pixtral_160": (1, 300, 300, 4, 1, 160, 160, True, 0),
    "ragged_window": (2, 1000, 1000, 4, 2, 128, 128, True, 333),
}

#: the f32 output's norm gap: both sum f32 products of the same bf16
#: values in other orders, the kernel's exp is ex2.approx (2 ulp), and a
#: p that lands by a rounding boundary rounds to the other bf16 value
#: (measured <= 3.7e-5)
O32_TOL = 2.0 ** -12
#: lse, absolute: one approximate exp and log on each side (<= 3.8e-6)
LSE_TOL = 2.0 ** -16
#: bf16 outputs and gradients, norm gaps: the above, then one rounding
#: to bf16 each, which flips to the neighbouring value on a share of the
#: elements (2^-8 of each at most; measured <= 2.7e-4)
BF16_TOL = 2.0 ** -10


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, dev, seed=0):
    B, Sq, Sk, H, KV, D, Dv, _, _ = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(B, Sq, H, D, generator=g, device=dev)
         * D ** -0.5).to(torch.bfloat16)
    k = (2 * torch.randn(B, Sk, KV, D, generator=g, device=dev)).to(
        torch.bfloat16)
    v = torch.randn(B, Sk, KV, Dv, generator=g, device=dev).to(torch.bfloat16)
    do = torch.randn(B, Sq, H, Dv, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, do


def _gap(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _run(q, k, v, do, causal, window):
    o, lse, o32 = ka.attn_fwd(q, k, v, causal, window, True)
    return (o, lse, o32) + ka.attn_bwd(q, k, v, o32, lse, do, causal, window)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_card_kernels_match_plain_versions(shape):
    """Forward and backward against the plain versions with the same
    tiles (tolerances above), and a second run bitwise equal to the
    first."""
    dev = _card()
    causal, window = SHAPES[shape][7:]
    q, k, v, do = _inputs(shape, dev)
    n0 = dict(build.LAUNCHES)
    got = _run(q, k, v, do, causal, window)
    assert {n: build.LAUNCHES[n] - n0[n] for n in
            ("attn_fwd", "attn_bwd_dq", "attn_bwd")} == dict.fromkeys(
        ("attn_fwd", "attn_bwd_dq", "attn_bwd"), 1)
    t = ka.tiles(q.shape[-1])
    ro, rlse, ro32 = ref.attention_blocked_ref(
        q, k, v, causal=causal, window=window, block_m=t["fwd"][0],
        block_n=t["fwd"][1])
    want = (ro, rlse, ro32) + ref.attention_blocked_bwd_ref(
        q, k, v, ro32, rlse, do, causal=causal, window=window,
        dq_tiles=t["dq"][:2], dkdv_tiles=t["dkdv"][:2])
    o, lse, o32, dq, dk, dv = got
    assert _gap(o32, ro32) <= O32_TOL
    assert float((lse - rlse).abs().max()) <= LSE_TOL
    for name, a, b in (("o", o, ro), ("dq", dq, want[3]),
                       ("dk", dk, want[4]), ("dv", dv, want[5])):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert _gap(a, b) <= BF16_TOL, (name, _gap(a, b))
    again = _run(q, k, v, do, causal, window)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.card
def test_card_route_takes_the_kernels_for_bf16_only():
    """``ops.attention`` launches the forward kernel for bf16 on the card
    and keeps the plain body for f32."""
    dev = _card()
    q, k, v, _ = _inputs("qwen2_gqa", dev)
    n0 = build.LAUNCHES["attn_fwd"]
    ops.attention(q, k, v)
    assert build.LAUNCHES["attn_fwd"] == n0 + 1
    ops.attention(q.float(), k.float(), v.float())
    assert build.LAUNCHES["attn_fwd"] == n0 + 1


#: cell -> (configuration file, batch, seq)
CELLS = {"gpt2l": ("gpt2-l", 4, 1024),
         "dsmoe": ("deepseek-moe-16b-l2", 2, 4096),
         "dsv2lite": ("deepseek-v2-lite-l5", 2, 4096)}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELLS))
def test_card_training_step_launch_counts(cell):
    """One training step of each cell's configuration launches the
    forward kernel layers x micro-batches x 2 times (forward and remat's
    recompute) and each backward kernel layers x micro-batches times:
    72 / 36 for gpt2-l, 8 / 4 for DeepSeekMoE, 20 / 10 for
    DeepSeek-V2-Lite."""
    dev = _card()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from chipbench import inputs, program
    name, B, S = CELLS[cell]
    with open(os.path.join(ROOT, "chipbench", "configs", f"{name}.json"),
              encoding="utf-8") as f:
        cfg = program.arch_config(json.load(f))
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = next(inputs.Batches(cfg.vocab, B, S, 1, dev))
    n0 = dict(build.LAUNCHES)
    loss, _, _ = steps._grads(model, params, batch, cfg.grad_accum)
    assert torch.isfinite(loss)
    calls = cfg.n_layers * cfg.grad_accum
    assert cfg.remat
    got = {n: build.LAUNCHES[n] - n0[n]
           for n in ("attn_fwd", "attn_bwd_dq", "attn_bwd")}
    assert got == {"attn_fwd": 2 * calls, "attn_bwd_dq": calls,
                   "attn_bwd": calls}
