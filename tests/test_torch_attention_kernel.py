"""Attention's blocked kernels (``kernels/attention.py``,
``kernels/csrc/attention_triton.py``) through their plain versions on
the CPU: ``ref.attention_blocked_ref`` and ``attention_blocked_bwd_ref``
repeat the kernels' tiles, rounding points, three-term split of dS and
backward formulas. Held here against ``models/ops.py::attention``'s plain
body (one key tile: the same computation up to summation order; the
hand-written backward against autograd of that body for causal,
windowed, GQA, MLA-width and cross-attention shapes) and, with the JAX
package's 512 x 1024 tiles, against ``repro.models.ops.attention`` at S
2048 and 4096. The card's tests are in ``test_torch_attention_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ops as jops
from repro_torch.kernels import attention as ka
from repro_torch.kernels import build, ref
from repro_torch.models import ops


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


#: name -> (B, Sq, Sk, H, KV, D, Dv, causal, window): causal, GQA with a
#: window (Hymba's group of 5), MLA's widths (d_qk 192 = 128 + 64, d_v
#: 128, cut to 48 / 32 here), non-causal cross-attention (Sq != Sk), and
#: lengths that no tile divides
SHAPES = {
    "causal": (2, 100, 100, 4, 4, 16, 16, True, 0),
    "gqa_window": (1, 150, 150, 5, 1, 32, 32, True, 37),
    "mla_widths": (1, 130, 130, 2, 2, 48, 32, True, 0),
    "cross": (2, 70, 23, 4, 2, 16, 16, False, 0),
}


def _inputs(shape, dtype, seed=0):
    B, Sq, Sk, H, KV, D, Dv, _, _ = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g).to(dtype)
    k = (2 * torch.randn(B, Sk, KV, D, generator=g)).to(dtype)
    v = torch.randn(B, Sk, KV, Dv, generator=g).to(dtype)
    do = torch.randn(B, Sq, H, Dv, generator=g).to(dtype)
    return q, k, v, do


def _scaled(q):
    return q * ops.as_dtype(q.shape[-1] ** -0.5, q.dtype)


def _body(q, k, v, shape):
    """``ops.attention``'s plain body (CPU tensors never leave it)."""
    causal, window = SHAPES[shape][7:]
    return ops.attention(q, k, v, causal=causal, window=window)


def _gap(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_blocked_ref_is_the_body_within_one_key_tile(shape, dtype):
    """With every key in one tile, the blocked forward is the plain body:
    the same f32 scores, max, exp, bf16 rounding of p and f32 sums, up to
    their order (bf16: equal or one rounding apart, ``rounded_apart``;
    f32: 2^-20 of the output's norm). Smaller tiles round p against each
    tile's running max, not the final one: in bf16 p can land one
    rounding apart, so the output stays within 2^-8 of its norm (measured
    ~1e-3); in f32 nothing is rounded and 2^-20 holds."""
    q, k, v, _ = _inputs(shape, dtype)
    causal, window = SHAPES[shape][7:]
    want = _body(q, k, v, shape)
    for bm, bn in ((64, 512), (32, 16)):
        o, lse, o32 = ref.attention_blocked_ref(
            _scaled(q), k, v, causal=causal, window=window, block_m=bm,
            block_n=bn)
        assert o.dtype == dtype and lse.shape == (q.shape[0], q.shape[2],
                                                  q.shape[1])
        if dtype == torch.float32:
            assert _gap(o, want) < 2.0 ** -20
        elif bn >= q.shape[1]:
            ratio, _ = ref.rounded_apart(o, want)
            assert ratio <= 1.0
        else:
            assert _gap(o, want) < 2.0 ** -8
        assert torch.equal(o32.to(dtype), o)


@pytest.mark.parametrize("S,window", [(2048, 0), (4096, 0), (2048, 700)])
def test_blocked_ref_with_jax_tiles_matches_jax_attention(S, window):
    """With the JAX package's tiles (512 query rows, 1024 keys) the plain
    version is the reference's algorithm: at most 0.5% of the bf16
    outputs differ from the JAX function's (measured 0.06-0.09%: XLA's
    exp and sums in another order flip a bf16 rounding of p or of the
    output) and the gap is within 2^-12 of the output's norm (measured
    5e-5 to 7e-5). The plain body, one tile with p rounded against the
    final max, differs in 4-13% of the elements at these lengths and
    lies 8-11x further off."""
    H, KV, D = 2, 1, 32
    rng = np.random.default_rng(S + window)
    qn = rng.standard_normal((1, S, H, D), dtype=np.float32)
    kn = 2 * rng.standard_normal((1, S, KV, D), dtype=np.float32)
    vn = rng.standard_normal((1, S, KV, D), dtype=np.float32)
    want = torch.from_numpy(np.array(jops.attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn)), causal=True,
        window=window).astype(jnp.float32)))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn))
    o, _, _ = ref.attention_blocked_ref(_scaled(q), k, v, causal=True,
                                        window=window, block_m=512,
                                        block_n=1024)
    share = float((o.float() != want).float().mean())
    assert share <= 0.005 and _gap(o, want) <= 2.0 ** -12
    body = ops.attention(q, k, v, window=window)
    assert float((body.float() != want).float().mean()) > 10 * share
    assert _gap(body, want) > 5 * _gap(o, want)


def _autograd_of_body(q, k, v, do, shape):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _body(*leaves, shape).backward(do)
    return [t.grad for t in leaves]


def _blocked_grads(q, k, v, do, shape, tiles=None):
    causal, window = SHAPES[shape][7:]
    t = tiles or {"fwd": (32, 16), "dq": (32, 16), "dkdv": (16, 32)}
    qr = _scaled(q)
    _, lse, o32 = ref.attention_blocked_ref(qr, k, v, causal=causal,
                                            window=window,
                                            block_m=t["fwd"][0],
                                            block_n=t["fwd"][1])
    dq, dk, dv = ref.attention_blocked_bwd_ref(
        qr, k, v, o32, lse, do, causal=causal, window=window,
        dq_tiles=t["dq"], dkdv_tiles=t["dkdv"])
    # qr = q * scale: the scale's product stays autograd's, as it is
    return dq * ops.as_dtype(q.shape[-1] ** -0.5, q.dtype), dk, dv


@pytest.mark.parametrize("shape", list(SHAPES))
def test_blocked_backward_is_autograd_of_the_body_f32(shape):
    """In f32 the hand-written backward (delta = rowsum(do * o), ds = p
    (dp - delta), dS split in three, dK and dV summed over the group's
    heads) is autograd's gradient of the plain body: each of dq, dk, dv
    within 2^-18 of its norm (measured ~4e-7: sums in other orders)."""
    q, k, v, do = _inputs(shape, torch.float32)
    want = _autograd_of_body(q, k, v, do, shape)
    for got, w in zip(_blocked_grads(q, k, v, do, shape), want):
        assert got.shape == w.shape and got.dtype == w.dtype
        assert _gap(got, w) < 2.0 ** -18


def _f64_grads(q, k, v, do, shape):
    return _autograd_of_body(q.double(), k.double(), v.double(),
                             do.double(), shape)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_blocked_backward_is_autograd_of_the_body_bf16(shape):
    """In bf16 both round each gradient to bf16 once at its end. The body
    also rounds dP to bf16 and multiplies dS and p once rounded; the
    kernels keep dP f32, take dS as its exact split and p to 16 bits in
    dV. So the two lie within 2^-7 of each gradient's norm of each other
    (measured 2.8e-3 to 3.7e-3), and the kernels' gradients are no
    further from the f64 gradient of the same bf16 inputs than the
    body's (within 10%; measured 3-30% closer): no operand is rounded
    below the body's."""
    q, k, v, do = _inputs(shape, torch.bfloat16)
    want = _autograd_of_body(q, k, v, do, shape)
    exact = _f64_grads(q, k, v, do, shape)
    for got, w, e in zip(_blocked_grads(q, k, v, do, shape), want, exact):
        assert got.dtype == torch.bfloat16
        assert _gap(got, w) < 2.0 ** -7
        assert _gap(got, e) <= 1.1 * _gap(w, e)


def test_ds_split_keeps_f32_precision(monkeypatch):
    """dS enters dq and dk as its exact three-term split: on bf16 values
    held in f32 (so no final rounding hides it) the split's dq and dk lie
    within 2^-18 of the f64 gradient of the same values, where dS rounded
    once to bf16 (hi alone) puts them ~1e-3 off."""
    shape = "gqa_window"
    q, k, v, do = (t.float() for t in _inputs(shape, torch.bfloat16, 3))
    exact = _f64_grads(q, k, v, do, shape)
    split = _blocked_grads(q, k, v, do, shape)
    real = ref._split3_parts
    monkeypatch.setattr(ref, "_split3_parts", lambda x: (
        real(x)[0], torch.zeros_like(x), torch.zeros_like(x)))
    once = _blocked_grads(q, k, v, do, shape)
    for i in (0, 1):
        assert _gap(split[i], exact[i]) < 2.0 ** -18
        assert _gap(once[i], exact[i]) > 2.0 ** -12


def test_function_on_the_cpu_runs_the_plain_versions():
    """``kernels.attention.attention`` on CPU tensors: forward and
    backward are the plain versions with the table's tiles, and nothing
    launches."""
    shape = "gqa_window"
    q, k, v, do = _inputs(shape, torch.bfloat16)
    causal, window = SHAPES[shape][7:]
    qr = _scaled(q)
    before = dict(build.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (qr, k, v)]
    out = ka.attention(*leaves, causal=causal, window=window)
    out.backward(do)
    t = ka.tiles(q.shape[-1])
    o, lse, o32 = ref.attention_blocked_ref(
        qr, k, v, causal=causal, window=window, block_m=t["fwd"][0],
        block_n=t["fwd"][1])
    want = ref.attention_blocked_bwd_ref(
        qr, k, v, o32, lse, do, causal=causal, window=window,
        dq_tiles=t["dq"][:2], dkdv_tiles=t["dkdv"][:2])
    assert torch.equal(out, o)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert torch.equal(ka.attention(qr, k, v, causal=causal,
                                        window=window), o)
    assert build.LAUNCHES == before


def test_cpu_fake_and_f32_keep_the_plain_body(monkeypatch):
    """Only bf16 CUDA tensors take the kernels: CPU tensors in bf16 and
    f32 and the dry run's fake tensors keep the plain body."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **kw):
        raise AssertionError("kernel path taken")
    monkeypatch.setattr(ka.Attention, "apply", refuse)
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, _ = _inputs("causal", dt)
        assert ops.attention(q, k, v).shape == q.shape
    with FakeTensorMode():
        q = torch.empty(2, 64, 4, 16, dtype=torch.bfloat16)
        assert ops.attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("d,want", [(64, (64, 0)), (128, (128, 0)),
                                    (192, (128, 64)), (160, (128, 32)),
                                    (80, (64, 16)), (72, (128, 0)),
                                    (8, (16, 0)), (256, (256, 0))])
def test_head_split(d, want):
    """Head widths as the kernels take them: two powers of two of at
    least 16 with no padding where d is their sum, else one padded."""
    assert ka.head_split(d) == want
    assert sum(want) >= d


@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 100, 300, 300), (True, 64, 257, 257),
    (False, 0, 70, 23), (False, 0, 23, 70)])
def test_live_ranges_hold_every_live_pair(causal, window, Sq, Sk):
    """The tile ranges both kernels walk (``attention_key_range`` per
    query tile, ``attention_query_range`` per key tile) hold every
    (query, key) pair the mask lets through; the tiles they skip hold
    none."""
    bm, bn = 64, 32
    ok = ref._attn_live(0, Sq, 0, Sk, causal, window, "cpu")
    seen = torch.zeros_like(ok)
    for m0 in range(0, Sq, bm):
        lo, hi = ref.attention_key_range(m0, bm, bn, Sk, causal, window)
        assert lo % bn == 0
        seen[m0:m0 + bm, lo:hi] = True
    assert bool(seen[ok].all())
    seen.zero_()
    for n0 in range(0, Sk, bn):
        lo, hi = ref.attention_query_range(n0, bm, bn, Sq, causal, window)
        assert lo % bm == 0
        seen[lo:hi, n0:n0 + bn] = True
    assert bool(seen[ok].all())
    if causal:
        skipped = Sq * Sk - int(seen.sum())
        assert skipped > 0
