"""The loss head's tensor-core path (``models/ops.py::_TensorCoreXent``,
``kernels/xent.py``) on the CPU: the three-term bf16 split of an f32
gradient is exact, the split GEMMs keep f32 precision where one bf16
rounding would not, the row kernels' plain versions form autograd's
gradient, and the Function's loss, dh and dW agree with the up-cast path
for f32 and bf16 head weights, with and without a mask, tied and untied,
one chunk and several. On the CPU the Function runs its GEMMs as f32
products of the bf16 terms and its row kernels as their plain versions,
which is the card's arithmetic up to the order of f32 sums. The ``card``
tests hold the CUDA kernels and the whole head against the same on the
card (``python -m pytest -m card tests/test_torch_loss_head.py``) and
skip here."""
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import xent as kx
from repro_torch.models import ops

#: bf16 keeps 8 significant bits: its spacing is 2^-7 of the power of
#: two at or below a value, so at most 2^-7 of the value
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _split_inputs(kind: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(7)
    if kind == "normal":
        return torch.randn(4096, generator=g)
    if kind == "wide":          # |g| from 2^-100 to 2^100, both signs
        e = torch.randint(-100, 100, (4096,), generator=g).float()
        m = 1.0 + torch.rand(4096, generator=g)
        s = torch.where(torch.rand(4096, generator=g) < 0.5, -1.0, 1.0)
        return s * m * torch.exp2(e)
    if kind == "ties":          # exactly halfway between two bf16 values:
        # for hi (low 16 bits 0x8000), and for mid (low 16 bits 0x4000 |
        # 7 random bits | 0x40: a 9-bit residual whose last bit is a half)
        hi = torch.randint(0x3C00, 0x4400, (2048,), generator=g,
                           dtype=torch.int32) << 16
        a = (hi | 0x8000).view(torch.float32)
        b = (hi | 0x4000 | (torch.randint(0, 0x80, (2048,), generator=g,
                                          dtype=torch.int32) << 7) | 0x40
             ).view(torch.float32)
        return torch.cat([a, -a, b, -b])
    return torch.tensor([0.0, -0.0] * 8)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties", "zeros"])
def test_split3_reconstructs_f32_bit_for_bit(kind):
    """hi + mid + lo == g for every f32 g with |g| >= 2^-100 and for
    zeros. Left out: |g| < 2^-100, where lo can fall below bf16's
    normal range (2^-126) and be rounded again."""
    g = _split_inputs(kind)
    parts = ref.split3_bf16(g).float().reshape(3, -1)
    hi, mid, lo = parts
    assert torch.equal(_bits(hi), _bits(g.to(torch.bfloat16).float()))
    assert torch.equal((hi + mid) + lo, g)
    assert torch.equal(hi + (mid + lo), g)
    # each term is at most half an ulp of the one before it
    nz = hi != 0
    assert bool((mid[nz].abs() <= hi[nz].abs() * BF16_ULP / 2).all())
    if kind in ("normal", "wide", "ties"):
        # one bf16 rounding alone does lose bits
        assert not torch.equal(hi, g)


@pytest.mark.parametrize("product", ["dh", "dW"])
def test_split_gemm_keeps_f32_precision(product):
    """The backward's two products of the f32 gradient G with bf16
    operands, as the card forms them from G's split (f32 products of the
    bf16 terms, f32 sums): within f32 rounding of the exact (float64)
    product, where G rounded once to bf16 is off by ~2^-9 of it."""
    gen = torch.Generator().manual_seed(3)
    R, D, V = 48, 40, 300
    G = torch.randn(R, V, generator=gen) * 1e-3
    W = torch.randn(D, V, generator=gen).to(torch.bfloat16)
    H = torch.randn(R, D, generator=gen).to(torch.bfloat16)
    S = ref.split3_bf16(G)
    if product == "dh":
        d = ops._mm_f32(S, W.T)
        got = d[:R] + (d[R:2 * R] + d[2 * R:])
        exact = G.double() @ W.double().T
        once = ops._mm_f32(G.to(torch.bfloat16), W.T)
        k = V
    else:
        got = ops._mm_f32(torch.cat([H, H, H]).T, S)
        exact = H.double().T @ G.double()
        once = ops._mm_f32(H.T, G.to(torch.bfloat16))
        k = R
    scale = float(exact.abs().max())
    # f32 sums of k exact products: |error| <= k * 2^-24 of their scale
    f32_bound = k * 2.0 ** -24 * float(
        (G.double().abs().max() * (W if product == "dh" else H)
         .double().abs().max()))
    assert float((got.double() - exact).abs().max()) <= f32_bound
    assert float((once.double() - exact).abs().max()) > 64 * f32_bound
    assert f32_bound < 1e-4 * scale


def test_row_plain_versions_form_autograds_gradient():
    """``xent_grad_split_ref`` is the split of the gradient autograd
    forms for sum((logsumexp - gather) * mask) * dtot, bit for bit, and
    both plain versions ignore the padding columns."""
    gen = torch.Generator().manual_seed(5)
    R, V, ld = 12, 37, 40
    x = torch.randn(R, V, generator=gen) * 3
    xp = torch.nn.functional.pad(x, (0, ld - V))
    t = torch.randint(0, V, (R,), generator=gen, dtype=torch.int32)
    m = (torch.rand(R, generator=gen) > 0.3).float()
    dtot = torch.tensor([0.37])
    lse, tgt, loss = ref.xent_rows_ref(xp, t, m, V)
    xl = x.clone().requires_grad_(True)
    lse_a = torch.logsumexp(xl, dim=-1)
    loss_a = (lse_a - torch.gather(xl, -1, t[:, None].long())[:, 0]) * m
    assert torch.equal(lse, lse_a.detach())
    assert torch.equal(loss, loss_a.detach())
    assert torch.equal(tgt, x[torch.arange(R), t.long()])
    (gx,) = torch.autograd.grad(loss_a.sum(), xl,
                                grad_outputs=dtot.reshape(()))
    planes = ref.xent_grad_split_ref(xp, lse, t, m, dtot, V)
    assert planes.shape == (3 * R, ld) and planes.dtype == torch.bfloat16
    p = planes.float()
    g = (p[:R] + p[R:2 * R]) + p[2 * R:]
    assert torch.equal(g[:, :V], gx)
    assert not bool(g[:, V:].any())
    # the wrappers take the plain versions for CPU tensors and launch
    # nothing
    before = dict(build.LAUNCHES)
    assert torch.equal(kx.xent_grad_split(xp, lse, t, m, dtot, V), planes)
    assert all(torch.equal(a, b) for a, b in
               zip(kx.xent_rows(xp, t, m, V), (lse, tgt, loss)))
    assert build.LAUNCHES == before


def _head_case(wdt, tied, masked, B=2, S=32, D=48, V=203, seed=11):
    gen = torch.Generator().manual_seed(seed)
    h = (torch.randn(B, S, D, generator=gen)).to(torch.bfloat16)
    shape = (V, D) if tied else (D, V)
    w = (torch.randn(*shape, generator=gen) * 0.3).to(wdt)
    t = torch.randint(0, V, (B, S), generator=gen, dtype=torch.int32)
    mask = ((torch.rand(B, S, generator=gen) > 0.25).float() if masked
            else None)
    return h, w, t, mask


def _loss_grads(fn, h, w, t, mask, tied, chunk):
    h = h.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    mr = mask if mask is not None else torch.ones(t.shape, device=t.device)
    tot, cnt = fn(h, w.T if tied else w, t, mr, chunk)
    loss = tot / torch.clamp(cnt, min=1.0)
    dh, dw = torch.autograd.grad(loss, [h, w])
    return loss.detach(), dh, dw


def _upcast_terms(h, w, t, mask, tied, chunk):
    """Each chunk's dW on the up-cast path, last chunk first."""
    w = w.clone().requires_grad_(True)
    mr = mask if mask is not None else torch.ones(t.shape, device=t.device)
    return ops._xent_upcast_terms(h, w.T if tied else w, t, mr, chunk, w)


def _assert_rounded_alike(got, want, terms=None):
    """``got`` and ``want`` are roundings to bf16 (or sums of ``terms``,
    each such a rounding) of f32 values that differ only by the order of
    their f32 sums: an element may land on a neighbouring bf16 value,
    and rarely does. The bound of each element is
    ``ref.rounded_apart``'s: one bf16 spacing of it, or of each of its
    terms and partial sums."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ratio, share = ref.rounded_apart(got, want, terms)
    assert ratio <= 1.0, ratio
    assert share < 0.05, share


def _split_once(monkeypatch):
    """The control: the logit gradient rounded once to bf16 (hi alone,
    mid and lo zero) in place of its exact split."""
    split = kx.xent_grad_split

    def once(*args):
        planes = split(*args).clone()
        planes[planes.shape[0] // 3:] = 0
        return planes
    monkeypatch.setattr(ops.xent, "xent_grad_split", once)


@pytest.mark.parametrize("chunk", [8, 12, 32],
                         ids=["chunk<S", "chunk_short_end", "chunk==S"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["w_f32", "w_bf16"])
def test_function_matches_upcast_path(wdt, masked, tied, chunk):
    """The Function (split GEMMs and row kernels' plain versions) against
    today's up-cast path. The loss is an f32 sum in another order
    (2^-20 relative); dh is rounded to bf16 from f32 sums in another
    order, so an element may sit one bf16 ulp away; dW likewise for each
    of the chunk terms summed in the weight's dtype, and each partial sum
    may round to a neighbour. A chunk that does not divide S leaves a
    shorter last chunk."""
    h, w, t, mask = _head_case(wdt, tied, masked)
    up = _loss_grads(lambda *a: ops._xent_upcast(*a, True),
                     h, w, t, mask, tied, chunk)
    tc = _loss_grads(ops._TensorCoreXent.apply, h, w, t, mask, tied, chunk)
    assert torch.allclose(tc[0], up[0], rtol=2.0 ** -20, atol=0)
    _assert_rounded_alike(tc[1], up[1])
    _assert_rounded_alike(tc[2], up[2],
                          _upcast_terms(h, w, t, mask, tied, chunk))
    assert tc[2].dtype == wdt


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["w_f32", "w_bf16"])
def test_once_rounded_gradient_fails_the_comparison(wdt, monkeypatch):
    """The comparison above tells the exact split from a logit gradient
    rounded once to bf16: with that rounding both dh and dW fall outside
    its bounds."""
    h, w, t, mask = _head_case(wdt, False, True, S=64)
    up = _loss_grads(lambda *a: ops._xent_upcast(*a, True),
                     h, w, t, mask, False, 16)
    terms = _upcast_terms(h, w, t, mask, False, 16)
    _split_once(monkeypatch)
    tc = _loss_grads(ops._TensorCoreXent.apply, h, w, t, mask, False, 16)
    for got, want, parts in ((tc[1], up[1], None), (tc[2], up[2], terms)):
        ratio, share = ref.rounded_apart(got, want, parts)
        assert ratio > 1.0 or share >= 0.05, (ratio, share)


def test_head_operand_pads_to_eight_and_keeps_aligned_weights():
    w = torch.randn(6, 203)
    p = ops._head_operand(w, torch.bfloat16)
    assert p.shape == (6, 208) and p.dtype == torch.bfloat16
    assert torch.equal(p[:, :203], w.to(torch.bfloat16))
    assert not bool(p[:, 203:].any())
    tied = torch.randn(208, 6).to(torch.bfloat16).T     # a tied head
    assert ops._head_operand(tied, torch.bfloat16) is tied


def test_cpu_fake_and_f32_take_the_upcast_path(monkeypatch):
    """Only bf16 CUDA tensors take the tensor-core path: CPU tensors, an
    f32 compute dtype and the dry run's fake tensors keep the up-cast
    path (no launch, no Function)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a):
        raise AssertionError("tensor-core path taken")
    monkeypatch.setattr(ops._TensorCoreXent, "apply", refuse)
    h, w, t, _ = _head_case(torch.float32, False, False, S=16)
    before = dict(build.LAUNCHES)
    for x in (h, h.float()):
        tot, cnt = ops.chunked_softmax_xent(x, w, t, chunk=8)
        assert float(cnt) == t.numel()
    with FakeTensorMode():
        fh = torch.empty(2, 16, 48, dtype=torch.bfloat16)
        tot, _ = ops.chunked_softmax_xent(fh, torch.empty(48, 203),
                                          torch.empty(2, 16,
                                                      dtype=torch.int32),
                                          chunk=8)
        assert tot.shape == ()
    assert not ops._tensor_cores(h)
    assert build.LAUNCHES == before


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


CARD_SHAPES = {"dsmoe": (1, 512, 2048, 102400, torch.bfloat16),
               "gpt2l": (4, 512, 1280, 50257, torch.float32)}


@pytest.mark.card
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_card_row_kernels_match_their_plain_versions(shape):
    """``xent_rows`` against ``xent_rows_ref`` (lse's sum in another
    order: 2^-20 relative) and ``xent_grad_split`` against its plain
    version (the same f32 operations element by element: bitwise) at
    the benchmark's chunk shapes."""
    dev = _card()
    B, c, D, V, _ = CARD_SHAPES[shape]
    R, ld = B * c, -(-V // 8) * 8
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(R, ld, generator=gen, device=dev) * 4
    t = torch.randint(0, V, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    m = (torch.rand(R, generator=gen, device=dev) > 0.2).float()
    dtot = torch.tensor([1.0 / R], device=dev)
    n0 = dict(build.LAUNCHES)
    got = kx.xent_rows(x, t, m, V)
    want = ref.xent_rows_ref(x, t, m, V)
    assert torch.allclose(got[0], want[0], rtol=2.0 ** -20, atol=0)
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[2], want[2], rtol=2.0 ** -18, atol=2.0 ** -18)
    planes = kx.xent_grad_split(x, want[0], t, m, dtot, V)
    assert torch.equal(planes.view(torch.int16),
                       ref.xent_grad_split_ref(x, want[0], t, m, dtot, V)
                       .view(torch.int16))
    assert build.LAUNCHES["xent_rows"] == n0["xent_rows"] + 1
    assert build.LAUNCHES["xent_grad_split"] == n0["xent_grad_split"] + 1


@pytest.mark.card
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["w_f32", "w_bf16"])
def test_card_head_matches_upcast_path(wdt, tied):
    """The whole head on the card, tensor-core path against the up-cast
    path, as on the CPU (cuBLAS sums in its own order on both)."""
    dev = _card()
    h, w, t, mask = _head_case(wdt, tied, True, B=2, S=1024, D=256,
                               V=5003)
    h, w, t, mask = h.to(dev), w.to(dev), t.to(dev), mask.to(dev)
    n0 = dict(build.LAUNCHES)
    up = _loss_grads(lambda *a: ops._xent_upcast(*a, True),
                     h, w, t, mask, tied, 256)
    tc = _loss_grads(ops._TensorCoreXent.apply, h, w, t, mask, tied, 256)
    assert torch.allclose(tc[0], up[0], rtol=2.0 ** -18, atol=0)
    _assert_rounded_alike(tc[1], up[1])
    _assert_rounded_alike(tc[2], up[2],
                          _upcast_terms(h, w, t, mask, tied, 256))
    assert build.LAUNCHES["xent_rows"] == n0["xent_rows"] + 4
    assert build.LAUNCHES["xent_grad_split"] == n0["xent_grad_split"] + 4


@pytest.mark.card
def test_card_once_rounded_gradient_fails_the_comparison(monkeypatch):
    """On the card too, a logit gradient rounded once to bf16 falls
    outside the bounds that the exact split meets (bf16 head weight, as
    DeepSeekMoE's)."""
    dev = _card()
    h, w, t, mask = _head_case(torch.bfloat16, False, True, B=2, S=1024,
                               D=256, V=5003)
    h, w, t, mask = h.to(dev), w.to(dev), t.to(dev), mask.to(dev)
    up = _loss_grads(lambda *a: ops._xent_upcast(*a, True),
                     h, w, t, mask, False, 256)
    terms = _upcast_terms(h, w, t, mask, False, 256)
    _split_once(monkeypatch)
    tc = _loss_grads(ops._TensorCoreXent.apply, h, w, t, mask, False, 256)
    for got, want, parts in ((tc[1], up[1], None), (tc[2], up[2], terms)):
        ratio, share = ref.rounded_apart(got, want, parts)
        assert ratio > 1.0 or share >= 0.05, (ratio, share)
