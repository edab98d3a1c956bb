"""The port's chunkwise linear-attention engine (``models/linear_attn``)
against the JAX reference on the CPU: ``chunked`` against the reference
``chunked`` and against both packages' ``reference_scan`` for every
stabilize/normalize combination, multi-chunk sequences, an initial
state, the final state and gradients; ``decode_step`` against the
reference's; and the intra-chunk mask applied before the exponential."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_attn as jla
from repro_torch.models import linear_attn as la

B, H, N, P = 2, 3, 4, 5
MODES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(S, stabilize, seed=0, with_state=False):
    """q, k, v, log_decay, log_in (numpy f32) and an optional state. The
    mLSTM's gates (stabilize): a log-sigmoid forget gate and an
    unbounded exponential input gate; Mamba's: dt·A <= 0 and no input
    gate."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, S, H, N), f(B, S, H, N) / 2, f(B, S, H, P)
    if stabilize:
        ld = -np.logaddexp(0, -f(B, S, H) - 2).astype(np.float32)
        li = 2 * f(B, S, H)
    else:
        ld = -np.logaddexp(0, f(B, S, H)).astype(np.float32) * 0.5
        li = None
    st = None
    if with_state:
        st = (f(B, H, N, P), np.abs(f(B, H, N)),
              (f(B, H) if stabilize else np.zeros((B, H), np.float32)))
    return q, k, v, ld, li, st


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(a, b, rel=2e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("stabilize,normalize", MODES)
@pytest.mark.parametrize("S,chunk", [(8, 8), (32, 8), (16, 32)])
def test_chunked_matches_reference_and_scans(stabilize, normalize, S, chunk):
    """Forward output and final state: the port's ``chunked`` against the
    reference's (same chunking, f32, within 2e-5 of the largest
    magnitude; the frameworks sum the einsums in different orders) and
    against both packages' step-by-step ``reference_scan``. (16, 32) is
    a single chunk of the whole sequence (W = min(chunk, S))."""
    q, k, v, ld, li, _ = _inputs(S, stabilize)
    kw = dict(normalize=normalize, stabilize=stabilize)
    y, st = la.chunked(*map(_t, (q, k, v, ld, li)), chunk=chunk,
                       return_state=True, **kw)
    jy, jst = jla.chunked(*map(_j, (q, k, v, ld, li)), chunk=chunk,
                          return_state=True, **kw)
    _close(y, jy)
    for a, b in zip(st, jst):
        _close(a, b)
    ys, sts = la.reference_scan(*map(_t, (q, k, v, ld, li)), **kw)
    jys, jsts = jla.reference_scan(*map(_j, (q, k, v, ld, li)), **kw)
    _close(ys, jys)
    _close(y, ys)
    for a, b, c in zip(st, sts, jsts):
        _close(b, c)
        _close(a, b)     # the chunked carry is the stepwise state


@pytest.mark.parametrize("stabilize,normalize", MODES)
def test_initial_state_is_carried(stabilize, normalize):
    """A given initial state enters the first chunk as the reference's
    does, and running two halves with the state carried equals one run."""
    S, W = 32, 8
    q, k, v, ld, li, st = _inputs(S, stabilize, seed=1, with_state=True)
    kw = dict(normalize=normalize, stabilize=stabilize)
    y, fin = la.chunked(*map(_t, (q, k, v, ld, li)), chunk=W,
                        state=la.LinState(*map(_t, st)), return_state=True,
                        **kw)
    jy, jfin = jla.chunked(*map(_j, (q, k, v, ld, li)), chunk=W,
                           state=jla.LinState(*map(_j, st)),
                           return_state=True, **kw)
    _close(y, jy)
    for a, b in zip(fin, jfin):
        _close(a, b)
    h = S // 2
    cut = lambda x, s: None if x is None else x[:, s]  # noqa: E731
    first = slice(0, h)
    second = slice(h, S)
    y1, mid = la.chunked(*(_t(cut(x, first)) for x in (q, k, v, ld, li)),
                         chunk=W, state=la.LinState(*map(_t, st)),
                         return_state=True, **kw)
    y2 = la.chunked(*(_t(cut(x, second)) for x in (q, k, v, ld, li)),
                    chunk=W, state=mid, **kw)
    _close(torch.cat([y1, y2], dim=1), y)


@pytest.mark.parametrize("stabilize,normalize", MODES)
def test_chunked_gradients_match_reference(stabilize, normalize):
    """Gradients of a weighted sum of the output with respect to every
    input (q, k, v and both gates) against ``jax.grad`` of the
    reference, each within 1e-4 of its own largest magnitude (the
    tolerance of the model's gradient leaves)."""
    S, W = 32, 8
    q, k, v, ld, li, _ = _inputs(S, stabilize, seed=2)
    if li is None:
        li = np.zeros_like(ld)
    w = np.random.default_rng(9).normal(size=(B, S, H, P)).astype(np.float32)
    kw = dict(chunk=W, normalize=normalize, stabilize=stabilize)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v, ld, li)]
    loss = (la.chunked(*xs, **kw) * _t(w)).sum()
    grads = torch.autograd.grad(loss, xs)
    jgrads = jax.grad(lambda *a: (jla.chunked(*a, **kw) * w).sum(),
                      argnums=(0, 1, 2, 3, 4))(*map(_j, (q, k, v, ld, li)))
    for g, jg in zip(grads, jgrads):
        assert torch.isfinite(g).all()
        _close(g, jg, rel=1e-4)


@pytest.mark.parametrize("stabilize,normalize", MODES)
def test_decode_step_matches_reference(stabilize, normalize):
    q, k, v, ld, li, st = _inputs(1, stabilize, seed=3, with_state=True)
    kw = dict(normalize=normalize, stabilize=stabilize)
    args = [x[:, 0] if x is not None else None for x in (q, k, v, ld, li)]
    s2, y = la.decode_step(la.LinState(*map(_t, st)), *map(_t, args), **kw)
    js2, jy = jla.decode_step(jla.LinState(*map(_j, st)), *map(_j, args),
                              **kw)
    assert y.dtype == torch.float32
    _close(y, jy, rel=1e-6)
    for a, b in zip(s2, js2):
        _close(a, b, rel=1e-6)


def test_mask_precedes_the_exponential():
    """Above the diagonal ``cum_t - cum_s + li_s - m_t`` overflows when
    the decay is strong and the input gate large: masking after ``exp``
    would give inf * 0 = NaN in the output and in every gradient. The
    port masks the exponent, as the reference does, and stays finite."""
    S, W = 16, 16
    q, k, v, _, _, _ = _inputs(S, True, seed=4)
    ld = np.full((B, S, H), -80.0, np.float32)      # cum spans 1280
    li = np.full((B, S, H), 60.0, np.float32)
    xs = [_t(x).requires_grad_(True) for x in (q, k, v, ld, li)]
    y = la.chunked(*xs, chunk=W, normalize=True, stabilize=True)
    grads = torch.autograd.grad(y.sum(), xs)
    assert torch.isfinite(y).all()
    assert all(torch.isfinite(g).all() for g in grads)
    jy = jla.chunked(*map(_j, (q, k, v, ld, li)), chunk=W, normalize=True,
                     stabilize=True)
    _close(y.detach(), jy)


def test_output_dtype_follows_q():
    """f32 inside, the output cast back to q's dtype (bf16 here)."""
    q, k, v, ld, li, _ = _inputs(16, True, seed=5)
    y = la.chunked(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(),
                   _t(ld), _t(li), chunk=8, normalize=True, stabilize=True)
    assert y.dtype == torch.bfloat16
    jy = jla.chunked(jnp.asarray(q, jnp.bfloat16),
                     jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), _j(ld), _j(li), chunk=8,
                     normalize=True, stabilize=True)
    # the same bf16 inputs, f32 inside: within one bf16 rounding
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32),
                               rtol=2 ** -7, atol=1e-6)
