"""The port's kernels (their plain versions, which the CUDA kernels are
held to bit for bit on the card by ``chip_smoke.py``) against the JAX
reference's Pallas kernels run in interpret mode, on the same numpy
inputs. K1/K2 must agree exactly. K3/K4 must agree within two ulps of
the terms each result sums (:func:`assert_adam_close`): XLA contracts
``b1*mu + (1-b1)*g`` into an fma on the CPU while the port rounds every
product (as its CUDA kernels, built with --fmad=false, do), so the two
differ by one rounding of a product — one ulp of the larger term, which
is many ulps of a sum that cancels; and the bias corrections are an f32
``pow`` in each framework, which may round one ulp apart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression.sparse import SparseGrad as JaxSparse
from repro.kernels import ops as jops
from repro_torch.compression.sparse import SparseGrad, k_for
from repro_torch.kernels import (build, fused_adam, ops, ref, replay, span,
                                 topk)

HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _x(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "ties":        # few distinct magnitudes: exact ties
        return rng.integers(-3, 4, n).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    x[1024:3 * 1024] = 0.0    # two all-zero blocks
    return x


CASES = [(kind, n, k) for kind in ("normal", "ties", "zeros")
         for n in (2500, 4 * 1024) for k in (1, 11, 103)]


@pytest.mark.parametrize("kind,n,k", CASES)
def test_topk_select_and_scatter_match_pallas(kind, n, k):
    x = _x(kind, n)
    rho = k / 1024
    assert k_for(rho) == k
    sg = ops.topk_compress(torch.from_numpy(x), rho)
    jsg = jops.topk_compress(jnp.asarray(x), rho, use_pallas=True)
    np.testing.assert_array_equal(sg.indices.numpy(), np.asarray(jsg.indices))
    np.testing.assert_array_equal(sg.values.numpy(), np.asarray(jsg.values))
    assert sg.values.shape == (-(-n // 1024), k)
    dense = ops.topk_decompress(sg)
    jdense = jops.topk_decompress(jsg, use_pallas=True)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))


def test_topk_bf16_matches_pallas():
    x = _x("normal", 3000, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    sg = ops.topk_compress(xt, 0.01)
    jsg = jops.topk_compress(xj, 0.01, use_pallas=True)
    np.testing.assert_array_equal(sg.indices.numpy(), np.asarray(jsg.indices))
    np.testing.assert_array_equal(sg.values.float().numpy(),
                                  np.asarray(jsg.values.astype(jnp.float32)))


def _state(n, seed=1):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    mu = (rng.standard_normal(n) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    return p, g, mu, nu


def assert_adam_close(out, ref_out, p, g, mu, nu, hyper):
    """(p', mu', nu') of two Adam implementations agree within two ulps
    of the terms of each sum (one for the product rounding, one for the
    bias corrections), propagated into p' through the step."""
    h = np.asarray(hyper, np.float64)[0]
    lr, b1, b2, eps, c1, c2, om1, om2 = h
    ulp = lambda t: np.spacing(np.abs(t).astype(np.float32)).astype(np.float64)  # noqa: E731
    a = [np.asarray(x, np.float64) for x in out]
    b = [np.asarray(x, np.float64) for x in ref_out]
    tol_mu = 2 * ulp(np.abs(b1 * mu) + np.abs(om1 * g))
    tol_nu = 2 * ulp(b2 * nu + om2 * g * g)
    den = np.sqrt(b[2] / c2) + eps
    step = lr * (b[1] / c1) / den
    tol_p = (2 * ulp(np.abs(p) + np.abs(step))
             + lr / c1 * tol_mu / den
             + np.abs(step) * tol_nu / (2 * np.maximum(b[2], 1e-30)))
    for x, y, tol in zip(a, b, (tol_p, tol_mu, tol_nu)):
        assert np.all(np.abs(x - y) <= tol), float(np.max(np.abs(x - y) - tol))


def _hyper(count):
    mine = ops.adam_hyper_traced(count=torch.tensor(count, dtype=torch.int32),
                                 **HYPER)
    theirs = jops.adam_hyper_traced(count=count, **HYPER)
    return mine, theirs


def test_hyper_row_matches_reference():
    for count in (1, 3, 1000):
        mine, theirs = _hyper(count)
        np.testing.assert_array_max_ulp(mine.numpy(), np.asarray(theirs),
                                        maxulp=1)
        # lr, b1, b2, eps and the pre-rounded complements are exact
        idx = [0, 1, 2, 3, 6, 7]
        np.testing.assert_array_equal(mine.numpy()[0, idx],
                                      np.asarray(theirs)[0, idx])


@pytest.mark.parametrize("n", [999, 4096])
def test_adam_tile_update_matches_pallas(n):
    p, g, mu, nu = _state(n)
    mine_h, jax_h = _hyper(3)
    out = fused_adam.adam_tile_update(*map(torch.from_numpy, (p, g, mu, nu)),
                                      mine_h)
    jout = jops.fused_adam_update(*map(jnp.asarray, (p, g, mu, nu)), jax_h,
                                  use_pallas=True)
    # K3 computes 1-b1 / 1-b2 in f32 (both packages' kernels do)
    h = mine_h.numpy().copy()
    h[0, 6:] = 1.0 - h[0, 1:3]
    assert_adam_close([t.numpy() for t in out], jout, p, g, mu, nu, h)


@pytest.mark.parametrize("n,k", [(2500, 11), (4096, 1), (4096, 103),
                                 (2500, 0)])
def test_topk_apply_matches_pallas(n, k):
    p, g, mu, nu = _state(n, seed=2)
    nb = -(-n // 1024)
    if k:
        sg = ops.topk_compress(torch.from_numpy(g), k / 1024)
        vals, idx = sg.values.numpy(), sg.indices.numpy()
    else:                       # hand-built empty payload (k_for never 0)
        vals = np.zeros((nb, 0), np.float32)
        idx = np.zeros((nb, 0), np.int32)
    mine_h, jax_h = _hyper(5)
    out = ops.fused_sparse_apply(
        SparseGrad(torch.from_numpy(vals), torch.from_numpy(idx), (n,)),
        *map(torch.from_numpy, (p, mu, nu)), mine_h)
    jout = jops.fused_sparse_apply(
        JaxSparse(jnp.asarray(vals), jnp.asarray(idx), (n,)),
        *map(jnp.asarray, (p, mu, nu)), jax_h, use_pallas=True)
    dense = np.asarray(jops.topk_decompress(
        JaxSparse(jnp.asarray(vals), jnp.asarray(idx), (n,)),
        use_pallas=False)) if k else np.zeros(n, np.float32)
    assert_adam_close([t.numpy() for t in out], jout, p, dense, mu, nu,
                      mine_h.numpy())


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor goes to the plain version: no launch is counted and
    the result is the plain version's, bit for bit."""
    build.reset_launches()
    x = torch.from_numpy(_x("normal", 2500))
    v, i = topk.topk_select(x, 11)
    rv, ri = ref.topk_select_ref(ref.to_blocks(x, 1024)[0], 11)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    d = topk.topk_scatter(v, i, x.numel())
    assert torch.equal(d, ref.topk_scatter_ref(v, i, 1024).reshape(-1)[:2500])
    p, g, mu, nu = map(torch.from_numpy, _state(2500))
    h, _ = _hyper(2)
    for a, b in zip(fused_adam.adam_tile_update(p, g, mu, nu, h),
                    ref.adam_tile_update_ref(p, g, mu, nu, h)):
        assert torch.equal(a, b)
    out = replay.topk_apply(v, i, p, mu, nu, h)
    blocks = [ref.to_blocks(t, 1024)[0] for t in (p, mu, nu)]
    for a, b in zip(out, ref.topk_apply_ref(v, i, *blocks, h, block=1024)):
        assert torch.equal(a, ref.unblock(b, (2500,)))
    rows = x.reshape(25, 100)
    q, s = span.span_pack(rows, 4)
    rq, rs = ref.span_pack_ref(rows, 4)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(span.quant_span_decode(q, s, 100, 4),
                       ref.span_decode_ref(q, s, 100, 4))
    dst = torch.zeros(30, 100)
    assert torch.equal(span.quant_span_apply(q, s, dst.clone(), 5, 4),
                       ref.quant_span_apply_ref(q, s, dst, 5, bits=4))
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_kernel_build_is_lazy():
    """Importing the wrappers builds nothing; the sources are in place
    and the build flags keep products and sums separately rounded."""
    assert not build._libs
    for name in build.SOURCES:
        assert (build.CSRC and
                open(f"{build.CSRC}/{name}.cu").read().count("extern") >= 1)
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
