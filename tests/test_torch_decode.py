"""The port's decode path against the JAX reference on the CPU, at
reduced size (f32): the cache trees of every architecture, 16 decode
steps from the reference's params (logits and every cache leaf), decode
against the port's own prefill, the long-context ring, Hymba's window,
Seamless's prefilled cross K/V, an MoE whose prefill drops tokens where
decode drops none, and the decode batches bit for bit.

Tolerances: logits and cache leaves within 5e-5 of the reference's,
scaled by the leaf's largest magnitude where that exceeds 1 (f32
throughout; the frameworks sum in different orders: ~1e-5 seen, ~3e-5
relative on the ring's 8,192-slot sums); decode against prefill within
2e-2 (the reference's ``test_decode_matches_prefill_last_token``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.synthetic import make_batch as jax_batch
from repro.models import lm as jax_lm
from repro.models import ops as jax_ops
from repro.models.registry import build_model as jax_model
from repro_torch import tree_leaves
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models import lm, moe, ops
from repro_torch.models.param import from_jax_cache, from_jax_params
from repro_torch.models.registry import build_model

ATOL = 5e-5            # port vs reference, f32
PREFILL_TOL = 2e-2     # decode vs prefill (the reference's own bound)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (six workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pair(arch, seed=1, **kw):
    """(port cfg, model, params; reference cfg, model, params), the
    port's params carried from the reference's init."""
    cfg = get_config(arch).reduced().replace(**kw)
    jcfg = jax_config(arch).reduced().replace(**kw)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg)
    p = from_jax_params(jax.tree.map(np.asarray, jp), m.specs)
    return cfg, m, p, jcfg, jm, jp


def _struct(x):
    """Nested (type name, fields) of a cache with (shape, dtype) leaves,
    in either package."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,
                tuple((f, _struct(v)) for f, v in zip(x._fields, x)))
    if isinstance(x, tuple):
        return tuple(_struct(v) for v in x)
    return (tuple(x.shape), str(x.dtype).split(".")[-1])


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol * scale)


def _assert_cache_close(cache, jcache):
    assert _struct(cache) == _struct(jcache)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _close(a, b)


def _jstep(jm, seq_len):
    return jax.jit(lambda p, c, b: jm.decode_step(p, c, b, seq_len))


def _dbatch(cfg, t, seq_len, pos):
    """The decode batch of step ``t`` at position ``pos`` in both
    packages."""
    b = make_batch(cfg, seq_len, B, step=t, kind="decode")
    b["pos"] = torch.tensor(pos, dtype=torch.int32)
    return b, {"tokens": jnp.asarray(b["tokens"].numpy()),
               "pos": jnp.int32(pos)}


def _caches(cfg, m, p, jm, jp, seq_len):
    """Fresh caches of both packages (Seamless: prefilled from the same
    source frames)."""
    if cfg.arch_type != "audio":
        return (m.init_cache(B, seq_len, device="cpu"),
                jm.init_cache(B, seq_len))
    src = make_batch(cfg, seq_len, B, step=11)
    jsrc = {"src_embeds": jnp.asarray(src["src_embeds"].numpy())}
    return (m.prefill_cache(p, src, B, seq_len),
            jm.prefill_cache(jp, jsrc, B, seq_len))


ARCHS = tuple(ASSIGNED_ARCHS) + ("gpt2-l",)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_tree_matches_reference(arch):
    """The same NamedTuples, fields, shapes and dtypes (``()`` for the
    unused fields), at reduced and at full width (shapes only)."""
    m = build_model(get_config(arch).reduced())
    jm = jax_model(jax_config(arch).reduced())
    assert _struct(m.init_cache(3, 40, device="cpu")) == \
        _struct(jm.init_cache(3, 40))
    want = jax_model(jax_config(arch)).init_cache(2, 1100, abstract=True)
    got = build_model(get_config(arch)).init_cache(2, 1100, device="meta")
    assert _struct(got) == _struct(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_sixteen_decode_steps_match_reference(arch):
    """From the reference's params, 16 decode steps of the same batches:
    every step's logits and, after the last, every cache leaf."""
    cfg, m, p, jcfg, jm, jp = _pair(arch)
    S = 16
    cache, jcache = _caches(cfg, m, p, jm, jp, S)
    step = _jstep(jm, S)
    with torch.no_grad():
        for t in range(S):
            b, jb = _dbatch(cfg, t, S, t)
            jl, jcache = step(jp, jcache, jb)
            logits, cache = m.decode_step(p, cache, b, S)
            assert logits.dtype == torch.float32
            assert logits.shape == (B, cfg.vocab)
            _close(logits, jl)
    _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_last_token(arch):
    """Teacher-forced decode of a sequence ends at the logits of the
    port's prefill (``logits_fn``) on it; Pixtral's text decode against
    a prefill with no patches, Seamless's from its prefilled cache."""
    cfg, m, p, *_ = _pair(arch)
    S = 16
    batch = make_batch(cfg, S, B, step=2)
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = batch["patch_embeds"][:, :0]
    with torch.no_grad():
        want = m.logits_fn(p, batch)
        cache = (m.prefill_cache(p, batch, B, S) if m.prefill_cache
                 else m.init_cache(B, S, device="cpu"))
        for t in range(S):
            b = {"tokens": batch["tokens"][:, t:t + 1],
                 "pos": torch.tensor(t, dtype=torch.int32)}
            logits, cache = m.decode_step(p, cache, b, S)
    np.testing.assert_allclose(logits.numpy(), want.numpy(),
                               atol=PREFILL_TOL, rtol=PREFILL_TOL)


def test_logits_fn_matches_reference():
    """The prefill entry point itself, dense and encoder-decoder."""
    for arch in ("qwen2-1.5b", "seamless-m4t-medium"):
        cfg, m, p, jcfg, jm, jp = _pair(arch)
        batch = make_batch(cfg, 32, B, step=4)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        with torch.no_grad():
            _close(m.logits_fn(p, batch), jm.logits_fn(jp, jb))


def _random_cache(jm, seq_len, seed):
    """A reference cache filled with random values (mid-sequence)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(rng.normal(size=a.shape) * 0.5, a.dtype),
        jax.tree.map(np.asarray, jm.init_cache(B, seq_len)))


def test_ring_cache_beyond_8192_positions():
    """seq_len 70,000 bounds the dense cache to 8,192 ring slots
    (``cache_len``); from a full ring carried in with ``from_jax_cache``,
    steps at pos >= 8,192 write slot pos % 8,192 and attend to every
    slot, as the reference does. Logits and v within ``ATOL``; k within
    pos_max * 2^-23 of its scale: the reference's jitted RoPE
    frequencies are constant-folded and differ from eager ones by an ulp
    (11 of 32 for hd 64), which at pos 20,001 moves an angle by up to
    pos * 2^-23 rad."""
    S = 70_000
    positions = (8192, 8193, 9000, 20_001)
    cfg, m, p, jcfg, jm, jp = _pair("qwen2-1.5b")
    assert lm.cache_len(cfg, S) == jax_lm.cache_len(jcfg, S) == 8192
    jc = _random_cache(jm, S, seed=3)
    cache = from_jax_cache(jc)
    assert cache.k.shape[2] == 8192
    jcache = jax.tree.map(jnp.asarray, jc)
    step = _jstep(jm, S)
    with torch.no_grad():
        for t, pos in enumerate(positions):
            b, jb = _dbatch(cfg, t, S, pos)
            jl, jcache = step(jp, jcache, jb)
            logits, cache = m.decode_step(p, cache, b, S)
            _close(logits, jl)
            assert not torch.equal(cache.k[:, :, pos % 8192],
                                   torch.from_numpy(jc.k[:, :, pos % 8192]))
    assert _struct(cache) == _struct(jcache)
    _close(cache.v, jcache.v)
    _close(cache.k, jcache.k, atol=max(positions) * 2.0 ** -23)


def test_hybrid_window_binds_beyond_32_positions():
    """Reduced Hymba: layer 0 global, layer 1 windowed to 32 positions.
    From a random cache at pos 40..43 the port equals the reference,
    and the same steps without the window give other logits."""
    S = 64
    cfg, m, p, jcfg, jm, jp = _pair("hymba-1.5b")
    assert list(lm.layer_windows(cfg)) == [0, 32]
    jc = _random_cache(jm, S, seed=5)
    cache, open_cache = from_jax_cache(jc), from_jax_cache(jc)
    jcache = jax.tree.map(jnp.asarray, jc)
    step = _jstep(jm, S)
    unwindowed = cfg.replace(global_attn_layers=(0, 1))
    with torch.no_grad():
        for t, pos in enumerate(range(40, 44)):
            b, jb = _dbatch(cfg, t, S, pos)
            jl, jcache = step(jp, jcache, jb)
            logits, cache = m.decode_step(p, cache, b, S)
            _close(logits, jl)
            other, open_cache = lm.decode_step(p, open_cache, b, unwindowed,
                                               S)
            assert float((other - logits).abs().max()) > 1e-3
    _assert_cache_close(cache, jcache)


def test_seamless_prefill_cache_matches_reference():
    """``prefill_cache``: the cross K/V of every decoder layer from the
    encoded source frames, zero self K/V; then decode from it."""
    cfg, m, p, jcfg, jm, jp = _pair("seamless-m4t-medium")
    S = 24
    cache, jcache = _caches(cfg, m, p, jm, jp, S)
    assert float(cache.cross_k.abs().max()) > 0
    assert float(cache.k.abs().max()) == 0
    _assert_cache_close(cache, jcache)
    step = _jstep(jm, S)
    with torch.no_grad():
        for t in range(3):
            b, jb = _dbatch(cfg, t, S, t)
            jl, jcache = step(jp, jcache, jb)
            logits, cache = m.decode_step(p, cache, b, S)
            _close(logits, jl)
    _assert_cache_close(cache, jcache)


def test_moe_prefill_drops_where_decode_does_not():
    """DeepSeekMoE at capacity factor 1.0: the prefill of 2 x 32 tokens
    (capacity 32 of 64 assignments an expert on average) drops tokens,
    decode (2 tokens, capacity 8) drops none, so the two differ; both
    packages agree on the prefill, on the decode and so on the gap. A
    prefill of capacity >= T (factor E/K) agrees with decode."""
    S = 32
    base = get_config("deepseek-moe-16b").reduced()
    moe_cfg = dataclasses.replace(base.moe, capacity_factor=1.0)
    cfg, m, p, jcfg, jm, jp = _pair("deepseek-moe-16b", moe=moe_cfg)
    assert moe.capacity(B * S, cfg) == 32 and moe.capacity(B, cfg) == 8
    batch = make_batch(cfg, S, B, step=6)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    step = _jstep(jm, S)
    cache, jcache = m.init_cache(B, S, device="cpu"), jm.init_cache(B, S)
    with torch.no_grad():
        pre = m.logits_fn(p, batch)
        for t in range(S):
            b = {"tokens": batch["tokens"][:, t:t + 1],
                 "pos": torch.tensor(t, dtype=torch.int32)}
            jl, jcache = step(jp, jcache, {"tokens": jb["tokens"][:, t:t + 1],
                                           "pos": jnp.int32(t)})
            dec, cache = m.decode_step(p, cache, b, S)
        drop_free = cfg.replace(moe=dataclasses.replace(
            moe_cfg, capacity_factor=moe_cfg.n_experts / moe_cfg.top_k))
        assert moe.capacity(B * S, drop_free) >= B * S
        pre_free = lm.logits_fn(p, batch, drop_free)
    jpre = jm.logits_fn(jp, jb)
    _close(pre, jpre)
    _close(dec, jl)
    gap = (pre - dec).abs().max()
    assert float(gap) > 0.1                      # prefill dropped tokens
    _close(pre - dec, np.asarray(jpre) - np.asarray(jl), atol=2 * ATOL)
    np.testing.assert_allclose(pre_free.numpy(), dec.numpy(),
                               atol=PREFILL_TOL, rtol=PREFILL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batches_bit_equal(arch):
    """``kind="decode"``: int32 tokens (B, 1) and pos = min(S - 1, 7)
    from the same counter RNG as the reference, bit for bit."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    for S, step in ((64, 3), (5, 0)):
        mine = make_batch(cfg, S, 3, step=step, seed=2, kind="decode")
        ref = jax_batch(jcfg, S, 3, step=step, seed=2, kind="decode")
        assert sorted(mine) == sorted(ref) == ["pos", "tokens"]
        for k in mine:
            x, y = mine[k].numpy(), np.asarray(ref[k])
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k
        assert int(mine["pos"]) == min(S - 1, 7)


def test_archs_cover_every_family():
    """The parametrized tests above reach every family's decode path."""
    kinds = {get_config(a).arch_type for a in ARCHS}
    assert kinds == {"dense", "moe", "vlm", "hybrid", "ssm", "audio"}


def test_bf16_scalars_round_as_jax_does():
    """JAX rounds 1/sqrt(hd) to bf16 before it scales a bf16 q (hd 128:
    the scale is not a power of two); ``ops.as_dtype`` gives the same
    bits, and ``decode_attention`` in bf16 (GQA, a window) agrees with
    the reference's to within one bf16 rounding of its largest output."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 8, 128))
    k, v = (rng.normal(size=(2, 16, 2, 128)) for _ in range(2))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (jq, jk, jv))
    want = np.asarray(jq * (1.0 / 128 ** 0.5)).view(np.int16)
    got = tq * ops.as_dtype(1.0 / 128 ** 0.5, torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)
    assert not torch.equal(got, tq * (1.0 / 128 ** 0.5))
    ref = np.asarray(jax_ops.decode_attention(jq, jk, jv, jnp.int32(9),
                                              window=4), np.float32)
    mine = ops.decode_attention(tq, tk, tv, torch.tensor(9), window=4)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(mine.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(ref).max()))
