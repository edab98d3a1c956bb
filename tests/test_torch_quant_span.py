"""The port's quantized row-span codec against the JAX reference's: the
plain versions of K5/K6/K7 (which the CUDA kernels are held to bit for
bit on the card by ``chip_smoke.py``) against the reference's Pallas
kernels in interpret mode and against the numpy codec ``encode_rows`` /
``decode_rows`` — all bitwise; and patch frames holding whole leaves,
RowUpdate and QuantSpan leaves, byte-identical from both packages."""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.checkpoint.patchset import PatchSet as JaxPatchSet
from repro.checkpoint.patchset import RowUpdate as JaxRowUpdate
from repro.compression.quant_span import QuantSpan as JaxQuantSpan
from repro.compression.quant_span import decode_rows as jax_decode_rows
from repro.compression.quant_span import encode_rows as jax_encode_rows
from repro.kernels import ops as jops
from repro_torch.checkpoint import io
from repro_torch.checkpoint.patchset import PatchSet, RowUpdate
from repro_torch.compression.quant_span import (QuantSpan, decode_rows,
                                                encode_rows)
from repro_torch.kernels import ops, span


def _bits32(a):
    return np.asarray(a, np.float32).view(np.int32)


def _rows(n, cols, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, cols)) * rng.uniform(0.01, 10.0, (n, 1))
         ).astype(np.float32)
    x[0] = 0.0                       # an all-zero row: scale 1e-12
    if cols > 2:
        x[-1, 1] = x[-1, 0] * -1.0   # an exact absmax tie of both signs
    return x


CODEC = [(bits, n, cols) for bits in (8, 4) for n in (1, 8, 9)
         for cols in (1, 2, 7, 1280)]


@pytest.mark.parametrize("bits,n,cols", CODEC)
def test_codec_matches_pallas_and_numpy(bits, n, cols):
    x = _rows(n, cols, seed=bits * 100 + n * 10 + cols)
    q, s = ops.quant_span_encode(torch.from_numpy(x), bits=bits)
    jq, js = jops.quant_span_encode(jnp.asarray(x), bits=bits,
                                    use_pallas=True)
    nq, ns = encode_rows(x, bits)
    rq, rs = jax_encode_rows(x, bits)
    assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert q.shape == (n, cols if bits == 8 else (cols + 1) // 2)
    for other in (np.asarray(jq), nq, rq):
        np.testing.assert_array_equal(q.numpy(), other)
    for other in (js, ns, rs):
        np.testing.assert_array_equal(_bits32(s.numpy()), _bits32(other))
    d = ops.quant_span_decode(q, s, cols=cols, bits=bits)
    jd = jops.quant_span_decode(jq, js, cols=cols, bits=bits,
                                use_pallas=True)
    for other in (jd, decode_rows(nq, ns, cols, bits),
                  jax_decode_rows(rq, rs, cols, bits)):
        np.testing.assert_array_equal(_bits32(d.numpy()), _bits32(other))
    # K7: into the middle of a leaf and onto its last row
    rng = np.random.default_rng(7)
    dst = rng.standard_normal((n + 5, cols)).astype(np.float32)
    for start in (3, 5):
        t = torch.from_numpy(dst.copy())
        got = ops.fused_span_apply(t, start, q, s, bits=bits)
        want = jops.fused_span_apply(jnp.asarray(dst), start, jq, js,
                                     bits=bits, use_pallas=True)
        assert got is t
        np.testing.assert_array_equal(_bits32(t.numpy()), _bits32(want))


def _half_step_rows(bits, n=12, seed=0):
    """Rows whose values sit on and a few ulps around (k + 1/2) * scale,
    where round-half-even, and an IEEE divide against a reciprocal
    multiply, decide the code."""
    qmax = 127.0 if bits == 8 else 7.0
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        amax = np.float32(rng.uniform(0.1, 10.0))
        s = amax * np.float32(1.0 / qmax)
        vals = [amax]
        for k in range(-int(qmax), int(qmax)):
            x = up = dn = np.float32((k + 0.5) * s)
            vals.append(x)
            for _ in range(3):
                up = np.nextafter(up, np.float32(np.inf))
                dn = np.nextafter(dn, np.float32(-np.inf))
                vals += [up, dn]
        rows.append(vals)
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_codec_rounds_like_numpy_at_half_steps(bits):
    x = _half_step_rows(bits)
    s = np.max(np.abs(x), axis=1, keepdims=True) * np.float32(
        1.0 / (127.0 if bits == 8 else 7.0))
    # the inputs do separate a true division from a reciprocal multiply
    assert (np.round(x / s) != np.round(x * (np.float32(1) / s))).any()
    q, sc = ops.quant_span_encode(torch.from_numpy(x), bits=bits)
    jq, _ = jops.quant_span_encode(jnp.asarray(x), bits=bits,
                                   use_pallas=True)
    nq, ns = encode_rows(x, bits)
    np.testing.assert_array_equal(q.numpy(), nq)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits32(sc.numpy()), _bits32(ns))


def test_apply_into_bf16_and_tail_shaped_leaf_matches_pallas():
    x = _rows(9, 3 * 5, seed=3)
    rng = np.random.default_rng(4)
    dst = rng.standard_normal((12, 3, 5)).astype(np.float32)
    for bits in (8, 4):
        q, s = ops.quant_span_encode(torch.from_numpy(x), bits=bits)
        jq, js = jops.quant_span_encode(jnp.asarray(x), bits=bits)
        t = torch.from_numpy(dst).to(torch.bfloat16)
        ops.fused_span_apply(t, 2, q, s, bits=bits)
        want = jops.fused_span_apply(jnp.asarray(dst, jnp.bfloat16), 2, jq,
                                     js, bits=bits, use_pallas=True)
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))


def test_wrappers_refuse_malformed_payloads():
    q, s = ops.quant_span_encode(torch.ones(4, 6), bits=4)
    dst = torch.zeros(5, 6)
    with pytest.raises(ValueError, match="exceed"):
        span.quant_span_apply(q, s, dst, 2, 4)        # rows [2, 6) of 5
    with pytest.raises(TypeError):
        span.quant_span_apply(q, s, dst, 0, 8)        # uint8 is not int8
    with pytest.raises(ValueError, match="wire columns"):
        span.quant_span_decode(q, s, 7, 4)            # 3 bytes hold 6
    with pytest.raises(ValueError, match="one f32 per row"):
        span.quant_span_decode(q, s[:3], 6, 4)
    with pytest.raises(ValueError, match="bits"):
        span.span_pack(torch.ones(2, 2), 2)


def _patch_blob(pkg):
    """A patch blob with a whole leaf, a RowUpdate and an int8 and an
    int4 QuantSpan, built from the same numpy arrays by either package."""
    rng = np.random.default_rng(11)
    whole = rng.standard_normal((3, 4)).astype(np.float32)
    rows = [rng.standard_normal((2, 5)).astype(np.float32),
            rng.standard_normal((1, 5)).astype(np.float32)]
    blocks = [rng.standard_normal((2, 7)).astype(np.float32),
              rng.standard_normal((3, 7)).astype(np.float32)]
    RU, QS = (RowUpdate, QuantSpan) if pkg == "port" else \
        (JaxRowUpdate, JaxQuantSpan)
    upd = {"params": {"['a']": whole,
                      "['b']": RU(starts=np.asarray([1, 6], np.int64),
                                  rows=rows, shape=(8, 5)),
                      "['c']": QS.from_rows([0, 4], blocks, (9, 7), 4)},
           "mu": {"['c']": QS.from_rows([0, 4], blocks, (9, 7), 8)},
           "count": np.array(7, np.int64)}
    return {"base": "full_00000001", "step": 3, "updates": upd}


def test_patch_frames_are_byte_identical_and_cross_load():
    mine, theirs = _patch_blob("port"), _patch_blob("jax")
    assert io.frame_dumps(mine) == jio.frame_dumps(theirs)
    got = io.frame_loads(jio.frame_dumps(theirs), verify=True)["updates"]
    back = jio.frame_loads(io.frame_dumps(mine), verify=True)["updates"]
    assert isinstance(got["params"]["['b']"], RowUpdate)
    assert isinstance(got["params"]["['c']"], QuantSpan)
    assert isinstance(back["params"]["['b']"], JaxRowUpdate)
    assert isinstance(back["mu"]["['c']"], JaxQuantSpan)
    for a, b in ((got, mine["updates"]), (back, mine["updates"])):
        qa, qb = a["params"]["['c']"], b["params"]["['c']"]
        assert (tuple(qa.starts), tuple(qa.shape), qa.bits, qa.dtype) == \
            (tuple(qb.starts), tuple(qb.shape), qb.bits, qb.dtype)
        for x, y in zip(qa.qs + qa.scales, qb.qs + qb.scales):
            np.testing.assert_array_equal(np.asarray(x), y)
        ra, rb = a["params"]["['b']"], b["params"]["['b']"]
        np.testing.assert_array_equal(np.asarray(ra.starts), rb.starts)
        for x, y in zip(ra.rows, rb.rows):
            np.testing.assert_array_equal(np.asarray(x), y)


def _frame_file(path, pkg):
    rng = np.random.default_rng(5)
    state = {"w": rng.standard_normal((10, 6)).astype(np.float32),
             "v": rng.standard_normal((4,)).astype(np.float32),
             "h": rng.standard_normal((3, 2)).astype(np.float32)}
    (io if pkg == "port" else jio).save_frame(str(path), state)
    return state


def _patch(pkg):
    rng = np.random.default_rng(6)
    PS = PatchSet if pkg == "port" else JaxPatchSet
    ps = PS()
    ps.add("a0", 2, rng.standard_normal((3, 6)).astype(np.float32), (10, 6))
    ps.add("a0", 8, rng.standard_normal((2, 6)).astype(np.float32), (10, 6))
    ps.add("a1", 0, rng.standard_normal((4,)).astype(np.float32))
    return ps


def test_patch_frame_writes_the_references_bytes(tmp_path):
    """The in-place fold writes the same bytes as the reference's:
    patching one frame with one PatchSet in either package gives
    byte-identical files, and the patched digests verify."""
    for pkg in ("port", "jax"):
        _frame_file(tmp_path / f"{pkg}.ckpt", pkg)
    n = io.patch_frame(str(tmp_path / "port.ckpt"), _patch("port"))
    m = jio.patch_frame(str(tmp_path / "jax.ckpt"), _patch("jax"))
    assert n == m
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "jax.ckpt").read_bytes()
    got = io.load_frame(str(tmp_path / "port.ckpt"), verify=True)
    np.testing.assert_array_equal(got["w"][2:5], _patch("port")["a0"][0].data)


@pytest.mark.parametrize("point", ["patch:mid_span", "patch:mid_data",
                                   "patch:pre_header", "patch:mid_header"])
def test_patch_frame_crash_points(tmp_path, point):
    """A kill at each crash point leaves the frame's layout readable and
    its untouched leaf intact; re-running the patch (recovery replays
    the journaled chain) lands on the uncrashed bytes."""
    path = tmp_path / "f.ckpt"
    state = _frame_file(path, "port")
    ref_path = tmp_path / "ref.ckpt"
    _frame_file(ref_path, "port")
    io.patch_frame(str(ref_path), _patch("port"))

    def hook(p):
        if p == point:
            raise KeyboardInterrupt(p)
    io.set_patch_crash_hook(hook)
    try:
        with pytest.raises(KeyboardInterrupt):
            io.patch_frame(str(path), _patch("port"))
    finally:
        io.set_patch_crash_hook(None)
    if point != "patch:mid_header":
        torn = io.load_frame(str(path))
        np.testing.assert_array_equal(torn["h"], state["h"])
    io.patch_frame(str(path), _patch("port"))
    assert path.read_bytes() == ref_path.read_bytes()
    assert not os.path.exists(str(path) + ".tmp")


def test_bf16_leaf_in_reference_frame_overlays_in_port():
    """A bf16 leaf the reference writes comes back as a torch bf16
    tensor, and K7's plain version writes into it like the reference's
    fused apply."""
    rng = np.random.default_rng(8)
    leaf = rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16)
    t = io.frame_loads(jio.frame_dumps({"x": jnp.asarray(leaf)}))["x"]
    assert t.dtype == torch.bfloat16
    x = _rows(2, 4, seed=9)
    q, s = ops.quant_span_encode(torch.from_numpy(x), bits=8)
    ops.fused_span_apply(t, 4, q, s, bits=8)
    want = jops.fused_span_apply(jnp.asarray(leaf), 4, jnp.asarray(q.numpy()),
                                 jnp.asarray(s.numpy()), bits=8)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
