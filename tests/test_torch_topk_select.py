"""The selection algorithm of the CUDA kernel behind K1 ``topk_select``
and K8 ``pack_select`` (``kernels/csrc/topk.cu``), which cannot run on
the CPU, as a numpy model of its steps in the kernel's lane layout. The
model is held bit for bit (indices, value bits, int8 codes, scales) to
the port's plain versions (``kernels/ref.py``, which ``chip_smoke.py``
holds the kernel to on the card) and to the JAX package's Pallas kernels
run in interpret mode, on adversarial inputs at k in {1, 2, 11, 31, 32,
33, 103, 1024} and on a property over blocks drawn from a few values.

The kernel's steps, for one 1024-element block held by one warp:

* lane l holds the 32 elements at columns j * 32 * VEC + l * VEC + e
  (VEC = 4 in f32, 8 in bf16: one 16-byte load per chunk j); a key is
  the f32 bit pattern of |x|, ordered as |x| when compared as an integer;
* t0 is the k-th largest of the 32 lane maxima (a bitonic network);
* fast path: if at most 32 elements have key >= t0, their columns are
  compacted one per lane and sorted by (key descending, column
  ascending); the first k are the picks;
* tie path: else, if at most 32 elements have key > t0, they are sorted
  the same way, and when fewer than k, the lowest columns with key == t0
  follow, in column order;
* fallback: otherwise, and whenever k > 32, k rounds of warp argmax.

The cases must reach all three paths at some k <= 32 (so they cannot pass
through the fallback alone), and ``chip_smoke._path_shares``, the rule
``chip_smoke.py`` reports on the card, must count the paths the model
takes."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.compression.sparse import topk_compress as jax_topk_compress
from repro.kernels import ops as jops
from repro_torch.kernels import ref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

BLOCK = 1024
LANES = 32
KS = (1, 2, 11, 31, 32, 33, 103, 1024)
N = 6 * BLOCK + 300          # seven blocks, the last ragged


# -------------------------------------------------------------- the model

def lane_columns(vec: int) -> np.ndarray:
    """(lane, i) -> column of the lane's i-th element."""
    i = np.arange(LANES)
    lane = np.arange(LANES)[:, None]
    return (i // vec) * (LANES * vec) + lane * vec + i % vec


def bitonic(keys, cols=None):
    """The warp's bitonic network, one value per lane, descending: on
    keys alone (t0), or on (key, column) pairs with the lower column
    first among equal keys (the candidates)."""
    lane = np.arange(LANES)
    size = 2
    while size <= LANES:
        stride = size // 2
        while stride:
            partner = lane ^ stride
            keep_first = ((lane & stride) == 0) == ((lane & size) == 0)
            pk = keys[partner]
            if cols is None:
                keys = np.where(keep_first, np.maximum(keys, pk),
                                np.minimum(keys, pk))
            else:
                pc = cols[partner]
                other_first = (pk > keys) | ((pk == keys) & (pc < cols))
                take = other_first == keep_first
                keys, cols = np.where(take, pk, keys), np.where(take, pc, cols)
            stride //= 2
        size *= 2
    return keys if cols is None else (keys, cols)


def model_block(block: np.ndarray, k: int, vec: int):
    """One block (1024 f32 values; a bf16 block as its f32 values) ->
    (the k picked columns in order, the path that picked them)."""
    keys = block.view(np.int32) & 0x7FFFFFFF
    cols = lane_columns(vec)
    lane_keys = keys[cols]
    if k <= LANES:
        t0 = bitonic(lane_keys.max(axis=1))[k - 1]
        assert (keys >= t0).sum() >= k
        for path, cand in (("fast", lane_keys >= t0),
                           ("tie", lane_keys > t0)):
            total = int(cand.sum())
            if total <= LANES:
                # compaction: lane by lane, each lane's elements in order
                ck = np.full(LANES, -1, np.int64)
                cc = BLOCK + np.arange(LANES)
                ck[:total] = keys[cols[cand]]
                cc[:total] = cols[cand]
                _, cc = bitonic(ck, cc)
                picks = list(cc[:min(k, total)])
                if path == "fast":
                    assert total >= k
                # tie fill: key == t0 in column order (chunk, lane, element)
                eq = lane_keys == t0
                for j in range(LANES // vec):
                    for lane in range(LANES):
                        for e in range(vec):
                            if len(picks) < k and eq[lane, j * vec + e]:
                                picks.append(cols[lane, j * vec + e])
                assert path == "tie" or len(picks) == k
                return np.asarray(picks, np.int32), path
    # fallback: k rounds; each lane's best is its first maximum (its
    # lowest column), the warp's the largest key, then the lowest column
    lane_keys = lane_keys.astype(np.int64)
    rows = np.arange(LANES)
    picks = []
    for _ in range(k):
        best = lane_keys.argmax(axis=1)
        bk, bc = lane_keys[rows, best], cols[rows, best]
        win = np.lexsort((bc, -bk))[0]
        picks.append(bc[win])
        lane_keys[win, best[win]] = -1
    return np.asarray(picks, np.int32), "fallback"


def model_select(x: torch.Tensor, k: int):
    """The kernel's selection over a whole tensor (f32 or bf16): returns
    (values in x's dtype, int32 indices, f32 scale (K8), paths)."""
    xb = ref.to_blocks(x, BLOCK)[0]
    blocks = xb.float().numpy()
    vec = 16 // x.element_size()
    out = [model_block(b, k, vec) for b in blocks]
    idx = torch.from_numpy(np.stack([o[0] for o in out]))
    vals = torch.gather(xb, 1, idx.long())
    amax = np.abs(blocks).max(axis=1).astype(np.float32)
    scale = np.maximum(amax * np.float32(1.0 / 127.0), np.float32(1e-12))
    return vals, idx, torch.from_numpy(scale[:, None]), [o[1] for o in out]


def model_pack(x: torch.Tensor, k: int):
    """K8: the model's picks, quantized as the kernel quantizes them."""
    vals, idx, scale, paths = model_select(x, k)
    v = vals.float().numpy()
    q = np.clip(np.rint(v / scale.numpy()), -127, 127).astype(np.int8)
    return torch.from_numpy(q), idx, scale, paths


# -------------------------------------------------------------- the inputs

def _inputs():
    """name -> (numpy f32 values, as bf16). Flat inputs have N elements,
    so the Pallas kernels compile once per k and dtype."""
    rng = np.random.default_rng(14)
    ties = rng.integers(-3, 4, N).astype(np.float32)
    ties[BLOCK:2 * BLOCK] = 0.0                   # an all-zero block
    signed = np.where(rng.standard_normal(N) < 0, -0.0, 0.0)
    signed[BLOCK + 500] = -2.0
    sparse = np.zeros(N)                          # k, 32, < k, 1, 0, k+1
    for b, nz in enumerate((11, 32, 5, 1, 0, 12)):
        sparse[b * BLOCK + rng.permutation(BLOCK)[:nz]] = \
            rng.standard_normal(nz)
    embed = np.zeros((40, 1280))                  # a few seen rows
    embed[[3, 17, 18, 39]] = rng.standard_normal((4, 1280))
    tied = rng.standard_normal(N)                 # 40 equal maxima
    for b in range(6):
        tied[b * BLOCK + rng.permutation(BLOCK)[:40]] = 5.0 * (-1.0) ** b
    col = np.arange(N) % BLOCK
    lanes = rng.standard_normal(N)                # large in lanes 0-9 only
    lanes[col % 128 < 40] *= 1000.0
    lanes16 = rng.standard_normal(N)
    lanes16[col % 256 < 80] *= 1000.0
    cases = {"randn": (rng.standard_normal(N), False),
             "ties": (ties, False), "zeros": (np.zeros(N), False),
             "signed zeros": (signed, False), "k nonzeros": (sparse, False),
             "embedding": (embed, False),
             "student-t1": (rng.standard_t(1, N), False),
             "student-t3": (rng.standard_t(3, N), False),
             "tied maxima": (tied, False), "ten lanes": (lanes, False),
             "bf16 randn": (rng.standard_normal(N), True),
             "bf16 ties": (ties, True), "bf16 embedding": (embed, True),
             "bf16 ten lanes": (lanes16, True)}
    return {name: (np.asarray(x, np.float32), bf16)
            for name, (x, bf16) in cases.items()}


INPUTS = _inputs()


def _torch(name):
    x, bf16 = INPUTS[name]
    t = torch.from_numpy(x.copy())
    return t.to(torch.bfloat16) if bf16 else t


def _jax(name):
    x, bf16 = INPUTS[name]
    return jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# -------------------------------------------------------------- the tests

@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_model_matches_plain_and_pallas(name, k):
    x = _torch(name)
    vals, idx, _, _ = model_select(x, k)
    rv, ri = ref.topk_select_ref(ref.to_blocks(x, BLOCK)[0], k)
    np.testing.assert_array_equal(idx.numpy(), ri.numpy())
    np.testing.assert_array_equal(_bits(vals), _bits(rv))
    q, pidx, scale, _ = model_pack(x, k)
    rq, rpi, rs = ref.pack_select_ref(ref.to_blocks(x, BLOCK)[0], k)
    np.testing.assert_array_equal(pidx.numpy(), idx.numpy())
    np.testing.assert_array_equal(q.numpy(), rq.numpy())
    np.testing.assert_array_equal(_bits(scale), _bits(rs))
    # the reference's Pallas kernels (jitted, interpret mode); their
    # value is a masked sum over the block, so a -0.0 pick comes out
    # +0.0 there (the port keeps the element, as the reference's step
    # does: ``test_signed_zero_picks_keep_their_sign``)
    sg = jops.topk_compress(_jax(name), k / BLOCK, use_pallas=True)
    np.testing.assert_array_equal(np.asarray(sg.indices), idx.numpy())
    np.testing.assert_array_equal(_jbits(sg.values), _bits(vals + 0.0))
    pd = jops.packed_compress(_jax(name), k / BLOCK, use_pallas=True)
    np.testing.assert_array_equal(np.asarray(pd.indices), idx.numpy())
    np.testing.assert_array_equal(np.asarray(pd.q), q.numpy())
    np.testing.assert_array_equal(_jbits(pd.scale), _bits(scale))


def test_signed_zero_picks_keep_their_sign():
    """A block of signed zeros takes the tie path (t0 = 0) and picks its
    first k columns; the values are the elements, -0.0 kept, as the
    plain version and the reference's training step (``lax.top_k`` and
    ``take_along_axis``) gather them. The reference's Pallas kernel sums
    the masked block and gives +0.0 (ROADMAP §3)."""
    x = _torch("signed zeros")
    vals, idx, _, paths = model_select(x, 11)
    xb = ref.to_blocks(x, BLOCK)[0]
    assert paths[0] == "tie"
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(11))
    np.testing.assert_array_equal(_bits(vals[0]), _bits(xb[0, :11]))
    negative_zero = _bits(vals) == np.int32(-2 ** 31)
    assert negative_zero.any()
    step = jax_topk_compress(_jax("signed zeros"), 11 / BLOCK)
    np.testing.assert_array_equal(np.asarray(step.indices), idx.numpy())
    np.testing.assert_array_equal(_jbits(step.values), _bits(vals))
    sg = jops.topk_compress(_jax("signed zeros"), 11 / BLOCK, use_pallas=True)
    assert not (_jbits(sg.values) == np.int32(-2 ** 31)).any()


def test_all_paths_are_reached_and_chip_smoke_counts_them():
    seen = {}
    for name in INPUTS:
        x = _torch(name)
        for k in KS:
            paths = model_select(x, k)[3]
            for p in paths:
                seen.setdefault(p, set()).add(k)
            shares = chip_smoke._path_shares([x], k)
            want = {p: paths.count(p) / len(paths)
                    for p in chip_smoke.SELECT_PATHS}
            assert shares == pytest.approx(want, abs=0), (name, k)
    for p in chip_smoke.SELECT_PATHS:
        assert min(seen[p]) <= 32, (p, seen[p])
    # the main path's k on continuous data: every block takes the fast path
    assert set(model_select(_torch("randn"), 11)[3]) == {"fast"}
    assert set(model_select(_torch("bf16 randn"), 11)[3]) == {"fast"}


@settings(max_examples=60, deadline=None)
@given(values=st.lists(st.sampled_from([0.0, -0.0, 0.5, -1.0, 1.0, 2.0,
                                        -2.0, 3.0]),
                       min_size=1, max_size=2 * BLOCK + 100),
       k=st.sampled_from([1, 2, 3, 11, 31, 32, 33]),
       bf16=st.booleans())
def test_model_matches_plain_on_few_values(values, k, bf16):
    x = torch.tensor(values, dtype=torch.float32)
    if bf16:
        x = x.to(torch.bfloat16)
    xb = ref.to_blocks(x, BLOCK)[0]
    vals, idx, _, _ = model_select(x, k)
    rv, ri = ref.topk_select_ref(xb, k)
    np.testing.assert_array_equal(idx.numpy(), ri.numpy())
    np.testing.assert_array_equal(_bits(vals), _bits(rv))
    q, _, scale, _ = model_pack(x, k)
    rq, _, rs = ref.pack_select_ref(xb, k)
    np.testing.assert_array_equal(q.numpy(), rq.numpy())
    np.testing.assert_array_equal(_bits(scale), _bits(rs))
