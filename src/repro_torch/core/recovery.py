"""Recovery: differential replay (Algorithm 1) and the patch-chain
overlay of LowDiff+, port of ``repro.core.recovery``.

Serial and device replay apply each differential through Adam in order
— ``M_{j+1} = M_j + Adam(G_j)`` — with the fused decode-and-apply kernel
of each leaf's wire form (``topk_apply`` K4, ``packed_apply`` K10 or
``quant_apply`` K13) decoding the payload straight into the update: the
kernel and hyper row the training step itself used. So a recovered
state equals the trained one bit for bit, and the two replays equal
each other bit for bit.

* :func:`replay_serial` uploads one differential at a time.
* :func:`replay_device` stages a window of compressed payloads on the
  device first (ρ·dense bytes cross PCIe, checked before the window
  runs), then loops over the window's differentials and leaves. Window
  N+1's upload does not yet overlap window N's replay.
* :func:`replay_parallel` (LowDiff's default) stages a window, then
  runs Adam's affine moment recurrences as a log-depth scan in torch
  ops, one bounded chunk of each leaf at a time — equal to serial replay
  up to float reassociation.

:func:`merge_deltas_pairwise` sums NaiveDC's state deltas in the
paper's pairwise tree order.

:func:`load_state_device` is the hardware-recovery twin of
``CheckpointStore.load_latest_state`` that overlays quantized row-span
patches on the card with ``quant_span_apply`` (K7).
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.checkpoint.patchset import RowUpdate
from repro_torch.compression.packed import PackedDiff
from repro_torch.compression.quant import QuantGrad
from repro_torch.compression.quant_span import QuantSpan
from repro_torch.compression.sparse import SparseGrad, is_compressed
from repro_torch.kernels import ops
from repro_torch.models.param import to_tensor
from repro_torch.optim.adam import AdamState


def load_latest_chain(store):
    """Load the newest loadable full checkpoint and the ordered
    differentials after it. A full that cannot be read back (missing
    blob, corrupt frame) falls back to the next older full. Returns
    (state, [(step, payload), ...]) with host leaves; raises
    FileNotFoundError when no full checkpoint is loadable."""
    from repro_torch.checkpoint.io import FrameCorruptionError
    from repro_torch.checkpoint.store import order_fulls
    fulls = order_fulls(store.manifest["fulls"])
    if not fulls:
        raise FileNotFoundError("no full checkpoint")
    last_err = None
    for entry in fulls:
        try:
            state = store.load_full(entry)
        except (FileNotFoundError, FrameCorruptionError) as e:
            last_err = e
            continue
        return state, store.diffs_after(entry["step"])
    raise FileNotFoundError(
        f"none of {len(fulls)} full checkpoints is loadable "
        f"(last error: {last_err})")


def contiguous_prefix(start: int, diffs: List[Tuple[int, Any]],
                      stride: int = 1) -> List[Tuple[int, Any]]:
    """Longest prefix of ``diffs`` whose steps advance by ``stride``
    from ``start``: replaying past a hole would silently corrupt the
    recovered state, so the chain is cut at the first gap."""
    out = []
    expect = start + stride
    for s, p in diffs:
        if s != expect:
            break
        out.append((s, p))
        expect = s + stride
    return out


def to_device(tree, device):
    """Host (or device) tree -> tensors on ``device``; compressed
    payloads (top-k, packed, quant8) keep their container."""
    return tree_map(lambda a: to_tensor(a, device=device), tree)


def merge_deltas_pairwise(deltas: List[Any]) -> Tuple[Any, int]:
    """The paper's pairwise tree merge of *state-delta* differentials
    (Naive DC): log2(n) rounds of pairwise sums, pairing as the
    reference does ((0, 1), (2, 3), ..., an odd last one carried up), so
    the sums round alike. Works on trees or single tensors. Returns
    (merged, rounds)."""
    deltas = list(deltas)
    rounds = 0
    while len(deltas) > 1:
        nxt = [tree_map(lambda a, b: a + b, deltas[i], deltas[i + 1])
               for i in range(0, len(deltas) - 1, 2)]
        if len(deltas) % 2:
            nxt.append(deltas[-1])
        deltas = nxt
        rounds += 1
    return deltas[0], rounds


def _payload_nbytes(payload) -> int:
    """Host bytes of a payload's arrays (compressed containers are tree
    nodes, so their q / indices / scale arrays count as they are)."""
    return sum(int(getattr(l, "nbytes", 0) or 0)
               for l in tree_leaves(payload))


def _fused_step(p_leaves, mu_l, nu_l, hyper, g_leaves):
    """Apply one differential's leaves (sorted leaf order, paired with
    the param leaves) through ``fused_decode_apply``. Shared by both
    replays so they run the same per-leaf program."""
    if len(g_leaves) != len(p_leaves):
        raise ValueError(
            f"differential has {len(g_leaves)} leaves, model has "
            f"{len(p_leaves)}")
    out = [ops.fused_decode_apply(g, p, m, v, hyper)
           for g, p, m, v in zip(g_leaves, p_leaves, mu_l, nu_l)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])


def _start(params, opt: AdamState, device):
    dev = resolve_device(device)
    p_leaves = [to_tensor(a, device=dev) for a in tree_leaves(params)]
    mu_l = [to_tensor(a, device=dev) for a in tree_leaves(opt.mu)]
    nu_l = [to_tensor(a, device=dev) for a in tree_leaves(opt.nu)]
    count = to_tensor(opt.count, device=dev).to(torch.int32)
    return dev, p_leaves, mu_l, nu_l, count


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _finish(params, opt, p_leaves, mu_l, nu_l, count):
    return (_rebuild(params, p_leaves),
            AdamState(_rebuild(opt.mu, mu_l), _rebuild(opt.nu, nu_l), count))


def replay_serial(params, opt: AdamState, diffs: List[Tuple[int, Any]], *,
                  lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, device=None):
    """Apply each differential in order, uploading one at a time.
    diffs: [(step, payload)]. Returns (params, AdamState) on ``device``
    (CUDA unless the CPU is asked for)."""
    from repro_torch.checkpoint.io import COPY_METER
    dev, p_l, mu_l, nu_l, count = _start(params, opt, device)
    for _, payload in diffs:
        count = count + 1
        hyper = ops.adam_hyper_traced(lr, b1, b2, eps, count)
        g_l = tree_leaves(to_device(payload, dev), is_leaf=is_compressed)
        COPY_METER.add_h2d(_payload_nbytes(payload))
        p_l, mu_l, nu_l = _fused_step(p_l, mu_l, nu_l, hyper, g_l)
    return _finish(params, opt, p_l, mu_l, nu_l, count)


#: what a corrupt or mismatched payload raises (``_check_wire``, the
#: kernel wrappers' shape and dtype checks): such a payload cuts the chain.
#: A kernel that fails to build or launch raises RuntimeError, which is
#: not caught: recovery must not pass over it as a shorter chain.
CORRUPT_PAYLOAD = (ValueError, TypeError)


def _wire_shapes(leaf, nb: int):
    """{field: (its shape, the shape the leaf's dense shape needs)} of a
    compressed leaf; k is whatever the payload carries."""
    if isinstance(leaf, SparseGrad):
        k = tuple(leaf.values.shape[1:2])
        return {"values": (leaf.values.shape, (nb,) + k),
                "indices": (leaf.indices.shape, (nb,) + k)}
    if isinstance(leaf, PackedDiff):
        k = tuple(leaf.q.shape[1:2])
        return {"q": (leaf.q.shape, (nb,) + k),
                "indices": (leaf.indices.shape, (nb,) + k),
                "scale": (leaf.scale.shape, (nb, 1))}
    return {"q": (leaf.q.shape, (nb, leaf.block)),
            "scale": (leaf.scale.shape, (nb,))}


def _check_wire(payload) -> None:
    """The block rows and the index, code and scale shapes of each
    compressed leaf must match the dense shape it claims to decode to."""
    for leaf in tree_leaves(payload, is_leaf=is_compressed):
        if not is_compressed(leaf):
            continue
        n = 1
        for d in leaf.shape:
            n *= int(d)
        nb = -(-n // leaf.block)
        for field, (got, want) in _wire_shapes(leaf, nb).items():
            if tuple(got) != want:
                raise ValueError(
                    f"corrupt differential: {type(leaf).__name__}.{field} "
                    f"{tuple(got)} for shape {tuple(leaf.shape)} (expected "
                    f"{want})")


def _stage_window(diffs: List[Tuple[int, Any]], dev):
    """Upload a window's payloads in wire form. A payload that fails to
    check or stage cuts the window there. Returns (staged leaf lists,
    error or None)."""
    from repro_torch.checkpoint.io import COPY_METER
    from repro_torch.obs.trace import trace_span
    with trace_span("replay.h2d", "recovery", n=len(diffs)) as sp:
        staged, err, nbytes = [], None, 0
        for _, payload in diffs:
            try:
                _check_wire(payload)
                staged.append(tree_leaves(to_device(payload, dev),
                                          is_leaf=is_compressed))
                nbytes += _payload_nbytes(payload)
            except CORRUPT_PAYLOAD as e:
                err = e
                break
        COPY_METER.add_h2d(nbytes)
        sp.set(bytes=nbytes, staged=len(staged))
        return staged, err


def replay_device(params, opt: AdamState, diffs: List[Tuple[int, Any]], *,
                  lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                  window: Optional[int] = None, device=None):
    """Device-resident replay: each window's compressed payloads are
    staged on the device, then applied differential by differential,
    leaf by leaf, with the kernel of its wire form (K4, K10 or K13).
    Bit-identical to :func:`replay_serial`. A corrupt payload (one that
    raises :data:`CORRUPT_PAYLOAD` when staged or applied) cuts the
    chain there; a failed build or launch raises.
    Returns (params, opt, applied)."""
    if not diffs:
        return params, opt, 0
    if window is not None and window < 0:
        raise ValueError("window must be None or >= 0")
    w = int(window) if window else len(diffs)
    dev, p_l, mu_l, nu_l, count = _start(params, opt, device)
    applied = 0
    for i in range(0, len(diffs), w):
        staged, err = _stage_window(diffs[i:i + w], dev)
        for g_l in staged:
            try:
                c = count + 1
                hyper = ops.adam_hyper_traced(lr, b1, b2, eps, c)
                p_l, mu_l, nu_l = _fused_step(p_l, mu_l, nu_l, hyper, g_l)
                count = c
                applied += 1
            except CORRUPT_PAYLOAD as e:
                err = e
                break
        if err is not None:
            break
    params2, opt2 = _finish(params, opt, p_l, mu_l, nu_l, count)
    return params2, opt2, applied


# ---------------- parallel replay: log-depth moment scan ----------------

def _scan_affine(beta: float, b: torch.Tensor):
    """Inclusive scan of ``x_j = beta * x_{j-1} + b_j`` along dim 0 in
    ceil(log2 n) rounds (Hillis-Steele over the pairs (a, b) with
    (l, r) -> (l.a * r.a, r.b + r.a * l.b)). Returns (A, B) with
    ``x_j = B_j + A_j * x_{-1}``; A is (n, 1, ...)."""
    n = b.shape[0]
    a = torch.full((n,) + (1,) * (b.dim() - 1), beta, dtype=torch.float32,
                   device=b.device)
    d = 1
    while d < n:
        b = torch.cat([b[:d], b[d:] + a[d:] * b[:-d]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return a, b


#: device scratch one chunk of a parallel replay may hold: each of the
#: window's n steps keeps about eight f32 temporaries per element (the
#: dense gradient, the scan's pairs and products, mu_j, nu_j, the step),
#: so a chunk spans SCRATCH_BYTES / (32 n) elements and the peak does not
#: grow with the chain or the leaf
SCRATCH_BYTES = 1 << 30


def _chunk_elems(n: int, block: int) -> int:
    per = SCRATCH_BYTES // (32 * n)
    return max(block, per // block * block)


def _dense_chunk(leaf, lo: int, hi: int) -> torch.Tensor:
    """Elements [lo, hi) of a differential's flattened leaf as dense f32.
    A compressed leaf decodes only the blocks that cover them (``lo`` is
    a multiple of its block): K2 (top-k), K9 (packed) or K12 (quant8)."""
    if is_compressed(leaf):
        b = leaf.block
        rows = slice(lo // b, -(-hi // b))
        if isinstance(leaf, SparseGrad):
            return ops.topk_decompress(SparseGrad(
                leaf.values[rows], leaf.indices[rows], (hi - lo,),
                b)).float()
        if isinstance(leaf, PackedDiff):
            return ops.packed_decompress(PackedDiff(
                leaf.q[rows], leaf.indices[rows], leaf.scale[rows],
                (hi - lo,), b))
        return ops.quant_decompress(QuantGrad(
            leaf.q[rows], leaf.scale[rows], (hi - lo,), b))
    return leaf.reshape(-1)[lo:hi].float()


def _parallel_leaf(p, gs, m0, v0, c1, c2, lr, b1, b2, eps):
    """All n Adam steps of one leaf at once, chunk by chunk of its
    flattened elements (the recurrences are elementwise): every
    (mu_j, nu_j) from the scan, every step's update in parallel, one sum
    into p. Returns new (p, mu, nu) leaves."""
    n, numel = len(gs), p.numel()
    block = math.lcm(1, *(g.block for g in gs if is_compressed(g)))
    chunk = _chunk_elems(n, block)
    cs = (n, 1)
    p2, mu, nu = (torch.empty_like(t) for t in (p, m0, v0))
    pf, mf, vf = p.reshape(-1), m0.reshape(-1), v0.reshape(-1)
    for lo in range(0, numel, chunk):
        hi = min(lo + chunk, numel)
        g = torch.stack([_dense_chunk(x, lo, hi) for x in gs])
        a, b = _scan_affine(b1, (1.0 - b1) * g)
        mu_j = b + a * mf[lo:hi]
        a, b = _scan_affine(b2, (1.0 - b2) * (g * g))
        nu_j = b + a * vf[lo:hi]
        del a, b, g
        step = lr * (mu_j / c1.reshape(cs)) / (
            torch.sqrt(nu_j / c2.reshape(cs)) + eps)
        p2.view(-1)[lo:hi] = (pf[lo:hi].float() - step.sum(0)).to(p.dtype)
        mu.view(-1)[lo:hi] = mu_j[-1]
        nu.view(-1)[lo:hi] = nu_j[-1]
    return p2, mu, nu


def replay_parallel(params, opt: AdamState, diffs: List[Tuple[int, Any]], *,
                    lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                    window: Optional[int] = None, device=None):
    """Log-depth replay: Adam's moment recurrences are affine, so each
    window's (mu_j, nu_j) come out of one scan of ceil(log2 n) rounds,
    every step's update is computed in parallel and summed into the
    params once. Equal to :func:`replay_serial` up to float
    reassociation. Payloads are staged on the device compressed and
    decoded chunk by chunk of each leaf, so the dense scratch stays near
    :data:`SCRATCH_BYTES` whatever the chain's length; ``window`` bounds
    the staged payloads, and windows chain exactly through (params, mu,
    nu, count). A payload that fails its checks cuts the chain there.
    Returns (params, opt, applied)."""
    if not diffs:
        return params, opt, 0
    if window is not None and window < 0:
        raise ValueError("window must be None or >= 0")
    w = int(window) if window else len(diffs)
    dev, p_l, mu_l, nu_l, count = _start(params, opt, device)
    applied = 0
    for i in range(0, len(diffs), w):
        staged, err = _stage_window(diffs[i:i + w], dev)
        if staged:
            if any(len(g) != len(p_l) for g in staged):
                raise ValueError("differential leaf count != model's")
            n = len(staged)
            counts = (count + 1 + torch.arange(n, device=dev)).float()
            c1 = 1.0 - torch.pow(torch.tensor(b1, device=dev), counts)
            c2 = 1.0 - torch.pow(torch.tensor(b2, device=dev), counts)
            for j in range(len(p_l)):    # each old leaf freed as it goes
                p_l[j], mu_l[j], nu_l[j] = _parallel_leaf(
                    p_l[j], [g[j] for g in staged], mu_l[j], nu_l[j],
                    c1, c2, lr, b1, b2, eps)
            count = count + n
            applied += n
        if err is not None:
            break
    params2, opt2 = _finish(params, opt, p_l, mu_l, nu_l, count)
    return params2, opt2, applied


# ---------------- device-resident patch-chain overlay ----------------

def _resident(x, dev) -> torch.Tensor:
    """A private copy of a state leaf on ``dev`` (frame leaves are
    read-only views of the checkpoint file)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, copy=True)
    return to_tensor(x, device=dev)


def _to_host(t: torch.Tensor):
    """numpy on the host (a bf16 leaf stays a CPU tensor, as frames load
    it: numpy has no bfloat16)."""
    t = t.cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _overlay(state, updates, dev, owned: dict) -> None:
    """One patch blob onto ``state``. ``owned`` maps id -> each device
    leaf this overlay made; holding the tensor keeps its id from being
    reused, and a leaf a later patch replaces is dropped from it."""
    from repro_torch.checkpoint.io import COPY_METER
    for k, v in updates.items():
        if isinstance(v, dict) and isinstance(state.get(k), dict):
            _overlay(state[k], v, dev, owned)
        elif isinstance(v, QuantSpan):
            dst = state[k]
            if id(dst) not in owned:
                dst = _resident(dst, dev)
                owned[id(dst)] = dst
            for start, q, sc in zip(v.starts, v.qs, v.scales):
                COPY_METER.add_h2d(q.nbytes + sc.nbytes)
                ops.fused_span_apply(dst, int(start), to_tensor(q, device=dev),
                                     to_tensor(sc, device=dev), bits=v.bits)
            state[k] = dst
        elif isinstance(v, RowUpdate):
            cur = owned.pop(id(state[k]), state[k])
            base = np.array(_to_host(cur) if isinstance(cur, torch.Tensor)
                            else cur)
            for sp in v.spans():
                base[sp.start:sp.stop] = sp.data
            state[k] = base
        else:
            owned.pop(id(state.get(k)), None)
            state[k] = v


def _download(state, owned: dict) -> None:
    for k, v in state.items():
        if isinstance(v, dict):
            _download(v, owned)
        elif id(v) in owned:
            state[k] = _to_host(v)


def overlay_device(state, updates, *, device=None) -> None:
    """Device twin of ``store.merge_updates`` for one patch blob: nested
    dicts merge, a QuantSpan leaf is dequantized into the state leaf on
    ``device`` by ``quant_span_apply`` (K7, no host decode of the wire
    bytes), a RowUpdate splices on the host, anything else replaces.
    Mutates ``state`` in place; overlaid leaves come back as numpy, equal
    bit for bit to the host overlay."""
    owned: dict = {}
    _overlay(state, updates, resolve_device(device), owned)
    _download(state, owned)


def load_state_device(store, *, device=None):
    """Hardware-recovery twin of ``store.load_latest_state``: quantized
    span payloads upload in wire form and K7 writes the dequantized rows
    straight into the state leaf on ``device`` (CUDA unless the CPU is
    asked for). The store's own walk of the chain runs it, so fallback
    and chain cut are the host path's, and so are the bytes: returns
    ``(state, step)`` with host leaves.

    Unlike the reference, which uploads and downloads a leaf for every
    patch, a leaf stays on the device across all patches of the chain
    and is downloaded once: the same result with fewer copies. As in the
    reference, COPY_METER's H2D counts the wire payloads (not the base
    leaves' upload)."""
    dev = resolve_device(device)
    owned: dict = {}
    return store.load_latest_state(
        merge=lambda state, updates: _overlay(state, updates, dev, owned),
        finish=lambda state: _download(state, owned))
