"""Recovery: differential replay (Algorithm 1), port of
``repro.core.recovery``.

Both replays apply each differential through Adam in order —
``M_{j+1} = M_j + Adam(G_j)`` — with ``topk_apply`` (K4) scattering each
leaf's wire payload straight into the update, the kernel and hyper row
the training step itself used. So a recovered state equals the trained
one bit for bit, and the two replays equal each other bit for bit.

* :func:`replay_serial` uploads one differential at a time.
* :func:`replay_device` stages a window of compressed payloads on the
  device first (ρ·dense bytes cross PCIe, checked before the window
  runs), then loops over the window's differentials and leaves. Window
  N+1's upload does not yet overlap window N's replay.

The reference's default, ``replay_parallel`` (a log-depth associative
scan over the moment recurrences), is not ported yet (ROADMAP §1
item 8).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.compression.sparse import SparseGrad, is_sparse
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
    """Host (or device) tree -> tensors on ``device``; SparseGrad
    payloads keep their container."""
    return tree_map(lambda a: to_tensor(a, device=device), tree)


def _payload_nbytes(payload) -> int:
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
        g_l = tree_leaves(to_device(payload, dev), is_leaf=is_sparse)
        COPY_METER.add_h2d(_payload_nbytes(payload))
        p_l, mu_l, nu_l = _fused_step(p_l, mu_l, nu_l, hyper, g_l)
    return _finish(params, opt, p_l, mu_l, nu_l, count)


#: what a corrupt or mismatched payload raises (``_check_wire``, the
#: kernel wrappers' shape and dtype checks): such a payload cuts the chain.
#: A kernel that fails to build or launch raises RuntimeError, which is
#: not caught: recovery must not pass over it as a shorter chain.
CORRUPT_PAYLOAD = (ValueError, TypeError)


def _check_wire(payload) -> None:
    """The block-row count of each compressed leaf must match the dense
    shape it claims to decode to."""
    for leaf in tree_leaves(payload, is_leaf=is_sparse):
        if not isinstance(leaf, SparseGrad):
            continue
        n = 1
        for d in leaf.shape:
            n *= int(d)
        nb = -(-n // leaf.block)
        if leaf.values.shape[0] != nb:
            raise ValueError(
                f"corrupt differential: {leaf.values.shape[0]} block rows "
                f"for shape {leaf.shape} (expected {nb})")


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
                                          is_leaf=is_sparse))
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
    leaf by leaf, with K4. Bit-identical to :func:`replay_serial`. A
    corrupt payload (one that raises :data:`CORRUPT_PAYLOAD` when staged
    or applied) cuts the chain there; a failed build or launch raises.
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
