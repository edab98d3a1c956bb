"""The MoE layer's dispatch kernels (``csrc/moe.cu``): ``plan`` (each
assignment's slot ``dest`` and whether it is kept, and each slot's
assignment ``src``), ``slot_gather`` (one row a slot) and
``assign_gather`` (one row a token, the sum of its kept assignments'
rows). They replace no TPU kernel: the JAX package leaves the dispatch
to XLA, and ``models/moe.py``'s ``_Dispatch`` and ``_Combine`` run them
forward and backward.

Assignment ``a = t·K + k`` of token ``t`` goes to expert ``eid[t, k]``;
the layer holds experts ``[first, first + n)`` with ``C`` slots each, and
the drop slot is ``n·C``. A tensor on the CPU goes to the plain version
in ``kernels.ref``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: experts per token the gathers take (``MAX_K`` in ``csrc/moe.cu``)
MAX_K = 32


def plan(eid: torch.Tensor, first: int, n: int, C: int):
    """(dest (T·K,) int64, valid (T·K,) bool, src (n·C,) int64) of the
    assignments ``eid`` (T, K) int64 to the ``n`` experts from
    ``first``, ``C`` slots each: an assignment's slot is its expert's
    (relative to ``first``) times ``C`` plus the number of earlier
    assignments to that expert, in flat order; kept if that is under
    ``C``, else and for the experts not held the drop slot ``n·C``.
    ``src[dest[a]] == a`` for every kept ``a``; other slots hold -1."""
    if not eid.is_cuda:
        return ref.moe_plan_ref(eid, first, n, C)
    if eid.dtype != torch.int64:
        raise TypeError(f"eid has dtype {eid.dtype}; kernel takes int64")
    if n < 1 or C < 1:
        raise ValueError(f"n ({n}) and C ({C}) must be positive")
    flat = eid.reshape(-1).contiguous()
    TK = flat.numel()
    dest = torch.empty((TK,), dtype=torch.int64, device=eid.device)
    valid = torch.empty((TK,), dtype=torch.bool, device=eid.device)
    src = torch.empty((n * C,), dtype=torch.int64, device=eid.device)
    fn = build.entry("moe", "moe_plan_i64")
    build.check(fn(flat.data_ptr(), TK, first, n, C, dest.data_ptr(),
                   valid.data_ptr(), src.data_ptr(),
                   build.stream_ptr(eid.device)), "moe_plan")
    build.LAUNCHES["moe_plan"] += 1
    return dest, valid, src


def _vec(d: int, *ts) -> int:
    """1 where rows of width ``d`` of every tensor ``ts`` start 16-byte
    aligned (the kernels' 16-byte loads), else 0."""
    return int(all((d * t.element_size()) % 16 == 0
                   and t.data_ptr() % 16 == 0 for t in ts if t is not None))


def _check_rows(x, name, dtype=None):
    build.require_cuda(x, name, dtypes=(torch.float32, torch.bfloat16)
                       if dtype is None else (dtype,), align=1)
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2-D, not {tuple(x.shape)}")


def slot_gather(x: torch.Tensor, src: torch.Tensor, K: int,
                w: torch.Tensor = None, dot_rows: torch.Tensor = None):
    """Rows of the slots: out[s] = x[src[s] // K] * w[src[s]] (the product
    rounded to x's dtype; without ``w`` the row itself), zeros where
    ``src[s] < 0``: (S, d). With ``dot_rows`` (S, d) also (out, dots):
    dots (T·K,) f32 holds, for each assignment that fills a slot s, the
    f32 sum over d of x[t] * dot_rows[s] (each product rounded to x's
    dtype), 0 for the others."""
    if not x.is_cuda:
        return ref.slot_gather_ref(x, src, K, w, dot_rows)
    _check_rows(x, "x")
    build.require_cuda(src, "src", dtypes=(torch.int64,), align=8)
    T, d = x.shape
    S = src.numel()
    if w is not None:
        build.require_cuda(w, "w", dtypes=(x.dtype,), align=1)
        if w.numel() != T * K:
            raise ValueError(f"w has {w.numel()} elements, want {T * K}")
    if dot_rows is not None:
        _check_rows(dot_rows, "dot_rows", x.dtype)
        if tuple(dot_rows.shape) != (S, d):
            raise ValueError(f"dot_rows {tuple(dot_rows.shape)} must be "
                             f"({S}, {d})")
    out = torch.empty((S, d), dtype=x.dtype, device=x.device)
    dots = (torch.zeros((T * K,), dtype=torch.float32, device=x.device)
            if dot_rows is not None else None)
    if S and d:
        fn = build.entry("moe", f"moe_slot_gather_{build.dtype_tag(x.dtype)}")
        build.check(fn(x.data_ptr(), src.data_ptr(), S, K, d,
                       None if w is None else w.data_ptr(),
                       None if dot_rows is None else dot_rows.data_ptr(),
                       None if dots is None else dots.data_ptr(),
                       out.data_ptr(), _vec(d, x, dot_rows, out),
                       build.stream_ptr(x.device)), "moe_slot_gather")
        build.LAUNCHES["moe_slot_gather"] += 1
    return out if dot_rows is None else (out, dots)


def assign_gather(rows: torch.Tensor, dest: torch.Tensor, K: int,
                  w: torch.Tensor = None) -> torch.Tensor:
    """Rows of the tokens: out[t] = the sum over k = 0..K-1 whose slot s
    = dest[t·K + k] lies in [0, R) of rows[s] * w[t·K + k] (without
    ``w``, rows[s]), from zero, each product and each add rounded to
    rows' dtype: (T, d) with T = dest.numel() // K."""
    if not rows.is_cuda:
        return ref.assign_gather_ref(rows, dest, K, w)
    _check_rows(rows, "rows")
    build.require_cuda(dest, "dest", dtypes=(torch.int64,), align=8)
    R, d = rows.shape
    if not 1 <= K <= MAX_K or dest.numel() % K:
        raise ValueError(f"K ({K}) must be in [1, {MAX_K}] and divide "
                         f"dest's {dest.numel()} elements")
    T = dest.numel() // K
    if w is not None:
        build.require_cuda(w, "w", dtypes=(rows.dtype,), align=1)
        if w.numel() != T * K:
            raise ValueError(f"w has {w.numel()} elements, want {T * K}")
    out = torch.empty((T, d), dtype=rows.dtype, device=rows.device)
    if T and d:
        fn = build.entry("moe",
                         f"moe_assign_gather_{build.dtype_tag(rows.dtype)}")
        build.check(fn(rows.data_ptr(), R, dest.data_ptr(), T, K, d,
                       None if w is None else w.data_ptr(), out.data_ptr(),
                       _vec(d, rows, out), build.stream_ptr(rows.device)),
                    "moe_assign_gather")
        build.LAUNCHES["moe_assign_gather"] += 1
    return out
