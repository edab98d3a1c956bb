"""K5 ``span_pack``, K6 ``quant_span_decode`` and K7 ``quant_span_apply``
(``csrc/span.cu``), the port of ``repro.kernels.pack.span_pack`` and
``repro.kernels.replay.quant_span_decode`` / ``quant_span_apply``: the
per-row absmax int8/int4 codec of LowDiff+'s quantized row-span patches,
bit-identical to the numpy codec (``compression.quant_span``). A tensor
on the CPU goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises.

The kernels handle any row count and odd ``cols`` themselves; the
reference pads rows to its 8-row Pallas tile and int4 columns to even
first, and slices the padding off again.

K5 reads x once: a cooperative grid of one CTA per SM holds each row
segment in shared memory until the row's absmax is known
(:func:`pack_plan` cuts a leaf into segments). A row wider than the
grid's shared memory takes the explicit two-pass path; :data:`PATHS`
counts the rows and elements of each.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, ref

_WIRE = {8: torch.int8, 4: torch.uint8}

#: rows up to this many columns go one to a warp, several to a segment
NARROW_COLS = 4096

#: span_pack path -> [rows, elements] packed on the card since the reset
PATHS: Dict[str, list] = {"one_pass": [0, 0], "two_pass": [0, 0]}


def reset_paths() -> None:
    for v in PATHS.values():
        v[0] = v[1] = 0


def _check_bits(bits: int) -> None:
    if bits not in _WIRE:
        raise ValueError(f"bits must be 8 or 4, not {bits}")


def wire_cols(cols: int, bits: int) -> int:
    return cols if bits == 8 else (cols + 1) // 2


class PackPlan(NamedTuple):
    """How K5 walks an (n, cols) block: ``warp_rows`` segments of
    ``rows`` whole rows, or segments of one ``width``-column part of a
    row, ``parts`` to a row; ``segments`` in all, ``grid`` CTAs."""
    path: str            # "one_pass" | "two_pass"
    grid: int
    parts: int
    width: int
    rows: int
    segments: int
    warp_rows: bool

    @property
    def waves(self) -> int:
        return -(-self.segments // self.grid) if self.grid else 0


def pack_plan(n: int, cols: int, grid: int, cap: int) -> PackPlan:
    """Segments of an (n, cols) block for a grid of ``grid`` co-resident
    CTAs that each hold ``cap`` f32 (a multiple of 4) in shared memory,
    sized so that a wave of segments fills the grid. A row part is a
    multiple of 4 columns (even, so no int4 byte is split between two
    CTAs); ``parts <= grid`` keeps every part of a row resident at once.
    A row wider than ``grid * cap`` takes the two-pass path."""
    if cols <= min(NARROW_COLS, cap):
        rmax = cap // cols
        waves = -(-n // (grid * rmax))
        rows = -(-n // (grid * waves))
        segments = -(-n // rows)
        return PackPlan("one_pass", min(grid, segments), 1, cols, rows,
                        segments, True)
    pmin = -(-cols // cap)
    if pmin > grid:
        return PackPlan("two_pass", 0, 0, 0, 0, 0, False)
    per_wave = max(1, min(grid // pmin, n))
    parts = grid // per_wave
    width = 4 * -(-cols // (4 * parts))
    parts = -(-cols // width)
    return PackPlan("one_pass", min(grid, n * parts), parts, width, 1,
                    n * parts, False)


_limits: Dict[int, Tuple[int, int, int, int]] = {}
# (device, stream) -> [part slots (u64, zeroed once), last generation]
_slots: Dict[Tuple[int, int], list] = {}


def pack_limits(device) -> Tuple[int, int, int, int]:
    """(grid, cap, dynamic shared memory bytes, CTAs per SM) of the
    one-pass kernel on ``device``; raises where it cannot be launched
    cooperatively."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _limits:
        import ctypes
        out = (ctypes.c_longlong * 4)()
        with torch.cuda.device(idx):
            build.check(build.entry("span", "span_pack_limits")(out),
                        "span_pack (limits)")
        _limits[idx] = tuple(int(v) for v in out)
    return _limits[idx]


def _part_slots(device, stream: int, count: int):
    """``count`` part slots (one u64 per segment) of (device, stream) and
    the next generation. Slots are zeroed when allocated (or when the
    32-bit generation wraps) and never reset: each launch tags what it
    stores with a larger generation."""
    key = (device.index, stream)
    ent = _slots.get(key)
    if ent is None or ent[0].numel() < count or ent[1] >= 0xFFFFFFFF:
        size = max(count, 0 if ent is None else ent[0].numel())
        ent = _slots[key] = [torch.zeros(size, dtype=torch.int64,
                                         device=device), 0]
    ent[1] += 1
    return ent[0], ent[1]


def span_pack(x2d: torch.Tensor, bits: int):
    """Quantize an (n, cols) f32 row block with per-row absmax scales ->
    (q (n, wire_cols) int8 | uint8, scale (n, 1) f32)."""
    return _pack(x2d, bits)[:2]


def pack_phases(x2d: torch.Tensor, bits: int):
    """:func:`span_pack` on the card with the one-pass kernel's phase
    times: (q, scale, stamps (segments, 4) int64), each row of stamps the
    global ns at which a segment began, its copies had landed, its row's
    absmax was known and its wire bytes were written."""
    if not x2d.is_cuda:
        raise ValueError("pack_phases times the kernel: x2d must be on "
                         "the card")
    return _pack(x2d, bits, stamps=True)


def _pack(x2d: torch.Tensor, bits: int, stamps: bool = False):
    _check_bits(bits)
    if x2d.dim() != 2:
        raise ValueError(
            f"span_pack takes (n, cols), not {tuple(x2d.shape)}")
    if not x2d.is_cuda:
        return ref.span_pack_ref(x2d, bits)
    build.require_cuda(x2d, "x2d", dtypes=(torch.float32,), align=4)
    n, cols = x2d.shape
    q = torch.empty((n, wire_cols(cols, bits)), dtype=_WIRE[bits],
                    device=x2d.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    if not (n and cols):
        scale.fill_(1e-12)
        return q, scale, None
    grid, cap = pack_limits(x2d.device)[:2]
    plan = pack_plan(n, cols, grid, cap)
    stream = build.stream_ptr(x2d.device)
    times = None
    if plan.path == "one_pass":
        slots, gen = _part_slots(x2d.device, stream, plan.segments)
        if stamps:
            times = torch.zeros((plan.segments, 4), dtype=torch.int64,
                                device=x2d.device)
        fn = build.entry("span", "span_pack_one_pass")
        build.check(fn(x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
                       slots.data_ptr(), n, cols, bits, plan.parts,
                       plan.width, plan.rows, plan.segments,
                       int(plan.warp_rows), gen, plan.grid,
                       None if times is None else times.data_ptr(), stream),
                    "span_pack")
    else:
        if stamps:
            raise ValueError("pack_phases times the one-pass kernel; "
                             f"{n}x{cols} takes the two-pass path")
        amax = torch.zeros(n, dtype=torch.int32, device=x2d.device)
        fn = build.entry("span", "span_pack_two_pass")
        build.check(fn(x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
                       amax.data_ptr(), n, cols, bits, stream),
                    "span_pack (two-pass)")
    build.LAUNCHES["span_pack"] += 1
    PATHS[plan.path][0] += n
    PATHS[plan.path][1] += n * cols
    return q, scale, times


def _check_wire(q, scale, cols: int, bits: int) -> None:
    _check_bits(bits)
    if q.dim() != 2 or q.dtype != _WIRE[bits]:
        raise TypeError(f"int{bits} span payload must be a 2-d "
                        f"{_WIRE[bits]} tensor, not {q.dtype}{tuple(q.shape)}")
    n, wc = q.shape
    if scale.numel() != n or scale.dtype != torch.float32:
        raise ValueError(f"scale {scale.dtype}{tuple(scale.shape)} does "
                         f"not give one f32 per row of {n}")
    if cols < 0 or wire_cols(cols, bits) > wc:
        raise ValueError(f"{wc} wire columns cannot hold {cols} int{bits} "
                         f"columns")


def quant_span_decode(q: torch.Tensor, scale: torch.Tensor, cols: int,
                      bits: int) -> torch.Tensor:
    """Wire bytes + per-row scales -> dense f32 (n, cols)."""
    _check_wire(q, scale, cols, bits)
    if not q.is_cuda:
        return ref.span_decode_ref(q, scale, cols, bits)
    build.require_cuda(q, "q", align=1)
    build.require_cuda(scale, "scale", align=4)
    n, wc = q.shape
    out = torch.empty((n, cols), dtype=torch.float32, device=q.device)
    if n and cols:
        fn = build.entry("span", "span_decode")
        build.check(fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                       cols, wc, bits, build.stream_ptr(q.device)),
                    "quant_span_decode")
        build.LAUNCHES["quant_span_decode"] += 1
    return out


def quant_span_apply(q: torch.Tensor, scale: torch.Tensor,
                     dst: torch.Tensor, start: int, bits: int) -> torch.Tensor:
    """Dequantize one row-span payload straight into rows [start,
    start + n) of the state leaf ``dst`` (shape (N, *tail), f32 or bf16),
    cast to its dtype. Writes **in place** and returns ``dst``: the
    reference returns a new array from ``dynamic_update_slice``; the port
    updates the leaf, so recovery holds one copy of it."""
    if dst.dim() == 0:
        raise ValueError("quant_span_apply needs a leaf with a row axis")
    cols = 1
    for d in dst.shape[1:]:
        cols *= int(d)
    _check_wire(q, scale, cols, bits)
    n = q.shape[0]
    start = int(start)
    if start < 0 or start + n > dst.shape[0]:
        raise ValueError(f"rows [{start}, {start + n}) exceed the leaf's "
                         f"{dst.shape[0]} rows")
    if not dst.is_cuda:
        return ref.quant_span_apply_ref(q, scale, dst, start, bits=bits)
    build.require_cuda(dst, "dst", dtypes=(torch.float32, torch.bfloat16),
                       align=2)
    build.require_cuda(q, "q", align=1)
    build.require_cuda(scale, "scale", align=4)
    if n and cols:
        fn = build.entry("span", f"span_apply_{build.dtype_tag(dst.dtype)}")
        build.check(fn(q.data_ptr(), scale.data_ptr(), dst.data_ptr(), n,
                       cols, q.shape[1], start, bits,
                       build.stream_ptr(dst.device)), "quant_span_apply")
        build.LAUNCHES["quant_span_apply"] += 1
    return dst
