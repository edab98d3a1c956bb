"""Collective bytes per category and op histograms (port of
``repro.analysis.hlo_stats``).

The port has no HLO. What it reads instead is an **op record**: every
aten and ``c10d`` op dispatched while a step runs, with the dtypes and
shapes of its inputs and outputs, taken by :class:`OpRecorder` (a
``TorchDispatchMode``, the port's stand-in for ``compiled.as_text()``).
On fake tensors in a fake process group (``launch/dryrun.py``) the
shapes are one rank's, so the totals are per device, as the reference's
partitioned HLO gives them.

:func:`collective_bytes` and :func:`op_histogram` take either an op
record or HLO text; the text parser is the reference's, unchanged, so a
reference dry run's ``hlo_text`` reads here too, and
:meth:`OpRecorder.text` renders a record in HLO's syntax, which the
reference's parser reads. Collective bytes are per-device *result*
bytes, as in the reference: ``c10d.allreduce_`` -> all-reduce,
``_allgather_base_`` / ``allgather_`` -> all-gather,
``_reduce_scatter_base_`` / ``reduce_scatter_`` -> reduce-scatter,
``alltoall_base_`` / ``alltoall_`` -> all-to-all, send / recv ->
collective-permute (a send has no result: its input counts).

A hand-written kernel's plain version (what its wrapper runs on a CPU
tensor) is recorded as the kernel: one op ``kernel.<name>``
(:meth:`OpRecorder.call_kernel`; ``analysis.segments.fake_run`` routes
every plain version of ``kernels.ref`` through it).

The recorder also keeps the live bytes of the storages that ops create
(:attr:`OpRecorder.peak_bytes`): each storage is counted when an op's
output brings it in and released, by a weakref on the storage, when it
dies. Under ``FakeTensorMode`` no byte is allocated, and the peak is
what the same eager run would hold on the device, before the caching
allocator's rounding.
"""
from __future__ import annotations

import re
import weakref
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op (overload packet name) -> HLO collective category
C10D_CATEGORY = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: torch dtype -> HLO element type
_HLO_DTYPE = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

#: allocation without a write: no bytes moved
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like"}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s*(\(?[^=]*?\)?)\s*(" + "|".join(COLLECTIVES) + r")(-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


Sig = Tuple[str, Tuple[int, ...]]       # (HLO element type, shape)


class OpRecord(NamedTuple):
    """One dispatched op: its namespace and name (``aten.mm``,
    ``c10d.allreduce_``), the signatures of its tensor inputs and
    outputs, and whether it only makes a view."""
    name: str
    ins: Tuple[Sig, ...]
    outs: Tuple[Sig, ...]
    view: bool

    @property
    def result(self) -> Tuple[Sig, ...]:
        """What a collective leaves on this device: its outputs, or, for
        a c10d op that returns only its work handle, its first tensor
        argument (the buffer it fills, or the tensor a send sends)."""
        return self.outs or self.ins[:1]

    @property
    def category(self) -> str:
        """The HLO collective category of a c10d op, else ''."""
        ns, _, op = self.name.partition(".")
        return C10D_CATEGORY.get(op, "") if ns == "c10d" else ""

    def nbytes(self, sigs) -> int:
        return sum(_shape_bytes(dt, ",".join(map(str, shp)))
                   for dt, shp in sigs)


def _sig(t: torch.Tensor) -> Sig:
    return (_HLO_DTYPE.get(t.dtype, str(t.dtype)), tuple(int(d) for d in
                                                         t.shape))


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched below it (see the module docstring)
    and tracks the live bytes of the storages their outputs hold.

    ``track(tree)`` counts tensors made before the recorder saw them (a
    step's arguments). ``live_bytes`` / ``peak_bytes`` are the bytes of
    the storages alive now / at most since the recorder was made."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._seen: Dict[OpRecord, OpRecord] = {}
        self._in_kernel = False

    # -- memory -----------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return                      # no storage (sparse, nested)
        key = st._cdata
        if key in self._live:
            return
        n = int(st.nbytes())
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def track(self, tree) -> int:
        """Counts the storages of ``tree``'s tensors as live; returns the
        live bytes after."""
        for t in _tensors(tree):
            self._hold(t)
        return self.live_bytes

    def live_storages(self) -> List[int]:
        """Keys of the storages alive now."""
        return list(self._live)

    def held_bytes(self, tree, exclude=()) -> int:
        """The bytes of the distinct storages of ``tree``'s tensors, those
        whose keys are in ``exclude`` left out."""
        seen = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in exclude:
                seen[st._cdata] = int(st.nbytes())
        return sum(seen.values())

    # -- hand-written kernels ---------------------------------------------
    def call_kernel(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, the plain version of the hand-written
        kernel ``name`` (what its wrapper runs on the CPU), recorded as
        the kernel runs on the card: one op ``kernel.<name>`` that reads
        its tensor arguments once and writes its results once, and
        holds only its results (the kernel allocates nothing else)."""
        if self._in_kernel:
            return fn(*args, **kwargs)
        self._in_kernel = True
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel = False
        outs = _tensors(out)
        self.ops.append(OpRecord(
            f"kernel.{name}", tuple(_sig(t) for t in _tensors((args, kwargs))),
            tuple(_sig(t) for t in outs), False))
        for t in outs:
            self._hold(t)
        return out

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._in_kernel:
            return out
        outs = _tensors(out)
        r = OpRecord(f"{func.namespace}.{func._opname}",
                     tuple(_sig(t) for t in _tensors((args, kwargs))),
                     tuple(_sig(t) for t in outs), bool(func.is_view))
        # a loop repeats the same ops: keep one copy of each record
        self.ops.append(self._seen.setdefault(r, r))
        for t in outs:
            self._hold(t)
        return out

    # -- views of the record ---------------------------------------------
    def bytes_moved(self) -> int:
        return bytes_moved(self.ops)

    def text(self) -> str:
        return to_text(self.ops)


def bytes_moved(ops) -> int:
    """Each input read once and each output written once, over every
    aten op that is not a view or an allocation and every hand-written
    kernel (collectives are the collective term's): what an eager run
    moves through device memory, unfused but for the kernels. XLA's
    ``bytes accessed`` is counted after fusion, so the reference counts
    fewer bytes for the same step."""
    total = 0
    for r in ops:
        ns, _, op = r.name.partition(".")
        if r.view or ns not in ("aten", "kernel") or op in _NO_TRAFFIC:
            continue
        total += r.nbytes(r.ins) + r.nbytes(r.outs)
    return total


def _hlo_sig(sigs) -> str:
    parts = [f"{dt}[{','.join(map(str, shp))}]" for dt, shp in sigs]
    return parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"


def to_text(ops) -> str:
    """An op record as lines of HLO syntax (``%N = <result> <op>(<operands>)``;
    a collective under its HLO name, its result the per-device result the
    reference counts), which both packages' parsers read."""
    lines = []
    for i, r in enumerate(ops):
        op = r.category or r.name.split(".", 1)[1]
        res = r.result if r.category else r.outs
        lines.append(f"  %{i} = {_hlo_sig(res) if res else '()'} {op}("
                     f"{', '.join(_hlo_sig([s]) for s in r.ins)})")
    return "\n".join(lines)


def _collectives_of_text(hlo_text: str) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if not m:
            continue
        if m.group(3) == "-done":   # async pair: count only the -start
            continue
        result_sig, op = m.group(1), m.group(2)
        b = sum(_shape_bytes(dt, dims)
                for dt, dims in _SHAPE_RE.findall(result_sig))
        out[op] += b
        out["count"] += 1
    return out


def _records(source):
    return source.ops if isinstance(source, OpRecorder) else source


def collective_bytes(source) -> Dict[str, int]:
    """Per-category per-device bytes (+ 'total', 'count') of HLO text or
    of an op record (an :class:`OpRecorder` or its ``ops``)."""
    if isinstance(source, str):
        out = _collectives_of_text(source)
    else:
        out = defaultdict(int)
        for r in _records(source):
            if r.category:
                out[r.category] += r.nbytes(r.result)
                out["count"] += 1
    out["total"] = sum(v for k, v in out.items()
                       if k in COLLECTIVES)
    return dict(out)


def op_histogram(source, top: int = 15):
    """Most frequent ops of HLO text (opcodes) or of an op record (aten
    and c10d names): a debugging aid for perf iteration."""
    if isinstance(source, str):
        ops = re.findall(r"=\s*\(?[\w\[\],{}: ]*?\)?\s*([a-z][\w-]*)\(",
                         source)
    else:
        ops = [r.name for r in _records(source)]
    hist = defaultdict(int)
    for o in ops:
        hist[o] += 1
    return sorted(hist.items(), key=lambda kv: -kv[1])[:top]
