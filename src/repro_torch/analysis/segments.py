"""Segment-composed cost accounting for the roofline analysis (port of
``repro.analysis.segments``).

The port's step is eager, so a whole step could be counted in one fake
run; the composer keeps the reference's shape all the same, because a
segment's cost is what a perf change moves: each *segment* of the step
(one layer's forward and backward, the embedding, the loss head, the
parameter gather, the gradient reduce, the optimizer, the compression)
runs once under ``FakeTensorMode`` on the CPU device, in the live fake
process group of ``launch/dryrun.py``, at one rank's shapes, and its
cost is multiplied by its trip count in the real step:

    total = sum over segments of count(seg) x cost(run(seg))

What a run counts (per device):

* **flops** — ``torch.utils.flop_counter.FlopCounterMode``: matrix
  products and convolutions only (XLA's count adds elementwise work);
* **bytes** — the op record (``hlo_stats.OpRecorder``): each input of an
  op that is not a view read once and each output written once, what an
  eager, unfused step moves (XLA's ``bytes accessed`` is after fusion);
* **coll_bytes / coll_count** — ``hlo_stats.collective_bytes``.

The segments follow what the port's sharded step does
(``distributed/step_builder.py``), which is not what GSPMD does: FSDP-style
data parallelism, every parameter gathered whole, the batch split, no
tensor-parallel compute. A layer runs on the gathered layer weights and
the rank's batch rows, through the same ``torch.utils.checkpoint``
wrapper as the model (``lm._run``), so the recompute counts.

The reference's ``ops.scan_unroll`` / ``set_analysis_unroll`` and
``normalize_cost_analysis`` have no counterpart: the port's loops are
eager Python, and a fake run counts every iteration. xLSTM keeps the
reference's trick all the same — its sLSTM runs one step per token, so a
pair is run at S' = min(S, 256) and its count scaled by S / S'.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.analysis.hlo_stats import OpRecorder, collective_bytes
from repro_torch.configs.base import DTYPES, ArchConfig, ShapeConfig
from repro_torch.core import steps as steps_lib
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import step_builder as sb
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import encdec, lm, ops
from repro_torch.models.param import ParamSpec, is_spec, is_stacked
from repro_torch.optim.adam import AdamState


@dataclasses.dataclass
class Segment:
    name: str
    count: int                  # static trip count in the real step
    fn: Callable                # positional fn run on fake tensors
    args: tuple                 # meta tensors (this rank's shapes)


# --------------------------------------------------------------------------
# fake runs
# --------------------------------------------------------------------------

#: plain version in ``kernels.ref`` -> the kernel it stands for
_KERNEL_OF = {"span_decode_ref": "quant_span_decode"}


@contextlib.contextmanager
def fake_run():
    """``FakeTensorMode`` (CPU device, no byte allocated) with a
    ``FlopCounterMode`` and an :class:`OpRecorder` below it; yields
    (flop counter, recorder). Inside, every plain version of a
    hand-written kernel (``kernels.ref.*_ref``, what the wrappers run on
    CPU tensors) is recorded as its kernel (``OpRecorder.call_kernel``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(), FlopCounterMode(display=False) as fc, \
            OpRecorder() as rec:
        plain = {n: getattr(kref, n) for n in dir(kref) if n.endswith("_ref")}
        for n, fn in plain.items():
            setattr(kref, n, functools.partial(
                rec.call_kernel, _KERNEL_OF.get(n, n[:-len("_ref")]), fn))
        try:
            yield fc, rec
        finally:
            for n, fn in plain.items():
                setattr(kref, n, fn)


def materialize(tree):
    """Fake CPU tensors for a tree of meta tensors (inside
    :func:`fake_run`)."""
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def local_blocks(tree):
    """This rank's block of every meta tensor that carries a
    ``.sharding`` (a live mesh), as a meta tensor; others as they are."""
    def one(t):
        sh = getattr(t, "sharding", None)
        if sh is None or not shd.is_live(sh.mesh):
            return t
        sl = sh.slices(tuple(t.shape), shd.coordinate(sh.mesh))
        shape = tuple(s.stop - s.start for s in sl)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return tree_map(one, tree)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _layer_params(layer_specs_tree, pdtype):
    """One layer's whole (gathered) params: the leading 'layers' dim
    stripped."""
    def one(s: ParamSpec):
        return _meta(s.shape[1:], DTYPES[s.dtype] if s.dtype else pdtype)
    return tree_map(one, layer_specs_tree, is_leaf=is_spec)


def _grad_of(block_fn, cfg: ArchConfig):
    """fwd+bwd of a block through the model's remat wrapper, as in the
    real step: gradients of the block's weights and input."""
    def f(lp, h, *rest):
        leaves = [t.requires_grad_(True) for t in tree_leaves(lp)]
        h = h.requires_grad_(True)
        with torch.enable_grad():
            out = lm._run(block_fn, cfg, lp, h, *rest)
            out0 = out[0] if isinstance(out, tuple) else out
            loss = out0.float().sum() * 1e-6
            if isinstance(out, tuple) and isinstance(out[1], torch.Tensor) \
                    and out[1].dim() == 0:
                loss = loss + out[1].float()
            return torch.autograd.grad(loss, leaves + [h])
    return f


def _positions(x):
    """Token positions of a (B, S, d) activation, made inside the run."""
    return torch.arange(x.shape[1])


def _batch_rows(ctx, B: int, S: int, accum: int) -> int:
    """Rows of each micro-batch that this rank computes on."""
    rows = sb._BatchShard(ctx, B, S, accum).rows
    return rows.stop - rows.start


# --------------------------------------------------------------------------
# per-shape segment builders
# --------------------------------------------------------------------------

def _block_segments(model, B: int, S: int, count_scale: int, grad: bool
                    ) -> List[Segment]:
    """The layer segments of a train (``grad``) or prefill step on ``B``
    local rows of ``S`` tokens; counts multiplied by ``count_scale``."""
    cfg: ArchConfig = model.cfg
    cdt, pdt = cfg.cdtype(), cfg.pdtype()
    wrap = (lambda fn: _grad_of(fn, cfg)) if grad else \
        (lambda fn: lambda *a: fn(*a))
    segs: List[Segment] = []
    if cfg.arch_type == "audio":
        Ss = encdec.src_len(cfg, S)
        segs.append(Segment(
            "enc_layer", cfg.n_encoder_layers * count_scale,
            wrap(lambda lp, x: encdec.enc_block(lp, x, cfg, _positions(x))),
            (_layer_params(model.specs["enc_layers"], pdt),
             _meta((B, Ss, cfg.d_model), cdt))))
        segs.append(Segment(
            "dec_layer", cfg.n_layers * count_scale,
            wrap(lambda lp, x, m: encdec.dec_block(lp, x, m, cfg,
                                                   _positions(x))),
            (_layer_params(model.specs["dec_layers"], pdt),
             _meta((B, S, cfg.d_model), cdt),
             _meta((B, Ss, cfg.d_model), cdt))))
    elif cfg.arch_type == "ssm":
        # xLSTM block cost is linear in S (fixed mLSTM chunk width, one
        # sLSTM step per token): run at S' = min(S, 256) and scale the
        # count by S / S'
        Sp = min(S, 256)
        segs.append(Segment(
            "xlstm_pair", (cfg.n_layers // 2) * count_scale * (S // Sp),
            wrap(lambda lp, x: lm._ssm_pair(lp, x, cfg)),
            (_layer_params(model.specs["layers"], pdt),
             _meta((B, Sp, cfg.d_model), cdt))))
    else:
        wins = lm.layer_windows(cfg).tolist()
        for w in sorted(set(wins)):
            fn = (lambda lp, x, _w=w: lm._std_block(
                lp, x, cfg, _positions(x), _w))
            if not grad:
                fn = (lambda lp, x, _f=fn: _f(lp, x)[0])
            segs.append(Segment(
                f"layer_w{w}", wins.count(w) * count_scale, wrap(fn),
                (_layer_params(model.specs["layers"], pdt),
                 _meta((B, S, cfg.d_model), cdt))))
    return segs


def _head_weight(cfg: ArchConfig):
    return _meta((cfg.d_model, cfg.vocab), cfg.pdtype())


def _gather_segment(model) -> Segment:
    """Every parameter gathered whole from this rank's blocks
    (``gather_tree``), once per step."""
    psh = sb.param_shardings(model)
    return Segment("gather", 1, lambda loc: sb.gather_tree(loc, psh),
                   (local_blocks(model.abstract_params(psh)),))


def train_segments(model, shape: ShapeConfig, *,
                   mode: str = "lowdiff_sharded") -> List[Segment]:
    """The sharded train step's segments; ``mode`` ``dense`` leaves out
    LowDiff's compression."""
    cfg: ArchConfig = model.cfg
    ctx = shd.current()
    mesh = ctx.mesh
    accum = sb.effective_accum(cfg.grad_accum, shape.global_batch,
                               sb._dp(mesh))
    S = shape.seq_len
    Bm = _batch_rows(ctx, shape.global_batch, S, accum)
    cdt, pdt = cfg.cdtype(), cfg.pdtype()
    segs = _block_segments(model, Bm, S, accum, grad=True)

    # embed (gather fwd + scatter-add bwd) on the gathered table
    def embed_seg(emb, toks):
        emb = emb.requires_grad_(True)
        with torch.enable_grad():
            h = emb.to(cdt)[toks.long()] * ops.sqrt_scale(cfg.d_model, cdt)
            return torch.autograd.grad(h.float().sum() * 1e-6, [emb])

    segs.append(Segment("embed", accum, embed_seg,
                        (_meta((cfg.vocab, cfg.d_model), pdt),
                         _meta((Bm, S), torch.int32))))

    # loss head: the model's chunked xent, fwd+bwd
    def head_seg(h, wlm, tgt):
        h, wlm = h.requires_grad_(True), wlm.requires_grad_(True)
        with torch.enable_grad():
            tot, cnt = ops.chunked_softmax_xent(h, wlm, tgt,
                                                chunk=cfg.loss_chunk,
                                                remat=cfg.remat)
            loss = tot / torch.clamp(cnt, min=1.0)
            return torch.autograd.grad(loss, [h, wlm])

    segs.append(Segment("loss_head", accum, head_seg,
                        (_meta((Bm, S, cfg.d_model), cdt), _head_weight(cfg),
                         _meta((Bm, S), torch.int32))))

    # the step's parameter all-gathers, once
    segs.append(_gather_segment(model))

    # the gradient reduce, once: the per-layer gradients stacked (as
    # core.steps._differentiable regroups them), all-reduced over the
    # ranks that split the batch, and this rank's blocks cut out
    psh = sb.param_shardings(model)
    gdt = DTYPES[cfg.grad_accum_dtype] if accum > 1 else None
    whole = tree_map(lambda t: _meta(t.shape, gdt or t.dtype),
                     model.abstract_params())
    group = sb._BatchShard(ctx, shape.global_batch, S, accum).group

    def reduce_seg(grads):
        def restack(g):
            return torch.stack([g[i] for i in range(g.shape[0])])
        grads = tree_map(lambda g, s: restack(g) if is_stacked(s) else g,
                         grads, model.specs)
        for g in tree_leaves(grads):
            col.all_reduce_(g, group)
        return sb.shard_tree(grads, psh)

    segs.append(Segment("reduce", 1, reduce_seg, (whole,)))

    # optimizer on the local blocks, once
    loc_p = local_blocks(model.abstract_params(psh))
    loc_g = tree_map(lambda t: _meta(t.shape, torch.float32), loc_p)

    def opt_seg(p, g, mu, nu):
        count = torch.ones((), dtype=torch.int32)
        hyper = kops.adam_hyper_traced(1e-3, 0.9, 0.999, 1e-8, count)
        return steps_lib._apply_tree(p, g, AdamState(mu, nu, count), hyper,
                                     count)

    segs.append(Segment("optimizer", 1, opt_seg,
                        (loc_p, loc_g, loc_g, loc_g)))

    if mode == "dense":
        return segs
    # LowDiff's shard-local compression of the local gradient blocks, once
    pspecs = tree_map(lambda s: s.spec, psh, is_leaf=sb._is_sharding)
    segs.append(Segment(
        "compress", 1,
        lambda g: sb.compress_sharded(g, pspecs, mesh, 0.01), (loc_g,)))
    return segs


def _lm_head_segment(model, B: int, group) -> Segment:
    """Final-position logits of the local rows, all-gathered over the
    batch shards (the sharded prefill / serve steps' last work)."""
    cfg = model.cfg

    def head(x, w):
        logits = torch.matmul(x.float(), w.to(x.dtype).float())
        return col.gather_from(logits, 0, group)

    return Segment("lm_head", 1, head,
                   (_meta((B, cfg.d_model), cfg.cdtype()), _head_weight(cfg)))


def prefill_segments(model, shape: ShapeConfig) -> List[Segment]:
    ctx = shd.current()
    B, S = shape.global_batch, shape.seq_len
    bshard = sb._BatchShard(ctx, B, S, 1)
    Bl = bshard.rows.stop - bshard.rows.start
    segs = _block_segments(model, Bl, S, 1, grad=False)
    segs.append(_gather_segment(model))
    segs.append(_lm_head_segment(model, Bl, bshard.group))
    return segs


def decode_segments(model, shape: ShapeConfig) -> List[Segment]:
    """The sharded serve step: every parameter and every cache leaf
    gathered whole, one layer's decode on the rank's batch rows against
    its whole-sequence cache, the head."""
    cfg: ArchConfig = model.cfg
    ctx = shd.current()
    B, seq_len = shape.global_batch, shape.seq_len
    bshard = sb._BatchShard(ctx, B, 1, 1)
    Bl = bshard.rows.stop - bshard.rows.start
    cdt, pdt = cfg.cdtype(), cfg.pdtype()
    h = _meta((Bl, 1, cfg.d_model), cdt)
    cache = model.init_cache(Bl, seq_len, device="meta")
    full = model.init_cache(B, seq_len, device="meta")
    cache_sh = shd.safe_sharding_tree(full, model.cache_logical())
    cache_abs = shd.zip_up_to(
        lambda t, s: sb._meta(tuple(t.shape), t.dtype, s), full, cache_sh)
    one = lambda c: lm.cache_slice(c, 0)  # noqa: E731
    Lc = lm.cache_len(cfg, seq_len)
    ring = Lc < seq_len
    segs: List[Segment] = []

    def pos():
        return torch.full((), seq_len - 1, dtype=torch.int32)

    if cfg.arch_type == "ssm":
        segs.append(Segment(
            "xlstm_pair_decode", cfg.n_layers // 2,
            lambda lp, x, m, s: lm.ssm_decode_block(lp, x, cfg, m, s),
            (_layer_params(model.specs["layers"], pdt), h,
             one(cache.mlstm), one(cache.slstm))))
    elif cfg.arch_type == "audio":
        segs.append(Segment(
            "dec_layer_decode", cfg.n_layers,
            lambda lp, x, a, b, c, d: encdec.dec_decode_block(
                lp, x, cfg, a, b, c, d, pos(), ring),
            (_layer_params(model.specs["dec_layers"], pdt), h,
             cache.k[0], cache.v[0], cache.cross_k[0], cache.cross_v[0])))
    else:
        wins = lm.layer_windows(cfg).tolist()
        hybrid = cfg.arch_type == "hybrid"
        for w in sorted(set(wins)):
            args = (_layer_params(model.specs["layers"], pdt), h,
                    cache.k[0], cache.v[0])
            if hybrid:
                args += (one(cache.mamba),)
            segs.append(Segment(
                f"layer_decode_w{w}", wins.count(w),
                lambda lp, x, a, b, m=None, _w=w: lm.decode_block(
                    lp, x, cfg, a, b, pos(), window=_w, ring=ring, mam=m),
                args))

    # the serve step's gathers (params and every cache leaf, whole) and
    # its copy of the rank's batch rows of the cache
    rows = bshard.rows
    psh = sb.param_shardings(model)

    def gather(params, cache):
        whole = sb.gather_tree(params, psh)
        cache = shd.zip_up_to(lambda t, _: t[:, rows].contiguous(),
                              sb.gather_tree(cache, cache_sh), cache_sh)
        return whole, cache

    segs.append(Segment("gather", 1, gather,
                        (local_blocks(model.abstract_params(psh)),
                         local_blocks(cache_abs))))
    segs.append(_lm_head_segment(model, Bl, bshard.group))
    return segs


def segments_for(model, shape: ShapeConfig, *,
                 train_mode: str = "lowdiff_sharded") -> List[Segment]:
    if shape.kind == "train":
        return train_segments(model, shape, mode=train_mode)
    if shape.kind == "prefill":
        return prefill_segments(model, shape)
    return decode_segments(model, shape)


# --------------------------------------------------------------------------
# running + accounting
# --------------------------------------------------------------------------

def measure_segment(seg: Segment) -> Dict[str, float]:
    with fake_run() as (fc, rec):
        args = materialize(seg.args)
        with torch.no_grad():
            seg.fn(*args)
    coll = collective_bytes(rec)
    return {"flops": float(fc.get_total_flops()),
            "bytes": float(rec.bytes_moved()),
            "coll_bytes": float(coll.get("total", 0)),
            "coll_count": int(coll.get("count", 0))}


def compose(model, shape: ShapeConfig, *,
            train_mode: str = "lowdiff_sharded") -> Dict:
    """Per-device composed cost over all segments."""
    segs = segments_for(model, shape, train_mode=train_mode)
    total = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    detail = []
    for seg in segs:
        m = measure_segment(seg)
        for k in total:
            total[k] += m[k] * seg.count
        detail.append({"segment": seg.name, "count": seg.count, **m})
    return {"total": total, "segments": detail}
