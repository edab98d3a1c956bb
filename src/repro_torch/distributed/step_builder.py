"""Sharded train / prefill / serve step builders (port of
``repro.distributed.step_builder``) on ``torch.distributed``.

Layouts come from the models' logical axes through the active mesh's
rules (:mod:`repro_torch.distributed.sharding`), with the reference's
divisibility-safe fallback: the train state (params, Adam moments,
error feedback), the batch, and the decode cache.

What runs on a live mesh: each rank holds its blocks of the state, by
the specs. A train step gathers every parameter, runs the port's
unsharded loss and gradient (``core.steps._grads``) on this rank's shard
of the batch, sums the gradients over the ranks that split the batch,
takes its block of each gradient and applies Adam to its blocks through
the dense update (K3 on the card). That is FSDP-style data parallelism
with the state sharded over every mesh axis; no compute is tensor
parallel (the reference's GSPMD also splits the matmuls). Results equal
the unsharded step's up to the reassociation of the sums over data
shards, and bit for bit on a world of one rank.

LowDiff on a sharded mesh: compression is *shard-local*
(:func:`compress_sharded`) — each rank runs the block top-k (K1 on the
card) on its own gradient block, so the differential checkpoint is
sharded like the optimizer state and no gathered gradient is
compressed.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.compression.sparse import SparseGrad, topk_compress
from repro_torch.data.synthetic import input_specs
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.param import abstractify, is_spec
from repro_torch.optim.adam import AdamState

#: logical axes of the batch inputs
BATCH_LOGICAL = {"tokens": ("batch", None), "targets": ("batch", None),
                 "loss_mask": ("batch", None),
                 "patch_embeds": ("batch", None, None),
                 "src_embeds": ("batch", None, None), "pos": ()}


# --------------------------------------------------------------------------
# sharding trees for the train state
# --------------------------------------------------------------------------

def param_shardings(model):
    return shd.safe_sharding_tree(model.abstract_params(),
                                  model.logical_axes())


def state_shardings(model, *, mode: str = "lowdiff",
                    error_feedback: bool = True) -> Dict[str, Any]:
    ctx = shd.current()
    psh = param_shardings(model)
    rep = shd.NamedSharding(ctx.mesh, shd.P())
    out = {"params": psh,
           "opt": AdamState(mu=psh, nu=psh, count=rep),
           "step": rep}
    if mode == "lowdiff" and error_feedback:
        out["ef"] = psh
    return out


def _meta(shape, dtype, sharding):
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.sharding = sharding
    return t


def abstract_state(model, *, mode: str = "lowdiff",
                   error_feedback: bool = True) -> Dict[str, Any]:
    """The train state as ``meta`` tensors, each with its ``.sharding``."""
    from repro_torch.configs.base import DTYPES
    sh = state_shardings(model, mode=mode, error_feedback=error_feedback)

    def f32(spec, s):
        dt = DTYPES[spec.dtype] if spec.dtype else torch.float32
        return _meta(spec.shape, dt, s)

    out = {"params": abstractify(model.specs, model.cfg.pdtype(),
                                 sh["params"]),
           "opt": AdamState(
               tree_map(f32, model.specs, sh["opt"].mu, is_leaf=is_spec),
               tree_map(f32, model.specs, sh["opt"].nu, is_leaf=is_spec),
               _meta((), torch.int32, sh["step"])),
           "step": _meta((), torch.int32, sh["step"])}
    if "ef" in sh:
        out["ef"] = tree_map(f32, model.specs, sh["ef"], is_leaf=is_spec)
    return out


def batch_shardings(model, shape_cfg):
    ctx = shd.current()
    specs = input_specs(model.cfg, shape_cfg)
    return {k: shd.NamedSharding(ctx.mesh, shd.safe_spec(
                v.shape, ctx.spec(BATCH_LOGICAL[k]), ctx.mesh))
            for k, v in specs.items()}


def abstract_batch(model, shape_cfg):
    return input_specs(model.cfg, shape_cfg,
                       shardings=batch_shardings(model, shape_cfg))


# --------------------------------------------------------------------------
# blocks of whole trees (live mesh)
# --------------------------------------------------------------------------

def _is_sharding(x) -> bool:
    return isinstance(x, shd.NamedSharding)


def global_shape(local_shape, spec, mesh):
    sizes = shd.mesh_shape(mesh)
    full = tuple(spec) + (None,) * (len(local_shape) - len(spec))
    return tuple(d * math.prod(sizes[a] for a in shd.dim_axes(ax))
                 for d, ax in zip(local_shape, full))


def shard_tree(tree, shardings):
    """This rank's blocks (contiguous) of a tree of whole tensors, by a
    matching tree of NamedShardings on a live mesh."""
    def one(x, sh):
        coord = shd.coordinate(sh.mesh)
        return x[sh.slices(tuple(x.shape), coord)].contiguous()
    return shd.zip_up_to(one, tree, shardings)


def gather_tree(tree, shardings):
    """Whole tensors from every rank's blocks (inverse of shard_tree)."""
    return shd.zip_up_to(
        lambda x, sh: col.gather_leaf(
            x, global_shape(x.shape, sh.spec, sh.mesh), sh.spec, sh.mesh),
        tree, shardings)


# --------------------------------------------------------------------------
# shard-local gradient compression
# --------------------------------------------------------------------------

def compress_sharded(grads, pspecs, mesh, rho: float):
    """Blockwise top-k (K1 on the card) of each device's *local* gradient
    block, the block flattened in its own row-major order and padded to
    whole 1,024-blocks on its own.

    On a live mesh ``grads`` are this rank's blocks, and each leaf's
    result holds this rank's rows of the global ``SparseGrad`` (shape =
    the whole leaf's). On an abstract mesh ``grads`` are whole tensors:
    every distinct block is compressed in this process, rank by rank,
    and the rows are concatenated as the reference's ``out_spec`` does —
    over the axes the spec names, in the spec's order, the first major;
    a mesh axis the spec does not name holds copies and adds none."""
    specs = shd.spec_leaves(pspecs)
    leaves = tree_leaves(grads)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} gradient leaves, {len(specs)} specs")
    sizes = shd.mesh_shape(mesh)
    outs = []
    for g, spec in zip(leaves, specs):
        if shd.is_live(mesh):
            sg = topk_compress(g.contiguous(), rho)
            outs.append(SparseGrad(sg.values, sg.indices,
                                   global_shape(g.shape, spec, mesh)))
            continue
        order = spec.axes()
        vals, idx = [], []
        for c in itertools.product(*(range(sizes[a]) for a in order)):
            coord = {a: 0 for a in sizes}
            coord.update(zip(order, c))
            blk = g[shd.block_slices(g.shape, spec, mesh, coord)]
            sg = topk_compress(blk.contiguous(), rho)
            vals.append(sg.values)
            idx.append(sg.indices)
        outs.append(SparseGrad(torch.cat(vals), torch.cat(idx),
                               tuple(g.shape)))
    it = iter(outs)
    return tree_map(lambda _: next(it), grads)


def gather_compressed(cg, pspecs, mesh):
    """The global ``SparseGrad`` tree (rows in ``out_spec`` order) from
    every rank's rows on a live mesh."""
    specs = shd.spec_leaves(pspecs)
    leaves = tree_leaves(cg, is_leaf=lambda x: isinstance(x, SparseGrad))
    sizes = shd.mesh_shape(mesh)
    names = shd.axis_names(mesh)
    outs = []
    for sg, spec in zip(leaves, specs):
        order = spec.axes()
        group = shd.axis_group(mesh, order)
        parts = []
        for t in (sg.values, sg.indices):
            n = col.group_size(group)
            buf = col.all_gather_stack(t, group)
            mesh_order = [a for a in names if a in order]
            at = {}
            for j in range(n):
                coord, rest = {}, j
                for a in reversed(mesh_order):
                    coord[a] = rest % sizes[a]
                    rest //= sizes[a]
                k = 0
                for a in order:
                    k = k * sizes[a] + coord[a]
                at[k] = buf[j]
            parts.append(torch.cat([at[k] for k in range(n)]))
        outs.append(SparseGrad(parts[0], parts[1], sg.shape, sg.block))
    it = iter(outs)
    return tree_map(lambda _: next(it), cg,
                    is_leaf=lambda x: isinstance(x, SparseGrad))


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def effective_accum(cfg_accum: int, global_batch: int, dp: int) -> int:
    """Largest accum <= cfg_accum such that the microbatch still spans
    the data-parallel shards evenly."""
    limit = max(1, global_batch // dp)
    a = min(cfg_accum, limit)
    while a > 1 and (global_batch % a or (global_batch // a) % dp):
        a -= 1
    return max(a, 1)


def _dp(mesh) -> int:
    sizes = shd.mesh_shape(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


class _BatchShard:
    """Which rows of a global batch this rank computes on: the micro-batch
    rows that the batch spec gives its coordinate, in each of ``accum``
    micro-batches (so micro-batch i of the shard is its part of global
    micro-batch i), and the group of ranks that split the batch."""

    def __init__(self, ctx, B: int, S: int, accum: int):
        self.mesh, self.accum = ctx.mesh, accum
        self.spec = shd.safe_spec((B // accum, S), ctx.spec(("batch", None)),
                                  ctx.mesh)
        self.group = shd.axis_group(ctx.mesh, self.spec.axes())
        self.rows = shd.block_slices((B // accum, S), self.spec, ctx.mesh,
                                     shd.coordinate(ctx.mesh))[0]

    def take(self, batch):
        def one(x):
            if x.dim() == 0:
                return x
            a = self.accum
            xm = x.reshape((a, -1) + tuple(x.shape[1:]))[:, self.rows]
            return xm.reshape((-1,) + tuple(x.shape[1:]))
        return {k: one(v) for k, v in batch.items()}


class _ShardLoss:
    """``model.loss_fn`` on this rank's batch shard, scaled by the shard's
    share of the tokens of the ranks that split the batch (all-reduced):
    the sum over shards of the scaled losses and of their gradients is
    the whole batch's. On one rank the scale is exactly 1."""

    def __init__(self, model, group):
        self.model, self.cfg, self.group = model, model.cfg, group
        self.specs = model.specs

    def loss_fn(self, params, batch):
        loss, metrics = self.model.loss_fn(params, batch)
        cnt = metrics["tokens"].detach().float()
        tot = col.all_reduce_(cnt.clone(), self.group)
        return loss * (cnt / torch.clamp(tot, min=1.0)), metrics


def _require_live(mesh, what: str):
    if not shd.is_live(mesh):
        raise RuntimeError(f"{what} runs on a live mesh (a DeviceMesh over "
                           f"an initialised process group); {mesh!r} is "
                           f"abstract")


def make_sharded_train_step(model, shape_cfg, *, mode: str = "dense",
                            rho: float = 0.01, lr: float = 1e-3,
                            error_feedback: bool = False,
                            donate: bool = True):
    """Returns (step, abstract_state, abstract_batch).

    ``step(state, batch) -> (state', metrics, extra)`` takes this rank's
    blocks of the state (``shard_tree``) and the *global* batch, and
    returns its blocks of the new state. ``metrics["loss"]`` is the whole
    batch's loss; the other metrics are this rank's shard's. Modes:

    * ``dense`` — Adam (K3) on the local blocks; extra None;
    * ``lowdiff_sharded`` — the reference's inner ``lowdiff_plus`` step
      (dense Adam, no error feedback) whose gradient is compressed
      shard-locally: extra is :func:`compress_sharded` of the local
      gradient blocks (this rank's rows of each ``SparseGrad``);
    * ``lowdiff`` / ``lowdiff_plus`` — the unsharded step's modes,
      passed through: the state's blocks (and error feedback) are
      gathered, the unsharded update runs on whole leaves with the
      gradient summed over shards (``lowdiff`` compresses each *global*
      leaf, as the reference's GSPMD does), and the new state is cut
      back into blocks; extra is the whole compressed or dense gradient.

    ``donate`` is accepted for the reference's signature; the state is
    replaced, never updated in place, as in the unsharded step.
    """
    del donate
    from repro_torch.core import steps as steps_lib
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    ctx = shd.current()
    mesh = ctx.mesh
    accum = effective_accum(model.cfg.grad_accum, shape_cfg.global_batch,
                            _dp(mesh))
    model = build_model(model.cfg.replace(grad_accum=accum))
    st_sh = state_shardings(model, mode=mode, error_feedback=error_feedback)
    abs_state = abstract_state(model, mode=mode,
                               error_feedback=error_feedback)
    abs_batch = abstract_batch(model, shape_cfg)
    if not shd.is_live(mesh):
        def step(state, batch):
            _require_live(mesh, "make_sharded_train_step's step")
        return step, abs_state, abs_batch

    bshard = _BatchShard(ctx, shape_cfg.global_batch, shape_cfg.seq_len,
                         accum)
    shard_model = _ShardLoss(model, bshard.group)
    psh = st_sh["params"]
    pspecs = tree_map(lambda s: s.spec, psh, is_leaf=_is_sharding)

    def reduce(grads):
        for g in tree_leaves(grads):
            col.all_reduce_(g, bshard.group)
        return grads

    def global_loss(loss):
        return col.all_reduce_(loss.detach().clone(), bshard.group)

    if mode in ("lowdiff", "lowdiff_plus"):
        inner = steps_lib.make_train_step(
            shard_model, mode=mode, rho=rho, lr=lr,
            error_feedback=error_feedback, reduce_grads=reduce)

        def step(state, batch):
            whole = gather_tree(state, st_sh)
            with shd.use_mesh(mesh, ctx.rules):
                new, metrics, extra = inner(whole, bshard.take(batch))
            del whole
            metrics = dict(metrics, loss=global_loss(metrics["loss"]))
            return shard_tree(new, st_sh), metrics, extra
        return step, abs_state, abs_batch

    if mode not in ("dense", "lowdiff_sharded"):
        raise ValueError(f"unknown sharded step mode {mode!r}")
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(state, batch):
        params = state["params"]
        whole = gather_tree(params, psh)
        with shd.use_mesh(mesh, ctx.rules):
            loss, metrics, grads = steps_lib._grads(
                shard_model, whole, bshard.take(batch), accum)
        del whole
        grads = shard_tree(reduce(grads), psh)
        opt = state["opt"]
        count = opt.count + 1
        hyper = ops.adam_hyper_traced(lr, b1, b2, eps, count)
        params2, opt2 = steps_lib._apply_tree(params, grads, opt, hyper,
                                              count)
        extra = (compress_sharded(grads, pspecs, mesh, rho)
                 if mode == "lowdiff_sharded" else None)
        new_state = {"params": params2, "opt": opt2,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=global_loss(loss)), extra

    return step, abs_state, abs_batch


def make_sharded_prefill_step(model, shape_cfg):
    """Returns (step, abstract_params, abstract_batch).

    ``step(params, batch)`` takes this rank's parameter blocks and the
    global batch, and returns the whole batch's final-position logits
    (B, V) in f32 on every rank. Per call it gathers every parameter
    and all-gathers the logits of the batch shards."""
    ctx = shd.current()
    mesh = ctx.mesh
    psh = param_shardings(model)
    abs_params = model.abstract_params(psh)
    abs_batch = abstract_batch(model, shape_cfg)
    if not shd.is_live(mesh):
        def step(params, batch):
            _require_live(mesh, "make_sharded_prefill_step's step")
        return step, abs_params, abs_batch
    bshard = _BatchShard(ctx, shape_cfg.global_batch, shape_cfg.seq_len, 1)

    def step(params, batch):
        whole = gather_tree(params, psh)
        with torch.no_grad(), shd.use_mesh(mesh, ctx.rules):
            logits = model.logits_fn(whole, bshard.take(batch))
            return col.gather_from(logits, 0, bshard.group)
    return step, abs_params, abs_batch


def make_sharded_serve_step(model, shape_cfg, *, donate: bool = True):
    """Returns (step, abstract_params, abstract_cache, abstract_batch).

    ``step(params, cache, batch) -> (logits, cache')``: one decode token
    from this rank's parameter and cache blocks (the cache laid out by
    ``cache_logical``: batch over data, KV sequence over model) and the
    global decode batch; logits (B, V) f32 on every rank, and this rank's
    new cache blocks. Per call it gathers every parameter and every
    cache leaf whole, decodes its batch shard with the port's in-place
    decode step on the gathered cache, and cuts its blocks back out; it
    all-gathers the logits of the batch shards. ``donate`` is accepted
    for the reference's signature."""
    del donate
    ctx = shd.current()
    mesh = ctx.mesh
    seq_len = shape_cfg.seq_len
    B = shape_cfg.global_batch
    psh = param_shardings(model)
    abs_params = model.abstract_params(psh)
    cache_meta = model.init_cache(B, seq_len, device="meta")
    cache_sh = shd.safe_sharding_tree(cache_meta, model.cache_logical())
    cache_abs = shd.zip_up_to(
        lambda t, s: _meta(tuple(t.shape), t.dtype, s), cache_meta, cache_sh)
    abs_batch = abstract_batch(model, shape_cfg)
    if not shd.is_live(mesh):
        def step(params, cache, batch):
            _require_live(mesh, "make_sharded_serve_step's step")
        return step, abs_params, cache_abs, abs_batch
    bshard = _BatchShard(ctx, B, 1, 1)
    coord = shd.coordinate(mesh)
    blocks = shd.zip_up_to(lambda t, s: s.slices(tuple(t.shape), coord),
                           cache_meta, cache_sh)

    def cut(t, sl):
        """This rank's block of a leaf decoded on its batch rows (dim 1,
        after the stacked layers: the cache splits the batch as the
        tokens do)."""
        if sl[1] != bshard.rows:
            raise ValueError(f"cache batch block {sl[1]} is not the "
                             f"tokens' {bshard.rows}")
        return t[(sl[0], slice(None)) + tuple(sl[2:])].contiguous()

    def step(params, cache, batch):
        whole = gather_tree(params, psh)
        full = gather_tree(cache, cache_sh)
        mine = shd.zip_up_to(lambda t, _: t[:, bshard.rows].contiguous(),
                             full, cache_sh)
        del full
        with torch.no_grad(), shd.use_mesh(mesh, ctx.rules):
            logits, mine = model.decode_step(whole, mine,
                                             bshard.take(batch), seq_len)
        del whole
        return (col.gather_from(logits, 0, bshard.group),
                shd.zip_up_to(cut, mine, blocks))

    return step, abs_params, cache_abs, abs_batch
