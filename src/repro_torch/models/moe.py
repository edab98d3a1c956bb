"""Capacity-based top-k Mixture-of-Experts layer, dense dispatch and
expert parallel (port of ``repro.models.moe``).

Dispatch is the position-in-expert formulation (Switch/T5X style) with
gathers instead of a (tokens, experts, capacity) one-hot einsum: an
assignment's slot in its expert is the number of earlier assignments to
that expert (the exclusive cumsum of the flattened ``(T·K, E)`` one-hot,
which the reference computes), assignments past the capacity go to a
drop slot ``E·C`` that holds no row, and the experts run as one batched
matmul over ``(E, C, d)``. The plan (``kernels/moe.py::plan``) also
gives its inverse, each slot's assignment ``src``, so every data
movement of the layer is a gather with no collisions: the dispatch
(:class:`_Dispatch`) gathers each slot's token row, and its backward
sums each token's slot rows; the combine (:class:`_Combine`) sums each
token's gated slot rows, and its backward gathers each slot's gated
output gradient. DeepSeekMoE-style shared experts are dense SwiGLU paths
added on top. On a live mesh with a ``model`` axis, :func:`moe_apply`
takes the expert-parallel path (:func:`_moe_apply_ep`) where the
reference does.

Two port-only options (``MoEConfig``): ``norm_topk=False`` keeps the
top-k softmax gates as they are, and ``held_experts`` makes the layer
this card's share of an expert-parallel deployment: it holds experts
``[0, held)`` only, routes over all ``n_experts`` with the capacity of
all of them, and computes the part of the result its own experts give
(the local half of the EP path's masking, without the exchange). The
router, the slotting and the gather into the expert buffers are one
``moe.route`` span when tracing is on; the backward of the dispatch and
of the combine are ``moe.route.bwd`` spans.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import moe as moe_kernels
from repro_torch.models.param import ParamSpec
from repro_torch.obs.trace import trace_span


def moe_specs(cfg: ArchConfig, layers: int) -> dict:
    d = cfg.d_model
    m = cfg.moe
    L = (layers,)
    n = m.held()
    specs = {
        "router": ParamSpec(L + (d, m.n_experts), ("layers", "fsdp", "experts")),
        "we_g": ParamSpec(L + (n, d, m.expert_ff),
                          ("layers", "experts", "fsdp", "expert_mlp")),
        "we_u": ParamSpec(L + (n, d, m.expert_ff),
                          ("layers", "experts", "fsdp", "expert_mlp")),
        "we_d": ParamSpec(L + (n, m.expert_ff, d),
                          ("layers", "experts", "expert_mlp", "fsdp")),
    }
    if m.n_shared:
        f = m.expert_ff * m.n_shared
        specs["ws_g"] = ParamSpec(L + (d, f), ("layers", "fsdp", "mlp"))
        specs["ws_u"] = ParamSpec(L + (d, f), ("layers", "fsdp", "mlp"))
        specs["ws_d"] = ParamSpec(L + (f, d), ("layers", "mlp", "fsdp"))
    return specs


def capacity(T: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(T * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: values in descending order,
    the lowest index first among equal values (``torch.topk`` promises
    no order among ties). A stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, d) -> (out, aux_loss).

    On a live mesh whose ``model`` axis (ep ranks) divides the expert
    count, with at least 16 tokens an expert, and with the batch not
    split over ``model``, this takes the expert-parallel path: each model
    rank owns E/ep experts. Under a live mesh ``x`` is this rank's data
    shard, so the token count is its tokens times the data-parallel size
    (the reference counts the global batch). Otherwise (no mesh, an
    abstract one, decode's few tokens) the dense dispatch."""
    from repro_torch.distributed import sharding as shd
    ctx = shd.current()
    if ctx is not None and shd.is_live(ctx.mesh) \
            and "model" in shd.axis_names(ctx.mesh) \
            and "model" not in ctx.spec(("batch",)).axes():
        sizes = shd.mesh_shape(ctx.mesh)
        ep = sizes["model"]
        dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
        T = x.shape[0] * x.shape[1] * dp
        if ep > 1 and cfg.moe.n_experts % ep == 0 \
                and cfg.moe.held() == cfg.moe.n_experts \
                and T >= 16 * cfg.moe.n_experts:
            return _moe_apply_ep(p, x, cfg, ctx, ep)
    return _moe_apply_dense(p, x, cfg)


def _gates(router, xf, cfg: ArchConfig):
    """Router of ``T`` tokens ``xf`` (T, d): (gate (T,K) f32, normalised
    to sum to 1 unless ``norm_topk`` is off, eid (T,K), aux)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = xf.shape[0]
    logits = torch.matmul(xf, router.to(xf.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                 # (T,E)
    gate, eid = top_k(probs, K)                                   # (T,K)
    if m.norm_topk:
        gate = gate / torch.maximum(gate.sum(-1, keepdim=True),
                                    gate.new_tensor(1e-9))

    # Load-balance auxiliary loss (Switch): E * mean_e(frac_e * prob_e)
    oh = F.one_hot(eid, E).float()                                # (T,K,E)
    frac = oh.sum(dim=(0, 1)) / (T * K)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return gate, eid, aux


def route_slots(router, xf, cfg: ArchConfig, first: int, n: int, C: int):
    """The router and the dispatch plan of ``T`` tokens ``xf`` (T, d) to
    the ``n`` experts ``[first, first + n)``, ``C`` slots each: (gate
    (T,K) f32, eid (T,K), dest (T·K,) slot in ``n·C + 1``, valid (T·K,),
    src (n·C,) each slot's assignment or -1, aux). An assignment's slot
    is its expert's (relative to ``first``) times ``C`` plus its
    position among the assignments to that expert, in token order; the
    assignments to other experts and those past ``C`` go to the drop
    slot ``n·C`` (``moe_kernels.plan``)."""
    gate, eid, aux = _gates(router, xf, cfg)
    dest, valid, src = moe_kernels.plan(eid, first, n, C)
    return gate, eid, dest, valid, src, aux


def route(p, xf, cfg: ArchConfig, C: int):
    """:func:`route_slots` over the experts the layer holds, without
    ``src``: (gate, eid, dest, valid, aux)."""
    gate, eid, dest, valid, _, aux = route_slots(p["router"], xf, cfg, 0,
                                                 cfg.moe.held(), C)
    return gate, eid, dest, valid, aux


def _moe_apply_dense(p, x, cfg: ArchConfig):
    """Reference dispatch (single device)."""
    B, S, d = x.shape
    m = cfg.moe
    n, K = m.held(), m.top_k
    T = B * S
    C = capacity(T, cfg)
    xf = x.reshape(T, d)
    with trace_span("moe.route", "model", device=True, assignments=T * K,
                    slots=n * C):
        gate, eid, dest, valid, src, aux = route_slots(p["router"], xf, cfg,
                                                       0, n, C)
        xe = _dispatch(xf, src, dest, n, K)

    y = _experts(xe, gate, dest, valid, src, p["we_g"], p["we_u"],
                 p["we_d"], K)
    if m.n_shared:
        y = y + _shared_expert(p, xf, x.dtype)
    return y.reshape(B, S, d), aux


class _Dispatch(torch.autograd.Function):
    """The expert buffers (n·C, d): slot s holds the row of token
    ``src[s] // K``, zeros where empty (the expert GEMMs' weight
    gradients read them). Backward: token t's gradient is the sum of
    its kept assignments' slot gradients, k = 0..K-1 in order."""

    @staticmethod
    def forward(ctx, xf, src, dest, K: int):
        ctx.save_for_backward(dest)
        ctx.K = K
        return moe_kernels.slot_gather(xf.contiguous(), src, K)

    @staticmethod
    def backward(ctx, dxe):
        (dest,) = ctx.saved_tensors
        with trace_span("moe.route.bwd", "model", device=True):
            dxf = moe_kernels.assign_gather(dxe.contiguous(), dest, ctx.K)
        return dxf, None, None, None


class _Combine(torch.autograd.Function):
    """The layer's output (T, d) from the expert outputs ``ye`` (n·C, d):
    y[t] = sum over the kept k of ye[dest[t·K + k]] * w[t·K + k], each
    product and add rounded to the compute dtype, from zero, k in order
    (``w`` is the gates of the kept assignments, in that dtype, 0 for the
    others). Backward: slot s's gradient is dy[t] * w[a] for the
    assignment a = t·K + k that fills it (zeros where empty), and w[a]'s
    is the f32 sum over d of dy[t] * ye[s] rounded to w's dtype."""

    @staticmethod
    def forward(ctx, ye, w, dest, src, K: int):
        ctx.save_for_backward(ye, w, dest, src)
        ctx.K = K
        return moe_kernels.assign_gather(ye, dest, K, w)

    @staticmethod
    def backward(ctx, dy):
        ye, w, dest, src = ctx.saved_tensors
        need_w = ctx.needs_input_grad[1]
        with trace_span("moe.route.bwd", "model", device=True):
            out = moe_kernels.slot_gather(dy.contiguous(), src, ctx.K, w,
                                          ye if need_w else None)
        if not need_w:
            return out, None, None, None, None
        dye, dots = out
        return dye, dots.to(w.dtype), None, None, None


def _dispatch(xf, src, dest, n: int, K: int):
    """The (n, C, d) buffers of ``n`` experts whose slots' assignments
    are ``src`` (n·C,): the ``T`` tokens ``xf`` gathered to their slots;
    ``dest`` routes the gradient back."""
    return _Dispatch.apply(xf, src, dest, K).view(n, -1, xf.shape[1])


def _experts(xe, gate, dest, valid, src, wg, wu, wd, K: int):
    """Run the experts on their buffers ``xe`` (E, C, d) and combine
    their outputs by the gates of the valid assignments: (T, d)."""
    E, C, d = xe.shape
    T, dt = gate.shape[0], xe.dtype
    g = torch.bmm(xe, wg.to(dt))
    u = torch.bmm(xe, wu.to(dt))
    h = F.silu(g.float()).to(dt) * u
    ye = torch.bmm(h, wd.to(dt))
    w = (gate * valid.reshape(T, K)).to(dt).reshape(T * K)
    return _Combine.apply(ye.reshape(E * C, d), w, dest, src, K)


def _shared_expert(p, xf, dtype):
    gs = torch.matmul(xf, p["ws_g"].to(dtype))
    us = torch.matmul(xf, p["ws_u"].to(dtype))
    hs = F.silu(gs.float()).to(dtype) * us
    return torch.matmul(hs, p["ws_d"].to(dtype))


# --------------------------------------------------------------------------
# expert-parallel path (the reference's shard_map, on torch.distributed)
# --------------------------------------------------------------------------

def _moe_apply_ep(p, x, cfg: ArchConfig, ctx, ep: int):
    """Expert-parallel MoE: expert group e on model rank e. ``x`` is this
    rank's data shard (B, S, d), replicated over ``model``; ``p`` the
    whole layer params. Each rank routes its data shard's tokens (the
    capacity is per data shard: the t5x/Switch group capacity; with one
    shard it equals the dense path's), runs the assignments to its own
    group, and the partial outputs are summed over ``model``: when
    ``S % ep == 0`` (S > 1) the rank keeps its chunk of the sequence,
    all-gathers the sequence before routing and reduce-scatters the
    output back to its chunk (then the chunks are gathered, as the
    port's activations are replicated over ``model``); otherwise one
    all-reduce. ``aux`` is averaged over the data axes (its gradient
    counted once, on model rank 0); the shared expert is added outside.

    Differentiable for a loss computed once per data shard and summed
    over shards (``distributed.collectives``): every rank gets the whole
    gradient of ``x`` and of every param of the layer."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    mesh = ctx.mesh
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    E_loc = E // ep
    B, S, d = x.shape
    mg = shd.axis_group(mesh, ("model",))
    rank = col.group_rank(mg)
    dp_axes = tuple(a for a in ("pod", "data") if a in shd.axis_names(mesh))
    seq_shard = S % ep == 0 and S > 1
    T = B * S
    C = capacity(T, cfg)                    # per-shard capacity

    router = col.copy_to(p["router"], mg)
    wg, wu, wd = (col.copy_to(p[k], mg).narrow(0, rank * E_loc, E_loc)
                  for k in ("we_g", "we_u", "we_d"))
    if seq_shard:
        xl = col.all_gather_dim(col.split_to(x, 1, mg), 1, mg)
    else:
        xl = col.copy_to(x, mg)
    xf = xl.reshape(T, d)
    gate, eid, dest, valid, src, aux = route_slots(router, xf, cfg,
                                                   rank * E_loc, E_loc, C)
    y = _experts(_dispatch(xf, src, dest, E_loc, K), gate, dest, valid, src,
                 wg, wu, wd, K)
    y = y.reshape(B, S, d)
    if seq_shard:
        y = col.gather_from(col.reduce_scatter_dim(y, 1, mg), 1, mg)
    else:
        y = col.reduce_from(y, mg)
    if rank != 0:
        aux = aux.detach()
    if dp_axes:
        dg = shd.axis_group(mesh, dp_axes)
        aux = col.all_reduce_sum(aux, dg) / col.group_size(dg)
    if m.n_shared:
        y = y + _shared_expert(p, x.reshape(T, d), x.dtype).reshape(B, S, d)
    return y, aux
