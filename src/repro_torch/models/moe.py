"""Capacity-based top-k Mixture-of-Experts layer (port of
``repro.models.moe``, single-device path).

Dispatch is the cumsum/position-in-expert formulation (Switch/T5X
style) with gather/scatter instead of a (tokens, experts, capacity)
one-hot einsum: an assignment's slot in its expert is the exclusive
cumsum of the flattened ``(T·K, E)`` one-hot, assignments past the
capacity go to a drop slot ``E·C`` that is thrown away, and the experts
run as one batched matmul over ``(E, C, d)``. DeepSeekMoE-style shared
experts are dense SwiGLU paths added on top. The reference's
expert-parallel ``shard_map`` path needs a mesh and is not ported:
``moe_apply`` always takes the dense path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.param import ParamSpec


def moe_specs(cfg: ArchConfig, layers: int) -> dict:
    d = cfg.d_model
    m = cfg.moe
    L = (layers,)
    specs = {
        "router": ParamSpec(L + (d, m.n_experts), ("layers", "fsdp", "experts")),
        "we_g": ParamSpec(L + (m.n_experts, d, m.expert_ff),
                          ("layers", "experts", "fsdp", "expert_mlp")),
        "we_u": ParamSpec(L + (m.n_experts, d, m.expert_ff),
                          ("layers", "experts", "fsdp", "expert_mlp")),
        "we_d": ParamSpec(L + (m.n_experts, m.expert_ff, d),
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
    """x: (B, S, d) -> (out, aux_loss). One device: the dense dispatch."""
    return _moe_apply_dense(p, x, cfg)


def route(p, xf, cfg: ArchConfig, C: int):
    """The router and the dispatch plan of ``T`` tokens ``xf`` (T, d):
    (gate (T,K) f32, eid (T,K), dest (T·K,) slot in ``E·C + 1``, valid
    (T·K,), aux)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = xf.shape[0]
    logits = torch.matmul(xf, p["router"].to(xf.dtype))
    probs = torch.softmax(logits.float(), dim=-1)                 # (T,E)
    gate, eid = top_k(probs, K)                                   # (T,K)
    gate = gate / torch.maximum(gate.sum(-1, keepdim=True),
                                gate.new_tensor(1e-9))

    # Load-balance auxiliary loss (Switch): E * mean_e(frac_e * prob_e)
    oh = F.one_hot(eid, E).float()                                # (T,K,E)
    frac = oh.sum(dim=(0, 1)) / (T * K)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    # position-in-expert: exclusive cumsum over flattened (T*K) assignments
    oh_flat = oh.reshape(T * K, E)
    pos = torch.cumsum(oh_flat, dim=0) - oh_flat
    pos_in_e = (pos * oh_flat).sum(dim=-1).to(torch.int64)
    eid_flat = eid.reshape(T * K)
    valid = pos_in_e < C
    dest = torch.where(valid, eid_flat * C + pos_in_e,
                       torch.full_like(eid_flat, E * C))          # drop slot
    return gate, eid, dest, valid, aux


def _moe_apply_dense(p, x, cfg: ArchConfig):
    """Reference dispatch (single device)."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = B * S
    C = capacity(T, cfg)
    xf = x.reshape(T, d)
    gate, _, dest, valid, aux = route(p, xf, cfg, C)

    # scatter per k-slot: within one slot the destinations are distinct
    # except the drop slot, whose row is thrown away
    dest_k = dest.reshape(T, K)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for kk in range(K):
        buf = buf.index_add(0, dest_k[:, kk], xf)
    xe = buf[:E * C].reshape(E, C, d)

    g = torch.bmm(xe, p["we_g"].to(x.dtype))
    u = torch.bmm(xe, p["we_u"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.bmm(h, p["we_d"].to(x.dtype))

    y_flat = torch.cat([ye.reshape(E * C, d),
                        torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    valid_k = valid.reshape(T, K)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for kk in range(K):
        w = (gate[:, kk] * valid_k[:, kk]).to(x.dtype)[:, None]
        y = y + y_flat[dest_k[:, kk]] * w

    if m.n_shared:
        y = y + _shared_expert(p, xf, x.dtype)
    return y.reshape(B, S, d), aux


def _shared_expert(p, xf, dtype):
    gs = torch.matmul(xf, p["ws_g"].to(dtype))
    us = torch.matmul(xf, p["ws_u"].to(dtype))
    hs = F.silu(gs.float()).to(dtype) * us
    return torch.matmul(hs, p["ws_d"].to(dtype))
