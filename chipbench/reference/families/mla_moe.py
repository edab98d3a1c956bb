"""Family ``mla_moe``: DeepSeek-V2's decoder layers (arXiv:2405.04434),
the program's ``arch_type`` "moe" with multi-head latent attention.

Every layer is ``h += MLA(RMSNorm(h))``, then ``h += FFN(RMSNorm(h))``.
The first ``first_dense_layers`` layers' FFN is a SwiGLU of width
``dense_ff`` (their weights the ``dense_layers`` stack); the rest hold
routed and shared experts (the ``layers`` stack).

MLA without a query compression, per layer, H heads, latent width r,
per head dn dims without position, dr rotated, dv of value:

* ``q = x W_q``, split per head into ``q_nope`` (dn) and ``q_pe`` (dr);
* ``[c_kv, k_pe] = x W_kva`` (widths r and dr), ``c_kv = RMSNorm(c_kv)``;
* ``[k_nope, v] = c_kv W_kvb``, per head dn and dv;
* ``q_pe`` and the single ``k_pe`` head, which every head shares, turn
  by YaRN's rotation (below; the halves rotate, as the decoder's other
  rotations do);
* causal softmax of ``[q_nope, q_pe] . [k_nope, k_pe]`` at scale
  ``(dn + dr)^-1/2 m^2``, ``m = 0.1 mscale_all_dim ln(factor) + 1``;
  ``out = (softmax V) W_o``.

YaRN (Peng et al. 2023, DeepSeek-V2's settings): pair ``i`` of the dr
rotated dims turns at ``theta^(-2i/dr)`` where ``i`` lies below ``lo``,
at that over ``factor`` above ``hi``, and a linear ramp between, with
``lo``/``hi`` the pair that turns ``beta_fast``/``beta_slow`` times over
the original context (floored, ceiled, within ``[0, dr - 1]``); cos and
sin are multiplied by ``m(mscale) / m(mscale_all_dim)``.

Routed experts: a softmax router over all ``n_experts`` picks the top-k
(ties to the lowest expert), the gates renormalised only with
``norm_topk``; each expert takes its assignments in token order up to
the capacity of ``decoder.capacity`` (counted over all ``n_experts``).
This card holds ``held_experts`` of them, ``[0, held)``, and only their
part of the result is computed: what the absent experts would add is
left out. The shared experts are one SwiGLU of width
``n_shared * expert_ff`` for every token. The layer's aux is the Switch
load-balance term over all experts, added with ``router_aux_weight``.

Precision as the decoder's: float32 norms and softmax, matmul inputs in
the compute dtype with float32 accumulation; TF32 is off for the float32
products.
"""
import math

import torch
import torch.nn.functional as F

from chipbench.reference import decoder

ARCH_TYPE = "moe"
#: configuration key -> attribute path on the program's ``ArchConfig``
PROGRAM_KEYS = {
    "n_experts": "moe.n_experts", "top_k": "moe.top_k",
    "n_shared": "moe.n_shared", "expert_ff": "moe.expert_ff",
    "capacity_factor": "moe.capacity_factor",
    "router_aux_weight": "moe.router_aux_weight",
    "norm_topk": "moe.norm_topk", "held_experts": "moe.held_experts",
    "first_dense_layers": "first_dense_layers", "dense_ff": "d_ff",
    "kv_lora_rank": "mla.kv_lora_rank",
    "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim",
    "v_head_dim": "mla.v_head_dim",
    "yarn_factor": "rope_scaling.factor",
    "yarn_original_max_position": "rope_scaling.original_max_position",
    "yarn_beta_fast": "rope_scaling.beta_fast",
    "yarn_beta_slow": "rope_scaling.beta_slow",
    "yarn_mscale": "rope_scaling.mscale",
    "yarn_mscale_all_dim": "rope_scaling.mscale_all_dim",
}


def held(m) -> int:
    return m["held_experts"] or m["n_experts"]


def param_shapes(m):
    d, V, H = m["d_model"], m["vocab"], m["n_heads"]
    r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                     m["qk_rope_head_dim"], m["v_head_dim"])
    n, fe, fs = held(m), m["expert_ff"], m["n_shared"] * m["expert_ff"]
    Ld = m["first_dense_layers"]
    s = {"embed": ((V, d), "embed"), "final_norm": ((d,), "ones"),
         "lm_head": ((d, V), "normal")}

    def stack(key, L, experts):
        s.update({
            f"{key}.attn_norm": ((L, d), "ones"),
            f"{key}.ffn_norm": ((L, d), "ones"),
            f"{key}.attn.wq": ((L, d, H * (dn + dr)), "normal"),
            f"{key}.attn.wkv_a": ((L, d, r + dr), "normal"),
            f"{key}.attn.kv_norm": ((L, r), "ones"),
            f"{key}.attn.wkv_b": ((L, r, H * (dn + dv)), "normal"),
            f"{key}.attn.wo": ((L, H * dv, d), "normal"),
        })
        if not experts:
            f = m["dense_ff"]
            s.update({f"{key}.ffn.wg": ((L, d, f), "normal"),
                      f"{key}.ffn.wu": ((L, d, f), "normal"),
                      f"{key}.ffn.wd": ((L, f, d), "normal")})
            return
        s.update({f"{key}.moe.router": ((L, d, m["n_experts"]), "normal"),
                  f"{key}.moe.we_g": ((L, n, d, fe), "normal"),
                  f"{key}.moe.we_u": ((L, n, d, fe), "normal"),
                  f"{key}.moe.we_d": ((L, n, fe, d), "normal")})
        if fs:
            s.update({f"{key}.moe.ws_g": ((L, d, fs), "normal"),
                      f"{key}.moe.ws_u": ((L, d, fs), "normal"),
                      f"{key}.moe.ws_d": ((L, fs, d), "normal")})

    if Ld:
        stack("dense_layers", Ld, False)
    stack("layers", m["n_layers"] - Ld, True)
    return dict(sorted(s.items()))


def layer_params(params, i):
    """Layer ``i``: a leading dense layer's slice of ``dense_layers``,
    else its slice of ``layers``. (``m`` is not passed: the dense stack's
    depth is its leaves' leading dim.)"""
    dense = params.get("dense_layers")
    Ld = dense["attn_norm"].shape[0] if dense else 0
    if i < Ld:
        return decoder.layer(dense, i)
    return decoder.layer(params["layers"], i - Ld)


def yarn_mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim, m, device=None):
    """(dim/2,) float32 inverse frequencies of YaRN (module docstring)."""
    theta, orig = m["rope_theta"], m["yarn_original_max_position"]

    def turns_at(rotations):          # the pair that turns so many times
        return dim * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    lo = max(math.floor(turns_at(m["yarn_beta_fast"])), 0)
    hi = min(math.ceil(turns_at(m["yarn_beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    base = 1.0 / (theta ** exps)
    scaled = 1.0 / (m["yarn_factor"] * theta ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - lo) / (hi - lo)).clamp(0, 1)
    return scaled * ramp + base * (1 - ramp)


def yarn_rope(x, m):
    """x: (B, S, H, D), position s rotated by YaRN's frequencies."""
    S, D = x.shape[1], x.shape[-1]
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * yarn_inv_freq(D, m, x.device)
    a = yarn_mscale(m["yarn_factor"], m["yarn_mscale"]) \
        / yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"])
    cos, sin = ang.cos()[:, None, :] * a, ang.sin()[:, None, :] * a
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def softmax_scale(m):
    mm = yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"])
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * mm * mm


def mla(p, x, m, prec):
    """(B, S, d) -> (B, S, d): causal multi-head latent attention."""
    B, S, _ = x.shape
    H = m["n_heads"]
    r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                     m["qk_rope_head_dim"], m["v_head_dim"])
    q_nope, q_pe = prec.mm(x, p["wq"]).reshape(B, S, H, dn + dr).split(
        [dn, dr], dim=-1)
    c_kv, k_pe = prec.mm(x, p["wkv_a"]).split([r, dr], dim=-1)
    c_kv = decoder.rms_norm(c_kv, p["kv_norm"], m["norm_eps"])
    k_nope, v = prec.mm(c_kv, p["wkv_b"]).reshape(B, S, H, dn + dv).split(
        [dn, dv], dim=-1)
    q = torch.cat([q_nope, yarn_rope(q_pe, m)], dim=-1)
    k = torch.cat([k_nope, yarn_rope(k_pe[:, :, None], m).expand(
        B, S, H, dr)], dim=-1)
    q = q * torch.tensor(softmax_scale(m), dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", prec.cast(q).float(),
                     prec.cast(k).float())
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prec.cast(w).float(),
                     prec.cast(v).float()).to(x.dtype)
    return prec.mm(o.reshape(B, S, H * dv), p["wo"])


def held_experts(p, x, m, prec, first=0):
    """(y (B, S, d), aux): the part of the routed experts' output that
    the experts ``[first, first + n)`` give, ``p``'s ``we_*`` holding
    those n, plus the shared experts where ``p`` has them."""
    B, S, d = x.shape
    E, K = m["n_experts"], m["top_k"]
    T = B * S
    xf = x.reshape(T, d)
    probs = torch.softmax(prec.mm(xf, p["router"]).float(), dim=-1)
    top, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = top[:, :K], eid[:, :K]
    if m["norm_topk"]:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = torch.bincount(eid.reshape(-1), minlength=E).float() / (T * K)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    # slot of each assignment (t, k), in token order, within its expert
    flat = eid.reshape(-1)
    onehot = F.one_hot(flat, E)
    slot = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    kept = slot < decoder.capacity(T, m)
    gflat = gate.reshape(-1)
    y = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for j in range(p["we_g"].shape[0]):
        a = torch.nonzero((flat == first + j) & kept).squeeze(1)
        if a.numel() == 0:
            continue
        tok = a // K
        out = decoder.swiglu(xf[tok], p["we_g"][j], p["we_u"][j],
                             p["we_d"][j], prec)
        y = y.index_add(0, tok, out.float() * gflat[a, None])
    if "ws_g" in p:
        y = y + decoder.swiglu(xf, p["ws_g"], p["ws_u"], p["ws_d"],
                               prec).float()
    return y.to(x.dtype).reshape(B, S, d), aux


def block(lp, h, m, prec, i):
    """Layer ``i``; the aux is the router's load-balance term (0 in a
    dense layer)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = decoder.rms_norm(h, lp["attn_norm"], m["norm_eps"])
    h = h + mla(lp["attn"], x, m, prec)
    x = decoder.rms_norm(h, lp["ffn_norm"], m["norm_eps"])
    if "moe" in lp:
        f, aux = held_experts(lp["moe"], x, m, prec)
        return h + f, aux
    ff = lp["ffn"]
    f = decoder.swiglu(x, ff["wg"], ff["wu"], ff["wd"], prec)
    return h + f, torch.zeros((), device=h.device)


def with_aux(xent, aux, m):
    return xent + m["router_aux_weight"] * aux


def active_params(m):
    """N of 6 N T: every parameter but the input embedding, less the
    held experts a token does not pick: it picks ``top_k * held / E`` of
    the held ones on average."""
    n, E = held(m), m["n_experts"]
    idle = n - m["top_k"] * n / E
    moe_layers = m["n_layers"] - m["first_dense_layers"]
    return decoder.non_embed_params(m) \
        - moe_layers * idle * 3 * m["d_model"] * m["expert_ff"]


def attention_flops(m, seq, tokens):
    """6 L H (d_qk + d_v) S T: scores (d_qk = dn + dr) and their product
    with V (d_v), forward and backward."""
    dqk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return 6.0 * m["n_layers"] * m["n_heads"] * (dqk + m["v_head_dim"]) \
        * seq * tokens
