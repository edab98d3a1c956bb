"""Family ``moe``: pre-norm decoder layers of attention and routed
experts (softmax top-k router with capacity, shared experts), the
router's load-balance term added to the loss with ``router_aux_weight``;
the program's ``arch_type`` "moe"."""
from chipbench.reference import decoder

ARCH_TYPE = "moe"
#: configuration key -> attribute path on the program's ``ArchConfig``
PROGRAM_KEYS = {
    "n_experts": "moe.n_experts", "top_k": "moe.top_k",
    "n_shared": "moe.n_shared", "expert_ff": "moe.expert_ff",
    "capacity_factor": "moe.capacity_factor",
    "router_aux_weight": "moe.router_aux_weight",
}


def param_shapes(m):
    L, d = m["n_layers"], m["d_model"]
    E, fe = m["n_experts"], m["expert_ff"]
    fs = m["n_shared"] * fe
    s = decoder.base_shapes(m)
    s.update({
        "layers.moe.router": ((L, d, E), "normal"),
        "layers.moe.we_g": ((L, E, d, fe), "normal"),
        "layers.moe.we_u": ((L, E, d, fe), "normal"),
        "layers.moe.we_d": ((L, E, fe, d), "normal"),
    })
    if fs:
        s.update({"layers.moe.ws_g": ((L, d, fs), "normal"),
                  "layers.moe.ws_u": ((L, d, fs), "normal"),
                  "layers.moe.ws_d": ((L, fs, d), "normal")})
    return dict(sorted(s.items()))


def block(lp, h, m, prec, i):
    """``h += Attn(RMSNorm(h))``, ``h += Experts(RMSNorm(h))``; the aux
    is the router's load-balance term."""
    x = decoder.rms_norm(h, lp["attn_norm"], m["norm_eps"])
    h = h + decoder.attention(lp["attn"], x, m, prec)
    x = decoder.rms_norm(h, lp["ffn_norm"], m["norm_eps"])
    f, aux = decoder.routed_experts(lp["moe"], x, m, prec)
    return h + f, aux


def with_aux(xent, aux, m):
    return xent + m["router_aux_weight"] * aux


def active_params(m):
    """N of 6 N T: every parameter but the input embedding, less the
    routed experts a token does not pick."""
    idle = m["n_experts"] - m["top_k"]
    return decoder.non_embed_params(m) \
        - m["n_layers"] * idle * 3 * m["d_model"] * m["expert_ff"]


def attention_flops(m, seq, tokens):
    """12 L d S T: scores and their product with V, forward and backward."""
    return 12.0 * m["n_layers"] * m["d_model"] * seq * tokens
