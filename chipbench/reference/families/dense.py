"""Family ``dense``: pre-norm decoder layers of attention and a SwiGLU
FFN of width ``d_ff``; the program's ``arch_type`` "dense"."""
import torch

from chipbench.reference import decoder

ARCH_TYPE = "dense"
#: configuration key -> attribute path on the program's ``ArchConfig``
PROGRAM_KEYS = {"d_ff": "d_ff"}


def param_shapes(m):
    L, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    s = decoder.base_shapes(m)
    s.update({"layers.ffn.wg": ((L, d, f), "normal"),
              "layers.ffn.wu": ((L, d, f), "normal"),
              "layers.ffn.wd": ((L, f, d), "normal")})
    return dict(sorted(s.items()))


def block(lp, h, m, prec, i):
    """``h += Attn(RMSNorm(h))``, ``h += FFN(RMSNorm(h))``; no aux."""
    x = decoder.rms_norm(h, lp["attn_norm"], m["norm_eps"])
    h = h + decoder.attention(lp["attn"], x, m, prec)
    x = decoder.rms_norm(h, lp["ffn_norm"], m["norm_eps"])
    ff = lp["ffn"]
    f = decoder.swiglu(x, ff["wg"], ff["wu"], ff["wd"], prec)
    return h + f, torch.zeros((), device=h.device)


def with_aux(xent, aux, m):
    return xent


def active_params(m):
    """N of 6 N T: every parameter but the input embedding."""
    return decoder.non_embed_params(m)


def attention_flops(m, seq, tokens):
    """12 L d S T: scores and their product with V, forward and backward."""
    return 12.0 * m["n_layers"] * m["d_model"] * seq * tokens
