"""Family ``window`` (a test family, added to a copy of the benchmark as
a file only): the dense decoder, its layers outside
``m["global_layers"]`` attending over a window of the last ``m["window"]``
keys (query i sees key j iff i - w < j <= i), as the program's
``sliding_window`` and ``global_attn_layers`` give them."""
import torch

from chipbench.reference import decoder

ARCH_TYPE = "dense"
#: configuration key -> attribute path on the program's ``ArchConfig``
PROGRAM_KEYS = {"d_ff": "d_ff", "window": "sliding_window",
                "global_layers": "global_attn_layers"}


def param_shapes(m):
    L, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    s = decoder.base_shapes(m)
    s.update({"layers.ffn.wg": ((L, d, f), "normal"),
              "layers.ffn.wu": ((L, d, f), "normal"),
              "layers.ffn.wd": ((L, f, d), "normal")})
    return dict(sorted(s.items()))


def layer_window(m, i):
    """Layer ``i``'s window; None attends to every earlier key."""
    return None if i in m["global_layers"] else m["window"]


def block(lp, h, m, prec, i):
    x = decoder.rms_norm(h, lp["attn_norm"], m["norm_eps"])
    h = h + decoder.attention(lp["attn"], x, m, prec,
                              window=layer_window(m, i))
    x = decoder.rms_norm(h, lp["ffn_norm"], m["norm_eps"])
    ff = lp["ffn"]
    f = decoder.swiglu(x, ff["wg"], ff["wu"], ff["wd"], prec)
    return h + f, torch.zeros((), device=h.device)


def with_aux(xent, aux, m):
    return xent


def active_params(m):
    return decoder.non_embed_params(m)


def attention_flops(m, seq, tokens):
    """12 d T times each layer's keys a query is charged for: S for a
    global layer, min(S, w) for a windowed one."""
    keys = sum(seq if layer_window(m, i) is None
               else min(seq, layer_window(m, i))
               for i in range(m["n_layers"]))
    return 12.0 * m["d_model"] * keys * tokens
