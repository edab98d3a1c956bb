"""Plain PyTorch decoder, written from the architectures' equations.

The yardstick the benchmark holds the program's training step against.
It imports nothing of the program and takes a configuration file's
``model`` keys (see ``chipbench/configs``). This file holds what every
family shares:

* token embedding scaled by sqrt(d), a stack of layers, a final RMSNorm
  and an untied output head;
* attention: causal multi-head attention with rotary positions (the
  half-split rotation), scores and softmax in float32, optionally over
  a window of the last ``window`` keys;
* SwiGLU ``W_d (silu(x W_g) * (x W_u))``;
* routed experts: a softmax router picks the top-k of E experts per
  token (ties to the lowest expert), the gates optionally renormalized
  to sum to 1; each expert takes its assignments in token order up to a
  capacity C = ceil(T k cf / E) rounded up to a multiple of 8, the rest
  dropped; shared experts are one SwiGLU of width n_shared * expert_ff
  added for every token; the layer also returns the Switch load-balance
  term E * sum_e(frac_e * mean_prob_e);
* loss: mean next-token cross-entropy over float32 logits, plus what the
  family adds from its layers' aux terms.

A configuration's ``family`` names a file ``families/<family>.py`` beside
this one (:func:`family`), which imports only ``torch`` and this file and
gives the family's weight layout (``param_shapes``), its layer
(``block(lp, h, m, prec, i) -> (h, aux)``, layer ``i``'s slice of the
stacked ``layers`` leaves, or of what its ``layer_params(params, i)``
picks), how the aux terms enter the loss (``with_aux``), its counts
(``active_params``, ``attention_flops``) and the program's keys it must
match (``ARCH_TYPE``, ``PROGRAM_KEYS``).

Precision follows the configuration: parameters in ``param_dtype``,
every matmul on inputs rounded to ``compute_dtype`` with float32
accumulation, norms and softmax in float32, the residual stream in the
compute dtype. :class:`Precision` with ``fp8=True`` rounds every matmul
input to float8 e4m3 (per-tensor absmax scaling) instead: the control
that a comparison has to reject. Each layer is recomputed in backward
(``torch.utils.checkpoint``) so that full-width layers fit beside the
reference's state.
"""
from __future__ import annotations

import importlib.util
import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FP8_MAX = 448.0
#: the families of this checkout: ``<family>.py``
FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "families")
_loaded: dict = {}


def family(m: dict):
    """The module of configuration ``m``'s family, loaded by file path:
    ``m["family_file"]`` where the harness set it (the checkout the cell
    came from), else ``families/<family>.py`` beside this file."""
    path = m.get("family_file") or os.path.join(FAMILIES,
                                                f"{m['family']}.py")
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _loaded:
        spec = importlib.util.spec_from_file_location(
            "chipbench_family_" + m["family"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


def param_shapes(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{dotted leaf name: (shape, init)} in sorted name order; init is
    'normal' (std 1/sqrt(fan-in)), 'embed' (std 0.02) or 'ones'."""
    return family(m).param_shapes(m)


def base_shapes(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The leaves every family here has: the embedding, the final norm,
    the output head, and each layer's two norms and attention."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    hd = m["head_dim"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    return {
        "embed": ((V, d), "embed"),
        "final_norm": ((d,), "ones"),
        "lm_head": ((d, V), "normal"),
        "layers.attn_norm": ((L, d), "ones"),
        "layers.ffn_norm": ((L, d), "ones"),
        "layers.attn.wq": ((L, d, H * hd), "normal"),
        "layers.attn.wk": ((L, d, KV * hd), "normal"),
        "layers.attn.wv": ((L, d, KV * hd), "normal"),
        "layers.attn.wo": ((L, H * hd, d), "normal"),
    }


def non_embed_params(m: dict) -> int:
    """Every parameter of the family's layout but the input embedding."""
    return sum(math.prod(s) for name, (s, _) in param_shapes(m).items()
               if name != "embed")


class Precision:
    """How matmul inputs are rounded: to ``dtype`` (the configuration's
    compute dtype), or with ``fp8`` to float8 e4m3 against the tensor's
    absmax and back."""

    def __init__(self, dtype: torch.dtype, fp8: bool = False):
        self.dtype, self.fp8 = dtype, fp8

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.fp8:
            return x
        scale = (x.detach().abs().amax().float() / FP8_MAX).clamp_min(1e-30)
        q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
        # straight-through: the value is rounded, the gradient is not
        return x + (q.to(x.dtype) - x).detach()

    def mm(self, a, b):
        return torch.matmul(self.cast(a), self.cast(b))

    def mm_f32(self, a, b):
        """Float32 products of inputs rounded as every other matmul's."""
        return torch.matmul(self.cast(a).float(), self.cast(b).float())


def rms_norm(x, gamma, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


def rope(x, theta: float):
    """x: (B, S, H, D); the halves (x1, x2) rotate by position * freq."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                         dtype=torch.float32) / D)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(p, x, m, prec: Precision, window=None):
    """Query i sees key j iff j <= i and, with a ``window`` w, i - w < j."""
    B, S, d = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(prec.mm(x, p["wq"]).reshape(B, S, H, hd), m["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).reshape(B, S, KV, hd), m["rope_theta"])
    v = prec.mm(x, p["wv"]).reshape(B, S, KV, hd)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q = q * torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", prec.cast(q).float(),
                     prec.cast(k).float())
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    if window:
        causal = causal & ~torch.ones_like(causal).tril(-window)
    s = s.masked_fill(~causal, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prec.cast(w).float(),
                     prec.cast(v).float()).to(x.dtype)
    return prec.mm(o.reshape(B, S, H * hd), p["wo"])


def swiglu(x, wg, wu, wd, prec: Precision):
    g = prec.mm(x, wg)
    u = prec.mm(x, wu)
    return prec.mm((F.silu(g.float()) * u.float()).to(x.dtype), wd)


def capacity(T: int, m: dict) -> int:
    c = math.ceil(T * m["top_k"] * m["capacity_factor"] / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def routed_experts(p, x, m, prec: Precision):
    """(y (B, S, d), aux) of one layer of routed (and shared) experts."""
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
    kept = slot < capacity(T, m)
    gflat = gate.reshape(-1)
    y = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for e in range(E):
        a = torch.nonzero((flat == e) & kept).squeeze(1)
        if a.numel() == 0:
            continue
        tok = a // K
        out = swiglu(xf[tok], p["we_g"][e], p["we_u"][e], p["we_d"][e], prec)
        y = y.index_add(0, tok, out.float() * gflat[a, None])
    if "ws_g" in p:
        y = y + swiglu(xf, p["ws_g"], p["ws_u"], p["ws_d"], prec).float()
    return y.to(x.dtype).reshape(B, S, d), aux


def layer(layers: dict, i: int) -> dict:
    """Layer ``i``'s slice of every stacked leaf of ``layers``."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def loss(params: dict, tokens, targets, m: dict, prec: Precision):
    """Mean cross-entropy of one micro-batch, with the layers' summed aux
    terms as the family adds them; params is the nested tree."""
    fam = family(m)
    pick = getattr(fam, "layer_params",
                   lambda params, i: layer(params["layers"], i))
    d = m["d_model"]
    h = params["embed"][tokens.long()].to(prec.dtype) \
        * torch.tensor(math.sqrt(d), dtype=prec.dtype)
    aux = torch.zeros((), device=h.device)
    for i in range(m["n_layers"]):
        h, a = checkpoint(fam.block, pick(params, i), h, m, prec, i,
                          use_reentrant=False)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], m["norm_eps"])
    xent = torch.zeros((), device=h.device)
    n = tokens.numel()
    for b in range(h.shape[0]):      # one sequence's logits at a time
        xent = xent + checkpoint(_xent_sum, h[b], params["lm_head"],
                                 targets[b], prec, use_reentrant=False)
    return fam.with_aux(xent / n, aux, m)


def _xent_sum(h, w, t, prec):
    logits = prec.mm_f32(h, w)
    return F.cross_entropy(logits, t.long(), reduction="sum")


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def gradients(flat: Dict[str, torch.Tensor], batch: dict, m: dict,
              prec: Precision):
    """(loss, {name: float32 gradient}) of one step: the batch's rows
    split into ``grad_accum`` micro-batches in order, each micro-batch's
    gradients added in float32 and divided by their count, the loss the
    mean of theirs (fewer micro-batches when the batch has fewer rows)."""
    tok, tgt = batch["tokens"], batch["targets"]
    accum = min(m["grad_accum"], tok.shape[0])
    per = tok.shape[0] // accum
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = nest(leaves)
    total = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in flat.items()}
    lsum = torch.zeros((), device=tok.device)
    for i in range(accum):
        sl = slice(i * per, (i + 1) * per)
        ls = loss(tree, tok[sl], tgt[sl], m, prec)
        gs = torch.autograd.grad(ls, list(leaves.values()))
        for k, g in zip(leaves, gs):
            total[k].add_(g.float())
        lsum = lsum + ls.detach()
        del gs, ls
    return lsum / accum, {k: v.div_(accum) for k, v in total.items()}
