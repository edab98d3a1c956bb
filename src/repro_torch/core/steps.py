"""Training-step builders with LowDiff integrated (port of
``repro.core.steps``).

Modes:
  dense    — plain Adam step: the no-checkpoint baseline, through the
             fused Adam kernel (K3).
  lowdiff  — paper Algorithm 1 training process: compress the gradient,
             then update the model from the compressed gradient itself,
             through the fused decode-and-apply kernel of its wire form.
             That is the kernel, and the payload, that recovery replays,
             so the compressed gradient G̃_t is an exact differential
             checkpoint. G̃_t is returned for the Reusing Queue. By
             ``compressor``:
             topk   — top-k select (K1) on ``grad + residual``, residual
                      ``corrected - decompress(cg)`` with the scatter
                      kernel (K2), update through ``topk_apply`` (K4);
             packed — the same with int8 picks: ``pack_select`` (K8),
                      ``pack_scatter`` (K9), ``packed_apply`` (K10);
             quant8 — blockwise int8 ``quantize`` (K11) of the gradient,
                      no error feedback, update through ``quant_apply``
                      (K13); the new state has no ``"ef"``.
  lowdiff_plus — the dense step (K3) that also returns the dense
             gradient tree, which LowDiff+ offloads layer by layer to
             its host replica.

The state is a dict of device tensors — {"params", "opt": AdamState,
"step", ["ef"]} — replaced, not updated in place, every step: a
snapshot of step t reads tensors no later step writes.

Gradient accumulation (``cfg.grad_accum``) runs the micro-batches inside
the step, as the reference's scan does: the accumulated gradient is what
every mode compresses, applies and checkpoints.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.compression.error_feedback import (ef_compress_tree_with,
                                                   ef_init)
from repro_torch.compression.sparse import is_compressed
from repro_torch.configs.base import DTYPES
from repro_torch.kernels import ops
from repro_torch.optim.adam import AdamState, adam_init


#: lowdiff gradient compressors (``--compressor``)
COMPRESSORS = ("topk", "quant8", "packed")


def init_state(model, seed: int = 0, *, mode: str = "lowdiff",
               error_feedback: bool = True, device=None,
               params=None) -> Dict[str, Any]:
    """Fresh training state on ``device`` (CUDA unless asked otherwise);
    ``params`` (e.g. from ``from_jax_params``) replaces the seeded init."""
    dev = resolve_device(device)
    if params is None:
        params = model.init(seed, device=dev)
    state = {"params": params, "opt": adam_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if mode == "lowdiff" and error_feedback:
        state["ef"] = ef_init(params)
    return state


def _differentiable(params):
    """(live tree, autograd leaves, regroup). Each stacked per-layer leaf
    is handed to the model as a list of its (L) layer slices, each its
    own autograd leaf, and ``regroup`` stacks their gradients back: the
    gradient of a whole stacked leaf through per-layer indexing would
    materialize and add one full-size, zero-padded copy per layer."""
    leaves, groups = [], []

    def live(p, stacked):
        base = p.detach()
        if stacked:
            views = [base[i].requires_grad_(True)
                     for i in range(base.shape[0])]
            groups.append(len(views))
            leaves.extend(views)
            return views
        groups.append(0)
        leaves.append(base.requires_grad_(True))
        return leaves[-1]

    tree = {k: tree_map(lambda p, s=(k == "layers"): live(p, s), v)
            for k, v in sorted(params.items())}

    def regroup(grads):
        out, i = [], 0
        for n in groups:
            if n:
                out.append(torch.stack(grads[i:i + n]))
                i += n
            else:
                out.append(grads[i])
                i += 1
        return out

    return tree, leaves, regroup


def _micro(batch, accum: int, i: int):
    """Micro-batch ``i`` of ``accum``: contiguous rows along axis 0, as
    the reference's ``x.reshape((accum, -1) + x.shape[1:])[i]``."""
    return {k: (x.reshape((accum, -1) + tuple(x.shape[1:]))[i]
                if x.dim() >= 1 else x) for k, x in batch.items()}


def _grads(model, params, batch, accum: int):
    """(loss, metrics, grads) in the params' tree. One batch: grads in
    the params' dtypes. ``accum`` > 1 (``cfg.grad_accum``): the batch is
    split into ``accum`` contiguous micro-batches, whose gradients are
    added in order into a ``cfg.grad_accum_dtype`` buffer and divided by
    ``accum`` in that dtype; the loss is their f32 mean, and the metrics
    are the reference's ``{"xent", "aux": 0, "tokens": 0}``."""
    live, leaves, regroup = _differentiable(params)

    def one(b):
        loss, metrics = model.loss_fn(live, b)
        return loss, metrics, regroup(torch.autograd.grad(loss, leaves))

    def as_tree(gl):
        git = iter(gl)
        return tree_map(lambda _: next(git), params)

    if accum <= 1:
        loss, metrics, gl = one(batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, as_tree(gl)
    acc_dt = DTYPES[model.cfg.grad_accum_dtype]
    dev = tree_leaves(params)[0].device
    acc = [torch.zeros(p.shape, dtype=acc_dt, device=dev)
           for p in tree_leaves(params)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(accum):
        loss, _, gl = one(_micro(batch, accum, i))
        for a, g in zip(acc, gl):
            a.add_(g.to(acc_dt))
        loss_sum = loss_sum + loss.detach()
        del gl
    loss = loss_sum / accum
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return loss, {"xent": loss, "aux": zero, "tokens": zero}, \
        as_tree([a.div_(accum) for a in acc])


def _apply_tree(params, payloads, opt: AdamState, hyper, count):
    """Per-leaf ``fused_decode_apply`` in sorted leaf order; returns
    (params', AdamState')."""
    out = tree_map(lambda g, p, m, v: ops.fused_decode_apply(g, p, m, v,
                                                             hyper),
                   payloads, params, opt.mu, opt.nu, is_leaf=is_compressed)
    triple = lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")  # noqa: E731
    pick = lambda i: tree_map(lambda t: t[i], out, is_leaf=triple)  # noqa: E731
    return pick(0), AdamState(pick(1), pick(2), count)


def make_train_step(model, *, mode: str = "lowdiff", rho: float = 0.01,
                    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, error_feedback: bool = True,
                    compressor: str = "topk"):
    """``step(state, batch) -> (state', metrics, extra)``; extra is the
    compressed gradient tree in lowdiff mode, the dense gradient tree in
    lowdiff_plus mode, else None. ``compressor``: 'topk', 'quant8' or
    'packed'; error feedback applies to topk and packed."""
    if mode not in ("lowdiff", "dense", "lowdiff_plus"):
        raise ValueError(f"unknown step mode {mode!r}")
    if compressor not in COMPRESSORS:
        raise ValueError(f"compressor {compressor!r} is not one of "
                         f"{COMPRESSORS}")
    compress, decompress = {
        "topk": (lambda g: ops.topk_compress(g, rho), ops.topk_decompress),
        "packed": (lambda g: ops.packed_compress(g, rho),
                   ops.packed_decompress),
        "quant8": (ops.quant_compress, None)}[compressor]
    cfg = model.cfg

    def step(state, batch):
        params = state["params"]
        loss, metrics, grads = _grads(model, params, batch, cfg.grad_accum)
        opt = state["opt"]
        count = opt.count + 1
        hyper = ops.adam_hyper_traced(lr, b1, b2, eps, count)
        extra, ef = None, None
        if mode == "lowdiff":
            if decompress is not None and error_feedback and "ef" in state:
                cg, ef = ef_compress_tree_with(grads, state["ef"], compress,
                                               decompress)
            else:
                cg = tree_map(compress, grads)
            extra, payloads = cg, cg
        else:
            payloads = grads
            if mode == "lowdiff_plus":
                extra = grads
        del grads
        params2, opt2 = _apply_tree(params, payloads, opt, hyper, count)
        new_state = {"params": params2, "opt": opt2,
                     "step": state["step"] + 1}
        if ef is not None:
            new_state["ef"] = ef
        return new_state, dict(metrics, loss=loss), extra

    return step
