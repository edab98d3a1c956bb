"""Training-step builders with LowDiff integrated (port of
``repro.core.steps``).

Modes:
  dense    — plain Adam step: the no-checkpoint baseline, through the
             fused Adam kernel (K3).
  lowdiff  — paper Algorithm 1 training process: compress the gradient
             with error feedback — top-k select (K1) on ``grad +
             residual``, residual ``corrected - decompress(cg)`` with the
             scatter kernel (K2) — then update the model from the
             compressed gradient itself: ``topk_apply`` (K4) scatters the
             wire payload into the Adam update. That is the kernel, and
             the payload, that recovery replays, so the compressed
             gradient G̃_t is an exact differential checkpoint. G̃_t is
             returned for the Reusing Queue.

The state is a dict of device tensors — {"params", "opt": AdamState,
"step", ["ef"]} — replaced, not updated in place, every step: a
snapshot of step t reads tensors no later step writes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device, tree_map
from repro_torch.compression.error_feedback import ef_compress_tree, ef_init
from repro_torch.compression.sparse import compress_tree, is_sparse
from repro_torch.kernels import ops
from repro_torch.optim.adam import AdamState, adam_init


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


def _grads(model, params, batch, accum: int):
    """(loss, metrics, grads) with grads in the params' tree and dtypes."""
    live, leaves, regroup = _differentiable(params)

    def one(b):
        loss, metrics = model.loss_fn(live, b)
        return loss, metrics, regroup(torch.autograd.grad(loss, leaves))

    if accum > 1:
        raise NotImplementedError(
            "gradient accumulation (grad_accum > 1) is not ported")
    loss, metrics, gl = one(batch)
    git = iter(gl)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(git), params)


def _apply_tree(params, payloads, opt: AdamState, hyper, count):
    """Per-leaf ``fused_decode_apply`` in sorted leaf order; returns
    (params', AdamState')."""
    out = tree_map(lambda g, p, m, v: ops.fused_decode_apply(g, p, m, v,
                                                             hyper),
                   payloads, params, opt.mu, opt.nu, is_leaf=is_sparse)
    triple = lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")  # noqa: E731
    pick = lambda i: tree_map(lambda t: t[i], out, is_leaf=triple)  # noqa: E731
    return pick(0), AdamState(pick(1), pick(2), count)


def make_train_step(model, *, mode: str = "lowdiff", rho: float = 0.01,
                    lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, error_feedback: bool = True,
                    compressor: str = "topk"):
    """``step(state, batch) -> (state', metrics, extra)``; extra is the
    compressed gradient tree in lowdiff mode, else None."""
    if compressor != "topk":
        raise NotImplementedError(
            f"compressor {compressor!r} is not ported (ROADMAP slice 3)")
    if mode not in ("lowdiff", "dense"):
        raise NotImplementedError(
            f"step mode {mode!r} is not ported (ROADMAP slice 2)")
    cfg = model.cfg

    def step(state, batch):
        params = state["params"]
        loss, metrics, grads = _grads(model, params, batch, cfg.grad_accum)
        opt = state["opt"]
        count = opt.count + 1
        hyper = ops.adam_hyper_traced(lr, b1, b2, eps, count)
        extra, ef = None, None
        if mode == "lowdiff":
            if error_feedback and "ef" in state:
                cg, ef = ef_compress_tree(grads, state["ef"], rho)
            else:
                cg = compress_tree(grads, rho)
            extra, payloads = cg, cg
        else:
            payloads = grads
        del grads
        params2, opt2 = _apply_tree(params, payloads, opt, hyper, count)
        new_state = {"params": params2, "opt": opt2,
                     "step": state["step"] + 1}
        if ef is not None:
            new_state["ef"] = ef
        return new_state, dict(metrics, loss=loss), extra

    return step
