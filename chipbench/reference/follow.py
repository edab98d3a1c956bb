"""The reference's training run: the first steps of a cell's traffic from
the seed's weights and batches, and the replay of a differential chain.

It returns per-leaf norms, the numbers the comparison reads: each step's
loss, the norm of the gradient the optimizer got (for LowDiff the
densified top-k of gradient plus residual), and, after chosen steps, the
norms of the parameters' change since the seed's weights and of both
moments.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from chipbench import inputs
from chipbench.reference.decoder import Precision, gradients
from chipbench.reference.optim import Adam, compress_ef, densify, topk


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.float()))


def follow(m: dict, traffic: dict, seed: int, device, steps: int, *,
           prec: Precision, record: Iterable[int] = (),
           half: bool = False) -> dict:
    """{"loss": [per step], "g": {step: {leaf: norm}}, "graw1": {leaf:
    norm of step 1's dense gradient}, "dp"/"mu"/"nu": {step: {leaf:
    norm}} at each step of ``record``}. ``half`` leaves out the second
    half of each batch's rows (a fault: the mean over the rest)."""
    lowdiff = traffic["strategy"] == "lowdiff"
    ef_on = lowdiff and traffic.get("error_feedback", True)
    rho = traffic.get("rho", 0.01)
    flat = inputs.weights(m, seed, device)
    p0 = {k: v.clone() for k, v in flat.items()}
    zeros = lambda v: torch.zeros(v.shape, dtype=torch.float32,  # noqa: E731
                                  device=v.device)
    mu = {k: zeros(v) for k, v in flat.items()}
    nu = {k: zeros(v) for k, v in flat.items()}
    ef = {k: zeros(v) for k, v in flat.items()} if ef_on else None
    adam = Adam(lr=traffic["lr"])
    batches = inputs.Batches(m["vocab"], traffic["batch"], traffic["seq"],
                             seed, device)
    out: dict = {"loss": [], "g": {}, "dp": {}, "mu": {}, "nu": {}}
    record = set(record)
    for s in range(1, steps + 1):
        batch = next(batches)
        if half:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        loss, grads = gradients(flat, batch, m, prec)
        if s == 1:
            out["graw1"] = {k: norm(g) for k, g in grads.items()}
        gn = out["g"][s] = {}
        for k in list(flat):
            g = grads.pop(k)
            if ef_on:
                g, ef[k] = compress_ef(g, ef[k], rho)
            elif lowdiff:
                v, i = topk(g, rho)
                g = densify(v, i, g.shape)
            gn[k] = norm(g)
            flat[k], mu[k], nu[k] = adam.step(flat[k], g, mu[k], nu[k], s)
            del g
        out["loss"].append(float(loss))
        if s in record:
            out["dp"][s] = {k: norm(flat[k].float() - p0[k].float())
                            for k in flat}
            out["mu"][s] = {k: norm(v) for k, v in mu.items()}
            out["nu"][s] = {k: norm(v) for k, v in nu.items()}
    return out


def replay(start: Dict[str, Dict[str, torch.Tensor]],
           chain: List[Dict[str, tuple]], count0: int, traffic: dict,
           device, name: str, dtype=torch.float32):
    """One leaf's state after replaying ``chain`` onto ``start``: start
    is {"params", "mu", "nu"} of host tensors keyed by leaf name, chain
    the differentials in step order, each {leaf: (values, indices,
    shape)}; the first differential is Adam step ``count0 + 1``.
    Returns (p, mu, nu) on ``device``."""
    adam = Adam(lr=traffic["lr"], dtype=dtype)
    p = start["params"][name].to(device)
    mu = start["mu"][name].to(device)
    nu = start["nu"][name].to(device)
    for j, diff in enumerate(chain):
        v, i, shape = diff[name]
        g = densify(v.to(device), i.to(device), shape)
        p, mu, nu = adam.step(p, g, mu, nu, count0 + 1 + j)
    return p, mu, nu
