"""The system under test, ``repro_torch``, as the drivers use it: the one
module of the benchmark that imports it, and only inside functions, so
that the reference and the counts can be imported without it.

The benchmark takes from the program the model it builds from the
configuration's registry entry, the training state, the LowDiff strategy
over a pure-RAM store, the dense step, and its spans (``TRACER``) and
stall charges (``TIMELINE``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from chipbench.reference.decoder import family, nest

#: configuration-file keys of every family and how the program's
#: ``ArchConfig`` holds them; a family adds its own (``PROGRAM_KEYS``:
#: attribute paths)
_CFG_KEYS = {
    "n_layers": lambda c: c.n_layers, "d_model": lambda c: c.d_model,
    "n_heads": lambda c: c.n_heads, "n_kv_heads": lambda c: c.n_kv_heads,
    "head_dim": lambda c: c.hd(), "vocab": lambda c: c.vocab,
    "rope_theta": lambda c: c.rope_theta, "norm_eps": lambda c: c.norm_eps,
    "tie_embeddings": lambda c: c.tie_embeddings,
    "param_dtype": lambda c: c.param_dtype,
    "compute_dtype": lambda c: c.compute_dtype,
    "grad_accum": lambda c: c.grad_accum,
}


def _attr(path: str):
    """A reader of dotted attribute ``path``; tuples read as lists, as a
    configuration file holds them."""
    def get(c):
        for name in path.split("."):
            c = getattr(c, name)
        return list(c) if isinstance(c, tuple) else c
    return get


def arch_config(m: dict):
    """The program's configuration of file ``m``: its registry entry with
    ``port_overrides`` applied (a nested dict replaces fields of a nested
    configuration); raises unless it is of the family's ``ARCH_TYPE``
    and holds every size the file states."""
    from repro_torch.configs import get_config
    cfg = get_config(m["port_arch"])
    kw = {}
    for k, v in m.get("port_overrides", {}).items():
        kw[k] = (dataclasses.replace(getattr(cfg, k), **v)
                 if isinstance(v, dict) else v)
    cfg = cfg.replace(**kw)
    fam = family(m)
    want = dict(_CFG_KEYS, **{k: _attr(p)
                              for k, p in fam.PROGRAM_KEYS.items()})
    if cfg.arch_type != fam.ARCH_TYPE:
        raise ValueError(f"{m['name']}: family {m['family']} runs on "
                         f"arch_type {fam.ARCH_TYPE}, the program's is "
                         f"{cfg.arch_type}")
    bad = {k: (m[k], get(cfg)) for k, get in want.items()
           if m[k] != get(cfg)}
    if bad:
        raise ValueError(f"{m['name']}: the file and the program differ "
                         f"(file, program): {bad}")
    return cfg


def build_model(m: dict):
    from repro_torch.models.registry import build_model as build
    return build(arch_config(m))


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted name: leaf} of a nested dict, names sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def check_layout(model, weights: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights must be the program's parameter tree."""
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in flatten(model.abstract_params()).items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    if want != got:
        raise ValueError(f"weights {got} do not match the program's "
                         f"parameters {want}")


def init_state(model, weights, traffic: dict, device):
    from repro_torch.core.steps import init_state as init
    mode = "lowdiff" if traffic["strategy"] == "lowdiff" else "dense"
    state = init(model, mode=mode,
                 error_feedback=traffic.get("error_feedback", True),
                 device=device, params=nest(weights))
    state["step"] = torch.tensor(traffic["start_step"], dtype=torch.int32,
                                 device=device)
    return state


def ram_store(traffic: dict):
    """The pure-RAM store: no root, so no byte reaches a disk and the
    journal is a ``MemoryJournal``."""
    from repro_torch.checkpoint.config import StoreConfig, TierSpec
    s = traffic["store"]
    return StoreConfig(tiers=[TierSpec(**t) for t in s["tiers"]],
                       retention_fulls=s["retention_fulls"]).build()


def lowdiff(model, store, traffic: dict, device):
    from repro_torch.core.lowdiff import LowDiff
    return LowDiff(model, store, rho=traffic["rho"], lr=traffic["lr"],
                   full_interval=traffic["full_interval"],
                   batch_size=traffic["batch_size"],
                   compressor=traffic["compressor"],
                   error_feedback=traffic["error_feedback"],
                   replay_device=traffic.get("replay_device", False),
                   device=device, flush_timeout=600.0)


def dense_step(model, traffic: dict):
    from repro_torch.core.steps import make_train_step
    step = make_train_step(model, mode="dense", lr=traffic["lr"])
    return lambda state, batch: step(state, batch)[:2]


def to_tensor(leaf, device) -> torch.Tensor:
    """A host leaf of a loaded checkpoint as a tensor on ``device``."""
    from repro_torch.models.param import to_tensor as convert
    return convert(leaf, device=device)


def sparse_leaves(payload) -> Dict[str, tuple]:
    """{leaf: (values, indices, shape)} of a top-k compressed tree."""
    from repro_torch.compression.sparse import SparseGrad
    out = {}

    def walk(t, prefix):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, SparseGrad):
                out[prefix + k] = (v.values, v.indices, tuple(v.shape))
            else:
                walk(v, f"{prefix}{k}.")
    walk(payload, "")
    return out


def release_pinned() -> None:
    """Hand torch's cached pinned host blocks back to the OS."""
    if not torch.cuda.is_available():
        return
    fn = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                  None) or getattr(torch._C, "_host_emptyCache", None))
    if fn is not None:
        fn()


def tracer():
    from repro_torch.obs.trace import TRACER
    return TRACER


def timeline():
    from repro_torch.obs.timeline import TIMELINE
    return TIMELINE
