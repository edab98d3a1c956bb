"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

A thread-local ``MeshContext`` maps the *logical* axis names of the
model's parameter and cache specs onto *physical* mesh axes, by the
reference's rules. A partition spec is the port's small
:class:`PartitionSpec`, a tuple of ``None | axis | (axis, ...)`` per
tensor dim, so ``tuple(spec)`` equals the reference's ``PartitionSpec``
as a tuple. :class:`NamedSharding` pairs a spec with a mesh and gives
its ``torch.distributed.tensor`` placements (``Shard(dim)`` on each mesh
dim the spec names, ``Replicate()`` on the others) and the block a
coordinate holds.

Differences from the reference, by design: :func:`shard` changes
nothing (see its docstring), and no compute is tensor parallel — the
sharded steps (:mod:`repro_torch.distributed.step_builder`) gather the
weights they need.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch import tree_leaves
from repro_torch.launch.mesh import AbstractMesh

# logical axis -> physical mesh axis (or tuple of axes); 'pod' is folded
# into the data-parallel dimension
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),   # FSDP weight shard axis
    "seq": None,
    "residual_seq": "model",
    "kvseq": "model",          # decode KV-cache sequence sharding
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": None,          # few KV heads: replicate, shard Q heads
    "qkv": None,
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "conv": None,
    "state": None,
    "frames": None,
    "null": None,
}

_TLS = threading.local()


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis name, or a tuple of
    names (the dim split over their product, the first name major)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec names, in the order it names them."""
        out = []
        for ax in self:
            if ax is not None:
                out.extend(ax if isinstance(ax, tuple) else (ax,))
        return tuple(out)


P = PartitionSpec


# ----------------------------------------------------------------------
# meshes: live (DeviceMesh) or abstract
# ----------------------------------------------------------------------

def is_live(mesh) -> bool:
    return not isinstance(mesh, AbstractMesh)


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    if "_repro_shape" not in mesh.__dict__:
        with _host_only():
            mesh.__dict__["_repro_shape"] = dict(zip(mesh.mesh_dim_names,
                                                     mesh.mesh.shape))
    return dict(mesh.__dict__["_repro_shape"])


def _host_only():
    """Suspends the active dispatch modes: the mesh's rank table is host
    bookkeeping (newer DeviceMeshes build ``mesh.mesh`` with a tensor op
    on each read), which a ``FakeTensorMode`` (the dry run) must not
    intercept."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


def coordinate(mesh) -> Dict[str, int]:
    """This rank's coordinate on a live mesh (axis name -> index)."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's peers along ``axes`` of a live
    mesh (the ranks that differ from it only there), ranked row-major
    over ``axes`` in the mesh's order. Every rank must ask for the same
    groups in the same order (creation is collective); groups are kept
    on the mesh."""
    import torch.distributed as dist
    names = axis_names(mesh)
    axes = tuple(a for a in names if a in axes)
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        with _host_only():
            ranks = mesh.mesh
            keep = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in keep]
            n = math.prod(ranks.shape[i] for i in keep)
            lists = ranks.permute(rest + keep).reshape(-1, n).tolist()
        if len(lists) == 1:
            cache[axes] = dist.group.WORLD
        else:
            cache[axes], _ = dist.new_subgroups_by_enumeration(lists)
    return cache[axes]


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

def dim_axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def block_slices(shape, spec, mesh, coord) -> Tuple[slice, ...]:
    """The slices of a ``shape`` tensor that the device at ``coord``
    holds under ``spec``: a dim split over axes (a1, a2, ...) is cut in
    prod(sizes) equal blocks, block index row-major over the coordinates
    of a1, a2, ... (the first major), as ``shard_map`` cuts it."""
    sizes = mesh_shape(mesh)
    out = []
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, full):
        idx, n = 0, 1
        for a in dim_axes(ax):
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways ({spec})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class NamedSharding:
    """A partition spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def placements(self):
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the
        spec splits tensor dim ``d`` over that mesh axis, else
        ``Replicate()``. A dim split over several axes gets ``Shard`` on
        each; DTensor splits them in mesh order, which is the spec's
        order for every rule here (('pod', 'data', 'model'))."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for a in axis_names(self.mesh):
            dims = [d for d, ax in enumerate(self.spec) if a in dim_axes(ax)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def slices(self, shape, coord) -> Tuple[slice, ...]:
        return block_slices(shape, self.spec, self.mesh, coord)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class MeshContext:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def spec(self, logical: Sequence[Optional[str]]) -> PartitionSpec:
        """Logical axes -> spec; a mesh axis that an earlier dim already
        took, or that the mesh lacks, is left out."""
        names = axis_names(self.mesh)
        axes = []
        used = set()
        for name in logical:
            phys = self.rules.get(name) if name else None
            if phys is None:
                axes.append(None)
                continue
            phys_t = phys if isinstance(phys, tuple) else (phys,)
            phys_t = tuple(a for a in phys_t
                           if a in names and a not in used)
            used.update(phys_t)
            if not phys_t:
                axes.append(None)
            elif len(phys_t) == 1:
                axes.append(phys_t[0])
            else:
                axes.append(phys_t)
        return PartitionSpec(*axes)

    def sharding(self, logical) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical))


def current() -> Optional[MeshContext]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (with ``rules`` over the defaults) current in this
    thread; nests, and restores the outer context on exit."""
    prev = current()
    _TLS.ctx = MeshContext(mesh, rules)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


def shard(x, *logical):
    """The identity. The reference constrains an activation's layout here
    (``with_sharding_constraint``), which changes no value; the port runs
    no tensor-parallel compute, so its activations have no layout to
    constrain."""
    return x


def safe_spec(shape, spec, mesh) -> PartitionSpec:
    """Per dim, the longest prefix of its axis tuple whose sizes' product
    divides the dim (e.g. 12 heads on a 16-way model axis replicate), so
    every arch x mesh combination has a valid layout."""
    sizes = mesh_shape(mesh)
    out = []
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, full):
        if ax is None:
            out.append(None)
            continue
        axes = dim_axes(ax)
        kept = None
        for n in range(len(axes), 0, -1):
            if dim % math.prod(sizes[a] for a in axes[:n]) == 0:
                kept = axes[0] if n == 1 else axes[:n]
                break
        out.append(kept)
    return PartitionSpec(*out)


def _is_logical(x) -> bool:
    """A logical-axis tuple (a plain tuple, not a NamedTuple node)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def zip_up_to(fn, struct, logical):
    """Map ``fn(leaf, logical)`` over the leaves of ``struct`` (tensors),
    pairing each with the entry of ``logical`` at the same place (its
    logical-axis tuple), as ``treedef.flatten_up_to`` pairs them."""
    if isinstance(struct, dict):
        return {k: zip_up_to(fn, struct[k], logical[k])
                for k in sorted(struct)}
    if isinstance(struct, tuple) and hasattr(struct, "_fields"):
        return type(struct)(*(zip_up_to(fn, s, l)
                              for s, l in zip(struct, logical)))
    if isinstance(struct, (list, tuple)):
        return type(struct)(zip_up_to(fn, s, l)
                            for s, l in zip(struct, logical))
    return fn(struct, logical)


def safe_sharding_tree(abstract_tree, logical_tree):
    """NamedShardings for a tree of tensors (meta ones included), with
    divisibility-checked specs."""
    ctx = current()
    if ctx is None:
        raise RuntimeError("safe_sharding_tree requires an active mesh")

    def one(leaf, logical):
        spec = ctx.spec(logical)
        return NamedSharding(ctx.mesh, safe_spec(leaf.shape, spec, ctx.mesh))

    return zip_up_to(one, abstract_tree, logical_tree)


def _map_logical(fn, tree):
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, tree[k]) for k in sorted(tree)}
    return type(tree)(*(_map_logical(fn, v) for v in tree)) \
        if hasattr(tree, "_fields") else \
        type(tree)(_map_logical(fn, v) for v in tree)


def pspec_tree(logical_tree):
    """Map a tree of logical-axis tuples to specs (all ``P()`` without an
    active mesh)."""
    ctx = current()
    if ctx is None:
        return _map_logical(lambda _: PartitionSpec(), logical_tree)
    return _map_logical(ctx.spec, logical_tree)


def sharding_tree(logical_tree):
    ctx = current()
    if ctx is None:
        raise RuntimeError("sharding_tree requires an active mesh")
    return _map_logical(ctx.sharding, logical_tree)


def spec_leaves(tree):
    """The specs of a tree of NamedShardings or specs, in leaf order."""
    return [s.spec if isinstance(s, NamedSharding) else s
            for s in tree_leaves(tree, is_leaf=lambda x: isinstance(
                x, (NamedSharding, PartitionSpec)))]
