"""Collectives of the sharded steps and the expert-parallel MoE, on
``torch.distributed`` process groups (the port's stand-in for the
reference's ``shard_map`` bodies and XLA collectives).

The layout convention: on a live mesh each rank computes on its data
shard of the batch, and activations and losses are replicated over the
``model`` axis (no tensor-parallel compute). The autograd functions
below differentiate a loss that is computed once per data shard, summed
over data shards, so a region of work split over ``model`` enters and
leaves through conjugate pairs (the Megatron ``f``/``g`` operators):

* :func:`copy_to` — identity forward, all-reduce of the gradient;
* :func:`reduce_from` — all-reduce forward, identity backward;
* :func:`split_to` — this rank's chunk of a replicated tensor forward,
  all-gather of the chunks' gradients backward;
* :func:`gather_from` — all-gather forward into a replicated tensor,
  this rank's chunk of the gradient backward;
* :func:`all_gather_dim` — all-gather forward into input of split work,
  reduce-scatter of the partial gradients backward;
* :func:`reduce_scatter_dim` — reduce-scatter forward of partial
  results, all-gather backward;
* :func:`all_reduce_sum` — sum forward and backward, for a value that
  every data shard's loss uses (the mean of ``aux``).

:func:`gather_leaf` assembles a whole tensor from the ranks' blocks
(no autograd): what the sharded steps do to each parameter they use.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in group-rank order (flat
    buffers, as both gloo and NCCL take them)."""
    n = group_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    shape = list(x.shape)
    shape[dim] *= n
    return all_gather_stack(x, group).movedim(0, dim).reshape(shape)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    c = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * c, c).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    s = list(x.shape)
    c = s[dim] // n
    inp = x.reshape(s[:dim] + [n, c] + s[dim + 1:]).movedim(dim, 0)
    inp = inp.contiguous()
    out = torch.empty(inp.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), inp.view(-1), group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    return _Copy.apply(x, group)


def reduce_from(x, group):
    return _Reduce.apply(x, group)


def all_reduce_sum(x, group):
    return _SumBoth.apply(x, group)


def split_to(x, dim: int, group):
    return _Split.apply(x, dim, group)


def gather_from(x, dim: int, group):
    return _GatherReplicated.apply(x, dim, group)


def all_gather_dim(x, dim: int, group):
    return _GatherPartial.apply(x, dim, group)


def reduce_scatter_dim(x, dim: int, group):
    return _ReduceScatter.apply(x, dim, group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no autograd)."""
    dist.all_reduce(x, group=group)
    return x


def gather_leaf(local: torch.Tensor, shape, spec, mesh) -> torch.Tensor:
    """The whole ``shape`` tensor from each rank's block of it under
    ``spec`` on the live ``mesh``: one all-gather over the mesh axes the
    spec names (a replicated leaf is still copied, through a group of
    one where the spec names no axis)."""
    axes = spec.axes() if isinstance(spec, shd.PartitionSpec) \
        else shd.PartitionSpec(*spec).axes()
    group = shd.axis_group(mesh, axes)
    n = group_size(group)
    buf = all_gather_stack(local, group)
    if n == 1 and tuple(local.shape) == tuple(shape):
        return buf[0]
    sizes = shd.mesh_shape(mesh)
    names = [a for a in shd.axis_names(mesh) if a in axes]
    me = shd.coordinate(mesh)
    out = torch.empty(tuple(shape), dtype=local.dtype, device=local.device)
    for j in range(n):
        coord, rest = dict(me), j
        for a in reversed(names):
            coord[a] = rest % sizes[a]
            rest //= sizes[a]
        out[shd.block_slices(shape, spec, mesh, coord)] = buf[j]
    return out
