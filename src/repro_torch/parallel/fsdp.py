"""FSDP over the mesh's "data" axis: the part of the reference's train
cell that GSPMD does for it (``repro.launch.steps.build_cell`` lays the
params out by ``spec_for_shape`` and XLA inserts the gathers).

Each parameter leaf is stored as this rank's slice along the dimension
that the rules give "data" (the "embed" dimension under
``DEFAULT_RULES``); a leaf that "data" does not divide stays whole.
Where a leaf is used it is gathered by :class:`_Gather`, an autograd
function whose forward is an all-gather over "data" and whose backward
is a reduce-scatter (a sum) over "data", so the gradients come out
sharded like the params.  The decoder's layers are gathered one at a
time where the layer runs (``layer``, the hook of
``models.model.backbone``); under ``checkpoint`` backward gathers the
layer again, FSDP's re-gather.  Everything else (the embedding, the
final norm, the head, an encoder) is gathered at the loss's entry.

Every rank draws the whole initialization from the same generator and
keeps its slice (``shard``), so the sharded state is bit for bit a slice
of the single-device state, as ``jax.device_put`` of ``init_params`` is
in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (LogicalRules, axes_and_shapes,
                                           shardings_for_tree)
from repro_torch.tree import tree_map


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, in
    the layout of a whole leaf (contiguous)."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``g``, this rank's slice
    along ``dim``."""
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather over "data" forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _AllReduce(torch.autograd.Function):
    """A sum over ``groups`` whose backward is the same sum: the output,
    equal on every rank, feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split along ``dim`` over the ``n`` ranks of ``group``, this
    rank holding slice ``rank`` (the placement a checkpoint reads)."""
    dim: int
    n: int
    rank: int
    group: Any

    def slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t`` (a copy)."""
        return t.chunk(self.n, self.dim)[self.rank].clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of this rank's slice ``t`` (every rank calls)."""
        return _gather(t, self.dim, self.group, self.n)


class Fsdp:
    """The placement and the gathers of a params tree over ``mesh``'s
    "data" axis.

    ``dims`` is a tree like the params: per leaf the dimension "data"
    splits, or None for a whole leaf.  ``mean_axes`` are the axes over
    which ``mean`` averages a statistic of the loss (the MoE aux loss's
    routing fractions and importances): the data-parallel axes the loss
    is taken over."""

    def __init__(self, mesh, dims, *, mean_axes: Sequence[str] = ("data",)):
        self.mesh = mesh
        self.dims = dims
        self.group = mesh.group("data")
        self.n = mesh.shape["data"]
        self.rank = mesh.coordinate("data")
        self.mean_groups = [mesh.group(a) for a in mean_axes
                            if a in mesh.axis_names]
        self.mean_size = math.prod(mesh.shape[a] for a in mean_axes
                                   if a in mesh.axis_names)

    @classmethod
    def for_specs(cls, specs, mesh, rules: LogicalRules, **kw) -> "Fsdp":
        """The placement that ``spec_for_shape`` gives a ParamSpec tree:
        each leaf split along the dimension "data" holds, if any."""
        axes, shapes = axes_and_shapes(specs)
        placements = shardings_for_tree(axes, mesh, rules, shapes)
        return cls(mesh, tree_map(lambda pl: pl.get("data"), placements),
                   **kw)

    def sharded(self):
        """Per leaf, in ``tree_leaves`` order, whether it is split."""
        return [d is not None for d in _dim_leaves(self.dims)]

    # -- placement ---------------------------------------------------------

    def splits(self):
        """The tree of :class:`Split`s (None for a whole leaf) of a tree
        like the params."""
        return tree_map(lambda d: None if d is None else
                        Split(d, self.n, self.rank, self.group), self.dims)

    def shard(self, tree):
        """This rank's slice of every leaf of a whole tree like the
        params (a copy), a whole leaf copied as it is."""
        return _map2(lambda t, s: t.clone() if s is None else s.slice(t),
                     tree, self.splits())

    def full(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole leaf of this rank's slice ``t`` of a leaf split along
        ``dim`` (no autograd)."""
        if dim is None:
            return t
        with torch.no_grad():
            return _gather(t, dim, self.group, self.n)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over "data" of every rank's whole ``t``, this rank's
        slice along ``dim`` (no autograd)."""
        return _scatter(t, dim, self.group, self.n)

    # -- gathers of the loss -----------------------------------------------

    def gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return t if dim is None else _Gather.apply(t, dim, self.group, self.n)

    def outside_blocks(self, params):
        """``params`` with every leaf outside the decoder's ``blocks``
        gathered (the embedding, the norms, the head, an encoder)."""
        return {k: (v if k == "blocks" else
                    _map2(self.gather, v, self.dims[k]) if isinstance(v, dict)
                    else self.gather(v, self.dims[k]))
                for k, v in params.items()}

    def layer(self, i: int, p):
        """The leaves of one decoder layer at period position ``i``
        (views of the stacked ``(G, ...)`` shards, any subset of
        ``blocks/pos{i}``'s keys) gathered: a stacked leaf's "data"
        dimension is one lower in a layer's view."""
        return _map2(lambda t, d: self.gather(t, None if d is None else d - 1),
                     p, self.dims["blocks"][f"pos{i}"])

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ``mean_axes`` of ``t`` (differentiable)."""
        return _AllReduce.apply(t, self.mean_groups) / self.mean_size


def _map2(fn, tree, dims):
    """``fn(leaf, dim)`` over ``tree``'s leaves, ``dims`` a tree holding
    at least ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, dims[k]) for k, v in tree.items()}
    return fn(tree, dims)


def _dim_leaves(dims):
    """The leaves of a dims tree (ints or None) in ``tree_leaves``
    order."""
    if isinstance(dims, dict):
        return [d for k in sorted(dims) for d in _dim_leaves(dims[k])]
    return [dims]


def local_rows(mesh, batch_axes, global_batch: int):
    """``(lo, hi)``: this rank's rows of a global batch split over
    ``batch_axes`` (outermost first), as the reference's batch spec lays
    them out."""
    dp, idx = 1, 0
    for a in batch_axes:
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
        dp *= mesh.shape[a]
    rows = global_batch // dp
    return idx * rows, (idx + 1) * rows

